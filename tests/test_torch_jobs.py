"""Every case of tests/test_scheduler.py, run against both packages (the
``pkg`` fixture): the leader's JobScheduler and the failover classes on the
deterministic sim fabric of the package under test — fair assignment, shard
dispatch with exactly-once counting, member failure retry, hedging, chip
weighting, leader failover with cursor resume, standby adopt/defer/mirror,
and the gang bookkeeping.

The gang cases' members are served by the JAX package's PredictWorker on
both sides: this package's PredictWorker has no ``job.predict_gang`` or
``job.decode_gang`` verb until the gang backends (EngineBackend.predict_gang
over InferenceEngine.run_batch_global in dmlc_tpu/scheduler/worker.py) are
ported. The scheduler's gang dispatch under test is each package's own.
"""

from torch_sides import JAX, pkg  # noqa: F401  (pkg: fixture)

def make_workload(n, prefix="n", offset=0):
    return [(f"{prefix}{i:05d}", offset + i) for i in range(n)]


class Fixture:
    """N members serving fake model backends + a leader scheduler."""

    def __init__(self, pkg, n_members=10, n_queries=100, shard=16, accuracy=1.0):
        self.net = pkg.rpc.SimRpcNetwork()
        self.live = [f"m{i}" for i in range(n_members)]
        self.calls = {m: 0 for m in self.live}  # shards served per member

        def backend_for(member, correct_frac):
            def fn(synsets):
                self.calls[member] += 1
                out = []
                for k, s in enumerate(synsets):
                    truth = int(s[1:])
                    # Deterministically wrong for a fraction of queries.
                    wrong = (truth % 100) >= correct_frac * 100
                    out.append(truth + 1 if wrong else truth)
                return out

            return fn

        for m in self.live:
            worker = pkg.worker.PredictWorker(
                {
                    "resnet18": backend_for(m, accuracy),
                    "alexnet": backend_for(m, accuracy),
                }
            )
            self.net.serve(m, worker.methods())

        self.scheduler = pkg.jobs.JobScheduler(
            self.net.client("L"),
            lambda: list(self.live),
            jobs={
                "resnet18": make_workload(n_queries),
                "alexnet": make_workload(n_queries),
            },
            shard_size=shard,
            timer=self._fake_timer(),
        )
        self.scheduler.is_leading = True  # fixture models the active leader
        self.net.serve("L", self.scheduler.methods())

    def _fake_timer(self):
        t = [0.0]

        def timer():
            t[0] += 0.005
            return t[0]

        return timer

    def crash(self, m):
        self.live.remove(m)
        self.net.crash(m)


def test_assignment_splits_members_evenly(pkg):
    f = Fixture(pkg)
    f.net.client("cli").call("L", "job.start", {})
    assigned = f.net.client("cli").call("L", "job.assignments", {})["assigned"]
    assert len(assigned["resnet18"]) == 5
    assert len(assigned["alexnet"]) == 5
    assert not set(assigned["resnet18"]) & set(assigned["alexnet"])


def test_run_to_completion_and_report(pkg):
    f = Fixture(pkg, n_queries=100, shard=16, accuracy=1.0)
    f.scheduler._start({})
    f.scheduler.run_to_completion()
    rep = f.net.client("cli").call("L", "job.report", {})["jobs"]
    for name in ("resnet18", "alexnet"):
        r = rep[name]
        assert r["finished"] == r["total"] == 100
        assert r["accuracy"] == 1.0
        assert not r["running"]
        for k in ("mean", "median", "p90", "p95", "p99", "std"):
            assert k in r["query_latency"] and k in r["shard_latency"]
        # Completed work over the fake timer's dispatch window.
        assert r["throughput_qps"] > 0
    # Work spread across members: every member served at least one shard.
    assert all(c > 0 for c in f.calls.values())


def test_partial_accuracy_counted_exactly(pkg):
    f = Fixture(pkg, n_queries=100, shard=10, accuracy=0.7)
    f.scheduler._start({})
    f.scheduler.run_to_completion()
    job = f.scheduler.jobs["resnet18"]
    assert job.finished == 100
    assert job.correct == 70  # truths 0..99, wrong for (truth % 100) >= 70


def test_member_crash_mid_run_retries_without_double_count(pkg):
    f = Fixture(pkg, n_members=4, n_queries=64, shard=16)
    f.scheduler._start({})
    f.scheduler.assign_once()
    assert f.scheduler.dispatch_once("resnet18") == 16
    f.crash(f.scheduler.jobs["resnet18"].assigned[1 % len(f.scheduler.jobs["resnet18"].assigned)])
    f.scheduler.run_to_completion()
    job = f.scheduler.jobs["resnet18"]
    assert job.finished == 64  # exactly once, despite the failed dispatch
    assert job.correct == 64
    assert f.scheduler.jobs["alexnet"].finished == 64


def test_idle_scheduler_dispatches_nothing(pkg):
    f = Fixture(pkg)
    assert f.scheduler.dispatch_all_once() == 0  # predict never issued
    assert f.scheduler.jobs["resnet18"].finished == 0


def test_leader_tracker_advances_and_wraps(pkg):
    net = pkg.rpc.SimRpcNetwork()
    leading = {"L0": True, "L1": True, "L2": True}
    for addr in ("L0", "L1", "L2"):
        net.serve(addr, {"leader.status": (lambda a: lambda p: {"leading": leading[a]})(addr)})
    t = pkg.failover.LeaderTracker(net.client("m"), ["L0", "L1", "L2"])
    assert t.probe() and t.current == "L0"
    net.crash("L0")
    assert not t.probe()  # advance to L1
    assert t.probe() and t.current == "L1"
    net.crash("L1")
    net.crash("L2")
    assert not t.probe()  # -> L2
    assert not t.probe()  # -> L0 (wrap)
    assert t.current == "L0"
    net.restart("L0")
    assert t.probe()
    # Alive-but-deferring candidates are skipped too, not just dead ones.
    leading["L0"] = False
    assert not t.probe()
    assert t.current == "L1"


def test_failover_resumes_from_cursor(pkg):
    f = Fixture(pkg, n_members=6, n_queries=80, shard=16)
    f.scheduler.is_leading = True  # primary actively leads
    f.scheduler._start({})
    f.scheduler.assign_once()
    # Primary completes 2 shards of each job, then standby syncs.
    for _ in range(2):
        f.scheduler.dispatch_once("resnet18")
        f.scheduler.dispatch_once("alexnet")
    standby = pkg.jobs.JobScheduler(
        f.net.client("L1"),
        lambda: list(f.live),
        jobs={"resnet18": make_workload(80), "alexnet": make_workload(80)},
        shard_size=16,
        timer=f._fake_timer(),
    )
    monitor = pkg.failover.StandbyLeader(f.net.client("L1"), "L1", ["L", "L1"], standby)
    monitor.step()  # mirrors primary state
    assert standby.jobs["resnet18"].finished == 32
    assert not monitor.is_leader

    shards_before = dict(f.calls)
    f.net.crash("L")
    monitor.step()  # primary dead -> promote + auto-resume
    assert monitor.is_leader
    assert standby.jobs["resnet18"].running
    standby.run_to_completion()
    for name in ("resnet18", "alexnet"):
        assert standby.jobs[name].finished == 80
        assert standby.jobs[name].correct == 80
    # Resume really started at the cursor: exactly (80-32)/16 = 3 more shards
    # per job were served cluster-wide.
    extra = sum(f.calls.values()) - sum(shards_before.values())
    assert extra == 6


def test_adopt_state_never_rewinds(pkg):
    f = Fixture(pkg, n_queries=64, shard=16)
    f.scheduler._start({})
    f.scheduler.assign_once()
    f.scheduler.dispatch_once("resnet18")
    f.scheduler.dispatch_once("resnet18")
    stale = {
        "jobs": {
            "resnet18": {
                "model": "resnet18",
                "finished": 16,
                "correct": 16,
                "running": True,
                "query_samples": [],
                "shard_samples": [],
            }
        }
    }
    f.scheduler.adopt_state(stale)
    assert f.scheduler.jobs["resnet18"].finished == 32  # stale snapshot ignored


def test_rebooted_ex_leader_defers_to_active_leader(pkg):
    """A restarted first-candidate must NOT reclaim leadership while another
    candidate actively leads (the dual-leader bug)."""
    net = pkg.rpc.SimRpcNetwork()
    live = ["m0", "m1"]
    active = pkg.jobs.JobScheduler(net.client("L1"), lambda: list(live), jobs={"j": make_workload(8)})
    active.is_leading = True
    net.serve("L1", active.methods())
    rebooted = pkg.jobs.JobScheduler(net.client("L0"), lambda: list(live), jobs={"j": make_workload(8)})
    net.serve("L0", rebooted.methods())
    monitor = pkg.failover.StandbyLeader(net.client("L0"), "L0", ["L0", "L1"], rebooted)
    monitor.step()
    assert not monitor.is_leader  # defers despite being first in the list
    # Only once the active leader dies does the rebooted one take over.
    net.crash("L1")
    monitor.step()
    assert monitor.is_leader


def test_standby_mirrors_sdfs_directory(pkg, tmp_path):
    """Failover must not orphan the SDFS directory (files + versions)."""
    MemberStore, SdfsClient, SdfsLeader, SdfsMember = (
        pkg.sdfs.MemberStore, pkg.sdfs.SdfsClient, pkg.sdfs.SdfsLeader, pkg.sdfs.SdfsMember)

    net = pkg.rpc.SimRpcNetwork()
    live = ["m0", "m1", "m2"]
    stores = {}
    for m in live:
        store = MemberStore(tmp_path / m)
        net.serve(m, SdfsMember(store, net.client(m)).methods())
        stores[m] = store
    primary_sdfs = SdfsLeader(net.client("L0"), lambda: list(live), replication_factor=2)
    primary_jobs = pkg.jobs.JobScheduler(net.client("L0"), lambda: list(live), jobs={})
    primary_jobs.is_leading = True
    net.serve("L0", {**primary_sdfs.methods(), **primary_jobs.methods()})

    client = SdfsClient(net.client("m0"), "L0", stores["m0"], "m0")
    client.put_bytes(b"v1", "w")
    client.put_bytes(b"v2", "w")

    standby_sdfs = SdfsLeader(net.client("L1"), lambda: list(live), replication_factor=2)
    standby_jobs = pkg.jobs.JobScheduler(net.client("L1"), lambda: list(live), jobs={})
    net.serve("L1", {**standby_sdfs.methods(), **standby_jobs.methods()})
    monitor = pkg.failover.StandbyLeader(net.client("L1"), "L1", ["L0", "L1"], standby_jobs, sdfs_leader=standby_sdfs)
    monitor.step()  # mirrors directory
    assert standby_sdfs.state.latest_version("w") == 2

    net.crash("L0")
    monitor.step()
    assert monitor.is_leader
    # Post-failover: get resolves, and a new put gets v3, never recycles v1.
    client.leader_addr = "L1"
    v, data = client.get_bytes("w")
    assert (v, data) == (2, b"v2")
    assert client.put_bytes(b"v3", "w")["version"] == 3


# ---------------------------------------------------------------------------
# Concurrent dispatch (round-2: up to W shards in flight per job)
# ---------------------------------------------------------------------------

import threading
import time as _time


def _sim_members(pkg, net, live, backend):
    for m in live:
        net.serve(m, pkg.worker.PredictWorker({"j": backend}).methods())


def echo_backend(synsets):
    return [int(s[1:]) for s in synsets]


def test_concurrent_dispatch_k_shards_in_flight(pkg):
    """4 dispatcher threads drive 4 members SIMULTANEOUSLY: every backend
    blocks on a barrier that only releases once all 4 have a shard in
    flight — completion is proof of 4-way concurrency, no timing needed."""
    net = pkg.rpc.SimRpcNetwork()
    live = [f"m{i}" for i in range(4)]
    barrier = threading.Barrier(4, timeout=10)

    def backend(synsets):
        barrier.wait()
        return echo_backend(synsets)

    _sim_members(pkg, net, live, backend)
    sched = pkg.jobs.JobScheduler(
        net.client("L"), lambda: list(live), jobs={"j": make_workload(64)}, shard_size=16
    )
    sched.is_leading = True
    sched._start({})
    threads = [threading.Thread(target=sched.dispatch_all_once) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    job = sched.jobs["j"]
    assert job.finished == 64 and job.correct == 64 and job.done
    assert not job.outstanding and not job.buffered and not job.retry_q


def test_concurrent_dispatch_completion_rate_scales(pkg):
    """K members x W workers with per-shard latency: wall time ~ serial/K."""
    net = pkg.rpc.SimRpcNetwork()
    live = [f"m{i}" for i in range(4)]
    delay = 0.03

    def backend(synsets):
        _time.sleep(delay)
        return echo_backend(synsets)

    _sim_members(pkg, net, live, backend)
    n_shards, shard = 16, 8
    sched = pkg.jobs.JobScheduler(
        net.client("L"),
        lambda: list(live),
        jobs={"j": make_workload(n_shards * shard)},
        shard_size=shard,
    )
    sched.is_leading = True
    sched._start({})

    def worker():
        while sched.has_dispatchable() or sched.jobs["j"].running:
            if sched.dispatch_all_once() == 0 and not sched.jobs["j"].running:
                return

    t0 = _time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    wall = _time.perf_counter() - t0
    serial = n_shards * delay
    job = sched.jobs["j"]
    assert job.finished == n_shards * shard and job.correct == job.finished
    assert wall < serial * 0.6, f"no speedup: wall={wall:.3f}s vs serial={serial:.3f}s"


def test_out_of_order_results_flush_as_contiguous_prefix(pkg):
    """Shard 0 completes AFTER shard 1: shard 1 buffers (finished stays 0,
    the durable cursor never skips a gap), then shard 0 flushes both."""
    net = pkg.rpc.SimRpcNetwork()
    gate = threading.Event()

    def slow(synsets):
        assert gate.wait(10)
        return echo_backend(synsets)

    net.serve("m0", pkg.worker.PredictWorker({"j": slow}).methods())
    net.serve("m1", pkg.worker.PredictWorker({"j": echo_backend}).methods())
    sched = pkg.jobs.JobScheduler(
        net.client("L"), lambda: ["m0", "m1"], jobs={"j": make_workload(16)}, shard_size=8
    )
    sched.is_leading = True
    sched._start({})
    job = sched.jobs["j"]
    assert job.assigned == ["m0", "m1"]

    t = threading.Thread(target=sched.dispatch_once, args=("j",))
    t.start()  # reserves offset 0 -> m0 (round-robin), blocks on the gate
    deadline = _time.monotonic() + 10
    while 0 not in job.outstanding and _time.monotonic() < deadline:
        _time.sleep(0.005)
    assert job.outstanding.get(0) == {"m0"}

    completed = sched.dispatch_once("j")  # offset 8 -> m1, completes first
    assert completed == 8  # completed work, but buffered behind the gap:
    assert job.finished == 0 and 8 in job.buffered  # cursor never skips

    gate.set()
    t.join(timeout=10)
    assert job.finished == 16 and job.correct == 16 and job.done


def test_failed_shard_retries_excluding_failed_member(pkg):
    net = pkg.rpc.SimRpcNetwork()

    def broken(synsets):
        raise RuntimeError("wedged accelerator")

    net.serve("m0", pkg.worker.PredictWorker({"j": broken}).methods())
    net.serve("m1", pkg.worker.PredictWorker({"j": echo_backend}).methods())
    sched = pkg.jobs.JobScheduler(
        net.client("L"), lambda: ["m0", "m1"], jobs={"j": make_workload(8)}, shard_size=8
    )
    sched.is_leading = True
    sched._start({})
    assert sched.dispatch_once("j") == 0  # m0 fails the shard
    job = sched.jobs["j"]
    assert job.retry_q and job.retry_q[0][0] == 0 and "m0" in job.retry_q[0][1]
    assert sched.dispatch_once("j") == 8  # retried on m1, not m0
    assert job.finished == 8 and job.correct == 8


def test_concurrent_crash_mid_run_keeps_exactly_once(pkg):
    """Members crash while 4 dispatcher threads are in flight: every query
    still counts exactly once."""
    net = pkg.rpc.SimRpcNetwork()
    live = [f"m{i}" for i in range(4)]

    def backend(synsets):
        _time.sleep(0.002)
        return echo_backend(synsets)

    _sim_members(pkg, net, live, backend)
    total = 64 * 8
    sched = pkg.jobs.JobScheduler(
        net.client("L"), lambda: list(live), jobs={"j": make_workload(total)}, shard_size=8
    )
    sched.is_leading = True
    sched._start({})

    def worker():
        while True:
            sched.assign_once()
            if sched.dispatch_all_once() == 0 and not sched.jobs["j"].running:
                return

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    _time.sleep(0.05)
    net.crash("m2")
    live.remove("m2")
    _time.sleep(0.05)
    net.crash("m0")
    live.remove("m0")
    for t in threads:
        t.join(timeout=30)
    job = sched.jobs["j"]
    assert job.finished == total
    assert job.correct == total  # exactly once: no double counts, no losses


def test_tail_hedging_backs_up_stragglers(pkg):
    """Once fresh shards run out, idle dispatchers re-send the oldest
    outstanding shard to a DIFFERENT member; whichever answer lands first
    counts, the other is a dedup'd no-op — exactly once either way."""
    f = Fixture(pkg, n_members=4, n_queries=32, shard=16)
    f.scheduler._start({})
    job = f.scheduler.jobs["resnet18"]
    # Latency evidence: hedging is gated on 2x the observed median shard
    # latency (no evidence -> no hedge). The fake timer advances 5 ms per
    # call, so anything beyond a 2 ms threshold is "slow".
    for _ in range(5):
        job.shard_stats.record(0.001)

    # Reserve both fresh shards without completing them (in flight).
    first = f.scheduler.next_shard("resnet18")
    second = f.scheduler.next_shard("resnet18")
    assert first is not None and second is not None
    assert job.next_offset >= len(job.queries)

    # Next reservation is a HEDGE of the oldest outstanding offset, on a
    # member other than the original assignee.
    hedge = f.scheduler.next_shard("resnet18")
    assert hedge is not None
    h_member, h_offset, h_shard, h_excluded = hedge
    assert h_offset == first[1]
    assert h_member != first[0] and first[0] in h_excluded
    # Two copies in flight max: the next idle reservation hedges the OTHER
    # shard, and after that there is nothing left to hand out.
    hedge2 = f.scheduler.next_shard("resnet18")
    assert hedge2 is not None and hedge2[1] == second[1]
    assert f.scheduler.next_shard("resnet18") is None

    # Hedge answer lands first and counts; the straggler's late answer is a
    # duplicate no-op.
    preds = [int(s[1:]) for s, _ in h_shard]
    assert f.scheduler._record_result(job, h_offset, h_shard, preds, 0.1, h_member) == len(h_shard)
    assert f.scheduler._record_result(job, first[1], h_shard, preds, 9.9, first[0]) == 0
    assert job.finished == len(h_shard) and job.correct == len(h_shard)


def test_hedge_failure_bookkeeping_keeps_other_copy_alive(pkg):
    """One copy failing must not forget the other in-flight copy, must not
    requeue while it lives, and a later requeue excludes every member that
    failed the shard."""
    f = Fixture(pkg, n_members=8, n_queries=16, shard=16)  # 4 assigned per job
    f.scheduler._start({})
    job = f.scheduler.jobs["resnet18"]
    for _ in range(5):
        job.shard_stats.record(0.001)  # latency evidence enabling hedges
    original = f.scheduler.next_shard("resnet18")
    hedge = f.scheduler.next_shard("resnet18")
    offset = original[1]
    assert hedge[1] == offset and job.outstanding[offset] == {original[0], hedge[0]}

    # The ORIGINAL fails: the hedge stays tracked, nothing is requeued yet.
    f.scheduler._record_failure(job, offset, original[0], original[3])
    assert job.outstanding[offset] == {hedge[0]}
    assert not job.retry_q
    # Idle dispatchers may now back up the surviving copy again — but never
    # on the member that already failed it.
    rehedge = f.scheduler.next_shard("resnet18")
    assert rehedge is not None and rehedge[1] == offset
    assert rehedge[0] not in {original[0], hedge[0]}

    # Everything in flight fails -> ONE requeue excluding all failed members.
    f.scheduler._record_failure(job, offset, hedge[0], hedge[3])
    assert not job.retry_q
    f.scheduler._record_failure(job, offset, rehedge[0], rehedge[3])
    assert len(job.retry_q) == 1
    requeued_offset, excluded = job.retry_q[0]
    assert requeued_offset == offset
    assert {original[0], hedge[0], rehedge[0]} <= excluded


def test_hedging_disabled_reserves_nothing_extra(pkg):
    f = Fixture(pkg, n_members=4, n_queries=16, shard=16)
    f.scheduler.hedge_tail = False
    f.scheduler._start({})
    f.scheduler.jobs["resnet18"].shard_stats.record(0.001)
    assert f.scheduler.next_shard("resnet18") is not None
    assert f.scheduler.next_shard("resnet18") is None  # no hedge branch


def test_hedging_waits_for_latency_evidence(pkg):
    """Without any observed shard latency — or before the in-flight copy is
    actually slow — idle dispatchers must NOT duplicate work."""
    f = Fixture(pkg, n_members=4, n_queries=16, shard=16)
    f.scheduler._start({})
    job = f.scheduler.jobs["resnet18"]
    assert f.scheduler.next_shard("resnet18") is not None
    # No latency evidence at all: no hedge.
    assert f.scheduler.next_shard("resnet18") is None
    assert f.scheduler.has_dispatchable() in (True, False)  # must not crash
    # Evidence of a LONG median: the in-flight copy is not yet slow.
    for _ in range(5):
        job.shard_stats.record(100.0)
    assert f.scheduler.next_shard("resnet18") is None


def test_chip_weighted_placement(pkg):
    """A 4-chip host draws ~4x the shards of 1-chip hosts (north star:
    ICI-local placement proportional to per-host chip topology)."""
    net = pkg.rpc.SimRpcNetwork()
    live = ["big", "small0", "small1"]
    served = {m: 0 for m in live}

    def backend_for(m):
        def fn(synsets):
            served[m] += 1
            return echo_backend(synsets)

        return fn

    for m in live:
        net.serve(m, pkg.worker.PredictWorker({"j": backend_for(m)}).methods())
    weights = {"big": 4, "small0": 1, "small1": 1}
    sched = pkg.jobs.JobScheduler(
        net.client("L"),
        lambda: list(live),
        jobs={"j": make_workload(24 * 8)},
        shard_size=8,
        member_weight=lambda addr: weights[addr],
    )
    sched.is_leading = True
    sched._start({})
    sched.run_to_completion()
    job = sched.jobs["j"]
    assert job.finished == 24 * 8
    assert served["big"] == 16 and served["small0"] == 4 and served["small1"] == 4
    # Per-member latency appears in the report.
    rep = job.report()
    assert set(rep["member_latency"]) == set(live)
    assert rep["member_latency"]["big"]["count"] == 16


# ---------------------------------------------------------------------------
# gang scheduling over a registered mesh group
# ---------------------------------------------------------------------------


class GangEcho:
    """Fake gang-capable backend: answers its rank's slice with the class
    encoded in the synset id, and records every (rank, world, n) call."""

    def __init__(self, log):
        self.log = log

    def __call__(self, synsets):
        raise AssertionError("gang job must never take the per-member path")

    def predict_gang(self, synsets, rank, world):
        self.log.append((rank, world, len(synsets)))
        start, stop = JAX.worker.gang_slice(len(synsets), rank, world)
        return [int(s[1:]) for s in synsets[start:stop]]


def _gang_fixture(pkg, n_queries=40, shard=8):
    net = pkg.rpc.SimRpcNetwork()
    live = ["m0", "m1"]
    calls = {m: [] for m in live}
    for m in live:
        net.serve(m, JAX.worker.PredictWorker({"resnet18": GangEcho(calls[m])}).methods())
    sched = pkg.jobs.JobScheduler(
        net.client("L"),
        lambda: list(live),
        jobs={"resnet18": make_workload(n_queries)},
        shard_size=shard,
        mesh_group=lambda: {"m0": 0, "m1": 1},
    )
    sched.is_leading = True
    net.serve("L", sched.methods())
    return net, sched, calls


def test_gang_stale_assignment_not_dispatchable(pkg):
    """ADVICE r3: while a mesh group is registered but the job's assignment
    does not match it yet (stale, pre-assign), dispatch_once is a no-op —
    has_dispatchable must say False so dispatcher threads sleep instead of
    busy-spinning; once the assignment matches, work counts again."""
    net, sched, calls = _gang_fixture(pkg, n_queries=40, shard=8)
    sched._start({})
    # Pre-assign: job started, mesh registered, no assignment yet.
    assert sched.jobs["resnet18"].running
    sched.jobs["resnet18"].assigned = ["m0"]  # stale: not the mesh group
    assert not sched.has_dispatchable()
    assert sched.dispatch_once("resnet18") == 0
    sched.assign_once()  # reconciles assignment to the mesh group
    assert sched.has_dispatchable()
    sched.run_to_completion()
    assert sched.jobs["resnet18"].finished == 40
    assert not sched.has_dispatchable()


def test_gang_dispatch_collective_shards_exactly_once(pkg):
    """A job whose assigned members are exactly the registered mesh group
    dispatches every shard to ALL of them (one collective execution per
    shard), reassembles rank-ordered slices, counts each query once, and
    reports the gang in the jobs report."""
    net, sched, calls = _gang_fixture(pkg, n_queries=40, shard=8)
    sched._start({})
    sched.assign_once()
    sched.run_to_completion()
    job = sched.jobs["resnet18"]
    assert job.finished == 40 and job.correct == 40  # slices reassembled in order
    rep = job.report()
    assert rep["gang_shards"] == 5  # every shard served collectively
    # Every shard reached BOTH processes with the full synset list.
    assert len(calls["m0"]) == 5 and len(calls["m1"]) == 5
    assert all(c == (0, 2, 8) for c in calls["m0"])
    assert all(c == (1, 2, 8) for c in calls["m1"])


def test_gang_member_failure_requeues_whole_shard(pkg):
    """All-or-nothing: one process failing fails the collective shard; it
    requeues whole and completes once the fleet is healthy again — no
    partial credit, no double count."""
    net, sched, calls = _gang_fixture(pkg, n_queries=16, shard=8)
    sched._start({})
    sched.assign_once()
    net.crash("m1")
    assert sched.dispatch_once("resnet18") == 0  # gang fails, shard requeued
    assert sched.jobs["resnet18"].retry_q
    net.restart("m1")
    sched.run_to_completion()
    job = sched.jobs["resnet18"]
    assert job.finished == 16 and job.correct == 16
    assert job.report()["gang_shards"] == 2  # the retried shard counted once


def test_gang_falls_back_to_member_dispatch_while_mesh_unregistered(pkg):
    """mesh_group -> None (mesh not fully registered / not configured):
    ordinary per-member dispatch through __call__ backends."""
    net = pkg.rpc.SimRpcNetwork()
    live = ["m0", "m1", "m2"]
    for m in live:
        net.serve(
            m,
            pkg.worker.PredictWorker(
                {"resnet18": lambda synsets: [int(s[1:]) for s in synsets]}
            ).methods(),
        )
    sched = pkg.jobs.JobScheduler(
        net.client("L"),
        lambda: list(live),
        jobs={"resnet18": make_workload(24)},
        shard_size=8,
        mesh_group=lambda: None,  # registration incomplete
    )
    sched.is_leading = True
    sched._start({})
    sched.assign_once()
    sched.run_to_completion()
    job = sched.jobs["resnet18"]
    assert job.finished == 24 and job.correct == 24
    assert job.report()["gang_shards"] == 0


def test_registered_mesh_group_owns_assignment_and_never_solo_dispatches(pkg):
    """While a mesh group is registered, jobs are assigned the WHOLE group
    (even with extra non-mesh members active) and shards only ever go out
    as collectives — a per-member job.predict against a global-mesh backend
    would fail on every member forever (the round-3 review's livelock)."""
    net = pkg.rpc.SimRpcNetwork()
    live = ["m0", "m1", "m2"]  # m2 active but outside the mesh
    calls = {m: [] for m in live}
    for m in live:
        net.serve(m, JAX.worker.PredictWorker({"resnet18": GangEcho(calls[m])}).methods())
    sched = pkg.jobs.JobScheduler(
        net.client("L"),
        lambda: list(live),
        jobs={"resnet18": make_workload(24)},
        shard_size=8,
        mesh_group=lambda: {"m0": 0, "m1": 1},
    )
    sched.is_leading = True
    sched._start({})
    # Force a stale assignment (as if assigned before mesh registration):
    # dispatch must WAIT for the next assign pass, not solo-dispatch
    # (GangEcho.__call__ raises if the per-member path is ever taken).
    sched.jobs["resnet18"].assigned = ["m0", "m2"]
    assert sched.dispatch_once("resnet18") == 0
    sched.assign_once()
    assert sched.jobs["resnet18"].assigned == ["m0", "m1"]  # the group, not m2
    sched.run_to_completion()
    job = sched.jobs["resnet18"]
    assert job.finished == 24 and job.correct == 24
    assert job.report()["gang_shards"] == 3
    assert calls["m2"] == []


def test_gang_config_error_trips_breaker_and_surfaces(pkg):
    """A method-level refusal (config incompatibility) fails identically on
    every retry: after the cap the job STOPS with the error in the report
    instead of hot-spinning; `predict` re-arms it. Unreachability (tested
    in test_gang_member_failure_requeues_whole_shard) never trips it."""

    class Refuses:
        def __call__(self, synsets):
            raise AssertionError("per-member path must not be used")

        def predict_gang(self, synsets, rank, world):
            raise ValueError("batch 64 not divisible by 5 processes")

    net = pkg.rpc.SimRpcNetwork()
    live = ["m0", "m1"]
    for m in live:
        net.serve(m, JAX.worker.PredictWorker({"resnet18": Refuses()}).methods())
    sched = pkg.jobs.JobScheduler(
        net.client("L"),
        lambda: list(live),
        jobs={"resnet18": make_workload(16)},
        shard_size=8,
        mesh_group=lambda: {"m0": 0, "m1": 1},
    )
    sched.is_leading = True
    sched._start({})
    for _ in range(sched.gang_max_consec_failures + 2):
        sched.dispatch_once("resnet18")
    job = sched.jobs["resnet18"]
    assert not job.running
    assert "not divisible" in job.report()["last_error"]
    assert job.finished == 0
    # Operator fixes the config and retries: predict re-arms the job.
    sched._start({})
    assert job.running and job.report()["last_error"] == ""


class GangStagingEcho(GangEcho):
    """GangEcho + decode staging: records prefetch decodes and answers
    predict from them, like EngineBackend's staging contract."""

    def __init__(self, log):
        super().__init__(log)
        self.decodes = []

    def decode_gang(self, synsets, rank, world):
        self.decodes.append((rank, world, len(synsets)))
        return True


def test_gang_decode_prefetch_counted_per_rank(pkg):
    """Every gang shard gets a decode-prefetch phase on every rank before
    its collective; the leader counts staged ranks in the job report."""
    net, sched, calls = _gang_fixture(pkg, n_queries=40, shard=8)
    # Re-wire with staging-capable backends so decodes are observable.
    workers = {}
    for m in ("m0", "m1"):
        w = GangStagingEcho([])
        workers[m] = w
        net.serve(m, JAX.worker.PredictWorker({"resnet18": w}).methods())
    sched._start({})
    sched.assign_once()
    sched.run_to_completion()
    job = sched.jobs["resnet18"]
    assert job.finished == 40 and job.gang_shards == 5
    assert job.report()["gang_staged_ranks"] == 10  # 5 shards x 2 ranks
    assert len(workers["m0"].decodes) == 5 and len(workers["m1"].decodes) == 5


def test_gang_decode_overlaps_collective_execution(pkg):
    """VERDICT r3 weak #5: decode of shard N+1 must run WHILE shard N's
    collective executes. Rank 0's collective blocks until it observes a
    prefetch decode for a DIFFERENT shard — it can only be released if the
    decode phase runs outside the gang serialization. A fully serialized
    implementation (decode inside the gang lock, or no prefetch at all)
    times out here."""
    import threading
    import time as _time

    net, sched, _ = _gang_fixture(pkg, n_queries=16, shard=8)
    state_lock = threading.Lock()
    decodes: set = set()
    overlap_proven = []

    class OverlapWitness(GangEcho):
        def __init__(self, blocking):
            super().__init__([])
            self.blocking = blocking

        def decode_gang(self, synsets, rank, world):
            with state_lock:
                decodes.add(tuple(synsets))
            return True

        def predict_gang(self, synsets, rank, world):
            if self.blocking:
                deadline = _time.time() + 5
                while _time.time() < deadline:
                    with state_lock:
                        if any(d != tuple(synsets) for d in decodes):
                            overlap_proven.append(True)
                            break
                    _time.sleep(0.005)
            return super().predict_gang(synsets, rank, world)

    net.serve("m0", JAX.worker.PredictWorker({"resnet18": OverlapWitness(blocking=True)}).methods())
    net.serve("m1", JAX.worker.PredictWorker({"resnet18": OverlapWitness(blocking=False)}).methods())
    sched._start({})
    sched.assign_once()
    threads = [
        threading.Thread(target=sched.dispatch_once, args=("resnet18",))
        for _ in range(2)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert overlap_proven, "no decode for another shard arrived during execution"
    sched.run_to_completion()
    assert sched.jobs["resnet18"].finished == 16
