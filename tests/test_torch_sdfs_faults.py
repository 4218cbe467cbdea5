"""Crash durability and integrity of the port's SDFS under disk faults,
against the JAX package's: the cases of tests/test_sdfs_faults.py (digests
at every hop, quarantine on rot, restart recovery from the sidecars, the
anti-entropy scrub, the fault injector of cluster/faults.py and the seeded
soak of bit rot and partitions), each run once against each package on
that package's SimRpcNetwork; and the port's durable-write helpers
(cluster/diskio.py), its crash-point injector and its flight recorder
(cluster/flight.py) against the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import os
import random

import pytest
from torch_sides import JAX, PORT, pkg  # noqa: F401  (fixture)

SEED_BASE = int(os.environ.get("DMLC_CHAOS_SEED", "0"))


def seeds(n: int) -> range:
    return range(SEED_BASE, SEED_BASE + n)


class Cluster:
    """SimRpc SDFS fleet of one package with restartable members (same
    dirs, fresh MemberStore = a process restart) and optional per-member
    FaultyIo."""

    def __init__(self, pkg, tmp_path, n=5, rf=3):
        self.pkg = pkg
        self.tmp = tmp_path
        self.net = self.pkg.rpc.SimRpcNetwork()
        self.live = [f"m{i}" for i in range(n)]
        self.stores: dict = {}
        for addr in self.live:
            self._serve(addr)
        self._serve_leader()

    def _serve(self, addr, io=None):
        store = self.pkg.sdfs.MemberStore(self.tmp / addr, io=io)
        self.net.serve(addr, self.pkg.sdfs.SdfsMember(store, self.net.client(addr)).methods())
        self.stores[addr] = store
        return store

    def _serve_leader(self) -> None:
        self.leader = self.pkg.sdfs.SdfsLeader(
            self.net.client("L"), lambda: list(self.live),
            replication_factor=min(3, len(self.live)),
        )
        self.net.serve("L", self.leader.methods())

    def client(self, addr="m0"):
        return self.pkg.sdfs.SdfsClient(self.net.client(addr), "L", self.stores[addr], addr)

    def restart_member(self, addr, io=None):
        return self._serve(addr, io=io)

    def announce(self, addr) -> dict:
        """What node.py's probe loop does after a restart: push the
        recovered inventory, apply the leader's dead/corrupt verdicts."""
        reply = self.net.client(addr).call(
            "L", "sdfs.announce",
            {"member": addr, "inventory": self.stores[addr].inventory()},
        )
        for name in reply["dead"]:
            self.stores[addr].delete(name)
        for name, v in reply["corrupt"]:
            self.stores[addr].quarantine(name, int(v))
        return reply

    def scrub_and_report(self, addr) -> list:
        """What node.py's scrub loop does each tick (full pass here)."""
        _, corrupt = self.stores[addr].scrub_once(None)
        for name, version in corrupt:
            self.net.client(addr).call(
                "L", "sdfs.report_corrupt",
                {"name": name, "version": version, "member": addr},
            )
        return corrupt

    def restart_fleet(self) -> None:
        """Full-fleet restart: every member recovers from disk, a FRESH
        leader (empty directory) rebuilds from member announces."""
        for addr in self.live:
            self.restart_member(addr)
        self._serve_leader()
        for addr in self.live:
            self.announce(addr)


@pytest.fixture
def cluster(pkg, tmp_path):
    return Cluster(pkg, tmp_path)


# ---------------------------------------------------------------------------
# digests end-to-end
# ---------------------------------------------------------------------------


def test_put_records_and_returns_content_digest(pkg, cluster):
    payload = b"digest-me" * 100
    reply = cluster.client().put_bytes(payload, "f")
    expected = hashlib.sha256(payload).hexdigest()
    assert reply["digest"] == expected
    assert cluster.leader.state.digest_of("f", 1) == expected
    # Every replica committed the digest in its sidecar.
    for r in reply["replicas"]:
        assert cluster.stores[r].digest_of("f", 1) == expected
    # And get re-verifies against it.
    assert cluster.client("m1").get_bytes("f")[1] == payload


def test_member_read_detects_rot_and_quarantines(pkg, cluster):
    reply = cluster.client().put_bytes(b"will-rot", "f")
    victim = reply["replicas"][0]
    pkg.faults.corrupt_stored(cluster.stores[victim], "f", 1, seed=3)
    with pytest.raises(pkg.sdfs.IntegrityError) as e:
        cluster.stores[victim].read("f", 1)
    assert pkg.sdfs.is_integrity_error(e.value)
    # Quarantined: no longer listed, no longer served, parked on disk.
    assert "f" not in cluster.stores[victim].listing()
    quarantined = list((cluster.stores[victim].dir / ".quarantine").iterdir())
    assert quarantined


def test_get_falls_back_past_corrupt_replica_and_reports(pkg, cluster):
    """THE acceptance scenario, part 1: one flipped bit in a stored replica
    is detected on read, never reaches the caller, and the leader drops the
    rotten copy so healing replaces it from verified sources."""
    payload = b"precious-bytes" * 1000
    digest = hashlib.sha256(payload).hexdigest()
    cluster.client().put_bytes(payload, "f")
    replicas = cluster.leader.state.replicas_of("f", 1)
    victim = replicas[0]  # the first replica the client will try
    pkg.faults.corrupt_stored(cluster.stores[victim], "f", 1, seed=9)

    version, data = cluster.client("m0").get_bytes("f")
    assert (version, data) == (1, payload), "corruption must never reach the caller"
    # The verifying read convicted the victim to the leader.
    assert victim not in cluster.leader.state.replicas_of("f", 1)

    # Healing restores rf, sourcing only from clean copies.
    assert cluster.leader.heal_once() >= 1
    healed = cluster.leader.state.replicas_of("f", 1)
    assert len(healed) == 3 and victim not in healed
    for r in healed:
        assert pkg.diskio.hash_file(cluster.stores[r].blob_path("f", 1)) == digest


def test_scrub_quarantines_rot_and_heal_restores_rf(pkg, cluster):
    """Part 2: at-rest rot with NO reader — the anti-entropy scrub finds
    it, quarantines, reports, and heal re-places from verified replicas."""
    payload = b"scrub-target" * 500
    cluster.client().put_bytes(payload, "f")
    cluster.client().put_bytes(b"clean-sibling", "g")
    victim = cluster.leader.state.replicas_of("f", 1)[1]
    pkg.faults.corrupt_stored(cluster.stores[victim], "f", 1, seed=4)

    assert cluster.scrub_and_report(victim) == [("f", 1)]
    assert "f" not in cluster.stores[victim].listing()
    assert victim not in cluster.leader.state.replicas_of("f", 1)

    assert cluster.leader.heal_once() >= 1
    healed = cluster.leader.state.replicas_of("f", 1)
    assert len(healed) == 3 and victim not in healed
    digest = hashlib.sha256(payload).hexdigest()
    for r in healed:
        assert pkg.diskio.hash_file(cluster.stores[r].blob_path("f", 1)) == digest


def test_scrub_cursor_covers_store_incrementally(pkg, tmp_path):
    store = pkg.sdfs.MemberStore(tmp_path / "s")
    for i in range(5):
        store.receive(f"f{i}", 1, f"payload-{i}".encode())
    seen = 0
    for _ in range(3):
        scanned, corrupt = store.scrub_once(2)
        assert corrupt == []
        seen += scanned
    assert seen == 6  # 3 passes x 2 blobs wrapped around the 5-blob store


def test_heal_falls_back_to_other_sources_when_first_is_corrupt(pkg, cluster):
    """Satellite: heal_once used to copy only from live_replicas[0] and
    skip the file for a whole pass on failure. A corrupt first source must
    be probed past (and convicted) within ONE pass."""
    payload = b"heal-source-fallback" * 200
    cluster.client().put_bytes(payload, "f")
    replicas = cluster.leader.state.replicas_of("f", 1)
    # Kill the last replica so healing is needed; rot the FIRST source.
    dead = replicas[-1]
    cluster.live.remove(dead)
    cluster.net.crash(dead)
    pkg.faults.corrupt_stored(cluster.stores[replicas[0]], "f", 1, seed=1)

    copies = cluster.leader.heal_once()
    assert copies >= 1, "one pass must heal despite the corrupt first source"
    healed = cluster.leader.state.replicas_of("f", 1)
    # The corrupt source was convicted mid-pass and dropped.
    assert replicas[0] not in healed
    digest = hashlib.sha256(payload).hexdigest()
    for r in healed:
        assert pkg.diskio.hash_file(cluster.stores[r].blob_path("f", 1)) == digest


# ---------------------------------------------------------------------------
# restart recovery
# ---------------------------------------------------------------------------


def test_member_restart_recovers_inventory_and_heals_zero(pkg, cluster):
    """Satellite: a member whose process restarts rebuilds `versions` from
    its sidecars, re-announces, and the next heal pass copies NOTHING."""
    cluster.client().put_bytes(b"survive-restart", "f")
    cluster.client().put_bytes(b"survive-too", "g")
    replicas = set(cluster.leader.state.replicas_of("f", 1))
    victim = next(iter(replicas))

    fresh = cluster.restart_member(victim)
    assert fresh.listing() != {}, "restart must recover the on-disk replicas"
    cluster.announce(victim)
    assert cluster.leader.heal_once() == 0, (
        "a recovered + re-announced member needs no re-replication"
    )
    assert set(cluster.leader.state.replicas_of("f", 1)) == replicas


def test_full_fleet_restart_serves_blob_with_matching_digest(pkg, cluster):
    """THE acceptance scenario, part 3: after detect/quarantine/heal, a
    FULL-fleet restart (fresh leader, members recovered from disk) still
    serves the blob end-to-end with a verified digest."""
    payload = b"fleet-restart-payload" * 300
    cluster.client().put_bytes(payload, "f")
    victim = cluster.leader.state.replicas_of("f", 1)[0]
    pkg.faults.corrupt_stored(cluster.stores[victim], "f", 1, seed=7)
    cluster.scrub_and_report(victim)
    cluster.leader.heal_once()

    cluster.restart_fleet()
    version, data = cluster.client("m1").get_bytes("f")
    assert (version, data) == (1, payload)
    digest = hashlib.sha256(payload).hexdigest()
    assert cluster.leader.state.digest_of("f", 1) == digest


def test_announce_respects_delete_tombstones(pkg, cluster):
    """A replica that missed a delete and then restarts must not resurrect
    the blob: the announce reply tells it the name is dead and it drops
    the bytes."""
    cluster.client().put_bytes(b"doomed", "f")
    straggler = cluster.leader.state.replicas_of("f", 1)[0]
    cluster.net.crash(straggler)  # misses the delete
    cluster.client("m" + str((int(straggler[1:]) + 1) % len(cluster.live))).delete("f")
    cluster.net.restart(straggler)

    fresh = cluster.restart_member(straggler)
    assert "f" in fresh.listing()  # still on disk after recovery...
    reply = cluster.announce(straggler)
    assert "f" in reply["dead"]
    assert "f" not in fresh.listing()  # ...dropped on the leader's verdict
    assert "f" not in cluster.leader.state.directory


def test_announce_flags_digest_divergent_copies(pkg, cluster):
    """A recovered copy whose SIDECAR digest disagrees with the directory
    (e.g. rot that also hit the sidecar, or a torn historical write) is
    never re-recorded — the member is told to quarantine it."""
    cluster.client().put_bytes(b"authentic", "f")
    victim = cluster.leader.state.replicas_of("f", 1)[0]
    store = cluster.stores[victim]
    # Rewrite the victim's copy wholesale (bytes AND sidecar digest drift).
    store.receive("f", 1, b"imposter-bytes")
    cluster.leader.state.drop_replica("f", 1, victim)

    reply = cluster.announce(victim)
    assert ["f", 1] in reply["corrupt"]
    assert victim not in cluster.leader.state.replicas_of("f", 1)
    assert "f" not in store.listing()  # quarantined locally


# ---------------------------------------------------------------------------
# fault injection (cluster/faults.py)
# ---------------------------------------------------------------------------


def test_torn_rename_leaves_no_committed_blob(pkg, tmp_path):
    io = pkg.faults.FaultyIo(seed=0).arm("rename", "torn_rename")
    store = pkg.sdfs.MemberStore(tmp_path / "s", io=io)
    with pytest.raises(OSError):
        store.receive("f", 1, b"never-lands")
    assert store.listing() == {}
    # Restart: recovery finds nothing half-committed either.
    fresh = pkg.sdfs.MemberStore(tmp_path / "s")
    assert fresh.listing() == {}
    assert io.injected == ["torn_rename"]


def test_torn_stage_is_unreadable(pkg, tmp_path):
    """Satellite: stage used to write non-atomically; a crash mid-stage
    must never leave a half-staged blob a replica pull could read."""
    io = pkg.faults.FaultyIo(seed=0).arm("rename", "torn_rename")
    store = pkg.sdfs.MemberStore(tmp_path / "s", io=io)
    with pytest.raises(OSError):
        store.stage("k", b"half-staged")
    with pytest.raises(KeyError):
        store.staged_size("k")
    assert list((tmp_path / "s" / ".staged").iterdir()) == []


def test_enospc_surfaces_and_store_stays_consistent(pkg, tmp_path):
    io = pkg.faults.FaultyIo(seed=0).arm("write", "enospc")
    store = pkg.sdfs.MemberStore(tmp_path / "s", io=io)
    with pytest.raises(OSError):
        store.receive("f", 1, b"wont-fit")
    assert store.listing() == {}
    store.receive("f", 1, b"fits-now")  # fault was one-shot; store recovers
    assert store.read("f", 1) == b"fits-now"


def test_bitflipped_write_detected_on_read(pkg, tmp_path):
    io = pkg.faults.FaultyIo(seed=5).arm("write", "bitflip")
    store = pkg.sdfs.MemberStore(tmp_path / "s", io=io)
    store.receive("f", 1, b"x" * 256)  # silently lands corrupted
    assert io.injected == ["bitflip"]
    with pytest.raises(pkg.sdfs.IntegrityError):
        store.read("f", 1)
    assert "f" not in store.listing()  # quarantined


def test_truncated_write_discarded_at_restart(pkg, tmp_path):
    io = pkg.faults.FaultyIo(seed=5).arm("write", "truncate")
    store = pkg.sdfs.MemberStore(tmp_path / "s", io=io)
    store.receive("f", 1, b"y" * 512)
    fresh = pkg.sdfs.MemberStore(tmp_path / "s")  # size vs sidecar mismatch -> dropped
    assert fresh.listing() == {}


def test_verified_receive_rejects_corrupt_frame(pkg, tmp_path):
    store = pkg.sdfs.MemberStore(tmp_path / "s")
    good = hashlib.sha256(b"real").hexdigest()
    with pytest.raises(pkg.sdfs.IntegrityError):
        store.receive("f", 1, b"fake", digest=good)
    assert store.listing() == {}  # nothing touched disk
    store.receive("f", 1, b"real", digest=good)
    assert store.read("f", 1) == b"real"


# ---------------------------------------------------------------------------
# combined chaos: disk faults x partitions (seeded, deterministic)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", seeds(3))
def test_bitrot_and_partition_chaos_never_spreads_corruption(pkg, tmp_path, seed):
    """Seeded soak combining the SimRpc partition faults with at-rest bit
    flips: whatever interleaving the seed draws, (1) a get never returns
    corrupt bytes, and (2) at quiescence every directory-listed replica's
    on-disk bytes hash to the put digest — corruption never crossed onto a
    healthy replica via healing."""
    rng = random.Random(seed)
    cl = Cluster(pkg, tmp_path, n=6, rf=3)
    payload = bytes(rng.randrange(256) for _ in range(4096))
    digest = hashlib.sha256(payload).hexdigest()
    cl.client().put_bytes(payload, "blob")

    partitioned: set[str] = set()
    for _ in range(25):
        roll = rng.random()
        replicas = cl.leader.state.replicas_of("blob", 1)
        if roll < 0.25 and replicas:
            # Rot one current replica's bytes at rest.
            victim = rng.choice(replicas)
            if "blob" in cl.stores[victim].listing():
                pkg.faults.corrupt_stored(cl.stores[victim], "blob", 1, seed=rng.randrange(1 << 30))
        elif roll < 0.5 and len(partitioned) < 2:
            m = rng.choice(cl.live)
            cl.net.partition("L", m)
            partitioned.add(m)
        elif roll < 0.7 and partitioned:
            m = partitioned.pop()
            cl.net.heal("L", m)
        # A reader may arrive at any point: it must get clean bytes or a
        # clean error — never rot.
        if rng.random() < 0.5:
            reader = rng.choice([m for m in cl.live if m not in partitioned])
            try:
                _, data = cl.client(reader).get_bytes("blob")
                assert data == payload, f"corrupt bytes served (seed {seed})"
            except pkg.rpc.RpcError:
                pass  # acceptable mid-fault; never acceptable: wrong bytes
        # Maintenance, as node.py's loops would run it (scrub on reachable
        # members only — partitioned ones can't report).
        for m in cl.live:
            if m not in partitioned:
                try:
                    cl.scrub_and_report(m)
                except pkg.rpc.RpcError:
                    pass
        cl.leader.heal_once()

    # Quiesce: heal partitions, full scrub + report everywhere, heal to rf.
    for m in list(partitioned):
        cl.net.heal("L", m)
    for m in cl.live:
        cl.scrub_and_report(m)
    for _ in range(4):
        cl.leader.heal_once()

    final = cl.leader.state.replicas_of("blob", 1)
    assert len(final) >= 3, f"rf not restored at quiescence (seed {seed})"
    for r in final:
        assert pkg.diskio.hash_file(cl.stores[r].blob_path("blob", 1)) == digest, (
            f"corruption crossed onto {r} (seed {seed})"
        )
    assert cl.client("m0").get_bytes("blob")[1] == payload


# ---------------------------------------------------------------------------
# transport satellite: send-side loss is observable
# ---------------------------------------------------------------------------


def test_udp_send_errors_are_counted(pkg):
    t = pkg.transport.UdpTransport("127.0.0.1", 0)
    try:
        t.send("127.0.0.1:not-a-port", {"x": 1})  # ValueError path
        t.send("127.0.0.1:not-a-port", {"x": 2})
        assert t.send_errors == 2
        t.send(t.address, {"x": 3})  # healthy send: not counted
        assert t.send_errors == 2
    finally:
        t.close()


# ---------------------------------------------------------------------------
# The two packages' injectors and helpers make the same disks
# ---------------------------------------------------------------------------


def faulty_run(side, tmp_path) -> tuple:
    """A seeded FaultyIo under a store: every write and rename may fault.
    The faults drawn, the outcome of each receive, and the recovered store."""
    io = side.faults.FaultyIo(seed=11, bitflip_rate=0.2, truncate_rate=0.2,
                              enospc_rate=0.1, torn_rename_rate=0.1)
    store = side.sdfs.MemberStore(tmp_path / side.name, io=io)
    outcomes = []
    for i in range(24):
        try:
            store.receive(f"f{i % 5}", i // 5 + 1, bytes(range(i, i + 200)))
            outcomes.append("ok")
        except OSError as e:
            outcomes.append(type(e).__name__)
    fresh = side.sdfs.MemberStore(tmp_path / side.name)
    readable = {}
    for name, versions in fresh.listing().items():
        for v in versions:
            try:
                readable[(name, v)] = fresh.read(name, v)
            except side.sdfs.IntegrityError:
                readable[(name, v)] = "integrity"
    return io.injected, outcomes, fresh.listing(), readable


def test_seeded_faulty_io_makes_the_same_store(tmp_path):
    got, want = faulty_run(PORT, tmp_path), faulty_run(JAX, tmp_path)
    assert got == want
    assert {"bitflip", "truncate", "enospc", "torn_rename"} <= set(want[0])


def crash_run(side, tmp_path, k: int | None) -> tuple:
    """Stage, commit and adopt through a CrashPointIo that kills the
    process at seam ``k``; the seams reached and what a restart recovers."""
    io = side.faults.CrashPointIo(hook=None if k is None else (lambda op: len(io.ops) == k))
    store = side.sdfs.MemberStore(tmp_path / f"{side.name}_{k}", io=io)
    try:
        store.receive("a", 1, b"first" * 50)
        store.stage("k", b"staged" * 40)
        store.receive("b", 1, b"second" * 60)
        scratch = store.incoming_path()
        scratch.write_bytes(b"adopted" * 30)
        store.adopt_file("c", 2, scratch)
    except side.faults.SimCrash:
        pass
    fresh = side.sdfs.MemberStore(tmp_path / f"{side.name}_{k}")
    return io.ops, io.crashed, fresh.listing(), fresh.inventory()


def test_crash_at_every_seam_recovers_the_same_store(tmp_path):
    seams, _, _, _ = crash_run(JAX, tmp_path, None)
    assert crash_run(PORT, tmp_path, None)[0] == seams
    for k in range(1, len(seams) + 1):
        got, want = crash_run(PORT, tmp_path, k), crash_run(JAX, tmp_path, k)
        assert got == want, f"crash at seam {k} ({seams[k - 1]})"
        assert want[1]


def test_durable_writes_match(tmp_path):
    data = bytes(range(256)) * 5000
    for side in (JAX, PORT):
        d = tmp_path / side.name
        d.mkdir()
        assert side.diskio.atomic_write(d / "w", data) == JAX.diskio.sha256_hex(data)
        assert side.diskio.atomic_copy(d / "w", d / "c") == hashlib.sha256(data).hexdigest()
        (d / "scratch").write_bytes(data[:999])
        side.diskio.atomic_install(d / "scratch", d / "i")
        assert side.diskio.hash_file(d / "i") == hashlib.sha256(data[:999]).hexdigest()
        assert sorted(x.name for x in d.iterdir()) == ["c", "i", "w"]
    assert PORT.diskio.COPY_CHUNK == JAX.diskio.COPY_CHUNK


def test_flight_recorder_matches(tmp_path):
    def run(side):
        t = [0.0]

        def clock():
            t[0] += 0.5
            return t[0]

        rec = side.flight.FlightRecorder(capacity=4, clock=clock, node="n1")
        for i in range(6):
            rec.note("shed", gate="microbatch", active=i)
        rec.note("scrub", corrupt=1)
        assert rec.dump(tmp_path / f"{side.name}.json", reason="test")
        assert not rec.dump(tmp_path / "missing" / "x.json")
        return rec.to_wire(), json.loads((tmp_path / f"{side.name}.json").read_text())

    got, want = run(PORT), run(JAX)
    assert got == want
    assert want[0]["dropped"] == 3 and want[1]["dump_reason"] == "test"
