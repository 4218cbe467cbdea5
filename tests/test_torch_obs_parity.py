"""The observability plane and the device monitor: the same seeded input
through both packages gives equal output.

- a seeded record and scrape stream through ``CostProfiler`` gives equal
  ``snapshot()``s, and a profile saved by either package warm-starts the
  other's ``CostProfiler.load`` with the same lanes;
- the same seeded spans give an equal ``critical_path``, ``breakdown``,
  analyzer snapshot and fleet table;
- the same table sequence gives an equal ``DriftSentinel.status()`` and the
  same flight notes and hooks;
- the same snapshots give byte-equal ``render_fleet_prometheus`` text;
- a virtual-clock ``device_work`` stream gives equal ``mfu_<model>`` gauges
  on the CPU (the analytic FLOPs of each registry included), and the same
  compile records give the same census and flight events.
"""

import random

import numpy as np
import pytest
from torch_sides import JAX, PORT


class VClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


MEMBERS = [f"10.0.0.{i}:8851" for i in range(4)]
STAGES = ["dispatch", "compute", "decode", "gen/step"]
MODELS = ["resnet18", "alexnet"]


def profiler_stream(side, seed: int):
    """A CostProfiler of ``side`` fed a seeded stream: direct records over
    a virtual clock, and cumulative span scrapes every tenth step."""
    rng = np.random.default_rng(seed)
    clock = VClock(50.0)
    p = side.profile.CostProfiler(window_s=10.0, windows=6, decay=0.6, clock=clock)
    cum = {m: {"count": 0, "total": 0.0} for m in MEMBERS}
    for step in range(400):
        clock.t += float(rng.exponential(0.4))
        p.record(MODELS[int(rng.integers(2))], MEMBERS[int(rng.integers(4))],
                 STAGES[int(rng.integers(4))], float(rng.gamma(2.0, 0.02)),
                 count=int(rng.integers(1, 65)))
        if step % 10 == 9:
            for m in MEMBERS:
                c = cum[m]
                n = int(rng.integers(0, 20))
                c["count"] += n
                c["total"] += n * float(rng.uniform(0.01, 0.1))
                if c["count"]:
                    p.ingest_scrape(m, {"spans": {"rpc/job.predict": {
                        "count": c["count"], "mean": c["total"] / c["count"]}}})
    return p, clock


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_profiler_snapshots_are_equal(seed):
    jax_p, _ = profiler_stream(JAX, seed)
    port_p, _ = profiler_stream(PORT, seed)
    snap = port_p.snapshot()
    assert snap == jax_p.snapshot()
    assert snap["profiles"]["resnet18"]  # the stream reached the lanes
    for m in MEMBERS:
        assert port_p.mean_cost(m) == jax_p.mean_cost(m)
    assert port_p.percentile(99) == jax_p.percentile(99)


@pytest.mark.parametrize("saver,loader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_saves_port_loads", "port_saves_jax_loads"])
def test_profile_saved_by_one_package_warm_starts_the_other(tmp_path, saver, loader):
    saved, clock = profiler_stream(saver, 7)
    path = tmp_path / "profile.json"
    assert saved.save(path)
    lanes = {}
    for side in (saver, loader):
        p = side.profile.CostProfiler(window_s=10.0, windows=6, decay=0.6,
                                      clock=VClock(clock.t))
        lanes[side.name] = (p.load(path), p.snapshot())
    assert lanes[loader.name][0] > 0
    assert lanes[loader.name] == lanes[saver.name]
    assert lanes[loader.name][1]["profiles"].keys() == saved.snapshot()["profiles"].keys()


def random_request(rng: random.Random, trace: str, t0: float) -> list[dict]:
    """One request as wire-form span events: a laned root, dispatch and
    gang fan-out children, pipelined decode/forward grandchildren, and now
    and then an orphan whose parent never arrived."""
    events = []
    counter = [0]

    def add(name, start, end, parent, lane, attrs):
        counter[0] += 1
        sid = f"{trace}.{counter[0]}"
        events.append({"name": name, "start": round(start, 4),
                       "dur": round(max(0.0, end - start), 4), "trace": trace,
                       "span": sid, "parent": parent, "lane": lane, "attrs": attrs})
        return sid

    model = rng.choice(MODELS)
    end = t0 + rng.uniform(0.5, 3.0)
    root = add("scheduler/dispatch", t0, end, None, MEMBERS[0], {"job": model})
    for _ in range(rng.randint(1, 3)):
        a = rng.uniform(t0, end)
        b = min(end + rng.uniform(-0.2, 0.3), a + rng.uniform(0.05, 2.0))
        lane = rng.choice(MEMBERS)
        child = add(rng.choice(["rpc/job.predict", "rpc/job.decode_gang"]), a, b, root,
                    lane, {"model": model})
        for _ in range(rng.randint(0, 2)):
            c = rng.uniform(a, b)
            add(rng.choice(["host/decode", "device/forward", "sdfs/pull"]), c,
                c + rng.uniform(0.01, (b - a)), child, lane, {})
    if rng.random() < 0.2:
        add("gen/step", t0 + 0.1, end + 0.2, f"{trace}.ghost", rng.choice(MEMBERS), {})
    return events


def request_stream(seed: int, n: int = 60) -> list[dict]:
    rng = random.Random(seed)
    events = []
    for i in range(n):
        events.extend(random_request(rng, f"t{seed}.{i}", 3.0 * i))
    return events


def charges(path) -> list:
    return [(s.span_id, s.name, s.lane, s.model, round(sec, 12)) for s, sec in path.charges]


@pytest.mark.parametrize("seed", [0, 1000, 2000])
def test_critical_paths_and_breakdowns_are_equal(seed):
    events = request_stream(seed)
    traces = {side.name: side.critpath.spans_from_wire(events) for side in (JAX, PORT)}
    assert traces["port"].keys() == traces["jax"].keys()
    for trace_id in traces["jax"]:
        want = JAX.critpath.critical_path(traces["jax"][trace_id])
        got = PORT.critpath.critical_path(traces["port"][trace_id])
        assert (got is None) == (want is None)
        if want is not None:
            assert charges(got) == charges(want)
            assert (got.total_s, got.orphans, got.model) == (want.total_s, want.orphans,
                                                              want.model)
    bd = PORT.critpath.breakdown(traces["port"])
    assert bd == JAX.critpath.breakdown(traces["jax"])
    assert set(bd) == set(MODELS)


def test_analyzer_snapshots_and_fleet_tables_are_equal():
    tables = {}
    for side in (JAX, PORT):
        clock = VClock(0.0)
        fleet = side.critpath.FleetCritPath()
        for i, member in enumerate(MEMBERS[:3]):
            an = side.critpath.CritPathAnalyzer(window_s=10.0, windows=8, clock=clock)
            for seed in range(3):
                events = request_stream(100 * i + seed, n=20)
                for e in events:  # each member owns its own roots
                    if e["parent"] is None:
                        e["lane"] = member
                an.ingest(events, own_lane=member)
                clock.t += 7.0
            fleet.fold(member, an.snapshot())
        tables[side.name] = (fleet.table(), [fleet.culprit(m) for m in MODELS])
    assert tables["port"] == tables["jax"]
    assert tables["port"][0]["members_reporting"] == 3


def sentinel_tables(seed: int) -> list[dict]:
    """Fleet tables over 14 ticks: a healthy baseline, then member n2's
    decode lane slows five-fold, then recovers."""
    rng = random.Random(seed)
    out = []
    for tick in range(14):
        models: dict = {}
        for member in ("n1", "n2", "n3"):
            slow = 5.0 if member == "n2" and 5 <= tick < 10 else 1.0
            samples = [slow * rng.uniform(0.9, 1.1) for _ in range(8)]
            body = models.setdefault("resnet18", {"requests": 8, "total_s": 0.0,
                                                  "lanes": []})
            body["lanes"].append({"stage": "decode", "member": member,
                                  "crit_s": sum(samples), "share": 1 / 3, "n": 8,
                                  "recent_n": 8, "samples": samples, "p50": 0.0,
                                  "p99": 0.0})
        out.append({"models": models})
    return out


@pytest.mark.parametrize("seed", [0, 1000, 2000])
def test_sentinel_states_are_equal(seed):
    got = {}
    for side in (JAX, PORT):
        notes, forces, replans, states = [], [], [], []
        s = side.sentinel.DriftSentinel(
            min_samples=5, confirm_windows=3, drift_factor=2.0, clear_factor=1.3,
            flight_note=lambda kind, _n=notes, **f: _n.append((kind, f)),
            force_sample=forces.append, request_replan=replans.append)
        for table in sentinel_tables(seed):
            fired = s.tick(table)
            states.append((fired, s.status(), s.alerting()))
        got[side.name] = (states, notes, forces, replans)
    assert got["port"] == got["jax"]
    assert got["port"][3] == ["latency_drift:resnet18:decode:n2"]


def fleet_snapshots(side, seed: int) -> dict:
    rng = random.Random(seed)
    fleet = {}
    for member in MEMBERS:
        reg = side.metrics.Registry()
        reg.counters.inc("requests", rng.randrange(1, 50))
        reg.counters.inc("shed_over_quota_predict", rng.randrange(0, 3))
        reg.counters.observe_high("queue_depth", rng.randrange(1, 30))
        reg.gauge("hbm_bytes_in_use", lambda v=rng.uniform(1e9, 7e10): v)
        reg.gauge("mfu_resnet18", lambda: None)
        stats = reg.latency("rpc/job.predict")
        for _ in range(rng.randrange(1, 30)):
            stats.record(rng.random() * 0.2)
        fleet[member] = {"metrics": reg.snapshot()}
    return fleet


@pytest.mark.parametrize("seed", [0, 5])
def test_fleet_prometheus_text_is_byte_equal(seed):
    snaps = fleet_snapshots(JAX, seed)
    assert fleet_snapshots(PORT, seed) == snaps
    text = PORT.observe.render_fleet_prometheus(snaps)
    assert text.encode() == JAX.observe.render_fleet_prometheus(snaps).encode()
    for member in MEMBERS:
        assert f'node="{member}"' in text


def test_mfu_gauges_are_equal_on_the_cpu():
    gauges = {}
    for side in (JAX, PORT):
        clock = VClock(0.0)
        registry = side.metrics.Registry()
        records = []

        class Profiler:
            def record(self, *a, **k):
                records.append((a, k))

        mon = side.devicemon.DeviceMonitor(registry, profiler=Profiler(), member="m0",
                                           clock=clock, mfu_window_s=30.0,
                                           census=side.devicemon.CompileCensus(clock))
        try:
            for m in MODELS:
                mon.register_model(m, resident_bytes=lambda: 1234)
            rng = np.random.default_rng(3)
            trace = []
            for _ in range(120):
                clock.t += float(rng.exponential(0.5))
                mon.device_work(MODELS[int(rng.integers(2))], int(rng.integers(1, 257)),
                                float(rng.uniform(0.005, 0.05)))
                snap = registry.snapshot()["gauges"]
                trace.append({k: snap[k] for k in ("mfu_resnet18", "mfu_alexnet",
                                                   "resident_bytes_resnet18",
                                                   "device_peak_flops")})
        finally:
            mon.close()
        gauges[side.name] = (trace, records)
    assert gauges["port"] == gauges["jax"]
    last = gauges["port"][0][-1]
    assert last["device_peak_flops"] == 1e12
    assert 0 < last["mfu_resnet18"] and 0 < last["mfu_alexnet"]


def test_census_and_flight_events_are_equal():
    got = {}
    for side in (JAX, PORT):
        clock = VClock(0.0)
        census = side.devicemon.CompileCensus(clock)
        flight = side.flight.FlightRecorder(clock=clock, node="m0")
        metrics = side.metrics.Counters()
        mon = side.devicemon.DeviceMonitor(None, flight=flight, metrics=metrics,
                                           warmup_s=20.0, census=census, clock=clock)
        try:
            verdicts = []
            for t, label, sec in [(0, "kernel/a", 1.5), (5, "kernel/b", 2.0),
                                  (19, "kernel/a", 0.5), (26, "kernel/b", 1.0),
                                  (41, "kernel/a", 0.25), (41, "kernel/c", 3.0)]:
                clock.t = float(t)
                verdicts.append(census.record(label, sec))
        finally:
            mon.close()
        got[side.name] = (verdicts, census.snapshot()["labels"], flight.to_wire()["events"],
                          metrics.snapshot())
    assert got["port"] == got["jax"]
    # kernel/b at 26 s and kernel/a at 41 s land past their 20 s windows.
    assert got["port"][0] == [False, False, False, True, True, False]
    assert [(e["kind"], e["program"]) for e in got["port"][2]] == [
        ("recompile_steady_state", "kernel/b"), ("recompile_steady_state", "kernel/a")]
