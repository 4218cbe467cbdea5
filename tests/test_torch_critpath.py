"""Every case of tests/test_profile.py and of tests/test_critpath.py, run
against both packages (``pkg``): the CostProfiler's windows, decay, scrape
deltas and warm start; the critical-path extraction (max-lane charging,
gang fan-out, orphans, the brute-force reference on seeded DAGs), the
rolling analyzer, the fleet fold and the drift sentinel.

The names imported below are the JAX package's; ``sided`` rebinds each to
the object of the same name in the package under test, for each case.
Left out: tests/test_critpath.py's ``TestDriftSoak``, whose harness
(``dmlc_tpu/loadgen.py``'s ``drift_sentinel_harness``) runs the JAX
package's SLO evaluator (``scheduler/placement.py``), which this package has
not ported.
"""

from __future__ import annotations

import math
import random

import pytest
from torch_sides import bind_sides, pkg  # noqa: F401  (pkg: fixture)

from dmlc_tpu.cluster.critpath import (
    GAP_STAGE,
    CritPathAnalyzer,
    FleetCritPath,
    Span,
    breakdown,
    critical_path,
    spans_from_perfetto,
    spans_from_wire,
    stage_of,
)
from dmlc_tpu.cluster.profile import ANY_MODEL, SPAN_STAGES, CostProfiler
from dmlc_tpu.cluster.sentinel import DriftSentinel

sided = bind_sides(globals(), {
    "ANY_MODEL": "profile", "SPAN_STAGES": "profile", "CostProfiler": "profile",
    "GAP_STAGE": "critpath", "CritPathAnalyzer": "critpath", "FleetCritPath": "critpath",
    "Span": "critpath", "breakdown": "critpath", "critical_path": "critpath",
    "spans_from_perfetto": "critpath", "spans_from_wire": "critpath", "stage_of": "critpath",
    "DriftSentinel": "sentinel",
})


def test_names_are_the_package_under_test(pkg):
    assert CostProfiler is pkg.profile.CostProfiler
    assert critical_path is pkg.critpath.critical_path
    assert DriftSentinel is pkg.sentinel.DriftSentinel
    assert pkg.name == "jax" or not CostProfiler.__module__.startswith("dmlc_tpu.")


# ===========================================================================
# tests/test_profile.py
# ===========================================================================


class VClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make(clock, **kw):
    kw.setdefault("window_s", 10.0)
    kw.setdefault("windows", 4)
    kw.setdefault("decay", 0.5)
    return CostProfiler(clock=clock, **kw)


# ---------------------------------------------------------------------------
# windowing edge cases
# ---------------------------------------------------------------------------


class TestWindows:
    def test_empty_profiler_queries(self):
        p = make(VClock())
        assert p.mean_cost("m0") is None
        assert math.isnan(p.percentile(99))
        assert p.frac_over(0.1) == 0.0  # no evidence is not a violation
        assert p.throughput() == 0.0
        assert p.members() == []
        assert p.snapshot()["profiles"] == {}

    def test_single_sample_p99(self):
        clock = VClock()
        p = make(clock)
        p.record("resnet18", "m0", "dispatch", 0.25)
        # One sample is every percentile.
        assert p.percentile(99) == 0.25
        assert p.percentile(50) == 0.25
        assert p.percentile(0) == 0.25
        assert p.mean_cost("m0") == pytest.approx(0.25)

    def test_windows_age_out_past_the_deque(self):
        clock = VClock()
        p = make(clock)  # 4 windows x 10s
        p.record("resnet18", "m0", "dispatch", 0.1)
        clock.advance(35.0)  # age 3: still inside the 4-window history
        assert p.mean_cost("m0") == pytest.approx(0.1)
        clock.advance(10.0)  # age 4: past max_age, weight drops to zero
        assert p.mean_cost("m0") is None

    def test_horizon_filters_older_windows(self):
        clock = VClock()
        p = make(clock)
        p.record("resnet18", "m0", "dispatch", 1.0)
        clock.advance(10.0)
        p.record("resnet18", "m0", "dispatch", 0.1)
        # Horizon of one window sees only the fresh record.
        assert p.mean_cost("m0", horizon_s=10.0) == pytest.approx(0.1)
        # The full history still mixes both.
        full = p.mean_cost("m0")
        assert 0.1 < full < 1.0

    def test_decay_weighting_under_virtual_clock(self):
        clock = VClock()
        p = make(clock, decay=0.5)
        p.record("resnet18", "m0", "dispatch", 1.0)
        clock.advance(10.0)  # the old window now has age 1 -> weight 0.5
        p.record("resnet18", "m0", "dispatch", 0.0)
        # mean = (1.0*0.5 + 0.0*1.0) / (0.5 + 1.0) = 1/3
        assert p.mean_cost("m0") == pytest.approx(1.0 / 3.0)
        clock.advance(10.0)  # ages 2 and 1 -> weights 0.25, 0.5
        assert p.mean_cost("m0") == pytest.approx(0.25 / 0.75)

    def test_amortized_record_weights_moments_by_count(self):
        p = make(VClock())
        p.record("resnet18", "m0", "dispatch", 0.2, count=64)
        p.record("resnet18", "m0", "dispatch", 0.4, count=64)
        assert p.mean_cost("m0") == pytest.approx(0.3)
        snap = p.snapshot()["profiles"]["resnet18"]["m0"]["dispatch"]
        assert snap["n"] == 128

    def test_reservoir_stays_bounded(self):
        p = make(VClock())
        for i in range(4 * CostProfiler.WINDOW_SAMPLES):
            p.record("resnet18", "m0", "dispatch", 0.001 * (i % 7))
        (dq,) = p._keys.values()
        assert len(dq[-1].samples) == CostProfiler.WINDOW_SAMPLES
        assert dq[-1].count == 4 * CostProfiler.WINDOW_SAMPLES

    def test_frac_over(self):
        p = make(VClock())
        for v in (0.1, 0.1, 0.9, 0.9):
            p.record("resnet18", "m0", "dispatch", v)
        assert p.frac_over(0.5, model="resnet18") == pytest.approx(0.5)
        assert p.frac_over(1.0, model="resnet18") == 0.0

    def test_lanes_are_keyed_by_model_member_stage(self):
        p = make(VClock())
        p.record("resnet18", "m0", "dispatch", 0.1)
        p.record("alexnet", "m1", "dispatch", 0.9)
        p.record("resnet18", "m0", "compute", 0.5)
        assert p.mean_cost("m0", model="resnet18") == pytest.approx(0.1)
        assert p.mean_cost("m1") == pytest.approx(0.9)
        assert p.mean_cost("m0", stage="compute") == pytest.approx(0.5)
        assert p.members(stage="dispatch") == ["m0", "m1"]


# ---------------------------------------------------------------------------
# scrape ingestion: cumulative deltas + reset detection
# ---------------------------------------------------------------------------


def scrape(count: int, mean: float, span: str = "rpc/job.predict") -> dict:
    return {"spans": {span: {"count": count, "mean": mean}}}


class TestIngestScrape:
    def test_first_scrape_folds_full_cumulative(self):
        p = make(VClock())
        assert p.ingest_scrape("m0", scrape(10, 0.2)) == 1
        assert p.mean_cost("m0", stage="predict", model=ANY_MODEL) == pytest.approx(0.2)
        snap = p.snapshot()["profiles"][ANY_MODEL]["m0"]["predict"]
        assert snap["n"] == 10

    def test_second_scrape_folds_only_the_delta(self):
        clock = VClock()
        p = make(clock)
        p.ingest_scrape("m0", scrape(10, 0.2))  # cum total 2.0
        clock.advance(10.0)
        # 10 more at 0.8 each: cum 20 @ mean 0.5 (total 10.0, delta 8.0).
        p.ingest_scrape("m0", scrape(20, 0.5))
        assert p.mean_cost(
            "m0", stage="predict", model=ANY_MODEL, horizon_s=10.0
        ) == pytest.approx(0.8)

    def test_member_restart_reanchors_the_cursor(self):
        p = make(VClock())
        p.ingest_scrape("m0", scrape(100, 0.2))
        # Restarted member: cumulative count DROPPED. The fresh cumulative
        # must fold as the first delta, not a negative one.
        assert p.ingest_scrape("m0", scrape(5, 0.4)) == 1
        lane = p.snapshot()["profiles"][ANY_MODEL]["m0"]["predict"]
        assert lane["n"] == 105

    def test_unknown_spans_and_junk_are_skipped(self):
        p = make(VClock())
        reply = {"spans": {
            "rpc/unmapped.verb": {"count": 5, "mean": 0.1},
            "host/decode": "not-a-dict",
            "gen/step": {"count": "x"},
        }}
        assert p.ingest_scrape("m0", reply) == 0
        assert p.ingest_scrape("m0", {}) == 0

    def test_span_stage_table_covers_the_pipeline(self):
        assert SPAN_STAGES["scheduler/dispatch"] == "dispatch"
        assert SPAN_STAGES["device/forward"] == "compute"
        assert SPAN_STAGES["host/decode"] == "decode"
        assert SPAN_STAGES["gen/step"] == "gen/step"


# ---------------------------------------------------------------------------
# persistence: warm-start across a restart mid-window
# ---------------------------------------------------------------------------


class TestWarmStart:
    def test_roundtrip_restores_lanes_and_means(self, tmp_path):
        clock = VClock(100.0)
        p = make(clock)
        p.record("resnet18", "m0", "dispatch", 0.1, count=32)
        p.record("resnet18", "m1", "dispatch", 0.5, count=32)
        path = tmp_path / "profile.json"
        assert p.save(path)

        # The restarted node's clock starts from zero (mid-window relative
        # to the old one); ages re-anchor against the new epoch.
        p2 = make(VClock(3.0))
        assert p2.load(path) == 2
        assert p2.mean_cost("m0") == pytest.approx(0.1)
        assert p2.mean_cost("m1") == pytest.approx(0.5)
        assert p2.members() == ["m0", "m1"]

    def test_warm_started_windows_age_out_normally(self, tmp_path):
        clock = VClock(95.0)
        p = make(clock)
        p.record("resnet18", "m0", "dispatch", 0.1)
        path = tmp_path / "profile.json"
        p.save(path)

        clock2 = VClock(0.0)
        p2 = make(clock2)
        p2.load(path)
        assert p2.mean_cost("m0") == pytest.approx(0.1)
        clock2.advance(40.0)  # past the 4-window history
        assert p2.mean_cost("m0") is None

    def test_new_records_merge_with_adopted_history(self, tmp_path):
        clock = VClock(50.0)
        p = make(clock)
        p.record("resnet18", "m0", "dispatch", 1.0)
        path = tmp_path / "profile.json"
        p.save(path)

        clock2 = VClock(50.0)
        p2 = make(clock2)
        p2.record("resnet18", "m0", "dispatch", 0.0)  # same-epoch fresh data
        p2.load(path)
        # The adopted age-0 window collides with the live one and is
        # skipped: live evidence wins over a stale snapshot of the same
        # window; the lane still counts as adopted history elsewhere.
        assert p2.mean_cost("m0") == pytest.approx(0.0)

    def test_mismatched_window_size_is_discarded(self, tmp_path):
        p = make(VClock())
        p.record("resnet18", "m0", "dispatch", 0.1)
        path = tmp_path / "profile.json"
        p.save(path)
        other = CostProfiler(window_s=99.0, windows=4, clock=VClock())
        assert other.load(path) == 0
        assert other.mean_cost("m0") is None

    def test_corrupt_and_missing_snapshots_start_cold(self, tmp_path):
        p = make(VClock())
        assert p.load(tmp_path / "nope.json") == 0
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        assert p.load(bad) == 0
        malformed = tmp_path / "malformed.json"
        malformed.write_text('{"version": 1, "window_s": 10.0, "lanes": [{}]}')
        assert p.load(malformed) == 0


# ===========================================================================
# tests/test_critpath.py
# ===========================================================================


def mk(name, start, end, span_id, parent=None, trace="t1", lane=None,
       model=None):
    return Span(name=name, start=float(start), end=float(end),
                span_id=span_id, parent_id=parent, trace_id=trace,
                lane=lane, model=model)


def charged_by_span(path):
    out: dict[str, float] = {}
    for span, sec in path.charges:
        out[span.span_id] = out.get(span.span_id, 0.0) + sec
    return out


# ---------------------------------------------------------------------------
# Extraction math
# ---------------------------------------------------------------------------


class TestCriticalPath:
    def test_overlapped_children_charge_max_lane_only(self):
        # root [0,10]; A [1,6] and B [2,9] overlap: B (later-ending)
        # shadows A on [2,6]; A is charged only its uncovered head [1,2].
        spans = [
            mk("rpc/job.predict", 0, 10, "r", model="m"),
            mk("scheduler/dispatch", 1, 6, "a", parent="r", lane="n1"),
            mk("scheduler/dispatch", 2, 9, "b", parent="r", lane="n2"),
        ]
        path = critical_path(spans)
        got = charged_by_span(path)
        assert got == pytest.approx({"r": 1 + 1, "a": 1, "b": 7})
        assert path.total_s == pytest.approx(10.0)  # exact wall partition
        shares = sum(got.values()) / 10.0
        assert shares == pytest.approx(1.0)

    def test_gang_fanout_charges_slowest_rank(self):
        # Four gang ranks fan out at t=1; the slowest ([1,9]) is the
        # blocking chain — the three faster ranks finish in its shadow
        # and charge nothing.
        spans = [mk("rpc/job.predict", 0, 10, "r", model="m")]
        ends = [4, 5, 9, 3]
        for i, e in enumerate(ends):
            spans.append(mk("rpc/job.decode_gang", 1, e, f"g{i}",
                            parent="r", lane=f"rank{i}"))
        path = critical_path(spans)
        got = charged_by_span(path)
        assert got["g2"] == pytest.approx(8.0)  # slowest rank [1,9]
        assert all(f"g{i}" not in got for i in (0, 1, 3))
        assert got["r"] == pytest.approx(2.0)  # [0,1] + [9,10]
        assert path.total_s == pytest.approx(10.0)

    def test_nested_pipeline_charges_blocking_chain(self):
        # dispatch [1,5] with decode child [2,4]; compute [4,9] pipelined
        # after: each inner span charges only its unshadowed self-time.
        spans = [
            mk("rpc/job.predict", 0, 10, "r", model="m"),
            mk("scheduler/dispatch", 1, 5, "d", parent="r", lane="n1"),
            mk("host/decode", 2, 4, "dec", parent="d", lane="n1"),
            mk("device/forward", 4, 9, "fwd", parent="r", lane="n1"),
        ]
        got = charged_by_span(critical_path(spans))
        # forward (ends later) claims [4,9]; dispatch keeps [1,4], inside
        # which decode claims [2,4] and dispatch self-time [1,2]; the
        # root's own gaps are [0,1] and [9,10]. Wall partitions exactly.
        assert got == pytest.approx({"r": 2, "fwd": 5, "d": 1, "dec": 2})
        assert sum(got.values()) == pytest.approx(10.0)

    def test_child_overhanging_parent_is_clamped(self):
        # A child recorded past its parent's end (clock skew / late flush)
        # must not push shares past 1.0.
        spans = [
            mk("rpc/job.predict", 0, 10, "r", model="m"),
            mk("host/decode", 8, 14, "c", parent="r", lane="n1"),
        ]
        path = critical_path(spans)
        got = charged_by_span(path)
        assert got == pytest.approx({"r": 8, "c": 2})
        assert path.total_s == pytest.approx(10.0)

    def test_multiple_roots_hull_and_gap(self):
        # Two parentless spans: hull [0,10], uncovered middle [4,6] is
        # virtual-root gap time.
        spans = [
            mk("a", 0, 4, "a", lane="n1", model="m"),
            mk("b", 6, 10, "b", lane="n2"),
        ]
        path = critical_path(spans)
        got = charged_by_span(path)
        assert got["a"] == pytest.approx(4.0)
        assert got["b"] == pytest.approx(4.0)
        gap = [sec for s, sec in path.charges if s.name == GAP_STAGE]
        assert sum(gap) == pytest.approx(2.0)
        assert path.total_s == pytest.approx(10.0)

    def test_orphans_charge_under_virtual_root_without_double_count(self):
        # An orphan subtree (parent id never arrived) rides next to the
        # true root: overlap with the covered chain stays shadowed, only
        # the orphan's overhang is charged — shares never exceed 1.0.
        spans = [
            mk("rpc/job.predict", 0, 8, "r", model="m", lane="n1"),
            mk("scheduler/dispatch", 1, 7, "d", parent="r", lane="n1"),
            # orphan: parent "ghost" was dropped by the sampling budget
            mk("host/decode", 2, 9, "o", parent="ghost", lane="n2"),
            mk("gen/step", 3, 5, "os", parent="o", lane="n2"),
        ]
        path = critical_path(spans)
        assert path.orphans == 1
        got = charged_by_span(path)
        # Hull [0,9]: orphan "o" ends last -> claims [2,9] minus its own
        # child's chain; true chain covers [0,2].
        assert path.total_s == pytest.approx(9.0)
        assert sum(got.values()) == pytest.approx(9.0)
        assert got["o"] == pytest.approx((3 - 2) + (9 - 5))
        assert got["os"] == pytest.approx(2.0)

    def test_cycle_guard_terminates(self):
        # A pure 2-cycle has no top-level span: dropped as malformed, not
        # an infinite walk.
        cycle = [
            mk("x", 0, 5, "a", parent="b", model="m"),
            mk("y", 1, 4, "b", parent="a"),
        ]
        assert critical_path(cycle) is None
        # A cycle island next to a real root never hangs the walk either;
        # the rooted chain is charged normally.
        path = critical_path(
            [mk("rpc/job.predict", 0, 10, "r", model="m"), *cycle])
        assert path is not None
        assert path.total_s == pytest.approx(10.0)
        assert sum(charged_by_span(path).values()) == pytest.approx(10.0)

    def test_self_parent_treated_as_root(self):
        path = critical_path([mk("x", 0, 5, "a", parent="a", model="m")])
        assert path.total_s == pytest.approx(5.0)

    def test_empty_and_zero_width(self):
        assert critical_path([]) is None
        assert critical_path([mk("x", 3, 3, "a")]) is None

    def test_model_inheritance_nearest_ancestor(self):
        spans = [
            mk("rpc/job.predict", 0, 10, "r", model="mA"),
            mk("scheduler/dispatch", 1, 9, "d", parent="r"),
            mk("host/decode", 2, 8, "c", parent="d", model="mB"),
            mk("gen/step", 3, 7, "g", parent="c"),
        ]
        path = critical_path(spans)
        assert path.model == "mA"
        by_id = {s.span_id: s.model for s, _ in path.charges}
        assert by_id["d"] == "mA"
        assert by_id["g"] == "mB"


# ---------------------------------------------------------------------------
# Brute-force reference on randomized seeded DAGs
# ---------------------------------------------------------------------------


def _reference_charges(spans: list[Span]) -> dict[str, float]:
    """Forward characterization of the blocking critical path: at each
    instant the charged span is found by descending from the root,
    repeatedly stepping into the latest-ending child active then (ties:
    larger start, then span id). Exact via elementary intervals."""
    by_id = {s.span_id: s for s in spans}
    children: dict[str, list[Span]] = {}
    tops: list[Span] = []
    for s in spans:
        if s.parent_id and s.parent_id != s.span_id and s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            tops.append(s)
    if len(tops) == 1:
        root = tops[0]
    else:
        root = Span(name=GAP_STAGE, start=min(s.start for s in tops),
                    end=max(s.end for s in tops), span_id="(vroot)",
                    parent_id=None, trace_id="t", lane=None, model=None)
        children["(vroot)"] = tops
    points = sorted({p for s in [root, *spans]
                     for p in (s.start, s.end)
                     if root.start <= p <= root.end} | {root.start, root.end})
    out: dict[str, float] = {}
    for lo, hi in zip(points, points[1:]):
        if hi <= lo:
            continue
        u = (lo + hi) / 2.0
        cur = root
        while True:
            active = [c for c in children.get(cur.span_id, ())
                      if c.start <= u < c.end]
            if not active:
                break
            cur = max(active, key=lambda c: (c.end, c.start, c.span_id))
        out[cur.span_id] = out.get(cur.span_id, 0.0) + (hi - lo)
    return out


def _random_tree(rng: random.Random) -> list[Span]:
    spans: list[Span] = []
    counter = [0]

    def grow(parent_id, lo, hi, depth):
        n = rng.randint(0, 3 if depth < 3 else 0)
        for _ in range(n):
            counter[0] += 1
            sid = f"s{counter[0]}"
            a = rng.uniform(lo - 0.5, hi)
            b = a + rng.uniform(0.0, (hi - lo) * rng.uniform(0.2, 1.2))
            if b <= a:
                continue
            spans.append(Span(
                name=rng.choice(["scheduler/dispatch", "host/decode",
                                 "device/forward", "gen/step"]),
                start=round(a, 3), end=round(b, 3), span_id=sid,
                parent_id=parent_id, trace_id="t",
                lane=rng.choice(["n1", "n2", "n3", None]), model=None))
            grow(sid, a, b, depth + 1)

    root = Span(name="rpc/job.predict", start=0.0,
                end=round(rng.uniform(5.0, 20.0), 3), span_id="root",
                parent_id=None, trace_id="t", lane="n1", model="m")
    spans.append(root)
    grow("root", root.start, root.end, 0)
    return spans


@pytest.mark.parametrize("seed", [0, 1000, 2000, 7, 42, 1337])
def test_matches_bruteforce_reference_on_random_dags(seed):
    rng = random.Random(seed)
    for _ in range(25):
        spans = _random_tree(rng)
        path = critical_path(spans)
        ref = _reference_charges(spans)
        got = charged_by_span(path)
        root = spans[0]
        assert path.total_s == pytest.approx(root.end - root.start, abs=1e-9)
        assert sum(got.values()) <= path.total_s + 1e-9  # never > wall
        for sid in set(ref) | set(got):
            assert got.get(sid, 0.0) == pytest.approx(
                ref.get(sid, 0.0), abs=1e-9), (seed, sid, spans)


# ---------------------------------------------------------------------------
# Normalization + one-shot breakdown
# ---------------------------------------------------------------------------


class TestNormalize:
    def test_wire_roundtrip_and_breakdown_shares(self):
        events = [
            {"name": "rpc/job.predict", "start": 0.0, "dur": 10.0,
             "trace": "t1", "span": "r", "parent": None, "lane": "n1",
             "attrs": {"model": "m"}},
            {"name": "scheduler/dispatch", "start": 1.0, "dur": 6.0,
             "trace": "t1", "span": "d", "parent": "r", "lane": "n1",
             "attrs": {"job": "m"}},
            {"name": "host/decode", "start": 2.0, "dur": 4.0,
             "trace": "t1", "span": "c", "parent": "d", "lane": "n2",
             "attrs": {}},
            {"name": "junk-no-ids", "start": 0.0, "dur": 1.0},
        ]
        traces = spans_from_wire(events)
        assert set(traces) == {"t1"}
        bd = breakdown(traces)
        body = bd["m"]
        assert body["requests"] == 1
        assert body["max_lanes"] == 2
        assert sum(ln["share"] for ln in body["lanes"]) == pytest.approx(1.0)
        assert body["total_s"] == pytest.approx(10.0)
        stages = {ln["stage"] for ln in body["lanes"]}
        assert stage_of("host/decode") in stages
        assert stage_of("scheduler/dispatch") in stages

    def test_perfetto_units_are_microseconds(self):
        doc = {"traceEvents": [
            {"ph": "X", "name": "rpc/job.predict", "ts": 0, "dur": 2_000_000,
             "args": {"trace": "t", "span": "r", "model": "m"}},
            {"ph": "M", "name": "meta"},
        ]}
        traces = spans_from_perfetto(doc)
        (span,) = traces["t"]
        assert span.end == pytest.approx(2.0)
        assert span.model == "m"


# ---------------------------------------------------------------------------
# Rolling analyzer: ownership, windows, snapshot
# ---------------------------------------------------------------------------


def _request_events(trace, model, root_lane="n1", t0=0.0, decode_s=2.0,
                    dispatch_member="n2"):
    """A plausible predict request: root -> dispatch -> decode."""
    total = 1.0 + decode_s + 1.0
    return [
        {"name": "host/decode", "start": t0 + 1.5, "dur": decode_s,
         "trace": trace, "span": f"{trace}.c", "parent": f"{trace}.d",
         "lane": dispatch_member, "attrs": {}},
        {"name": "scheduler/dispatch", "start": t0 + 1.0,
         "dur": decode_s + 1.0, "trace": trace, "span": f"{trace}.d",
         "parent": f"{trace}.r", "lane": root_lane,
         "attrs": {"job": model, "member": dispatch_member}},
        {"name": "rpc/job.predict", "start": t0, "dur": total,
         "trace": trace, "span": f"{trace}.r", "parent": None,
         "lane": root_lane, "attrs": {"model": model}},
    ]


class TestAnalyzer:
    def test_charges_once_and_shares_sum_to_one(self):
        clk = [100.0]
        an = CritPathAnalyzer(window_s=10.0, clock=lambda: clk[0])
        for i in range(5):
            an.ingest(_request_events(f"t{i}", "m"))
        snap = an.snapshot()
        body = snap["models"]["m"]
        assert body["requests"] == 5
        assert sum(ln["share"] for ln in body["lanes"]) == pytest.approx(1.0)
        assert snap["counters"]["traces"] == 5
        # Late spans for an already-charged trace are counted, not folded.
        an.ingest(_request_events("t0", "m"))
        snap2 = an.snapshot()
        assert snap2["models"]["m"]["requests"] == 5
        assert snap2["counters"]["late_spans"] == 3

    def test_root_ownership_partition(self):
        clk = [0.0]
        events = _request_events("tx", "m", root_lane="leader")
        owner = CritPathAnalyzer(clock=lambda: clk[0])
        other = CritPathAnalyzer(clock=lambda: clk[0])
        assert owner.ingest(events, own_lane="leader") == 1
        assert other.ingest(events, own_lane="member2") == 0
        # Unlaned roots are claimed only by the claimer (the leader).
        unlaned = _request_events("ty", "m", root_lane=None)
        assert other.ingest(unlaned, own_lane="member2") == 0
        assert owner.ingest(unlaned, own_lane="leader",
                            claim_unlaned=True) == 1

    def test_unrooted_trace_never_charged_and_bounded(self):
        clk = [0.0]
        an = CritPathAnalyzer(clock=lambda: clk[0])
        an.MAX_PENDING = 4
        for i in range(8):  # orphan-only fragments of remote traces
            an.ingest([{"name": "host/decode", "start": 1.0, "dur": 1.0,
                        "trace": f"frag{i}", "span": f"f{i}",
                        "parent": "remote-root", "lane": "n1",
                        "attrs": {}}], own_lane="n1")
        snap = an.snapshot()
        assert snap["models"] == {}
        assert snap["counters"]["unrooted_evicted"] >= 4

    def test_windows_decay_out(self):
        clk = [0.0]
        an = CritPathAnalyzer(window_s=10.0, windows=4,
                              clock=lambda: clk[0])
        an.ingest(_request_events("t1", "m"))
        assert "m" in an.snapshot()["models"]
        clk[0] += 10.0 * 5  # beyond the window horizon
        assert an.snapshot()["models"] == {}

    def test_snapshot_is_jsonable(self):
        import json
        an = CritPathAnalyzer(clock=lambda: 0.0)
        an.ingest(_request_events("t1", "m"))
        json.dumps(an.snapshot())


class TestFleetFold:
    def test_fold_and_culprit(self):
        clk = [0.0]
        fleet = FleetCritPath()
        for member, decode_s in (("n1", 0.5), ("n2", 6.0)):
            an = CritPathAnalyzer(clock=lambda: clk[0])
            for i in range(4):
                an.ingest(_request_events(
                    f"{member}.t{i}", "m", root_lane=member,
                    dispatch_member=member, decode_s=decode_s))
            fleet.fold(member, an.snapshot())
        table = fleet.table()
        assert table["members_reporting"] == 2
        body = table["models"]["m"]
        assert body["requests"] == 8
        assert sum(ln["share"] for ln in body["lanes"]) == pytest.approx(1.0)
        culprit = fleet.culprit("m")
        assert culprit is not None
        assert culprit["stage"] == "decode"
        assert culprit["member"] == "n2"
        assert 0.0 < culprit["critpath_share"] <= 1.0
        assert fleet.culprit("missing") is None
        fleet.forget("n2")
        assert fleet.table()["members_reporting"] == 1


# ---------------------------------------------------------------------------
# Drift sentinel
# ---------------------------------------------------------------------------


def _table(q_samples: dict[tuple[str, str, str], list[float]]):
    models: dict = {}
    for (model, stage, member), samples in q_samples.items():
        body = models.setdefault(model, {"requests": 0, "total_s": 0.0,
                                         "lanes": []})
        body["lanes"].append({
            "stage": stage, "member": member,
            "crit_s": sum(samples), "share": 0.5, "n": len(samples),
            "recent_n": len(samples), "samples": list(samples),
            "p50": 0.0, "p99": 0.0,
        })
    return {"models": models}


class TestSentinel:
    def _mk(self, **kw):
        events: list[tuple[str, dict]] = []
        forces: list[float] = []
        replans: list[str] = []
        s = DriftSentinel(
            min_samples=5, confirm_windows=3, drift_factor=2.0,
            clear_factor=1.3,
            flight_note=lambda kind, **f: events.append((kind, f)),
            force_sample=forces.append,
            request_replan=replans.append, **kw)
        return s, events, forces, replans

    @pytest.mark.parametrize("seed", [0, 1000, 2000])
    def test_drift_alert_within_confirm_windows(self, seed):
        rng = random.Random(seed)
        s, events, forces, replans = self._mk()
        key = ("m", "decode", "n2")
        healthy = lambda: [rng.uniform(0.9, 1.1) for _ in range(10)]
        for _ in range(6):  # learn the baseline
            s.tick(_table({key: healthy()}))
        assert s.alerting() == []
        slow = lambda: [rng.uniform(4.5, 5.5) for _ in range(10)]  # 5x
        ticks_to_alert = 0
        for i in range(5):
            fired = s.tick(_table({key: slow()}))
            if fired:
                ticks_to_alert = i + 1
                break
        assert ticks_to_alert == 3  # exactly confirm_windows
        assert s.alerting() == [key]
        (desc,) = [f for k, f in events if k == "latency_drift"]
        assert (desc["model"], desc["stage"], desc["member"]) == key
        assert desc["factor"] > 2.0
        assert forces == [s.force_sample_s]
        assert any(k == "drift_force_sample" for k, _ in events)
        # Localized to one member -> replan requested.
        assert replans == ["latency_drift:m:decode:n2"]
        assert any(k == "drift_replan_request" for k, _ in events)

    def test_min_samples_floor(self):
        s, events, *_ = self._mk()
        key = ("m", "decode", "n2")
        for _ in range(4):
            s.tick(_table({key: [1.0, 1.0, 1.0]}))  # n=3 < 5: never judged
        for _ in range(6):
            s.tick(_table({key: [100.0] * 3}))
        assert s.alerting() == []
        assert events == []

    def test_baseline_frozen_during_drift_and_hysteresis_clear(self):
        s, events, _, _ = self._mk()
        key = ("m", "decode", "n2")
        for _ in range(4):
            s.tick(_table({key: [1.0] * 8}))
        base = s.status()["lanes"][0]["baseline_s"]
        for _ in range(3):
            s.tick(_table({key: [5.0] * 8}))
        st = s.status()["lanes"][0]
        assert st["alert"] is True
        assert st["baseline_s"] == pytest.approx(base)  # frozen, no launder
        # One healthy tick does not clear (hysteresis)...
        s.tick(_table({key: [1.0] * 8}))
        assert s.alerting() == [key]
        # ...confirm_windows healthy ticks do.
        for _ in range(2):
            s.tick(_table({key: [1.0] * 8}))
        assert s.alerting() == []
        assert any(k == "latency_drift_clear" for k, _ in events)

    def test_fleetwide_drift_does_not_replan(self):
        s, _, _, replans = self._mk()
        keys = [("m", "decode", f"n{i}") for i in range(3)]
        for _ in range(4):
            s.tick(_table({k: [1.0] * 8 for k in keys}))
        for _ in range(4):
            s.tick(_table({k: [5.0] * 8 for k in keys}))
        assert len(s.alerting()) == 3  # all three members drifted
        assert replans == []  # not placement-fixable: no replan

    def test_config_validation(self):
        with pytest.raises(ValueError):
            DriftSentinel(clear_factor=3.0, drift_factor=2.0)
        with pytest.raises(ValueError):
            DriftSentinel(baseline_decay=1.5)

    def test_status_jsonable(self):
        import json
        s, *_ = self._mk()
        s.tick(_table({("m", "decode", "n1"): [1.0] * 8}))
        json.dumps(s.status())
