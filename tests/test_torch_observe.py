"""The observability plane's reference cases, run against both packages
(``pkg``):

- every case of tests/test_scrapetree.py (span partition, counter-exact
  tree merge, delegate limits, the 512-member soak);
- every case of tests/test_trace_sampling.py (the sampled bit on the wire,
  head sampling, the adaptive controller, ``obs.trace_ctl`` knobs);
- the ObsService, fleet-trace and scrape cases of
  tests/test_observability.py (``obs.flight``, per-node skew clamping,
  scrape-tree staleness and re-delegation, the streaming merge and orphan
  adoption);
- every case of tests/test_tracing_fleet.py (propagation on the sim
  fabric, clock alignment and merge, a three-node localcluster whose
  merged trace holds one trace across three nodes, the fleet scrape and its
  Prometheus text).

The names imported below are the JAX package's; ``sided`` rebinds each to
the object of the same name in the package under test, for each case. The
localcluster cases run each package's own fleet with its echo backends.
"""

from __future__ import annotations

import json
import math
import os
import random

import pytest
from torch_sides import bind_sides, pkg  # noqa: F401  (pkg: fixture)

from dmlc_tpu.cluster import observe, tracectx
from dmlc_tpu.cluster.critpath import ORPHAN_ROOT_NAME, breakdown, spans_from_perfetto
from dmlc_tpu.cluster.flight import FlightRecorder
from dmlc_tpu.cluster.localcluster import (
    make_synsets,
    start_local_cluster,
    stop_local_cluster,
    wait_until,
)
from dmlc_tpu.cluster.observe import (
    FleetTraceMerger,
    ObsService,
    merge_fleet_trace,
    scrape_metrics_with_misses,
)
from dmlc_tpu.cluster.rpc import DeadlineExceeded, Overloaded, RpcError, SimRpcNetwork
from dmlc_tpu.cluster.scrapetree import (
    ScrapeDelegate,
    ScrapeTreeCoordinator,
    partition_spans,
)
from dmlc_tpu.cluster.sdfs import placement_order
from dmlc_tpu.utils import tracing
from dmlc_tpu.utils.metrics import Counters, Registry, merge_mergeable_snapshots
from dmlc_tpu.utils.tracing import Tracer, traced_methods, tracer

sided = bind_sides(globals(), {
    "observe": None, "tracectx": None, "tracing": None,
    "ORPHAN_ROOT_NAME": "critpath", "breakdown": "critpath",
    "spans_from_perfetto": "critpath", "FlightRecorder": "flight",
    "make_synsets": "localcluster", "start_local_cluster": "localcluster",
    "stop_local_cluster": "localcluster", "wait_until": "localcluster",
    "FleetTraceMerger": "observe", "ObsService": "observe",
    "merge_fleet_trace": "observe", "scrape_metrics_with_misses": "observe",
    "DeadlineExceeded": "rpc", "Overloaded": "rpc", "RpcError": "rpc",
    "SimRpcNetwork": "rpc", "ScrapeDelegate": "scrapetree",
    "ScrapeTreeCoordinator": "scrapetree", "partition_spans": "scrapetree",
    "placement_order": "sdfs", "Counters": "metrics", "Registry": "metrics",
    "merge_mergeable_snapshots": "metrics", "Tracer": "tracing",
    "traced_methods": "tracing", "tracer": "tracing",
})


def test_names_are_the_package_under_test(pkg):
    assert ObsService is pkg.observe.ObsService
    assert observe is pkg.observe
    assert tracer is pkg.tracing.tracer
    assert start_local_cluster is pkg.localcluster.start_local_cluster


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# ===========================================================================
# tests/test_scrapetree.py
# ===========================================================================


SEED_BASE = int(os.environ.get("DMLC_CHAOS_SEED", "0"))


def build_fleet(n: int, seed: int = 0):
    """N sim members, each with a seeded-random metric load so merges have
    something nontrivial to be exact about."""
    rng = random.Random(seed ^ 0x5CA1E)
    net = SimRpcNetwork()
    addrs = [f"m{i:03d}:1" for i in range(n)]
    registries: dict[str, Registry] = {}
    for i, addr in enumerate(addrs):
        reg = Registry()
        reg.counters.inc("requests", rng.randrange(1, 50))
        if rng.random() < 0.5:
            reg.counters.inc("shed", rng.randrange(1, 5))
        reg.counters.observe_high("queue_depth", rng.randrange(1, 30))
        stats = reg.latency("rpc/job.predict")
        for _ in range(rng.randrange(1, 8)):
            stats.record(rng.random() * 0.2)
        table = ObsService(reg, lane=addr).methods()
        table.update(ScrapeDelegate(
            net.client(addr), timeout_s=1.0, concurrency=1
        ).methods())
        net.serve(addr, table)
        registries[addr] = reg
    return net, addrs, registries


def direct_merged(net: SimRpcNetwork, addrs: list[str]) -> dict:
    """The flat O(N) equivalent the tree must match: every member scraped
    mergeable directly, folded in one pass."""
    replies, misses = scrape_metrics_with_misses(
        net.client("flat:0"), addrs, timeout=1.0, mergeable=True
    )
    assert not misses
    return merge_mergeable_snapshots([r["metrics"] for r in replies.values()])


class TestPartitionSpans:
    def test_every_member_in_exactly_one_span(self):
        addrs = [f"m{i:03d}:1" for i in range(37)]
        spans = partition_spans(addrs)
        flat = [a for span in spans for a in span]
        assert sorted(flat) == sorted(addrs)
        assert len(flat) == len(set(flat))

    def test_span_size_is_ceil_sqrt(self):
        for n in (1, 2, 3, 4, 16, 17, 100, 511, 512):
            spans = partition_spans([f"m{i:04d}" for i in range(n)])
            size = math.isqrt(n - 1) + 1
            assert all(len(s) <= size for s in spans)
            assert len(spans) == math.ceil(n / size)

    def test_dedup_and_deterministic_order(self):
        spans = partition_spans(["b", "a", "b", "c"], span_size=2)
        assert spans == [["a", "b"], ["c"]]

    def test_explicit_span_size_wins(self):
        spans = partition_spans([f"m{i}" for i in range(9)], span_size=4)
        assert [len(s) for s in spans] == [4, 4, 1]

    def test_empty_ring(self):
        assert partition_spans([]) == []


class TestCounterExactness:
    def test_tree_merge_equals_direct_scrape(self):
        net, addrs, _ = build_fleet(20, seed=SEED_BASE)
        coord = ScrapeTreeCoordinator(
            net.client("leader:0"), clock=net.clock, timeout_s=1.0
        )
        result = coord.scrape(addrs)
        flat = direct_merged(net, addrs)
        # Integer fields must be EXACT: counters, histogram buckets, and
        # per-lane sample counts survive any fold association order.
        assert result.merged["counters"] == flat["counters"]
        assert result.merged["nodes"] == flat["nodes"] == 20
        for name, wire in flat["latency"].items():
            tree_wire = result.merged["latency"][name]
            assert tree_wire["n"] == wire["n"]
            assert tree_wire["buckets"] == wire["buckets"]
            assert tree_wire["mean"] == pytest.approx(wire["mean"])
            assert tree_wire["m2"] == pytest.approx(wire["m2"])

    def test_high_watermarks_merge_as_max_not_sum(self):
        net, addrs, registries = build_fleet(9, seed=SEED_BASE + 1)
        result = ScrapeTreeCoordinator(
            net.client("leader:0"), clock=net.clock, timeout_s=1.0
        ).scrape(addrs)
        expected = max(
            registries[a].counters.snapshot()["queue_depth_high"] for a in addrs
        )
        assert result.merged["counters"]["queue_depth_high"] == expected

    def test_member_replies_keep_flat_scrape_shape(self):
        # CostProfiler.ingest_scrape and the CLI read summary-form replies;
        # the tree's per-member entries must stay byte-compatible.
        net, addrs, _ = build_fleet(6, seed=SEED_BASE)
        result = ScrapeTreeCoordinator(
            net.client("leader:0"), clock=net.clock, timeout_s=1.0
        ).scrape(addrs)
        for addr in addrs:
            reply = result.members[addr]
            lat = reply["metrics"]["latency"]["rpc/job.predict"]
            assert {"count", "mean", "median", "p99"} <= set(lat)
            assert "spans" in reply and "sampling" in reply


class TestDelegateLimits:
    def test_max_span_caps_fanout(self):
        net, addrs, _ = build_fleet(4)
        delegate = ScrapeDelegate(net.client(addrs[0]), timeout_s=1.0)
        huge = addrs + [f"ghost{i}:1" for i in range(300)]
        partial = delegate._scrape_span({"addrs": huge[: 4]})["partial"]
        assert len(partial["members"]) == 4
        reply = delegate._scrape_span({"addrs": huge})
        capped = reply["partial"]
        total = len(capped["members"]) + len(capped["missed"])
        assert total <= ScrapeDelegate.MAX_SPAN

    def test_missed_members_counted_in_scrape_timeouts(self):
        net, addrs, _ = build_fleet(6)
        counters = Counters()
        delegate = ScrapeDelegate(
            net.client(addrs[0]), timeout_s=1.0, metrics=counters
        )
        net.crash(addrs[2])
        net.crash(addrs[4])
        partial = delegate._scrape_span({"addrs": addrs})["partial"]
        assert sorted(partial["missed"]) == sorted([addrs[2], addrs[4]])
        assert counters.get("scrape_timeouts") == 2


class TestSoak512:
    N = 512

    def test_leader_cycle_cost_sublinear_and_counter_exact(self):
        net, addrs, _ = build_fleet(self.N, seed=SEED_BASE)
        counters = Counters()
        coord = ScrapeTreeCoordinator(
            net.client("leader:0"), clock=net.clock, timeout_s=1.0,
            metrics=counters,
        )
        calls_before = len(net.calls)
        result = coord.scrape(addrs)
        # Leader-issued RPCs measured on the FABRIC's log: calls sourced by
        # the coordinator this cycle are exactly the obs.scrape_span calls
        # (delegate fan-out dials from the delegates, not the leader).
        leader_calls = [
            (a, m) for a, m in net.calls[calls_before:] if m == "obs.scrape_span"
        ]
        bound = 4.0 * math.sqrt(self.N)
        assert len(leader_calls) <= bound
        assert result.leader_rpcs == len(leader_calls)
        assert counters.snapshot()["scrape_tree_rpcs_high"] <= bound
        # Every member reported; the fold is counter-exact vs the direct
        # O(N) scrape at the same virtual instant.
        assert len(result.members) == self.N
        flat = direct_merged(net, addrs)
        assert result.merged["counters"] == flat["counters"]
        assert result.merged["nodes"] == self.N
        for name, wire in flat["latency"].items():
            assert result.merged["latency"][name]["n"] == wire["n"]
            assert result.merged["latency"][name]["buckets"] == wire["buckets"]

    def test_bad_cycle_stays_under_double_sqrt_bound(self):
        # Kill every primary delegate: every span pays the re-delegation
        # penalty and the cycle still fits the 4*sqrt(N) envelope.
        net, addrs, _ = build_fleet(self.N, seed=SEED_BASE + 2)
        spans = partition_spans(addrs)
        for span in spans:
            net.crash(span[0])
        coord = ScrapeTreeCoordinator(
            net.client("leader:0"), clock=net.clock, timeout_s=1.0
        )
        result = coord.scrape(addrs)
        assert result.redelegations == len(spans)
        assert result.leader_rpcs <= 4.0 * math.sqrt(self.N)
        assert not result.stale_spans  # alternates carried every span


# ===========================================================================
# tests/test_trace_sampling.py
# ===========================================================================


class TestSampledBitWire:
    def test_wire_carries_sampled_bit(self):
        assert tracectx.to_wire(tracectx.child(sampled=True))[2] == 1
        assert tracectx.to_wire(tracectx.child(sampled=False))[2] == 0

    def test_from_wire_round_trip(self):
        ctx = tracectx.child(sampled=False)
        back = tracectx.from_wire(tracectx.to_wire(ctx))
        assert back.trace_id == ctx.trace_id
        assert back.sampled is False

    def test_legacy_two_element_frame_reads_sampled(self):
        # Old peers send [trace, span]: absent bit means "keep tracing",
        # so a mixed-version fleet degrades toward more data, not less.
        back = tracectx.from_wire(["t1", "s1"])
        assert back.sampled is True

    def test_children_inherit_the_root_decision(self):
        root = tracectx.child(sampled=False)
        with tracectx.bind(root):
            child = tracectx.child()
        assert child.sampled is False
        assert child.trace_id == root.trace_id

    def test_bit_rides_the_sim_fabric(self):
        net = SimRpcNetwork()
        net.serve("peer:1", {"ping": lambda p: {}})
        root = tracectx.child(sampled=False)
        with tracectx.bind(root):
            net.client("me:1").call("peer:1", "ping", {})
        assert net.frames[-1]["t"][2] == 0


class TestHeadSampling:
    def _tracer(self, rate: float, **kw) -> Tracer:
        t = Tracer()
        t.enabled = True
        t.set_sampling(rate=rate, **kw)
        return t

    def test_unsampled_roots_store_nothing_but_aggregate_exactly(self):
        t = self._tracer(0.0)
        for _ in range(10):
            with t.span("scheduler/dispatch"):
                pass
        assert t.events_wire() == []
        assert t.summary()["scheduler/dispatch"]["count"] == 10.0
        s = t.sampling_summary()
        assert s["unsampled"] == 10 and s["sampled"] == 0

    def test_rate_one_keeps_everything(self):
        t = self._tracer(1.0)
        for _ in range(5):
            with t.span("root"):
                pass
        assert len(t.events_wire()) == 5
        assert t.sampling_summary()["sampled"] == 5

    def test_error_spans_force_recorded_at_rate_zero(self):
        t = self._tracer(0.0)
        with pytest.raises(RpcError):
            with t.span("loadgen/request"):
                with t.span("rpc/job.predict"):
                    raise RpcError("deadline: too slow")
        # The WHOLE local chain of the failing request survives: every
        # enclosing span saw the same exception on unwind.
        events = t.events_wire()
        assert {e["name"] for e in events} == {"loadgen/request", "rpc/job.predict"}
        assert all(e["attrs"]["error"] == "RpcError" for e in events)
        assert all(e["attrs"]["forced"] == "error" for e in events)
        assert t.sampling_summary()["forced_records"] == 2

    def test_ok_spans_of_unsampled_trace_stay_dropped(self):
        t = self._tracer(0.0)
        with pytest.raises(ValueError):
            with t.span("root"):
                with t.span("ok_child"):
                    pass  # exits cleanly before the failure
                raise ValueError("later failure")
        names = {e["name"] for e in t.events_wire()}
        assert names == {"root"}  # the clean child was already dropped

    def test_forced_window_samples_everything(self):
        clock = FakeClock()
        t = self._tracer(0.0, clock=clock)
        t.force_sampling(10.0)
        with t.span("root"):
            pass
        assert len(t.events_wire()) == 1
        clock.t = 11.0  # window expired
        with t.span("root"):
            pass
        assert len(t.events_wire()) == 1

    def test_record_honors_the_ambient_bit(self):
        t = self._tracer(1.0)
        with tracectx.bind(tracectx.child(sampled=False)):
            t.record("device/forward", 0.005)
        assert t.events_wire() == []
        assert t.summary()["device/forward"]["count"] == 1.0


class TestAdaptiveController:
    def test_rate_shrinks_proportionally_over_budget(self):
        clock = FakeClock()
        t = Tracer()
        t.enabled = True
        t.set_sampling(rate=1.0, spans_per_s=10.0, clock=clock)
        t.adapt_window_s = 1.0
        # 100 spans/s against a 10/s budget for two windows.
        for _ in range(3):
            for _ in range(100):
                with t.span("root"):
                    pass
            clock.t += 1.0
        s = t.sampling_summary()
        assert s["effective_rate"] < 0.5  # cut hard, not by baby steps
        assert s["effective_rate"] >= Tracer.MIN_SAMPLE_RATE

    def test_rate_regrows_when_load_falls(self):
        clock = FakeClock()
        t = Tracer()
        t.enabled = True
        t.set_sampling(rate=1.0, spans_per_s=10.0, clock=clock)
        t.adapt_window_s = 1.0
        for _ in range(3):
            for _ in range(100):
                with t.span("root"):
                    pass
            clock.t += 1.0
        squeezed = t.sampling_summary()["effective_rate"]
        for _ in range(20):  # near-idle windows
            with t.span("root"):
                pass
            clock.t += 1.0
        regrown = t.sampling_summary()["effective_rate"]
        assert regrown > squeezed
        assert regrown <= 1.0

    def test_budget_zero_disables_adaptation(self):
        clock = FakeClock()
        t = Tracer()
        t.enabled = True
        t.set_sampling(rate=0.5, spans_per_s=0.0, clock=clock)
        for _ in range(50):
            with t.span("root"):
                pass
            clock.t += 0.1
        assert t.sampling_summary()["effective_rate"] == 0.5


class TestTraceCtlKnobs:
    def _serve_obs(self):
        net = SimRpcNetwork()
        net.serve("n1:1", ObsService(Registry(), lane="n1:1").methods())
        return net, tracer

    def test_sampling_knobs_pushed_over_the_wire(self):
        net, tracer = self._serve_obs()
        prev = tracer.enabled
        try:
            reply = net.client("cli:0").call(
                "n1:1", "obs.trace_ctl",
                {"enable": True, "sample_rate": 0.25, "spans_per_s": 50.0},
                timeout=2.0,
            )
            assert reply["enabled"] is True
            assert reply["sampling"]["base_rate"] == 0.25
            assert reply["sampling"]["spans_per_s_budget"] == 50.0
            forced = net.client("cli:0").call(
                "n1:1", "obs.trace_ctl", {"force_sample_s": 5.0}, timeout=2.0
            )
            assert forced["sampling"]["base_rate"] == 0.25
        finally:
            tracer.enabled = prev
            tracer.set_sampling(rate=1.0, spans_per_s=0.0)
            tracer.reset()

    def test_metrics_reply_surfaces_sampling_state(self):
        net, tracer = self._serve_obs()
        try:
            reply = net.client("cli:0").call(
                "n1:1", "obs.metrics", {}, timeout=2.0
            )
            assert {"sampled", "unsampled", "effective_rate",
                    "observed_rate"} <= set(reply["sampling"])
        finally:
            tracer.set_sampling(rate=1.0, spans_per_s=0.0)
            tracer.reset()


# ===========================================================================
# tests/test_observability.py: ObsService, fleet trace, scrape
# ===========================================================================


class TestObsFlight:
    def test_obs_flight_rpc_serves_the_ring(self):
        fr = FlightRecorder(clock=FakeClock(), node="n1")
        fr.note("gray_demote", member="m9", reason="slow")
        net = SimRpcNetwork()
        net.serve("n1", ObsService(Registry(), flight=fr, lane="n1").methods())
        wire = net.client("c").call("n1", "obs.flight", {}, timeout=5.0)
        assert wire["events"][0]["kind"] == "gray_demote"
        assert wire["node"] == "n1"


# ---------------------------------------------------------------------------
# Fleet trace merge: per-node skew accounting + the clamp alert
# ---------------------------------------------------------------------------


class TestTraceSkew:
    @staticmethod
    def _node(events, offset=0.0, rtt=0.001):
        return {"dump": {"events": events, "dropped": 0},
                "offset": offset, "rtt": rtt}

    PARENT = {"name": "rpc/job.predict", "start": 1.0, "dur": 0.5,
              "span": "s1", "trace": "t1"}

    def _child(self, start: float) -> dict:
        return {"name": "device/forward", "start": start, "dur": 0.1,
                "span": "s2", "parent": "s1", "trace": "t1"}

    def test_clamp_skew_measured_per_node_and_alerted(self):
        fr = FlightRecorder(clock=FakeClock())
        doc = merge_fleet_trace(
            {"a": self._node([self.PARENT]),
             "b": self._node([self._child(0.9)])},
            flight=fr, skew_alert_s=0.05,
        )
        nodes = doc["otherData"]["nodes"]
        assert nodes["b"]["max_skew_s"] == pytest.approx(0.1)
        assert nodes["a"]["max_skew_s"] == 0.0
        assert doc["otherData"]["skew_clamped_children"] == 1
        # The child renders AT its parent's start, never before it.
        rendered = [e for e in doc["traceEvents"]
                    if e.get("ph") == "X" and e["name"] == "device/forward"]
        assert rendered[0]["ts"] == pytest.approx(1.0 * 1e6)
        alerts = [e for e in fr.events() if e["kind"] == "trace_skew_clamp"]
        assert len(alerts) == 1
        assert alerts[0]["node"] == "b"
        assert alerts[0]["max_skew_s"] == pytest.approx(0.1)
        assert alerts[0]["clamped"] == 1
        assert alerts[0]["threshold_s"] == 0.05

    def test_sub_threshold_skew_clamps_quietly(self):
        fr = FlightRecorder(clock=FakeClock())
        doc = merge_fleet_trace(
            {"a": self._node([self.PARENT]),
             "b": self._node([self._child(0.99)])},
            flight=fr, skew_alert_s=0.05,
        )
        # Clamped (causality must still render forward) but under the
        # alert line: no flight noise for sub-RTT jitter.
        assert doc["otherData"]["skew_clamped_children"] == 1
        assert doc["otherData"]["nodes"]["b"]["max_skew_s"] == pytest.approx(0.01)
        assert not [e for e in fr.events() if e["kind"] == "trace_skew_clamp"]

    def test_merge_without_flight_still_reports_skew(self):
        doc = merge_fleet_trace(
            {"a": self._node([self.PARENT]),
             "b": self._node([self._child(0.8)])},
        )
        assert doc["otherData"]["nodes"]["b"]["max_skew_s"] == pytest.approx(0.2)


# ---------------------------------------------------------------------------
# Partial fleets: scrape-tree staleness + streaming trace merge
# ---------------------------------------------------------------------------


def _sim_obs_fleet(n: int):
    """N sim members each serving the real obs surface (ObsService +
    ScrapeDelegate) with a distinguishable counter load."""
    net = SimRpcNetwork()
    addrs = [f"m{i:02d}:1" for i in range(n)]
    registries: dict[str, Registry] = {}
    for i, addr in enumerate(addrs):
        reg = Registry()
        reg.counters.inc("work", i + 1)
        reg.latency("rpc/job.predict").extend([0.01 * (i + 1)] * 3)
        table = ObsService(reg, lane=addr).methods()
        table.update(ScrapeDelegate(
            net.client(addr), timeout_s=1.0, concurrency=1
        ).methods())
        net.serve(addr, table)
        registries[addr] = reg
    return net, addrs, registries


class TestScrapeTreePartialFleet:
    def _coordinator(self, net, clock=None):
        return ScrapeTreeCoordinator(
            net.client("leader:0"), clock=clock or net.clock, timeout_s=1.0,
            concurrency=1,
        )

    def test_dead_span_is_flagged_stale_not_lost_not_raised(self):
        # THE pinned contract: every delegate candidate of one span dying
        # mid-cycle still yields a merged snapshot — the dark span is
        # FLAGGED stale (never an exception, never silently absent).
        net, addrs, registries = _sim_obs_fleet(9)  # spans of 3
        spans_of_three = [addrs[0:3], addrs[3:6], addrs[6:9]]
        for dead in spans_of_three[1][:2]:  # both delegate candidates
            net.crash(dead)
        coord = self._coordinator(net)
        result = coord.scrape(addrs)  # must not raise
        assert len(result.stale_spans) == 1
        assert result.stale_spans[0]["addrs"] == spans_of_three[1]
        assert result.stale_spans[0]["reason"]
        # Live spans are all present; the dark span is absent from members
        # but named in stale_spans — flagged loss, not silent loss.
        assert sorted(result.members) == sorted(spans_of_three[0] + spans_of_three[2])
        merged_work = result.merged["counters"]["work"]
        expected = sum(
            registries[a].counters.get("work")
            for a in spans_of_three[0] + spans_of_three[2]
        )
        assert merged_work == expected

    def test_stale_for_tracks_last_fresh_stamp(self):
        net, addrs, _ = _sim_obs_fleet(9)
        coord = self._coordinator(net)
        first = coord.scrape(addrs)
        assert not first.stale_spans and len(first.members) == 9
        for dead in addrs[3:5]:
            net.crash(dead)
        net.advance(5.0)
        second = coord.scrape(addrs)
        assert len(second.stale_spans) == 1
        assert second.stale_spans[0]["stale_for_s"] == pytest.approx(5.0)
        # Fresh spans carry this cycle's stamp.
        assert all(t == pytest.approx(5.0) for t in second.stamps.values())

    def test_dead_primary_redelegates_to_next_in_span(self):
        net, addrs, _ = _sim_obs_fleet(9)
        net.crash(addrs[3])  # span 2's primary delegate; alternate lives
        result = self._coordinator(net).scrape(addrs)
        assert not result.stale_spans
        assert result.redelegations == 1
        assert addrs[4] in result.delegates
        # The crashed node is still a member of the span: it shows up as
        # missed by the alternate's fan-out, not silently dropped.
        assert addrs[3] in result.missed
        assert addrs[3] not in result.members


class TestFleetTraceMergerStreaming:
    @staticmethod
    def _node(events, offset=0.0, rtt=0.001):
        return {"dump": {"events": events, "dropped": 0},
                "offset": offset, "rtt": rtt}

    PARENT = {"name": "rpc/job.predict", "start": 1.0, "dur": 0.5,
              "span": "s1", "trace": "t1"}
    CHILD = {"name": "device/forward", "start": 0.9, "dur": 0.1,
             "span": "s2", "parent": "s1", "trace": "t1"}

    def test_streaming_merge_equals_one_shot(self):
        per_node = {
            "a": self._node([self.PARENT], offset=0.002),
            "b": self._node([self.CHILD], offset=-0.001),
        }
        one_shot = merge_fleet_trace(per_node, unreachable={"c": "down"})
        merger = FleetTraceMerger()
        for addr in sorted(per_node):
            entry = per_node[addr]
            merger.add_node(addr, entry["dump"], offset=entry["offset"],
                            rtt=entry["rtt"])
        merger.add_unreachable("c", "down")
        assert merger.finish() == one_shot

    def test_partial_fleet_is_flagged_not_silent(self):
        doc = merge_fleet_trace(
            {"a": self._node([self.PARENT])}, unreachable={"b": "rpc: boom"}
        )
        assert doc["otherData"]["unreachable"] == {"b": "rpc: boom"}
        assert "b" not in doc["otherData"]["nodes"]
        # The reachable node's spans still made it.
        assert sum(1 for e in doc["traceEvents"] if e.get("ph") == "X") == 1

    def test_parent_arriving_after_child_still_clamps(self):
        # Collection order: the child's node reports BEFORE the parent's —
        # the deferred clamp pass must still see the parent's start.
        merger = FleetTraceMerger()
        merger.add_node("b", {"events": [self.CHILD], "dropped": 0})
        merger.add_node("a", {"events": [self.PARENT], "dropped": 0})
        doc = merger.finish()
        rendered = [e for e in doc["traceEvents"]
                    if e.get("ph") == "X" and e["name"] == "device/forward"]
        assert rendered[0]["ts"] == pytest.approx(1.0 * 1e6)
        assert doc["otherData"]["skew_clamped_children"] == 1

    def test_orphan_spans_adopted_under_synthetic_root(self):
        # A span whose parent was dropped (sampling budget, ring overflow,
        # dead member) must NOT vanish from the merged document or dangle
        # with a broken parent edge: its trace gets ONE synthetic root
        # spanning the hull, adopting the orphan AND the trace's true
        # top-level spans, and the degradation is counted in
        # otherData.orphan_spans (docs/OBSERVABILITY.md section 9).
        orphan = {"name": "gen/step", "start": 1.2, "dur": 0.1,
                  "span": "s9", "parent": "never-arrived", "trace": "t1"}
        doc = merge_fleet_trace({
            "a": self._node([self.PARENT]),
            "b": self._node([orphan]),
        })
        assert doc["otherData"]["orphan_spans"] == 1
        roots = [e for e in doc["traceEvents"]
                 if e.get("name") == ORPHAN_ROOT_NAME]
        assert len(roots) == 1
        root = roots[0]
        assert root["args"]["trace"] == "t1"
        assert root["args"]["synthetic"] is True
        # The root spans the trace hull (PARENT [1.0, 1.5] + orphan
        # [1.2, 1.3], in microseconds).
        assert root["ts"] == pytest.approx(1.0 * 1e6)
        assert root["dur"] == pytest.approx(0.5 * 1e6)
        # BOTH the orphan and the true top-level span hang off it, so
        # downstream consumers (Perfetto nesting, critpath extraction) see
        # one rooted tree per trace.
        by_span = {e["args"].get("span"): e for e in doc["traceEvents"]
                   if e.get("ph") == "X"}
        assert by_span["s9"]["args"]["parent"] == root["args"]["span"]
        assert by_span["s1"]["args"]["parent"] == root["args"]["span"]

    def test_orphan_adoption_keeps_critpath_shares_partitioned(self):
        # Graceful degradation end to end: the adopted document feeds the
        # critical-path extractor and shares still partition the charged
        # time exactly — overlap between the orphan subtree and the covered
        # chain stays concurrent, never double-charged.
        orphan = {"name": "gen/step", "start": 1.2, "dur": 0.1,
                  "span": "s9", "parent": "never-arrived", "trace": "t1",
                  "attrs": {"model": "lm_small"}}
        doc = merge_fleet_trace({
            "a": self._node([dict(self.PARENT, lane="a")]),
            "b": self._node([dict(orphan, lane="b")]),
        })
        crit = breakdown(spans_from_perfetto(doc))
        (body,) = crit.values()
        total = sum(ln["share"] for ln in body["lanes"])
        assert total == pytest.approx(1.0)
        assert body["requests"] == 1

    def test_no_orphans_no_synthetic_roots(self):
        doc = merge_fleet_trace({
            "a": self._node([self.PARENT]),
            "b": self._node([self.CHILD]),
        })
        assert "orphan_spans" not in doc["otherData"]
        assert not [e for e in doc["traceEvents"]
                    if e.get("name") == ORPHAN_ROOT_NAME]


# ===========================================================================
# tests/test_tracing_fleet.py
# ===========================================================================


@pytest.fixture(autouse=True)
def fresh_tracer(sided):
    """Every test starts from a clean, enabled-off global tracer and ends
    without leaking enablement into the rest of the suite."""
    tracer.reset()
    tracer.enabled = False
    yield
    tracer.enabled = False
    tracer.reset()


def spans_by_name() -> dict:
    return {e["name"]: e for e in tracer.events_wire()}


# ---------------------------------------------------------------------------
# Sim-fabric propagation
# ---------------------------------------------------------------------------


def make_chain(net: SimRpcNetwork):
    """leader -> member -> storage, each hop a traced RPC service."""
    net.serve("storage", traced_methods({
        "sdfs.fetch": lambda p: {"data": b"x"},
    }))

    def predict(p):
        net.client("member").call("storage", "sdfs.fetch", {}, timeout=5.0)
        return {"predictions": [0]}

    net.serve("member", traced_methods({"job.predict": predict}))

    def dispatch(p):
        return net.client("leader").call("member", "job.predict", {}, timeout=5.0)

    net.serve("leader", traced_methods({"job.start": dispatch}))


def test_nested_hops_share_one_trace_with_parent_links():
    net = SimRpcNetwork()
    make_chain(net)
    tracer.enabled = True
    with tracer.span("client/predict"):
        net.client("cli").call("leader", "job.start", {}, timeout=10.0)
    spans = spans_by_name()
    assert set(spans) == {
        "client/predict", "rpc/job.start", "rpc/job.predict", "rpc/sdfs.fetch"
    }
    trace_ids = {e["trace"] for e in spans.values()}
    assert len(trace_ids) == 1
    # Parent edges mirror the call tree exactly.
    assert spans["client/predict"]["parent"] is None
    assert spans["rpc/job.start"]["parent"] == spans["client/predict"]["span"]
    assert spans["rpc/job.predict"]["parent"] == spans["rpc/job.start"]["span"]
    assert spans["rpc/sdfs.fetch"]["parent"] == spans["rpc/job.predict"]["span"]
    # Lanes: each hop attributed to the node that served it.
    assert spans["rpc/job.start"]["lane"] == "leader"
    assert spans["rpc/job.predict"]["lane"] == "member"
    assert spans["rpc/sdfs.fetch"]["lane"] == "storage"


def test_every_frame_carries_the_same_trace_id():
    net = SimRpcNetwork()
    make_chain(net)
    tracer.enabled = True
    with tracer.span("root"):
        net.client("cli").call("leader", "job.start", {}, timeout=10.0)
    assert len(net.frames) == 3
    tids = {f["t"][0] for f in net.frames}
    assert len(tids) == 1
    # Each hop's `t` names the CALLER's span (the remote parent), so the
    # three frames carry three different span ids under one trace.
    sids = {f["t"][1] for f in net.frames}
    assert len(sids) == 3


def test_disabled_tracing_adds_zero_frame_bytes():
    net = SimRpcNetwork()
    make_chain(net)
    assert not tracer.enabled
    net.client("cli").call("leader", "job.start", {}, timeout=10.0)
    assert net.frames, "sanity: frames recorded"
    assert all("t" not in f for f in net.frames)
    assert tracer.events_wire() == []


def test_typed_errors_still_record_spans_and_leak_no_context():
    net = SimRpcNetwork()

    def overloaded(p):
        raise Overloaded("queue full", retry_after_s=0.1)

    def expired(p):
        raise DeadlineExceeded("budget exhausted")

    net.serve("m", traced_methods({"x.shed": overloaded, "x.late": expired}))
    tracer.enabled = True
    with tracer.span("root"):
        with pytest.raises(Overloaded):
            net.client("c").call("m", "x.shed", {}, timeout=5.0)
        with pytest.raises(DeadlineExceeded):
            net.client("c").call("m", "x.late", {}, timeout=5.0)
    assert tracectx.current() is None, "ambient context leaked past the spans"
    spans = spans_by_name()
    root = spans["root"]
    for name in ("rpc/x.shed", "rpc/x.late"):
        assert spans[name]["trace"] == root["trace"]
        assert spans[name]["parent"] == root["span"]


def test_expired_budget_rejected_before_handler_keeps_context_clean():
    net = SimRpcNetwork()
    net.serve("m", traced_methods({"x.go": lambda p: {}}))
    net.set_latency("c", "m", 10.0)  # transit eats the whole budget
    tracer.enabled = True
    with tracer.span("root"):
        with pytest.raises(Exception):
            net.client("c").call("m", "x.go", {}, timeout=1.0)
    assert tracectx.current() is None
    assert "rpc/x.go" not in spans_by_name()  # the method never ran


# ---------------------------------------------------------------------------
# Clock alignment + merge (pure functions, scripted offsets)
# ---------------------------------------------------------------------------


def test_merge_aligns_clocks_and_clamps_residual_skew():
    # Node B's tracer clock runs 5.0s AHEAD of the collector's; its span is
    # a child of A's span. Aligned, the child starts 10ms after the parent.
    per_node = {
        "a:1": {
            "offset": 0.0, "rtt": 0.001,
            "dump": {"events": [{
                "name": "parent", "start": 1.000, "dur": 0.100, "tid": 1,
                "trace": "t1", "span": "s1", "parent": None, "lane": "a:1",
                "attrs": {},
            }], "dropped": 0},
        },
        "b:2": {
            "offset": 5.0, "rtt": 0.001,
            "dump": {"events": [{
                "name": "child", "start": 6.010, "dur": 0.050, "tid": 2,
                "trace": "t1", "span": "s2", "parent": "s1", "lane": "b:2",
                "attrs": {},
            }, {
                # Residual skew artifact: aligned start would precede the
                # parent by 2ms — must be clamped to the parent's start.
                "name": "skewed", "start": 5.998, "dur": 0.010, "tid": 2,
                "trace": "t1", "span": "s3", "parent": "s1", "lane": "b:2",
                "attrs": {},
            }], "dropped": 0},
        },
    }
    doc = observe.merge_fleet_trace(per_node)
    events = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    meta = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
    assert {m["args"]["name"] for m in meta} == {"a:1", "b:2"}
    assert events["parent"]["pid"] != events["child"]["pid"]
    assert events["child"]["ts"] == pytest.approx(
        events["parent"]["ts"] + 10_000, abs=1.0
    )
    assert events["skewed"]["ts"] == pytest.approx(events["parent"]["ts"])
    assert doc["otherData"]["skew_clamped_children"] == 1


def test_measure_clock_offset_midpoint():
    net = SimRpcNetwork()
    remote_now = 100.0
    net.serve("n", traced_methods({"obs.clock": lambda p: {"now": remote_now}}))
    # Local virtual clock advances 0.2s per call (scripted link latency
    # charges transit on both the request and nothing on reply — midpoint
    # still lands between t0 and t1).
    net.set_latency("c", "n", 0.2)
    client = net.client("c")
    offset, rtt = observe.measure_clock_offset(
        client, "n", local_now=net.clock, samples=3
    )
    assert rtt == pytest.approx(0.2)
    # t0 = now, t1 = now + 0.2 per probe; remote stays 100.
    assert offset == pytest.approx(remote_now - (net.now - 0.2 + net.now) / 2, abs=0.5)


# ---------------------------------------------------------------------------
# Acceptance: localcluster predict -> one merged >=3-node trace
# ---------------------------------------------------------------------------


def test_fleet_trace_three_nodes_one_trace(tmp_path):
    """The fleet-trace acceptance: leader-dispatch, member-predict, and SDFS-pull
    spans from >= 3 distinct nodes share a single trace_id with correct
    parent edges and non-negative child offsets, in a merged trace that
    loads as Chrome/Perfetto JSON."""
    nodes: list = []
    blob_name = {"name": None}

    def make_backends(i: int):
        def predict(synsets):
            # Every shard pulls the published blob THROUGH SDFS: leader
            # directory lookup + member-to-member fetch, all under the
            # ambient trace of the rpc/job.predict span.
            nodes[i].sdfs.get_bytes(blob_name["name"])
            return [int(s[1:]) for s in synsets]

        return {"resnet18": predict}

    synsets = make_synsets(tmp_path / "synsets.txt", 24)
    nodes.extend(start_local_cluster(
        tmp_path, 3,
        backends=make_backends,
        synset_path=synsets,
        job_models=["resnet18"],
        replication_factor=2,
        dispatch_shard_size=4,
    ))
    try:
        leader = nodes[0]
        members = sorted(leader.active_member_addrs())
        assert len(members) == 3
        # Choose a blob whose hash placement starts AWAY from the leader's
        # member store: its replicas then live on the two non-leader nodes,
        # so a shard predicted by the node that fetches from the OTHER
        # replica holder touches three distinct lanes in one trace.
        leader_member = leader.self_member_addr
        name = next(
            f"corpus/blob{i}" for i in range(256)
            if placement_order(f"corpus/blob{i}", members)[-1] == leader_member
        )
        blob_name["name"] = name
        reply = nodes[1].sdfs.put_bytes(b"fixture-bytes" * 64, name)
        assert leader_member not in reply["replicas"]

        # The probe loops need a tick to agree on who leads before
        # `predict` can land (a deferring standby refuses it).
        wait_until(
            lambda: leader.tracker.current == leader.self_leader_addr,
            msg="tracker converged on the promoted leader",
        )
        tracing.enable()
        tracer.reset()
        leader.predict()
        wait_until(
            lambda: all(
                r["finished"] >= r["total"]
                for r in leader.jobs_report().values()
            ),
            timeout=60.0,
            msg="all shards finished",
        )

        out = tmp_path / "fleet_trace.json"
        doc = observe.export_fleet_trace(leader.rpc, members, out)
        tracing.disable()

        # The artifact is valid Perfetto/Chrome JSON.
        loaded = json.loads(out.read_text())
        events = [e for e in loaded["traceEvents"] if e.get("ph") == "X"]
        meta = [e for e in loaded["traceEvents"] if e.get("ph") == "M"]
        assert {m["args"]["name"] for m in meta} == set(members)
        assert doc["otherData"]["nodes"].keys() == set(members)

        # Index spans by trace.
        by_trace: dict[str, list[dict]] = {}
        for e in events:
            t = e["args"].get("trace")
            if t:
                by_trace.setdefault(t, []).append(e)

        def names(evs):
            return {e["name"] for e in evs}

        # THE acceptance trace: dispatch + predict + SDFS pull, >= 3 pids.
        best = None
        for t, evs in by_trace.items():
            pids = {e["pid"] for e in evs}
            if (
                len(pids) >= 3
                and "scheduler/dispatch" in names(evs)
                and "rpc/job.predict" in names(evs)
                and {"sdfs/pull", "rpc/sdfs.fetch_meta"} & names(evs)
            ):
                best = evs
                break
        assert best is not None, (
            "no trace spanned 3 nodes with dispatch+predict+pull; traces: "
            + str({t: sorted(names(evs)) for t, evs in by_trace.items()})
        )

        # Parent edges are correct within the merged trace.
        spans = {e["args"]["span"]: e for e in best}
        dispatch = next(e for e in best if e["name"] == "scheduler/dispatch")
        predict = next(e for e in best if e["name"] == "rpc/job.predict")
        assert dispatch["args"].get("parent") is None  # trace root
        assert predict["args"]["parent"] == dispatch["args"]["span"]
        pulls = [e for e in best if e["name"] == "sdfs/pull"]
        assert pulls and all(
            p["args"]["parent"] in spans for p in pulls
        )
        # Clock-aligned, non-negative child offsets: no child starts before
        # its parent anywhere in the merged document.
        all_spans = {
            e["args"]["span"]: e for e in events if e["args"].get("span")
        }
        violations = [
            (e["name"], e["ts"] - all_spans[e["args"]["parent"]]["ts"])
            for e in events
            if e["args"].get("parent") in all_spans
            and e["ts"] < all_spans[e["args"]["parent"]]["ts"]
        ]
        assert not violations, violations
    finally:
        tracing.disable()
        stop_local_cluster(nodes)


def test_fleet_metrics_scrape_and_prometheus(tmp_path):
    """The leader's probe-cadence scrape surfaces every member's counters
    through obs.fleet, and the Prometheus rendering labels them by node."""
    nodes = start_local_cluster(
        tmp_path, 3, synset_path=make_synsets(tmp_path / "s.txt", 8),
        job_models=["resnet18"],
    )
    try:
        leader = nodes[0]
        members = set(leader.active_member_addrs())
        wait_until(
            lambda: set(leader.fleet_metrics) == members,
            timeout=30.0,
            msg="leader scraped every member",
        )
        reply = nodes[1].rpc.call(leader.self_leader_addr, "obs.fleet", {}, timeout=5.0)
        assert set(reply["fleet"]) == members
        for addr, snap in reply["fleet"].items():
            assert "counters" in snap["metrics"]
            assert "gauges" in snap["metrics"]
        text = nodes[1].rpc.call(
            leader.self_leader_addr, "obs.fleet_prom", {}, timeout=5.0
        )["text"]
        for addr in members:
            assert f'node="{addr}"' in text
    finally:
        stop_local_cluster(nodes)
