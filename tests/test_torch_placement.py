"""Every case of tests/test_placement.py, run against both packages (the
``pkg`` fixture): the PlacementAdvisor (cost-balanced dealing, weight
normalization, sticky exclusion with re-entry hysteresis, the move budget,
the stale-plan bypass, ingest-aware and memory-headroom placement, gang
formation), the SloEvaluator (burn-rate math, alert edges, the fast-burn
callback, gauges and flight events), the degrade -> burn -> replan ->
recover soak on the sim fabric, and gang dispatch.

The names imported below are the JAX package's; ``sided`` rebinds each to
the object of the same name in the package under test, for each case. The
gang fixture's members are served by the JAX package's PredictWorker on
both sides; ``test_gang_plan_completes_on_port_members`` serves them by
this package's (``job.predict_gang``), and
``test_gang_plan_fails_visibly_on_port_members`` pins what a port member
whose backend cannot serve gang shards answers. The scheduler and advisor
under test are each package's own.
"""

from __future__ import annotations

import os
import random

import pytest
from torch_sides import JAX, PORT, bind_sides, pkg  # noqa: F401  (pkg: fixture)

from dmlc_tpu.cluster.flight import FlightRecorder
from dmlc_tpu.cluster.profile import CostProfiler
from dmlc_tpu.cluster.rpc import SimRpcNetwork
from dmlc_tpu.scheduler.jobs import JobScheduler
from dmlc_tpu.scheduler.placement import (
    PlacementAdvisor,
    PlacementPlan,
    SloEvaluator,
    SloObjective,
)
from dmlc_tpu.scheduler.worker import PredictWorker, gang_slice
from dmlc_tpu.utils.metrics import Counters

sided = bind_sides(globals(), {
    "FlightRecorder": "flight", "CostProfiler": "profile", "SimRpcNetwork": "rpc",
    "JobScheduler": "jobs", "PlacementAdvisor": "placement", "PlacementPlan": "placement",
    "SloEvaluator": "placement", "SloObjective": "placement", "PredictWorker": "worker",
    "gang_slice": "worker", "Counters": "metrics",
})

SEED_BASE = int(os.environ.get("DMLC_CHAOS_SEED", "0"))


def seeds(n: int) -> range:
    return range(SEED_BASE, SEED_BASE + n)


class VClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make_profiler(clock, **kw) -> CostProfiler:
    kw.setdefault("window_s", 10.0)
    kw.setdefault("windows", 4)
    kw.setdefault("decay", 0.5)
    return CostProfiler(clock=clock, **kw)


def feed(prof: CostProfiler, costs: dict, model: str = "resnet18", n: int = 8):
    """One amortized dispatch record per member at its scripted cost."""
    for m, c in costs.items():
        prof.record(model, m, "dispatch", c, count=n)


def make_workload(n):
    return [(f"n{i:05d}", i) for i in range(n)]


# ---------------------------------------------------------------------------
# PlacementAdvisor: the solver
# ---------------------------------------------------------------------------


class TestPlacementAdvisor:
    def test_abstains_with_nothing_to_place(self):
        adv = PlacementAdvisor(make_profiler(VClock()))
        assert adv.advise({}, ["m0"]) is None
        assert adv.advise({"job": 10}, []) is None

    def test_weights_normalize_to_the_slowest_member(self):
        clock = VClock()
        prof = make_profiler(clock)
        flight = FlightRecorder(clock=clock)
        adv = PlacementAdvisor(prof, flight=flight, clock=clock)
        feed(prof, {"m0": 0.1, "m1": 0.4})
        plan = adv.advise({"job": 100}, ["m0", "m1"])
        assert plan.assignment == {"job": ["m0", "m1"]}
        # The slowest member anchors at weight 1; the 4x-faster one gets 4x
        # the dispatch-pool share.
        assert plan.weights["job"] == {"m0": 4, "m1": 1}
        assert any(e["kind"] == "placement_decision" for e in flight.events())

    def test_weight_amplification_is_capped(self):
        clock = VClock()
        prof = make_profiler(clock)
        adv = PlacementAdvisor(prof, clock=clock)
        feed(prof, {"m0": 0.01, "m1": 1.0})
        plan = adv.advise({"job": 100}, ["m0", "m1"])
        # Raw ratio is 100x; the cap keeps one fast member from starving
        # the interleave of everyone else.
        assert plan.weights["job"]["m0"] == PlacementAdvisor.MAX_WEIGHT
        assert plan.weights["job"]["m1"] == 1

    def test_exclusion_is_sticky_until_well_under_the_line(self):
        clock = VClock()
        prof = make_profiler(clock)
        adv = PlacementAdvisor(prof, clock=clock, exclude_factor=3.0)
        jobs = {"job": 100}
        members = ["m0", "m1", "m2", "m3", "m4"]
        # Fleet at 0.1, one outlier at 1.0: line = 3 x median = 0.3.
        feed(prof, {"m0": 0.1, "m1": 0.1, "m2": 0.1, "m3": 0.1, "m4": 1.0})
        plan = adv.advise(jobs, members)
        assert plan.excluded == ["m4"]
        assert "m4" not in plan.assignment["job"]
        # Recovers into the hysteresis band (0.25 > 0.7 x line = 0.21):
        # still excluded — a member hovering at the line must not flap.
        clock.advance(50.0)  # the old windows age past the whole history
        feed(prof, {"m0": 0.1, "m1": 0.1, "m2": 0.1, "m3": 0.1, "m4": 0.25})
        adv.advise(jobs, members)
        assert adv.status()["excluded"] == ["m4"]
        # Well back under the re-entry line: re-admitted.
        clock.advance(50.0)
        feed(prof, {"m0": 0.1, "m1": 0.1, "m2": 0.1, "m3": 0.1, "m4": 0.12})
        plan3 = adv.advise(jobs, members)
        assert adv.status()["excluded"] == []
        assert "m4" in plan3.assignment["job"]

    def test_readmits_cheapest_when_jobs_outnumber_eligible(self):
        clock = VClock()
        prof = make_profiler(clock)
        adv = PlacementAdvisor(prof, clock=clock)
        feed(prof, {"m0": 0.1, "m1": 0.1, "m2": 10.0})
        plan = adv.advise({"a": 10, "b": 10, "c": 10}, ["m0", "m1", "m2"])
        # m2 is over the line, but three jobs need three members:
        # availability wins and the outlier is re-admitted.
        assert plan.excluded == []
        assert sorted(m for ms in plan.assignment.values() for m in ms) == [
            "m0", "m1", "m2",
        ]
        assert all(len(ms) == 1 for ms in plan.assignment.values())

    def test_identical_inputs_return_the_cached_plan(self):
        clock = VClock()
        prof = make_profiler(clock)
        adv = PlacementAdvisor(prof, clock=clock)
        feed(prof, {"m0": 0.1, "m1": 0.1})
        first = adv.advise({"job": 10}, ["m0", "m1"])
        assert adv.advise({"job": 10}, ["m0", "m1"]) is first

    def test_move_budget_throttles_churn(self):
        clock = VClock()
        prof = make_profiler(clock)
        metrics = Counters()
        flight = FlightRecorder(clock=clock)
        adv = PlacementAdvisor(
            prof, flight=flight, metrics=metrics, clock=clock,
            max_moves=2, window_s=1000.0, hysteresis=0.15,
        )
        jobs = {"a": 10, "b": 10}
        members = ["m0", "m1", "m2", "m3"]
        feed(prof, {m: 0.1 for m in members})
        first = adv.advise(jobs, members)
        # m3 becomes 10x faster: the solver wants a 3-move reshuffle that
        # clears hysteresis but blows the 2-move budget — throttled.
        clock.advance(50.0)
        feed(prof, {"m0": 0.1, "m1": 0.1, "m2": 0.1, "m3": 0.01})
        second = adv.advise(jobs, members)
        assert second is first
        assert metrics.get("placement_throttled") == 1
        assert any(e["kind"] == "placement_throttled" for e in flight.events())

    def test_hysteresis_rejects_marginal_improvements(self):
        clock = VClock()
        prof = make_profiler(clock)
        metrics = Counters()
        adv = PlacementAdvisor(
            prof, metrics=metrics, clock=clock,
            max_moves=100, window_s=1000.0, hysteresis=0.5,
        )
        jobs = {"a": 10, "b": 10}
        members = ["m0", "m1", "m2", "m3"]
        feed(prof, {m: 0.1 for m in members})
        first = adv.advise(jobs, members)
        clock.advance(50.0)
        feed(prof, {"m0": 0.1, "m1": 0.1, "m2": 0.1, "m3": 0.01})
        # The reshuffle improves the estimate ~33% — under the 50% bar, so
        # the previous plan stands (and this is NOT the budget's doing).
        assert adv.advise(jobs, members) is first
        assert metrics.get("placement_throttled") == 0
        assert metrics.get("placement_decisions") == 1

    def test_stale_plan_bypasses_hysteresis_and_budget(self):
        clock = VClock()
        prof = make_profiler(clock)
        adv = PlacementAdvisor(
            prof, clock=clock, max_moves=0, window_s=1000.0, hysteresis=0.99,
        )
        jobs = {"a": 10, "b": 10}
        feed(prof, {m: 0.1 for m in ["m0", "m1", "m2", "m3"]})
        first = adv.advise(jobs, ["m0", "m1", "m2", "m3"])
        assert "m3" in {m for ms in first.assignment.values() for m in ms}
        # m3 departs: the cached plan references a gone member, so even a
        # zero budget and maximal hysteresis cannot pin the fleet to it.
        second = adv.advise(jobs, ["m0", "m1", "m2"])
        assert second is not first
        assert all(
            m != "m3" for ms in second.assignment.values() for m in ms
        )

    def test_ingest_factors_bias_weights_and_are_flight_stamped(self):
        # With equal measured dispatch cost, the member that can
        # FEED its chips (idle decode lanes + local SDFS blobs) earns the
        # larger dispatch-pool share — and the factors are reconstructible
        # from the flight recorder (lint O2) and advisor status.
        clock = VClock()
        prof = make_profiler(clock)
        flight = FlightRecorder(clock=clock)
        idle = {"m0": 0.0, "m1": 8.0}
        locality = {"m0": 0.0, "m1": 1.0}
        adv = PlacementAdvisor(
            prof, flight=flight, clock=clock,
            decode_idle=idle.get, blob_locality=locality.get,
        )
        feed(prof, {"m0": 0.2, "m1": 0.2})
        plan = adv.advise({"job": 100}, ["m0", "m1"])
        # Bounded bias: full idle + full locality = 1 + 2 * ingest_bias.
        assert adv.status()["ingest_factors"] == {"m1": 1.6}
        assert plan.weights["job"]["m1"] > plan.weights["job"]["m0"]
        note = next(
            e for e in flight.events() if e["kind"] == "placement_decision"
        )
        assert "m1=1.6" in note["ingest"]

    def test_no_ingest_signals_means_pre_tier_behavior(self):
        clock = VClock()
        prof = make_profiler(clock)
        adv = PlacementAdvisor(prof, clock=clock)
        feed(prof, {"m0": 0.1, "m1": 0.4})
        plan = adv.advise({"job": 100}, ["m0", "m1"])
        # Neither callable wired: factors empty, weights exactly the
        # measured-cost normalization (bit-for-bit pre-decode-tier).
        assert adv.status()["ingest_factors"] == {}
        assert plan.weights["job"] == {"m0": 4, "m1": 1}

    def test_unknown_ingest_readings_stay_neutral(self):
        # A member the leader has not scraped yet (None) must not read as
        # zero capacity — factors only ever help, never penalize below 1x.
        clock = VClock()
        prof = make_profiler(clock)
        adv = PlacementAdvisor(
            prof, clock=clock,
            decode_idle=lambda m: None, blob_locality=lambda m: None,
        )
        feed(prof, {"m0": 0.1, "m1": 0.4})
        plan = adv.advise({"job": 100}, ["m0", "m1"])
        assert adv.status()["ingest_factors"] == {}
        assert plan.weights["job"] == {"m0": 4, "m1": 1}


# ---------------------------------------------------------------------------
# SloEvaluator: burn rates and alert edges
# ---------------------------------------------------------------------------


def make_evaluator(prof, clock, **kw):
    kw.setdefault("fast_window_s", 10.0)
    kw.setdefault("slow_window_s", 40.0)
    kw.setdefault("fast_burn", 5.0)
    kw.setdefault("slow_burn", 2.0)
    obj = SloObjective("resnet18", latency_s=0.5, availability=0.9)
    return SloEvaluator(prof, {"resnet18": obj}, **kw)


class TestSloEvaluator:
    def test_objective_parsing(self):
        objs = SloObjective.from_config({
            "resnet18": {"latency_s": 0.25},
            "llm": {"latency_s": 1.0, "availability": 0.999},
        })
        assert objs["resnet18"].availability == 0.99
        assert objs["llm"].error_budget == pytest.approx(0.001)
        assert SloObjective.from_config(None) == {}

    def test_alert_fires_once_and_clears_after_recovery(self):
        clock = VClock()
        prof = make_profiler(clock)
        metrics = Counters()
        flight = FlightRecorder(clock=clock)
        fired: list[str] = []
        ev = make_evaluator(
            prof, clock, metrics=metrics, flight=flight,
            on_fast_burn=fired.append,
        )
        state = ev.evaluate()
        assert state["resnet18"]["fast"] == 0.0
        assert not state["resnet18"]["fast_alert"]  # no evidence, no alert
        # Every observation over the objective: frac 1.0 / budget 0.1 = 10x.
        for _ in range(20):
            prof.record("resnet18", "m0", "dispatch", 1.0)
        state = ev.evaluate()
        assert state["resnet18"]["fast"] == pytest.approx(10.0)
        assert state["resnet18"]["fast_alert"] and state["resnet18"]["slow_alert"]
        assert fired == ["resnet18"]
        assert metrics.get("slo_fast_burn_alerts") == 1
        kinds = [e["kind"] for e in flight.events()]
        assert "slo_fast_burn" in kinds and "slo_slow_burn" in kinds
        # Still burning: the alert is edge-triggered, nothing refires.
        ev.evaluate()
        assert fired == ["resnet18"]
        assert metrics.get("slo_fast_burn_alerts") == 1
        # Recovery: the bad windows age past every horizon, burn hits 0,
        # both alerts clear.
        clock.advance(100.0)
        for _ in range(20):
            prof.record("resnet18", "m0", "dispatch", 0.01)
        state = ev.evaluate()
        assert not state["resnet18"]["fast_alert"]
        assert not state["resnet18"]["slow_alert"]
        assert any(e["kind"] == "slo_burn_clear" for e in flight.events())

    def test_alert_holds_inside_the_hysteresis_band(self):
        clock = VClock()
        prof = make_profiler(clock)
        ev = make_evaluator(prof, clock)
        for _ in range(10):
            prof.record("resnet18", "m0", "dispatch", 1.0)
        assert ev.evaluate()["resnet18"]["fast_alert"]
        # 30% over the objective: burn 3.0 — under the 5x threshold but
        # above the clear line (0.5 x 5 = 2.5), so the alert holds.
        clock.advance(100.0)
        for _ in range(7):
            prof.record("resnet18", "m0", "dispatch", 0.01)
        for _ in range(3):
            prof.record("resnet18", "m0", "dispatch", 1.0)
        state = ev.evaluate()
        assert state["resnet18"]["fast"] == pytest.approx(3.0)
        assert state["resnet18"]["fast_alert"]

    def test_status_and_registry_gauges(self):
        class Reg:
            def __init__(self):
                self.gauges = {}

            def gauge(self, name, fn):
                self.gauges[name] = fn

        clock = VClock()
        prof = make_profiler(clock)
        reg = Reg()
        ev = make_evaluator(prof, clock, registry=reg)
        for _ in range(4):
            prof.record("resnet18", "m0", "dispatch", 1.0)
        ev.evaluate()
        assert reg.gauges["slo_fast_burn_resnet18"]() == pytest.approx(10.0)
        assert reg.gauges["slo_slow_burn_resnet18"]() == pytest.approx(10.0)
        s = ev.status()
        assert s["fast_burn_threshold"] == 5.0
        m = s["models"]["resnet18"]
        assert m["objective_latency_s"] == 0.5
        assert m["p99_s"] == pytest.approx(1.0)
        assert m["fast_alert"] is True


# ---------------------------------------------------------------------------
# Scheduler integration: plan application + replan triggers
# ---------------------------------------------------------------------------


class SpyAdvisor:
    """Records every trigger the scheduler consults it with; abstains."""

    def __init__(self):
        self.calls: list[str] = []

    def advise(self, jobs, members, chip_weight=None, trigger="periodic"):
        self.calls.append(trigger)
        return None


class TestSchedulerIntegration:
    def _scheduler(self, advisor, members, flight=None):
        net = SimRpcNetwork()
        s = JobScheduler(
            net.client("L"),
            lambda: list(members),
            jobs={"resnet18": make_workload(8)},
            timer=net.clock,
            advisor=advisor,
            flight=flight,
        )
        s.is_leading = True
        return s

    def test_request_replan_reaches_the_advisor_once(self):
        spy = SpyAdvisor()
        s = self._scheduler(spy, ["m0", "m1"])
        s._start({})
        assert spy.calls and spy.calls[0] == "periodic"
        s.request_replan("slo_fast_burn:resnet18")
        s.assign_once()
        assert spy.calls[-1] == "slo_fast_burn:resnet18"
        s.assign_once()  # the trigger was consumed, not latched
        assert spy.calls[-1] == "periodic"

    def test_membership_change_is_its_own_trigger(self):
        spy = SpyAdvisor()
        members = ["m0", "m1"]
        s = self._scheduler(spy, members)
        s._start({})
        members.remove("m1")
        s.assign_once()
        assert spy.calls[-1] == "membership"

    def test_plan_application_builds_weighted_pool_and_stamps_flight(self):
        net = SimRpcNetwork()
        flight = FlightRecorder(clock=net.clock)
        plan = PlacementPlan(
            assignment={"resnet18": ["m0", "m1"]},
            weights={"resnet18": {"m0": 2, "m1": 1}},
        )

        class Fixed:
            def advise(self, *a, **k):
                return plan

        s = JobScheduler(
            net.client("L"),
            lambda: ["m0", "m1", "m2"],
            jobs={"resnet18": make_workload(8)},
            timer=net.clock,
            advisor=Fixed(),
            flight=flight,
        )
        s.is_leading = True
        s._start({})
        job = s.jobs["resnet18"]
        assert job.assigned == ["m0", "m1"]
        assert job.dispatch_pool == ["m0", "m1", "m0"]
        assert any(e["kind"] == "placement_apply" for e in flight.events())

    def test_incomplete_plan_falls_back_to_round_robin(self):
        plan = PlacementPlan(assignment={"resnet18": ["ghost"]})

        class Fixed:
            def advise(self, *a, **k):
                return plan

        s = self._scheduler(Fixed(), ["m0", "m1"])
        s._start({})
        # The plan references a member the scheduler cannot see: the pass
        # keeps the round-robin baseline instead of stranding the job.
        assert s.jobs["resnet18"].assigned == ["m0", "m1"]


# ---------------------------------------------------------------------------
# Acceptance soak: degrade -> fast burn -> replan -> recovery, all on the
# flight recorder
# ---------------------------------------------------------------------------


class PlacementFixture:
    """Six echo members on the sim fabric; the profiler, advisor, and SLO
    evaluator are wired exactly as cluster/node.py wires them, but driven
    synchronously on the fabric's virtual clock."""

    def __init__(self, seed: int, n_members=6, n_queries=40_000, shard=16):
        rng = random.Random(seed)
        self.net = SimRpcNetwork()
        self.members = [f"m{i}" for i in range(n_members)]
        self.base: dict[str, float] = {}
        for m in self.members:
            def backend(synsets, member=m):
                return [int(s[1:]) for s in synsets]

            self.net.serve(m, PredictWorker({"resnet18": backend}).methods())
            self.base[m] = 0.03 + rng.uniform(0.0, 0.01)
            self.net.set_latency("L", m, self.base[m])
        self.flight = FlightRecorder(clock=self.net.clock)
        self.metrics = Counters()
        self.profiler = CostProfiler(
            window_s=5.0, windows=8, decay=0.5, clock=self.net.clock
        )
        self.advisor = PlacementAdvisor(
            self.profiler, flight=self.flight, metrics=self.metrics,
            clock=self.net.clock, max_moves=4, window_s=10.0,
            hysteresis=0.1, exclude_factor=3.0,
        )
        self.scheduler = JobScheduler(
            self.net.client("L"),
            lambda: list(self.members),
            jobs={"resnet18": make_workload(n_queries)},
            shard_size=shard,
            shard_timeout_s=5.0,
            timer=self.net.clock,
            hedge_tail=False,
            metrics=self.metrics,
            flight=self.flight,
            profiler=self.profiler,
            advisor=self.advisor,
        )
        self.scheduler.is_leading = True
        self.evaluator = SloEvaluator(
            self.profiler,
            {"resnet18": SloObjective("resnet18", latency_s=0.1,
                                      availability=0.95)},
            fast_window_s=5.0, slow_window_s=20.0,
            fast_burn=2.0, slow_burn=1.0,
            metrics=self.metrics, flight=self.flight,
            on_fast_burn=lambda model: self.scheduler.request_replan(
                f"slo_fast_burn:{model}"
            ),
        )

    def step(self) -> dict:
        """One scheduler tick + one SLO evaluation (the leader's scrape
        cadence, collapsed to every tick for the sim)."""
        self.scheduler.assign_once()
        if self.scheduler.dispatch_all_once() == 0:
            self.net.advance(0.05)
        return self.evaluator.evaluate()

    def p99(self) -> float:
        return self.profiler.percentile(
            99, model="resnet18", stage="dispatch", horizon_s=5.0
        )


class TestPlacementSoak:
    @pytest.mark.parametrize("seed", seeds(2))
    def test_degraded_member_burns_then_placement_recovers(self, seed):
        f = PlacementFixture(seed)
        f.scheduler._start({})
        victim = random.Random(seed + 1).choice(f.members)

        # Phase 1 — healthy warmup: profiles accumulate, nothing alerts.
        while f.net.now < 10.0:
            state = f.step()
        assert not state["resnet18"]["fast_alert"]
        assert f.p99() < 0.1

        # Phase 2 — degrade one member 5x: well over the 0.1 s objective,
        # well under the shard timeout (slow-but-alive, gray's blind spot
        # with gray ejection disabled — placement must carry this alone).
        f.net.set_latency("L", victim, 5 * f.base[victim])
        alert_t = None
        for _ in range(4000):
            if f.step()["resnet18"]["fast_alert"]:
                alert_t = f.net.now
                break
        assert alert_t is not None, "degraded member never tripped fast burn"

        # Phase 3 — the advisor must exclude the victim and fleet p99 must
        # come back under the objective within three fast windows.
        deadline = alert_t + 3 * f.evaluator.fast_window_s
        recovered_t = None
        for _ in range(8000):
            f.step()
            assert not all(j.done for j in f.scheduler.jobs.values()), (
                "workload drained before recovery could be observed"
            )
            if victim in f.advisor.status()["excluded"] and f.p99() < 0.1:
                recovered_t = f.net.now
                break
        assert recovered_t is not None, "victim never excluded / p99 stuck"
        assert recovered_t <= deadline, (
            f"recovery took {recovered_t - alert_t:.1f}s "
            f"(> {deadline - alert_t:.1f}s budget)"
        )
        assert victim not in f.scheduler.jobs["resnet18"].assigned

        # Churn stayed inside the move budget.
        st = f.advisor.status()
        assert st["moves_used"] <= st["max_moves"]

        # Every decision on the path is reconstructible from the recorder:
        # the burn alert, the advisor's decision (naming the exclusion),
        # and the scheduler applying it.
        kinds = {e["kind"] for e in f.flight.events()}
        assert {"slo_fast_burn", "placement_decision", "placement_apply"} <= kinds
        assert any(
            e["kind"] == "placement_decision" and victim in e.get("excluded", "")
            for e in f.flight.events()
        )


# ---------------------------------------------------------------------------
# Memory-headroom HARD constraint (cluster/devicemon.py)
# ---------------------------------------------------------------------------


class TestHeadroomHardConstraint:
    """A member whose scraped HBM headroom (hbm_limit - hbm_in_use) cannot
    hold a model's analytic resident bytes is never dealt that model — a
    refusal inside the solver, not a cost weighting. Unknown on either side
    (unscraped member, CPU backend with no stats, unregistered model) never
    blocks: absence of telemetry must not strand a job."""

    def _advisor(self, headroom, model_bytes, **kw):
        clock = VClock()
        prof = make_profiler(clock)
        adv = PlacementAdvisor(
            prof, clock=clock, headroom=headroom, model_bytes=model_bytes, **kw
        )
        feed(prof, {"m0": 0.1, "m1": 0.1})
        return adv

    def test_refuses_member_whose_headroom_cannot_hold_the_model(self):
        clock = VClock()
        flight = FlightRecorder(clock=clock)
        metrics = Counters()
        room = {"m0": 8e9, "m1": 1e9}
        adv = self._advisor(
            room.get, lambda j: 2e9, flight=flight, metrics=metrics
        )
        plan = adv.advise({"job": 100}, ["m0", "m1"])
        assert plan.assignment["job"] == ["m0"]
        assert adv.status()["headroom_blocked"] == {"job": ["m1"]}
        assert metrics.get("placement_headroom_blocked") == 1
        # The refusal is reconstructible from the recorder (lint O2).
        note = [e for e in flight.events() if e["kind"] == "placement_decision"][-1]
        assert note["headroom_blocked"] == "job=m1"

    def test_unknown_headroom_never_blocks(self):
        adv = self._advisor(lambda m: None, lambda j: 2e9)
        plan = adv.advise({"job": 100}, ["m0", "m1"])
        assert sorted(plan.assignment["job"]) == ["m0", "m1"]
        assert adv.status()["headroom_blocked"] == {}

    def test_unknown_model_bytes_never_blocks(self):
        adv = self._advisor(lambda m: 1e9, lambda j: None)
        plan = adv.advise({"job": 100}, ["m0", "m1"])
        assert sorted(plan.assignment["job"]) == ["m0", "m1"]
        assert adv.status()["headroom_blocked"] == {}

    def test_blocks_are_per_job_not_fleet_wide(self):
        # m1 is too full for the big model but fine for the small one.
        room = {"m0": 8e9, "m1": 1e9}
        sizes = {"big": 4e9, "small": 1e8}
        adv = self._advisor(room.get, sizes.get)
        plan = adv.advise({"big": 50, "small": 50}, ["m0", "m1"])
        assert plan.assignment["big"] == ["m0"]
        assert "m1" in plan.assignment["small"]
        assert adv.status()["headroom_blocked"] == {"big": ["m1"]}

    def test_job_blocked_everywhere_gets_no_members(self):
        # Dispatching it anywhere would OOM the member; an empty
        # assignment is the correct, visible answer.
        adv = self._advisor(lambda m: 1e9, {"big": 4e9, "small": 1e8}.get)
        plan = adv.advise({"big": 50, "small": 50}, ["m0", "m1"])
        assert plan.assignment["big"] == []
        assert sorted(plan.assignment["small"]) == ["m0", "m1"]
        assert adv.status()["headroom_blocked"] == {"big": ["m0", "m1"]}

    def test_callback_errors_treated_as_unknown(self):
        def boom(_):
            raise RuntimeError("scrape race")

        adv = self._advisor(boom, lambda j: 2e9)
        plan = adv.advise({"job": 100}, ["m0", "m1"])
        assert sorted(plan.assignment["job"]) == ["m0", "m1"]


# ---------------------------------------------------------------------------
# Gang-sharded placement: a model that fits NO
# single member's HBM becomes a chip gang, not a refusal
# ---------------------------------------------------------------------------


class GangEchoBackend:
    """Gang-capable fake: ``predict_gang`` answers this rank's contiguous
    slice; solo dispatch of the over-HBM model is a bug, so ``__call__``
    fails loudly (the real LmBackend refuses with a typed RpcError)."""

    def __call__(self, synsets):
        raise AssertionError("over-HBM model must never be dispatched solo")

    def predict_gang(self, synsets, rank, world):
        start, stop = gang_slice(len(synsets), rank, world)
        return [int(s[1:]) for s in synsets[start:stop]]


class TestGangPlacement:
    """Over-HBM models gang instead of starving: the advisor trades replica
    count against shard width from the same cost lanes and HBM gauges the
    solo path uses."""

    def _advisor(self, headroom, model_bytes, costs=None, **kw):
        clock = VClock()
        prof = make_profiler(clock)
        adv = PlacementAdvisor(
            prof, clock=clock, headroom=headroom, model_bytes=model_bytes, **kw
        )
        feed(prof, costs or {"m0": 0.1, "m1": 0.1, "m2": 0.1, "m3": 0.1})
        return adv

    def test_over_hbm_job_gets_a_gang_not_a_refusal(self):
        clock = VClock()
        flight = FlightRecorder(clock=clock)
        metrics = Counters()
        # 25 MB model, 10 MB headroom everywhere: solo is impossible on
        # every member, but a 3-wide gang's ~8.3 MB share fits each.
        adv = self._advisor(
            lambda m: 10e6, {"lm": 25e6, "small": 1e6}.get,
            flight=flight, metrics=metrics,
        )
        plan = adv.advise({"lm": 50, "small": 50}, ["m0", "m1", "m2", "m3"])
        assert plan.gangs == {"lm": 3}
        assert len(plan.assignment["lm"]) == 3
        assert plan.weights["lm"] == {}  # gangs have no dispatch pool
        assert metrics.get("placement_gangs_formed") == 1
        # The small job still places solo; it did not inherit gang shape.
        assert plan.assignment["small"] and "small" not in plan.gangs
        assert adv.status()["gangs"] == {"lm": 3}
        # The decision is reconstructible from the recorder (lint O2).
        note = [
            e for e in flight.events() if e["kind"] == "placement_decision"
        ][-1]
        assert note["gangs"].startswith("lm:3=")

    def test_gang_width_is_minimal_feasible(self):
        # 40 MB over 25 MB headroom: a 2-wide share (20 MB) already fits,
        # so the advisor must NOT burn a third chip on this job.
        adv = self._advisor(lambda m: 25e6, {"lm": 40e6}.get)
        plan = adv.advise({"lm": 10}, ["m0", "m1", "m2", "m3"])
        assert plan.gangs == {"lm": 2}

    def test_gang_members_follow_cost_lane_capacity(self):
        # m0's dispatch lane runs 2x the fleet cost (still under the
        # exclusion line): the 3-wide gang must land on the three members
        # whose lanes can actually feed it.
        adv = self._advisor(
            lambda m: 10e6, {"lm": 25e6}.get,
            costs={"m0": 0.2, "m1": 0.1, "m2": 0.1, "m3": 0.1},
        )
        plan = adv.advise({"lm": 10}, ["m0", "m1", "m2", "m3"])
        assert plan.gangs["lm"] == 3
        assert "m0" not in plan.assignment["lm"]

    def test_gang_members_follow_chip_weights(self):
        # Equal costs, but m3 advertises 4 chips: capacity = chips/cost
        # puts it first in the gang.
        adv = self._advisor(lambda m: 13e6, {"lm": 25e6}.get)
        plan = adv.advise(
            {"lm": 10}, ["m0", "m1", "m2", "m3"],
            chip_weight={"m0": 1, "m1": 1, "m2": 1, "m3": 4},
        )
        assert plan.gangs["lm"] == 2
        assert "m3" in plan.assignment["lm"]

    def test_truly_unplaceable_job_still_gets_no_members(self):
        # Even the widest gang cannot shard 100 MB into 10 MB headrooms
        # across two members: empty assignment remains the honest answer.
        adv = self._advisor(lambda m: 10e6, {"lm": 100e6}.get)
        plan = adv.advise({"lm": 10}, ["m0", "m1"])
        assert plan.assignment["lm"] == []
        assert plan.gangs == {}


class GangFixture:
    """Four gang-capable members on the sim fabric with headroom gauges too
    small for the model solo — wired like cluster/node.py wires the leader,
    driven on the virtual clock."""

    def __init__(self, n_members: int = 4, n_queries: int = 64, shard: int = 8):
        self.net = SimRpcNetwork()
        self.members = [f"m{i}" for i in range(n_members)]
        for m in self.members:
            self.net.serve(
                m, JAX.worker.PredictWorker({"lm": GangEchoBackend()}).methods()
            )
        self.flight = FlightRecorder(clock=self.net.clock)
        self.metrics = Counters()
        self.profiler = CostProfiler(
            window_s=5.0, windows=8, decay=0.5, clock=self.net.clock
        )
        self.advisor = PlacementAdvisor(
            self.profiler, flight=self.flight, metrics=self.metrics,
            clock=self.net.clock,
            headroom=lambda m: 10e6, model_bytes={"lm": 25e6}.get,
        )
        feed(self.profiler, {m: 0.1 for m in self.members}, model="lm")
        self.scheduler = JobScheduler(
            self.net.client("L"),
            lambda: list(self.members),
            jobs={"lm": [(f"p{i}", i) for i in range(n_queries)]},
            shard_size=shard,
            shard_timeout_s=5.0,
            timer=self.net.clock,
            hedge_tail=False,
            metrics=self.metrics,
            flight=self.flight,
            profiler=self.profiler,
            advisor=self.advisor,
        )
        self.scheduler.is_leading = True

    def step(self) -> None:
        self.scheduler.assign_once()
        if self.scheduler.dispatch_all_once() == 0:
            self.net.advance(0.05)

    def run_until(self, pred, budget_s: float = 60.0) -> bool:
        deadline = self.net.now + budget_s
        while self.net.now < deadline:
            self.step()
            if pred():
                return True
        return False


class TestGangDispatch:
    def test_over_hbm_model_serves_through_the_gang_path(self):
        f = GangFixture()
        f.scheduler._start({})
        job = f.scheduler.jobs["lm"]
        assert job.gang_world == 3
        assert f.run_until(lambda: job.done), job.report()
        assert job.accuracy == 1.0
        assert job.gang_shards == 8  # 64 queries / shard 8, all collective
        # Solo predict never fired: every dispatch was the gang verb.
        assert all(m != "job.predict" for _, m in f.net.calls)

    @pytest.mark.parametrize("seed", seeds(3))
    def test_gang_member_death_tears_down_and_replans(self, seed):
        f = GangFixture()
        f.scheduler._start({})
        job = f.scheduler.jobs["lm"]
        gang = list(job.assigned)
        assert job.gang_world == 3 and len(gang) == 3

        # Phase 1 — healthy gang serves a few collective shards.
        assert f.run_until(lambda: job.gang_shards >= 2), job.report()

        # Phase 2 — kill one member MID-STREAM (chaos-seeded choice). The
        # in-flight shard fails with the typed unreachable error, the whole
        # gang is released (all-or-nothing), and a replan is forced.
        victim = random.Random(seed).choice(gang)
        f.net.crash(victim)
        assert f.run_until(
            lambda: any(
                e["kind"] == "gang_teardown" for e in f.flight.events()
            ),
            budget_s=30.0,
        ), "gang teardown never recorded"
        tear = [e for e in f.flight.events() if e["kind"] == "gang_teardown"][0]
        assert tear["job"] == "lm" and tear["world"] == 3
        assert set(tear["released"].split(",")) == set(gang)
        assert "unreachable" in tear["why"].lower()

        # Phase 3 — failure detection removes the member; the advisor
        # re-forms the gang from survivors and the stream drains with no
        # hung dispatches and full accuracy.
        f.members.remove(victim)
        assert f.run_until(lambda: job.done, budget_s=120.0), job.report()
        assert job.accuracy == 1.0
        assert victim not in job.assigned
        assert job.gang_world == 3 and len(job.assigned) == 3
        assert not job.outstanding, "hung gang dispatches left behind"
        # The replan is attributable: teardown forced its own trigger.
        assert any(
            e["kind"] == "placement_decision"
            and e.get("trigger", "").startswith(("gang_member_lost", "membership"))
            for e in f.flight.events()
        )


def test_gang_plan_completes_on_port_members(pkg):
    """A chip-gang plan dispatched to this package's members runs through
    their ``job.predict_gang``: the job completes with accuracy 1.0 and is
    never folded into solo ``job.predict`` dispatches. The scheduler and
    advisor are the package's under test; the members are this package's."""
    f = GangFixture()
    for m in f.members:
        f.net.serve(m, PORT.worker.PredictWorker({"lm": GangEchoBackend()}).methods())
    f.scheduler._start({})
    job = f.scheduler.jobs["lm"]
    assert job.gang_world == 3
    assert f.run_until(lambda: job.done), job.report()
    assert job.accuracy == 1.0
    assert job.gang_shards == 8
    assert any(m == "job.predict_gang" for _, m in f.net.calls)
    assert all(m != "job.predict" for _, m in f.net.calls)


def test_gang_plan_fails_visibly_on_port_members(pkg):
    """A chip-gang plan dispatched to this package's members whose backend
    cannot serve gang shards (no ``predict_gang``) stops the job with the
    members' ``cannot serve gang shards`` error in its result: the gang is
    never folded into solo ``job.predict`` dispatches."""
    f = GangFixture()
    for m in f.members:
        f.net.serve(m, PORT.worker.PredictWorker({"lm": lambda synsets: [0] * len(synsets)})
                    .methods())
    f.scheduler._start({})
    job = f.scheduler.jobs["lm"]
    assert job.gang_world == 3
    assert f.run_until(lambda: not job.running, budget_s=60.0), job.report()
    assert "gang dispatch failing repeatedly" in job.last_error
    assert "backend for 'lm' cannot serve gang shards" in job.last_error
    assert job.report()["last_error"] == job.last_error
    assert job.finished == 0 and job.gang_shards == 0
    assert all(m != "job.predict" for _, m in f.net.calls)
    stopped = [e for e in f.flight.events() if e["kind"] == "job_stopped"]
    assert stopped and "cannot serve gang shards" in stopped[-1]["error"]
