"""Every case of tests/test_autoscaler.py, run against both packages (the
``pkg`` fixture): the Autoscaler's decision engine (multiplicative scale-up
on the burn edge, asymmetric hysteresis, the per-tick moves budget, the
memory guard on memory-bound targets, per-tenant composite lanes, every
decision flight-recorded) and the tenant-isolation certification of the
package's own ``loadgen.tenant_isolation_harness``, judged by its
``validate_slo_cert`` and by ``tools/slo_cert.tenant_failures``.

The names imported below are the JAX package's; ``sided`` rebinds each to
the object of the same name in the package under test, for each case.
"""

from __future__ import annotations

import os

import pytest
from torch_sides import JAX, bind_sides, pkg  # noqa: F401  (pkg: fixture)

from dmlc_tpu.cluster.flight import FlightRecorder
from dmlc_tpu.loadgen import tenant_isolation_harness, validate_slo_cert
from dmlc_tpu.scheduler.autoscaler import Autoscaler, ScaleTarget
from dmlc_tpu.utils.metrics import Counters
from tools.slo_cert import tenant_failures

sided = bind_sides(globals(), {
    "FlightRecorder": "flight", "tenant_isolation_harness": "loadgen",
    "validate_slo_cert": "loadgen", "Autoscaler": "autoscaler", "ScaleTarget": "autoscaler",
    "Counters": "metrics",
})

SEED_BASE = int(os.environ.get("DMLC_CHAOS_SEED", "0"))


class Knob:
    """A fake ScaleTarget seam that clamps like the real ones do."""

    def __init__(self, value: int, ceiling: int = 64):
        self.value = value
        self.ceiling = ceiling
        self.applied: list[int] = []

    def get(self) -> int:
        return self.value

    def apply(self, value: int) -> int:
        self.value = max(1, min(self.ceiling, int(value)))
        self.applied.append(self.value)
        return self.value


def make(knob: Knob, *, clock=None, flight=None, metrics=None,
         models=None, memory_bound=False, hbm_used=None,
         clear_windows=3, moves_budget=2, lo=1, hi=64) -> Autoscaler:
    t = [0.0]
    auto = Autoscaler(
        flight=flight, metrics=metrics,
        clock=clock or (lambda: t.__setitem__(0, t[0] + 1.0) or t[0]),
        clear_windows=clear_windows, moves_budget=moves_budget,
        hbm_used=hbm_used,
    )
    auto.register(ScaleTarget(
        "knob", get=knob.get, apply=knob.apply, lo=lo, hi=hi,
        models=models, memory_bound=memory_bound,
    ))
    return auto


class TestDecisionEngine:
    def test_scale_up_is_multiplicative_with_floor_of_one(self):
        knob = Knob(1)
        auto = make(knob)
        for expected in (2, 3, 4, 6, 9):
            decisions = auto.tick(["llm-7b"], {"llm-7b": 12.0})
            assert [d["direction"] for d in decisions] == ["up"]
            assert knob.value == expected
        up = auto.decisions[-1]
        assert up["trigger"] == "slo_fast_burn:llm-7b"
        assert up["burn"] == 12.0

    def test_scale_down_waits_clear_windows_then_single_steps(self):
        knob = Knob(4)
        auto = make(knob, clear_windows=3)
        assert auto.tick([], {}) == []  # streak 1
        assert auto.tick([], {}) == []  # streak 2
        down = auto.tick([], {})        # streak 3: first shrink
        assert [d["direction"] for d in down] == ["down"]
        assert knob.value == 3
        assert down[0]["trigger"] == "slo_clear:3w"
        auto.tick([], {})
        assert knob.value == 2  # one step per tick, never a cliff

    def test_burn_resets_the_clear_streak(self):
        knob = Knob(4)
        auto = make(knob, clear_windows=3)
        auto.tick([], {})
        auto.tick([], {})
        auto.tick(["llm-7b"], {"llm-7b": 8.0})  # burn: streak back to zero
        assert knob.value == 6  # and an up-move
        assert auto.tick([], {}) == []
        assert auto.tick([], {}) == []
        assert knob.value == 6  # two quiet ticks are not enough to shrink

    def test_moves_budget_bounds_actuations_and_records_the_hold(self):
        knobs = [Knob(2) for _ in range(3)]
        flight = FlightRecorder(clock=lambda: 0.0, node="test")
        auto = Autoscaler(flight=flight, clock=lambda: 0.0, moves_budget=2)
        for i, k in enumerate(knobs):
            auto.register(ScaleTarget(f"k{i}", get=k.get, apply=k.apply))
        decisions = auto.tick(["llm-7b"], {})
        assert [d["direction"] for d in decisions] == ["up", "up", "hold"]
        assert decisions[2]["reason"] == "moves_budget"
        assert [k.value for k in knobs] == [3, 3, 2]
        # Lint O2: the refusal is in the flight ring too, with its trigger.
        kinds = [n for n in flight.events()
                 if n["kind"] == "autoscale_decision"]
        assert len(kinds) == 3
        assert kinds[2]["reason"] == "moves_budget"

    def test_hbm_guard_blocks_memory_bound_growth(self):
        knob = Knob(2)
        auto = make(knob, memory_bound=True, hbm_used=lambda: 0.95)
        decisions = auto.tick(["llm-7b"], {})
        assert [d["direction"] for d in decisions] == ["hold"]
        assert decisions[0]["reason"] == "hbm_guard"
        assert decisions[0]["hbm_used"] == 0.95
        assert knob.value == 2

    def test_hbm_unknown_never_blocks(self):
        knob = Knob(2)
        auto = make(knob, memory_bound=True, hbm_used=lambda: None)
        assert [d["direction"] for d in auto.tick(["llm-7b"], {})] == ["up"]

    def test_composite_tenant_lane_matches_model_target(self):
        knob = Knob(2)
        auto = make(knob, models={"llm-7b"})
        decisions = auto.tick(["llm-7b@acme"], {"llm-7b@acme": 9.0})
        assert [d["direction"] for d in decisions] == ["up"]
        assert decisions[0]["trigger"] == "slo_fast_burn:llm-7b@acme"

    def test_unrelated_burn_does_not_grow_a_scoped_target(self):
        knob = Knob(2)
        auto = make(knob, models={"resnet50"})
        assert auto.tick(["llm-7b@acme"], {}) == []
        assert knob.value == 2

    def test_ceiling_and_floor_are_respected(self):
        knob = Knob(4, ceiling=4)
        auto = make(knob, hi=4, clear_windows=1)
        assert auto.tick(["llm-7b"], {}) == []  # at hi: nothing to decide
        auto2 = make(Knob(1), lo=1, clear_windows=1)
        assert auto2.tick([], {}) == []  # at lo: nothing to shrink

    def test_effective_value_recorded_not_the_wish(self):
        knob = Knob(3, ceiling=4)  # seam clamps 3*1.5=4.5 -> 4
        auto = make(knob, hi=10)
        decisions = auto.tick(["llm-7b"], {})
        assert decisions[0]["to"] == 4

    def test_metrics_count_directions(self):
        metrics = Counters()
        knob = Knob(2)
        auto = make(knob, metrics=metrics, clear_windows=1)
        auto.tick(["llm-7b"], {})
        auto.tick([], {})
        assert metrics.get("autoscale_up") == 1
        assert metrics.get("autoscale_down") == 1

    def test_status_shape(self):
        knob = Knob(2)
        auto = make(knob, clear_windows=5)
        auto.tick(["llm-7b"], {})
        status = auto.status()
        assert status["targets"]["knob"]["current"] == 3
        assert status["targets"]["knob"]["clear_streak"] == 0
        assert status["last_decision"]["direction"] == "up"
        assert status["clear_windows"] == 5


# ---------------------------------------------------------------------------
# The isolation certification across the chaos seed matrix
# ---------------------------------------------------------------------------


_CERTS: dict = {}


class TestTenantIsolationCertification:
    @pytest.fixture
    def cert(self, pkg):
        # One certificate a package, reused by the class's cases (the
        # reference's class scope, kept per package).
        if pkg.name not in _CERTS:
            _CERTS[pkg.name] = pkg.loadgen.tenant_isolation_harness(6, SEED_BASE).run()
        return _CERTS[pkg.name]

    def test_certificate_validates(self, cert):
        assert validate_slo_cert(cert) == []

    def test_isolation_and_convergence_verdicts(self, cert):
        # The exact verdicts CI's tenant leg gates on (tools/slo_cert.py
        # --tenants): a divergence between pytest and CI here means the
        # shared helper drifted, which is itself a failure.
        assert tenant_failures(cert) == []

    def test_surge_is_quota_bounded_within_tenant_a(self, cert):
        surging = cert["tenants"]["tenants"]["acme"]
        assert surging["shed_over_quota"] > 0
        assert surging["shed_over_quota"] <= surging["shed"]
        # The surge still made progress inside its allowance.
        assert surging["ok"] > 0

    def test_tenant_b_p99_certified_through_the_surge(self, cert):
        steady = cert["tenants"]["tenants"]["default"]
        assert steady["certified"] is True
        for model, body in steady["models"].items():
            assert body["certified"] is True, model
            assert body["p99_s"] <= body["objective_latency_s"]

    def test_zero_cross_tenant_evictions(self, cert):
        assert cert["tenants"]["cross_tenant_evictions"] == 0

    def test_autoscaler_scales_up_within_three_fast_burn_windows(self, cert):
        auto = cert["autoscaler"]
        assert auto["first_burn_cycle"] is not None
        assert auto["scale_up_cycles"] is not None
        assert auto["scale_up_cycles"] <= 3

    def test_autoscaler_scales_back_down_without_breach(self, cert):
        auto = cert["autoscaler"]
        assert auto["scaled_down"] is True
        assert auto["breach_after_scale_down"] is False
        # Converged all the way back to the floor after the crowd passed.
        assert auto["capacity_units"] == 1

    def test_every_decision_is_flight_recorded(self, cert):
        auto = cert["autoscaler"]
        assert auto["decisions"], "the surge must have produced decisions"
        assert auto["flight_recorded"] >= len(auto["decisions"])
        for decision in auto["decisions"]:
            assert decision["direction"] in ("up", "down", "hold")
            assert decision["trigger"]
