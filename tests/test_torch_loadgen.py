"""Every case of tests/test_loadgen.py, run against both packages (the
``pkg`` fixture): seeded open-loop arrivals, the flash-crowd certification
at 1% base sampling (burn rates against the SloEvaluator and recomputed
from the profiler, every error trace in the merged fleet trace, the scrape
tree's cost bound) and ``validate_slo_cert``'s refusals; and, beside them,
the same seed giving equal certificates in both packages apart from wall
times.

The names imported below are the JAX package's; ``sided`` rebinds each to
the object of the same name in the package under test, for each case.
"""

from __future__ import annotations

import os

import pytest
from torch_sides import JAX, PORT, bind_sides, pkg  # noqa: F401  (pkg: fixture)

from dmlc_tpu.loadgen import (
    FlashCrowd,
    OpenLoopArrivals,
    ReplayHarness,
    TrafficMix,
    TrafficSpec,
    validate_slo_cert,
)

sided = bind_sides(globals(), {
    "FlashCrowd": "loadgen", "OpenLoopArrivals": "loadgen", "ReplayHarness": "loadgen",
    "TrafficMix": "loadgen", "TrafficSpec": "loadgen", "validate_slo_cert": "loadgen",
})

SEED_BASE = int(os.environ.get("DMLC_CHAOS_SEED", "0"))

MIXES = (
    TrafficMix("resnet50", "predict", 0.7),
    TrafficMix("llm-7b", "generate", 0.3),
)


def flash_spec(seed: int, duration: float = 60.0) -> TrafficSpec:
    return TrafficSpec(
        duration_s=duration, base_rps=24.0,
        mixes=tuple(TrafficMix(m.model, m.kind, m.weight) for m in MIXES),
        diurnal_amplitude=0.2, diurnal_period_s=2 * duration,
        flash_crowds=(FlashCrowd(duration / 3, duration / 4, 6.0),),
        seed=seed,
    )


class TestArrivals:
    def test_same_seed_same_schedule(self):
        spec = flash_spec(SEED_BASE)
        a = list(OpenLoopArrivals(spec))
        b = list(OpenLoopArrivals(spec))
        assert a == b
        assert a and all(0 <= t < spec.duration_s for t, _ in a)

    def test_different_seed_different_schedule(self):
        a = list(OpenLoopArrivals(flash_spec(SEED_BASE)))
        b = list(OpenLoopArrivals(flash_spec(SEED_BASE + 1)))
        assert [t for t, _ in a] != [t for t, _ in b]

    def test_flash_crowd_multiplies_the_rate(self):
        spec = flash_spec(SEED_BASE)
        crowd = spec.flash_crowds[0]
        inside = spec.rate_at(crowd.start_s + crowd.duration_s / 2)
        just_before = spec.rate_at(crowd.start_s - 0.001)
        assert inside > 4.0 * just_before  # x6 minus diurnal drift
        assert spec.rate_at(crowd.start_s + crowd.duration_s) < inside

    def test_arrival_density_follows_the_crowd(self):
        spec = flash_spec(SEED_BASE, duration=60.0)
        times = [t for t, _ in OpenLoopArrivals(spec)]
        crowd = spec.flash_crowds[0]
        in_crowd = sum(
            1 for t in times if crowd.start_s <= t < crowd.start_s + crowd.duration_s
        )
        per_s_in = in_crowd / crowd.duration_s
        per_s_out = (len(times) - in_crowd) / (spec.duration_s - crowd.duration_s)
        assert per_s_in > 3.0 * per_s_out

    def test_mix_weights_respected(self):
        spec = flash_spec(SEED_BASE)
        kinds = [m.kind for _, m in OpenLoopArrivals(spec)]
        predict_frac = kinds.count("predict") / len(kinds)
        assert 0.6 < predict_frac < 0.8

    def test_rate_never_negative_and_peak_bounds(self):
        spec = flash_spec(SEED_BASE)
        peak = spec.peak_rate()
        for i in range(0, 60):
            assert 0.0 <= spec.rate_at(float(i)) <= peak

    def test_zero_weight_mix_rejected(self):
        spec = TrafficSpec(
            duration_s=1.0, base_rps=1.0,
            mixes=(TrafficMix("m", "predict", 0.0),), seed=0,
        )
        with pytest.raises(ValueError):
            OpenLoopArrivals(spec)


_CERTS: dict = {}


def _cert_of(side):
    """THE acceptance scenario: seeded flash crowd at 1% base sampling.
    One run a package, reused by every case (the reference's class scope,
    kept per package)."""
    if side.name not in _CERTS:
        harness = side.loadgen.ReplayHarness(
            12, flash_spec(SEED_BASE), sample_rate=0.01,
            scrape_interval_s=5.0,
        )
        _CERTS[side.name] = harness, harness.run()
    return _CERTS[side.name]


class TestCertification:
    @pytest.fixture
    def cert(self, pkg):
        return _cert_of(pkg)

    def test_certificate_validates(self, cert):
        _, doc = cert
        assert validate_slo_cert(doc) == []

    def test_all_error_traces_in_merged_fleet_trace(self, cert):
        # 100% of error/deadline-exceeded requests survive 1% sampling:
        # forced recording beats the head-sampling lottery, always.
        _, doc = cert
        traces = doc["traces"]
        assert traces["error_requests"] > 0  # the crowd must actually hurt
        assert traces["error_traces_in_merged"] == traces["error_requests"]
        assert traces["all_errors_sampled"] is True

    def test_sampling_actually_sampled(self, cert):
        # At a 1% base rate with a real error load, SOME roots must have
        # been dropped and SOME forced — otherwise the knob is decorative.
        _, doc = cert
        s = doc["observability"]["sampling"]
        assert s["base_rate"] == pytest.approx(0.01)
        assert s["unsampled"] > 0
        assert s["forced_records"] > 0

    def test_burn_rates_match_slo_evaluator(self, cert):
        harness, doc = cert
        status = harness.slo.status()["models"]
        for model, body in doc["models"].items():
            assert body["fast_burn"] == pytest.approx(status[model]["fast_burn"])
            assert body["slow_burn"] == pytest.approx(status[model]["slow_burn"])

    def test_burn_rates_match_profiler_recomputation(self, cert):
        # Independent recomputation from first principles: burn =
        # frac_over(objective) / error_budget on the same profiler state.
        harness, doc = cert
        for model, obj in harness.objectives.items():
            frac = harness.profiler.frac_over(
                obj.latency_s, model=model, stage="dispatch",
                horizon_s=harness.slo.slow_window_s,
            )
            expected = frac / obj.error_budget
            assert doc["models"][model]["slow_burn"] == pytest.approx(expected)

    def test_leader_scrape_cost_within_tree_bound(self, cert):
        _, doc = cert
        obs = doc["observability"]
        assert obs["bound_ok"] is True
        assert obs["leader_rpcs_per_cycle_avg"] <= obs["sqrt_bound_rpcs_per_cycle"]
        assert obs["scrape_cycles"] > 0

    def test_outcome_counts_are_complete(self, cert):
        _, doc = cert
        for body in doc["models"].values():
            counted = (body["ok"] + body["shed"] + body["deadline"]
                       + body["evicted"] + body["error"])
            assert counted == body["requests"]

    def test_same_seed_reproduces_integer_fields(self, cert):
        _, doc = cert
        again = ReplayHarness(
            12, flash_spec(SEED_BASE), sample_rate=0.01,
            scrape_interval_s=5.0,
        ).run()
        for model in doc["models"]:
            for key in ("requests", "ok", "shed", "deadline", "evicted", "error"):
                assert doc["models"][model][key] == again["models"][model][key]
        assert doc["seed"] == again["seed"]

    def test_global_tracer_restored_after_run(self, cert, pkg):
        tracer = pkg.tracing.tracer

        assert tracer.enabled is False
        assert tracer.sample_rate == 1.0
        assert tracer.events_wire() == []


class TestCertSchema:
    def test_rejects_wrong_version(self):
        assert any("version" in p for p in validate_slo_cert({"version": 99}))

    def test_rejects_missing_sections(self):
        problems = validate_slo_cert({"version": 1, "seed": 0})
        assert any("observability" in p for p in problems)
        assert any("traces" in p for p in problems)
        assert any("models" in p for p in problems)

    def test_rejects_incoherent_outcome_counts(self):
        harness_doc = ReplayHarness(
            4, flash_spec(SEED_BASE, duration=10.0), sample_rate=1.0,
            scrape_interval_s=5.0,
        ).run()
        assert validate_slo_cert(harness_doc) == []
        model = next(iter(harness_doc["models"]))
        harness_doc["models"][model]["ok"] += 1
        assert any("outcome counts" in p for p in validate_slo_cert(harness_doc))


def test_same_seed_gives_equal_certificates_in_both_packages():
    """The flash-crowd certificate of one seed, from each package's
    ReplayHarness, is the same document (the harness runs on the virtual
    clock, so the certificate holds no wall time)."""
    docs = {side.name: _cert_of(side)[1] for side in (JAX, PORT)}
    assert docs["jax"] == docs["port"]
