"""Replayable load generation + SLO certification over the sim fabric.

Copied from ``dmlc_tpu/loadgen.py`` (the whole module): with the same seed
it replays the same workload and gives the same report as the JAX
package's, apart from wall times; ``SessionChurnHarness`` drives this
package's ``GenerateWorker`` and ``GenRouter``.

The observability plane (scrape trees, adaptive trace sampling, SLO burn
rates) is only trustworthy if it can be DEMONSTRATED against known traffic
— so this module replays a fully seeded workload through a simulated fleet
on the virtual clock and emits a certification document
(``slo_cert.json``, docs/OPERATIONS.md) any run with the same seed
reproduces byte-for-byte in its integer fields:

- **Open-loop arrivals** — an inhomogeneous Poisson process (Lewis-Shedler
  thinning against the peak rate), so load does NOT back off when the
  fleet slows down; that is what makes deadline misses and sheds honest.
- **Traffic shape** — a base rate modulated by a diurnal sinusoid and
  scripted flash crowds (start/duration/multiplier), mixing predict and
  generate requests across models by weight.
- **Simulated members** — each member admits through a token bucket on the
  virtual clock (overflow -> ``Overloaded`` shed), serves with a seeded
  jittered service time (a deterministic slow minority models stragglers,
  and queue pressure inflates them further), raising ``DeadlineExceeded``
  when the simulated service cannot fit the caller's remaining budget and
  occasionally evicting generate requests under pressure.
- **The real observability plane** — the leader scrapes through the real
  ``ScrapeTreeCoordinator``/``ScrapeDelegate`` tree, folds profiles with
  the real ``CostProfiler``/``SloEvaluator``, and the real tracer head-
  samples requests — errors force-recorded — so the certificate measures
  the plane this repo ships, not a mock of it.

The certificate pins: per-model p50/p99 vs objective, SLO burn rates
(read from the same ``SloEvaluator`` state the leader alerts on), shed /
deadline / eviction counts, leader scrape-RPC cost vs the 4*sqrt(N)
tree bound, sampling effectiveness, and that 100% of error and
deadline-exceeded request traces survived into the merged fleet trace.
``validate_slo_cert`` is the schema gate CI runs (tools/slo_cert.py).
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

from dmlc_tpu_torch.cluster import observe, tenant as tenant_mod, tracectx
from dmlc_tpu_torch.cluster.critpath import CritPathAnalyzer, FleetCritPath
from dmlc_tpu_torch.cluster.flight import FlightRecorder
from dmlc_tpu_torch.cluster.profile import CostProfiler
from dmlc_tpu_torch.cluster.sentinel import DriftSentinel
from dmlc_tpu_torch.cluster.rpc import (
    DeadlineExceeded,
    Overloaded,
    RpcError,
    RpcUnreachable,
    SimRpcNetwork,
)
from dmlc_tpu_torch.cluster.scrapetree import ScrapeDelegate, ScrapeTreeCoordinator
from dmlc_tpu_torch.scheduler.autoscaler import Autoscaler, ScaleTarget
from dmlc_tpu_torch.scheduler.placement import SloEvaluator, SloObjective, tenant_lane
from dmlc_tpu_torch.utils import tracing
from dmlc_tpu_torch.utils.metrics import Registry
from dmlc_tpu_torch.utils.tracing import traced_methods

SLO_CERT_VERSION = 1

# Per-request deadline budget by traffic kind (seconds of virtual time).
KIND_DEADLINE_S = {"predict": 0.5, "generate": 2.0}

# Mean simulated service time by kind; jittered per request, inflated on
# the deterministic slow minority and again under admission pressure.
KIND_SERVICE_S = {"predict": 0.08, "generate": 0.45}


# ---------------------------------------------------------------------------
# Traffic shape
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrafficMix:
    """One slice of the offered traffic: a model served by one kind of
    request, drawn with probability proportional to ``weight``, on behalf
    of ``tenant`` (cluster/tenant.py; the default tenant is the legacy
    single-tenant traffic, byte-identical on the wire)."""

    model: str
    kind: str  # "predict" | "generate"
    weight: float = 1.0
    tenant: str = tenant_mod.DEFAULT_TENANT


@dataclass(frozen=True)
class FlashCrowd:
    """A scripted step burst: rate multiplies by ``multiplier`` for
    ``duration_s`` starting at ``start_s`` (overlapping crowds stack).
    A crowd scoped to ``tenant`` multiplies ONLY that tenant's mixes —
    the tenant-isolation certification drives exactly this: tenant A
    surges 10x while tenant B's offered load never moves."""

    start_s: float
    duration_s: float
    multiplier: float
    tenant: str | None = None

    def factor_at(self, t: float, tenant: str | None = None) -> float:
        if self.tenant is not None and tenant is not None \
                and tenant != self.tenant:
            return 1.0
        return self.multiplier if self.start_s <= t < self.start_s + self.duration_s else 1.0


@dataclass(frozen=True)
class TrafficSpec:
    """A fully seeded workload description — same spec, same arrivals."""

    duration_s: float
    base_rps: float
    mixes: tuple[TrafficMix, ...]
    diurnal_amplitude: float = 0.0   # 0..1: rate swings +-amplitude
    diurnal_period_s: float = 86400.0
    flash_crowds: tuple[FlashCrowd, ...] = ()
    seed: int = 0

    def _diurnal_at(self, t: float) -> float:
        if self.diurnal_amplitude <= 0.0:
            return 1.0
        return 1.0 + self.diurnal_amplitude * math.sin(
            2.0 * math.pi * t / self.diurnal_period_s
        )

    def mix_rates_at(self, t: float) -> list[float]:
        """Per-mix instantaneous offered rate: the base split by weight,
        then modulated by the diurnal and by every crowd that applies to
        the mix's tenant (unscoped crowds apply to everyone)."""
        total_w = sum(max(0.0, m.weight) for m in self.mixes) or 1.0
        diurnal = self._diurnal_at(t)
        out = []
        for m in self.mixes:
            rate = self.base_rps * max(0.0, m.weight) / total_w * diurnal
            for crowd in self.flash_crowds:
                rate *= crowd.factor_at(t, m.tenant)
            out.append(max(0.0, rate))
        return out

    def rate_at(self, t: float) -> float:
        """Instantaneous offered rate (requests/s of virtual time)."""
        return sum(self.mix_rates_at(t))

    def peak_rate(self) -> float:
        """An upper bound on ``rate_at`` — the thinning envelope. Assumes
        the worst case of every crowd overlapping; a loose bound only
        costs rejected candidates, never correctness."""
        peak = self.base_rps * (1.0 + max(0.0, self.diurnal_amplitude))
        for crowd in self.flash_crowds:
            peak *= max(1.0, crowd.multiplier)
        return max(peak, 1e-9)

    def tenants(self) -> list[str]:
        """Every tenant the mixes name, default included, sorted."""
        return sorted({m.tenant for m in self.mixes})

    def to_wire(self) -> dict:
        return {
            "duration_s": self.duration_s,
            "base_rps": self.base_rps,
            "seed": self.seed,
            "diurnal_amplitude": self.diurnal_amplitude,
            "diurnal_period_s": self.diurnal_period_s,
            "mixes": [
                {"model": m.model, "kind": m.kind, "weight": m.weight,
                 # Default tenant omitted: a tenant-less spec's wire form
                 # (and thus its certificate) stays byte-identical.
                 **({"tenant": m.tenant}
                    if m.tenant != tenant_mod.DEFAULT_TENANT else {})}
                for m in self.mixes
            ],
            "flash_crowds": [
                {"start_s": c.start_s, "duration_s": c.duration_s,
                 "multiplier": c.multiplier,
                 **({"tenant": c.tenant} if c.tenant is not None else {})}
                for c in self.flash_crowds
            ],
        }


class OpenLoopArrivals:
    """Inhomogeneous Poisson arrivals by Lewis-Shedler thinning: candidate
    gaps are exponential at the peak rate; each candidate survives with
    probability ``rate_at(t) / peak``. Open-loop by construction — the
    schedule never waits for the system under test."""

    def __init__(self, spec: TrafficSpec):
        self.spec = spec
        self._rng = random.Random(spec.seed ^ 0xA11)
        if sum(max(0.0, m.weight) for m in spec.mixes) <= 0:
            raise ValueError("TrafficSpec.mixes must carry positive weight")

    def _pick_mix(self, t: float) -> TrafficMix:
        """Draw a mix proportional to its INSTANTANEOUS rate: during a
        tenant-scoped flash crowd the surging tenant's mixes own most of
        the arrivals, exactly as a real crowd would. With no tenant-scoped
        crowds every mix scales identically and this reduces to the static
        weight draw (same RNG call count — legacy seeds replay bit-for-bit)."""
        rates = self.spec.mix_rates_at(t)
        total = sum(rates)
        x = self._rng.random() * total
        for mix, r in zip(self.spec.mixes, rates):
            x -= r
            if x <= 0:
                return mix
        return self.spec.mixes[-1]

    def __iter__(self) -> Iterator[tuple[float, TrafficMix]]:
        lam = self.spec.peak_rate()
        t = 0.0
        while True:
            t += self._rng.expovariate(lam)
            if t >= self.spec.duration_s:
                return
            if self._rng.random() * lam <= self.spec.rate_at(t):
                yield t, self._pick_mix(t)


# ---------------------------------------------------------------------------
# Simulated members
# ---------------------------------------------------------------------------


class SimMember:
    """One simulated serving member: token-bucket admission on the virtual
    clock, seeded jittered service times, deterministic stragglers, and
    kv-pressure evictions for generate traffic. Serves the REAL
    observability surface (ObsService + ScrapeDelegate) next to the fake
    workload verbs, so scrapes and traces exercise production code."""

    SLOW_EVERY = 7        # every 7th member is a straggler
    SLOW_FACTOR = 4.0     # straggler service-time multiplier
    PRESSURE_GAIN = 3.0   # service inflation at full admission pressure
    EVICT_PRESSURE = 0.5   # generate evictions start above this utilization
    EVICT_P = 0.25         # ... with this probability
    # Per-stage decomposition of one simulated service: the critpath plane
    # attributes request time to (stage, member), so the sim reports where
    # its pretend time went. Fractions sum to 1.
    STAGE_FRACTIONS = (("decode", 0.35), ("compute", 0.65))

    def __init__(self, net: SimRpcNetwork, addr: str, index: int, *,
                 seed: int, capacity_qps: float, scrape_timeout_s: float,
                 tenants: dict[str, tenant_mod.TenantSpec] | None = None):
        self.net = net
        self.addr = addr
        self.slow = (index % self.SLOW_EVERY) == self.SLOW_EVERY - 1
        self.rng = random.Random((seed << 16) ^ (index * 0x9E37) ^ 0x51AB)
        self.registry = Registry()
        self.capacity_qps = max(1e-6, capacity_qps)
        self.burst = max(2.0, self.capacity_qps)
        self._tokens = self.burst
        self._last_refill = net.clock()
        # Per-tenant token buckets (the sim analogue of AdmissionGate's
        # TenantLedger): a declared tenant refills at share * capacity, so
        # its flash crowd drains ITS bucket and sheds typed over_quota
        # while the member-wide bucket — and every other tenant — keeps
        # serving. Empty = no enforcement, bit-identical legacy behavior.
        self.tenants = dict(tenants or {})
        self._tenant_buckets: dict[str, list[float]] = {}
        for name, spec in self.tenants.items():
            rate = max(1e-6, spec.share * self.capacity_qps)
            burst = max(2.0, rate)
            self._tenant_buckets[name] = [burst, net.clock(), rate, burst]
        # Evictions charged to a tenant whose OWN pressure was below the
        # eviction line (i.e. somebody else's surge would have been the
        # trigger). The quota ordering makes this structurally zero; the
        # counter exists so the certificate PROVES it rather than assumes.
        self.cross_tenant_evictions = 0
        # Injected per-stage slowdown ({stage: factor}) — the drift
        # scenario's fault: ONE member's decode turning 5x mid-replay.
        self.stage_slowdown: dict[str, float] = {}
        self.obs = observe.ObsService(self.registry, lane=addr)
        self.delegate = ScrapeDelegate(
            net.client(addr), timeout_s=scrape_timeout_s, concurrency=1,
            metrics=self.registry.counters,
        )
        net.serve(addr, self.methods())

    def set_stage_slowdown(self, stage: str, factor: float) -> None:
        """Inject (or clear, factor=1) a service-stage slowdown — the
        drift sentinel certification's mid-replay fault."""
        if factor == 1.0:
            self.stage_slowdown.pop(stage, None)
        else:
            self.stage_slowdown[stage] = float(factor)

    def set_capacity(self, capacity_qps: float) -> None:
        """Autoscaler actuation in the sim: a capacity change models
        replicas joining/leaving this member's serving pool. Buckets keep
        their current fill; only refill rates and ceilings move."""
        self.capacity_qps = max(1e-6, capacity_qps)
        self.burst = max(2.0, self.capacity_qps)
        self._tokens = min(self._tokens, self.burst)
        for name, spec in self.tenants.items():
            bucket = self._tenant_buckets[name]
            bucket[2] = max(1e-6, spec.share * self.capacity_qps)
            bucket[3] = max(2.0, bucket[2])
            bucket[0] = min(bucket[0], bucket[3])

    def methods(self) -> dict:
        table = traced_methods({
            "job.predict": self._serve_request,
            "job.generate": self._serve_request,
        })
        table.update(self.obs.methods())
        table.update(self.delegate.methods())
        return table

    def _admit(self, tenant: str) -> tuple[float, float]:
        """Take one token or shed; returns (member utilization, the
        pressure the requester's SERVICE should see) — with tenants
        enforced, that pressure is the requester's OWN bucket: over-share
        work queues behind its own quota (the sim analogue of the
        DynamicBatcher/SlotScheduler displacement ordering), so one
        tenant's surge inflates its own latency and eviction odds, never
        another tenant's within-quota work."""
        now = self.net.clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._last_refill) * self.capacity_qps
        )
        self._last_refill = now
        utilization = 1.0 - self._tokens / self.burst
        evict_pressure = utilization
        bucket = self._tenant_buckets.get(tenant) if self.tenants else None
        if self.tenants:
            if bucket is None:
                # Unknown tenant: charged against the residual low-priority
                # share, exactly like TenantLedger's UNKNOWN_SHARE stance.
                spec = tenant_mod.spec_for(tenant, self.tenants)
                rate = max(1e-6, spec.share * self.capacity_qps)
                burst = max(2.0, rate)
                bucket = self._tenant_buckets[tenant] = [burst, now, rate, burst]
            bucket[0] = min(bucket[3], bucket[0] + (now - bucket[1]) * bucket[2])
            bucket[1] = now
            evict_pressure = 1.0 - bucket[0] / bucket[3]
            if bucket[0] < 1.0:
                self.registry.counters.inc("shed")
                self.registry.counters.inc("shed_over_quota")
                raise Overloaded(
                    f"{self.addr}: tenant {tenant!r} at quota",
                    retry_after_s=0.1, tenant=tenant, quota="over_quota",
                )
        if self._tokens < 1.0:
            self.registry.counters.inc("shed")
            raise Overloaded(
                f"{self.addr}: admission queue full", retry_after_s=0.1,
                tenant=tenant, quota="gate_full",
            )
        self._tokens -= 1.0
        if bucket is not None:
            bucket[0] -= 1.0
        return utilization, evict_pressure

    def _serve_request(self, p: dict) -> dict:
        kind = str(p.get("kind") or "predict")
        # The ambient tenant, carried by the RPC frame's `n` field and
        # re-bound server-side (cluster/rpc.serve_with_deadline) — the
        # same wire threading production members see.
        tenant = tenant_mod.current()
        self.registry.counters.inc("requests")
        utilization, pressure = self._admit(tenant)
        service = KIND_SERVICE_S.get(kind, 0.1) * (0.5 + self.rng.random())
        if self.slow:
            service *= self.SLOW_FACTOR
        # With no tenant table, ``pressure`` IS the member utilization —
        # legacy runs are bit-identical. With tenants enforced it is the
        # requester's own-quota pressure, so a surging tenant's latency
        # degrades (and burns ITS SLO lane) while within-quota tenants
        # keep their service times.
        service *= 1.0 + self.PRESSURE_GAIN * pressure
        # Per-stage breakdown + injected slowdowns. The no-fault path adds
        # exactly 0.0, keeping legacy seeded latencies bit-identical; a
        # slowed stage stretches the total by its share * (factor - 1).
        stages = {
            stage: service * frac * self.stage_slowdown.get(stage, 1.0)
            for stage, frac in self.STAGE_FRACTIONS
        }
        service += sum(
            service * frac * (self.stage_slowdown.get(stage, 1.0) - 1.0)
            for stage, frac in self.STAGE_FRACTIONS
        )
        if (
            kind == "generate"
            and pressure > self.EVICT_PRESSURE
            and self.rng.random() < self.EVICT_P
        ):
            # Recorded assertion: with tenants enforced the eviction
            # trigger IS the requester's own-bucket pressure, so a
            # within-quota tenant can never stand here — mirroring
            # SlotScheduler's victim ordering. If a future edit decouples
            # trigger from victim, this counter (summed into the
            # certificate's cross_tenant_evictions, pinned at zero) is
            # what catches it.
            if self.tenants and pressure <= self.EVICT_PRESSURE:
                self.cross_tenant_evictions += 1
            self.registry.counters.inc("evicted")
            raise RpcError(f"evicted: {self.addr} kv-cache pressure")
        budget = float(p.get("deadline_s") or KIND_DEADLINE_S.get(kind, 1.0))
        if service >= budget:
            # The caller would wait out its whole budget; the sim raises
            # the same verdict the deadline fabric would without dragging
            # the shared virtual clock forward per straggler.
            self.registry.counters.inc("deadline_exceeded")
            raise DeadlineExceeded(
                f"{self.addr}/{kind}: simulated service {service:.3f}s "
                f"exceeds {budget:.3f}s budget"
            )
        self.registry.latency(f"rpc/job.{kind}").record(service)
        return {"service_s": service, "stages": stages}


# ---------------------------------------------------------------------------
# Request bookkeeping
# ---------------------------------------------------------------------------


@dataclass
class ModelTally:
    kind: str = "predict"
    requests: int = 0
    ok: int = 0
    shed: int = 0
    shed_over_quota: int = 0  # subset of shed: typed tenant-quota refusals
    deadline: int = 0
    evicted: int = 0
    error: int = 0
    latencies: list[float] = field(default_factory=list)

    def percentile(self, p: float) -> float | None:
        if not self.latencies:
            return None
        ordered = sorted(self.latencies)
        rank = max(0, math.ceil(p / 100.0 * len(ordered)) - 1)
        return ordered[rank]


class ReplayHarness:
    """One seeded certification run: N simulated members + a leader
    running the real scrape tree / profiler / SLO evaluator / tracer,
    driven by an ``OpenLoopArrivals`` schedule on the virtual clock.
    ``run()`` returns the ``slo_cert.json`` document."""

    def __init__(
        self,
        n_members: int,
        spec: TrafficSpec,
        *,
        objectives: dict[str, SloObjective] | None = None,
        sample_rate: float = 1.0,
        spans_per_s_budget: float = 0.0,
        scrape_interval_s: float = 10.0,
        scrape_timeout_s: float = 1.0,
        burn_force_sample_s: float = 15.0,
        fast_burn: float = 6.0,
        slow_burn: float = 1.5,
        fast_window_s: float | None = None,
        capacity_headroom: float = 2.0,
        tenants: dict[str, tenant_mod.TenantSpec] | None = None,
        autoscale: bool = False,
        autoscale_max_units: int = 8,
        autoscale_clear_windows: int = 3,
        autoscale_moves_budget: int = 2,
        drift: dict[str, Any] | None = None,
        sentinel_min_samples: int = 20,
        sentinel_confirm_windows: int = 3,
        sentinel_drift_factor: float = 2.0,
    ):
        if n_members < 2:
            raise ValueError("certification needs at least 2 members")
        self.spec = spec
        self.sample_rate = float(sample_rate)
        self.spans_per_s_budget = float(spans_per_s_budget)
        self.scrape_interval_s = float(scrape_interval_s)
        self.burn_force_sample_s = float(burn_force_sample_s)
        # Declared tenant table (cluster/tenant.py specs). When the spec's
        # mixes name tenants that aren't declared, they still flow — as
        # unknown low-priority tenants, like the production gates.
        self.tenant_specs = dict(tenants or {})

        self.net = SimRpcNetwork()
        self.leader_addr = "leader:0"
        self.member_addrs = [f"m{i:03d}:1" for i in range(n_members)]
        self.per_member_qps = capacity_headroom * spec.base_rps / n_members
        self.members = [
            SimMember(self.net, addr, i, seed=spec.seed,
                      capacity_qps=self.per_member_qps,
                      scrape_timeout_s=scrape_timeout_s,
                      tenants=self.tenant_specs)
            for i, addr in enumerate(self.member_addrs)
        ]
        self.leader_registry = Registry()
        self.leader_obs = observe.ObsService(
            self.leader_registry, lane=self.leader_addr
        )
        self.net.serve(self.leader_addr, self.leader_obs.methods())
        self.client = self.net.client(self.leader_addr)
        self.coordinator = ScrapeTreeCoordinator(
            self.client, clock=self.net.clock, timeout_s=scrape_timeout_s,
            concurrency=1, metrics=self.leader_registry.counters,
        )
        self.profiler = CostProfiler(
            window_s=5.0, windows=64, clock=self.net.clock, seed=spec.seed
        )
        # Root-cause plane under certification (OBSERVABILITY §9): every
        # served request's synthesized span DAG is charged into the REAL
        # critpath analyzer on the virtual clock; the fleet fold feeds burn
        # attribution and the REAL drift sentinel, exactly as on a leader.
        self.replan_requests: list[str] = []
        self.flight = FlightRecorder(clock=self.net.clock, node="loadgen")
        self.critpath = CritPathAnalyzer(
            window_s=float(scrape_interval_s), windows=16,
            clock=self.net.clock, seed=spec.seed,
        )
        self.fleet_critpath = FleetCritPath()
        self.sentinel = DriftSentinel(
            drift_factor=float(sentinel_drift_factor),
            min_samples=int(sentinel_min_samples),
            confirm_windows=int(sentinel_confirm_windows),
            force_sample_s=float(burn_force_sample_s) or 15.0,
            flight_note=self.flight.note,
            force_sample=self._drift_force_sample,
            request_replan=self.replan_requests.append,
        )
        # The injected fault: {"member": index, "stage": name, "factor": x,
        # "at_fraction": when} — ONE member's stage slows mid-replay, and
        # the certificate must show the sentinel naming it.
        self.drift = dict(drift) if drift else None
        self._drift_applied = False
        self._drift_injected_cycle: int | None = None
        self._drift_alert_cycle: int | None = None
        self.drift_alerts: list[dict[str, Any]] = []
        self.drift_force_windows = 0
        self._trace_seq = 0
        if objectives is None:
            objectives = self.default_objectives(spec)
        self.objectives = objectives
        # The fast window bounds detection latency: the evaluator needs
        # roughly fast_burn * error_budget * window of over-objective
        # samples before it alerts, so a tight-convergence scenario (the
        # autoscaler certification) passes a short window here.
        if fast_window_s is None:
            fast_window_s = min(30.0, spec.duration_s)
        self.slo = SloEvaluator(
            self.profiler, objectives,
            fast_window_s=min(float(fast_window_s), spec.duration_s),
            slow_window_s=spec.duration_s,
            fast_burn=fast_burn, slow_burn=slow_burn, stage="dispatch",
            metrics=self.leader_registry.counters,
            # Per-tenant burn lanes: every non-default tenant the traffic
            # names gets its own model@tenant lane, scored against the
            # model objective on that tenant's traffic only.
            tenants=[t for t in spec.tenants()
                     if t != tenant_mod.DEFAULT_TENANT],
            flight=self.flight,
            # Burn alerts name their critical-path culprit — the field the
            # certificate's critpath gate requires on every burn event.
            attribution=self.fleet_critpath.culprit,
        )
        self._dispatch_rng = random.Random(spec.seed ^ 0xD15)
        self.tallies: dict[str, ModelTally] = {}
        # tenant -> model -> tally (the certificate's per-tenant section).
        self.tenant_tallies: dict[str, dict[str, ModelTally]] = {}
        self.error_traces: set[str] = set()
        self.scrape_cycles = 0
        self.leader_scrape_rpcs = 0
        self.stale_spans_total = 0
        self.redelegations_total = 0
        self.force_windows = 0
        # The elastic loop under certification (scheduler/autoscaler.py):
        # the REAL Autoscaler on the virtual clock, actuating simulated
        # capacity units (each unit = the baseline per-member qps, i.e. a
        # replica's worth of serving). The certificate pins convergence:
        # scale-up within the fast-burn windows, scale-down after quiet.
        self.autoscaler: Autoscaler | None = None
        self._capacity_units = 1
        self._first_burn_cycle: int | None = None
        self._first_up_cycle: int | None = None
        self._first_down_cycle: int | None = None
        self._breach_after_down = False
        if autoscale:
            self.autoscaler = Autoscaler(
                flight=self.flight,
                metrics=self.leader_registry.counters,
                clock=self.net.clock,
                clear_windows=autoscale_clear_windows,
                moves_budget=autoscale_moves_budget,
            )
            self.autoscaler.register(ScaleTarget(
                "sim_capacity",
                get=lambda: self._capacity_units,
                apply=self._apply_capacity_units,
                lo=1,
                hi=max(1, int(autoscale_max_units)),
            ))

    def _apply_capacity_units(self, units: int) -> int:
        self._capacity_units = max(1, int(units))
        for member in self.members:
            member.set_capacity(self.per_member_qps * self._capacity_units)
        return self._capacity_units

    def _drift_force_sample(self, seconds: float) -> None:
        """Sentinel actuation: a confirmed drift opens a forced-sampling
        window fleet-wide — the same hook a burning SLO uses — so the
        traces that explain the shift are captured while it is happening."""
        tracing.tracer.force_sampling(seconds)
        observe.force_fleet_sampling(
            self.client, self.member_addrs, seconds, timeout=1.0,
        )
        self.drift_force_windows += 1

    @staticmethod
    def default_objectives(spec: TrafficSpec) -> dict[str, SloObjective]:
        """One objective per model in the mix: a latency bound between the
        nominal and straggler service time for its kind, so a healthy
        fleet passes and a straggler-heavy one visibly burns budget."""
        out: dict[str, SloObjective] = {}
        for mix in spec.mixes:
            bound = KIND_SERVICE_S.get(mix.kind, 0.1) * 2.5
            out.setdefault(
                mix.model,
                SloObjective(model=mix.model, latency_s=bound, availability=0.95),
            )
        return out

    # ---- the drive loop ------------------------------------------------

    def run(self) -> dict:
        tracer = tracing.tracer
        prev_enabled = tracer.enabled
        tracer.reset()
        tracer.enabled = True
        tracer.set_sampling(
            rate=self.sample_rate, spans_per_s=self.spans_per_s_budget,
            clock=self.net.clock,
        )
        try:
            next_scrape = self.scrape_interval_s
            for t, mix in OpenLoopArrivals(self.spec):
                while next_scrape <= t:
                    if next_scrape > self.net.now:
                        self.net.advance(next_scrape - self.net.now)
                    self._scrape_cycle()
                    next_scrape += self.scrape_interval_s
                if t > self.net.now:
                    self.net.advance(t - self.net.now)
                self._dispatch(mix)
            while next_scrape <= self.spec.duration_s:
                if next_scrape > self.net.now:
                    self.net.advance(next_scrape - self.net.now)
                self._scrape_cycle()
                next_scrape += self.scrape_interval_s
            merged_trace = observe.collect_fleet_trace(
                self.client,
                [self.leader_addr, *self.member_addrs],
                timeout=5.0, clock_samples=1,
            )
            sampling = tracer.sampling_summary()
            return self._certificate(merged_trace, sampling)
        finally:
            # Restore the process-global tracer exactly as found: default
            # rate, controller off, REAL clock back in (the sim clock must
            # not leak into later users of the tracer).
            tracer.enabled = prev_enabled
            tracer.set_sampling(rate=1.0, spans_per_s=0.0, clock=time.monotonic)
            tracer.reset()

    def _scrape_cycle(self) -> None:
        result = self.coordinator.scrape(self.member_addrs)
        self.scrape_cycles += 1
        self.leader_scrape_rpcs += result.leader_rpcs
        self.stale_spans_total += len(result.stale_spans)
        self.redelegations_total += result.redelegations
        for addr, reply in result.members.items():
            self.profiler.ingest_scrape(addr, reply)
        # Root-cause fold BEFORE the SLO evaluation: the analyzer snapshot
        # lands in the fleet fold, the sentinel judges the folded table,
        # and only then does the evaluator run — so a burn alert fired
        # this cycle carries the freshest culprit attribution.
        self.fleet_critpath.fold("sim", self.critpath.snapshot())
        fired = self.sentinel.tick(self.fleet_critpath.table())
        if fired:
            self.drift_alerts.extend(fired)
            if self._drift_alert_cycle is None:
                self._drift_alert_cycle = self.scrape_cycles
        state = self.slo.evaluate()
        burning = self.slo.burning_models()
        if self.autoscaler is not None:
            if burning and self._first_burn_cycle is None:
                self._first_burn_cycle = self.scrape_cycles
            decisions = self.autoscaler.tick(
                burning, {lane: st.get("fast", 0.0)
                          for lane, st in state.items()},
            )
            for decision in decisions:
                if decision["direction"] == "up" \
                        and self._first_up_cycle is None:
                    self._first_up_cycle = self.scrape_cycles
                if decision["direction"] == "down" \
                        and self._first_down_cycle is None:
                    self._first_down_cycle = self.scrape_cycles
            if burning and self._first_down_cycle is not None \
                    and self.scrape_cycles > self._first_down_cycle:
                # A burn AFTER the scale-down would mean the shrink broke
                # the SLO it just restored — the flap the hysteresis and
                # clear-window discipline exist to prevent.
                self._breach_after_down = True
        if burning and self.burn_force_sample_s > 0:
            # The same hook the real leader runs (cluster/node.py): a model
            # burning budget flips the whole fleet to forced sampling.
            tracing.tracer.force_sampling(self.burn_force_sample_s)
            observe.force_fleet_sampling(
                self.client, self.member_addrs, self.burn_force_sample_s,
                timeout=1.0,
            )
            self.force_windows += 1

    def _tally_pair(self, mix: TrafficMix) -> tuple[ModelTally, ModelTally]:
        """(per-model aggregate, per-(tenant, model)) tallies for one
        request; both counted on every outcome so the certificate's tenant
        outcome counts sum exactly like the model ones."""
        tally = self.tallies.setdefault(mix.model, ModelTally(kind=mix.kind))
        per_tenant = self.tenant_tallies.setdefault(mix.tenant, {})
        tenant_tally = per_tenant.setdefault(mix.model, ModelTally(kind=mix.kind))
        return tally, tenant_tally

    def _record_latency(self, mix: TrafficMix, member: str,
                        latency: float) -> None:
        """One observed latency into the SLO lanes: the bare model lane
        (the aggregate every legacy consumer reads) AND, for a non-default
        tenant, the model@tenant composite the per-tenant burn is scored
        on."""
        self.profiler.record(mix.model, member, "dispatch", latency)
        lane = tenant_lane(mix.model, mix.tenant)
        if lane != mix.model:
            self.profiler.record(lane, member, "dispatch", latency)

    def _inject_drift_if_due(self) -> None:
        """Apply the configured mid-replay stage fault once its time
        arrives: ONE member's stage slows by the configured factor, and
        from here on the certificate's detection timeline is live."""
        if self.drift is None or self._drift_applied:
            return
        if self.net.now < float(self.drift.get("at_fraction", 0.5)) \
                * self.spec.duration_s:
            return
        idx = int(self.drift.get("member", 0)) % len(self.members)
        stage = str(self.drift.get("stage", "decode"))
        factor = float(self.drift.get("factor", 5.0))
        self.members[idx].set_stage_slowdown(stage, factor)
        self._drift_applied = True
        self._drift_injected_cycle = self.scrape_cycles
        self.flight.note(
            "drift_injected", member=self.member_addrs[idx],
            stage=stage, factor=factor,
        )

    def _emit_trace(self, mix: TrafficMix, member: str, latency: float,
                    stages: dict[str, Any]) -> None:
        """Synthesize the served request's span DAG — the same tree the
        real dispatch path traces (root -> dispatch -> rpc -> host/decode
        then device/forward) — and charge it into the critpath analyzer,
        so burn attribution and the drift sentinel run on the real
        extraction math, not on the sim's own stage numbers."""
        self._trace_seq += 1
        trace = f"sim{self._trace_seq}"
        sid = f"{trace}-"
        t0 = self.net.now
        decode_s = max(0.0, float(stages.get("decode", 0.0)))
        compute_s = max(0.0, float(stages.get("compute", 0.0)))
        self.critpath.ingest([
            {"name": "loadgen/request", "trace": trace, "span": sid + "root",
             "start": t0, "dur": latency, "attrs": {"model": mix.model}},
            {"name": "scheduler/dispatch", "trace": trace, "span": sid + "d",
             "parent": sid + "root", "start": t0, "dur": latency,
             "lane": self.leader_addr},
            {"name": f"rpc/job.{mix.kind}", "trace": trace, "span": sid + "r",
             "parent": sid + "d", "start": t0, "dur": latency,
             "lane": member},
            {"name": "host/decode", "trace": trace, "span": sid + "dec",
             "parent": sid + "r", "start": t0, "dur": decode_s,
             "lane": member},
            {"name": "device/forward", "trace": trace, "span": sid + "f",
             "parent": sid + "r", "start": t0 + decode_s, "dur": compute_s,
             "lane": member},
        ])

    def _dispatch(self, mix: TrafficMix) -> None:
        self._inject_drift_if_due()
        member = self.member_addrs[
            self._dispatch_rng.randrange(len(self.member_addrs))
        ]
        budget = KIND_DEADLINE_S.get(mix.kind, 1.0)
        tally, tenant_tally = self._tally_pair(mix)
        tally.requests += 1
        tenant_tally.requests += 1
        trace_id = ""
        try:
            with tenant_mod.bind(mix.tenant), tracing.tracer.span(
                "loadgen/request", model=mix.model, kind=mix.kind
            ):
                ctx = tracectx.current()
                trace_id = ctx.trace_id if ctx is not None else ""
                reply = self.client.call(
                    member, f"job.{mix.kind}",
                    {"model": mix.model, "kind": mix.kind, "deadline_s": budget},
                    timeout=budget,
                )
        except Overloaded as e:
            tally.shed += 1
            tenant_tally.shed += 1
            if getattr(e, "quota", None) == "over_quota":
                tally.shed_over_quota += 1
                tenant_tally.shed_over_quota += 1
            self.error_traces.add(trace_id)
            return
        except DeadlineExceeded:
            tally.deadline += 1
            tenant_tally.deadline += 1
            tally.latencies.append(budget)
            tenant_tally.latencies.append(budget)
            self.error_traces.add(trace_id)
            # The caller waited its whole budget: that latency is real and
            # lands in the SLO lane as an over-objective observation.
            self._record_latency(mix, member, budget)
            return
        except (RpcUnreachable, RpcError) as e:
            if "evicted:" in str(e):
                tally.evicted += 1
                tenant_tally.evicted += 1
            else:
                tally.error += 1
                tenant_tally.error += 1
            self.error_traces.add(trace_id)
            return
        tally.ok += 1
        tenant_tally.ok += 1
        latency = float(reply["service_s"])
        tally.latencies.append(latency)
        tenant_tally.latencies.append(latency)
        self._record_latency(mix, member, latency)
        stages = reply.get("stages")
        if isinstance(stages, dict):
            self._emit_trace(mix, member, latency, stages)

    # ---- certificate ---------------------------------------------------

    @staticmethod
    def _jsonsafe(value):
        """NaN/inf -> None recursively: the certificate must be strict
        JSON (the profiler's percentile is NaN on an empty lane)."""
        if isinstance(value, float) and not math.isfinite(value):
            return None
        if isinstance(value, dict):
            return {k: ReplayHarness._jsonsafe(v) for k, v in value.items()}
        if isinstance(value, list):
            return [ReplayHarness._jsonsafe(v) for v in value]
        return value

    def _certificate(self, merged_trace: dict, sampling: dict) -> dict:
        slo_status = self.slo.status()
        merged_trace_ids = {
            ev["args"]["trace"]
            for ev in merged_trace.get("traceEvents", ())
            if ev.get("ph") == "X" and "trace" in (ev.get("args") or {})
        }
        error_traces = {t for t in self.error_traces if t}
        present = error_traces & merged_trace_ids
        n = len(self.member_addrs)
        cycles = max(1, self.scrape_cycles)
        obs_calls = sum(
            1 for _, method in self.net.calls if method.startswith("obs.")
        )
        models: dict[str, dict] = {}
        for model in sorted(self.tallies):
            tally = self.tallies[model]
            slo_model = (slo_status.get("models") or {}).get(model, {})
            models[model] = {
                "kind": tally.kind,
                "requests": tally.requests,
                "ok": tally.ok,
                "shed": tally.shed,
                "shed_over_quota": tally.shed_over_quota,
                "deadline": tally.deadline,
                "evicted": tally.evicted,
                "error": tally.error,
                "p50_s": tally.percentile(50),
                "p99_s": tally.percentile(99),
                "objective_latency_s": slo_model.get("objective_latency_s"),
                "availability": slo_model.get("availability"),
                "fast_burn": slo_model.get("fast_burn", 0.0),
                "slow_burn": slo_model.get("slow_burn", 0.0),
                "fast_alert": slo_model.get("fast_alert", False),
                "slow_alert": slo_model.get("slow_alert", False),
            }
        extra: dict[str, dict] = {}
        tenants_doc = self._tenants_section()
        if tenants_doc is not None:
            extra["tenants"] = tenants_doc
        autoscaler_doc = self._autoscaler_section()
        if autoscaler_doc is not None:
            extra["autoscaler"] = autoscaler_doc
        extra["critpath"] = self._critpath_section()
        return self._jsonsafe({
            "version": SLO_CERT_VERSION,
            "seed": self.spec.seed,
            "spec": {
                **self.spec.to_wire(),
                "members": n,
                "sample_rate": self.sample_rate,
                "spans_per_s_budget": self.spans_per_s_budget,
                "scrape_interval_s": self.scrape_interval_s,
            },
            "models": models,
            "slo": slo_status,
            "observability": {
                "scrape_cycles": self.scrape_cycles,
                "leader_scrape_rpcs_total": self.leader_scrape_rpcs,
                "leader_rpcs_per_cycle_avg": self.leader_scrape_rpcs / cycles,
                "members": n,
                "direct_equivalent_rpcs_per_cycle": n,
                "sqrt_bound_rpcs_per_cycle": 4.0 * math.sqrt(n),
                "bound_ok": (
                    self.leader_scrape_rpcs / cycles <= 4.0 * math.sqrt(n)
                ),
                "stale_spans_total": self.stale_spans_total,
                "redelegations_total": self.redelegations_total,
                "scrape_rpc_fraction": (
                    obs_calls / len(self.net.calls) if self.net.calls else 0.0
                ),
                "force_windows": self.force_windows,
                "sampling": sampling,
            },
            "traces": {
                "error_requests": len(error_traces),
                "error_traces_in_merged": len(present),
                "all_errors_sampled": error_traces <= merged_trace_ids,
                "merged_events": sum(
                    1 for ev in merged_trace.get("traceEvents", ())
                    if ev.get("ph") == "X"
                ),
            },
            **extra,
        })

    def _tenants_section(self) -> dict | None:
        """Per-tenant certification: outcome counts per (tenant, model),
        each tenant-model p99 judged against the MODEL's objective, and
        the fleet-summed cross-tenant eviction count the isolation pin
        requires to be zero. Absent entirely for tenant-less traffic —
        legacy certificates don't grow a section of empty rows."""
        only_default = set(self.tenant_tallies) <= {tenant_mod.DEFAULT_TENANT}
        if not self.tenant_specs and only_default:
            return None
        tenants: dict[str, dict] = {}
        for tenant in sorted(set(self.tenant_tallies) | set(self.tenant_specs)):
            spec = tenant_mod.spec_for(tenant, self.tenant_specs)
            per_model: dict[str, dict] = {}
            totals = ModelTally()
            for model, tally in sorted(
                (self.tenant_tallies.get(tenant) or {}).items()
            ):
                objective = self.objectives.get(model)
                p99 = tally.percentile(99)
                per_model[model] = {
                    "kind": tally.kind,
                    "requests": tally.requests,
                    "ok": tally.ok,
                    "shed": tally.shed,
                    "shed_over_quota": tally.shed_over_quota,
                    "deadline": tally.deadline,
                    "evicted": tally.evicted,
                    "error": tally.error,
                    "p50_s": tally.percentile(50),
                    "p99_s": p99,
                    "objective_latency_s": (
                        objective.latency_s if objective else None
                    ),
                    "certified": (
                        p99 is None or objective is None
                        or p99 <= objective.latency_s
                    ),
                }
                totals.requests += tally.requests
                totals.ok += tally.ok
                totals.shed += tally.shed
                totals.shed_over_quota += tally.shed_over_quota
                totals.deadline += tally.deadline
                totals.evicted += tally.evicted
                totals.error += tally.error
            tenants[tenant] = {
                "priority": spec.priority,
                "share": spec.share,
                "requests": totals.requests,
                "ok": totals.ok,
                "shed": totals.shed,
                "shed_over_quota": totals.shed_over_quota,
                "deadline": totals.deadline,
                "evicted": totals.evicted,
                "error": totals.error,
                "models": per_model,
                "certified": all(
                    body["certified"] for body in per_model.values()
                ),
            }
        return {
            "declared": sorted(self.tenant_specs),
            "cross_tenant_evictions": sum(
                m.cross_tenant_evictions for m in self.members
            ),
            "tenants": tenants,
        }

    def _critpath_section(self) -> dict:
        """Root-cause evidence: the folded critical-path table the culprit
        attribution reads, the sentinel's lane states, every burn and
        drift flight event, and — when a drift fault was injected — the
        detection timeline the certification pins (injection cycle, alert
        cycle, the alerts themselves, forced-sampling windows, replan
        requests)."""
        flight = self.flight.to_wire()
        burn_events = [e for e in flight["events"]
                       if e.get("kind") in ("slo_fast_burn", "slo_slow_burn")]
        drift_events = [
            e for e in flight["events"]
            if str(e.get("kind", "")).startswith(("latency_drift", "drift_"))
        ]
        out: dict[str, Any] = {
            "table": self.fleet_critpath.table(),
            "sentinel": self.sentinel.status(),
            "burn_events": burn_events,
            "drift_events": drift_events,
        }
        if self.drift is not None:
            cycles = None
            if self._drift_alert_cycle is not None \
                    and self._drift_injected_cycle is not None:
                cycles = self._drift_alert_cycle - self._drift_injected_cycle
            out["drift"] = {
                "spec": dict(self.drift),
                "injected_member": self.member_addrs[
                    int(self.drift.get("member", 0)) % len(self.members)
                ],
                "injected": self._drift_applied,
                "injected_cycle": self._drift_injected_cycle,
                "alert_cycle": self._drift_alert_cycle,
                "cycles_to_alert": cycles,
                "alerts": list(self.drift_alerts),
                "force_windows": self.drift_force_windows,
                "replan_requests": list(self.replan_requests),
            }
        return out

    def _autoscaler_section(self) -> dict | None:
        """Convergence evidence for the elastic loop: when the first burn
        was seen, how many scrape cycles until the first scale-up, whether
        the fleet scaled back down after quiet, and whether the SLO burned
        again AFTER the scale-down (it must not). The full decision ring —
        every one also flight-recorded — rides along."""
        if self.autoscaler is None:
            return None
        up_cycles = None
        if self._first_burn_cycle is not None and self._first_up_cycle is not None:
            up_cycles = self._first_up_cycle - self._first_burn_cycle + 1
        return {
            "enabled": True,
            "capacity_units": self._capacity_units,
            "first_burn_cycle": self._first_burn_cycle,
            "first_up_cycle": self._first_up_cycle,
            "first_down_cycle": self._first_down_cycle,
            "scale_up_cycles": up_cycles,
            "scaled_down": self._first_down_cycle is not None,
            "breach_after_scale_down": self._breach_after_down,
            "decisions": list(self.autoscaler.decisions),
            "flight_recorded": (
                self.flight.to_wire()["recorded"]
                if self.flight is not None else 0
            ),
        }


# ---------------------------------------------------------------------------
# Certificate schema gate
# ---------------------------------------------------------------------------

_NUM = (int, float)

# section -> {field: required types} — hand-rolled (no jsonschema dep);
# None in a type tuple marks the field as nullable.
_CERT_SHAPE: dict[str, dict[str, tuple]] = {
    "spec": {
        "duration_s": _NUM, "base_rps": _NUM, "seed": (int,),
        "members": (int,), "sample_rate": _NUM, "scrape_interval_s": _NUM,
        "mixes": (list,), "flash_crowds": (list,),
    },
    "observability": {
        "scrape_cycles": (int,), "leader_scrape_rpcs_total": (int,),
        "leader_rpcs_per_cycle_avg": _NUM, "members": (int,),
        "sqrt_bound_rpcs_per_cycle": _NUM, "bound_ok": (bool,),
        "stale_spans_total": (int,), "redelegations_total": (int,),
        "sampling": (dict,),
    },
    "traces": {
        "error_requests": (int,), "error_traces_in_merged": (int,),
        "all_errors_sampled": (bool,), "merged_events": (int,),
    },
}

_MODEL_SHAPE: dict[str, tuple] = {
    "kind": (str,), "requests": (int,), "ok": (int,), "shed": (int,),
    "shed_over_quota": (int,),
    "deadline": (int,), "evicted": (int,), "error": (int,),
    "p50_s": (*_NUM, type(None)), "p99_s": (*_NUM, type(None)),
    "fast_burn": _NUM, "slow_burn": _NUM,
    "fast_alert": (bool,), "slow_alert": (bool,),
}

_TENANT_SHAPE: dict[str, tuple] = {
    "priority": (str,), "share": _NUM,
    "requests": (int,), "ok": (int,), "shed": (int,),
    "shed_over_quota": (int,), "deadline": (int,), "evicted": (int,),
    "error": (int,), "models": (dict,), "certified": (bool,),
}


def validate_slo_cert(doc: dict) -> list[str]:
    """Structural validation of one certificate document; returns the list
    of problems (empty = valid). CI fails the seeded smoke leg on any."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("version") != SLO_CERT_VERSION:
        problems.append(f"version must be {SLO_CERT_VERSION}")
    if not isinstance(doc.get("seed"), int):
        problems.append("seed must be an integer")
    for section, shape in _CERT_SHAPE.items():
        body = doc.get(section)
        if not isinstance(body, dict):
            problems.append(f"missing section {section!r}")
            continue
        for key, types in shape.items():
            if key not in body:
                problems.append(f"{section}.{key} missing")
            elif not isinstance(body[key], types) or (
                isinstance(body[key], bool) and bool not in types
            ):
                problems.append(f"{section}.{key} has wrong type")
    slo = doc.get("slo")
    if not isinstance(slo, dict) or not isinstance(slo.get("models"), dict):
        problems.append("slo.models missing")
    models = doc.get("models")
    if not isinstance(models, dict) or not models:
        problems.append("models section missing or empty")
        return problems
    for model, body in models.items():
        if not isinstance(body, dict):
            problems.append(f"models.{model} is not an object")
            continue
        for key, types in _MODEL_SHAPE.items():
            if key not in body:
                problems.append(f"models.{model}.{key} missing")
            elif not isinstance(body[key], types) or (
                isinstance(body[key], bool) and bool not in types
            ):
                problems.append(f"models.{model}.{key} has wrong type")
        counted = sum(
            int(body.get(k) or 0)
            for k in ("ok", "shed", "deadline", "evicted", "error")
        )
        if counted != int(body.get("requests") or 0):
            problems.append(f"models.{model}: outcome counts != requests")
    problems.extend(_validate_tenants(doc, models))
    problems.extend(_validate_autoscaler(doc))
    problems.extend(validate_sessions(doc))
    problems.extend(_validate_critpath(doc))
    return problems


def _validate_tenants(doc: dict, models: dict) -> list[str]:
    """The per-tenant section's invariants (optional section — absent on
    tenant-less certificates): every tenant's outcome counts must sum to
    its requests, the tenants' request totals must account for EXACTLY the
    model totals (no request untallied, none double-counted), and the
    cross-tenant eviction count must be present (the isolation pin reads
    it)."""
    body = doc.get("tenants")
    if body is None:
        return []
    problems: list[str] = []
    if not isinstance(body, dict) or not isinstance(body.get("tenants"), dict):
        return ["tenants section is not an object with a tenants map"]
    if not isinstance(body.get("cross_tenant_evictions"), int):
        problems.append("tenants.cross_tenant_evictions missing")
    tenant_requests = 0
    for tenant, tbody in body["tenants"].items():
        if not isinstance(tbody, dict):
            problems.append(f"tenants.{tenant} is not an object")
            continue
        for key, types in _TENANT_SHAPE.items():
            if key not in tbody:
                problems.append(f"tenants.{tenant}.{key} missing")
            elif not isinstance(tbody[key], types) or (
                isinstance(tbody[key], bool) and bool not in types
            ):
                problems.append(f"tenants.{tenant}.{key} has wrong type")
        counted = sum(
            int(tbody.get(k) or 0)
            for k in ("ok", "shed", "deadline", "evicted", "error")
        )
        if counted != int(tbody.get("requests") or 0):
            problems.append(f"tenants.{tenant}: outcome counts != requests")
        for model, mbody in (tbody.get("models") or {}).items():
            if not isinstance(mbody, dict):
                problems.append(f"tenants.{tenant}.models.{model} not an object")
                continue
            mcounted = sum(
                int(mbody.get(k) or 0)
                for k in ("ok", "shed", "deadline", "evicted", "error")
            )
            if mcounted != int(mbody.get("requests") or 0):
                problems.append(
                    f"tenants.{tenant}.models.{model}: "
                    "outcome counts != requests"
                )
        tenant_requests += int(tbody.get("requests") or 0)
    model_requests = sum(
        int((m or {}).get("requests") or 0) for m in models.values()
        if isinstance(m, dict)
    )
    if tenant_requests != model_requests:
        problems.append(
            f"tenants request total {tenant_requests} != "
            f"models request total {model_requests}"
        )
    return problems


def _validate_critpath(doc: dict) -> list[str]:
    """The root-cause section's invariants (optional section — absent on
    pre-critpath certificates): every charged model's lane shares must sum
    to 1 (never more), every burn alert for a model the table attributes
    must carry its named culprit, and a run that injected a drift fault
    must show the sentinel detecting it — the right (model, stage, member)
    named, the forced-sampling window opened, the replan requested."""
    body = doc.get("critpath")
    if body is None:
        return []
    problems: list[str] = []
    if not isinstance(body, dict) or not isinstance(body.get("table"), dict):
        return ["critpath section is not an object with a table"]
    models = body["table"].get("models")
    if not isinstance(models, dict):
        return ["critpath.table.models missing"]
    for model, mbody in models.items():
        lanes = (mbody or {}).get("lanes")
        if not isinstance(lanes, list) or not lanes:
            problems.append(f"critpath.{model}: no lanes")
            continue
        total = 0.0
        for ln in lanes:
            share = float((ln or {}).get("share") or 0.0)
            if share < 0.0 or share > 1.0 + 1e-9:
                problems.append(f"critpath.{model}: share {share} out of range")
            total += share
        if total > 1.0 + 1e-6 or abs(total - 1.0) > 1e-6:
            problems.append(f"critpath.{model}: shares sum {total:.8f} != 1")
    burns = body.get("burn_events")
    if not isinstance(burns, list):
        problems.append("critpath.burn_events missing")
        burns = []
    for i, ev in enumerate(burns):
        if not isinstance(ev, dict):
            problems.append(f"critpath.burn_events[{i}] not an object")
            continue
        if str(ev.get("model") or "") not in models:
            continue  # the table never attributed this lane; nothing owed
        if "culprit_stage" not in ev or "culprit_member" not in ev \
                or "critpath_share" not in ev:
            problems.append(f"critpath.burn_events[{i}] lacks culprit")
    drift = body.get("drift")
    if drift is None:
        return problems
    if not isinstance(drift, dict):
        return [*problems, "critpath.drift is not an object"]
    if not drift.get("injected"):
        problems.append("critpath.drift: fault was never injected")
        return problems
    spec = drift.get("spec") or {}
    member = str(drift.get("injected_member") or "")
    stage = str(spec.get("stage") or "decode")
    alerts = drift.get("alerts")
    if not isinstance(alerts, list) or not alerts:
        problems.append("critpath.drift: sentinel never alerted")
        return problems
    first = alerts[0] if isinstance(alerts[0], dict) else {}
    if str(first.get("member")) != member or str(first.get("stage")) != stage:
        problems.append(
            "critpath.drift: first alert names "
            f"({first.get('stage')}, {first.get('member')}), "
            f"fault was ({stage}, {member})"
        )
    if not isinstance(drift.get("cycles_to_alert"), int):
        problems.append("critpath.drift: cycles_to_alert missing")
    if int(drift.get("force_windows") or 0) < 1:
        problems.append("critpath.drift: no forced-sampling window opened")
    replans = drift.get("replan_requests")
    if not isinstance(replans, list) or not replans:
        problems.append("critpath.drift: no replan requested")
    elif not any(member in str(r) and stage in str(r) for r in replans):
        problems.append("critpath.drift: replan reason names no culprit")
    return problems


def _validate_autoscaler(doc: dict) -> list[str]:
    """The autoscaler section's invariants (optional section): decision
    list present and every decision carries a direction + trigger, the
    flight-recorded count covers the decisions, and a clean run never
    burned after its scale-down."""
    body = doc.get("autoscaler")
    if body is None:
        return []
    problems: list[str] = []
    if not isinstance(body, dict):
        return ["autoscaler section is not an object"]
    decisions = body.get("decisions")
    if not isinstance(decisions, list):
        problems.append("autoscaler.decisions missing")
        decisions = []
    for i, decision in enumerate(decisions):
        if not isinstance(decision, dict) or "direction" not in decision \
                or "trigger" not in decision:
            problems.append(f"autoscaler.decisions[{i}] lacks direction/trigger")
    recorded = body.get("flight_recorded")
    if not isinstance(recorded, int) or recorded < len(decisions):
        problems.append("autoscaler.flight_recorded < decisions")
    if not isinstance(body.get("breach_after_scale_down"), bool):
        problems.append("autoscaler.breach_after_scale_down missing")
    return problems


# ---------------------------------------------------------------------------
# The canonical tenant-isolation scenario
# ---------------------------------------------------------------------------
#
# One definition, three consumers: tests/test_autoscaler.py pins its
# verdicts across the chaos-seed matrix, tools/slo_cert.py --tenants
# replays it standalone, and tools/ci_check.sh runs that per seed leg.
# Tenant "acme" (low priority, half share) takes a 10x flash crowd while
# the default tenant's steady traffic rides the same members; the
# certificate must show acme shedding typed over-quota inside its own
# allowance, the default tenant's p99 certified, zero cross-tenant
# evictions, and the autoscaler scaling up on the burn edge then back
# down after quiet without re-breaching.

ISOLATION_TENANTS: dict[str, dict[str, object]] = {
    "acme": {"priority": "low", "share": 0.5},
}


def two_tenant_flash_spec(
    seed: int,
    *,
    base_rps: float = 40.0,
    duration_s: float = 240.0,
    surge_start_s: float = 30.0,
    surge_duration_s: float = 30.0,
    surge_multiplier: float = 10.0,
) -> TrafficSpec:
    """The pinned two-tenant traffic shape: default tenant serves a
    steady predict+generate mix; tenant ``acme`` runs generate traffic
    and takes a tenant-scoped flash crowd."""
    return TrafficSpec(
        mixes=(
            TrafficMix("resnet50", "predict", 0.5),
            TrafficMix("llm-7b", "generate", 0.2),
            TrafficMix("llm-7b", "generate", 0.3, tenant="acme"),
        ),
        base_rps=base_rps,
        duration_s=duration_s,
        flash_crowds=(
            FlashCrowd(
                start_s=surge_start_s,
                duration_s=surge_duration_s,
                multiplier=surge_multiplier,
                tenant="acme",
            ),
        ),
        seed=seed,
    )


def tenant_isolation_harness(
    n_members: int, seed: int, **overrides: Any
) -> ReplayHarness:
    """ReplayHarness wired for the isolation certification: quota
    enforcement on, the real autoscaler actuating sim capacity, a short
    fast-burn window (detection latency bounds how much of the surge
    leaks into latency before the scale-up), and a clear-window run
    longer than the surge so the scale-down happens after quiet, not
    mid-crowd."""
    params: dict[str, Any] = dict(
        tenants=tenant_mod.parse_tenants(ISOLATION_TENANTS),
        autoscale=True,
        autoscale_max_units=8,
        autoscale_clear_windows=12,
        capacity_headroom=2.0,
        scrape_interval_s=2.5,
        fast_window_s=5.0,
    )
    params.update(overrides)
    return ReplayHarness(n_members, two_tenant_flash_spec(seed), **params)


# ---------------------------------------------------------------------------
# The canonical drift-sentinel scenario
# ---------------------------------------------------------------------------
#
# One definition, three consumers: tests/test_critpath.py pins its
# verdicts across the chaos-seed matrix, tools/slo_cert.py --critpath
# replays it standalone, and tools/ci_check.sh runs that per seed leg.
# A steady single-model predict load rides four members (none of them a
# SLOW_EVERY straggler); at half-replay EXACTLY ONE member's decode stage
# slows 5x. The certificate must show the sentinel naming (model, decode,
# that member) within three detection windows of the injection, the next
# fast-burn alert carrying the same culprit, a forced-sampling window
# opening, and a placement replan requested with the culprit in its
# reason — all read back from the flight recorder.

DRIFT_MEMBER_INDEX = 1
DRIFT_STAGE = "decode"
DRIFT_FACTOR = 5.0
DRIFT_SCRAPE_INTERVAL_S = 2.5
DRIFT_FAST_WINDOW_S = 5.0
# Detection bound the certification pins: the sentinel must name the
# culprit within this many fast-burn windows of the injection.
DRIFT_DETECT_FAST_WINDOWS = 3


def drift_soak_spec(
    seed: int, *, base_rps: float = 40.0, duration_s: float = 240.0,
) -> TrafficSpec:
    """The pinned drift traffic shape: one steady predict mix, no flash
    crowds — the injected stage fault is the ONLY latency shift in the
    run, so any alert the sentinel raises is attributable to it."""
    return TrafficSpec(
        mixes=(TrafficMix("resnet50", "predict", 1.0),),
        base_rps=base_rps,
        duration_s=duration_s,
        seed=seed,
    )


def drift_sentinel_harness(
    n_members: int, seed: int, **overrides: Any
) -> ReplayHarness:
    """ReplayHarness wired for the drift certification: scrape cadence ==
    analyzer window (every fold carries one fresh window of samples), a
    short fast-burn window with a threshold the one-member slowdown
    clearly crosses (frac-over ~0.11 of a 0.05 budget => burn ~2.3), and
    the 5x decode fault on one member at half-replay."""
    params: dict[str, Any] = dict(
        scrape_interval_s=DRIFT_SCRAPE_INTERVAL_S,
        fast_window_s=DRIFT_FAST_WINDOW_S,
        fast_burn=1.5,
        drift={
            "member": DRIFT_MEMBER_INDEX, "stage": DRIFT_STAGE,
            "factor": DRIFT_FACTOR, "at_fraction": 0.5,
        },
        sentinel_min_samples=20,
        sentinel_confirm_windows=3,
        sentinel_drift_factor=2.0,
    )
    params.update(overrides)
    return ReplayHarness(n_members, drift_soak_spec(seed), **params)


# ---------------------------------------------------------------------------
# The canonical session-churn scenario
# ---------------------------------------------------------------------------
#
# One definition, three consumers again: tests/test_genrouter.py pins its
# verdicts across the chaos-seed matrix, tools/slo_cert.py --sessions
# replays it standalone, and tools/ci_check.sh runs that per seed leg.
# Sixteen generation streams across two tenants ride real GenerateWorkers
# behind the real session router; the seeded schedule kills two members
# mid-decode and drains a third, and the certificate's ``sessions``
# section must show every stream completing token-identically to its
# unkilled reference — zero lost, zero duplicated — with migrations
# bounded by the sessions actually resident at each disruption and the
# drain dropping nothing.


def _session_plan(prompt: list[int], seed: int, n: int) -> list[int]:
    """A toy decoder's full output: token i is a pure function of
    (prompt, seed, i) — the same contract the engine's position-seeded
    sampling provides, so resume-from-prefix continues identically."""
    return [int(prompt[0]) * 1000 + int(seed) % 97 * 10 + i + 1
            for i in range(n)]


class _SessionDecoder:
    """Deterministic GenerationBackend stand-in with the resume-from-prefix
    entry: ``resume_tokens`` skips the already-delivered positions."""

    def __init__(self, member: str, prefills: dict[str, int]):
        self.member = member
        self.prefills = prefills  # shared across members: sid -> count
        self.live: list[tuple[Any, list[int]]] = []

    def submit(self, prompt: list[int], *, max_new_tokens: int,
               temperature: float = 0.0, eos_id: int | None = None,
               request_id: str = "", seed: int | None = None,
               resume_tokens: Any = None) -> Any:
        from dmlc_tpu_torch.generate.slots import GenStream

        stream = GenStream(request_id)
        done = [int(t) for t in resume_tokens] if resume_tokens else []
        full = _session_plan(prompt, seed or 0, len(done) + int(max_new_tokens))
        self.prefills[request_id] = self.prefills.get(request_id, 0) + 1
        self.live.append((stream, full[len(done):]))
        return stream

    def step(self) -> None:
        for stream, remaining in self.live:
            if stream.done or stream.cancelled:
                continue
            if remaining:
                stream.push([remaining.pop(0)])
            if not remaining:
                stream.finish()


class SessionChurnHarness:
    """Generate-heavy churn against the REAL session tier: ``n_members``
    real ``GenerateWorker``s over deterministic toy decoders on a
    ``SimRpcNetwork``, fronted by a real ``GenRouter`` holding the tenant
    ledger (``ISOLATION_TENANTS``). The seeded schedule interleaves decode
    steps, client polls, and leader ticks with ``kills`` member crashes
    mid-decode and ``drains`` operator drains; ``run()`` drives everything
    to completion and returns the sessions-section certificate document."""

    def __init__(self, n_members: int, seed: int, *, streams: int = 16,
                 kills: int = 2, drains: int = 1, max_rounds: int = 600):
        if n_members < kills + drains + 1:
            raise ValueError("need a survivor: n_members > kills + drains")
        self.n_members = int(n_members)
        self.seed = int(seed)
        self.streams = int(streams)
        self.kills = int(kills)
        self.drains = int(drains)
        self.max_rounds = int(max_rounds)

    def run(self) -> dict[str, Any]:
        from dmlc_tpu_torch.generate.worker import GenerateWorker
        from dmlc_tpu_torch.scheduler.genrouter import GenRouter

        rng = random.Random(self.seed)
        net = SimRpcNetwork()
        alive = {f"m{i}" for i in range(self.n_members)}
        prefills: dict[str, int] = {}
        decoders: dict[str, _SessionDecoder] = {}
        for m in sorted(alive):
            decoders[m] = _SessionDecoder(m, prefills)
            worker = GenerateWorker(
                {"toy": decoders[m]},  # type: ignore[dict-item]
                session_ttl_s=1e9, clock=net.clock,
            )
            net.serve(m, worker.methods())
        router = GenRouter(
            net.client("L"),
            lambda: sorted(alive),
            tenants=tenant_mod.parse_tenants(ISOLATION_TENANTS),
            max_sessions=4 * self.streams,
            drain_deadline_s=0.0,
            session_ttl_s=1e9,
            timeout_s=5.0,
            clock=net.clock,
        )
        router.is_leading = True
        router.epoch = [1, "L"]
        net.serve("L", router.methods())

        # Seeded stream population across the two tenants. Each stream's
        # reference is its plan — what an unkilled run would deliver.
        clients: list[dict[str, Any]] = []
        for i in range(self.streams):
            tenant = "acme" if i % 2 else tenant_mod.DEFAULT_TENANT
            prompt, sd = [i + 1], self.seed * 1000 + i
            tokens = rng.randint(6, 12)
            clients.append({
                "cid": f"c{i}", "tenant": tenant, "prompt": prompt,
                "seed": sd, "plan": _session_plan(prompt, sd, tokens),
                "tokens": tokens, "gen_id": None, "acked": 0,
                "consumed": [], "finished": False, "lost": False,
            })
        for c in clients:
            with tenant_mod.bind(c["tenant"]):
                reply = net.client(c["cid"]).call("L", "job.generate", {
                    "model": "toy", "prompt": c["prompt"],
                    "max_new_tokens": c["tokens"], "seed": c["seed"],
                })
            c["gen_id"] = reply["gen_id"]

        # Seeded disruption schedule: kills and the drain land on distinct
        # members at distinct rounds, each mid-decode.
        rounds = sorted(rng.sample(range(2, 2 + 4 * (self.kills + self.drains)),
                                   self.kills + self.drains))
        events = (["kill"] * self.kills) + (["drain"] * self.drains)
        rng.shuffle(events)
        schedule = dict(zip(rounds, events))
        disrupted: set[str] = set()
        migration_budget = 0
        drain_members: list[str] = []
        drain_resident: set[str] = set()

        def residents(member: str) -> list[str]:
            return [s["id"] for s in router.sessions_table()
                    if s["member"] == member
                    and s["state"] in ("running", "migrating")]

        done = 0
        for rnd in range(self.max_rounds):
            event = schedule.get(rnd)
            if event is not None:
                hosting = sorted(
                    m for m in alive - disrupted
                    if residents(m)
                ) or sorted(alive - disrupted)
                victim = rng.choice(hosting)
                disrupted.add(victim)
                migration_budget += len(residents(victim))
                if event == "kill":
                    alive.discard(victim)
                    net.crash(victim)
                else:
                    drain_members.append(victim)
                    drain_resident.update(residents(victim))
                    router.drain(victim, reason="loadgen")
            for m in sorted(alive):
                decoders[m].step()
            router.tick()
            done = 0
            for c in clients:
                if c["finished"] or c["lost"]:
                    done += 1
                    continue
                try:
                    r = net.client(c["cid"]).call("L", "job.generate_poll", {
                        "gen_id": c["gen_id"], "ack": c["acked"],
                    })
                except (RpcUnreachable, RpcError):
                    continue
                for seq, toks in sorted(r.get("chunks", [])):
                    if seq <= c["acked"]:
                        continue
                    c["acked"] = seq
                    c["consumed"].extend(int(t) for t in toks)
                if r.get("done") and not r.get("chunks"):
                    if r.get("error"):
                        c["lost"] = True
                    else:
                        c["finished"] = True
            if done == len(clients):
                break

        return self._certify(router, clients, migration_budget,
                             drain_members, drain_resident)

    def _certify(self, router: Any, clients: list[dict[str, Any]],
                 migration_budget: int, drain_members: list[str],
                 drain_resident: set[str]) -> dict[str, Any]:
        migrations_by_sid = {
            s["id"]: int(s["migrations"]) for s in router.sessions_table()
        }
        drains_doc = router.draining()
        tenants: dict[str, dict[str, int]] = {}
        completed = lost = duplicated = drain_lost = 0
        max_migrations = 0
        total_migrations = 0
        for c in clients:
            t = tenants.setdefault(c["tenant"], {
                "streams": 0, "completed": 0, "lost": 0,
                "duplicated": 0, "migrations": 0,
            })
            t["streams"] += 1
            ok = c["finished"] and c["consumed"] == c["plan"]
            dup = c["consumed"] != c["plan"][: len(c["consumed"])]
            m = migrations_by_sid.get(c["gen_id"], 0)
            completed += int(ok)
            t["completed"] += int(ok)
            if not ok:
                lost += 1
                t["lost"] += 1
                if c["gen_id"] in drain_resident:
                    drain_lost += 1
            duplicated += int(dup)
            t["duplicated"] += int(dup)
            total_migrations += m
            t["migrations"] += m
            max_migrations = max(max_migrations, m)
        certified = (
            completed == len(clients) and lost == 0 and duplicated == 0
            and total_migrations <= migration_budget and drain_lost == 0
            and all(d.get("complete") for d in drains_doc.values())
        )
        return {
            "version": SLO_CERT_VERSION,
            "seed": self.seed,
            "sessions": {
                "members": self.n_members,
                "streams": len(clients),
                "completed": completed,
                "lost": lost,
                "duplicated": duplicated,
                "kills": self.kills,
                "drains": self.drains,
                "migrations": total_migrations,
                "migration_budget": migration_budget,
                "max_migrations_per_stream": max_migrations,
                "drain_completed": all(
                    bool(d.get("complete")) for d in drains_doc.values()
                ) if drains_doc else True,
                "drain_lost": drain_lost,
                "tenants": tenants,
                "certified": certified,
            },
        }


def session_churn_harness(
    n_members: int, seed: int, **overrides: Any
) -> SessionChurnHarness:
    """SessionChurnHarness wired for the survivable-generation
    certification: sixteen streams over two tenants on four members, two
    seeded kills mid-decode and one drain (docs/GENERATE.md)."""
    params: dict[str, Any] = dict(streams=16, kills=2, drains=1)
    params.update(overrides)
    return SessionChurnHarness(n_members, seed, **params)


_SESSION_SHAPE: dict[str, tuple] = {
    "members": (int,), "streams": (int,), "completed": (int,),
    "lost": (int,), "duplicated": (int,), "kills": (int,),
    "drains": (int,), "migrations": (int,), "migration_budget": (int,),
    "max_migrations_per_stream": (int,), "drain_completed": (bool,),
    "drain_lost": (int,), "tenants": (dict,), "certified": (bool,),
}


def validate_sessions(doc: dict) -> list[str]:
    """The sessions section's invariants (optional section — absent on
    certificates without generation churn): every verdict field present
    and typed, completed + lost accounting for every stream, and the
    per-tenant breakdown summing exactly to the fleet totals."""
    body = doc.get("sessions")
    if body is None:
        return []
    problems: list[str] = []
    if not isinstance(body, dict):
        return ["sessions section is not an object"]
    for key, types in _SESSION_SHAPE.items():
        if key not in body:
            problems.append(f"sessions.{key} missing")
        elif not isinstance(body[key], types) or (
            isinstance(body[key], bool) and bool not in types
        ):
            problems.append(f"sessions.{key} has wrong type")
    # Arithmetic invariants run only over well-typed fields: a tampered
    # "zero" string is already reported above and must not crash the
    # validator (it judges hostile docs, it doesn't trust them).
    def num(v: Any) -> int:
        return int(v) if isinstance(v, (int, float)) and \
            not isinstance(v, bool) else 0

    if num(body.get("completed")) + num(body.get("lost")) != \
            num(body.get("streams")):
        problems.append("sessions: completed + lost != streams")
    tenants = body.get("tenants")
    if isinstance(tenants, dict):
        for name, tbody in tenants.items():
            if not isinstance(tbody, dict):
                problems.append(f"sessions.tenants.{name} is not an object")
        for key in ("streams", "completed", "lost", "migrations"):
            tallied = sum(
                num(t.get(key)) for t in tenants.values()
                if isinstance(t, dict)
            )
            if tallied != num(body.get(key)):
                problems.append(
                    f"sessions: tenant {key} total {tallied} != "
                    f"fleet {key} {body.get(key)}"
                )
    return problems


__all__ = [
    "ISOLATION_TENANTS",
    "SLO_CERT_VERSION",
    "FlashCrowd",
    "ModelTally",
    "OpenLoopArrivals",
    "ReplayHarness",
    "SessionChurnHarness",
    "SimMember",
    "TrafficMix",
    "TrafficSpec",
    "session_churn_harness",
    "tenant_isolation_harness",
    "two_tenant_flash_spec",
    "validate_sessions",
    "validate_slo_cert",
]
