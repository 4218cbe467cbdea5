"""SLO burn-rate monitoring + profile-driven placement (the control loop).

Copied from ``dmlc_tpu/scheduler/placement.py`` (the whole module): the
objectives' config form, the burn-rate windows, the plan and its flight
notes are the JAX package's, so a leader of either package plans the same
placement from the same profiles.

This module spends the observability plane: ``CostProfiler`` lanes
(cluster/profile.py) feed two decision-makers the JobScheduler consults —

- **SloEvaluator** — per-model latency/availability objectives declared in
  ClusterConfig (``slo_objectives``). Burn rate is the SRE-workbook form:
  the fraction of observations over the latency objective, divided by the
  error budget (1 - availability target), over two horizons — a *fast*
  window that catches cliffs in minutes and a *slow* window that catches
  smolder. Alert transitions (with hysteresis, so a fleet hovering at the
  line does not flap) land in the flight recorder, the metrics counters,
  and per-model registry gauges; a fast-burn transition also pings the
  scheduler to replan placement NOW instead of on the next periodic pass.

- **PlacementAdvisor** — solves model -> member assignment from measured
  per-member dispatch cost instead of blind round-robin. Greedy
  cost-balancing: members whose decayed mean cost exceeds
  ``exclude_factor`` x the fleet median are excluded (with a re-entry
  hysteresis band so a recovering member must come well back under the
  line), the rest are dealt to jobs by capacity (chip weight / measured
  cost), and dispatch-pool weights scale inversely with cost so a slow
  member that stays assigned still receives proportionally fewer shards.
  Plans are throttled by a max-moves-per-window budget and a relative
  improvement threshold — rebalancing is itself a disturbance, and an
  advisor that reshuffles the fleet every tick is worse than round-robin.

Every decision stamps the flight recorder (lint rule O2 enforces this for
any future profile-reading scheduler path): placement must never be
invisible in a postmortem.

Both classes are sans-IO (injected clocks, no RPC, leaf locks only) so the
seeded sim soak (tests/test_placement.py) drives the whole loop —
degradation -> fast burn -> replan -> recovery — on the virtual clock.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from time import monotonic
from typing import Any, Callable

from dmlc_tpu_torch.cluster import tenant as tenant_mod

log = logging.getLogger(__name__)


def tenant_lane(model: str, tenant: str) -> str:
    """Composite profiler model key for one tenant's share of a model's
    traffic (``model@tenant``). The default tenant rides the bare model
    lane, so a tenant-less fleet records exactly what it always did; the
    dispatch paths record BOTH the bare lane (the aggregate every existing
    consumer reads) and the composite one when a non-default tenant is
    ambient."""
    if not tenant or tenant == tenant_mod.DEFAULT_TENANT:
        return model
    return f"{model}@{tenant}"


# ---------------------------------------------------------------------------
# SLO evaluation: multi-window burn rates
# ---------------------------------------------------------------------------


@dataclass
class SloObjective:
    """One model's serving objective: ``latency_s`` is the per-shard
    dispatch latency bound, ``availability`` the target fraction of
    dispatches under it (error budget = 1 - availability)."""

    model: str
    latency_s: float
    availability: float = 0.99

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.availability)

    @classmethod
    def from_config(cls, objectives: dict) -> "dict[str, SloObjective]":
        """Parse the ClusterConfig ``slo_objectives`` mapping
        (``{model: {"latency_s": s, "availability": a}}``)."""
        out: dict[str, SloObjective] = {}
        for model, spec in (objectives or {}).items():
            out[model] = cls(
                model=model,
                latency_s=float(spec["latency_s"]),
                availability=float(spec.get("availability", 0.99)),
            )
        return out


class SloEvaluator:
    """Evaluates burn rates from profiler lanes on every call (the leader
    runs it on the scrape cadence). Stateful only for alert edges."""

    # An alert clears only once burn falls below this fraction of its
    # threshold: hysteresis against flapping at the line.
    CLEAR_FRACTION = 0.5

    def __init__(
        self,
        profiler: Any,
        objectives: dict[str, SloObjective],
        *,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        fast_burn: float = 14.0,
        slow_burn: float = 2.0,
        stage: str = "dispatch",
        metrics: Any = None,
        flight: Any = None,
        registry: Any = None,
        on_fast_burn: Callable[[str], None] | None = None,
        tenants: list[str] | None = None,
        tenant_guard: Any = None,
        attribution: Callable[[str], dict[str, Any] | None] | None = None,
    ) -> None:
        self.profiler = profiler
        self.objectives = dict(objectives)
        # Root-cause hook (cluster/critpath.FleetCritPath.culprit): maps a
        # model to its top critical-path contributor so every burn alert
        # names (stage, member, critpath_share) instead of just the model.
        self.attribution = attribution
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.stage = stage
        self.metrics = metrics
        self.flight = flight
        self.on_fast_burn = on_fast_burn
        # Declared tenants (utils/config ``tenants``): each gets its own
        # burn lane per model, scored against the MODEL's objective — the
        # per-tenant promise is the same latency bound, evaluated on that
        # tenant's traffic only (profiler lane ``model@tenant``).
        self.tenants = sorted(tenants or [])
        # utils/metrics.TenantLabelGuard (optional): bounds per-tenant
        # gauge label cardinality.
        self.tenant_guard = tenant_guard
        # lane -> {"fast": burn, "slow": burn, "fast_alert": bool, ...}
        # where lane is the model (aggregate) or "model@tenant".
        self._state: dict[str, dict] = {
            lane: {"fast": 0.0, "slow": 0.0, "fast_alert": False,
                   "slow_alert": False}
            for m in self.objectives for lane in self._lanes(m)
        }
        self._lock = threading.Lock()
        if registry is not None:
            for model in self.objectives:
                for lane in self._lanes(model):
                    name = lane if lane == model else self._gauge_label(lane, model)
                    registry.gauge(
                        f"slo_fast_burn_{name}",
                        lambda ln=lane: self._state[ln]["fast"],
                    )
                    registry.gauge(
                        f"slo_slow_burn_{name}",
                        lambda ln=lane: self._state[ln]["slow"],
                    )

    def _lanes(self, model: str) -> list[str]:
        """The aggregate lane plus one per declared tenant."""
        return [model] + [f"{model}@{t}" for t in self.tenants]

    def _gauge_label(self, lane: str, model: str) -> str:
        tenant = lane[len(model) + 1:]
        if self.tenant_guard is not None:
            tenant = self.tenant_guard.label(tenant)
        return f"{model}@{tenant}"

    def _culprit(self, model: str) -> dict[str, Any]:
        """Flight-note fields naming the model's top critical-path
        contributor; empty when attribution is unwired or has no data yet
        (a burn note without a culprit beats no burn note)."""
        if self.attribution is None:
            return {}
        try:
            top = self.attribution(model)
        except Exception:  # the alert must land even if attribution dies
            log.exception("slo attribution failed for %s", model)
            return {}
        if not top:
            return {}
        return {
            "culprit_stage": str(top.get("stage", "")),
            "culprit_member": str(top.get("member", "")),
            "critpath_share": float(top.get("critpath_share", 0.0)),
        }

    def _burn(self, obj: SloObjective, horizon_s: float,
              lane: str | None = None) -> float:
        frac = self.profiler.frac_over(
            obj.latency_s, model=lane or obj.model, stage=self.stage,
            horizon_s=horizon_s,
        )
        return frac / obj.error_budget

    def evaluate(self) -> dict[str, dict]:
        """One evaluation pass over every objective — aggregate per model
        plus one lane per declared (model, tenant). Returns the per-lane
        state after the pass. Alert edge-transitions record flight events
        and counters; entering fast burn fires ``on_fast_burn`` (after the
        evaluator's own lock is released — the callback takes the
        scheduler's lock)."""
        fired: list[str] = []
        with self._lock:
            for model, obj in sorted(self.objectives.items()):
                for lane in self._lanes(model):
                    tenant = lane[len(model) + 1:] if lane != model else None
                    st = self._state[lane]
                    st["fast"] = self._burn(obj, self.fast_window_s, lane=lane)
                    st["slow"] = self._burn(obj, self.slow_window_s, lane=lane)
                    for win, threshold in (("fast", self.fast_burn),
                                           ("slow", self.slow_burn)):
                        alert_key = f"{win}_alert"
                        if not st[alert_key] and st[win] >= threshold:
                            st[alert_key] = True
                            if self.metrics is not None:
                                self.metrics.inc(f"slo_{win}_burn_alerts")
                            if self.flight is not None:
                                culprit = self._culprit(model)
                                self.flight.note(
                                    f"slo_{win}_burn", model=model,
                                    burn=round(st[win], 3), threshold=threshold,
                                    objective_s=obj.latency_s,
                                    **({"tenant": tenant} if tenant else {}),
                                    **culprit,
                                )
                            log.warning("SLO %s burn for %s: %.1fx budget "
                                        "(threshold %.1fx)", win, lane,
                                        st[win], threshold)
                            if win == "fast":
                                fired.append(lane)
                        elif st[alert_key] and \
                                st[win] <= self.CLEAR_FRACTION * threshold:
                            st[alert_key] = False
                            if self.flight is not None:
                                self.flight.note(
                                    "slo_burn_clear", model=model, window=win,
                                    burn=round(st[win], 3),
                                    **({"tenant": tenant} if tenant else {}),
                                )
            out = {m: dict(st) for m, st in self._state.items()}
        if self.on_fast_burn is not None:
            for lane in fired:
                self.on_fast_burn(lane)
        return out

    def status(self) -> dict:
        """The ``obs.slo`` reply / CLI ``slo`` verb payload."""
        with self._lock:
            state = {m: dict(st) for m, st in self._state.items()}
        out: dict = {
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fast_burn_threshold": self.fast_burn,
            "slow_burn_threshold": self.slow_burn,
            "models": {},
        }
        for model, obj in sorted(self.objectives.items()):
            st = state.get(model, {})
            body: dict = {
                "objective_latency_s": obj.latency_s,
                "availability": obj.availability,
                "p99_s": self.profiler.percentile(
                    99, model=model, stage=self.stage,
                    horizon_s=self.fast_window_s,
                ),
                "fast_burn": st.get("fast", 0.0),
                "slow_burn": st.get("slow", 0.0),
                "fast_alert": st.get("fast_alert", False),
                "slow_alert": st.get("slow_alert", False),
            }
            if self.attribution is not None:
                try:
                    body["culprit"] = self.attribution(model)
                except Exception:
                    log.exception("slo attribution failed for %s", model)
                    body["culprit"] = None
            if self.tenants:
                body["tenants"] = {
                    t: {
                        "p99_s": self.profiler.percentile(
                            99, model=f"{model}@{t}", stage=self.stage,
                            horizon_s=self.fast_window_s,
                        ),
                        "fast_burn": state.get(f"{model}@{t}", {}).get("fast", 0.0),
                        "slow_burn": state.get(f"{model}@{t}", {}).get("slow", 0.0),
                        "fast_alert": state.get(f"{model}@{t}", {}).get(
                            "fast_alert", False),
                        "slow_alert": state.get(f"{model}@{t}", {}).get(
                            "slow_alert", False),
                    }
                    for t in self.tenants
                }
            out["models"][model] = body
        return out

    def burning_models(self) -> list[str]:
        """Lanes currently in fast-burn alert (bare models plus any
        ``model@tenant`` composites) — what the leader's forced-sampling
        hook, the autoscaler, and the SLO-cert harness key off."""
        with self._lock:
            return sorted(
                m for m, st in self._state.items() if st.get("fast_alert")
            )


# ---------------------------------------------------------------------------
# Placement: greedy cost-balancing with hysteresis + move budget
# ---------------------------------------------------------------------------


@dataclass
class PlacementPlan:
    """One solved assignment: job -> members, plus per-member dispatch-pool
    weights (shards land proportionally to weight)."""

    assignment: dict[str, list[str]] = field(default_factory=dict)
    weights: dict[str, dict[str, int]] = field(default_factory=dict)
    excluded: list[str] = field(default_factory=list)
    moves: int = 0
    trigger: str = ""
    # job -> gang width: the job's members act as ONE placement unit (a chip
    # gang in member rank order, docs/SHARDING.md) instead of a dispatch
    # pool. Set when the model fits NO single member's HBM headroom but an
    # even ceil-share across `width` members fits each of them.
    gangs: dict[str, int] = field(default_factory=dict)


class PlacementAdvisor:
    """Turns profiler lanes into assignment plans. ``advise`` is called
    under the scheduler lock, so it must stay non-blocking and touch only
    leaf locks (the profiler's, the flight recorder's)."""

    MAX_WEIGHT = 8          # weight amplification cap per member
    REENTER_FRACTION = 0.7  # an excluded member re-enters below this x line

    def __init__(
        self,
        profiler: Any,
        *,
        flight: Any = None,
        metrics: Any = None,
        clock: Callable[[], float] = monotonic,
        max_moves: int = 2,
        window_s: float = 60.0,
        hysteresis: float = 0.15,
        exclude_factor: float = 3.0,
        stage: str = "dispatch",
        decode_idle: Callable[[str], float | None] | None = None,
        blob_locality: Callable[[str], float | None] | None = None,
        ingest_bias: float = 0.3,
        headroom: Callable[[str], float | None] | None = None,
        model_bytes: Callable[[str], float | None] | None = None,
    ) -> None:
        self.profiler = profiler
        self.flight = flight
        self.metrics = metrics
        self.clock = clock
        self.max_moves = int(max_moves)
        self.window_s = float(window_s)
        self.hysteresis = float(hysteresis)
        self.exclude_factor = float(exclude_factor)
        self.stage = stage
        # Ingest-aware placement (docs/INGEST.md §Decode tier): optional
        # per-member reads of idle decode lanes (the scraped
        # ``decode_lane_idle`` gauge) and SDFS blob locality (fraction of
        # the directory with a replica on that member). A member that can
        # FEED its chips is worth more than one that must pull every
        # pixel over the wire.
        self.decode_idle = decode_idle
        self.blob_locality = blob_locality
        self.ingest_bias = float(ingest_bias)
        # Memory-headroom HARD constraint (cluster/devicemon.py, docs/
        # OBSERVABILITY.md §8): per-member HBM headroom bytes (scraped
        # hbm_limit - hbm_in_use) and per-model analytic resident bytes.
        # A (job, member) pair whose KNOWN headroom cannot hold the KNOWN
        # model bytes is never assigned — unlike the ingest bias this is a
        # refusal, not a weighting. None on either side = no constraint
        # (unknown never blocks).
        self.headroom = headroom
        self.model_bytes = model_bytes
        self._last_blocked: dict[str, list[str]] = {}
        self._last_ingest: dict[str, float] = {}
        self._last_plan: PlacementPlan | None = None
        self._excluded: set[str] = set()
        self._moves_used = 0
        self._window_start: float | None = None
        # Replica targets (scheduler/autoscaler.py): per-job bound on how
        # many members the solver may deal to the job. The greedy dealer
        # naturally spreads every eligible member across jobs, so SHRINKING
        # the target is the actuation that matters (growing = raising it
        # back). For a gang job the target instead WIDENS the gang past its
        # minimal memory-fit width — more shards, more aggregate HBM
        # bandwidth — and never shrinks below what fits. Empty = unbounded
        # (pre-autoscaler behavior, bit for bit).
        self.replica_targets: dict[str, int] = {}

    def set_replica_target(self, job: str, target: int | None) -> None:
        """Bound (or, for gangs, widen to) ``target`` members for ``job``.
        None or <= 0 clears the bound."""
        if target is None or target <= 0:
            self.replica_targets.pop(job, None)
        else:
            self.replica_targets[job] = int(target)

    # ---- cost model ----------------------------------------------------

    def _costs(self, members: list[str]) -> tuple[dict[str, float], float]:
        """(per-member decayed mean dispatch cost, fleet median over the
        measured ones). Unmeasured members cost the median (innocent until
        profiled); with nothing measured anywhere, everyone costs 1.0."""
        measured = {}
        for m in members:
            c = self.profiler.mean_cost(m, stage=self.stage)
            if c is not None and c > 0:
                measured[m] = c
        if measured:
            ordered = sorted(measured.values())
            median = ordered[len(ordered) // 2]
        else:
            median = 1.0
        return {m: measured.get(m, median) for m in members}, median

    def _ingest_factors(self, members: list[str]) -> dict[str, float]:
        """Ingest-aware capacity multipliers: idle decode lanes (normalized
        to the fleet's best) and SDFS blob locality each add up to
        ``ingest_bias`` to a member's effective capacity — bounded
        [1, 1 + 2*bias], so ingest breaks ties and biases assignment but
        never overrides a measured dispatch-cost cliff. Empty when neither
        signal is wired (the pre-decode-tier behavior, bit for bit)."""
        if self.decode_idle is None and self.blob_locality is None:
            return {}
        idle: dict[str, float] = {}
        if self.decode_idle is not None:
            for m in members:
                try:
                    v = self.decode_idle(m)
                except Exception:
                    v = None
                if v is not None and v > 0:
                    idle[m] = float(v)
        max_idle = max(idle.values(), default=0.0)
        out: dict[str, float] = {}
        for m in members:
            f = 1.0
            if max_idle > 0:
                f += self.ingest_bias * idle.get(m, 0.0) / max_idle
            if self.blob_locality is not None:
                try:
                    loc = self.blob_locality(m)
                except Exception:
                    loc = None
                if loc:
                    f += self.ingest_bias * min(1.0, max(0.0, float(loc)))
            out[m] = round(f, 3)
        return out

    def _need_and_room(
        self, jobs: list[str], members: list[str]
    ) -> tuple[dict[str, float], dict[str, float]]:
        """(job -> known model resident bytes, member -> known HBM headroom
        bytes). Unknown on either side is simply absent (never constrains)."""
        need: dict[str, float] = {}
        room: dict[str, float] = {}
        if self.headroom is None or self.model_bytes is None:
            return need, room
        for job in jobs:
            try:
                b = self.model_bytes(job)
            except Exception:  # noqa: BLE001 - telemetry read; treat as unknown
                b = None
            if b is not None and b > 0:
                need[job] = float(b)
        for m in members:
            try:
                h = self.headroom(m)
            except Exception:  # noqa: BLE001 - telemetry read; treat as unknown
                h = None
            if h is not None:
                room[m] = float(h)
        return need, room

    def _blocked_pairs(
        self, jobs: list[str], members: list[str]
    ) -> dict[str, set[str]]:
        """job -> members that MUST NOT serve it solo: the member's reported
        HBM headroom (bytes) is known and smaller than the model's known
        analytic resident bytes. Either side unknown = unconstrained."""
        need, room = self._need_and_room(jobs, members)
        blocked: dict[str, set[str]] = {}
        for job, nbytes in need.items():
            bad = {m for m, h in room.items() if h < nbytes}
            if bad:
                blocked[job] = bad
        return blocked

    def _gang_plan(
        self,
        job: str,
        eligible: list[str],
        costs: dict[str, float],
        chip_weight: dict[str, int],
        need_bytes: float,
        room: dict[str, float],
    ) -> tuple[list[str], int] | None:
        """Trade replica count against shard width for a job NO single
        member can hold: the SMALLEST width whose even ceil-share of the
        model's resident bytes fits each chosen member's known headroom
        (minimal width leaves the most replica capacity for every other
        job). Members are chosen by cost-lane capacity — chip weight over
        measured dispatch cost — so the gang lands on the members that can
        actually feed it; unknown headroom never blocks, mirroring
        ``_blocked_pairs``. None when even the widest gang cannot fit."""
        ranked = sorted(
            eligible,
            key=lambda m: (
                -chip_weight.get(m, 1) / max(1e-9, costs.get(m, 1.0)),
                m,
            ),
        )
        for width in range(2, len(ranked) + 1):
            share = need_bytes / width
            fits = [m for m in ranked if room.get(m, float("inf")) >= share]
            if len(fits) >= width:
                want = self.replica_targets.get(job)
                if want is not None and want > width:
                    # Autoscaler asked for more fan-out than the minimal
                    # fit: widen while enough members hold the (smaller)
                    # per-shard share. Memory fit still wins — the target
                    # never narrows a gang below what fits.
                    for w2 in range(min(want, len(ranked)), width, -1):
                        share2 = need_bytes / w2
                        fits2 = [
                            m for m in ranked
                            if room.get(m, float("inf")) >= share2
                        ]
                        if len(fits2) >= w2:
                            return fits2[:w2], w2
                return fits[:width], width
        return None

    def _exclusions(self, costs: dict[str, float], median: float) -> set[str]:
        """Sticky outlier set: enter above ``exclude_factor`` x median,
        leave below ``REENTER_FRACTION`` x that line (hysteresis). Never
        excludes down to fewer members than jobs need — availability wins."""
        line = self.exclude_factor * median
        out = set()
        for m, c in sorted(costs.items()):
            if m in self._excluded:
                if c > self.REENTER_FRACTION * line:
                    out.add(m)
            elif c > line:
                out.add(m)
        return out

    @staticmethod
    def _plan_estimate(plan: PlacementPlan, jobs: dict[str, int],
                       costs: dict[str, float], chip_weight: dict[str, int]) -> float:
        """Estimated makespan: max over jobs of demand / service rate,
        where a member's rate is chips / measured cost."""
        worst = 0.0
        for name, members in plan.assignment.items():
            demand = max(1, jobs.get(name, 0))
            rate = sum(
                chip_weight.get(m, 1) / max(1e-9, costs.get(m, 1.0))
                for m in members
            )
            worst = max(worst, demand / rate if rate > 0 else float("inf"))
        return worst

    # ---- the solver ----------------------------------------------------

    def advise(
        self,
        jobs: dict[str, int],
        members: list[str],
        chip_weight: dict[str, int] | None = None,
        trigger: str = "periodic",
    ) -> PlacementPlan | None:
        """Solve job -> member placement from current profiles. ``jobs``
        maps job name to remaining demand (queries left); ``members`` is
        the eligible fleet (gray-demoted members already removed by the
        scheduler). Returns None when there is nothing to place (caller
        keeps its round-robin fallback)."""
        if not jobs or not members:
            return None
        chip_weight = chip_weight or {m: 1 for m in members}
        costs, median = self._costs(sorted(members))
        excluded = self._exclusions(costs, median)
        eligible = [m for m in sorted(members) if m not in excluded]
        if len(eligible) < len(jobs):
            # Not enough healthy members to give every job one: re-admit
            # the cheapest excluded members until every job can be served.
            readmit = sorted(excluded, key=lambda m: (costs[m], m))
            while len(eligible) < len(jobs) and readmit:
                back = readmit.pop(0)
                excluded.discard(back)
                eligible.append(back)
            eligible.sort()
        self._excluded = set(excluded)

        # Ingest-aware weighting AFTER exclusion (outliers are judged on
        # raw dispatch cost alone): a member's effective cost shrinks with
        # idle decode capacity and blob locality, which flows into both
        # the greedy deal below and the dispatch-pool weights.
        ingest = self._ingest_factors(sorted(members))
        self._last_ingest = ingest
        if ingest:
            costs = {m: c / ingest.get(m, 1.0) for m, c in costs.items()}

        # Hard headroom refusals, applied inside the solver: unlike the
        # exclusion set above (cost outliers, fleet-wide) a block is per
        # (job, member) — a member too full for vit_l14 may still serve
        # resnet18.
        blocked = self._blocked_pairs(sorted(jobs), sorted(members))
        self._last_blocked = {j: sorted(ms) for j, ms in sorted(blocked.items())}
        if blocked and self.metrics is not None:
            self.metrics.inc("placement_headroom_blocked")

        # Gang formation (docs/SHARDING.md): a job every eligible member is
        # blocked for is NOT refused — it becomes a chip gang wide enough
        # that each member's ceil-share of the model fits its headroom. Gang
        # jobs leave the solo solver (their members stay eligible for other
        # jobs' dispatch pools; the scheduler keeps the flows separate).
        need, room = self._need_and_room(sorted(jobs), sorted(members))
        gang_assign: dict[str, list[str]] = {}
        gang_width: dict[str, int] = {}
        solo_jobs = dict(jobs)
        for job in sorted(jobs):
            bad = blocked.get(job)
            if not bad or not eligible or not set(eligible) <= bad:
                continue
            got = self._gang_plan(
                job, eligible, costs, chip_weight, need[job], room
            )
            if got is None:
                continue  # truly unplaceable: _solve leaves it memberless
            gang_assign[job], gang_width[job] = got
            del solo_jobs[job]
            if self.metrics is not None:
                self.metrics.inc("placement_gangs_formed")

        plan = self._solve(solo_jobs, eligible, costs, chip_weight, blocked)
        for job, gang_members in gang_assign.items():
            plan.assignment[job] = list(gang_members)
            plan.weights[job] = {}
            plan.gangs[job] = gang_width[job]
        plan.excluded = sorted(excluded)
        plan.trigger = trigger

        previous = self._last_plan
        plan.moves = self._count_moves(previous, plan)
        now = self.clock()
        if self._window_start is None or now - self._window_start >= self.window_s:
            self._window_start = now
            self._moves_used = 0

        # A usable cached plan gates the new one behind hysteresis and the
        # move budget; a STALE one (departed members, missing jobs) never
        # does — reality already forced the change. Neither does a change
        # to the EXCLUSION set: exclusions are outlier/SLO-driven removals,
        # and the throughput estimate below would always score removing a
        # member as a loss (less capacity), burying the one change the
        # burn-rate alert exists to force.
        usable = previous is not None and not self._plan_stale(
            previous, jobs, set(members)
        )
        excluded_changed = previous is not None and (
            set(plan.excluded) != set(previous.excluded)
        )
        if usable and not excluded_changed:
            if (plan.moves == 0 and plan.assignment == previous.assignment
                    and plan.gangs == previous.gangs):
                return previous  # identical assignment: keep the cached object
            # Hysteresis: a reshuffle must buy a real improvement.
            old_est = self._plan_estimate(previous, jobs, costs, chip_weight)
            new_est = self._plan_estimate(plan, jobs, costs, chip_weight)
            improvement = (old_est - new_est) / old_est if old_est > 0 else 0.0
            if improvement < self.hysteresis:
                return previous
            # Move budget: bounded churn per window.
            if self._moves_used + plan.moves > self.max_moves:
                if self.metrics is not None:
                    self.metrics.inc("placement_throttled")
                if self.flight is not None:
                    self.flight.note(
                        "placement_throttled", trigger=trigger,
                        moves=plan.moves,
                        budget=self.max_moves - self._moves_used,
                    )
                return previous

        self._moves_used += plan.moves
        self._last_plan = plan
        if self.metrics is not None:
            self.metrics.inc("placement_decisions")
        if self.flight is not None:
            note = dict(
                trigger=trigger,
                moves=plan.moves,
                excluded=",".join(plan.excluded),
                assignment=";".join(
                    f"{n}={len(ms)}" for n, ms in sorted(plan.assignment.items())
                ),
            )
            if any(f > 1.0 for f in ingest.values()):
                # The ingest weighting is part of the routing decision, so
                # it must be reconstructible from the recorder (lint O2).
                note["ingest"] = ",".join(
                    f"{m}={f}" for m, f in sorted(ingest.items()) if f > 1.0
                )
            if blocked:
                # Headroom refusals shaped this plan — a postmortem of a
                # starved job must see WHICH members were refused (lint O2).
                note["headroom_blocked"] = ";".join(
                    f"{j}={','.join(sorted(ms))}" for j, ms in sorted(blocked.items())
                )
            if plan.gangs:
                # A gang is the plan's most consequential shape: which job
                # went multi-chip, how wide, on whom (lint O2).
                note["gangs"] = ";".join(
                    f"{j}:{w}={','.join(plan.assignment[j])}"
                    for j, w in sorted(plan.gangs.items())
                )
            if self.replica_targets:
                # Autoscaler bounds shaped this plan (lint O2).
                note["replica_targets"] = ",".join(
                    f"{j}={t}" for j, t in sorted(self.replica_targets.items())
                )
            self.flight.note("placement_decision", **note)
        return plan

    def _solve(
        self, jobs: dict[str, int], eligible: list[str],
        costs: dict[str, float], chip_weight: dict[str, int],
        blocked: dict[str, set[str]] | None = None,
    ) -> PlacementPlan:
        """Greedy balance: deal members (fastest first) to the job with the
        highest remaining demand per unit of capacity already granted.
        ``blocked`` pairs (headroom refusals) are never dealt — a job every
        member is blocked for ends up with NO members, which is the
        correct answer: dispatching it would OOM the member."""
        names = sorted(jobs)
        blocked = blocked or {}
        capacity = {
            m: chip_weight.get(m, 1) / max(1e-9, costs.get(m, 1.0))
            for m in eligible
        }
        granted = {n: 0.0 for n in names}
        assignment: dict[str, list[str]] = {n: [] for n in names}
        caps = self.replica_targets
        for m in sorted(eligible, key=lambda m: (-capacity[m], m)):
            # Most-starved job first: demand per granted capacity, with
            # empty jobs infinitely starved so everyone gets one member.
            candidates = [
                n for n in names
                if m not in blocked.get(n, ())
                and len(assignment[n]) < caps.get(n, len(eligible) + 1)
            ]
            if not candidates:
                continue  # member too full for every job this pass
            target = max(
                candidates,
                key=lambda n: (
                    float("inf") if not assignment[n]
                    else max(1, jobs[n]) / max(1e-9, granted[n]),
                    -len(assignment[n]),
                    # Most-constrained first on ties: a job refused on more
                    # members must take the members it CAN use, or an
                    # unconstrained peer drains them and strands it.
                    len(blocked.get(n, ())),
                    n,
                ),
            )
            assignment[target].append(m)
            granted[target] += capacity[m]
        weights: dict[str, dict[str, int]] = {}
        for n in names:
            ms = assignment[n]
            if not ms:
                weights[n] = {}
                continue
            # Normalize to the SLOWEST member: it anchors at weight 1 and
            # faster peers scale up with 1/cost (capped, so one fast member
            # cannot starve the interleave of everyone else).
            worst = max(costs.get(m, 1.0) for m in ms)
            weights[n] = {
                m: max(1, min(
                    self.MAX_WEIGHT * max(1, chip_weight.get(m, 1)),
                    round(chip_weight.get(m, 1) * worst / max(1e-9, costs.get(m, 1.0))),
                ))
                for m in ms
            }
        return PlacementPlan(assignment=assignment, weights=weights)

    @staticmethod
    def _count_moves(previous: PlacementPlan | None, plan: PlacementPlan) -> int:
        """Members newly added to a job they weren't serving before (the
        disruptive direction: a move re-points dispatch traffic)."""
        if previous is None:
            return 0
        moves = 0
        for name, ms in plan.assignment.items():
            before = set(previous.assignment.get(name, ()))
            moves += sum(1 for m in ms if m not in before)
        return moves

    def _plan_stale(self, previous: PlacementPlan, jobs: dict[str, int],
                    members: set[str]) -> bool:
        """A cached plan is unusable (bypasses hysteresis/budget) when it
        references departed members, misses a job entirely, or deals a job
        more SOLO members than its replica target allows — a shrink from
        the autoscaler must land this advise, not after the hysteresis
        gate happens to open."""
        for name in jobs:
            ms = previous.assignment.get(name)
            if not ms or any(m not in members for m in ms):
                return True
        for name, target in self.replica_targets.items():
            if name in previous.gangs:
                continue  # gang width is memory-driven; target only widens
            if len(previous.assignment.get(name, ())) > target:
                return True
        return False

    def status(self) -> dict:
        plan = self._last_plan
        return {
            "excluded": sorted(self._excluded),
            "moves_used": self._moves_used,
            "max_moves": self.max_moves,
            "window_s": self.window_s,
            "ingest_factors": {
                m: f for m, f in sorted(self._last_ingest.items()) if f > 1.0
            },
            "headroom_blocked": {
                j: list(ms) for j, ms in sorted(self._last_blocked.items())
            },
            "assignment": {} if plan is None else {
                n: list(ms) for n, ms in sorted(plan.assignment.items())
            },
            "gangs": {} if plan is None else dict(sorted(plan.gangs.items())),
            "replica_targets": dict(sorted(self.replica_targets.items())),
        }


__all__ = ["PlacementAdvisor", "PlacementPlan", "SloEvaluator", "SloObjective"]
