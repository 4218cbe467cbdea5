"""Burn-rate-driven elastic actuator: grow what burns, shrink what's idle.

Copied from ``dmlc_tpu/scheduler/autoscaler.py`` (the whole module).

The fleet already *measures* everything the scaling decision needs — the
multiwindow SLO burn rate (scheduler/placement.SloEvaluator), per-lane
dispatch cost (cluster/profile.CostProfiler), and device-plane HBM
occupancy (cluster/devicemon) — but until now a human read those dashboards
and turned the knobs. This module closes the loop. It is deliberately
sans-IO (lint D1): no threads, no clocks of its own beyond the injected
timebase, no RPC. The leader's observability loop calls ``tick`` right
after ``SloEvaluator.evaluate`` with the set of burning lanes, and the
autoscaler actuates registered :class:`ScaleTarget` seams:

- decode-tier fan-out (cluster/decodetier.DecodeTierClient.set_fanout),
- generate slot-table width and page-pool budget
  (generate/slots.SlotScheduler.set_limits),
- per-model replica targets, gangs included
  (scheduler/placement.PlacementAdvisor.set_replica_target).

Control discipline mirrors the PlacementAdvisor's (docs/OPERATIONS.md):

- **Scale up on the burn edge.** A fast-burn lane grows every target whose
  model matches, multiplicatively (x1.5, at least +1) — a 10x flash crowd
  reaches any reachable capacity within a few fast-burn windows instead of
  creeping one unit per tick.
- **Scale down only after quiet.** ``clear_windows`` consecutive clear
  ticks are required before shrinking, and the shrink is a single step —
  asymmetric hysteresis, because a premature shrink re-triggers the burn
  it just cleared (the classic autoscaler flap).
- **Moves budget.** At most ``moves_budget`` actuations per tick; the rest
  wait for the next evaluation.
- **HBM guard.** A memory-bound target never grows while the fleet's worst
  device is above ``hbm_ceiling`` occupancy — growing the slot table on a
  full HBM converts an SLO problem into an OOM.

Every decision — up, down, and the *refusals* (budget spent, HBM guard) —
is flight-recorded with its trigger and the signal values that justified
it (lint O2: this module reads profiles and steers the fleet, so its
reasoning must be reconstructible from the recorder), and kept in a ring
the CLI renders (``dmlc status`` / ``dmlc tenants``).
"""

from __future__ import annotations

from time import monotonic
from typing import Any, Callable, Iterable, Mapping

__all__ = ["Autoscaler", "ScaleTarget"]


class ScaleTarget:
    """One elastic knob: a name, a reader, an actuator, and bounds.

    ``get`` returns the current setting; ``apply`` sets a new one and
    returns what actually took effect (seams clamp — the decision record
    stores the effective value, not the wish). ``models`` restricts which
    burning lanes drive this target (None = any burn in the fleet);
    lanes are matched on their model part, so the per-tenant composite
    ``llm-7b@acme`` drives a target registered for ``llm-7b``.
    ``memory_bound`` targets answer to the HBM guard on the way up.

    ``drain`` gates the way DOWN (scale-down-through-drain): a
    shrink that would abandon live work — generation slots mid-decode, a
    member holding resident sessions — first asks ``drain(proposed)``.
    True means the capacity is already clear and the shrink applies; False
    means a drain was *initiated* (sessions finishing or migrating) and
    the shrink holds, visibly, until a later quiet tick finds it clear.
    """

    def __init__(
        self,
        name: str,
        *,
        get: Callable[[], int],
        apply: Callable[[int], int],
        lo: int = 1,
        hi: int = 64,
        models: Iterable[str] | None = None,
        memory_bound: bool = False,
        drain: Callable[[int], bool] | None = None,
    ) -> None:
        self.name = name
        self.get = get
        self.apply = apply
        self.lo = int(lo)
        self.hi = int(hi)
        self.models = frozenset(models) if models is not None else None
        self.memory_bound = bool(memory_bound)
        self.drain = drain

    def matches(self, burning_models: set[str]) -> bool:
        if self.models is None:
            return bool(burning_models)
        return bool(self.models & burning_models)


class Autoscaler:
    """Sans-IO scaling brain: feed it burn verdicts, it turns knobs."""

    GROWTH = 1.5  # multiplicative scale-up factor (at least +1 per move)

    def __init__(
        self,
        *,
        flight: Any = None,
        metrics: Any = None,
        clock: Callable[[], float] = monotonic,
        clear_windows: int = 3,
        moves_budget: int = 2,
        hbm_ceiling: float = 0.9,
        hbm_used: Callable[[], float | None] | None = None,
        history: int = 64,
    ) -> None:
        self.flight = flight
        self.metrics = metrics
        self.clock = clock
        self.clear_windows = max(1, int(clear_windows))
        self.moves_budget = max(1, int(moves_budget))
        self.hbm_ceiling = float(hbm_ceiling)
        # Worst-device HBM occupancy fraction (devicemon scrape), None when
        # the device plane is dark — unknown never blocks, mirroring the
        # PlacementAdvisor's headroom stance.
        self.hbm_used = hbm_used
        self.history = max(1, int(history))
        self.targets: list[ScaleTarget] = []
        self._clear_streak: dict[str, int] = {}
        self._seq = 0
        self.decisions: list[dict[str, Any]] = []
        self.ticks = 0

    def register(self, target: ScaleTarget) -> ScaleTarget:
        self.targets.append(target)
        self._clear_streak[target.name] = 0
        return target

    # ---- decision engine -------------------------------------------------

    def _record(self, **fields: Any) -> dict[str, Any]:
        self._seq += 1
        decision = {"seq": self._seq, "t": round(self.clock(), 3), **fields}
        self.decisions.append(decision)
        del self.decisions[: -self.history]
        if self.flight is not None:
            self.flight.note("autoscale_decision", **{
                k: v for k, v in decision.items() if v is not None
            })
        if self.metrics is not None:
            self.metrics.inc(f"autoscale_{fields.get('direction', 'hold')}")
        return decision

    def _grow(self, cur: int, hi: int) -> int:
        return min(hi, max(cur + 1, int(cur * self.GROWTH)))

    def tick(
        self,
        burning: Iterable[str],
        burn_values: Mapping[str, float] | None = None,
    ) -> list[dict[str, Any]]:
        """One control step. ``burning`` is SloEvaluator.burning_models()
        output — lanes, including per-tenant composites ``model@tenant``.
        Returns the decisions made this tick (also flight-recorded and
        kept in ``self.decisions`` for the status plane)."""
        self.ticks += 1
        lanes = sorted(set(burning))
        burning_models = {lane.split("@", 1)[0] for lane in lanes}
        burn_values = burn_values or {}
        try:
            hbm = self.hbm_used() if self.hbm_used is not None else None
        except Exception:  # noqa: BLE001 - telemetry read; treat as unknown
            hbm = None
        moves = 0
        out: list[dict[str, Any]] = []
        for target in self.targets:
            cur = int(target.get())
            if target.matches(burning_models):
                self._clear_streak[target.name] = 0
                trigger_lane = next(
                    (ln for ln in lanes
                     if target.models is None
                     or ln.split("@", 1)[0] in target.models),
                    lanes[0] if lanes else "",
                )
                trigger = f"slo_fast_burn:{trigger_lane}"
                burn = burn_values.get(trigger_lane)
                if cur >= target.hi:
                    continue  # already at ceiling: nothing to decide
                if moves >= self.moves_budget:
                    out.append(self._record(
                        target=target.name, direction="hold", at=cur,
                        trigger=trigger, reason="moves_budget",
                        burn=burn,
                    ))
                    continue
                if (target.memory_bound and hbm is not None
                        and hbm > self.hbm_ceiling):
                    # Growing a memory-holding knob on a full device trades
                    # an SLO breach for an OOM; refuse, visibly.
                    out.append(self._record(
                        target=target.name, direction="hold", at=cur,
                        trigger=trigger, reason="hbm_guard",
                        hbm_used=round(hbm, 3), burn=burn,
                    ))
                    continue
                effective = int(target.apply(self._grow(cur, target.hi)))
                moves += 1
                out.append(self._record(
                    target=target.name, direction="up",
                    from_=cur, to=effective, trigger=trigger, burn=burn,
                    hbm_used=None if hbm is None else round(hbm, 3),
                ))
            else:
                streak = self._clear_streak[target.name] = (
                    self._clear_streak[target.name] + 1
                )
                if cur <= target.lo or streak < self.clear_windows:
                    continue
                if moves >= self.moves_budget:
                    continue  # quiet shrink can always wait a tick
                proposed = max(target.lo, cur - 1)
                if target.drain is not None and not target.drain(proposed):
                    # Scale-down goes through drain, never through
                    # abandonment: the seam started draining the excess
                    # capacity; the shrink lands once it reports clear.
                    out.append(self._record(
                        target=target.name, direction="hold", at=cur,
                        trigger=f"slo_clear:{streak}w", reason="draining",
                    ))
                    continue
                effective = int(target.apply(proposed))
                moves += 1
                out.append(self._record(
                    target=target.name, direction="down",
                    from_=cur, to=effective,
                    trigger=f"slo_clear:{streak}w",
                ))
        return out

    # ---- status plane ----------------------------------------------------

    def status(self) -> dict[str, Any]:
        """CLI/status shape: per-target setting + clear streak, the last
        decision, and the recent decision ring."""
        return {
            "ticks": self.ticks,
            "clear_windows": self.clear_windows,
            "moves_budget": self.moves_budget,
            "hbm_ceiling": self.hbm_ceiling,
            "targets": {
                t.name: {
                    "current": int(t.get()),
                    "lo": t.lo,
                    "hi": t.hi,
                    "clear_streak": self._clear_streak.get(t.name, 0),
                    "memory_bound": t.memory_bound,
                }
                for t in self.targets
            },
            "last_decision": self.decisions[-1] if self.decisions else None,
            "decisions": list(self.decisions[-8:]),
        }
