"""Latency drift sentinel: watch the critical-path plane, name the drift.

Copied from ``dmlc_tpu/cluster/sentinel.py`` (the whole module).

The critical-path analyzer (cluster/critpath.py) says where p99 goes
*right now*; this module says when that changed and whether one member is
to blame. On every leader scrape cycle ``DriftSentinel.tick`` receives
the folded fleet table, computes a high quantile of each (model, stage,
member) lane's RECENT self-time samples, and compares it against a
decay-weighted learned baseline (docs/OBSERVABILITY.md §9):

- **min-samples floor** — a lane with fewer than ``min_samples`` recent
  requests is never judged; thin tails lie.
- **quantile shift** — drifting when recent qNN exceeds
  ``drift_factor × baseline``. The baseline is an EWMA of the lane's
  quantile, updated only while the lane is healthy — a sustained
  regression must not launder itself into the baseline it is judged by.
- **hysteresis** — ``confirm_windows`` consecutive drifting ticks arm the
  alert; it clears only after the same number of healthy ticks below
  ``clear_factor × baseline`` (< drift_factor), so a lane flapping at the
  threshold cannot strobe the flight recorder.

On alert the sentinel raises a ``latency_drift`` flight event naming
(model, stage, member, q_s, baseline_s, share), opens a forced
trace-sampling window through the injected hook (the node wires
``obs.trace_ctl``'s force path) so the drift window is densely traced,
and — when the drift localizes to exactly one member for that (model,
stage) — requests a placement replan via the injected hook. Sans-IO:
no clocks, no RPC; ticks are the cadence.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable


class _LaneState:
    __slots__ = ("baseline", "streak", "clear_streak", "alert", "last_q",
                 "last_n")

    def __init__(self) -> None:
        self.baseline = float("nan")
        self.streak = 0
        self.clear_streak = 0
        self.alert = False
        self.last_q = float("nan")
        self.last_n = 0


def _quantile(samples: list[float], p: float) -> float:
    """Nearest-rank quantile; NaN when empty."""
    if not samples:
        return float("nan")
    ordered = sorted(samples)
    rank = max(0, math.ceil(max(0.0, min(100.0, p)) / 100.0 * len(ordered)) - 1)
    return ordered[rank]


class DriftSentinel:
    """Windowed latency-drift detector over fleet critical-path lanes.

    ``tick(table)`` consumes ``FleetCritPath.table()`` output. Callbacks:
    ``flight_note(kind, **fields)`` for flight events,
    ``force_sample(seconds)`` to open a forced trace-sampling window, and
    ``request_replan(reason)`` for member-localized drift. All optional —
    the loadgen sim harness and unit tests drive the same class bare."""

    def __init__(
        self,
        quantile: float = 90.0,
        drift_factor: float = 2.0,
        clear_factor: float = 1.3,
        min_samples: int = 20,
        confirm_windows: int = 3,
        baseline_decay: float = 0.8,
        force_sample_s: float = 30.0,
        flight_note: Callable[..., None] | None = None,
        force_sample: Callable[[float], None] | None = None,
        request_replan: Callable[[str], None] | None = None,
    ):
        if not (0.0 < baseline_decay < 1.0):
            raise ValueError(f"baseline_decay={baseline_decay} not in (0,1)")
        if clear_factor > drift_factor:
            raise ValueError(
                f"clear_factor={clear_factor} > drift_factor={drift_factor}: "
                "hysteresis must clear below the trip threshold"
            )
        self.quantile = float(quantile)
        self.drift_factor = float(drift_factor)
        self.clear_factor = float(clear_factor)
        self.min_samples = int(min_samples)
        self.confirm_windows = int(confirm_windows)
        self.baseline_decay = float(baseline_decay)
        self.force_sample_s = float(force_sample_s)
        self.flight_note = flight_note
        self.force_sample = force_sample
        self.request_replan = request_replan
        self._lanes: dict[tuple[str, str, str], _LaneState] = {}
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {
            "ticks": 0, "alerts": 0, "clears": 0, "replans": 0,
            "force_samples": 0,
        }

    # ---- the scrape-cadence heartbeat ---------------------------------

    def tick(self, table: dict[str, Any]) -> list[dict[str, Any]]:
        """Judge every lane in the folded fleet table; fire callbacks for
        newly-armed alerts. Returns the fired alert descriptors (tests and
        the cert read these without a flight recorder)."""
        fired: list[dict[str, Any]] = []
        cleared: list[tuple[str, str, str]] = []
        replans: list[str] = []
        with self._lock:
            self.counters["ticks"] += 1
            seen: set[tuple[str, str, str]] = set()
            for model, body in (table.get("models") or {}).items():
                for ln in body.get("lanes", ()):
                    key = (str(model), str(ln.get("stage")),
                           str(ln.get("member")))
                    seen.add(key)
                    st = self._lanes.setdefault(key, _LaneState())
                    samples = [float(s) for s in (ln.get("samples") or ())]
                    n = int(ln.get("recent_n", len(samples)))
                    q = _quantile(samples, self.quantile)
                    st.last_q, st.last_n = q, n
                    if n < self.min_samples or math.isnan(q):
                        continue  # thin or empty window: never judged
                    if math.isnan(st.baseline):
                        st.baseline = q  # first full window seeds it
                        continue
                    drifting = q > self.drift_factor * st.baseline
                    healthy = q <= self.clear_factor * st.baseline
                    if drifting:
                        st.streak += 1
                        st.clear_streak = 0
                        # Baseline frozen: suspected drift must not decay
                        # into the yardstick it is measured against.
                        if not st.alert and st.streak >= self.confirm_windows:
                            st.alert = True
                            share = float(ln.get("share", 0.0))
                            desc = {
                                "model": key[0], "stage": key[1],
                                "member": key[2], "q_s": q,
                                "baseline_s": st.baseline,
                                "factor": q / st.baseline
                                if st.baseline > 0 else float("inf"),
                                "share": round(share, 4),
                                "n": n,
                            }
                            fired.append(desc)
                    else:
                        st.streak = 0
                        if st.alert and healthy:
                            st.clear_streak += 1
                            if st.clear_streak >= self.confirm_windows:
                                st.alert = False
                                st.clear_streak = 0
                                cleared.append(key)
                        else:
                            st.clear_streak = 0
                        if not st.alert:
                            st.baseline = (
                                self.baseline_decay * st.baseline
                                + (1.0 - self.baseline_decay) * q
                            )
            # A lane that vanished from the table (member gone, model
            # drained) keeps its state but cannot flap: no samples, no
            # judgement. Bound the map against unbounded churn.
            if len(self._lanes) > 4096:
                for key in [k for k in self._lanes if k not in seen][:1024]:
                    del self._lanes[key]
            for desc in fired:
                self.counters["alerts"] += 1
                # Localization: replan only when exactly this one member
                # drifts for the (model, stage) — a stage slow EVERYWHERE
                # is a model/kernel problem placement cannot fix.
                peers = [
                    k for k, s in self._lanes.items()
                    if k[0] == desc["model"] and k[1] == desc["stage"]
                    and s.alert
                ]
                if len(peers) == 1:
                    replans.append(
                        f"latency_drift:{desc['model']}:{desc['stage']}"
                        f":{desc['member']}"
                    )
        for desc in fired:
            if self.flight_note is not None:
                self.flight_note("latency_drift", **desc)
            if self.force_sample is not None:
                self.counters["force_samples"] += 1
                self.force_sample(self.force_sample_s)
                if self.flight_note is not None:
                    self.flight_note(
                        "drift_force_sample", seconds=self.force_sample_s,
                        model=desc["model"], stage=desc["stage"],
                        member=desc["member"],
                    )
        for reason in replans:
            self.counters["replans"] += 1
            if self.request_replan is not None:
                self.request_replan(reason)
            if self.flight_note is not None:
                self.flight_note("drift_replan_request", reason=reason)
        for key in cleared:
            self.counters["clears"] += 1
            if self.flight_note is not None:
                st = self._lanes[key]
                self.flight_note(
                    "latency_drift_clear", model=key[0], stage=key[1],
                    member=key[2], q_s=st.last_q, baseline_s=st.baseline,
                )
        return fired

    # ---- introspection -------------------------------------------------

    def status(self) -> dict[str, Any]:
        """Wire-safe snapshot for obs.critpath / the CLI: every judged
        lane's baseline, latest quantile, streaks, and alert flag."""
        def _safe(x: float) -> float | None:
            return None if math.isnan(x) else x

        with self._lock:
            lanes = [
                {
                    "model": k[0], "stage": k[1], "member": k[2],
                    "baseline_s": _safe(st.baseline),
                    "q_s": _safe(st.last_q), "n": st.last_n,
                    "streak": st.streak, "alert": st.alert,
                }
                for k, st in sorted(self._lanes.items())
            ]
            return {
                "quantile": self.quantile,
                "drift_factor": self.drift_factor,
                "clear_factor": self.clear_factor,
                "min_samples": self.min_samples,
                "confirm_windows": self.confirm_windows,
                "counters": dict(self.counters),
                "lanes": lanes,
                "alerts": [ln for ln in lanes if ln["alert"]],
            }

    def alerting(self) -> list[tuple[str, str, str]]:
        with self._lock:
            return sorted(k for k, st in self._lanes.items() if st.alert)


__all__ = ["DriftSentinel"]
