"""Clock abstraction: real time for deployment, simulated time for tests.

Copied from ``dmlc_tpu/cluster/clock.py`` (the whole module).

The reference's timing behavior (1 s heartbeats, 3 s failure timeout, 3 s
maintenance loops) was only ever validated by hand on live VMs (SURVEY.md §4).
Every time-dependent component here takes a Clock so the simulator can drive
whole failure/rejoin scenarios deterministically in milliseconds.
"""

from __future__ import annotations

import time
from typing import Callable


class Clock:
    # This class IS the injection boundary D1 points everything else at:
    # the one place real wall time may enter the cluster layer.
    def now(self) -> float:
        return time.time()  # dmlc-lint: disable=D1 -- Clock is the sanctioned wall-clock source

    def monotonic(self) -> float:
        return time.monotonic()  # dmlc-lint: disable=D1 -- Clock is the sanctioned wall-clock source


class SimClock(Clock):
    def __init__(self, start: float = 1_000_000.0):
        self._t = start

    def now(self) -> float:
        return self._t

    def monotonic(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time goes forward")
        self._t += dt


class TimerRegistry:
    """Named periodic timer bodies: the single dispatch point between a
    node's maintenance cadence and whoever drives it.

    In deployment each registered body is ticked by its own thread on the
    wall clock (node.py's ``_timer`` wraps ``_loop`` around ``fire``). Under
    dmlc-mc the SAME registrations become explicit schedule choices — the
    explorer fires timers in any order, any number of times — so the code a
    timer runs in production is byte-identical to the code the model checker
    interleaves (docs/MODELCHECK.md). Re-registering a name overwrites: a
    restarted component re-wires its timer without a stale body surviving."""

    def __init__(self) -> None:
        self._timers: dict[str, tuple[float, Callable[[], None]]] = {}

    def register(
        self, name: str, interval_s: float, body: Callable[[], None]
    ) -> None:
        self._timers[name] = (float(interval_s), body)

    def names(self) -> list[str]:
        return sorted(self._timers)

    def interval(self, name: str) -> float:
        return self._timers[name][0]

    def fire(self, name: str) -> None:
        """Run one tick of ``name``'s body on the caller's stack."""
        self._timers[name][1]()
