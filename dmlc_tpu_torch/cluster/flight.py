"""Flight recorder: a bounded per-node ring of structured state-change events.

Copied from ``dmlc_tpu/cluster/flight.py`` (the whole module).

Postmortems of chaos-suite failures have so far meant log archaeology:
the counters (utils/metrics.Counters) say HOW MANY times a breaker opened
or a member was gray-demoted, but not WHEN relative to what. This module
records the state transitions themselves — breaker open/close, gray
demote/restore, quarantine, shed, scrub verdicts, maintenance-loop crashes
— into a fixed-size ring with monotonic timestamps (docs/OBSERVABILITY.md).

Properties:

- **Bounded**: a ``deque(maxlen=capacity)`` — the newest ``capacity``
  events survive, the total ever recorded is counted, so a wrapped ring is
  visibly wrapped.
- **Cheap**: one dict append under a lock per *state transition* (these are
  rare by construction; the hot request path only touches the recorder
  when it sheds).
- **Durable on trouble**: ``dump()`` writes the ring through
  ``diskio.atomic_write``; the node auto-dumps on maintenance-loop crashes
  and at shutdown, and the ring is fetchable live over ``obs.flight``.

Sans-IO: the clock is injected (``Clock.monotonic`` in deployment, the
virtual clock in tests) so simulated incident timelines replay exactly.
"""

from __future__ import annotations

import json
import logging
import threading
from collections import deque
from pathlib import Path
from time import monotonic
from typing import Callable

from dmlc_tpu_torch.cluster.diskio import atomic_write

log = logging.getLogger(__name__)


class FlightRecorder:
    """One node's event ring. ``note()`` is safe from any thread."""

    def __init__(
        self,
        capacity: int = 2048,
        clock: Callable[[], float] = monotonic,
        node: str = "",
    ):
        self.capacity = int(capacity)
        self.clock = clock
        self.node = node
        self._ring: deque = deque(maxlen=self.capacity)
        self._recorded = 0
        self._lock = threading.Lock()

    def note(self, kind: str, **fields) -> None:
        """Record one state transition. ``kind`` is a snake_case event name
        (docs/OBSERVABILITY.md lists the schema); ``fields`` must be
        wire-serializable scalars/strings."""
        event = {"t": self.clock(), "kind": kind, **fields}
        with self._lock:
            self._ring.append(event)
            self._recorded += 1

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def to_wire(self) -> dict:
        """The ``obs.flight`` reply: the surviving events plus enough
        bookkeeping to see whether (and how far) the ring wrapped."""
        with self._lock:
            return {
                "node": self.node,
                "capacity": self.capacity,
                "recorded": self._recorded,
                "dropped": max(0, self._recorded - len(self._ring)),
                "events": list(self._ring),
            }

    def dump(self, path: str | Path, reason: str = "") -> bool:
        """Write the ring to disk (temp -> fsync -> rename, so a crash
        mid-dump never leaves a torn postmortem). Best-effort by contract:
        a full disk must not turn an ejection into a crash. Returns
        whether the write landed."""
        doc = self.to_wire()
        if reason:
            doc["dump_reason"] = reason
        try:
            atomic_write(Path(path), json.dumps(doc, default=str).encode())
            return True
        except OSError:
            log.warning("flight-recorder dump to %s failed", path, exc_info=True)
            return False
