"""Trace spans: lightweight instrumentation for the cluster and device path.

The reference's only observability is per-query `Instant` timing at the
scheduler (src/services.rs:419-424) plus log lines. Here every subsystem can
open named spans (thread-safe, ~no overhead when disabled); the collector
exports

- per-name aggregates (count/mean/percentiles via LatencyStats), and
- Chrome trace-event JSON (chrome://tracing / Perfetto compatible) for
  timeline inspection of e.g. decode vs device-dispatch overlap.

Spans are DISTRIBUTED (docs/OBSERVABILITY.md): each span records the
``trace_id``/``span_id``/``parent_id`` of the ambient trace context
(cluster/tracectx.py), which the RPC fabrics carry hop to hop in the frame
field ``t`` — so a leader-dispatch span, the member's predict span, and the
SDFS replica's fetch span all share one trace with correct parent edges,
and ``obs.trace_dump`` + the leader-side merge (cluster/observe.py) render
them as one fleet-wide timeline.

``lane`` is the serving-node identity ambient at record time: RPC servers
bind their node's member address around method execution, so a process
hosting several nodes (the localcluster harness) can still attribute every
span to the node that executed it — it becomes the Perfetto pid lane.

Device work is asynchronous under JAX; callers that want true device time
wrap the block_until_ready boundary (as InferenceEngine.run_batch does).
"""

from __future__ import annotations

import contextvars
import json
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

from dmlc_tpu_torch.cluster import tracectx
from dmlc_tpu_torch.utils.metrics import LatencyStats


@dataclass
class SpanRecord:
    name: str
    start_s: float
    duration_s: float
    thread_id: int
    attrs: dict = field(default_factory=dict)
    trace_id: str | None = None
    span_id: str | None = None
    parent_id: str | None = None
    lane: str | None = None


# ---------------------------------------------------------------------------
# Lane: which node is executing (ambient; the Perfetto pid dimension)
# ---------------------------------------------------------------------------

_lane: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "dmlc_trace_lane", default=None
)


def current_lane() -> str | None:
    return _lane.get()


@contextmanager
def lane(name: str | None) -> Iterator[None]:
    """Bind the executing-node identity for the dynamic extent of the
    block. RPC servers bind their node's member address here; node
    maintenance threads bind it at spawn. None leaves the ambient lane."""
    if name is None:
        yield
        return
    token = _lane.set(name)
    try:
        yield
    finally:
        _lane.reset(token)


class Tracer:
    """Span collector. Disabled by default; enabling costs one branch per
    span entry. Bounded: keeps aggregates forever, raw events up to
    ``max_events`` — newest raw spans are dropped past that, aggregates
    stay exact, and every drop is COUNTED (``dropped_events``) so a
    truncated timeline is visibly truncated instead of silently short.

    Head-based sampling (docs/OBSERVABILITY.md §7): each fresh ROOT trace
    is kept with probability ``effective_rate``; the decision rides the
    wire in the ``t`` frame field so every hop of an unsampled request
    skips raw span storage (aggregates — the profiler's food — stay exact
    for every request). An adaptive controller shrinks/regrows the rate
    toward a spans/s budget, and spans that end in an exception are
    recorded REGARDLESS of the bit, so error and deadline-exceeded
    requests always survive into the merged fleet timeline."""

    MIN_SAMPLE_RATE = 1e-3

    def __init__(self, max_events: int = 100_000):
        self.enabled = False
        self.max_events = max_events
        self._events: list[SpanRecord] = []
        self._dropped = 0
        self.resets = 0  # bumped by reset(); cursor-based drains re-seek
        self._aggregates: dict[str, LatencyStats] = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # --- head-based sampling state (all guarded by self._lock) ---
        self.sample_rate = 1.0            # configured base rate for roots
        self.spans_per_s_budget = 0.0     # adaptive target; 0 = controller off
        self.adapt_window_s = 5.0
        self._effective_rate = 1.0
        self._srng = random.Random(0x5A3B1E)  # sampling is a label, not control flow
        self._sample_clock = time.monotonic
        self._sampled_roots = 0
        self._unsampled_roots = 0
        self._forced_records = 0
        self._window_start: float | None = None
        self._window_records = 0
        self._force_until: float | None = None

    def now(self) -> float:
        """The tracer's own clock (seconds since construction/reset) — the
        timebase every SpanRecord.start_s lives in. ``obs.clock`` echoes
        this so the leader-side merge can align per-node timelines."""
        return time.perf_counter() - self._t0

    @contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield
            return
        if tracectx.current() is None:
            ctx = tracectx.child(sampled=self._decide_root())
        else:
            ctx = tracectx.child()
        start = time.perf_counter()
        error: BaseException | None = None
        try:
            with tracectx.bind(ctx):
                yield
        except BaseException as e:
            error = e
            raise
        finally:
            dur = time.perf_counter() - start
            if error is not None:
                attrs = dict(attrs, error=type(error).__name__)
                if not ctx.sampled:
                    attrs["forced"] = "error"
            rec = SpanRecord(
                name, start - self._t0, dur, threading.get_ident(), attrs,
                trace_id=ctx.trace_id, span_id=ctx.span_id,
                parent_id=ctx.parent_id, lane=_lane.get(),
            )
            with self._lock:
                self._aggregates.setdefault(name, LatencyStats()).record(dur)
                # Forced sampling: a span that raised is stored even when
                # the head decision said drop — every enclosing span of the
                # failing request sees the same exception on unwind, so the
                # whole local chain survives into the merged trace.
                if ctx.sampled or error is not None:
                    if error is not None and not ctx.sampled:
                        self._forced_records += 1
                    self._append_locked(rec)

    def record(self, name: str, duration_s: float, **attrs) -> None:
        """Record an externally-timed duration (e.g. device execution) as a
        leaf span under the ambient trace context."""
        if not self.enabled:
            return
        ctx = tracectx.child()
        rec = SpanRecord(
            name, time.perf_counter() - self._t0 - duration_s, duration_s,
            threading.get_ident(), attrs,
            trace_id=ctx.trace_id, span_id=ctx.span_id,
            parent_id=ctx.parent_id, lane=_lane.get(),
        )
        with self._lock:
            self._aggregates.setdefault(name, LatencyStats()).record(duration_s)
            if ctx.sampled:
                self._append_locked(rec)

    def _append_locked(self, rec: SpanRecord) -> None:
        self._window_records += 1
        if len(self._events) < self.max_events:
            self._events.append(rec)
        else:
            self._dropped += 1

    # ---- head-based sampling -------------------------------------------

    def set_sampling(self, rate=None, spans_per_s=None, clock=None) -> None:
        """Configure head sampling: ``rate`` is the base keep-probability
        for fresh roots (clamped to [0, 1]); ``spans_per_s`` a storage
        budget the adaptive controller steers the effective rate toward
        (0 disables adaptation); ``clock`` overrides the controller's
        timebase (the sim harness injects its virtual clock)."""
        with self._lock:
            if rate is not None:
                self.sample_rate = max(0.0, min(1.0, float(rate)))
                self._effective_rate = self.sample_rate
            if spans_per_s is not None:
                self.spans_per_s_budget = max(0.0, float(spans_per_s))
                if self.spans_per_s_budget <= 0.0:
                    self._effective_rate = self.sample_rate
            if clock is not None:
                self._sample_clock = clock
            self._window_start = None
            self._window_records = 0

    def force_sampling(self, seconds: float) -> None:
        """Sample every fresh root for the next ``seconds`` regardless of
        rate — the SLO-burn hook: when a model is burning budget, the
        leader wants whole traces, not a 1% lottery."""
        with self._lock:
            until = self._sample_clock() + float(seconds)
            if self._force_until is None or until > self._force_until:
                self._force_until = until

    def _decide_root(self) -> bool:
        with self._lock:
            now = self._sample_clock()
            if self._force_until is not None and now < self._force_until:
                self._sampled_roots += 1
                return True
            self._maybe_adapt_locked(now)
            r = self._effective_rate
            sampled = r >= 1.0 or (r > 0.0 and self._srng.random() < r)
            if sampled:
                self._sampled_roots += 1
            else:
                self._unsampled_roots += 1
            return sampled

    def _maybe_adapt_locked(self, now: float) -> None:
        if self.spans_per_s_budget <= 0.0:
            return
        if self._window_start is None:
            self._window_start = now
            self._window_records = 0
            return
        dt = now - self._window_start
        if dt < self.adapt_window_s:
            return
        observed = self._window_records / dt
        budget = self.spans_per_s_budget
        if observed > budget:
            # Over budget: cut proportionally (a 10x overshoot drops the
            # rate 10x in one window, not by baby steps).
            self._effective_rate = max(
                self.MIN_SAMPLE_RATE, self._effective_rate * budget / observed
            )
        elif observed < 0.5 * budget:
            # Comfortably under: regrow gently toward the base rate.
            self._effective_rate = min(self.sample_rate, self._effective_rate * 1.5)
        self._window_start = now
        self._window_records = 0

    def sampling_summary(self) -> dict:
        """Root decisions + controller state, surfaced via ``obs.metrics``
        so the adaptive behavior is observable fleet-wide."""
        with self._lock:
            total = self._sampled_roots + self._unsampled_roots
            return {
                "sampled": self._sampled_roots,
                "unsampled": self._unsampled_roots,
                "forced_records": self._forced_records,
                "base_rate": self.sample_rate,
                "effective_rate": self._effective_rate,
                "spans_per_s_budget": self.spans_per_s_budget,
                "observed_rate": (self._sampled_roots / total) if total else 1.0,
            }

    # ---- reporting -----------------------------------------------------

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._dropped

    def summary(self) -> dict:
        """Per-name aggregate summaries. When raw spans were dropped past
        ``max_events`` the count rides along under the reserved
        ``dropped_events`` key (absent otherwise, so the common case keeps
        its pure name->stats shape)."""
        with self._lock:
            out: dict = {
                name: st.summary() for name, st in sorted(self._aggregates.items())
            }
            if self._dropped:
                out["dropped_events"] = self._dropped
            return out

    @property
    def event_count(self) -> int:
        """Raw spans currently buffered — with ``resets``, the cursor
        contract for incremental drains (``events_wire(offset=...)``)."""
        with self._lock:
            return len(self._events)

    def events_wire(self, lane: str | None = None, offset: int = 0) -> list[dict]:
        """Raw spans in wire form for ``obs.trace_dump``. With ``lane``
        given, only spans executed under that lane (plus unlaned spans —
        in production one process is one node, so ambient work with no
        serving scope still belongs to it). ``offset`` skips already-seen
        spans (the buffer is append-only between resets, so an index plus
        the ``resets`` counter is a stable drain cursor)."""
        with self._lock:
            events = self._events[offset:] if offset > 0 else list(self._events)
        out = []
        for e in events:
            if lane is not None and e.lane is not None and e.lane != lane:
                continue
            out.append(
                {
                    "name": e.name,
                    "start": e.start_s,
                    "dur": e.duration_s,
                    "tid": e.thread_id % 1_000_000,
                    "trace": e.trace_id,
                    "span": e.span_id,
                    "parent": e.parent_id,
                    "lane": e.lane,
                    "attrs": dict(e.attrs),
                }
            )
        return out

    def chrome_trace(self) -> list[dict]:
        """Trace-event JSON objects (phase 'X' = complete events, µs)."""
        with self._lock:
            events = list(self._events)
        out = []
        for e in events:
            args = dict(e.attrs)
            if e.trace_id is not None:
                args.update(trace=e.trace_id, span=e.span_id)
                if e.parent_id is not None:
                    args["parent"] = e.parent_id
            if e.lane is not None:
                args["lane"] = e.lane
            out.append(
                {
                    "name": e.name,
                    "ph": "X",
                    "ts": e.start_s * 1e6,
                    "dur": e.duration_s * 1e6,
                    "pid": 0,
                    "tid": e.thread_id % 1_000_000,
                    "args": args,
                }
            )
        return out

    def export(self, path: str | Path) -> None:
        doc: dict = {"traceEvents": self.chrome_trace()}
        dropped = self.dropped_events
        if dropped:
            # Visible truncation: Perfetto shows otherData in the trace
            # info pane, so a timeline missing its tail says so.
            doc["otherData"] = {
                "dropped_events": dropped,
                "note": f"timeline truncated: {dropped} span(s) past "
                        f"max_events={self.max_events} were not recorded",
            }
        Path(path).write_text(json.dumps(doc))

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._aggregates.clear()
            self._dropped = 0
            self.resets += 1
            self._t0 = time.perf_counter()
            self._sampled_roots = 0
            self._unsampled_roots = 0
            self._forced_records = 0
            self._window_start = None
            self._window_records = 0
            self._force_until = None


# Process-global tracer: subsystems import this; tools flip .enabled.
tracer = Tracer()


def enable() -> Tracer:
    tracer.enabled = True
    return tracer


def disable() -> None:
    tracer.enabled = False


# ---------------------------------------------------------------------------
# RPC handler instrumentation (lint rule O1's contract)
# ---------------------------------------------------------------------------


def traced(method_name: str, fn):
    """Wrap one RPC handler so it executes under a ``rpc/<method>`` span.
    The span parents onto the caller's wire context (which the serving
    layer binds ambiently), so the cross-process edge is recorded here —
    once, for every handler, instead of per-handler boilerplate. Idempotent:
    an already-wrapped handler passes through."""
    if getattr(fn, "_dmlc_traced", False):
        return fn

    def handler(payload: dict, _fn=fn, _span_name=f"rpc/{method_name}") -> dict:
        with tracer.span(_span_name):
            return _fn(payload)

    handler._dmlc_traced = True  # type: ignore[attr-defined]
    handler.__name__ = getattr(fn, "__name__", method_name)
    handler.__wrapped__ = fn  # type: ignore[attr-defined]
    return handler


def traced_methods(table: dict) -> dict:
    """Wrap a whole RPC method table (the form lint rule O1 requires every
    ``methods()`` to return): each handler runs under its ``rpc/<method>``
    span. Safe to nest — tables merged from already-traced sub-tables are
    not double-wrapped."""
    return {name: traced(name, fn) for name, fn in table.items()}
