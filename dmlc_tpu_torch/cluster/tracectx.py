"""Distributed trace context: one causal identity for a whole request tree.

Mirrors ``cluster/deadline.py``: an ambient ``contextvars`` binding that the
RPC fabrics propagate hop to hop, so a predict request can be followed
leader -> member -> SDFS replica without any call site threading trace
arguments through. The pieces (docs/OBSERVABILITY.md):

- ``TraceContext`` — ``(trace_id, span_id, parent_id)``. ``trace_id`` names
  the whole request tree; ``span_id`` is the innermost *active* span, which
  becomes the parent of anything opened (locally or remotely) beneath it.
- an ambient binding (``bind``/``current``): ``utils/tracing.Tracer.span``
  binds a child context for its dynamic extent, and the RPC server binds
  the caller's wire context around method execution — so a handler's first
  span parents onto the caller's span across the process boundary.
- a wire form (frame field ``t``, alongside the deadline field ``d`` in
  cluster/rpc.py): ``[trace_id, span_id, sampled]`` — two 16-hex-char
  strings plus the head-sampling bit (0/1), ~40 bytes per frame. The field
  is OMITTED entirely when no context is bound (tracing disabled costs zero
  frame bytes). Old peers that ship only two elements are read as sampled
  (they predate sampling and always recorded), and readers index only the
  elements they know, so the dialect is extensible both ways.
- a ``sampled`` bit: decided ONCE at the root span (head-based sampling,
  utils/tracing.Tracer) and inherited by every child, locally and across
  the wire — so a whole request tree is either kept or dropped together
  and the merged fleet timeline never shows half a request.

IDs come from ``os.urandom`` (not the process-global ``random`` state, so
sans-IO determinism of the simulator is untouched — trace ids are labels,
never control flow).
"""

from __future__ import annotations

import contextvars
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator


@dataclass(frozen=True)
class TraceContext:
    trace_id: str
    span_id: str
    parent_id: str | None = None
    # Head-based sampling decision for the WHOLE trace, made at the root
    # span and inherited by every descendant (never re-decided mid-tree).
    # Unsampled spans still propagate identity — errors can force-record
    # against the same trace_id — they just skip raw span storage.
    sampled: bool = True


def new_id() -> str:
    """A 64-bit random hex id (8 bytes — the Perfetto/W3C span-id width)."""
    return os.urandom(8).hex()


_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "dmlc_tracectx", default=None
)


def current() -> TraceContext | None:
    """The ambient trace context bound by the innermost span/serving scope."""
    return _current.get()


@contextmanager
def bind(ctx: TraceContext | None) -> Iterator[TraceContext | None]:
    """Make ``ctx`` ambient for the dynamic extent of the block. Binding
    ``None`` *clears* any inherited context — the RPC server does exactly
    that for frames that carried no ``t`` field, so the sim fabric (which
    dispatches on the caller's stack) has the same propagation semantics as
    the TCP fabric (which crosses a process boundary)."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def child(parent: TraceContext | None = None, sampled: bool | None = None) -> TraceContext:
    """A new span context under ``parent`` (default: the ambient context),
    or a fresh root trace when there is no parent. ``sampled`` applies only
    to fresh roots (the head decision, made by the Tracer); children always
    inherit their parent's bit."""
    p = parent if parent is not None else _current.get()
    if p is None:
        return TraceContext(
            trace_id=new_id(), span_id=new_id(), parent_id=None,
            sampled=True if sampled is None else bool(sampled),
        )
    return TraceContext(
        trace_id=p.trace_id, span_id=new_id(), parent_id=p.span_id,
        sampled=p.sampled,
    )


# ---------------------------------------------------------------------------
# Wire form (RPC frame field ``t``)
# ---------------------------------------------------------------------------


def to_wire(ctx: TraceContext | None) -> list | None:
    """``[trace_id, span_id, sampled]`` — the caller's active span becomes
    the remote side's parent, and the head-sampling bit rides along so the
    remote tracer honors the root's decision. None when there is nothing
    to propagate."""
    if ctx is None:
        return None
    return [ctx.trace_id, ctx.span_id, 1 if ctx.sampled else 0]


def from_wire(wire) -> TraceContext | None:
    """Rebuild a context from the frame field (tolerant: a malformed field
    from an old/foreign peer yields None rather than an error — tracing
    must never fail a request). A two-element field from an old peer reads
    as sampled: those peers always recorded."""
    try:
        if not wire:
            return None
        sampled = bool(wire[2]) if len(wire) > 2 else True
        return TraceContext(
            trace_id=str(wire[0]), span_id=str(wire[1]), sampled=sampled
        )
    except (IndexError, KeyError, TypeError):
        return None


def wire_context() -> list | None:
    """The ambient context in wire form (what an outbound call should put
    in its frame), or None — in which case the field is omitted."""
    return to_wire(_current.get())
