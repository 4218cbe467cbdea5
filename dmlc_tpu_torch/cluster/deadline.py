"""Deadline propagation: one budget for a whole request tree.

Copied from ``dmlc_tpu/cluster/deadline.py`` (the whole module).

The reference gave every RPC a flat timeout (its query deadline was a full
HOUR, src/main.rs:132); our port flattened that to 60 s — still per *hop*,
so a leader -> member -> SDFS-pull chain could legally burn 3x the caller's
patience, and a caller that has already given up keeps a server computing
for it. This module is the fix (docs/OVERLOAD.md):

- ``Deadline`` — an expiry on an injected monotonic clock. ``remaining()``
  is the per-hop budget left; it only shrinks as the request travels.
- an ambient binding (``bind``/``current``): the RPC server wraps method
  execution in ``bind(deadline)``, so any nested ``Rpc.call`` the method
  makes inherits the caller's remaining budget *without every call site
  threading a deadline argument through*.
- ``resolve_budget(timeout, deadline)`` — the one place a call's effective
  budget is computed: the explicit timeout, capped by an explicit deadline
  and by the ambient (inherited) one.

Budgets travel the wire as *relative seconds remaining* (frame field
``d``), re-anchored to the receiver's clock on arrival — host clocks are
never compared, so skew cannot manufacture or destroy budget. Transit time
is therefore uncounted; callers should treat the deadline as accurate to
within one network transit.

Uses ``contextvars`` so the binding is per-thread (server handler threads)
and survives into worker threads only when explicitly rebound.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from time import monotonic
from typing import Callable, Iterator


class Deadline:
    """An absolute expiry on an injected monotonic clock."""

    __slots__ = ("clock", "expires_at", "budget_s")

    def __init__(self, budget_s: float, clock: Callable[[], float] = monotonic):
        self.clock = clock
        self.budget_s = float(budget_s)
        self.expires_at = clock() + self.budget_s

    def remaining(self) -> float:
        return self.expires_at - self.clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def __repr__(self) -> str:  # log-friendly
        return f"Deadline(remaining={self.remaining():.3f}s of {self.budget_s:.3f}s)"


_current: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "dmlc_deadline", default=None
)


def current() -> Deadline | None:
    """The ambient deadline bound by the innermost serving scope, if any."""
    return _current.get()


@contextmanager
def bind(deadline: Deadline | None) -> Iterator[Deadline | None]:
    """Make ``deadline`` ambient for the dynamic extent of the block (the
    RPC server's per-method scope). Nested calls then inherit it through
    ``resolve_budget``."""
    token = _current.set(deadline)
    try:
        yield deadline
    finally:
        _current.reset(token)


def resolve_budget(timeout: float, deadline: Deadline | float | None = None) -> float:
    """Effective budget for one outbound call: the explicit ``timeout``,
    capped by an explicit ``deadline`` (a Deadline or plain seconds) and by
    the ambient inherited deadline. May be <= 0, which callers turn into a
    local fast-fail (``DeadlineExceeded``) instead of an RPC."""
    budget = float(timeout)
    for dl in (deadline, _current.get()):
        if dl is None:
            continue
        rem = dl.remaining() if isinstance(dl, Deadline) else float(dl)
        budget = min(budget, rem)
    return budget
