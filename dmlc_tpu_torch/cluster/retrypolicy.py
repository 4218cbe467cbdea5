"""Retry budgets + per-peer circuit breakers: the ONE way the cluster retries.

Copied from ``dmlc_tpu/cluster/retrypolicy.py`` (the whole module).

Before this module, every retrying caller rolled its own policy — the
scheduler requeued failed shards immediately, SDFS client pulls walked the
replica list, the failover probe and the announce loop re-dialed every tick.
Each is individually sane; together, against a dead or *drowning* peer, they
are a retry storm: the peer's recovery bandwidth is spent absorbing the
fleet's impatience (the classic metastable failure shape — retries are load
amplification exactly when capacity is lowest).

The fix is two small mechanisms, shared per-node and keyed per destination
(docs/OVERLOAD.md):

- **Retry budget** — a token bucket per destination. First attempts are
  free (work must flow); *retries* spend a token, refilled at
  ``retry_rate_per_s`` up to ``retry_burst``. An empty bucket means the
  retry fast-fails locally and the caller's own requeue/backoff machinery
  handles it — a struggling peer costs bounded probe traffic per window,
  never an unbounded reflection of the offered load.
- **Circuit breaker** — closed / open / half-open per destination, tripped
  only by *overload-class* failures (``RpcUnreachable``,
  ``DeadlineExceeded``, ``Overloaded``): ``breaker_threshold`` consecutive
  failures open it; after ``breaker_cooldown_s`` it admits exactly ONE
  half-open probe; a probe success closes it, a failure re-opens it.
  Method-level errors (the peer answered, the answer was "no") prove
  liveness and CLOSE the breaker — a buggy request must not eject a
  healthy peer.

Sans-IO: the clock is injected (``Clock.monotonic`` in deployment, the
SimRpcNetwork virtual clock in tests), so breaker/budget behavior replays
deterministically.
"""

from __future__ import annotations

import logging
import threading
from time import monotonic
from typing import Callable

from dmlc_tpu_torch.cluster.rpc import DeadlineExceeded, Overloaded, RpcUnreachable

log = logging.getLogger(__name__)


def is_overload_error(err: BaseException) -> bool:
    """Failures that mean "the peer is unreachable or drowning" — the only
    kind that should trip breakers or spend gray-failure evidence."""
    return isinstance(err, (RpcUnreachable, DeadlineExceeded, Overloaded))


class _Breaker:
    """One destination's circuit-breaker state. Caller holds the policy lock."""

    __slots__ = ("state", "consec", "opened_at", "open_count", "probe_inflight")

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self):
        self.state = self.CLOSED
        self.consec = 0          # consecutive overload-class failures
        self.opened_at = 0.0
        self.open_count = 0      # lifetime opens (gray ejection watches this)
        self.probe_inflight = False


class _Bucket:
    """One destination's retry-token bucket. Caller holds the policy lock."""

    __slots__ = ("tokens", "stamp")

    def __init__(self, cap: float, now: float):
        self.tokens = cap
        self.stamp = now


class RetryPolicy:
    """Per-destination retry governor shared by every retrying caller on a
    node (scheduler dispatch, SDFS pulls, failover probes, announce loop).

    Thread-safe; all methods are O(1) under one lock.
    """

    def __init__(
        self,
        clock: Callable[[], float] = monotonic,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 5.0,
        retry_rate_per_s: float = 1.0,
        retry_burst: float = 5.0,
        metrics=None,
        flight=None,
    ):
        self.clock = clock
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.retry_rate_per_s = float(retry_rate_per_s)
        self.retry_burst = float(retry_burst)
        self.metrics = metrics
        # Flight recorder (cluster/flight.py, optional): breaker open/close
        # transitions, timestamped for postmortems.
        self.flight = flight
        self._breakers: dict[str, _Breaker] = {}
        self._buckets: dict[str, _Bucket] = {}
        self._lock = threading.Lock()

    # ---- admission -----------------------------------------------------

    def allow(self, dest: str) -> bool:
        """May a (first-attempt) call go to ``dest`` right now? False while
        the breaker is open; a half-open breaker admits exactly one probe at
        a time (the caller MUST report the outcome via ``record``)."""
        with self._lock:
            ok = self._allow_locked(dest)
        if not ok and self.metrics is not None:
            self.metrics.inc("breaker_denied")
        return ok

    def allow_retry(self, dest: str) -> bool:
        """May a RETRY go to ``dest``? The breaker gate plus one token from
        the destination's retry budget; a denial means the caller should
        fail (or park the work) instead of re-dialing."""
        with self._lock:
            if not self._allow_locked(dest):
                denied_by = "breaker_denied"
            elif not self._spend_token_locked(dest):
                denied_by = "retries_denied"
            else:
                return True
        if self.metrics is not None:
            self.metrics.inc(denied_by)
        return False

    def _allow_locked(self, dest: str) -> bool:
        b = self._breakers.get(dest)
        if b is None or b.state == _Breaker.CLOSED:
            return True
        now = self.clock()
        if b.state == _Breaker.OPEN:
            if now - b.opened_at < self.breaker_cooldown_s:
                return False
            b.state = _Breaker.HALF_OPEN
            b.probe_inflight = False
        # half-open: one probe in flight at a time
        if b.probe_inflight:
            return False
        b.probe_inflight = True
        return True

    def _spend_token_locked(self, dest: str) -> bool:
        now = self.clock()
        bucket = self._buckets.get(dest)
        if bucket is None:
            bucket = self._buckets[dest] = _Bucket(self.retry_burst, now)
        bucket.tokens = min(
            self.retry_burst,
            bucket.tokens + (now - bucket.stamp) * self.retry_rate_per_s,
        )
        bucket.stamp = now
        if bucket.tokens < 1.0:
            return False
        bucket.tokens -= 1.0
        return True

    # ---- outcome reporting ---------------------------------------------

    def record(self, dest: str, err: BaseException | None = None) -> None:
        """Report one call's outcome. ``err=None`` (success) and
        method-level errors close the breaker; overload-class errors count
        toward opening it (and re-open a half-open one immediately)."""
        failure = err is not None and is_overload_error(err)
        opened = False
        closed = False
        with self._lock:
            b = self._breakers.setdefault(dest, _Breaker())
            if not failure:
                closed = b.state != _Breaker.CLOSED
                b.state = _Breaker.CLOSED
                b.consec = 0
                b.probe_inflight = False
            else:
                b.consec += 1
                b.probe_inflight = False
                if b.state == _Breaker.HALF_OPEN or b.consec >= self.breaker_threshold:
                    if b.state != _Breaker.OPEN:
                        b.open_count += 1
                        opened = True
                    b.state = _Breaker.OPEN
                    b.opened_at = self.clock()
        if opened:
            if self.metrics is not None:
                self.metrics.inc("breaker_open")
            if self.flight is not None:
                self.flight.note("breaker_open", dest=dest, error=str(err))
            log.warning("circuit breaker OPEN for %s (%s)", dest, err)
        elif closed:
            if self.flight is not None:
                self.flight.note("breaker_close", dest=dest)
            log.info("circuit breaker closed for %s", dest)

    # ---- introspection -------------------------------------------------

    def breaker_state(self, dest: str) -> str:
        with self._lock:
            b = self._breakers.get(dest)
            if b is None:
                return _Breaker.CLOSED
            # Surface cooldown expiry without mutating: an expired OPEN is
            # reported half-open (the next allow() transitions it).
            if (
                b.state == _Breaker.OPEN
                and self.clock() - b.opened_at >= self.breaker_cooldown_s
            ):
                return _Breaker.HALF_OPEN
            return b.state

    def open_count(self, dest: str) -> int:
        """Lifetime opens for ``dest`` — gray ejection demotes a member
        whose breaker keeps reopening."""
        with self._lock:
            b = self._breakers.get(dest)
            return 0 if b is None else b.open_count

    def snapshot(self) -> dict:
        """Per-destination breaker states for status surfaces (only
        destinations that ever failed appear)."""
        with self._lock:
            return {
                dest: {"state": b.state, "opens": b.open_count, "consec": b.consec}
                for dest, b in self._breakers.items()
                if b.open_count or b.consec or b.state != _Breaker.CLOSED
            }
