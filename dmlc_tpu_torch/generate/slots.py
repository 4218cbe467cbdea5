"""Step-level slot scheduler: continuous batching over the generation engine.

Copied from ``dmlc_tpu/generate/slots.py`` with its imports pointed at this
package; the behaviour (admission, shed, eviction, deadlines, spans and
``step_stats``) is the JAX package's. ``metrics``, ``flight``, ``registry``
and ``profile`` are optional hooks (None = off).

A predict batcher coalesces one-shot requests into a batch and disbands it
after a single device dispatch. Generation needs the Orca-style evolution
of that idea: the batch is persistent (one decode step ticking at a fixed
shape) and requests are slots that join and leave it between steps — a
5-token reply exits after 5 steps while a 500-token neighbor keeps its
slot, and the freed slot (plus its recycled KV pages) admits the next
waiting request immediately. Throughput scales with resident slots at
roughly constant step cost.

Admission follows the predict path's overload contract:

- submit-time shed — no free slot (and the bounded wait queue full) or not
  enough free pages for the prompt+1 reservation raises a typed
  ``Overloaded`` with a retry-after hint; nothing buffers toward a
  guaranteed deadline miss. Flight-recorder ``shed`` events mark each.
- deadline-carrying — a request captures the ambient RPC deadline
  (cluster/deadline.py) at submit; the decode loop exits expired slots
  with a ``deadline:``-typed error between steps, never mid-step.
- mid-decode eviction — a slot whose next token needs a page the pool
  cannot grant is EVICTED with a typed ``Overloaded`` error (flight
  ``slot_evict``): admission only reserved its prompt, so a full pool is
  the overload signal arriving late, and the evicted client retries
  against the retry-after hint like any shed.

Tokens stream out through per-request ``GenStream``s: seq-numbered chunks
retained until the consumer's cumulative ack — the exactly-once delivery
substrate the RPC worker (generate/worker.py) exposes as
``job.generate_poll``.

Tracing: every decode step runs under a ``gen/step`` span bound to the
OLDEST resident slot's submit-time trace context, so a request's timeline
shows the steps that produced its tokens parented under its
``rpc/job.generate`` span; ``gen/prefill`` spans bind the joining
request's own context.
"""

from __future__ import annotations

import logging
import os
import threading
from collections.abc import Callable, Iterable
from time import monotonic
from typing import Any, NoReturn

from dmlc_tpu_torch.cluster import deadline as deadline_mod
from dmlc_tpu_torch.cluster import tenant as tenant_mod
from dmlc_tpu_torch.cluster import tracectx
from dmlc_tpu_torch.cluster.rpc import Overloaded, remote_error
from dmlc_tpu_torch.generate.kvcache import PagePoolExhausted
from dmlc_tpu_torch.utils import tracing
from dmlc_tpu_torch.utils.metrics import LatencyStats
from dmlc_tpu_torch.utils.tracing import tracer

log = logging.getLogger(__name__)


class GenStream:
    """One request's token stream with exactly-once chunk delivery.

    Producer side (the decode loop): ``push`` appends tokens; ``finish``
    seals the stream (optionally with a typed error string). Consumer side:
    ``chunks_after(ack)`` returns every chunk with seq > ack — chunks are
    retained until covered by a later cumulative ack, so a lost/retried
    poll re-reads the same chunks and the consumer dedups by seq.
    ``tokens()``/``wait`` serve in-process consumers (CLI, tests).

    Lifecycle hooks for the session plane (generate/worker.py,
    scheduler/genrouter.py): ``cancel`` requests a cooperative exit — the
    decode loop retires the slot between steps with a ``cancelled:`` error;
    ``hold``/``unhold`` pin the stream against the worker's TTL sweep while
    a migration handoff is reading it; ``step_gen`` is the engine step
    count at the last delivered token, the sweep's liveness witness."""

    def __init__(self, request_id: str) -> None:
        self.request_id = request_id
        self._cv = threading.Condition()
        self._chunks: list[tuple[int, list[int]]] = []
        self._next_seq = 1
        self._all: list[int] = []
        self.done = False
        self.error: str | None = None
        self.acked = 0
        self.cancelled = False
        self.step_gen = 0
        self._holds = 0

    # ---- producer --------------------------------------------------------

    def push(self, tokens: list[int]) -> None:
        if not tokens:
            return
        with self._cv:
            if self.done:
                raise RuntimeError("stream already finished")
            self._chunks.append((self._next_seq, [int(t) for t in tokens]))
            self._next_seq += 1
            self._all.extend(int(t) for t in tokens)
            self._cv.notify_all()

    def finish(self, error: str | None = None) -> None:
        with self._cv:
            if self.done:
                return
            self.done = True
            self.error = error
            self._cv.notify_all()

    # ---- session-plane hooks --------------------------------------------

    def cancel(self) -> None:
        """Request a cooperative exit: the decode loop retires the slot
        between steps (never mid-step). Idempotent; a finished stream is
        left as-is."""
        with self._cv:
            self.cancelled = True
            self._cv.notify_all()

    def hold(self) -> None:
        with self._cv:
            self._holds += 1

    def unhold(self) -> None:
        with self._cv:
            self._holds = max(0, self._holds - 1)

    def held(self) -> bool:
        with self._cv:
            return self._holds > 0

    # ---- consumer --------------------------------------------------------

    def chunks_after(self, ack: int) -> dict[str, Any]:
        """The poll reply body: unacked chunks + completion state. ``ack``
        is cumulative — chunks with seq <= ack are dropped for good."""
        with self._cv:
            if ack > self.acked:
                self.acked = int(ack)
                self._chunks = [c for c in self._chunks if c[0] > self.acked]
            return {
                "chunks": [[seq, list(toks)] for seq, toks in self._chunks],
                "done": self.done,
                "error": self.error,
            }

    def drained(self) -> bool:
        """Finished AND every chunk acked — safe to garbage-collect."""
        with self._cv:
            return self.done and not self._chunks

    def wait(self, timeout: float | None = None) -> bool:
        with self._cv:
            self._cv.wait_for(lambda: self.done, timeout=timeout)
            return self.done

    def tokens(self) -> list[int]:
        with self._cv:
            return list(self._all)

    def result(self, timeout: float | None = None) -> list[int]:
        """Block until done; raise the stream's typed error if it failed."""
        if not self.wait(timeout):
            raise TimeoutError(f"generation {self.request_id} still running")
        with self._cv:
            if self.error is not None:
                raise remote_error(self.error)
            return list(self._all)


class _Slot:
    """Host-side request state riding one engine slot."""

    __slots__ = (
        "stream", "prompt", "max_new_tokens", "temperature", "eos_id",
        "deadline", "trace_ctx", "pages", "emitted", "slot", "submitted_t",
        "tenant", "seed",
    )

    def __init__(self, stream: GenStream, prompt: list[int],
                 max_new_tokens: int, temperature: float, eos_id: int | None,
                 deadline: Any, trace_ctx: Any, pages: list[int],
                 submitted_t: float, tenant: str,
                 seed: int | None = None) -> None:
        self.stream = stream
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.deadline = deadline
        self.trace_ctx = trace_ctx
        self.pages = pages
        self.emitted = 0
        self.slot = -1
        self.submitted_t = submitted_t
        self.tenant = tenant
        self.seed = seed


class SlotScheduler:
    """Continuous-batching loop: admit between steps, step while anyone is
    resident, shed at the door when the slot table / page pool is full."""

    def __init__(
        self,
        engine: Any,
        *,
        max_waiting: int = 0,
        name: str = "generate",
        metrics: Any = None,
        flight: Any = None,
        registry: Any = None,
        retry_after_s: float = 0.25,
        clock: Callable[[], float] = monotonic,
        autostart: bool = True,
        lane: Any = None,
        profile: Callable[[float], None] | None = None,
        tenants: Any = None,
    ) -> None:
        self.engine = engine
        self.name = name
        self.metrics = metrics
        self.flight = flight
        self.retry_after_s = float(retry_after_s)
        self.clock = clock
        # Cost-profile feed (cluster/profile.py): called with each decode
        # step's wall seconds so the node's profiler grows a gen/step lane.
        self.profile = profile
        # Node identity for span attribution (utils/tracing.lane): the
        # decode thread does not inherit the RPC server's ambient lane, so
        # it binds its own. A callable defers resolution to thread start
        # (the node's lane can still change while ports resolve).
        self.lane = lane
        # Bounded join queue beyond the slot table itself: 0 = no waiting,
        # a submit either takes a slot-table place or sheds.
        self.max_waiting = max(0, int(max_waiting))
        # Per-tenant quotas over the in-flight bound (cluster/tenant.py):
        # a tenant's share of (slot table + wait queue), enforced at
        # submit; eviction ordering below prefers low-priority-and-over-
        # quota residents. No tenants declared = legacy behavior.
        self.ledger = tenant_mod.TenantLedger(
            tenants, int(engine.max_slots) + self.max_waiting
        )
        # Autoscaler-adjustable soft bounds (scheduler/autoscaler.py):
        # max_active caps ADMITTED slots at <= the compiled slot table;
        # page_budget caps pages-in-use at <= the allocated pool (0 = the
        # pool itself). Both resize live — the compiled step shape and the
        # HBM pool never change, only how much of them admission hands out.
        self.max_active = int(engine.max_slots)
        self.page_budget = 0
        self._page_total = int(getattr(engine, "pages_free", 0))
        self._cv = threading.Condition()
        self._pending: list[_Slot] = []
        self._closed = False
        # Owned exclusively by the decode thread after admission.
        self._resident: list[_Slot] = []
        self.requests = 0
        self.sheds = 0
        self.evictions = 0
        self.completions = 0
        self.step_stats = LatencyStats()
        self.tokens_streamed = 0
        self._t_first_token: float | None = None
        self._t_last_token: float | None = None
        if registry is not None:
            registry.gauge(f"{name}_slots_active", lambda: self.engine.slots_active)
            registry.gauge(f"{name}_pages_free", lambda: self.engine.pages_free)
            registry.gauge(f"{name}_tok_s", self.tok_s)
        self._thread = threading.Thread(
            target=self._loop, name=f"gen-{name}", daemon=True
        )
        # ``autostart=False`` defers the decode thread so a test can stage
        # several submissions and observe a DETERMINISTIC admission order;
        # production always autostarts.
        if autostart:
            self._thread.start()

    def start(self) -> None:
        if not self._thread.is_alive():
            self._thread.start()

    # ---- request side ----------------------------------------------------

    def submit(
        self,
        prompt: Iterable[int],
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        eos_id: int | None = None,
        request_id: str | None = None,
        deadline: Any = None,
        seed: int | None = None,
        resume_tokens: Iterable[int] | None = None,
    ) -> GenStream:
        """Admit one generation request; returns its stream immediately.
        Sheds with a typed ``Overloaded`` when the slot table (plus the
        bounded wait queue) or the page pool cannot take it. Captures the
        ambient RPC deadline and trace context (the decode loop carries
        both forward).

        ``seed`` keys the engine's position-seeded sampling RNG.
        ``resume_tokens`` is the migration entry (docs/GENERATE.md
        §Migration): tokens already delivered to the client elsewhere are
        prefilled along with the prompt (same seed → the continuation is
        token-identical to the uninterrupted run), and the stream emits
        only the ``max_new_tokens`` NEW tokens from the resume point on."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if resume_tokens is not None:
            prompt = prompt + [int(t) for t in resume_tokens]
        if len(prompt) > self.engine.max_prefill:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds max_prefill="
                f"{self.engine.max_prefill}"
            )
        total = len(prompt) + int(max_new_tokens)
        if total > self.engine.max_tokens:
            raise ValueError(
                f"prompt+max_new_tokens={total} exceeds the engine's "
                f"max_tokens={self.engine.max_tokens}"
            )
        if deadline is None:
            deadline = deadline_mod.current()
        tenant = tenant_mod.current()
        stream = GenStream(request_id or os.urandom(6).hex())
        with self._cv:
            if self._closed:
                raise RuntimeError("slot scheduler is stopped")
            if self.ledger.would_exceed(tenant):
                self._shed(
                    f"tenant {tenant!r} at quota "
                    f"({self.ledger.active(tenant)}/{self.ledger.quota(tenant)})",
                    tenant=tenant, verdict="over_quota",
                )
            in_flight = len(self._resident) + len(self._pending)
            limit = min(int(self.engine.max_slots), self.max_active) + self.max_waiting
            if in_flight >= limit:
                self._shed(f"slot table full ({in_flight} in flight)",
                           tenant=tenant)
            if self.page_budget > 0 and \
                    self._page_total - self.engine.pages_free >= self.page_budget:
                self._shed(
                    f"page budget exhausted "
                    f"({self._page_total - self.engine.pages_free}/"
                    f"{self.page_budget} pages in use)",
                    tenant=tenant,
                )
            try:
                pages = self.engine.reserve(len(prompt))
            except PagePoolExhausted as e:
                self._shed(f"page pool exhausted: {e}", tenant=tenant)
            self.requests += 1
            if self.metrics is not None:
                self.metrics.inc("gen_requests")
            slot = _Slot(
                stream, prompt, int(max_new_tokens), float(temperature),
                eos_id, deadline, tracectx.current(), pages, self.clock(),
                tenant, seed,
            )
            self._pending.append(slot)
            self.ledger.acquire(tenant)
            self._cv.notify_all()
        return stream

    def _shed(self, why: str, tenant: str | None = None,
              verdict: str = "gate_full") -> NoReturn:
        self.sheds += 1
        if tenant is not None:
            self.ledger.note_shed(tenant)
        if self.metrics is not None:
            self.metrics.inc("shed")
            self.metrics.inc(f"shed_{self.name}")
            if verdict == "over_quota":
                self.metrics.inc(f"shed_over_quota_{self.name}")
        tracer.record(f"overload/shed_{self.name}", 0.0)
        if self.flight is not None:
            self.flight.note("shed", gate=self.name,
                             active=len(self._resident), tenant=tenant,
                             quota=verdict)
        raise Overloaded(f"{self.name}: {why}",
                         retry_after_s=self.retry_after_s,
                         tenant=tenant, quota=verdict)

    def set_limits(self, max_active: int | None = None,
                   page_budget: int | None = None) -> dict[str, int]:
        """Autoscaler actuation seam: resize the admitted share of the
        slot table / page pool. Clamped to the compiled/allocated sizes —
        the engine itself never reshapes. Returns the effective limits."""
        with self._cv:
            if max_active is not None:
                self.max_active = max(1, min(int(max_active),
                                             int(self.engine.max_slots)))
            if page_budget is not None:
                pb = int(page_budget)
                if pb <= 0 or (self._page_total and pb >= self._page_total):
                    self.page_budget = 0
                else:
                    self.page_budget = max(1, pb)
            return {"max_active": self.max_active,
                    "page_budget": self.page_budget}

    # ---- decode loop -----------------------------------------------------

    def _loop(self) -> None:
        lane_name = self.lane() if callable(self.lane) else self.lane
        with tracing.lane(lane_name):
            self._loop_body()

    def _loop_body(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._resident and not self._closed:
                    self._cv.wait()
                if self._closed:
                    drained = self._pending
                    self._pending = []
                else:
                    drained = None
            if drained is not None:
                for s in drained:
                    self.engine.release_reservation(s.pages)
                    self._ledger_release(s)
                    s.stream.finish("overloaded: scheduler stopped")
                for s in self._resident:
                    self.engine.release(s.slot)
                    self._ledger_release(s)
                    s.stream.finish("overloaded: scheduler stopped")
                self._resident = []
                return
            try:
                self._admit_pending()
                self._retire_and_step()
            except Exception:
                # A crashed decode loop must fail every resident request
                # visibly, not hang their streams forever.
                log.exception("decode loop error; failing resident slots")
                for s in self._resident:
                    try:
                        self.engine.release(s.slot)
                    except Exception:  # dmlc-lint: disable=E1 -- best-effort cleanup mid-failure; the stream error below is the observable verdict
                        pass
                    s.stream.finish("RpcError: generation engine failed")
                self._resident = []

    def _admit_pending(self) -> None:
        """Move waiting requests into free engine slots (between steps).

        The head request stays IN ``_pending`` until it lands in
        ``_resident``: submit-time admission counts both lists, and a
        request invisible to that count during its prefill would let a
        third request slip past a full slot table."""
        while True:
            free = self.engine.free_slots()
            with self._cv:
                if not self._pending or not free:
                    return
                req = self._pending[0]
            if req.deadline is not None and req.deadline.expired():
                # Expired while waiting: a prefill now would be dead work.
                self._unpend(req)
                self.engine.release_reservation(req.pages)
                self._ledger_release(req)
                req.stream.finish("deadline: expired before a slot freed")
                continue
            if req.stream.cancelled:
                # Cancelled while waiting (router migrated it away, or the
                # client gave up): a prefill now would be dead work.
                self._unpend(req)
                self.engine.release_reservation(req.pages)
                self._ledger_release(req)
                req.stream.finish("cancelled: before a slot freed")
                continue
            req.slot = free[0]
            try:
                with tracectx.bind(req.trace_ctx):
                    with tracer.span("gen/prefill", slot=req.slot,
                                     prompt=len(req.prompt)):
                        first = self.engine.join(
                            req.slot, req.prompt,
                            temperature=req.temperature, pages=req.pages,
                            seed=req.seed,
                        )
            except Exception as e:
                # A bad request (or a prefill failure) fails ITS stream,
                # never the resident batch. Pages go back wherever they
                # are: bound to the slot (join got past bind) or still the
                # submit-time reservation.
                log.exception("prefill failed for %s", req.stream.request_id)
                self._unpend(req)
                if (self.engine.cache_mode == "paged"
                        and not self.engine.cache.slot_pages(req.slot)):
                    self.engine.release_reservation(req.pages)
                self.engine.release(req.slot)
                self._ledger_release(req)
                req.stream.finish(f"{type(e).__name__}: {e}")
                continue
            req.pages = []  # ownership moved to the cache's slot binding
            with self._cv:
                self._pending.remove(req)
                self._resident.append(req)
            if self.flight is not None:
                # ``step`` stamps WHEN in the batch's life the slot joined:
                # admits at step > 0 are the continuous-batching evidence
                # (a request entered a batch already mid-decode).
                self.flight.note(
                    "slot_admit", slot=req.slot, prompt=len(req.prompt),
                    step=self.engine.steps, request=req.stream.request_id,
                    pages=len(self.engine.cache.slot_pages(req.slot))
                    if self.engine.cache_mode == "paged" else 0,
                )
            self._deliver(req, first)
            if req.eos_id is not None and first == req.eos_id:
                self._exit(req, "eos")

    def _unpend(self, req: _Slot) -> None:
        with self._cv:
            if req in self._pending:
                self._pending.remove(req)

    def _ledger_release(self, req: _Slot) -> None:
        with self._cv:
            self.ledger.release(req.tenant)

    def _eviction_victim(self, req: _Slot) -> _Slot:
        """Eviction ordering (docs/OVERLOAD.md §Priority classes): when
        ``req`` needs a page the pool cannot grant, the slot that dies is
        the newest LOW-PRIORITY-AND-OVER-QUOTA resident — the workload
        holding more than its share pays for the pressure it created.
        With no such victim (everyone within quota, or ``req`` itself is
        the over-quota low-priority one) the requester is evicted, as
        before: within-quota work of another tenant is NEVER the victim."""
        with self._cv:
            spec = self.ledger.spec(req.tenant)
            if spec.high_priority and not self.ledger.over_quota(req.tenant):
                for other in reversed(self._resident):
                    if other is req:
                        continue
                    if self.ledger.over_quota(other.tenant) and \
                            not self.ledger.spec(other.tenant).high_priority:
                        return other
            return req

    def _evict(self, victim: _Slot, why: Exception) -> None:
        self.evictions += 1
        if self.metrics is not None:
            self.metrics.inc("gen_evictions")
        if self.flight is not None:
            self.flight.note("slot_evict", slot=victim.slot,
                             emitted=victim.emitted, tenant=victim.tenant)
        self._exit(victim, "evicted",
                   error=f"overloaded: evicted mid-decode ({why})",
                   counted=False)

    def _retire_and_step(self) -> None:
        # Between-step housekeeping: expired deadlines out, page growth
        # secured, THEN one fixed-shape step for whoever remains.
        for req in list(self._resident):
            if req not in self._resident:
                continue  # already evicted as another slot's page victim
            if req.stream.cancelled:
                self._exit(req, "cancel",
                           error="cancelled: stream cancelled",
                           counted=False)
                continue
            if req.deadline is not None and req.deadline.expired():
                self._exit(req, "deadline",
                           error="deadline: generation exceeded its budget")
                continue
            if req.emitted >= req.max_new_tokens:
                self._exit(req, "max_tokens")
                continue
            try:
                self.engine.ensure_capacity(req.slot)
            except PagePoolExhausted as e:
                victim = self._eviction_victim(req)
                self._evict(victim, e)
                if victim is not req:
                    # The freed pages may now cover the requester; if the
                    # pool STILL cannot grant, the requester exits too.
                    try:
                        self.engine.ensure_capacity(req.slot)
                    except PagePoolExhausted as e2:
                        self._evict(req, e2)
        if not self._resident:
            return
        oldest = min(self._resident, key=lambda r: r.submitted_t)
        t0 = self.clock()
        with tracectx.bind(oldest.trace_ctx):
            with tracer.span("gen/step", slots=len(self._resident)):
                tokens = self.engine.step()
        elapsed = max(0.0, self.clock() - t0)
        self.step_stats.record(elapsed)
        if self.profile is not None:
            self.profile(elapsed)
        for req in list(self._resident):
            tok = int(tokens[req.slot])
            self._deliver(req, tok)
            if req.eos_id is not None and tok == req.eos_id:
                self._exit(req, "eos")

    def _deliver(self, req: _Slot, token: int) -> None:
        req.emitted += 1
        req.stream.step_gen = self.engine.steps
        req.stream.push([token])
        self.tokens_streamed += 1
        if self.metrics is not None:
            self.metrics.inc("gen_tokens")
        now = self.clock()
        if self._t_first_token is None:
            self._t_first_token = now
        self._t_last_token = now

    def _exit(self, req: _Slot, reason: str, error: str | None = None,
              counted: bool = True) -> None:
        freed = self.engine.release(req.slot)
        with self._cv:  # submit reads len(_resident) for admission
            self._resident.remove(req)
            self.ledger.release(req.tenant)
        if counted:
            self.completions += 1
        if self.flight is not None:
            self.flight.note("slot_exit", slot=req.slot, reason=reason,
                             step=self.engine.steps, emitted=req.emitted,
                             pages_freed=len(freed))
        req.stream.finish(error)

    # ---- observability / lifecycle ---------------------------------------

    def tok_s(self) -> float:
        """Streamed-token rate over the window tokens actually flowed."""
        if self._t_first_token is None or self._t_last_token is None:
            return 0.0
        dt = self._t_last_token - self._t_first_token
        if dt <= 0:
            return 0.0
        return self.tokens_streamed / dt

    def summary(self) -> dict[str, Any]:
        with self._cv:
            tenants = self.ledger.summary()
        return {
            "requests": self.requests,
            "sheds": self.sheds,
            "evictions": self.evictions,
            "completions": self.completions,
            "tokens_streamed": self.tokens_streamed,
            "tok_s": round(self.tok_s(), 2),
            "slots_active": self.engine.slots_active,
            "pages_free": self.engine.pages_free,
            "max_active": self.max_active,
            "page_budget": self.page_budget,
            **({"tenants": tenants} if tenants else {}),
            "steps": self.engine.steps,
            "step_ms_p50": round(self.step_stats.percentile(50) * 1e3, 3)
            if len(self.step_stats) else None,
            "step_ms_p99": round(self.step_stats.percentile(99) * 1e3, 3)
            if len(self.step_stats) else None,
        }

    def stop(self, timeout_s: float = 10.0) -> None:
        """Fail-fast shutdown: waiting and resident requests finish with a
        typed error (node stop must be bounded, not generation-length)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)
