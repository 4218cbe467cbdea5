"""Member-side generation worker: the ``job.generate`` RPC surface.

Port of ``dmlc_tpu/generate/worker.py``. ``GenerateWorker.methods()`` is
the table a fabric serves (``cluster.rpc.TcpRpcServer`` over TCP, with
frames compatible with the JAX package's, or ``cluster.rpc.SimRpcNetwork``
in process), and ``rpc`` in the client helpers is any ``cluster.rpc.Rpc``
(``TcpRpc``, a ``SimRpcNetwork`` client) or other object with
``.call(addr, method, payload, timeout=)``. The node that wires the worker
into a member's server is not ported yet.

Mirrors ``scheduler/worker.PredictWorker``'s shape — a backend per model,
an RPC method table wired into the member server — but the verb is
autoregressive, so one request produces MANY replies' worth of tokens. The
control-plane fabric is strict request/response (cluster/rpc.py), so
streaming rides a chunk-poll protocol (wire format: docs/GENERATE.md):

- ``job.generate``  {model, prompt:[int], max_new_tokens, temperature?,
  eos_id?, gen_id?, seed?, resume_tokens?} -> {gen_id}. Admission happens
  HERE (slot table + page pool, typed ``Overloaded`` on refusal) and the
  ambient deadline/trace context captured by the slot scheduler ride the
  whole generation. A caller-supplied ``gen_id`` makes the verb IDEMPOTENT:
  re-submitting a live id returns it without a second prefill — the
  property the router's migration retry (leader failover mid-migration)
  leans on for its ≤1-prefill-per-failure bound. ``seed`` keys the
  position-seeded sampling RNG and ``resume_tokens`` re-prefills an
  already-delivered prefix (scheduler/genrouter.py migration entry).
- ``job.generate_poll``  {gen_id, ack:int} -> {chunks: [[seq, [tok,..]],
  ...], done, error?}. Chunks are seq-numbered and retained until covered
  by the CUMULATIVE ack, so a retried poll (lost reply, client crash +
  resume) re-reads identical chunks and the client dedups by seq —
  exactly-once token delivery over an at-least-once fabric.
- ``job.generate_cancel`` {gen_id, reason?} -> {cancelled} releases the
  consumer's interest and cancels the stream cooperatively (the decode
  loop retires the slot between steps, never mid-step).

Sessions for which no poll arrives within ``session_ttl_s`` are swept (an
abandoned client must not pin chunks forever) — but never while the
backend is still stepping the stream or a migration handoff holds it: the
sweep compares the stream's ``step_gen`` against its last observation and
skips held streams, so an in-flight decode step or handoff cannot race a
reap. Every sweep/cancel is flight-recorded (``session_sweep`` with reason
``ttl``/``cancel``/``migrated``). ``generate_stream`` / ``generate`` are
the client helpers the CLI and tests drive.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections.abc import Callable, Iterable
from typing import TYPE_CHECKING, Any, Iterator

import torch

if TYPE_CHECKING:
    from dmlc_tpu_torch.generate.slots import GenStream, SlotScheduler

from dmlc_tpu_torch.cluster.rpc import RpcError, remote_error
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.tracing import traced_methods, tracer

log = logging.getLogger(__name__)


class GenerationBackend:
    """One servable LM: engine + slot scheduler, built lazily like
    EngineBackend (weights and KV pools take device memory; nodes that never
    see a generate request shouldn't pay). The device is resolved at
    construction: with no CUDA device and no explicit ``device="cpu"`` this
    raises at once."""

    def __init__(
        self,
        model_name: str,
        *,
        max_slots: int = 8,
        page_size: int = 16,
        num_pages: int = 128,
        max_prefill: int = 64,
        max_waiting: int = 0,
        metrics: Any = None,
        flight: Any = None,
        registry: Any = None,
        lane: Any = None,
        profile: Callable[[float], None] | None = None,
        device_work: Any = None,
        tenants: Any = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.model_name = model_name
        self.device = resolve_device(device)
        self.tenants = tenants
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_prefill = int(max_prefill)
        self.max_waiting = int(max_waiting)
        self.metrics = metrics
        self.flight = flight
        self.registry = registry
        self.lane = lane
        self.profile = profile
        # Device-plane telemetry hook (cluster/devicemon.py): called with
        # (model, tokens, device_seconds) per decode step.
        self.device_work = device_work
        self._scheduler: SlotScheduler | None = None
        self._lock = threading.Lock()

    def warmup(self) -> None:
        """Build the engine now (node startup, before membership)."""
        self._ensure()

    def _ensure(self) -> SlotScheduler:
        # One-time lazy init: requests arriving before the engine exists must
        # block on the single build, not double-build it (EngineBackend's
        # pattern).
        with self._lock:
            if self._scheduler is None:
                from dmlc_tpu_torch.generate.engine import GenerationEngine
                from dmlc_tpu_torch.generate.slots import SlotScheduler

                engine = GenerationEngine(
                    self.model_name,
                    max_slots=self.max_slots,
                    page_size=self.page_size,
                    num_pages=self.num_pages,
                    max_prefill=self.max_prefill,
                    device_work=self.device_work,
                    device=self.device,
                )
                self._scheduler = SlotScheduler(
                    engine,
                    max_waiting=self.max_waiting,
                    name=f"generate-{self.model_name}",
                    metrics=self.metrics,
                    flight=self.flight,
                    registry=self.registry,
                    lane=self.lane,
                    profile=self.profile,
                    tenants=self.tenants,
                )
            return self._scheduler

    def slot_limit(self) -> int:
        """Autoscaler read seam: the effective slot-table bound (configured
        width until the lazy engine builds)."""
        with self._lock:
            sched = self._scheduler
        return sched.max_active if sched is not None else self.max_slots

    def set_slot_limit(self, max_active: int) -> int:
        """Autoscaler apply seam: bound the live slot table. A backend that
        hasn't built yet just reports its configured width — there is no
        running decode batch to bound."""
        with self._lock:
            sched = self._scheduler
        if sched is None:
            return self.max_slots
        return int(sched.set_limits(max_active=max_active)["max_active"])

    def slots_resident(self) -> int:
        """Live decode slots right now — the autoscaler's drain seam:
        shrinking the slot limit below this would abandon streams
        mid-decode, so scale-down holds until residency fits."""
        with self._lock:
            sched = self._scheduler
        return int(sched.engine.slots_active) if sched is not None else 0

    def submit(self, prompt: Iterable[int], **kw: Any) -> GenStream:
        return self._ensure().submit(prompt, **kw)

    def load_variables(self, variables: Any) -> None:
        """`train`-verb hot-swap into the live engine."""
        self._ensure().engine.load_variables(variables)

    def summary(self) -> dict[str, Any]:
        with self._lock:
            sched = self._scheduler
        return sched.summary() if sched is not None else {"built": False}

    def stop(self, timeout_s: float = 5.0) -> None:
        with self._lock:
            sched = self._scheduler
        if sched is not None:
            sched.stop(timeout_s=timeout_s)


class _Session:
    __slots__ = ("stream", "last_poll", "step_gen")

    def __init__(self, stream: GenStream, now: float) -> None:
        self.stream = stream
        self.last_poll = now
        # Stream step generation at the last sweep observation: a stream
        # whose backend stepped since then is live regardless of polls.
        self.step_gen = 0


class GenerateWorker:
    """RPC surface over a dict of GenerationBackends."""

    def __init__(self, backends: dict[str, GenerationBackend], *,
                 session_ttl_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic,
                 flight: Any = None) -> None:
        self.backends = dict(backends)
        self.session_ttl_s = float(session_ttl_s)
        self.clock = clock
        self.flight = flight
        self._sessions: dict[str, _Session] = {}
        self._lock = threading.Lock()

    def methods(self) -> dict[str, Any]:
        return traced_methods({
            "job.generate": self._generate,
            "job.generate_poll": self._poll,
            "job.generate_cancel": self._cancel,
        })

    def _backend(self, model: str) -> GenerationBackend:
        backend = self.backends.get(model)
        if backend is None:
            raise RpcError(
                f"model {model!r} not served here; have {sorted(self.backends)}"
            )
        return backend

    def _generate(self, p: dict[str, Any]) -> dict[str, Any]:
        backend = self._backend(p["model"])
        gen_id = str(p.get("gen_id") or os.urandom(8).hex())
        with self._lock:
            if gen_id in self._sessions:
                # Idempotent re-submit (router retry across a leader
                # failover): the live session IS the answer; a second
                # prefill would fork the stream and double-bill the slots.
                return {"gen_id": gen_id, "model": p["model"],
                        "resumed": True}
        try:
            stream = backend.submit(
                [int(t) for t in p["prompt"]],
                max_new_tokens=int(p["max_new_tokens"]),
                temperature=float(p.get("temperature", 0.0)),
                eos_id=int(p["eos_id"]) if p.get("eos_id") is not None else None,
                request_id=gen_id,
                seed=int(p["seed"]) if p.get("seed") is not None else None,
                resume_tokens=p.get("resume_tokens"),
            )
        except ValueError as e:
            raise RpcError(str(e))
        now = self.clock()
        with self._lock:
            self._sweep_locked(now)
            if gen_id in self._sessions:
                dup = stream  # lost a concurrent duplicate-submit race
            else:
                self._sessions[gen_id] = _Session(stream, now)
                dup = None
        if dup is not None:
            dup.cancel()
            return {"gen_id": gen_id, "model": p["model"], "resumed": True}
        return {"gen_id": gen_id, "model": p["model"]}

    def _poll(self, p: dict[str, Any]) -> dict[str, Any]:
        gen_id = p["gen_id"]
        now = self.clock()
        with self._lock:
            session = self._sessions.get(gen_id)
            if session is None:
                raise RpcError(f"unknown generation {gen_id!r} (done+acked, "
                               "cancelled, or expired)")
            session.last_poll = now
        # The session is NOT popped on the final reply: if that reply is
        # lost, the client's retried poll must find the same idempotent
        # done-verdict, not "unknown generation". TTL sweep (and explicit
        # cancel) reap it instead.
        return session.stream.chunks_after(int(p.get("ack", 0)))

    def _cancel(self, p: dict[str, Any]) -> dict[str, Any]:
        reason = str(p.get("reason", "cancel"))
        with self._lock:
            session = self._sessions.pop(p["gen_id"], None)
        if session is not None:
            # Cooperative: the decode loop retires the slot between steps
            # (never mid-step), freeing its pages for the next admit — a
            # migrated-away session must not keep decoding dead tokens.
            session.stream.cancel()
            if self.flight is not None:
                self.flight.note("session_sweep", gen_id=p["gen_id"],
                                 reason=reason)
        return {"cancelled": session is not None}

    def _sweep_locked(self, now: float) -> None:
        for gid, s in list(self._sessions.items()):
            if now - s.last_poll <= self.session_ttl_s:
                continue
            stream = s.stream
            if stream.held():
                continue  # migration handoff mid-read: never reap under it
            gen = int(stream.step_gen)
            if not stream.done and gen != s.step_gen:
                # The backend stepped this stream since the last sweep
                # observation: it is live even with no polls arriving
                # (slow consumer, router mid-failover). Reap only once the
                # decode goes quiet too — the step-generation guard that
                # closes the sweep-vs-in-flight-step race.
                s.step_gen = gen
                continue
            self._sessions.pop(gid, None)
            stream.cancel()
            if self.flight is not None:
                self.flight.note("session_sweep", gen_id=gid, reason="ttl",
                                 idle_s=round(now - s.last_poll, 3))
            log.info("swept abandoned generation session %s", gid)

    def summary(self) -> dict[str, Any]:
        with self._lock:
            open_sessions = len(self._sessions)
        return {
            "open_sessions": open_sessions,
            "models": {name: b.summary() for name, b in self.backends.items()},
        }


# ---------------------------------------------------------------------------
# Client helpers (CLI / tests / tools)
# ---------------------------------------------------------------------------


def generate_stream(
    rpc: Any,
    addr: str,
    model: str,
    prompt: Iterable[int],
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    eos_id: int | None = None,
    seed: int | None = None,
    poll_timeout: float = 10.0,
    poll_interval_s: float = 0.0,
    sleep: Callable[[float], None] = time.sleep,
) -> Iterator[int]:
    """Submit and yield tokens as they stream. Exactly-once: chunks are
    dedup'd by seq and acked cumulatively, so a retried poll after a lost
    reply cannot duplicate or drop tokens. Raises the remote's typed error
    (Overloaded / DeadlineExceeded / RpcError) on failure. ``seed`` pins
    the sampling RNG (temperature > 0) to a reproducible sequence."""
    payload: dict[str, Any] = {
        "model": model, "prompt": [int(t) for t in prompt],
        "max_new_tokens": int(max_new_tokens),
        "temperature": float(temperature), "eos_id": eos_id,
    }
    if seed is not None:
        payload["seed"] = int(seed)
    with tracer.span("cli/generate", model=model):
        reply = rpc.call(addr, "job.generate", payload, timeout=poll_timeout)
        gen_id = reply["gen_id"]
        acked = 0
        while True:
            r = rpc.call(
                addr, "job.generate_poll", {"gen_id": gen_id, "ack": acked},
                timeout=poll_timeout,
            )
            advanced = False
            for seq, toks in sorted(r.get("chunks", [])):
                if seq <= acked:
                    continue  # replayed chunk from a retried poll
                acked = seq
                advanced = True
                for t in toks:
                    yield int(t)
            if r.get("done") and not r.get("chunks"):
                if r.get("error"):
                    raise remote_error(r["error"])
                return
            if not advanced and not r.get("done") and poll_interval_s > 0:
                sleep(poll_interval_s)


def generate(rpc: Any, addr: str, model: str, prompt: Iterable[int],
             **kw: Any) -> list[int]:
    """Blocking convenience: the full generated token list."""
    return list(generate_stream(rpc, addr, model, prompt, **kw))
