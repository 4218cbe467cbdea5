"""GenRouter: leader-routed generation sessions that survive the fleet.

Copied from ``dmlc_tpu/scheduler/genrouter.py`` (the whole module): the
``gen.*``/``job.generate*`` verbs and the ledger's wire form
(``gen.state``) are the JAX package's, so a router of either package routes
to members of both and a standby of either mirrors the other's ledger.

Before this module a generation stream was a per-member island: the client
dialed one member's GenerateWorker and everything recoverable about the
stream — KV pages, slot, undelivered chunks — lived in that member's RAM.
The router makes the stream a FLEET-level object (docs/GENERATE.md
§Routing/§Migration/§Drain):

- **Routing.** ``job.generate`` on the LEADER picks a member by the gauges
  every node already exports (``generate-<model>_slots_active``,
  ``generate-<model>_pages_free``, ``mfu_<model>``), corrected by the
  ledger's own residency view (a just-routed session is not in any scrape
  yet), honoring tenant quotas (cluster/tenant.py) and session affinity
  (same tenant+model prefers its existing member as a tiebreak). Draining
  and breaker-convicted members admit nothing new.
- **Session ledger.** session id → model, prompt, sampling params, RNG
  seed, tenant, deadline budget, placed member, cumulative acked-token
  prefix. The ledger rides the leader-state machinery exactly like
  scheduler/jobs.py job cursors: epoch-keyed ``gen.state`` wire snapshots,
  pulled by the StandbyLeader every sync tick, adopted without ever
  rewinding a delivered prefix — so a promoted leader re-adopts every live
  stream (and re-adoption is idempotent: merging by sid cannot create a
  second placement).
- **Migration.** On membership loss, breaker conviction, member amnesia
  (alive but lost the session), or a drain deadline, the router re-submits
  ``prompt + delivered_prefix`` with the session's seed to a survivor
  (``resume_tokens`` entry, generate/slots.py) — the engine's
  position-seeded sampling RNG makes the continuation token-identical to
  the unkilled reference — and splices the member's restarted chunk seqs
  into its own continuous out-seq space, so the client's cumulative-ack
  dedup keeps working unchanged: exactly-once end to end, nothing lost,
  nothing doubled. The member-side ``job.generate`` is idempotent on a
  caller gen_id, which bounds migration to ≤1 prefill per failure even
  when a promoted leader retries a dead leader's in-flight migration.
- **Drain.** ``job.drain`` flips a member to stop-admitting; resident
  sessions finish within the drain deadline or migrate; the autoscaler's
  scale-down goes through ``release_capacity`` (drain-then-shrink) instead
  of abandoning sessions. Every transition is flight-recorded (``route``,
  ``migrate``, ``drain_start``, ``drain_complete``, ``session_lost``) with
  counters ``gen_sessions_routed``/``gen_migrations`` and the
  ``gen_drain_active`` gauge.

Lock discipline (dmlc-lint L1): the router lock guards ONLY ledger state;
every RPC happens outside it — handlers snapshot under the lock, call,
then fold the reply back under the lock with a staleness check (session
gone or re-placed meanwhile → the reply is dropped). ``members()`` and
``metrics_for()`` are LOCAL reads by contract (membership snapshot, scrape
cache), never network calls.
"""

from __future__ import annotations

import logging
import os
import threading
from collections.abc import Callable, Mapping
from time import monotonic
from typing import Any

from dmlc_tpu_torch.cluster import tenant as tenant_mod
from dmlc_tpu_torch.cluster import tracectx
from dmlc_tpu_torch.cluster.rpc import Overloaded, RpcError, RpcUnreachable
from dmlc_tpu_torch.utils.tracing import traced_methods

log = logging.getLogger(__name__)

#: states in which a session occupies a member slot (or is about to)
_LIVE_STATES = ("running", "migrating")


class Session:
    """One stream's ledger entry — everything a leader needs to re-route,
    migrate, or re-adopt it. ``delivered`` is the token prefix the router
    has folded from member chunk streams (the migration prefill payload);
    ``out_chunks``/``out_seq`` are the router's OWN seq space toward the
    client, spliced continuously across placements; ``member_acked`` is
    the cumulative ack toward the CURRENT placement (resets to 0 on
    migration because a resumed member stream restarts its seqs)."""

    __slots__ = (
        "sid", "model", "prompt", "max_new_tokens", "temperature", "eos_id",
        "seed", "tenant", "deadline_s", "member", "delivered",
        "member_acked", "out_seq", "out_chunks", "client_acked", "state",
        "error", "migrations", "trace", "routed_t", "touched", "tenant_held",
    )

    def __init__(self, sid: str, model: str, prompt: list[int],
                 max_new_tokens: int, temperature: float, eos_id: int | None,
                 seed: int, tenant: str, deadline_s: float | None,
                 member: str, trace: list | None, now: float) -> None:
        self.sid = sid
        self.model = model
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.seed = seed
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.member = member
        self.delivered: list[int] = []
        self.member_acked = 0
        self.out_seq = 0
        self.out_chunks: list[tuple[int, list[int]]] = []
        self.client_acked = 0
        self.state = "running"  # running | migrating | done | lost
        self.error: str | None = None
        self.migrations = 0
        self.trace = trace
        self.routed_t = now
        self.touched = now
        self.tenant_held = False

    def live(self) -> bool:
        return self.state in _LIVE_STATES

    def to_wire(self) -> dict[str, Any]:
        return {
            "model": self.model, "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature, "eos_id": self.eos_id,
            "seed": self.seed, "tenant": self.tenant,
            "deadline_s": self.deadline_s, "member": self.member,
            "delivered": list(self.delivered),
            "member_acked": self.member_acked, "out_seq": self.out_seq,
            "out_chunks": [[seq, list(toks)] for seq, toks in self.out_chunks],
            "client_acked": self.client_acked, "state": self.state,
            "error": self.error, "migrations": self.migrations,
            "trace": self.trace, "routed_t": self.routed_t,
        }

    @classmethod
    def from_wire(cls, sid: str, w: Mapping[str, Any], now: float) -> "Session":
        s = cls(
            sid, str(w["model"]), [int(t) for t in w["prompt"]],
            int(w["max_new_tokens"]), float(w.get("temperature", 0.0)),
            int(w["eos_id"]) if w.get("eos_id") is not None else None,
            int(w.get("seed", 0)), str(w.get("tenant", "default")),
            w.get("deadline_s"), str(w["member"]), w.get("trace"), now,
        )
        s.delivered = [int(t) for t in w.get("delivered", [])]
        s.member_acked = int(w.get("member_acked", 0))
        s.out_seq = int(w.get("out_seq", 0))
        s.out_chunks = [
            (int(seq), [int(t) for t in toks])
            for seq, toks in w.get("out_chunks", [])
        ]
        s.client_acked = int(w.get("client_acked", 0))
        s.state = str(w.get("state", "running"))
        s.error = w.get("error")
        s.migrations = int(w.get("migrations", 0))
        return s


class GenRouter:
    """Leader-side session router + ledger (module docstring)."""

    def __init__(
        self,
        rpc: Any,
        members: Callable[[], list[str]],
        *,
        metrics_for: Callable[[str], Mapping[str, float] | None] | None = None,
        tenants: Any = None,
        max_sessions: int = 256,
        drain_deadline_s: float = 30.0,
        session_ttl_s: float = 600.0,
        timeout_s: float = 10.0,
        retry_policy: Any = None,
        metrics: Any = None,
        flight: Any = None,
        clock: Callable[[], float] = monotonic,
    ) -> None:
        self.rpc = rpc
        self.members = members
        self.metrics_for = metrics_for
        self.max_sessions = int(max_sessions)
        self.drain_deadline_s = float(drain_deadline_s)
        self.session_ttl_s = float(session_ttl_s)
        self.timeout_s = float(timeout_s)
        self.retry_policy = retry_policy
        self.metrics = metrics
        self.flight = flight
        self.clock = clock
        # Set by StandbyLeader on promotion/abdication, like
        # JobScheduler.is_leading/epoch — candidates compare terms.
        self.is_leading = False
        self.epoch: list = [0, ""]
        self._tenants = tenants
        self.ledger = tenant_mod.TenantLedger(tenants, self.max_sessions)
        self._lock = threading.RLock()
        self._sessions: dict[str, Session] = {}
        # member -> {"t", "deadline_s", "complete", "reason"}
        self._drains: dict[str, dict[str, Any]] = {}

    # ---- RPC surface ----------------------------------------------------

    def methods(self) -> dict[str, Any]:
        return traced_methods({
            "job.generate": self._generate,
            "job.generate_poll": self._poll,
            "job.generate_cancel": self._cancel,
            "job.generate_sessions": lambda p: {
                "sessions": self.sessions_table()
            },
            "job.drain": self._drain_rpc,
            "job.undrain": self._undrain_rpc,
            "gen.state": lambda p: self.to_wire(),
        })

    def _require_leading(self) -> None:
        # Same guard as JobScheduler._start_rpc: a deferring standby must
        # not place sessions the acting leader knows nothing about.
        if not self.is_leading:
            raise RpcError("not the active leader")

    # ---- routing --------------------------------------------------------

    def _generate(self, p: dict[str, Any]) -> dict[str, Any]:
        self._require_leading()
        model = str(p["model"])
        prompt = [int(t) for t in p["prompt"]]
        max_new = int(p["max_new_tokens"])
        temperature = float(p.get("temperature", 0.0))
        eos_id = int(p["eos_id"]) if p.get("eos_id") is not None else None
        tenant = tenant_mod.current()
        sid = str(p.get("gen_id") or os.urandom(8).hex())
        if p.get("seed") is not None:
            seed = int(p["seed"])
        else:
            seed = int.from_bytes(os.urandom(4), "big") >> 1
        with self._lock:
            self._sweep_locked()
            existing = self._sessions.get(sid)
            if existing is not None:
                # Idempotent re-submit: the ledger entry IS the answer.
                return {"gen_id": sid, "model": existing.model,
                        "member": existing.member, "resumed": True}
            if self.ledger.would_exceed(tenant):
                self.ledger.note_shed(tenant)
                self._shed_note(tenant, "over_quota")
                raise Overloaded(
                    f"genroute: tenant {tenant!r} at quota "
                    f"({self.ledger.active(tenant)}/{self.ledger.quota(tenant)})",
                    retry_after_s=0.25, tenant=tenant, quota="over_quota",
                )
            live = sum(1 for s in self._sessions.values() if s.live())
            if live >= self.max_sessions:
                self._shed_note(tenant, "gate_full")
                raise Overloaded(
                    f"genroute: session ledger full ({live} live)",
                    retry_after_s=0.25, tenant=tenant, quota="gate_full",
                )
        payload: dict[str, Any] = {
            "model": model, "prompt": prompt, "max_new_tokens": max_new,
            "temperature": temperature, "eos_id": eos_id,
            "gen_id": sid, "seed": seed,
        }
        excluded: set[str] = set()
        target: str | None = None
        for _ in range(8):
            with self._lock:
                candidate = self._pick_locked(model, tenant, excluded)
            if candidate is None:
                raise RpcError(
                    f"no eligible member serves {model!r} "
                    f"(draining/convicted/dead excluded: {sorted(excluded)})"
                )
            try:
                # Outside the lock (L1). Overloaded propagates typed to the
                # client — its retry-after contract is the member's shed.
                self.rpc.call(candidate, "job.generate", payload,
                              timeout=self.timeout_s)
            except RpcUnreachable:
                # Dead-but-not-yet-detected member: try the next one.
                excluded.add(candidate)
                continue
            target = candidate
            break
        if target is None:
            raise RpcError(
                f"every candidate for {model!r} was unreachable: "
                f"{sorted(excluded)}"
            )
        now = self.clock()
        with self._lock:
            if sid in self._sessions:
                # Lost a concurrent duplicate-submit race: the member-side
                # gen_id dedup means both submits share one stream; keep
                # the first ledger entry (no double adoption).
                s = self._sessions[sid]
                return {"gen_id": sid, "model": s.model, "member": s.member,
                        "resumed": True}
            s = Session(sid, model, prompt, max_new, temperature, eos_id,
                        seed, tenant, None, target,
                        tracectx.to_wire(tracectx.current()), now)
            self._sessions[sid] = s
            self.ledger.acquire(tenant)
            s.tenant_held = True
        if self.metrics is not None:
            self.metrics.inc("gen_sessions_routed")
        if self.flight is not None:
            self.flight.note("route", gen_id=sid, model=model, member=target,
                             tenant=tenant, prompt=len(prompt))
        return {"gen_id": sid, "model": model, "member": target}

    def _shed_note(self, tenant: str, verdict: str) -> None:
        if self.metrics is not None:
            self.metrics.inc("shed")
            self.metrics.inc("shed_genroute")
        if self.flight is not None:
            self.flight.note("shed", gate="genroute", tenant=tenant,
                             quota=verdict)

    def _pick_locked(self, model: str, tenant: str,
                     exclude: set[str]) -> str | None:
        """Least-loaded eligible member by the scraped gauges, with the
        ledger's own residency correcting scrape lag and session affinity
        (same tenant+model) breaking ties. Draining and breaker-convicted
        members are never eligible."""
        candidates = []
        for m in self.members():
            if m in exclude or m in self._drains:
                continue
            if self.retry_policy is not None and not self.retry_policy.allow(m):
                continue
            candidates.append(m)
        if not candidates:
            return None
        resident: dict[str, int] = {}
        affinity: set[str] = set()
        for s in self._sessions.values():
            if s.live():
                resident[s.member] = resident.get(s.member, 0) + 1
                if s.tenant == tenant and s.model == model:
                    affinity.add(s.member)

        def load(m: str) -> float:
            g = self.metrics_for(m) if self.metrics_for is not None else None
            g = g or {}
            # A scraped gauge can be PRESENT but None-valued (hbm_*/mfu_*
            # degrade gracefully on CPU backends) — treat None as zero.
            slots = float(g.get(f"generate-{model}_slots_active") or 0.0)
            pages = float(g.get(f"generate-{model}_pages_free") or 0.0)
            mfu = float(g.get(f"mfu_{model}") or 0.0)
            # Busy slots and a hot chip push a member down the order; free
            # KV pages pull it up (pages are what a long prompt needs).
            return resident.get(m, 0) + slots + mfu - 0.01 * pages

        return min(
            candidates,
            key=lambda m: (round(load(m), 3), 0 if m in affinity else 1, m),
        )

    # ---- streaming ------------------------------------------------------

    def _poll(self, p: dict[str, Any]) -> dict[str, Any]:
        self._require_leading()
        sid = str(p["gen_id"])
        ack = int(p.get("ack", 0))
        now = self.clock()
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                raise RpcError(f"unknown generation {sid!r} (done+acked, "
                               "cancelled, or expired)")
            s.touched = now
            if ack > s.client_acked:
                s.client_acked = ack
                s.out_chunks = [c for c in s.out_chunks if c[0] > ack]
            member, macked = s.member, s.member_acked
            fetch = s.state == "running"
        amnesia = False
        if fetch:
            try:
                r = self.rpc.call(member, "job.generate_poll",
                                  {"gen_id": sid, "ack": macked},
                                  timeout=self.timeout_s)
            except RpcUnreachable as e:
                # Serve retained chunks; the tick loop owns the
                # migrate-or-not verdict (one lost poll isn't a conviction).
                log.warning("poll of %s on %s unreachable: %s", sid, member, e)
                r = None
            except RpcError as e:
                r = None
                if "unknown generation" in str(e):
                    # Member amnesia: alive but restarted (or swept) — its
                    # copy of the session is gone for good. Migrate now.
                    amnesia = True
                else:
                    log.warning("poll of %s on %s failed: %s", sid, member, e)
            if r is not None:
                self._fold(sid, member, r)
        if amnesia:
            self._migrate(sid, "member_amnesia")
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                raise RpcError(f"unknown generation {sid!r}")
            return {
                "chunks": [[seq, list(toks)] for seq, toks in s.out_chunks],
                "done": s.state in ("done", "lost"),
                "error": s.error,
            }

    def _fold(self, sid: str, member: str, r: Mapping[str, Any]) -> None:
        """Splice a member poll reply into the session's own seq space.
        Exactly-once: ``member_acked`` is cumulative per placement and the
        ``s.member == member`` staleness check drops replies from a
        placement the session migrated away from mid-call."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None or s.member != member or s.state != "running":
                return
            for seq, toks in sorted(r.get("chunks", [])):
                seq = int(seq)
                if seq <= s.member_acked:
                    continue
                s.member_acked = seq
                toks = [int(t) for t in toks]
                s.delivered.extend(toks)
                s.out_seq += 1
                s.out_chunks.append((s.out_seq, toks))
            if r.get("done"):
                s.state = "done"
                s.error = r.get("error")
                self._retire_locked(s)

    def _cancel(self, p: dict[str, Any]) -> dict[str, Any]:
        self._require_leading()
        sid = str(p["gen_id"])
        with self._lock:
            s = self._sessions.pop(sid, None)
            if s is None:
                return {"cancelled": False}
            member = s.member if s.state == "running" else None
            self._retire_locked(s)
        if member is not None:
            try:
                self.rpc.call(member, "job.generate_cancel",
                              {"gen_id": sid, "reason": "cancel"},
                              timeout=self.timeout_s)
            except (RpcUnreachable, RpcError) as e:
                # The member-side TTL sweep reaps it eventually.
                log.warning("cancel of %s on %s failed: %s", sid, member, e)
        return {"cancelled": True}

    # ---- drain ----------------------------------------------------------

    def _drain_rpc(self, p: dict[str, Any]) -> dict[str, Any]:
        self._require_leading()
        deadline = p.get("deadline_s")
        return self.drain(str(p["member"]),
                          deadline_s=float(deadline)
                          if deadline is not None else None)

    def _undrain_rpc(self, p: dict[str, Any]) -> dict[str, Any]:
        self._require_leading()
        return self.undrain(str(p["member"]))

    def drain(self, member: str, deadline_s: float | None = None,
              reason: str = "operator") -> dict[str, Any]:
        """Flip ``member`` to stop-admitting. Resident sessions get
        ``deadline_s`` to finish; whoever is still live at the deadline is
        migrated by the tick loop. Idempotent (a re-drain tightens the
        deadline, never extends it)."""
        if deadline_s is None:
            deadline_s = self.drain_deadline_s
        with self._lock:
            d = self._drains.get(member)
            fresh = d is None
            if d is None:
                d = self._drains[member] = {
                    "t": self.clock(), "deadline_s": float(deadline_s),
                    "complete": False, "reason": reason,
                }
            else:
                d["deadline_s"] = min(float(d["deadline_s"]), float(deadline_s))
            resident = sum(1 for s in self._sessions.values()
                           if s.live() and s.member == member)
            effective = float(d["deadline_s"])
        if fresh:
            if self.flight is not None:
                self.flight.note("drain_start", member=member,
                                 deadline_s=effective, resident=resident,
                                 reason=reason)
            log.info("draining %s: %d resident session(s), deadline %.1fs",
                     member, resident, effective)
        return {"member": member, "draining": True,
                "deadline_s": effective, "resident": resident}

    def undrain(self, member: str) -> dict[str, Any]:
        with self._lock:
            was = self._drains.pop(member, None)
        return {"member": member, "draining": False, "was": was is not None}

    def drain_active(self) -> int:
        """The ``gen_drain_active`` gauge: members mid-drain (not complete)."""
        with self._lock:
            return sum(1 for d in self._drains.values() if not d["complete"])

    def draining(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {
                m: {"deadline_s": d["deadline_s"], "complete": d["complete"],
                    "reason": d["reason"],
                    "age_s": round(self.clock() - d["t"], 3)}
                for m, d in self._drains.items()
            }

    def release_capacity(self, model: str, keep: int) -> bool:
        """Autoscaler scale-down seam (scheduler/autoscaler.py drain hook):
        OK to shrink to ``keep`` members only once at most ``keep`` still
        hold live sessions of ``model``. Otherwise initiate a drain on the
        lightest extra member(s) and HOLD the shrink until their sessions
        finish or migrate — scale-down must never abandon a stream."""
        with self._lock:
            hosting: dict[str, int] = {}
            for s in self._sessions.values():
                if s.live() and s.model == model:
                    hosting[s.member] = hosting.get(s.member, 0) + 1
            extra = len(hosting) - int(keep)
            if extra <= 0:
                return True
            victims = [
                m for m in sorted(hosting, key=lambda m: (hosting[m], m))
                if m not in self._drains
            ][:extra]
        for m in victims:
            self.drain(m, reason="autoscale")
        return False

    # ---- migration (tick loop) ------------------------------------------

    def tick(self) -> dict[str, int]:
        """Leader-loop body: migrate sessions off dead, breaker-convicted,
        or deadline-expired-drain members; mark drains complete when they
        empty; sweep expired ledger entries. No-op on a non-leader."""
        if not self.is_leading:
            return {"migrated": 0}
        alive = set(self.members())
        now = self.clock()
        moves: list[tuple[str, str]] = []
        with self._lock:
            self._sweep_locked()
            for sid, s in self._sessions.items():
                if s.state != "running":
                    continue
                m = s.member
                if m not in alive:
                    moves.append((sid, "member_lost"))
                elif self.retry_policy is not None and \
                        not self.retry_policy.allow(m):
                    moves.append((sid, "breaker"))
                else:
                    d = self._drains.get(m)
                    if d is not None and now - d["t"] >= d["deadline_s"]:
                        moves.append((sid, "drain"))
        migrated = 0
        for sid, why in moves:
            if self._migrate(sid, why):
                migrated += 1
        completed: list[str] = []
        with self._lock:
            for member, d in self._drains.items():
                if d["complete"]:
                    continue
                if any(s.live() and s.member == member
                       for s in self._sessions.values()):
                    continue
                d["complete"] = True
                completed.append(member)
        for member in completed:
            if self.flight is not None:
                self.flight.note("drain_complete", member=member)
            log.info("drain of %s complete (no resident sessions)", member)
        return {"migrated": migrated}

    def _migrate(self, sid: str, why: str) -> bool:
        """Move one session to a survivor: re-prefill prompt+delivered with
        the session's seed (token-identical continuation, engine docstring)
        and reset the per-placement ack. The ``migrating`` state is the
        single-flight guard — a concurrent tick/poll cannot double-migrate."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None or s.state != "running":
                return False
            if s.eos_id is not None and s.delivered and \
                    s.delivered[-1] == s.eos_id:
                # The terminal token already reached the ledger; the member
                # died between it and the done verdict. Nothing to resume.
                s.state = "done"
                self._retire_locked(s)
                return False
            remaining = s.max_new_tokens - len(s.delivered)
            if remaining <= 0:
                s.state = "done"
                self._retire_locked(s)
                return False
            s.state = "migrating"
            old = s.member
            target = self._pick_locked(s.model, s.tenant, {old})
            if target is None:
                self._lost_locked(
                    s, f"no surviving member serves {s.model!r} ({why})"
                )
                return False
            payload = {
                "model": s.model, "prompt": list(s.prompt),
                "max_new_tokens": remaining, "temperature": s.temperature,
                "eos_id": s.eos_id, "gen_id": sid, "seed": s.seed,
                "resume_tokens": list(s.delivered),
            }
            tenant, trace = s.tenant, s.trace
            old_alive = old in set(self.members())
        if old_alive:
            # Drain/breaker path: the old member still holds the slot —
            # release it so it stops decoding dead tokens (reason rides
            # into its session_sweep flight note).
            try:
                self.rpc.call(old, "job.generate_cancel",
                              {"gen_id": sid, "reason": "migrated"},
                              timeout=self.timeout_s)
            except (RpcUnreachable, RpcError) as e:
                log.warning("cancel of %s on %s failed: %s", sid, old, e)
        try:
            # The session's submit-time trace context parents the resumed
            # member's rpc/job.generate + gen/* spans into the SAME trace
            # (tools/trace_smoke.py pins this), and the tenant binding
            # keeps quota attribution across the hop.
            with tenant_mod.bind(tenant):
                with tracectx.bind(tracectx.from_wire(trace)):
                    self.rpc.call(target, "job.generate", payload,
                                  timeout=self.timeout_s)
        except (Overloaded, RpcUnreachable) as e:
            # Target shed or died before prefilling anything: back to
            # ``running`` so the next tick retries another survivor.
            log.warning("resume of %s on %s deferred: %s", sid, target, e)
            with self._lock:
                s2 = self._sessions.get(sid)
                if s2 is not None and s2.state == "migrating":
                    s2.state = "running"
            return False
        except RpcError as e:
            # A refusal (resume prefix exceeds the target's max_prefill,
            # unknown model): terminal for this stream.
            with self._lock:
                s2 = self._sessions.get(sid)
                if s2 is not None and s2.state == "migrating":
                    self._lost_locked(s2, f"resume on {target} refused: {e}")
            return False
        with self._lock:
            s2 = self._sessions.get(sid)
            if s2 is None or s2.state != "migrating":
                return False
            s2.member = target
            s2.member_acked = 0
            s2.migrations += 1
            s2.state = "running"
            delivered = len(s2.delivered)
        if self.metrics is not None:
            self.metrics.inc("gen_migrations")
        if self.flight is not None:
            self.flight.note("migrate", gen_id=sid, from_=old, to=target,
                             reason=why, delivered=delivered)
        log.info("migrated session %s %s -> %s (%s, %d tokens re-prefilled)",
                 sid, old, target, why, delivered)
        return True

    def _lost_locked(self, s: Session, why: str) -> None:
        s.state = "lost"
        s.error = f"session lost: {why}"
        self._retire_locked(s)
        if self.metrics is not None:
            self.metrics.inc("gen_sessions_lost")
        if self.flight is not None:
            self.flight.note("session_lost", gen_id=s.sid, member=s.member,
                             reason=why)
        log.warning("session %s lost: %s", s.sid, why)

    def _retire_locked(self, s: Session) -> None:
        if s.tenant_held:
            s.tenant_held = False
            self.ledger.release(s.tenant)

    def _sweep_locked(self) -> None:
        now = self.clock()
        for sid, s in list(self._sessions.items()):
            if now - s.touched <= self.session_ttl_s:
                continue
            self._sessions.pop(sid)
            self._retire_locked(s)
            if s.live():
                # Abandoned live stream: the member-side TTL sweep reaps
                # its slot; dropping the ledger entry stops routing
                # maintenance for it.
                log.info("swept abandoned session %s", sid)

    # ---- leader-state machinery -----------------------------------------

    def to_wire(self) -> dict[str, Any]:
        """Epoch-keyed ledger snapshot (``gen.state``), the standby sync
        payload — same shape discipline as JobScheduler.to_wire."""
        with self._lock:
            return {
                "epoch": list(self.epoch),
                "sessions": {sid: s.to_wire()
                             for sid, s in self._sessions.items()},
                "drains": {m: dict(d) for m, d in self._drains.items()},
            }

    def adopt_state(self, wire: Mapping[str, Any]) -> int:
        """Copy the leader's ledger (standby sync loop). Never rewinds a
        session's delivered prefix — a stale snapshot must not undo folded
        tokens — and merges by sid, so adoption is idempotent and a sid can
        never be adopted into two entries (the no-duplicate-adoption
        invariant dmlc-mc's ``session_migrate`` scenario checks). Returns
        the number of NEW sids adopted."""
        adopted = 0
        now = self.clock()
        with self._lock:
            for sid, w in dict(wire.get("sessions", {})).items():
                cur = self._sessions.get(sid)
                if cur is not None and \
                        len(cur.delivered) > len(w.get("delivered", ())):
                    continue
                if cur is None:
                    adopted += 1
                self._sessions[sid] = Session.from_wire(sid, w, now)
            for m, d in dict(wire.get("drains", {})).items():
                if m not in self._drains:
                    self._drains[m] = dict(d)
            self._rebuild_ledger_locked()
        return adopted

    def readopt(self) -> int:
        """Promotion hook (StandbyLeader._promote): every live entry keeps
        its placement — the new leader RE-ADOPTS streams, it never
        re-places them (that would be the duplicate-prefill bug the soak
        pins). A migration the dead leader left in flight drops back to
        ``running`` so the tick loop re-drives it; the member-side gen_id
        dedup keeps even a double-driven migration at one prefill."""
        with self._lock:
            n = 0
            for s in self._sessions.values():
                if s.state == "migrating":
                    s.state = "running"
                if s.live():
                    n += 1
            self._rebuild_ledger_locked()
        if self.flight is not None and n:
            self.flight.note("gen_readopt", sessions=n,
                             epoch=list(self.epoch))
        return n

    def _rebuild_ledger_locked(self) -> None:
        self.ledger = tenant_mod.TenantLedger(self._tenants,
                                              self.max_sessions)
        for s in self._sessions.values():
            if s.live():
                self.ledger.acquire(s.tenant)
                s.tenant_held = True
            else:
                s.tenant_held = False

    # ---- observability --------------------------------------------------

    def sessions_table(self) -> list[dict[str, Any]]:
        """The CLI ``sessions`` verb's rows, route order."""
        with self._lock:
            return [
                {"id": s.sid, "model": s.model, "member": s.member,
                 "tenant": s.tenant, "delivered": len(s.delivered),
                 "state": s.state, "migrations": s.migrations}
                for s in sorted(self._sessions.values(),
                                key=lambda s: (s.routed_t, s.sid))
            ]

    def status(self) -> dict[str, Any]:
        with self._lock:
            live = sum(1 for s in self._sessions.values() if s.live())
            total = len(self._sessions)
        return {
            "sessions": live,
            "total": total,
            "drains": self.draining(),
        }
