"""Leader failover: candidate tracking, liveness probing, standby state sync.

Copied from ``dmlc_tpu/cluster/failover.py`` (the whole module): the
probe, the promotion rule, the epochs and the mirrored state
(``job.state``, ``sdfs.state``) are the JAX package's, so a candidate of
either package defers to, mirrors and takes over from the other.
``mesh_bootstrap`` is the node's ``parallel/multihost.MeshBootstrap`` when
it configures ``mesh_processes`` > 1, whose rank map a standby mirrors
through ``mesh.state``; ``genrouter`` is the node's ``GenRouter``, whose
ledger a standby mirrors through ``gen.state``.

Capability parity with the reference's failover machinery:

- a configured ordered list of leader candidates (was the hardcoded
  ``LEADER_HOSTNAMES``, src/services.rs:26-30 — here it's config data)
- member-side probe loop: call ``leader.alive`` every probe interval; on
  failure advance to the next candidate, wrapping (services.rs:527-545,
  575-580)
- standby-leader loop: while not current leader, copy job state from the
  current leader; on becoming leader with nonempty history, auto-resume
  the prediction jobs (services.rs:212-240)

Together with the scheduler's resume-from-cursor this gives the reference's
headline behavior: "the new leader will try to pick up where it left off"
(CS425MP4Report), detectable within one probe interval.
"""

from __future__ import annotations

import logging
from typing import Callable

from dmlc_tpu_torch.cluster.rpc import Rpc, RpcError, RpcUnreachable
from dmlc_tpu_torch.utils.tracing import tracer

log = logging.getLogger(__name__)


def epoch_key(epoch) -> tuple[int, str]:
    """Total order over leadership epochs. An epoch is [counter, claimant]:
    counters order successive terms; the claimant address breaks the tie
    when two partitioned candidates claim the same counter — deterministic,
    so every member and every candidate agrees on which term is newer."""
    return int(epoch[0]), str(epoch[1])


class LeaderTracker:
    """Which candidate do I currently believe is leader? Probe and advance.

    ``retry_policy`` (cluster/retrypolicy.py, optional) breaker-gates the
    probes: once a candidate has failed enough consecutive probes its
    breaker opens, and subsequent ticks SKIP the 2 s timeout against it —
    advancing to the next candidate immediately — until the cooldown admits
    one half-open probe. With every candidate down, a full wrap costs one
    budgeted probe per cooldown window instead of candidates x timeout of
    blocked probe-loop time per tick."""

    def __init__(self, rpc: Rpc, candidates: list[str], retry_policy=None):
        if not candidates:
            raise ValueError("need at least one leader candidate")
        self.rpc = rpc
        self.candidates = list(candidates)
        self.index = 0
        self.retry_policy = retry_policy

    @property
    def current(self) -> str:
        return self.candidates[self.index]

    def probe(self, timeout: float = 2.0) -> bool:
        """One check; advances to the next candidate unless the current one
        is reachable AND actively leading. Liveness alone is not enough: a
        rebooted ex-leader answers RPCs as a deferring standby, and routing
        verbs there would mutate state its sync loop immediately overwrites."""
        if self.retry_policy is not None and not self.retry_policy.allow(self.current):
            reason = "breaker open (recent probes failed)"
        else:
            try:
                with tracer.span("failover/probe", candidate=self.current):
                    status = self.rpc.call(
                        self.current, "leader.status", {}, timeout=timeout
                    )
                if self.retry_policy is not None:
                    self.retry_policy.record(self.current)
                if status.get("leading"):
                    return True
                reason = "alive but not leading"
            except (RpcUnreachable, RpcError) as e:
                if self.retry_policy is not None:
                    self.retry_policy.record(self.current, e)
                reason = str(e)
        prev = self.current
        self.index = (self.index + 1) % len(self.candidates)
        log.warning("leader %s (%s); trying %s", prev, reason, self.current)
        return False


class StandbyLeader:
    """A leader candidate that is not (yet) the active leader.

    ``step()`` implements one pass of the reference's 3 s monitor loop
    (services.rs:212-240), with one correction to the reference's design:
    leadership is *claimed and observed*, not implied by list position. A
    candidate promotes only when no candidate anywhere answers
    ``leader.status`` with ``leading: true`` AND every candidate ahead of it
    is dead — so a rebooted ex-leader defers to whoever promoted in its
    absence instead of creating a second active leader. While another
    candidate leads, we mirror its job state AND its SDFS directory (the
    reference replicated only job state; losing the directory on failover
    would orphan every stored file and recycle version numbers).

    Like the reference's static-candidate scheme, this is liveness-based,
    not a consensus protocol: a full network partition between candidates
    can still yield two claimants until the partition heals. Leadership
    EPOCHS fence the damage: every promotion takes a term strictly newer
    than any term it has observed ([counter+1, self]), members reject SDFS
    writes from older terms (SdfsMember fencing), and on heal the claimant
    with the older term sees the newer one and abdicates — so a write acked
    by a stale claimant is (a) rejected at every member whose fence has seen
    the newer term and (b) never silently replaced under the same version by
    the winning term's directory without having been refused first. The
    fence persists across member restarts (SdfsMember._save_fence), so the
    remaining window is a member that was UNREACHABLE during fence_members()
    and has never seen a newer-term write: it stays legacy-open to the stale
    claimant until the first fenced write reaches it.
    """

    def __init__(
        self,
        rpc: Rpc,
        self_addr: str,
        candidates: list[str],
        scheduler,
        sdfs_leader=None,
        mesh_bootstrap=None,
        genrouter=None,
        on_promote: Callable[[], None] | None = None,
    ):
        self.rpc = rpc
        self.self_addr = self_addr
        self.candidates = list(candidates)
        self.scheduler = scheduler
        self.sdfs_leader = sdfs_leader
        self.mesh_bootstrap = mesh_bootstrap
        self.genrouter = genrouter
        self.on_promote = on_promote
        self.is_leader = False
        # Highest leadership epoch observed anywhere (my own while leading):
        # promotions take [observed_counter + 1, self_addr].
        self.seen_epoch: list = [0, ""]

    def _observe_epoch(self, epoch) -> None:
        if epoch is not None and epoch_key(epoch) > epoch_key(self.seen_epoch):
            self.seen_epoch = [int(epoch[0]), str(epoch[1])]

    def step(self) -> None:
        if self.is_leader:
            self._leading_step()
            return
        leading = None
        alive: set[str] = set()
        for addr in self.candidates:
            if addr == self.self_addr:
                continue
            try:
                status = self.rpc.call(addr, "leader.status", {}, timeout=2.0)
            except (RpcUnreachable, RpcError):
                continue
            alive.add(addr)
            self._observe_epoch(status.get("epoch"))
            if status.get("leading"):
                leading = addr
                break
        if leading is not None:
            self._sync_from(leading)
            return
        # Nobody claims leadership: the first live candidate takes over.
        for addr in self.candidates:
            if addr == self.self_addr:
                self._promote()
                return
            if addr in alive:
                return  # a live candidate ahead of us will promote

    def _leading_step(self) -> None:
        """While leading, watch for a claimant with a NEWER term (the healed
        half of a candidate partition): the older term must abdicate, not
        co-lead. Same-or-older claimants are ignored — they will see us and
        abdicate themselves."""
        for addr in self.candidates:
            if addr == self.self_addr:
                continue
            try:
                status = self.rpc.call(addr, "leader.status", {}, timeout=2.0)
            except (RpcUnreachable, RpcError):
                continue
            other = status.get("epoch")
            if (
                status.get("leading")
                and other is not None
                and epoch_key(other) > epoch_key(self.seen_epoch)
            ):
                self._abdicate(addr, other)
                return

    def _abdicate(self, winner: str, winner_epoch) -> None:
        log.warning(
            "%s: abdicating epoch %s to %s (epoch %s)",
            self.self_addr, self.seen_epoch, winner, winner_epoch,
        )
        self._observe_epoch(winner_epoch)
        self.is_leader = False
        self.scheduler.is_leading = False
        if self.sdfs_leader is not None:
            self.sdfs_leader.is_leading = False
        if self.mesh_bootstrap is not None:
            self.mesh_bootstrap.is_leading = False
        if self.genrouter is not None:
            self.genrouter.is_leading = False
        # Drop in-flight work and mirror the winner — identical to a fresh
        # standby joining.
        self._sync_from(winner)

    def _sync_from(self, addr: str) -> None:
        try:
            state = self.rpc.call(addr, "job.state", {}, timeout=2.0)
            self.scheduler.adopt_state(state)
            if self.sdfs_leader is not None:
                wire = self.rpc.call(addr, "sdfs.state", {}, timeout=2.0)
                self._observe_epoch(wire.get("epoch"))
                self.sdfs_leader.adopt_state(wire)
            if self.mesh_bootstrap is not None:
                wire = self.rpc.call(addr, "mesh.state", {}, timeout=2.0)
                self.mesh_bootstrap.adopt_state(wire)
            if self.genrouter is not None:
                # Mirror the generation-session ledger so a promotion can
                # re-adopt every live stream (scheduler/genrouter.py).
                wire = self.rpc.call(addr, "gen.state", {}, timeout=2.0)
                self._observe_epoch(wire.get("epoch"))
                self.genrouter.adopt_state(wire)
        except (RpcUnreachable, RpcError) as e:
            log.warning("standby sync from %s failed: %s", addr, e)

    def _promote(self) -> None:
        self.is_leader = True
        self.seen_epoch = [int(self.seen_epoch[0]) + 1, self.self_addr]
        self.scheduler.is_leading = True
        self.scheduler.epoch = list(self.seen_epoch)
        if self.sdfs_leader is not None:
            self.sdfs_leader.is_leading = True
            self.sdfs_leader.epoch = list(self.seen_epoch)
            # Best-effort fence announcement: members learn the new term
            # BEFORE it accepts writes, so a stale claimant's placements
            # bounce instead of landing (reachable members only — the fence
            # still tightens as writes carry the epoch). Then rebuild
            # reservations from member inventories, so versions acked by the
            # old term but never mirrored here are not re-issued.
            # fence_members may ADOPT a newer term if member fences outrank
            # ours (persisted fences after a full restart) — keep the
            # failover's and scheduler's view of the epoch in lockstep.
            adopted = self.sdfs_leader.fence_members()
            if epoch_key(adopted) > epoch_key(self.seen_epoch):
                self.seen_epoch = list(adopted)
                self.scheduler.epoch = list(adopted)
            self.sdfs_leader.reconcile_from_members()
        if self.mesh_bootstrap is not None:
            self.mesh_bootstrap.is_leading = True
        if self.genrouter is not None:
            self.genrouter.is_leading = True
            self.genrouter.epoch = list(self.seen_epoch)
        log.warning("%s: promoting to leader (epoch %s)", self.self_addr, self.seen_epoch)
        if self.scheduler.has_history():
            # Resume interrupted jobs from the replicated cursor.
            self.scheduler._start({})
        if self.genrouter is not None:
            # Re-adopt every live generation stream from the mirrored
            # ledger — placements are kept, never re-placed.
            self.genrouter.readopt()
        if self.on_promote is not None:
            self.on_promote()
