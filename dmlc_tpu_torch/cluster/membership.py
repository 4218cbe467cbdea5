"""Gossip membership + failure detection.

Copied from ``dmlc_tpu/cluster/membership.py`` (the whole module).

Capability parity with the reference's membership layer (src/membership.rs):

- ring heartbeating: every round each node refreshes itself and pings its k=2
  nearest ring neighbors on each side with its full membership list
  (membership.rs:225-259, utils.rs:5-21)
- failure detection: a neighbor silent for > failure_timeout is marked FAILED,
  with a one-round grace period for newly-adjacent neighbors
  (membership.rs:261-291) — hardened beyond the reference with SWIM-style
  indirect probes: a suspect (silent past half the timeout) is ping-req'd
  through other members, whose relayed acks ("ack2") count as liveness, so a
  lossy direct link never produces a false FAILED verdict on its own
- anti-entropy merge: for a known id, newer last_active wins, ties resolve
  by status rank (LEFT > FAILED > ACTIVE — a deterministic join, see
  merge_entry); unknown ids are inserted (membership.rs:302-327)
- join/welcome bootstrap with fast-rejoin: a joiner bumps its incarnation
  timestamp; the introducer fails stale same-address entries so the new
  incarnation supersedes them (membership.rs:113-123,185-214)

Redesigned, not translated: the protocol core is sans-IO — a pure state
machine advanced by ``step()`` with an injected Clock and Transport — so the
deterministic simulator (tests/test_membership.py) can run crash / partition /
rejoin scenarios hermetically, which the reference could only do by killing
VMs by hand. In deployment a runner thread calls ``step()`` on the real clock
(cluster/node.py); on a TPU fleet one membership node runs per TPU-VM host
over DCN, and chips never appear here — devices are the mesh's concern
(parallel/mesh.py), hosts are the cluster's.
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

from dmlc_tpu_torch.cluster.clock import Clock
from dmlc_tpu_torch.cluster.transport import Transport
from dmlc_tpu_torch.utils.config import ClusterConfig
from dmlc_tpu_torch.utils.ring import symmetric_ring_neighbors

log = logging.getLogger(__name__)


class Status(str, Enum):
    ACTIVE = "active"
    FAILED = "failed"
    LEFT = "left"


NodeId = tuple[str, float]  # (address, incarnation timestamp)


@dataclass
class Member:
    status: Status
    last_active: float

    def to_wire(self) -> list:
        return [self.status.value, self.last_active]

    @classmethod
    def from_wire(cls, w: list) -> "Member":
        return cls(Status(w[0]), float(w[1]))


# Tie-break rank for equal last_active: any non-ACTIVE verdict beats ACTIVE
# (a failure can't be gossiped away by an equally-old ACTIVE copy), and LEFT
# beats FAILED (a deliberate exit outranks a suspicion). The order must be
# TOTAL: with a mere "non-ACTIVE wins" rule, two nodes holding FAILED@t and
# LEFT@t adopt each other's verdict on every ping and never converge.
_STATUS_RANK = {Status.ACTIVE: 0, Status.FAILED: 1, Status.LEFT: 2}


def merge_entry(current: Member | None, incoming: Member) -> Member:
    """Anti-entropy conflict resolution: newer last_active wins; ties resolve
    by status rank — a deterministic join, so merge order can't matter."""
    if current is None or incoming.last_active > current.last_active:
        return incoming
    if (
        incoming.last_active == current.last_active
        and _STATUS_RANK[incoming.status] > _STATUS_RANK[current.status]
    ):
        return incoming
    return current


class MembershipNode:
    """One node's view of the cluster. Drive with handle() for incoming
    messages and step() once per heartbeat interval."""

    def __init__(
        self,
        config: ClusterConfig,
        transport: Transport,
        clock: Clock,
        on_change: Callable[[NodeId, Member], None] | None = None,
    ):
        self.config = config
        self.transport = transport
        self.clock = clock
        self.on_change = on_change
        self.self_id: NodeId = (transport.address, clock.now())
        self.members: dict[NodeId, Member] = {
            self.self_id: Member(Status.ACTIVE, clock.now())
        }
        self._prev_neighbors: set[NodeId] = set()
        # Failure detection runs on LOCAL receipt times, never on gossiped
        # remote-clock stamps: when we hear a node directly (ping, ack, or a
        # relayed indirect ack) we stamp our own clock here. Gossiped
        # last_active orders anti-entropy merges only. This makes detection
        # latency independent of clock skew.
        self._last_heard: dict[NodeId, float] = {}
        # SWIM-style indirect probing: target -> {requester addr: stamp} of
        # ping-req relays we owe an ack2 forward for. Keyed by requester so
        # a suspect re-probed every round yields ONE ack2 per requester,
        # not one per round. Pruned past the failure timeout.
        self._relay: dict[NodeId, dict[str, float]] = {}
        self._left = False
        # Deterministic per-node RNG for gossip sampling: reproducible sim
        # runs, distinct sequences across nodes.
        self._rng = random.Random(hash(self.self_id))
        # handle() runs on the transport's receiver thread while step() runs
        # on the node's stepper thread; all state access goes through this
        # lock (a no-op cost in the single-threaded simulator).
        self._lock = threading.RLock()
        transport.set_handler(self.handle)

    # ---- queries -------------------------------------------------------

    def active_ids(self) -> list[NodeId]:
        with self._lock:
            return sorted(i for i, m in self.members.items() if m.status == Status.ACTIVE)

    def list_membership(self) -> list[tuple[NodeId, Member]]:
        with self._lock:
            return sorted(self.members.items())

    def is_active(self, node_id: NodeId) -> bool:
        m = self.members.get(node_id)
        return m is not None and m.status == Status.ACTIVE

    # ---- lifecycle -----------------------------------------------------

    def join(self, introducer: str) -> None:
        """(Re)join via an introducer address. Bumps our incarnation so any
        stale entry for our address is superseded cluster-wide."""
        with self._lock:
            now = self.clock.now()
            old = self.self_id
            self.self_id = (self.transport.address, now)
            self.members.pop(old, None)
            self.members[self.self_id] = Member(Status.ACTIVE, now)
            self._left = False
            # A fresh incarnation starts with a clean detector: stale
            # neighbor stamps from the previous life must not insta-fail
            # nodes that were silent only because we were gone.
            self._prev_neighbors = set()
            self._last_heard = {}
        if introducer != self.transport.address:
            self.transport.send(introducer, {"t": "join", "sender": list(self.self_id)})

    def leave(self) -> None:
        """Graceful exit: gossip a LEFT verdict so peers drop us without
        waiting out the failure timeout."""
        with self._lock:
            self._left = True
            me = self.members[self.self_id]
            me.status = Status.LEFT
            me.last_active = self.clock.now()
            for n in self._neighbors():
                self._send_ping(n)  # under the lock: _wire_list iterates members

    # ---- periodic step (pinger + detector) -----------------------------

    def step(self) -> None:
        with self._lock:
            if self._left:
                return
            now = self.clock.now()
            self.members[self.self_id].last_active = now  # self-refresh
            neighbors = self._neighbors()
            for n in neighbors:
                self._send_ping(n)
                # A just-(re)adopted neighbor starts its silence clock now —
                # one full timeout of grace before it can be judged (a stale
                # stamp from a previous adjacency must not insta-fail it).
                if n not in self._prev_neighbors:
                    self._last_heard[n] = now
            # Detector: only judge nodes that were already neighbors last
            # round, and only on locally-stamped receipt times. A SUSPECT
            # (silent past half the timeout) first gets indirect probes:
            # ping-reqs to other members who ping it and relay its ack back
            # (SWIM) — a lossy direct link then never becomes a false
            # FAILED verdict, because evidence arrives via a third party.
            cutoff = now - self.config.failure_timeout_s
            suspect_cutoff = now - self.config.failure_timeout_s / 2
            judged = self._prev_neighbors & set(neighbors)
            r = self.config.indirect_probes
            for n in judged:
                m = self.members.get(n)
                heard = self._last_heard.get(n, now)
                if m is None or m.status != Status.ACTIVE:
                    continue
                if heard < cutoff:
                    self._set(n, Member(Status.FAILED, m.last_active))
                    log.warning("%s: detected failure of %s", self.transport.address, n)
                elif r > 0 and heard < suspect_cutoff:
                    helpers = [
                        i
                        for i in self.members
                        if i not in (n, self.self_id)
                        and self.members[i].status == Status.ACTIVE
                    ]
                    self._rng.shuffle(helpers)
                    for h in helpers[:r]:
                        self.transport.send(
                            h[0],
                            {"t": "pingreq", "sender": list(self.self_id), "target": list(n)},
                        )
            self._prev_neighbors = set(neighbors)
            # Prune relay obligations nobody can satisfy anymore.
            expiry = now - self.config.failure_timeout_s
            for t in list(self._relay):
                self._relay[t] = {a: s for a, s in self._relay[t].items() if s >= expiry}
                if not self._relay[t]:
                    del self._relay[t]

    def _neighbors(self) -> list[NodeId]:
        return symmetric_ring_neighbors(
            self.members.keys(),
            self.self_id,
            self.config.ring_k,
            predicate=self.is_active,
        )

    def _send_ping(self, dest: NodeId) -> None:
        self.transport.send(
            dest[0], {"t": "ping", "sender": list(self.self_id), "list": self._wire_list()}
        )

    def _wire_list(self) -> list:
        """Gossip payload: at most gossip_max_entries entries per datagram.

        Self is always included; non-ACTIVE verdicts (FAILED/LEFT) are
        prioritized so failure news rides every ping; the remaining slots are
        a random sample that rotates per ping — anti-entropy converges over
        rounds while the datagram stays bounded at any fleet size (the
        reference gossiped the full list, O(N) per heartbeat,
        membership.rs:242-257)."""
        cap = max(1, self.config.gossip_max_entries)
        if len(self.members) <= cap:
            entries = list(self.members.items())
        else:
            rest = [
                (i, m) for i, m in self.members.items() if i != self.self_id
            ]
            verdicts = [e for e in rest if e[1].status != Status.ACTIVE]
            actives = [e for e in rest if e[1].status == Status.ACTIVE]
            self._rng.shuffle(verdicts)
            self._rng.shuffle(actives)
            take = (verdicts + actives)[: cap - 1]
            entries = [(self.self_id, self.members[self.self_id])] + take
        return [[i[0], i[1], *m.to_wire()] for i, m in entries]

    # ---- message handling ---------------------------------------------

    def handle(self, src: str, msg: dict) -> None:
        with self._lock:
            if self._left:
                return
            kind = msg.get("t")
            if kind == "ping":
                sender = (msg["sender"][0], msg["sender"][1])
                self._last_heard[sender] = self.clock.now()  # direct evidence
                self._merge_wire_list(msg["list"])
                self.transport.send(sender[0], {"t": "ack", "sender": list(self.self_id)})
            elif kind == "ack":
                sender = (msg["sender"][0], msg["sender"][1])
                self._last_heard[sender] = self.clock.now()  # direct evidence
                self._merge_one(sender, Member(Status.ACTIVE, self.clock.now()))
                # Relay the liveness proof to anyone whose ping-req for this
                # node we served (the requester's direct link may be down —
                # that is the whole point of asking us).
                for requester in self._relay.pop(sender, {}):
                    self.transport.send(
                        requester, {"t": "ack2", "sender": list(self.self_id), "target": list(sender)}
                    )
            elif kind == "pingreq":
                # Probe ``target`` on the requester's behalf: ping it now and
                # owe the requester an ack2 when (if) it answers us.
                requester = (msg["sender"][0], msg["sender"][1])
                target = (msg["target"][0], msg["target"][1])
                if target != self.self_id:
                    self._relay.setdefault(target, {})[requester[0]] = self.clock.now()
                    self._send_ping(target)
                else:  # asked about ourselves: answer directly
                    self.transport.send(requester[0], {"t": "ack", "sender": list(self.self_id)})
            elif kind == "ack2":
                # Indirect liveness: a helper heard ``target`` for us.
                target = (msg["target"][0], msg["target"][1])
                if target != self.self_id:
                    self._last_heard[target] = self.clock.now()
                    self._merge_one(target, Member(Status.ACTIVE, self.clock.now()))
            elif kind == "join":
                joiner = (msg["sender"][0], msg["sender"][1])
                # Fast-rejoin: any older incarnation at the same address is
                # dead. Stamp the verdict with now so it wins anti-entropy
                # against peers holding a fresher ACTIVE for the stale id.
                for nid, m in list(self.members.items()):
                    if nid[0] == joiner[0] and nid[1] < joiner[1] and m.status == Status.ACTIVE:
                        self._set(nid, Member(Status.FAILED, self.clock.now()))
                self._merge_one(joiner, Member(Status.ACTIVE, self.clock.now()))
                self.members[self.self_id].last_active = self.clock.now()
                self.transport.send(
                    joiner[0],
                    {"t": "welcome", "sender": list(self.self_id), "list": self._wire_list()},
                )
            elif kind == "welcome":
                # Adopt the introducer's view wholesale (we know nothing yet).
                self._merge_wire_list(msg["list"])

    def _merge_wire_list(self, wire: list) -> None:
        for addr, inc, status, last_active in wire:
            self._merge_one((addr, float(inc)), Member.from_wire([status, last_active]))

    def _merge_one(self, nid: NodeId, incoming: Member) -> None:
        if nid == self.self_id:
            # Nobody else's opinion of us beats our own liveness, except a
            # FAILED verdict newer than our own refresh would be overwritten
            # at the next step() anyway; keep self authoritative.
            return
        merged = merge_entry(self.members.get(nid), incoming)
        self._set(nid, merged)

    def _set(self, nid: NodeId, member: Member) -> None:
        prev = self.members.get(nid)
        self.members[nid] = member
        if (prev is None or prev.status != member.status) and self.on_change is not None:
            self.on_change(nid, member)
        if prev is None:
            log.info("%s: learned of %s (%s)", self.transport.address, nid, member.status.value)
        elif prev.status != member.status:
            log.info(
                "%s: %s %s -> %s", self.transport.address, nid, prev.status.value, member.status.value
            )
