"""The port's gossip membership (cluster/membership.py on cluster/transport.py,
cluster/clock.py, utils/config.py and utils/ring.py) against the JAX
package's: the scenarios of tests/test_membership.py run in both packages in
this one process, step by step, and every node's membership list must be the
same in both after every step. (A node's gossip sampling draws from
``random.Random(hash(self_id))``, and ``hash`` of a string differs from
process to process, so the two packages are compared only within one.)
Then one port node and one JAX node join each other over UDP on localhost.
"""

import time

import pytest
from torch_sockets import socket_time_limit  # noqa: F401  (autouse fixture)

import dmlc_tpu.cluster.auth as jax_auth
import dmlc_tpu.cluster.clock as jax_clock
import dmlc_tpu.cluster.membership as jax_membership
import dmlc_tpu.cluster.transport as jax_transport
import dmlc_tpu.utils.config as jax_config
import dmlc_tpu_torch.cluster.auth as port_auth
import dmlc_tpu_torch.cluster.clock as port_clock
import dmlc_tpu_torch.cluster.membership as port_membership
import dmlc_tpu_torch.cluster.transport as port_transport
import dmlc_tpu_torch.utils.config as port_config

PACKAGES = {
    "jax": (jax_clock, jax_membership, jax_transport, jax_config, jax_auth),
    "port": (port_clock, port_membership, port_transport, port_config, port_auth),
}


class SimCluster:
    """N membership nodes of one package on its in-memory fabric with a
    shared fake clock (tests/test_membership.py's harness)."""

    def __init__(self, pkg: str, n: int, ring_k: int = 2, **config_overrides):
        clock_mod, self.mem, transport_mod, config_mod, _ = PACKAGES[pkg]
        self.net = transport_mod.SimNetwork()
        self.clock = clock_mod.SimClock()
        self.config = config_mod.ClusterConfig(ring_k=ring_k, **config_overrides)
        self.nodes = {}
        for i in range(n):
            addr = f"node{i}:8850"
            self.nodes[addr] = self.mem.MembershipNode(self.config, self.net.endpoint(addr),
                                                       self.clock)
            self.clock.advance(0.001)  # distinct incarnations
        for addr, node in self.nodes.items():
            if addr != "node0:8850":
                node.join("node0:8850")
        self.net.deliver_all()

    def round(self, dt: float = 1.0):
        self.clock.advance(dt)
        for addr, node in self.nodes.items():
            if addr not in self.net.down:
                node.step()
        self.net.deliver_all()

    def restart(self, addr: str, introducer: str):
        self.net.restart(addr)
        node = self.mem.MembershipNode(self.config, self.net.endpoint(addr), self.clock)
        self.nodes[addr] = node
        node.join(introducer)
        self.net.deliver_all()

    def view(self) -> dict:
        """Every node's membership list as plain values."""
        return {addr: [(nid, m.status.value, m.last_active) for nid, m in node.list_membership()]
                for addr, node in self.nodes.items()}

    def newest_status(self, at: str, of: str) -> str:
        entries = [(nid[1], m.status.value) for nid, m in self.nodes[at].members.items()
                   if nid[0] == of]
        return max(entries)[1]


class Twin:
    """The same scenario on both packages' clusters, compared after every
    step."""

    def __init__(self, n: int, **kw):
        self.jax = SimCluster("jax", n, **kw)
        self.port = SimCluster("port", n, **kw)
        self.steps = 0
        self.check()

    def check(self):
        assert self.port.view() == self.jax.view(), f"after step {self.steps}"
        assert self.port.net.pending() == self.jax.net.pending()

    def do(self, fn):
        fn(self.jax)
        fn(self.port)
        self.steps += 1
        self.check()

    def rounds(self, n: int):
        for _ in range(n):
            self.do(lambda c: c.round())


def test_bootstrap_is_the_same_in_both_packages():
    t = Twin(5)
    t.rounds(5)
    for addr in t.port.nodes:
        assert {t.port.newest_status(addr, a) for a in t.port.nodes} == {"active"}


def test_failure_detection_is_the_same_in_both_packages():
    t = Twin(6)
    t.rounds(5)
    t.do(lambda c: c.net.crash("node3:8850"))
    t.rounds(8)
    for addr in t.port.nodes:
        if addr != "node3:8850":
            assert t.port.newest_status(addr, "node3:8850") == "failed"


def test_rejoin_is_the_same_in_both_packages():
    t = Twin(5)
    t.rounds(5)
    t.do(lambda c: c.net.crash("node4:8850"))
    t.rounds(8)
    t.do(lambda c: c.restart("node4:8850", "node1:8850"))
    t.rounds(6)
    for addr in t.port.nodes:
        assert t.port.newest_status(addr, "node4:8850") == "active"


def test_leave_is_the_same_in_both_packages():
    t = Twin(5)
    t.rounds(5)
    t.do(lambda c: (c.nodes["node2:8850"].leave(), c.net.deliver_all()))
    t.rounds(4)
    for addr in t.port.nodes:
        if addr != "node2:8850":
            assert t.port.newest_status(addr, "node2:8850") == "left"


def test_partition_and_heal_are_the_same_in_both_packages():
    t = Twin(4, ring_k=2)
    t.rounds(5)
    victim = "node1:8850"
    others = [a for a in t.port.nodes if a != victim]
    t.do(lambda c: [c.net.partition(victim, o) for o in others])
    t.rounds(8)
    assert {t.port.newest_status(a, victim) for a in others} == {"failed"}
    t.do(lambda c: [c.net.heal(victim, o) for o in others])
    t.do(lambda c: (c.nodes[victim].join("node0:8850"), c.net.deliver_all()))
    t.rounds(6)
    assert {t.port.newest_status(a, victim) for a in t.port.nodes} == {"active"}


def test_capped_gossip_is_the_same_in_both_packages():
    """Past gossip_max_entries the ping carries a random sample drawn from
    each node's RNG: the two packages draw the same in one process."""
    t = Twin(12, gossip_max_entries=4)
    t.rounds(6)
    t.do(lambda c: c.net.crash("node7:8850"))
    t.rounds(8)


@pytest.mark.parametrize("keyed", [False, True], ids=["plain", "keyed"])
def test_port_and_jax_nodes_join_over_udp(keyed):
    """A port node and a JAX node, each on its own UDP socket on localhost
    and its own real clock, join through the JAX node and each see the
    other active."""
    nodes, transports = [], []
    try:
        for pkg in ("jax", "port"):
            clock_mod, mem, transport_mod, config_mod, auth_mod = PACKAGES[pkg]
            auth = auth_mod.FrameAuth("fleet") if keyed else None
            tr = transport_mod.UdpTransport("127.0.0.1", 0, auth=auth)
            transports.append(tr)
            cfg = config_mod.ClusterConfig(heartbeat_interval_s=0.05, failure_timeout_s=5.0)
            nodes.append(mem.MembershipNode(cfg, tr, clock_mod.Clock()))
        ref, port = nodes
        port.join(ref.self_id[0])
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if len(ref.active_ids()) == 2 and len(port.active_ids()) == 2:
                break
            ref.step()
            port.step()
            time.sleep(0.05)
        assert ref.active_ids() == port.active_ids() == sorted([ref.self_id, port.self_id])
        assert [tr.rejected for tr in transports] == [0, 0]
    finally:
        for tr in transports:
            tr.close()
