"""The port's localcluster harness holds its port block.

A block is probed and held before the first node starts: a busy port makes
the harness draw another block, the held ports refuse any other socket that
does not share them, the nodes' own servers still bind there, and
``stop_local_cluster`` lets them go.
"""

import errno
import itertools
import socket

import pytest

from dmlc_tpu_torch.cluster import localcluster as lc
from dmlc_tpu_torch.cluster.rpc import TcpRpcServer
from dmlc_tpu_torch.cluster.transport import UdpTransport


def _free_base(n_nodes: int, avoid: int | None = None) -> int:
    """A block base in PORT_RANGE whose ports are all free now."""
    for base in range(lc.PORT_RANGE[0] // 10 * 10, lc.PORT_RANGE[1], 10 * (n_nodes + 1)):
        if base == avoid:
            continue
        try:
            lc._release(lc._reserve_block_at(base, n_nodes))
        except OSError:
            continue
        return base
    raise AssertionError("no free block in PORT_RANGE")


def _draws(monkeypatch, bases):
    seq = itertools.chain(bases, itertools.repeat(bases[-1]))
    monkeypatch.setattr(lc.random, "randint", lambda lo, hi: next(seq))


@pytest.mark.parametrize("busy", ["udp_gossip", "tcp_member", "tcp_connection"])
def test_busy_port_draws_another_block(monkeypatch, busy):
    busy_base = _free_base(2)
    free_base = _free_base(2, avoid=busy_base)
    port = busy_base + 10 + (0 if busy == "udp_gossip" else 2)
    holders = []
    if busy == "udp_gossip":
        holders.append(lc._bound(socket.SOCK_DGRAM, port, False))
    elif busy == "tcp_member":
        listener = lc._bound(socket.SOCK_STREAM, port, True)
        listener.listen(1)
        holders.append(listener)
    else:
        # An outgoing connection whose local port is the member port: what
        # an ephemeral range that covers PORT_RANGE would hand out.
        listener = lc._bound(socket.SOCK_STREAM, 0, True)
        listener.listen(1)
        client = lc._bound(socket.SOCK_STREAM, port, False)
        client.connect(listener.getsockname())
        holders += [listener, client, listener.accept()[0]]
    _draws(monkeypatch, [busy_base, free_base])
    try:
        base, held = lc._reserve_block(2)
        lc._release(held)
    finally:
        for sock in holders:
            sock.close()
    assert base == free_base


def test_held_block_refuses_others_and_admits_the_nodes_servers(monkeypatch):
    base = _free_base(1)
    _draws(monkeypatch, [base])
    got, held = lc._reserve_block(1)
    assert got == base
    try:
        for port in (base + 1, base + 2):
            with pytest.raises(OSError) as e:
                lc._bound(socket.SOCK_STREAM, port, False)
            assert e.value.errno == errno.EADDRINUSE
        with pytest.raises(OSError):
            lc._bound(socket.SOCK_DGRAM, base, False)
        held[0]["udp"].close()
        gossip = UdpTransport("127.0.0.1", base)
        server = TcpRpcServer("127.0.0.1", base + 2, {})
        assert server.address == f"127.0.0.1:{base + 2}"
        server.close()
        gossip.close()
    finally:
        lc._release(held)


def test_fleet_starts_past_a_busy_block_and_stop_releases_it(monkeypatch, tmp_path):
    busy_base = _free_base(2)
    free_base = _free_base(2, avoid=busy_base)
    listener = lc._bound(socket.SOCK_STREAM, busy_base + 2, True)
    listener.listen(1)
    _draws(monkeypatch, [busy_base, free_base])
    nodes = []
    try:
        nodes = lc.start_local_cluster(tmp_path, n_nodes=2, join=False, device="cpu")
        assert [n.self_member_addr for n in nodes] == [
            f"127.0.0.1:{free_base + 2}", f"127.0.0.1:{free_base + 12}"]
        assert all(n in lc._HELD for n in nodes)
    finally:
        lc.stop_local_cluster(nodes)
        listener.close()
    assert not any(n in lc._HELD for n in nodes)
