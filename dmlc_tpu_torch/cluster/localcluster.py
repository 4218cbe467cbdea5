"""Localhost cluster harness: N real nodes on 127.0.0.1 in one process.

Copied from ``dmlc_tpu/cluster/localcluster.py`` (the whole module), with
three changes: ``device`` is passed on to every ``ClusterNode``, which
passes it to the engines it builds (``"cuda"`` on the card, ``"cpu"`` in
the tests); port blocks are drawn from ``PORT_RANGE``, below Linux's
default ephemeral range; and a block is probed and held before the first
node starts (``_reserve_block``), so that a host whose ephemeral range
covers ``PORT_RANGE`` cannot hand one of its ports to an outgoing
connection while the fleet starts or runs.

The reference could only be exercised by deploying to its 10-VM fleet; this
module spins the REAL stack (UDP gossip, TCP RPC, maintenance threads) on
loopback with compressed intervals — the shared engine behind the
integration tests and the operator tools (tools/measure_failover.py), so
port allocation, config compression, and readiness waits live in ONE place.
"""

from __future__ import annotations

import errno
import random
import socket
import time
import weakref
from pathlib import Path

from dmlc_tpu_torch.cluster.node import ClusterNode
from dmlc_tpu_torch.utils.config import ClusterConfig

#: Where port blocks are drawn: below Linux's default ephemeral range (32768
#: and up), from which every outgoing connection (one an RPC) takes its local
#: port, so that a fleet's listeners do not draw ports those connections
#: hold. A host may set a range that covers this one; a connection's port,
#: even in TIME_WAIT, refuses a listener's bind, so ``_reserve_block`` skips
#: such ports and holds the ones it draws.
PORT_RANGE = (21000, 32700)
#: Draws of a port block before ``_reserve_block`` gives up, and fleet starts
#: before ``start_local_cluster`` does (a start collides only with another
#: process that holds the same block).
BLOCK_DRAWS = 256
START_ATTEMPTS = 5

#: Each running node's held TCP ports (leader and member), closed by
#: ``stop_local_cluster``.
_HELD: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def wait_until(cond, timeout: float = 30.0, interval: float = 0.02, msg: str = "condition"):
    """Poll ``cond`` until true or raise (the harness's only clock)."""
    # This module is the REAL-stack harness (live sockets, real heartbeat
    # threads), not a sans-IO state machine: its readiness waits and port
    # draws are genuinely anchored to wall time.
    deadline = time.monotonic() + timeout  # dmlc-lint: disable=D1 -- real-stack harness waits on real time
    while time.monotonic() < deadline:  # dmlc-lint: disable=D1 -- real-stack harness waits on real time
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def make_synsets(path: Path, n: int) -> Path:
    """A synset_words.txt with n synthetic classes (truth = line index)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"n{i:08d} label {i}\n" for i in range(n)))  # dmlc-lint: disable=F1 -- test-harness workload fixture, not replicated cluster state; rebuilt per run
    return path


def echo_backend(synsets):
    """Fake model: predicts the class encoded in the synset id (always
    right against make_synsets truth)."""
    return [int(s[1:]) for s in synsets]


def start_local_cluster(
    tmp: Path,
    n_nodes: int = 3,
    backends=None,
    n_leader_candidates: int = 2,
    scale: float = 1.0,
    join: bool = True,
    device=None,
    **config_overrides,
):
    """Start ``n_nodes`` ClusterNodes on a random loopback port block.

    Interval constants are the reference's, compressed 5x and multiplied by
    ``scale`` (scale=5 restores the reference's 1 s heartbeat / 3 s loops).
    ``backends`` is {model: PredictFn} shared by every node, OR a callable
    ``node_index -> {model: PredictFn}`` for per-node instances (needed
    when a test must prove EVERY member's backend changed — a shared
    object would mask a one-member regression); default is the echo
    backend for the configured job models. With ``join`` the fleet is
    joined, converged, and the first leader promoted before returning.
    ``device`` goes to every node (and so to the engines it builds).

    Returns the node list; caller owns shutdown (``stop_local_cluster``).
    """
    overrides = dict(config_overrides)
    synset_path = overrides.pop("synset_path", None)
    if synset_path is None:
        synset_path = make_synsets(tmp / "synsets.txt", 40)
    last: Exception | None = None
    for attempt in range(START_ATTEMPTS):
        base, held = _reserve_block(n_nodes)
        candidates = [
            f"127.0.0.1:{base + 10 * i + 1}" for i in range(n_leader_candidates)
        ]
        nodes: list = []
        try:
            return _start_all(tmp, n_nodes, base, candidates, synset_path, overrides,
                              backends, scale, join, nodes, device, held)
        except OSError as e:
            stop_local_cluster(nodes)
            _release(held)
            if e.errno != errno.EADDRINUSE:
                # Only genuine port collisions are worth a redraw; other OS
                # failures (fd exhaustion, disk) would just repeat.
                raise
            # The held block was taken by another process's harness between
            # its probe and a server's listen: redraw.
            last = e
        except Exception:
            # A half-started fleet (convergence timeout etc.) must not leak
            # bound ports and heartbeat threads into the caller, who never
            # got a handle to stop them.
            stop_local_cluster(nodes)
            _release(held)
            raise
    raise last


def _bound(kind: int, port: int, reuse: bool) -> socket.socket:
    sock = socket.socket(socket.AF_INET, kind)
    try:
        if reuse:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", port))
    except OSError:
        sock.close()
        raise
    return sock


def _release(held: list[dict]) -> None:
    for ports in held:
        for sock in (ports["udp"], *ports["tcp"]):
            sock.close()


def _reserve_block(n_nodes: int) -> tuple[int, list[dict]]:
    """Draw a port block that is free now and hold it.

    Node i's gossip port (base + 10i, UDP) is held by a bound socket until
    just before node i is built; its leader and member ports (+1, +2, TCP)
    by bound sockets that do not listen, until ``stop_local_cluster``.
    Linux gives an outgoing connection no port that a socket is bound to,
    and the node's own servers still bind there (SO_REUSEADDR on both, and
    neither held socket listens). A port that is in use, by a listener or
    by a connection, fails the draw and another block is drawn."""
    for _ in range(BLOCK_DRAWS):
        # dmlc-lint: disable=D1 -- port draw must differ across concurrent harness processes; determinism would guarantee collisions
        base = random.randint(*PORT_RANGE) // 10 * 10
        try:
            return base, _reserve_block_at(base, n_nodes)
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
    raise OSError(errno.EADDRINUSE,
                  f"no free block of {n_nodes} nodes' ports in {BLOCK_DRAWS} draws "
                  f"from {PORT_RANGE}")


def _reserve_block_at(base: int, n_nodes: int) -> list[dict]:
    held: list[dict] = []
    try:
        for i in range(n_nodes):
            held.append({"udp": _bound(socket.SOCK_DGRAM, base + 10 * i, False), "tcp": []})
            for k in (1, 2):
                held[-1]["tcp"].append(_bound(socket.SOCK_STREAM, base + 10 * i + k, True))
    except OSError:
        _release(held)
        raise
    return held


def _start_all(tmp, n_nodes, base, candidates, synset_path, overrides,
               backends, scale, join, nodes, device=None, held=None):
    for i in range(n_nodes):
        fields = dict(
            host="127.0.0.1",
            gossip_port=base + 10 * i,
            leader_port=base + 10 * i + 1,
            member_port=base + 10 * i + 2,
            leader_candidates=candidates,
            storage_dir=str(tmp / f"node{i}" / "storage"),
            synset_path=str(synset_path),
            replication_factor=min(2, n_nodes),
            dispatch_shard_size=8,
            heartbeat_interval_s=0.2 * scale,
            failure_timeout_s=0.6 * scale,
            rereplication_interval_s=0.6 * scale,
            assignment_interval_s=0.6 * scale,
            leader_probe_interval_s=0.6 * scale,
        )
        fields.update(overrides)  # caller overrides win over harness defaults
        cfg = ClusterConfig(**fields)
        node_backends = backends(i) if callable(backends) else backends
        if node_backends is None:
            node_backends = {name: echo_backend for name in cfg.job_models}
        if held is not None:
            held[i]["udp"].close()  # the gossip transport binds it next
        node = ClusterNode(cfg, backends=node_backends, device=device)
        if held is not None:
            _HELD[node] = held[i]["tcp"]
        node.start()
        nodes.append(node)
    if join:
        for n in nodes[1:]:
            n.join(nodes[0].gossip.address)
        wait_until(
            lambda: all(len(n.membership.active_ids()) == n_nodes for n in nodes),
            msg=f"{n_nodes}-node membership convergence",
        )
        wait_until(lambda: nodes[0].standby.is_leader, msg="first-leader promotion")
    return nodes


def stop_local_cluster(nodes) -> None:
    """Best-effort shutdown of every node (tolerates already-crashed ones)."""
    for n in nodes:
        try:
            n.stop()
        except Exception:  # dmlc-lint: disable=E1 -- teardown must reach every node; a crashed one has nothing left to observe
            pass
        for sock in _HELD.pop(n, ()):
            sock.close()
