"""Localhost cluster harness: N real nodes on 127.0.0.1 in one process.

Copied from ``dmlc_tpu/cluster/localcluster.py`` (the whole module), with
two changes: ``device`` is passed on to every ``ClusterNode``, which
passes it to the engines it builds (``"cuda"`` on the card, ``"cpu"`` in
the tests); and port blocks are drawn from ``PORT_RANGE``, below Linux's
ephemeral range.

The reference could only be exercised by deploying to its 10-VM fleet; this
module spins the REAL stack (UDP gossip, TCP RPC, maintenance threads) on
loopback with compressed intervals — the shared engine behind the
integration tests and the operator tools (tools/measure_failover.py), so
port allocation, config compression, and readiness waits live in ONE place.
"""

from __future__ import annotations

import random
import time
from pathlib import Path

from dmlc_tpu_torch.cluster.node import ClusterNode
from dmlc_tpu_torch.utils.config import ClusterConfig

#: Where port blocks are drawn: below Linux's ephemeral range (32768 and up),
#: from which every outgoing connection (one an RPC) takes its local port, so
#: that a fleet's listeners do not draw ports those connections hold.
PORT_RANGE = (21000, 32700)


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
    for attempt in range(3):
        # dmlc-lint: disable=D1 -- port draw must differ across concurrent harness processes; determinism would guarantee collisions
        base = random.randint(*PORT_RANGE) // 10 * 10
        candidates = [
            f"127.0.0.1:{base + 10 * i + 1}" for i in range(n_leader_candidates)
        ]
        nodes: list = []
        try:
            return _start_all(tmp, n_nodes, base, candidates, synset_path, overrides,
                              backends, scale, join, nodes, device)
        except OSError as e:
            import errno

            if e.errno != errno.EADDRINUSE:
                # Only genuine port collisions are worth a redraw; other OS
                # failures (fd exhaustion, disk) would just repeat.
                stop_local_cluster(nodes)
                raise
            # Random port block collided with another harness cluster (or a
            # busy system port): clean up and redraw — observed as a rare
            # cross-test flake before this retry existed.
            stop_local_cluster(nodes)
            last = e
        except Exception:
            # A half-started fleet (convergence timeout etc.) must not leak
            # bound ports and heartbeat threads into the caller, who never
            # got a handle to stop them.
            stop_local_cluster(nodes)
            raise
    raise last


def _start_all(tmp, n_nodes, base, candidates, synset_path, overrides,
               backends, scale, join, nodes, device=None):
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
        node = ClusterNode(cfg, backends=node_backends, device=device)
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
