"""Multi-host mesh formation: the cluster substrate bootstraps torch.distributed.

Copied from ``dmlc_tpu/parallel/multihost.py`` with its imports rewritten,
and its ``jax.distributed.initialize`` turned into
``torch.distributed.init_process_group``. The reference runs on 10 hosts
but each host's model runs alone — there is no cross-host device mesh
anywhere (src/services.rs:26-30, 199-211). Scaling past one process needs
one: every process joins one default ``torch.distributed`` group, so that
``parallel/mesh.make_mesh`` lays its mesh over ``world x local devices``
and the train step and ``InferenceEngine.run_batch_global`` span
processes through collectives.

The missing piece is agreeing on (coordinator_address, num_processes,
process_id) — exactly the kind of agreement the cluster layer already
provides. The elected leader (cluster/failover.py) serves
``mesh.register``: each member registers its address and is assigned the
next process id; everyone polls until the expected process count has
registered, then calls ``init_process_group`` with the leader-published
coordinator address. Deterministic, restart-safe (same address
re-registers to the same rank), and with no second consensus system. The
verbs and their wire are the JAX package's, so a member of either package
registers with a leader of either.

The coordinator is a ``TCPStore`` served IN process 0, as
``jax.distributed`` runs its coordination service there. Before the group
forms, each rank publishes its host and device through it, and the backend
is picked by topology (``choose_backend``): gloo on the CPU, gloo where
two ranks share a device (NCCL refuses two ranks on one device), NCCL
where each rank has its own.

Hermetic coverage: tests/test_torch_multihost.py forms a real 2-process
CPU gloo group through a leader's ``MeshBootstrap`` and runs the dp train
step and a gang job over it.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from datetime import timedelta

import torch

from dmlc_tpu_torch.cluster.rpc import Rpc, RpcError
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.tracing import traced_methods

log = logging.getLogger(__name__)


class MeshBootstrap:
    """Leader-side rank assignment for the global device mesh.

    Ranks are handed out in registration order; re-registration of a known
    address is idempotent (a restarted process keeps its rank — required, as
    the process group binds rank to the coordinator's store). The published
    coordinator address is ``<rank-0's host>:<coordinator_port>``: the
    store runs IN process 0, so the coordinator host must be wherever rank
    0 lives, which is only known once the first process registers.

    Like SdfsLeader, writes are refused unless actively leading (set by
    StandbyLeader on promotion) so two candidates can never hand out
    conflicting rank maps. The mesh forms once per fleet lifetime — a
    post-failover leader cannot re-rank already-initialized processes.
    """

    def __init__(self, coordinator_port: int, num_processes: int, is_leading: bool = True):
        self.coordinator_port = int(coordinator_port)
        self.num_processes = int(num_processes)
        self.is_leading = is_leading
        self.ranks: dict[str, int] = {}
        self._lock = threading.Lock()

    def methods(self) -> dict:
        return traced_methods({
            "mesh.register": self._register,
            "mesh.info": self._info,
            "mesh.state": self._state_wire,
        })

    def _state_wire(self, p: dict) -> dict:
        """Rank-map replication payload for standby leaders: without it a
        failover would re-rank already-initialized processes."""
        with self._lock:
            return {"ranks": dict(self.ranks)}

    def adopt_state(self, wire: dict) -> None:
        with self._lock:
            self.ranks = {str(a): int(r) for a, r in wire["ranks"].items()}

    def group(self) -> dict | None:
        """{addr: rank} once every expected process has registered, else
        None — the scheduler's gang-dispatch readiness check (keeps the
        ready invariant here instead of in callers)."""
        with self._lock:
            if len(self.ranks) < self.num_processes:
                return None
            return dict(self.ranks)

    def _register(self, p: dict) -> dict:
        addr = p["addr"]
        with self._lock:
            if not self.is_leading:
                raise RpcError("not the active leader")
            if addr not in self.ranks:
                if len(self.ranks) >= self.num_processes:
                    raise RpcError(
                        f"mesh is full: {self.num_processes} processes already registered"
                    )
                self.ranks[addr] = len(self.ranks)
            return self._info_locked(self.ranks[addr])

    def _info(self, p: dict) -> dict:
        with self._lock:
            return self._info_locked(None)

    def _coordinator_locked(self) -> str | None:
        rank0 = next((a for a, r in self.ranks.items() if r == 0), None)
        if rank0 is None:
            return None
        host, _, _ = rank0.rpartition(":")
        return f"{host}:{self.coordinator_port}"

    def _info_locked(self, process_id) -> dict:
        return {
            "process_id": process_id,
            "num_processes": self.num_processes,
            "coordinator": self._coordinator_locked(),
            "registered": len(self.ranks),
            "ready": len(self.ranks) >= self.num_processes,
        }


# RpcError fragments that polling can never fix — fail fast instead of
# burning the whole join window.
_PERMANENT_ERRORS = ("unknown method", "mesh is full")


def register_until_ready(
    rpc: Rpc,
    leader_addr,
    self_addr: str,
    timeout_s: float = 120.0,
    poll_s: float = 0.5,
) -> dict:
    """Register with the leader and poll until every expected process has —
    returns the final {process_id, num_processes, coordinator, ...} info.

    ``leader_addr`` may be a callable re-resolved every poll (the node's
    LeaderTracker) so a leader failover mid-join redirects to the promoted
    standby instead of stranding the fleet. Transient failures (connection
    drops, a candidate still deferring mid-election) keep polling until the
    deadline; permanent refusals (mesh not configured, mesh full) raise
    immediately."""
    addr_fn = leader_addr if callable(leader_addr) else (lambda: leader_addr)
    deadline = time.monotonic() + timeout_s
    info = None
    last_err: Exception | None = None
    while time.monotonic() < deadline:
        addr = addr_fn()
        try:
            # Each attempt is bounded (dmlc-analyze A3): a wedged candidate
            # must cost one short re-poll, never the implicit 60 s default —
            # and never more than the join window that remains.
            attempt_s = max(0.1, min(10.0, deadline - time.monotonic()))
            info = rpc.call(
                addr, "mesh.register", {"addr": self_addr}, timeout=attempt_s
            )
            if info["ready"]:
                return info
        except RpcError as e:
            if any(frag in str(e) for frag in _PERMANENT_ERRORS):
                raise
            last_err = e
            log.warning("mesh.register at %s failed (will retry): %s", addr, e)
        time.sleep(poll_s)
    raise TimeoutError(
        f"global mesh never became ready: {info and info['registered']}"
        f"/{info and info['num_processes']} processes registered"
        + (f" (last error: {last_err})" if last_err else "")
    )


def device_key(device: torch.device) -> str:
    """What two ranks compare to tell whether they share a device: the host
    and, for a CUDA device, the card's UUID."""
    host = socket.gethostname()
    if device.type != "cuda":
        return f"{host}/cpu"
    return f"{host}/{torch.cuda.get_device_properties(device).uuid}"


def choose_backend(keys: list[str]) -> str:
    """The collective backend for ranks on the devices ``keys``
    (``device_key``, one per rank): gloo on the CPU and where two ranks
    share a device, NCCL where each rank has a card of its own."""
    if any(k.endswith("/cpu") for k in keys) or len(set(keys)) < len(keys):
        return "gloo"
    return "nccl"


def initialize_global_runtime(info: dict, device: str | torch.device | None = None,
                              timeout_s: float = 120.0) -> dict:
    """Join the default ``torch.distributed`` group described by a register
    reply: ``init_process_group`` over a ``TCPStore`` at the published
    coordinator, which process 0 serves, with the backend that
    ``choose_backend`` picks from every rank's device (the CUDA device
    unless ``device="cpu"``). After this, ``make_mesh`` lays meshes over
    every process. Returns ``info`` with the ``backend`` that ran and the
    ``device``.

    A process joins one group in its life, as ``jax.distributed`` allows one
    initialization: a process already in a group of the same rank and size
    returns at once, and one in another group raises ``RuntimeError``."""
    import torch.distributed as dist

    rank, world = int(info["process_id"]), int(info["num_processes"])
    dev = resolve_device(device)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(
                f"this process is rank {dist.get_rank()} of a group of {dist.get_world_size()}; "
                f"it cannot join as rank {rank} of {world}")
        return {**info, "backend": dist.get_backend(), "device": str(dev)}
    host, _, port = str(info["coordinator"]).rpartition(":")
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=timedelta(seconds=timeout_s))
    store.set(f"dmlc/device/{rank}", device_key(dev))
    keys = [store.get(f"dmlc/device/{r}").decode() for r in range(world)]
    backend = choose_backend(keys)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    log.info("joined global mesh: process %d/%d over %s, device %s", rank, world, backend, dev)
    return {**info, "backend": backend, "device": str(dev)}


def join_global_mesh(
    rpc: Rpc, leader_addr, self_addr: str, timeout_s: float = 120.0,
    device: str | torch.device | None = None,
) -> dict:
    """The member-side one-call path: register, wait for the fleet, join.
    ``leader_addr`` may be a callable (see register_until_ready). Returns
    the register reply with the ``backend`` and ``device`` that joined."""
    info = register_until_ready(rpc, leader_addr, self_addr, timeout_s=timeout_s)
    return initialize_global_runtime(info, device=device, timeout_s=timeout_s)
