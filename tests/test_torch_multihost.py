"""The port's multi-host mesh formation (``parallel/multihost.py``) on the
CPU, mirroring tests/test_multihost.py:

- ``MeshBootstrap`` and ``register_until_ready`` on the port's
  ``SimRpcNetwork``: rank assignment idempotent and bounded, registration
  refused unless leading, transient failures retried, polling to quorum,
  permanent errors failing fast, a redirect reaching the promoted standby;
  and the backend rule (gloo on the CPU and where ranks share a device,
  NCCL where each has its own), and the refusal to join a second group;
- across the wire, over TCP on localhost: a port member registering with a
  JAX leader, and a JAX member with a port leader, get the info dicts of an
  all-JAX pair, and a port standby adopts a JAX leader's ``mesh.state``;
- two-process gloo groups formed through a port leader's ``MeshBootstrap``
  by ``join_global_mesh`` (tests/torch_mesh_worker.py):
  - training: the ``{dp: 2}`` step spans both processes, with equal losses
    on both ranks (rel 1e-6) and equal parameters, and matches the JAX
    single-process step on the concatenated batch: each loss atol 1e-5, the
    parameters after two steps atol 2e-5 (``attn.key.bias``, whose gradient
    is zero in exact arithmetic, within ``2 * lr`` a step), a
    ``grad_accum=2`` step's loss and a BatchNorm ResNet's loss and running
    statistics (summed across the processes) atol 1e-5;
  - the gang: the port ``JobScheduler`` with ``mesh_group`` runs a
    12-query job to ``job.correct == 12`` over ``gang_shards == 2``;
  - kill and re-form, at world 2 rather than the JAX test's 4 to keep the
    suite light: one rank killed mid-job fails its shard whole (requeued,
    nothing stranded; the gloo survivor's error is one breaker step, where
    the JAX survivor hangs), and after the gang re-forms the job completes
    with every prediction correct, exactly once.

Every test runs under ``torch_sockets``' time limit, and tears its
processes down.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import SIZE, tiny_variables
from torch_mesh_worker import BATCH, CLASSES, IMAGE, LR, VIT, batch
from torch_sockets import socket_time_limit  # noqa: F401  (autouse fixture)

from dmlc_tpu.cluster.rpc import TcpRpc as JaxTcpRpc
from dmlc_tpu.cluster.rpc import TcpRpcServer as JaxTcpRpcServer
from dmlc_tpu.models.resnet import BasicBlock as JaxBasicBlock
from dmlc_tpu.models.resnet import ResNet as JaxResNet
from dmlc_tpu.models.vit import ViT as JaxViT
from dmlc_tpu.parallel import create_train_state as jax_create_train_state
from dmlc_tpu.parallel import default_optimizer as jax_default_optimizer
from dmlc_tpu.parallel import make_mesh as jax_make_mesh
from dmlc_tpu.parallel import make_train_step as jax_make_train_step
from dmlc_tpu.parallel.multihost import MeshBootstrap as JaxMeshBootstrap
from dmlc_tpu.parallel.multihost import register_until_ready as jax_register_until_ready
from dmlc_tpu_torch.cluster.rpc import RpcError, SimRpcNetwork, TcpRpc, TcpRpcServer
from dmlc_tpu_torch.models.convert import resnet_from_jax, vit_from_jax
from dmlc_tpu_torch.parallel.multihost import (
    MeshBootstrap,
    choose_backend,
    initialize_global_runtime,
    register_until_ready,
)
from dmlc_tpu_torch.scheduler.jobs import JobScheduler
from dmlc_tpu_torch.scheduler.worker import EngineBackend
from dmlc_tpu_torch.utils import corpus

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_mesh_worker.py"
ZERO_GRAD_SUFFIX = "attn.key.bias"


# ---------------------------------------------------------------------------
# MeshBootstrap and register_until_ready on the sim fabric
# ---------------------------------------------------------------------------


def test_rank_assignment_idempotent_and_bounded():
    net = SimRpcNetwork()
    boot = MeshBootstrap(coordinator_port=8853, num_processes=3)
    net.serve("L", boot.methods())
    cli = net.client("x")

    a = cli.call("L", "mesh.register", {"addr": "hostA:1"})
    b = cli.call("L", "mesh.register", {"addr": "hostB:1"})
    assert (a["process_id"], b["process_id"]) == (0, 1)
    assert not b["ready"] and b["registered"] == 2
    # The coordinator lives where rank 0 lives (its store runs in process 0).
    assert b["coordinator"] == "hostA:8853"
    again = cli.call("L", "mesh.register", {"addr": "hostA:1"})  # a restart keeps its rank
    assert again["process_id"] == 0 and again["registered"] == 2
    assert boot.group() is None
    c = cli.call("L", "mesh.register", {"addr": "hostC:1"})
    assert c["process_id"] == 2 and c["ready"]
    assert boot.group() == {"hostA:1": 0, "hostB:1": 1, "hostC:1": 2}
    with pytest.raises(RpcError, match="full"):
        cli.call("L", "mesh.register", {"addr": "hostD:1"})
    assert cli.call("L", "mesh.info", {})["process_id"] is None


def test_register_refused_unless_leading():
    net = SimRpcNetwork()
    boot = MeshBootstrap(coordinator_port=8853, num_processes=2, is_leading=False)
    net.serve("L", boot.methods())
    with pytest.raises(RpcError, match="not the active leader"):
        net.client("x").call("L", "mesh.register", {"addr": "hostA:1"})
    boot.is_leading = True  # StandbyLeader._promote does this
    assert net.client("x").call("L", "mesh.register", {"addr": "hostA:1"})["process_id"] == 0


def test_register_until_ready_retries_transient_failures():
    net = SimRpcNetwork()
    boot = MeshBootstrap(coordinator_port=1, num_processes=2)
    net.serve("L", boot.methods())
    net.crash("L")  # the leader restarting while the member starts polling

    def recover():
        time.sleep(0.1)
        net.restart("L")
        net.client("y").call("L", "mesh.register", {"addr": "hostB:1"})

    t = threading.Thread(target=recover)
    t.start()
    info = register_until_ready(net.client("x"), "L", "hostA:1", timeout_s=5.0, poll_s=0.02)
    t.join(timeout=5)
    assert not t.is_alive() and info["ready"]


def test_register_until_ready_polls_to_quorum():
    net = SimRpcNetwork()
    boot = MeshBootstrap(coordinator_port=1, num_processes=2)
    net.serve("L", boot.methods())

    def late_joiner():
        time.sleep(0.1)
        net.client("y").call("L", "mesh.register", {"addr": "hostB:1"})

    t = threading.Thread(target=late_joiner)
    t.start()
    info = register_until_ready(net.client("x"), "L", "hostA:1", timeout_s=5.0, poll_s=0.02)
    t.join(timeout=5)
    assert not t.is_alive() and info["ready"] and info["process_id"] == 0


def test_register_fails_fast_on_permanent_errors():
    net = SimRpcNetwork()
    net.serve("L", {})  # no mesh.register at all: the fleet configures no mesh
    t0 = time.monotonic()
    with pytest.raises(RpcError, match="unknown method"):
        register_until_ready(net.client("x"), "L", "hostA:1", timeout_s=30.0, poll_s=0.01)
    assert time.monotonic() - t0 < 5.0
    boot = MeshBootstrap(coordinator_port=1, num_processes=1)
    net.serve("L2", boot.methods())
    net.client("x").call("L2", "mesh.register", {"addr": "hostA:1"})
    with pytest.raises(RpcError, match="full"):
        register_until_ready(net.client("x"), "L2", "hostB:1", timeout_s=30.0, poll_s=0.01)
    with pytest.raises(TimeoutError, match="never became ready"):
        register_until_ready(net.client("x"), "L3", "hostA:1", timeout_s=0.2, poll_s=0.05)


def test_register_redirects_to_promoted_standby():
    net = SimRpcNetwork()
    primary = MeshBootstrap(coordinator_port=8853, num_processes=2)
    standby = MeshBootstrap(coordinator_port=8853, num_processes=2, is_leading=False)
    net.serve("L0", primary.methods())
    net.serve("L1", standby.methods())
    first = net.client("a").call("L0", "mesh.register", {"addr": "hostA:1"})
    assert first["process_id"] == 0
    standby.adopt_state(net.client("L1").call("L0", "mesh.state", {}))  # the sync loop
    net.crash("L0")
    current = ["L0"]

    def failover():
        time.sleep(0.05)
        standby.is_leading = True  # promotion
        current[0] = "L1"          # the tracker advances
        time.sleep(0.05)
        net.client("a").call("L1", "mesh.register", {"addr": "hostA:1"})

    t = threading.Thread(target=failover)
    t.start()
    info = register_until_ready(net.client("b"), lambda: current[0], "hostB:1", timeout_s=5.0,
                                poll_s=0.01)
    t.join(timeout=5)
    assert info["ready"] and info["process_id"] == 1
    assert info["coordinator"] == "hostA:8853"  # hostA kept rank 0 across the failover


def test_backend_rule_and_one_group_a_process(tmp_path):
    """gloo on the CPU and where two ranks share a card (NCCL refuses
    that), NCCL where each rank has its own; and a process joins one group
    in its life: the same rank and size again is a no-op, another raises."""
    assert choose_backend(["h/cpu", "h/cpu"]) == "gloo"
    assert choose_backend(["h/GPU-a", "h/GPU-a"]) == "gloo"
    assert choose_backend(["h/GPU-a", "h/GPU-b"]) == "nccl"
    assert choose_backend(["h1/GPU-a", "h2/GPU-a"]) == "nccl"
    assert choose_backend(["h/GPU-a", "h/cpu"]) == "gloo"
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        info = {"process_id": 0, "num_processes": 1, "coordinator": "127.0.0.1:1"}
        assert initialize_global_runtime(info, device="cpu")["backend"] == "gloo"
        with pytest.raises(RuntimeError, match="cannot join as rank 1 of 2"):
            initialize_global_runtime({**info, "process_id": 1, "num_processes": 2},
                                      device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Across the wire: either package's member against either package's leader
# ---------------------------------------------------------------------------


def _register_pair(rpc, register, boot, server_cls):
    """Two members register with ``boot`` served over TCP: the first by one
    call, the second through ``register`` to quorum; then the first again
    (a restart) and ``mesh.info``."""
    srv = server_cls("127.0.0.1", 0, boot.methods())
    try:
        first = rpc.call(srv.address, "mesh.register", {"addr": "10.0.0.1:7000"}, timeout=10)
        second = register(rpc, srv.address, "10.0.0.2:7000", timeout_s=10.0, poll_s=0.01)
        again = register(rpc, srv.address, "10.0.0.1:7000", timeout_s=10.0, poll_s=0.01)
        return [first, second, again, rpc.call(srv.address, "mesh.info", {}, timeout=10)]
    finally:
        srv.close()


def test_member_and_leader_of_either_package_agree_on_the_rank_map():
    all_jax = _register_pair(JaxTcpRpc(), jax_register_until_ready,
                             JaxMeshBootstrap(8853, 2), JaxTcpRpcServer)
    port_member = _register_pair(TcpRpc(), register_until_ready,
                                 JaxMeshBootstrap(8853, 2), JaxTcpRpcServer)
    port_leader = _register_pair(JaxTcpRpc(), jax_register_until_ready,
                                 MeshBootstrap(8853, 2), TcpRpcServer)
    assert all_jax[1] == {"process_id": 1, "num_processes": 2, "coordinator": "10.0.0.1:8853",
                          "registered": 2, "ready": True}
    assert port_member == all_jax
    assert port_leader == all_jax


def test_port_standby_adopts_a_jax_leaders_mesh_state():
    leader = JaxMeshBootstrap(8853, 3)
    srv = JaxTcpRpcServer("127.0.0.1", 0, leader.methods())
    try:
        rpc = JaxTcpRpc()
        for host in ("10.0.0.5", "10.0.0.6"):
            rpc.call(srv.address, "mesh.register", {"addr": f"{host}:7000"}, timeout=10)
        standby = MeshBootstrap(8853, 3, is_leading=False)
        standby.adopt_state(TcpRpc().call(srv.address, "mesh.state", {}, timeout=10))
    finally:
        srv.close()
    assert standby.ranks == leader.ranks == {"10.0.0.5:7000": 0, "10.0.0.6:7000": 1}
    standby.is_leading = True  # promoted after the JAX leader died
    net = SimRpcNetwork()
    net.serve("S", standby.methods())
    again = net.client("x").call("S", "mesh.register", {"addr": "10.0.0.6:7000"})
    assert again["process_id"] == 1 and again["coordinator"] == "10.0.0.5:8853"
    third = net.client("x").call("S", "mesh.register", {"addr": "10.0.0.7:7000"})
    assert third["process_id"] == 2 and third["ready"]


# ---------------------------------------------------------------------------
# Two processes: one gloo group through a port leader's MeshBootstrap
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leader(world: int):
    """A port leader's MeshBootstrap for ``world`` processes, served over
    TCP, with a coordinator port that is free now."""
    boot = MeshBootstrap(coordinator_port=_free_port(), num_processes=world)
    return boot, TcpRpcServer("127.0.0.1", 0, boot.methods())


def _env():
    return dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
                PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _stop(procs) -> None:
    for p in procs:
        if p.stdin is not None and not p.stdin.closed:
            try:
                p.stdin.close()
            except OSError:  # a dead worker's pipe: nothing left to close
                pass
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def _jax_vit():
    return JaxViT(num_classes=CLASSES, dtype=jnp.float32, **VIT)


def _jax_resnet():
    return JaxResNet(stage_sizes=[1, 1], block_cls=JaxBasicBlock, num_classes=CLASSES,
                     num_filters=8, dtype=jnp.float32)


def _jax_steps(model, variables, images, labels, steps, grad_accum=1):
    """The JAX step in one process over the whole batch."""
    state = jax_create_train_state(model, variables, jax_default_optimizer(LR))
    state, step = jax_make_train_step(jax_make_mesh({"dp": 1}, devices=jax.devices()[:1]), state,
                                      grad_accum=grad_accum)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, images, labels)
        losses.append(float(metrics["loss"]))
    return state, losses


def test_two_process_dp_train_step_matches_jax_on_the_whole_batch(tmp_path):
    images, labels = batch()
    labels = labels.astype(np.int32)
    vit_vars = jax.tree_util.tree_map(
        np.asarray, _jax_vit().init(jax.random.PRNGKey(4), images, train=False))
    resnet_vars = jax.tree_util.tree_map(
        np.asarray, _jax_resnet().init(jax.random.PRNGKey(5), images, train=False))
    weights = {f"vit.{k}": v.numpy() for k, v in vit_from_jax(vit_vars).items()}
    weights |= {f"resnet.{k}": v.numpy() for k, v in resnet_from_jax(resnet_vars).items()}
    np.savez(tmp_path / "weights.npz", **weights)

    boot, srv = _leader(2)
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(WORKER), "train", srv.address, f"127.0.0.1:{7000 + i}",
             str(tmp_path / "weights.npz"), str(tmp_path / f"out{i}.npz")],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(2)]
        outs = [p.communicate(timeout=50)[0].decode(errors="replace") for p in procs]
        assert [p.returncode for p in procs] == [0, 0], outs
    finally:
        srv.close()
        for p in procs:
            p.kill()
    assert sorted(boot.group().values()) == [0, 1]
    got = sorted((dict(np.load(tmp_path / f"out{i}.npz")) for i in range(2)),
                 key=lambda r: int(r["rank"]))
    assert [str(r["backend"]) for r in got] == ["gloo", "gloo"]
    for key in ("vit_losses", "accum_loss", "resnet_loss"):
        np.testing.assert_allclose(got[1][key], got[0][key], rtol=1e-6, err_msg=key)
    for k in got[0]:  # the replicas stay equal
        if k.startswith("vit."):
            np.testing.assert_array_equal(got[1][k], got[0][k], err_msg=k)

    state, want = _jax_steps(_jax_vit(), vit_vars, images, labels, 2)
    np.testing.assert_allclose(got[0]["vit_losses"], want, atol=1e-5)
    params = vit_from_jax({"params": jax.tree_util.tree_map(np.asarray, state.params)})
    for k, w in params.items():
        atol = 2 * LR * 2 if k.endswith(ZERO_GRAD_SUFFIX) else 2e-5
        np.testing.assert_allclose(got[0][f"vit.{k}"], w.numpy(), atol=atol, err_msg=k)
    _, want = _jax_steps(_jax_vit(), vit_vars, images, labels, 1, grad_accum=2)
    np.testing.assert_allclose(got[0]["accum_loss"], want[0], atol=1e-5)
    state, want = _jax_steps(_jax_resnet(), resnet_vars, images, labels, 1)
    np.testing.assert_allclose(got[0]["resnet_loss"], want[0], atol=1e-5)
    stats = resnet_from_jax({"params": jax.tree_util.tree_map(np.asarray, state.params),
                             "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                   state.batch_stats)})
    held = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(held) == 12
    for k in held:
        np.testing.assert_allclose(got[0][f"resnet.{k}"], stats[k].numpy(), atol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def gang_corpus(tmp_path_factory):
    """12 one-image classes and the truth: the tinynet backend's own solo
    prediction of each (job.correct then holds the gang to it row for
    row)."""
    data_dir, synset_path = corpus.generate(tmp_path_factory.mktemp("gang"), n_classes=12,
                                            images_per_class=1, size=SIZE)
    synsets = [line.split()[0] for line in synset_path.read_text().splitlines()]
    solo = EngineBackend("tinynet", data_dir, batch_size=16, device="cpu",
                         variables=tiny_variables(0), dtype=torch.float32)
    return data_dir, list(zip(synsets, solo(synsets)))


def _spawn_gang(data_dir, world=2):
    """``world`` gang workers joined through a fresh port leader; returns
    (bootstrap, leader server, processes, member addresses by rank) once
    every worker printed its ready line, tearing all down on a failed
    start."""
    boot, srv = _leader(world)
    procs = [subprocess.Popen([sys.executable, str(WORKER), "gang", srv.address, str(data_dir)],
                              env=_env(), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True)
             for _ in range(world)]
    try:
        ready = []
        for p in procs:
            for line in p.stdout:
                if line.lstrip().startswith("{"):
                    ready.append(json.loads(line))
                    break
            else:
                raise AssertionError(f"gang worker exited with {p.wait(timeout=10)}")
        assert all(r["ready"] and r["backend"] == "gloo" for r in ready)
        addrs = [r["addr"] for r in sorted(ready, key=lambda r: r["rank"])]
        assert boot.group() == {a: i for i, a in enumerate(addrs)}
    except BaseException:
        srv.close()
        for p in procs:
            p.kill()
        raise
    return boot, srv, procs, addrs


def test_gang_job_over_a_joined_two_process_mesh(gang_corpus):
    data_dir, queries = gang_corpus
    boot, srv, procs, addrs = _spawn_gang(data_dir)
    try:
        sched = JobScheduler(TcpRpc(), lambda: list(addrs), jobs={"tinynet": queries},
                             shard_size=8, mesh_group=boot.group, shard_timeout_s=20.0)
        sched.is_leading = True
        sched._start({})
        sched.assign_once()
        sched.run_to_completion(max_rounds=100)
        job = sched.jobs["tinynet"]
        rep = job.report()
        assert job.finished == len(queries) == 12
        assert job.correct == len(queries), rep
        assert rep["gang_shards"] == 2  # 12 queries / shard 8 -> 2 collective shards
    finally:
        srv.close()
        _stop(procs)


def test_gang_kill_and_reform_at_world_two(gang_corpus):
    """A rank killed mid-job fails the next collective shard whole: it is
    requeued with no partial credit, nothing is left outstanding and no
    breaker steps. A fresh gang then forms through a new leader bootstrap,
    and the same job resumes from the requeued shard and completes, every
    prediction correct, exactly once."""
    data_dir, queries = gang_corpus
    holder: dict = {}
    boot, srv, procs, addrs = _spawn_gang(data_dir)
    holder.update(boot=boot, addrs=addrs)
    procs2, srv2 = [], None
    try:
        sched = JobScheduler(TcpRpc(), lambda: list(holder["addrs"]),
                             jobs={"tinynet": queries}, shard_size=8,
                             mesh_group=lambda: holder["boot"].group(), shard_timeout_s=15.0)
        sched.is_leading = True
        sched._start({})
        sched.assign_once()
        job = sched.jobs["tinynet"]
        assert sched.dispatch_once("tinynet") == 8 and job.finished == 8
        assert job.report()["gang_shards"] == 1

        procs[1].kill()
        procs[1].wait(timeout=10)
        assert sched.dispatch_once("tinynet") == 0
        assert job.finished == 8 and not job.done
        assert job.retry_q and job.retry_q[0][0] == 8  # whole-shard requeue
        assert job.outstanding == {}
        # The JAX survivor hangs in the dead collective until the shard
        # timeout, which the scheduler counts as weather. The port's gloo
        # survivor sees the closed connection at once and answers with that
        # error, which the scheduler (the JAX package's, copied) counts as
        # one method-level failure: one step of 8 toward the breaker, reset
        # by the next collective that succeeds.
        assert job.running and job.gang_consec_failures == 1

        srv.close()
        _stop(procs)  # the survivor is wedged in a dead group
        boot2, srv2, procs2, addrs2 = _spawn_gang(data_dir)
        holder.update(boot=boot2, addrs=addrs2)
        sched.assign_once()
        sched.run_to_completion(max_rounds=100)
        rep = job.report()
        assert job.done and job.finished == len(queries)
        assert job.correct == len(queries), rep
        assert rep["gang_shards"] == 2  # one per gang generation
        assert job.gang_consec_failures == 0
    finally:
        srv.close()
        if srv2 is not None:
            srv2.close()
        _stop(procs)
        _stop(procs2)
