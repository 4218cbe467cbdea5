"""The port's node, leader and CLI end to end: real fleets on localhost (UDP
gossip, TCP RPC, maintenance threads) in one process.

- tests/test_node_integration.py's cases on a port fleet through the port's
  CLI: the full stack, an authenticated fleet, the status verb and a leader
  failover that resumes the jobs; and ``python -m dmlc_tpu_torch.cli``
  driving a port fleet from a process of its own.
- tests/test_dataset_sdfs.py's four-node sharded inference from the store,
  with tinynet EngineBackends of this package at ``device="cpu"``.
- Mixed fleets: all-JAX, all-port, a port leader with JAX members, a JAX
  leader with port members, and a port leader with a JAX standby that takes
  over mid-job. Each runs the same two 40-synset jobs with tinynet engines
  on seeded variables carried from the JAX tree; each job's ``finished``
  and ``correct`` and the members assigned at ``predict`` must equal the
  all-JAX fleet's. The JAX nodes run with ``placement_enabled=False``:
  this package has no placement advisor yet, and with it the JAX leader's
  assignment would follow its cost profiles instead of the round-robin
  split both packages share.
- The observability plane across packages: a port leader with JAX members
  and a JAX leader with port members, their images pulled through the
  store and both tracers on, run the jobs and one scrape pass; the
  leader's ``obs.fleet`` lists every member with the device monitor's
  gauges, ``obs.critpath`` has both jobs' lanes, and ``trace fleet``
  writes one document in which one dispatch's trace holds spans of all
  three nodes. The jobs still equal the all-JAX fleet's: the profiler
  without an advisor does not move assignment.

Every store lives under ``tmp_path``; every fleet is stopped in
``finally``; every test runs under ``torch_sockets``' time limit.
"""

import errno
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tiny_model
import torch
from test_torch_engine import SIZE, TorchTinyNet, tiny_from_jax, tiny_to_jax, tiny_variables
from torch_sides import JAX, PORT
from torch_sockets import socket_time_limit  # noqa: F401  (autouse fixture)

import dmlc_tpu.cluster.node as jax_node
from dmlc_tpu.models import registry as jax_registry
from dmlc_tpu_torch.cli import Cli
from dmlc_tpu_torch.cluster import node as port_node
from dmlc_tpu_torch.cluster.localcluster import (
    PORT_RANGE,
    echo_backend,
    make_synsets,
    start_local_cluster,
    stop_local_cluster,
    wait_until,
)
from dmlc_tpu_torch.models import registry as port_registry

REPO = Path(__file__).resolve().parent.parent
N_CLASSES = tiny_model.N_CLASSES

# A second tiny model, so the mixed fleets run two jobs as the reference does
# (resnet18 and alexnet) and the round-robin split gives each its own members.
if "tinynet_b" not in jax_registry.list_models():
    jax_registry.register(jax_registry.ModelSpec(
        "tinynet_b", tiny_model.tinynet, input_size=SIZE, num_outputs=N_CLASSES))
if "tinynet_b" not in port_registry.list_models():
    port_registry.register(port_registry.ModelSpec(
        "tinynet_b", TorchTinyNet, SIZE, N_CLASSES, from_jax=tiny_from_jax, to_jax=tiny_to_jax))

JOBS = {"tinynet": 0, "tinynet_b": 1}  # job model -> seed of its variables
BATCH = 8


class Slow:
    """A backend that takes ``seconds`` longer a shard, so a failover lands
    mid-job."""

    def __init__(self, backend, seconds: float):
        self.backend, self.seconds = backend, seconds

    def __call__(self, synsets):
        time.sleep(self.seconds)
        return self.backend(synsets)


def free_port_block() -> int:
    """The first port of a block, drawn as localcluster draws one."""
    return random.randint(*PORT_RANGE) // 10 * 10


@pytest.fixture
def cluster3(tmp_path):
    """3 real port nodes on 127.0.0.1 via the port's harness (echo backends,
    joined + converged + first leader promoted)."""
    nodes = start_local_cluster(tmp_path, n_nodes=3)
    yield nodes
    stop_local_cluster(nodes)


def test_full_stack_through_cli(cluster3, tmp_path):
    nodes = cluster3
    cli = Cli(nodes[1])  # drive from a non-leader node

    out = cli.run_command("lm")
    assert out.count("active") == 3
    assert nodes[1].gossip.address in cli.run_command("list_self")

    src = tmp_path / "w.bin"
    src.write_bytes(b"weights-bytes-v1")
    assert "1" in cli.run_command(f"put {src} models/resnet18")
    dst = tmp_path / "out.bin"
    assert "v1" in cli.run_command(f"get models/resnet18 {dst}")
    assert dst.read_bytes() == b"weights-bytes-v1"

    src.write_bytes(b"weights-bytes-v2")
    cli.run_command(f"put {src} models/resnet18")
    merged = tmp_path / "merged.bin"
    assert "[2, 1]" in cli.run_command(f"gv models/resnet18 2 {merged}")
    assert b"== Version 2 ==" in merged.read_bytes()
    assert "models/resnet18" in cli.run_command("ls models/resnet18")

    # train: broadcast the weights to every member, visible in local stores
    cli.run_command("train")
    wait_until(
        lambda: "models/resnet18" in Cli(nodes[2]).run_command("store"),
        msg="train broadcast reaches node2's store",
    )

    out = cli.run_command("predict")
    assert "resnet18" in out and "alexnet" in out
    leader = nodes[0]
    wait_until(lambda: all(j.done for j in leader.scheduler.jobs.values()), msg="jobs complete")
    out = cli.run_command("jobs")
    assert out.count("40/40 finished") == 2
    assert out.count("accuracy 100.00%") == 2
    assert "p99" in out
    assert "resnet18" in cli.run_command("assign")
    assert "all digests verified" in cli.run_command("scrub")

    from dmlc_tpu_torch.utils.tracing import tracer

    try:
        # Both peers are port members, reached through obs.trace_ctl.
        assert "enabled (fleet: 2/2 peers reached)" in cli.run_command("trace on")
        cli.run_command(f"get models/resnet18 {tmp_path / 'traced.bin'}")
        trace_path = tmp_path / "trace.json"
        assert "rpc/" in cli.run_command("trace summary")
        assert "wrote Chrome trace" in cli.run_command(f"trace export {trace_path}")
        assert trace_path.exists() and "traceEvents" in trace_path.read_text()
        assert "disabled" in cli.run_command("trace off")
    finally:
        tracer.enabled = False
        tracer.reset()

    assert "flight ring" in cli.run_command("flight")
    assert "no tenants declared" in cli.run_command("tenants")
    assert "error" in cli.run_command("get no/such/file /tmp/x")
    assert "unknown command" in cli.run_command("frobnicate")
    assert "usage" in cli.run_command("put onlyonearg")
    # The observability verbs answer as the JAX package's do.
    out = cli.run_command("metrics")
    assert "counters:" in out and "device_peak_flops=1e+12" in out, out
    assert "dmlc_decode_lane_idle" in cli.run_command("metrics prom")
    wait_until(lambda: len(leader.fleet_metrics) == 3, msg="the leader scraped every member")
    fleet = cli.run_command("metrics fleet")
    assert all(n.self_member_addr in fleet for n in nodes), fleet
    # The leader's profile holds the dispatch lanes of the jobs it ran.
    out = Cli(leader).run_command("profile --model resnet18")
    assert "dispatch" in out and "alexnet" not in out, out
    trace = cli.run_command(f"trace fleet {tmp_path / 'f.json'}")
    assert "wrote merged fleet trace" in trace and "node lane(s)" in trace, trace
    assert (tmp_path / "f.json").exists()
    # The device table: every member, HBM unknown on the CPU.
    table = cli.run_command("device")
    assert "hbm used/limit" in table and "steady recompiles" in table
    for n in nodes:
        assert n.self_member_addr in table
    # The verbs that wait for an unported module name it.
    assert "scheduler/genrouter.py" in cli.run_command("generate lm_small 1 2")
    assert "scheduler/placement.py" in cli.run_command("slo")
    assert "mesh-join" in cli.run_command("help")


def test_authenticated_cluster_end_to_end(tmp_path):
    """A fleet sharing auth_key converges, replicates, and serves jobs with
    every gossip datagram and RPC frame HMAC-tagged — and an unkeyed caller
    cannot reach the leader's methods."""
    nodes = start_local_cluster(tmp_path, n_nodes=3, auth_key="fleet-secret")
    try:
        cli = Cli(nodes[1])
        assert cli.run_command("lm").count("active") == 3

        src = tmp_path / "w.bin"
        src.write_bytes(b"keyed-bytes")
        cli.run_command(f"put {src} models/keyed")
        dst = tmp_path / "out.bin"
        cli.run_command(f"get models/keyed {dst}")
        assert dst.read_bytes() == b"keyed-bytes"

        cli.run_command("predict")
        wait_until(lambda: all(j.done for j in nodes[0].scheduler.jobs.values()),
                   msg="keyed jobs complete")
        assert cli.run_command("jobs").count("40/40 finished") == 2

        with pytest.raises(PORT.rpc.RpcUnreachable):
            PORT.rpc.TcpRpc().call(nodes[0].self_leader_addr, "sdfs.delete",
                                   {"name": "models/keyed"}, timeout=2.0)
    finally:
        stop_local_cluster(nodes)


def test_status_verb_shows_shed_requests(cluster3):
    nodes = cluster3
    member = nodes[2]
    cli = Cli(member)
    out = cli.run_command("status")
    assert "predict gate" in out and "transfer gate" in out
    assert f"node {member.self_member_addr}" in out

    holders = [member.predict_gate.admit() for _ in range(member.predict_gate.capacity)]
    for h in holders:
        h.__enter__()
    try:
        with pytest.raises(PORT.rpc.Overloaded):
            nodes[0].rpc.call(member.self_member_addr, "job.predict",
                              {"model": "resnet18", "synsets": ["n00000001"]}, timeout=5.0)
    finally:
        for h in holders:
            h.__exit__(None, None, None)
    out = cli.run_command("status")
    assert "shed=1" in out, out
    assert "shed_predict=1" in out, out
    assert member.metrics.get("shed") == 1


def test_critpath_verb_renders_fleet_attribution(cluster3):
    """tests/test_node_integration.py's case on a port fleet: after traced
    predict traffic, the CLI ``critpath`` verb renders the leader's folded
    critical-path table, (stage x member) lanes with charged seconds and
    shares; ``slo`` names the module it waits for."""
    from dmlc_tpu_torch.utils.tracing import tracer

    nodes = cluster3
    leader = nodes[0]
    cli = Cli(nodes[1])
    try:
        tracer.enabled = True
        cli.run_command("predict")
        wait_until(lambda: all(j.done for j in leader.scheduler.jobs.values()),
                   msg="jobs complete")
        # Charge the process tracer's spans and fold them leader-side the
        # same way the scrape cycle does, without waiting for its cadence.
        assert leader.critpath is not None
        leader.critpath.ingest_tracer(tracer, own_lane=None)
        leader.fleet_critpath.fold("local", leader.critpath.snapshot())

        out = cli.run_command("critpath")
        lines = out.splitlines()
        assert "model" in lines[0] and "share" in lines[0], out
        assert len(lines) >= 2, out
        # --top bounds lanes per model; unknown models and extra args are
        # clean misses, not crashes.
        top = cli.run_command("critpath --top 1")
        assert len(top.splitlines()) <= len(lines)
        assert "no critical-path lanes" in cli.run_command("critpath nope")
        assert "usage:" in cli.run_command("critpath a b")
        assert "scheduler/placement.py" in cli.run_command("slo")
    finally:
        tracer.enabled = False
        tracer.reset()


def test_leader_failover_resumes_jobs(tmp_path):
    """The standby mirrors the leader's cursor, takes over when the leader
    stops mid-job, and finishes the jobs; the member's tracker follows."""
    slow = Slow(echo_backend, 0.05)
    nodes = start_local_cluster(tmp_path, n_nodes=3, dispatch_workers=1,
                                backends={"resnet18": slow, "alexnet": slow})
    try:
        leader, standby, member = nodes
        cli = Cli(member)
        cli.run_command("predict")
        wait_until(lambda: any(j.finished > 0 for j in standby.scheduler.jobs.values()),
                   msg="standby state sync")
        mid_job = not all(j.done for j in standby.scheduler.jobs.values())
        leader.stop()
        wait_until(lambda: standby.standby.is_leader, msg="standby promotion")
        wait_until(lambda: all(j.done for j in standby.scheduler.jobs.values()),
                   msg="jobs finish under the new leader")
        wait_until(lambda: member.tracker.current == standby.self_leader_addr,
                   msg="tracker advance")
        out = cli.run_command("jobs")
        assert out.count("40/40 finished") == 2
        assert out.count("accuracy 100.00%") == 2
        assert mid_job, "the jobs were done before the leader stopped"
    finally:
        stop_local_cluster(nodes)


def test_cli_module_drives_a_port_fleet(cluster3, tmp_path):
    """``python -m dmlc_tpu_torch.cli`` starts a port node from a config
    file and its verbs reach the fleet's leader. The node serves no model
    (``job_models`` empty), so shards the leader sends it fail over to the
    fleet's members."""
    nodes = cluster3
    cfg = nodes[0].config
    src = tmp_path / "w.bin"
    src.write_bytes(b"from-the-cli")
    commands = "\n".join([
        f"join {nodes[0].gossip.address}", f"put {src} models/cli", "ls models/cli",
        f"get models/cli {tmp_path / 'back.bin'}", "predict", "jobs", "exit", "",
    ])
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONPATH": str(REPO)}
    for _ in range(3):
        base = free_port_block()
        config = {
            "host": "127.0.0.1", "gossip_port": base, "leader_port": base + 1,
            "member_port": base + 2, "leader_candidates": list(cfg.leader_candidates),
            "storage_dir": str(tmp_path / "cli_node" / "storage"),
            "synset_path": cfg.synset_path, "eager_load": False, "job_models": [],
        }
        path = tmp_path / "cluster.json"
        path.write_text(json.dumps(config))
        done = subprocess.run(
            [sys.executable, "-m", "dmlc_tpu_torch.cli", "--config", str(path), "--device",
             "cpu", "--log-file", str(tmp_path / "cli.log")],
            input=commands, capture_output=True, text=True, timeout=45, env=env, cwd=tmp_path,
        )
        if "Address already in use" not in done.stderr:
            break
    assert done.returncode == 0, done.stderr
    out = done.stdout
    assert f"node up: member=127.0.0.1:{base + 2}" in out, out
    assert f"join sent to {nodes[0].gossip.address}" in out
    assert "models/cli" in out and "fetched models/cli v1" in out
    assert (tmp_path / "back.bin").read_bytes() == b"from-the-cli"
    assert "started jobs: alexnet, resnet18" in out
    assert "/40 finished" in out
    wait_until(lambda: all(j.done for j in nodes[0].scheduler.jobs.values()), msg="jobs done")
    report = nodes[0].jobs_report()
    assert [report[m]["correct"] for m in ("alexnet", "resnet18")] == [40, 40]


def make_corpus(tmp_path, n):
    from PIL import Image

    synsets = tmp_path / "synsets.txt"
    synsets.write_text("".join(f"n{i:08d} label {i}\n" for i in range(n)))
    data = tmp_path / "seed_corpus"
    rng = np.random.default_rng(5)
    for i in range(n):
        d = data / f"n{i:08d}"
        d.mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8)).save(d / "x.jpg")
    return synsets, data


def test_four_node_sdfs_sharded_inference(tmp_path):
    """4 port nodes, zero local corpora, tinynet engines on the CPU:
    publish -> predict -> every shard served from SDFS-pulled images."""
    synset_path, seed_data = make_corpus(tmp_path, N_CLASSES)
    nodes = []
    try:
        nodes = start_local_cluster(
            tmp_path, n_nodes=4, n_leader_candidates=1, synset_path=synset_path,
            data_from_sdfs=True, job_models=["tinynet"], batch_size=BATCH,
            # A failure timeout of 30 heartbeats: a member that a loaded
            # test host starves for a second must not be healed around
            # (a third replica of rf 2).
            dispatch_workers=4, device="cpu", heartbeat_interval_s=0.1, failure_timeout_s=3.0,
            rereplication_interval_s=0.2, assignment_interval_s=0.2,
            leader_probe_interval_s=0.2,
            backends=lambda i: {"tinynet": PORT.worker.EngineBackend(
                "tinynet", tmp_path / f"node{i}" / "no_such_corpus", batch_size=BATCH,
                device="cpu")},
        )
        assert PORT.dataset.publish_corpus(nodes[2].sdfs, seed_data) == N_CLASSES
        name = PORT.dataset.sdfs_image_name("n00000000")
        assert len(nodes[1].sdfs.ls(name)[name]) == 2  # rf 2

        nodes[1].predict()
        wait_until(lambda: all(j.done for j in nodes[0].scheduler.jobs.values()),
                   timeout=40.0, msg="sharded jobs complete")
        report = nodes[3].jobs_report()["tinynet"]
        assert report["finished"] == N_CLASSES
        assert len(report["member_latency"]) == 4  # every member served shards
        assert any(any((tmp_path / f"node{i}" / "data_cache").glob("*.img")) for i in range(4))
    finally:
        stop_local_cluster(nodes)


# ---------------------------------------------------------------------------
# Mixed fleets: the same jobs on nodes of either package
# ---------------------------------------------------------------------------


def jax_backend(model, data_dir):
    variables = jax.tree_util.tree_map(jnp.asarray, tiny_variables(JOBS[model]))
    return JAX.worker.EngineBackend(model, data_dir, batch_size=BATCH, variables=variables,
                                    dtype=jnp.float32)


def port_backend(model, data_dir):
    return PORT.worker.EngineBackend(model, data_dir, batch_size=BATCH,
                                     variables=tiny_variables(JOBS[model]),
                                     dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """40 synsets whose images are picked from a seeded pool so that the
    ``tinynet`` job's answers are right wherever an image of that class
    exists (the truth is the synset's line): a miscounted or misrouted
    shard changes ``correct``. Only images on which the JAX and the port
    engines agree are picked. Returns (synset path, data dir, the counts an
    in-process engine gives)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("mixed")
    pool_dir = root / "pool"
    rng = np.random.default_rng(11)
    pool = []
    for k in range(6 * N_CLASSES):
        d = pool_dir / f"p{k:05d}"
        d.mkdir(parents=True)
        coarse = rng.integers(0, 256, (4, 4, 3), np.uint8)
        img = np.repeat(np.repeat(coarse, 8, 0), 8, 1) // 2 + rng.integers(0, 128, (32, 32, 3),
                                                                          np.uint8)
        Image.fromarray(img.astype(np.uint8)).save(d / "x.jpg", quality=95)
        pool.append(d.name)
    jax_top1 = jax_backend("tinynet", pool_dir)(pool)
    port_top1 = port_backend("tinynet", pool_dir)(pool)
    agree = [k for k in range(len(pool)) if jax_top1[k] == port_top1[k]]
    picks, used = [], set()
    for i in range(N_CLASSES):
        k = next((k for k in agree if jax_top1[k] == i and k not in used), None)
        if k is None:
            k = next(k for k in agree if k not in used)
        used.add(k)
        picks.append(k)
    data_dir = root / "train"
    for i, k in enumerate(picks):
        d = data_dir / f"n{i:08d}"
        d.mkdir(parents=True)
        (d / "x.jpg").write_bytes((pool_dir / pool[k] / "x.jpg").read_bytes())
    synset_path = make_synsets(root / "synsets.txt", N_CLASSES)
    synsets = [f"n{i:08d}" for i in range(N_CLASSES)]
    expected = {}
    for model in JOBS:
        top1 = jax_backend(model, data_dir)(synsets)
        assert port_backend(model, data_dir)(synsets) == top1
        expected[model] = {"finished": N_CLASSES,
                           "correct": sum(int(p == i) for i, p in enumerate(top1))}
    # Well above the one right answer a random labelling of 40 gives.
    assert expected["tinynet"]["correct"] >= 5
    return synset_path, data_dir, expected


SIDE_OF = {"J": (JAX, jax_node, jax_backend), "P": (PORT, port_node, port_backend)}


def start_fleet(tmp, kinds: str, synset_path, data_dir, slow_s: float = 0.0, **overrides):
    """Nodes of the packages ``kinds`` names ("J"/"P" each), laid out as
    localcluster lays out its fleet (nodes 0 and 1 leader candidates),
    joined, converged, and node 0 promoted."""
    for _ in range(3):
        base = free_port_block()
        candidates = [f"127.0.0.1:{base + 10 * i + 1}" for i in range(2)]
        nodes = []
        try:
            for i, kind in enumerate(kinds):
                side, node_mod, make_backend = SIDE_OF[kind]
                fields = dict(
                    host="127.0.0.1", gossip_port=base + 10 * i, leader_port=base + 10 * i + 1,
                    member_port=base + 10 * i + 2, leader_candidates=candidates,
                    storage_dir=str(tmp / f"node{i}" / "storage"), synset_path=str(synset_path),
                    data_dir=str(data_dir), job_models=list(JOBS), batch_size=BATCH,
                    replication_factor=2, dispatch_shard_size=BATCH, placement_enabled=False,
                    # A failure timeout of six heartbeats: a loaded test host
                    # must not drop a member between convergence and predict.
                    heartbeat_interval_s=0.25, failure_timeout_s=1.5,
                    rereplication_interval_s=0.6, assignment_interval_s=0.6,
                    leader_probe_interval_s=0.6,
                )
                fields.update(overrides)
                backends = {m: make_backend(m, data_dir) for m in JOBS}
                if slow_s:
                    backends = {m: Slow(b, slow_s) for m, b in backends.items()}
                node = node_mod.ClusterNode(side.config.ClusterConfig(**fields), backends=backends)
                node.start()
                nodes.append(node)
            for n in nodes[1:]:
                n.join(nodes[0].gossip.address)
            wait_until(lambda: all(len(n.membership.active_ids()) == len(kinds) for n in nodes),
                       msg="mixed membership convergence")
            wait_until(lambda: nodes[0].standby.is_leader, msg="first-leader promotion")
            return nodes
        except OSError as e:
            stop_local_cluster(nodes)
            if e.errno != errno.EADDRINUSE:
                raise
            last = e
        except BaseException:
            stop_local_cluster(nodes)
            raise
    raise last


def run_jobs(nodes, failover: bool = False) -> dict:
    """predict from the last node; the jobs' counts and the members (by
    node index) the leader assigned each job at predict."""
    index = {n.self_member_addr: i for i, n in enumerate(nodes)}
    client = nodes[-1]
    client.predict()
    assigned = {job: sorted(index[a] for a in members)
                for job, members in client.assignments().items()}
    leader = nodes[0]
    mid_job = None
    if failover:
        standby = nodes[1]
        wait_until(lambda: any(j.finished > 0 for j in standby.scheduler.jobs.values()),
                   msg="standby state sync")
        mid_job = not all(j.done for j in standby.scheduler.jobs.values())
        leader.stop()
        wait_until(lambda: standby.standby.is_leader, msg="standby promotion")
        leader = standby
        wait_until(lambda: client.tracker.current == standby.self_leader_addr,
                   msg="tracker advance")
    wait_until(lambda: all(j.done for j in leader.scheduler.jobs.values()), timeout=40.0,
               msg="jobs complete")
    report = client.jobs_report()
    return {"assigned": assigned, "mid_job": mid_job,
            "jobs": {job: {k: r[k] for k in ("finished", "correct")}
                     for job, r in report.items()}}


@pytest.fixture(scope="module")
def all_jax(workload, tmp_path_factory):
    synset_path, data_dir, _ = workload
    nodes = start_fleet(tmp_path_factory.mktemp("all_jax"), "JJJ", synset_path, data_dir)
    try:
        return run_jobs(nodes)
    finally:
        stop_local_cluster(nodes)


def test_all_jax_fleet_gives_the_in_process_counts(workload, all_jax):
    _, _, expected = workload
    assert all_jax["jobs"] == expected
    # Two jobs over three members: the sorted round-robin split.
    assert all_jax["assigned"] == {"tinynet": [0, 2], "tinynet_b": [1]}


@pytest.mark.parametrize("kinds", ["PPP", "PJJ", "JPP"],
                         ids=["all_port", "port_leader_jax_members", "jax_leader_port_members"])
def test_mixed_fleet_equals_all_jax(workload, all_jax, tmp_path, kinds):
    synset_path, data_dir, _ = workload
    nodes = start_fleet(tmp_path, kinds, synset_path, data_dir)
    try:
        got = run_jobs(nodes)
        if kinds[0] == "J":
            # The JAX leader's obs.metrics scrape of a port member answers
            # in the reference's form.
            reply = nodes[0].rpc.call(nodes[1].self_member_addr, "obs.metrics", {},
                                      timeout=5.0)
            assert {"metrics", "spans", "sampling", "critpath"} <= set(reply)
            assert "hbm_bytes_in_use" in reply["metrics"]["gauges"]
    finally:
        stop_local_cluster(nodes)
    assert got["jobs"] == all_jax["jobs"]
    assert got["assigned"] == all_jax["assigned"]


def test_port_leader_fails_over_to_jax_standby(workload, all_jax, tmp_path):
    """The port leader stops mid-job; the JAX standby, which mirrored its
    cursor and store directory, promotes and finishes the jobs exactly
    once."""
    synset_path, data_dir, _ = workload
    nodes = start_fleet(tmp_path, "PJP", synset_path, data_dir, slow_s=0.1,
                        dispatch_workers=1)
    try:
        got = run_jobs(nodes, failover=True)
    finally:
        stop_local_cluster(nodes)
    assert got["mid_job"], "the jobs were done before the leader stopped"
    assert got["jobs"] == all_jax["jobs"]
    assert got["assigned"] == all_jax["assigned"]


#: The device monitor's gauges every member exports (the reference's names).
DEVICE_GAUGES = ("hbm_bytes_in_use", "hbm_peak_bytes", "hbm_limit_bytes", "jit_compiles",
                 "jit_compile_seconds", "jit_steady_recompiles", "device_peak_flops",
                 *(f"{kind}_{job}" for job in JOBS for kind in ("resident_bytes", "mfu")))


@pytest.mark.parametrize("kinds", ["PJJ", "JPP"],
                         ids=["port_leader_jax_members", "jax_leader_port_members"])
def test_mixed_fleet_observability(workload, all_jax, tmp_path, kinds):
    synset_path, data_dir, _ = workload
    tracers = (JAX.tracing.tracer, PORT.tracing.tracer)
    for tr in tracers:
        tr.reset()
        tr.enabled = True
    nodes = start_fleet(tmp_path, kinds, synset_path, data_dir, data_from_sdfs=True)
    try:
        client = nodes[-1]
        client_side = SIDE_OF[kinds[-1]][0]
        assert client_side.dataset.publish_corpus(client.sdfs, data_dir) == N_CLASSES
        got = run_jobs(nodes)
        leader = nodes[0]
        leader.timers.fire("obs_scrape")  # one scrape pass, on this thread
        members = sorted(n.self_member_addr for n in nodes)

        fleet = client.rpc.call(leader.self_leader_addr, "obs.fleet", {}, timeout=5.0)
        assert sorted(fleet["fleet"]) == members
        for addr, reply in fleet["fleet"].items():
            gauges = reply["metrics"]["gauges"]
            assert set(DEVICE_GAUGES) <= set(gauges), (addr, sorted(gauges))
            assert gauges["hbm_bytes_in_use"] is None  # no card on the CPU
            assert gauges["resident_bytes_tinynet"] > 0
        crit = client.rpc.call(leader.self_leader_addr, "obs.critpath", {}, timeout=5.0)
        assert set(JOBS) <= set(crit["critpath"]["models"]), crit

        path = tmp_path / "fleet.json"
        out = client_side.cli.Cli(client).run_command(f"trace fleet {path}")
        assert "wrote merged fleet trace" in out, out
        doc = json.loads(path.read_text())
        lanes = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
        assert sorted(lanes.values()) == members
        by_trace: dict[str, list[dict]] = {}
        for e in doc["traceEvents"]:
            if e.get("ph") == "X" and e["args"].get("trace"):
                by_trace.setdefault(e["args"]["trace"], []).append(e)
        spanning = [t for t, evs in by_trace.items()
                    if "scheduler/dispatch" in {e["name"] for e in evs}
                    and "rpc/job.predict" in {e["name"] for e in evs}
                    and len({e["pid"] for e in evs}) == len(nodes)]
        assert spanning, {t: sorted({(e["name"], lanes[e["pid"]]) for e in evs})
                          for t, evs in list(by_trace.items())[:5]}
    finally:
        for tr in tracers:
            tr.enabled = False
            tr.reset()
        stop_local_cluster(nodes)
    assert got["jobs"] == all_jax["jobs"]
    assert got["assigned"] == all_jax["assigned"]
