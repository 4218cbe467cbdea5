"""The port's gang serving path against the JAX package's on the CPU:
``LmBackend``, the gang verbs, ``EngineBackend.predict_gang`` and
``InferenceEngine.run_batch_global``.

- ``LmBackend``: the solo over-budget refusal word for word, ``predict_gang``
  slices (an empty one answers ``[]``) with the JAX seed-0 tree carried
  across giving the JAX backend's tokens, ``resident_bytes`` equal to the
  JAX backend's at each width, ``load_variables`` re-sharding every cached
  width.
- The cluster: tests/test_sharding.py's
  ``test_lm_wide_serves_through_cluster_gang_path`` on the sim fabric, with
  port members under a port scheduler, port members under a JAX scheduler
  and JAX members under a port scheduler: the advisor plans a gang of 3
  from headroom alone, every dispatch is ``job.predict_gang``, and the job's
  accuracy is 1.0 against the members' own width-1 program (token
  identity).
- ``run_batch_global`` equals ``run_batch`` at world 1, and in a
  two-process gloo group (formed over a ``FileStore`` under ``tmp_path``)
  each rank gets back its own rows as ``run_batch`` gives them.

Every test runs under ``torch_sockets``' time limit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_engine import SIZE, tiny_variables
from torch_sides import JAX, PORT
from torch_sockets import socket_time_limit  # noqa: F401  (autouse fixture)

from dmlc_tpu.models.registry import get_model as jax_get_model
from dmlc_tpu.parallel import sharding as jsl
from dmlc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dmlc_tpu.scheduler.worker import LmBackend as JaxLmBackend
from dmlc_tpu_torch.cluster.rpc import RpcError
from dmlc_tpu_torch.parallel import sharding as sl
from dmlc_tpu_torch.parallel.inference import InferenceEngine
from dmlc_tpu_torch.parallel.mesh import make_mesh
from dmlc_tpu_torch.scheduler.worker import EngineBackend, LmBackend, PredictWorker
from dmlc_tpu_torch.utils import corpus

REPO = Path(__file__).resolve().parent.parent
PROMPT_LEN = 16
BUDGET = 10_000_000  # < lm_wide's 25 MB of replicated float32 weights


def jax_seed0_tree() -> dict:
    prog = jsl.ShardedProgram("lm_wide", jax_make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    return jax.device_get(prog.variables)


# ---------------------------------------------------------------------------
# LmBackend


def test_solo_refusal_equals_jax():
    ours = LmBackend("lm_wide", prompt_len=PROMPT_LEN, hbm_budget_bytes=BUDGET, device="cpu")
    ref = JaxLmBackend("lm_wide", prompt_len=PROMPT_LEN, hbm_budget_bytes=BUDGET)
    with pytest.raises(RpcError) as got:
        ours(["p0"])
    with pytest.raises(Exception) as want:
        ref(["p0"])
    assert str(got.value) == str(want.value)
    assert "over this chip's 10000000 HBM budget; serve it as a gang" in str(got.value)
    assert ours._programs == {}  # refused before building anything


def test_predict_gang_slices_and_empty_slice():
    tree = jax_seed0_tree()
    ours = LmBackend("lm_wide", prompt_len=PROMPT_LEN, device="cpu")
    ours.warmup()
    ours.load_variables(tree)
    ref = JaxLmBackend("lm_wide", prompt_len=PROMPT_LEN, devices=jax.devices()[:1])
    prompts = [f"p{i}" for i in range(5)]
    whole = ours(prompts)
    assert whole == ref(prompts)
    parts = [ours.predict_gang(prompts, rank, 3) for rank in range(3)]
    assert [len(p) for p in parts] == [2, 2, 1]
    assert sum(parts, []) == whole
    assert ours.predict_gang(prompts[:2], 2, 3) == []  # empty slice: no execution
    assert ours.predict_gang(prompts, 1, 3) == ref.predict_gang(prompts, 1, 3)


@pytest.mark.parametrize("width", [1, 2, 3, 8])
def test_resident_bytes_equal_jax(width):
    ours = LmBackend("lm_wide", device="cpu", devices=["cpu"] * width)
    ref = JaxLmBackend("lm_wide", devices=jax.devices()[:width])
    assert ours.resident_bytes() is None and ref.resident_bytes() is None
    ours._program(width)
    ref._program(width)
    got = ours.resident_bytes()
    assert isinstance(got, int) and got == ref.resident_bytes()
    if sl.plan_axes(width, num_heads=4)["tp"] > 1:  # sharded below the solo footprint
        assert got < get_lm_wide_bytes()
    else:  # pure dp (width 3: 4 heads) replicates
        assert got == get_lm_wide_bytes()


def get_lm_wide_bytes() -> int:
    return jax_get_model("lm_wide").param_bytes()


def test_load_variables_reshards_every_cached_width():
    backend = LmBackend("lm_wide", prompt_len=PROMPT_LEN, device="cpu", devices=["cpu"] * 4)
    prompts = [f"q{i}" for i in range(8)]
    before = {w: backend._program(w).run(sl.encode_prompts(prompts, PROMPT_LEN, 2048))
              for w in (1, 4)}
    tree = jax_seed0_tree()
    backend.load_variables(tree)
    fresh = sl.ShardedProgram("lm_wide", make_mesh({"dp": 1}, device="cpu"))
    fresh.load_variables(tree)
    want = fresh.run(sl.encode_prompts(prompts, PROMPT_LEN, 2048))
    for width, prog in backend._programs.items():
        got = prog.run(sl.encode_prompts(prompts, PROMPT_LEN, 2048))
        assert (got == want).all() and not (got == before[width]).all(), width
        query = prog.variables["block0.attn.query.weight"]
        np.testing.assert_array_equal(sl.gather_leaf(query),
                                      tree["params"]["block0"]["attn"]["query"]["kernel"].T)
    assert backend._programs[4].mesh.shape == {"dp": 1, "tp": 4}


# ---------------------------------------------------------------------------
# The cluster


@pytest.mark.parametrize("scheduler,members", [(PORT, PORT), (JAX, PORT), (PORT, JAX)],
                         ids=["port_over_port", "jax_over_port", "port_over_jax"])
def test_lm_wide_serves_through_cluster_gang_path(scheduler, members):
    """tests/test_sharding.py's acceptance case with the members and the
    scheduler each from the package named: truth labels from the members'
    own single-device program (each package seeds its own weights), so
    accuracy 1.0 is token identity through advisor gang formation, gang
    dispatch and per-rank sharded execution."""
    prompts = [f"p{i}" for i in range(12)]
    vocab = jax_get_model("lm_wide").num_outputs
    tokens = sl.encode_prompts(prompts, PROMPT_LEN, vocab)
    if members is PORT:
        truth = sl.ShardedProgram("lm_wide", make_mesh({"dp": 1}, device="cpu")).run(tokens)

        def backend():
            return LmBackend("lm_wide", prompt_len=PROMPT_LEN, hbm_budget_bytes=BUDGET,
                             device="cpu")
    else:
        truth = jsl.ShardedProgram(
            "lm_wide", jax_make_mesh({"dp": 1}, devices=jax.devices()[:1])).run(tokens)

        def backend():
            return JaxLmBackend("lm_wide", prompt_len=PROMPT_LEN, hbm_budget_bytes=BUDGET)

    net = scheduler.rpc.SimRpcNetwork()
    names = ["m0", "m1", "m2", "m3"]
    for m in names:
        net.serve(m, members.worker.PredictWorker({"lm_wide": backend()}).methods())
    flight = scheduler.flight.FlightRecorder(clock=net.clock)
    profiler = scheduler.profile.CostProfiler(window_s=5.0, windows=8, decay=0.5,
                                              clock=net.clock)
    for m in names:
        profiler.record("lm_wide", m, "dispatch", 0.1, count=8)
    advisor = scheduler.placement.PlacementAdvisor(
        profiler, flight=flight, clock=net.clock,
        headroom=lambda m: float(BUDGET),
        model_bytes=lambda job: float(get_lm_wide_bytes()),
    )
    sched = scheduler.jobs.JobScheduler(
        net.client("L"), lambda: list(names),
        jobs={"lm_wide": list(zip(prompts, (int(t) for t in truth)))},
        shard_size=4, shard_timeout_s=30.0, timer=net.clock, hedge_tail=False,
        flight=flight, profiler=profiler, advisor=advisor,
    )
    sched.is_leading = True
    sched._start({})
    job = sched.jobs["lm_wide"]
    assert job.gang_world == 3, job.report()
    assert len(job.assigned) == 3

    deadline = net.now + 120.0
    while not job.done and net.now < deadline:
        sched.assign_once()
        if sched.dispatch_all_once() == 0:
            net.advance(0.05)
    assert job.done, job.report()
    assert job.correct == len(prompts)
    assert job.accuracy == 1.0
    assert any(m == "job.predict_gang" for _, m in net.calls)
    assert all(m != "job.predict" for _, m in net.calls)


# ---------------------------------------------------------------------------
# EngineBackend.predict_gang and run_batch_global


def tiny_engine(batch_size: int = 16) -> InferenceEngine:
    return InferenceEngine("tinynet", device="cpu", variables=tiny_variables(0),
                           dtype=torch.float32, batch_size=batch_size)


def test_run_batch_global_equals_run_batch_at_world_one():
    eng = tiny_engine()
    batch = np.random.RandomState(1).randint(0, 255, (16, SIZE, SIZE, 3)).astype(np.uint8)
    ref = eng.run_batch(batch)
    got = eng.run_batch_global(batch)
    np.testing.assert_array_equal(got.top1_index, ref.top1_index)
    np.testing.assert_allclose(got.top1_prob, ref.top1_prob, rtol=1e-6)
    got5 = eng.run_batch_global(batch[:5])
    np.testing.assert_array_equal(got5.top1_index, ref.top1_index[:5])
    empty = eng.run_batch_global(batch[:0])  # an empty shard still runs
    assert empty.top1_index.shape == (0,) and empty.top1_prob.shape == (0,)
    with pytest.raises(ValueError, match="exceeds per-process share 16"):
        eng.run_batch_global(np.concatenate([batch, batch[:1]]))


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path[:0] = [{tests!r}, {repo!r}]
from test_torch_engine import SIZE, tiny_variables
from dmlc_tpu_torch.parallel.inference import InferenceEngine

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
eng = InferenceEngine("tinynet", device="cpu", variables=tiny_variables(0),
                      dtype=torch.float32, batch_size=16)
batch = np.random.RandomState(1).randint(0, 255, (16, SIZE, SIZE, 3)).astype(np.uint8)
first = eng.run_batch_global(batch[:8] if rank == 0 else batch[8:13])
second = eng.run_batch_global(batch[8:16] if rank == 0 else batch[:0])
np.savez(out, idx=first.top1_index, prob=first.top1_prob, idx2=second.top1_index)
dist.destroy_process_group()
"""


def test_run_batch_global_two_process_gloo(tmp_path):
    """Rank 0 sends 8 rows and rank 1 five, then rank 0 eight more and rank 1
    an empty shard, which still runs and enters the barrier; each rank's
    rows come back as run_batch gives them."""
    script = _RANK.format(tests=str(REPO / "tests"), repo=str(REPO))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(rank), str(tmp_path / "store"),
                               str(tmp_path / f"rank{rank}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=50)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    batch = np.random.RandomState(1).randint(0, 255, (16, SIZE, SIZE, 3)).astype(np.uint8)
    ref = tiny_engine().run_batch(batch)
    r0, r1 = (np.load(tmp_path / f"rank{rank}.npz") for rank in range(2))
    np.testing.assert_array_equal(r0["idx"], ref.top1_index[:8])
    np.testing.assert_array_equal(r1["idx"], ref.top1_index[8:13])
    np.testing.assert_allclose(r0["prob"], ref.top1_prob[:8], rtol=1e-5)
    np.testing.assert_allclose(r1["prob"], ref.top1_prob[8:13], rtol=1e-5)
    np.testing.assert_array_equal(r0["idx2"], ref.top1_index[8:16])
    assert r1["idx2"].shape == (0,)


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    data_dir, synset_path = corpus.generate(tmp_path_factory.mktemp("gang"), n_classes=6,
                                            size=SIZE)
    return data_dir, [line.split()[0] for line in synset_path.read_text().splitlines()]


def test_engine_backend_predict_gang(tiny_corpus):
    """One process without a group is rank 0 of 1: its gang slice answers as
    the solo path does, from a staged decode when one was made; a rank the
    process group does not have fails with the rank-mismatch error after
    the batch ran, and an over-cap slice with the cap error."""
    data_dir, synsets = tiny_corpus
    backend = EngineBackend("tinynet", data_dir, batch_size=8, device="cpu",
                            variables=tiny_variables(0), dtype=torch.float32)
    solo = backend(synsets)
    assert backend.predict_gang(synsets, 0, 1) == solo
    assert backend.decode_gang(synsets, 0, 1) is True
    assert backend.predict_gang(synsets, 0, 1) == solo and backend.stage_hits == 1
    runs = backend.engine.latency_summary()["count"]
    with pytest.raises(RpcError, match="gang rank mismatch: scheduler says 1"):
        backend.predict_gang(synsets, 1, 2)
    assert backend.engine.latency_summary()["count"] == runs + 1  # entered, then raised
    with pytest.raises(RpcError, match="exceeds per-process batch cap 8"):
        backend.predict_gang(synsets * 2, 0, 1)
    # The verb: a rank's slice over RPC, and decode_gang staging.
    methods = PredictWorker({"tinynet": backend}).methods()
    assert methods["job.decode_gang"]({"model": "tinynet", "synsets": synsets, "rank": 0,
                                       "world": 1}) == {"staged": True}
    got = methods["job.predict_gang"]({"model": "tinynet", "synsets": synsets, "rank": 0,
                                       "world": 1})
    assert got == {"predictions": solo}
