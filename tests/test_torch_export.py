"""The port's torch.export serving programs (dmlc_tpu_torch/models/export.py)
against the JAX package's StableHLO export, on the CPU.

The same numpy variables (tiny_variables, carried to the port by
models/convert.py) and the same uint8 batch go through the JAX exported
program (``exported.call``) and through the port's program after a
``torch.export.save``/``load`` round trip. Both are exported at float32, so
the top-1 must be equal and the probabilities and embeddings agree to
float32 summation order (PROB_RTOL, EMBED_ATOL). Then: the graph takes every
weight as an input; the two packages refuse each other's blobs; the SDFS
publish/fetch path; ExportedBackend through PredictWorker with a hot-swap
and an artifact batch smaller than the shard; the gang's sharded program at
plan_axes(2) against the unsharded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import BATCH, SIZE, tiny_variables  # registers the port's tinynet
from tiny_model import N_CLASSES  # registers the JAX tinynet and tinyembed
from torch import nn

from dmlc_tpu.models import export as jax_export
from dmlc_tpu_torch.cluster.rpc import RpcError, RpcUnreachable, SimRpcNetwork
from dmlc_tpu_torch.cluster.sdfs import MemberStore, SdfsClient, SdfsLeader, SdfsMember
from dmlc_tpu_torch.models import export as export_lib
from dmlc_tpu_torch.models import registry as t_registry
from dmlc_tpu_torch.models import weights as weights_lib
from dmlc_tpu_torch.models.convert import dense_weight, state_dict_to_jax
from dmlc_tpu_torch.models.layers import Conv2d, Linear, batch_norm
from dmlc_tpu_torch.scheduler.worker import ExportedBackend, PredictWorker
from dmlc_tpu_torch.utils import corpus

PROB_RTOL = 1e-5
EMBED_ATOL = 1e-5
EMBED_DIM = 16


class TorchTinyEmbed(nn.Module):
    """Counterpart of tests/tiny_model.TinyEmbed: global mean -> dense."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.proj = Linear(3, EMBED_DIM, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.to(self.dtype).mean(dim=(1, 2))).to(torch.float32)


class TorchTinyBn(nn.Module):
    """A port-only classifier with BatchNorm: its running statistics must
    be program inputs like every other weight."""

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(3, 4, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn = batch_norm(4)
        self.head = Linear(4, num_classes, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2).to(self.dtype))))
        return self.head(y.mean(dim=(2, 3))).to(torch.float32)


def _embed_from_jax(variables):
    p = variables["params"]["proj"]
    return {"proj.weight": dense_weight(p["kernel"]),
            "proj.bias": torch.from_numpy(np.asarray(p["bias"], np.float32))}


def _embed_to_jax(sd):
    return state_dict_to_jax(sd, lambda module: ((module,), "dense"))


if "tinyembed" not in t_registry.list_models():
    t_registry.register(t_registry.ModelSpec(
        "tinyembed", TorchTinyEmbed, SIZE, EMBED_DIM, classifier=False,
        from_jax=_embed_from_jax, to_jax=_embed_to_jax))


def embed_variables(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"proj": {
        "kernel": rng.normal(size=(3, EMBED_DIM)).astype(np.float32),
        "bias": (0.1 * rng.normal(size=EMBED_DIM)).astype(np.float32)}}}


def varied_pixels(seed: int, n: int = BATCH) -> np.ndarray:
    """uint8 images, each around a colour of its own, so a random tinynet
    answers several classes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 1, 1, 3))
    noise = rng.integers(-24, 25, (n, SIZE, SIZE, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def forcing_variables(cls: int) -> dict:
    """tinynet weights that answer ``cls`` for every image."""
    v = tiny_variables(0)
    v = jax.tree_util.tree_map(np.zeros_like, v)
    v["params"]["head"]["bias"][cls] = 9.0
    return v


@pytest.fixture(scope="module")
def tinynet_blob():
    return export_lib.export_serving("tinynet", batch_size=BATCH, dtype=torch.float32,
                                     device="cpu")


@pytest.fixture(scope="module")
def tinynet_blob_bf16():
    return export_lib.export_serving("tinynet", batch_size=BATCH, device="cpu")


@pytest.fixture
def sdfs(tmp_path):
    """A two-member port SDFS in process (rf 2); the client on m0."""
    net = SimRpcNetwork()
    stores, live = {}, ["m0", "m1"]
    for m in live:
        stores[m] = MemberStore(tmp_path / m)
        net.serve(m, SdfsMember(stores[m], net.client(m)).methods())
    net.serve("L", SdfsLeader(net.client("L"), lambda: list(live),
                              replication_factor=2).methods())
    return SdfsClient(net.client("m0"), "L", stores["m0"], "m0")


@pytest.mark.parametrize("model,variables", [("tinynet", tiny_variables(3)),
                                             ("tinyembed", embed_variables(4))])
def test_export_matches_jax_export(model, variables):
    """The same variables and uint8 batch through the JAX exported program
    and the port's program after save/load."""
    jblob = jax_export.export_serving(model, batch_size=BATCH, dtype=jnp.float32)
    _, jexp = jax_export.load_serving(jblob)
    name, exp = export_lib.load_serving(
        export_lib.export_serving(model, batch_size=BATCH, dtype=torch.float32, device="cpu"),
        expect_model=model)
    assert name == model and exp.batch == BATCH and exp.input_size == SIZE
    u8 = varied_pixels(7)
    want = jexp.call(jax.tree_util.tree_map(jnp.asarray, variables), u8)
    server = export_lib.ExportedServer(exp, variables)
    got = server(u8)
    if model == "tinynet":
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=PROB_RTOL)
        assert len(set(got[0].tolist())) > 1  # the check sees several classes
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=EMBED_ATOL)
        assert got.shape == (BATCH, EMBED_DIM)


def test_export_matches_the_engine(tinynet_blob):
    """The loaded program computes what the port's InferenceEngine computes
    (its kernels' plain versions on the CPU) for the same weights."""
    from dmlc_tpu_torch.parallel.inference import InferenceEngine

    variables = tiny_variables(11)
    engine = InferenceEngine("tinynet", device="cpu", batch_size=BATCH, dtype=torch.float32,
                             variables=variables)
    _, exp = export_lib.load_serving(tinynet_blob)
    u8 = varied_pixels(0)
    want = engine.run_batch(u8)
    idx, top = export_lib.ExportedServer(exp, variables)(u8)
    np.testing.assert_array_equal(idx, want.top1_index)
    np.testing.assert_allclose(top, want.top1_prob, rtol=PROB_RTOL)


@pytest.fixture
def tinybn(monkeypatch):
    """A port-only model with BatchNorm, registered for one test (the JAX
    registry has no counterpart, and test_torch_models holds the two
    registries equal)."""
    monkeypatch.setitem(t_registry._REGISTRY, "tinybn_export",
                        t_registry.ModelSpec("tinybn_export", TorchTinyBn, 16, 10))


@pytest.mark.parametrize("model", ["tinynet", "tinyembed", "tinybn_export"])
def test_every_weight_is_a_user_input(model, tinybn):
    """No parameter, buffer or constant is lifted into the graph: BatchNorm's
    running statistics are inputs too, and the artifact holds no weights."""
    from torch.export.graph_signature import InputKind

    ep = export_lib.export_program(model, batch_size=2, device="cpu")
    kinds = {s.kind for s in ep.graph_signature.input_specs}
    assert kinds == {InputKind.USER_INPUT}
    prog = export_lib.build_serving_forward(model)
    assert not list(prog.parameters()) and not list(prog.buffers())
    names = [s.arg.name for s in ep.graph_signature.input_specs]
    assert len(names) == len(prog.weight_avals) + 1 and names[-1] == "u8"
    if model == "tinybn_export":
        assert {"bn.running_mean", "bn.running_var"} <= set(prog.weight_avals)
        assert "bn.num_batches_tracked" not in prog.weight_avals


def test_blob_is_small_and_records_its_avals(tinynet_blob, tinynet_blob_bf16):
    _, exp = export_lib.load_serving(tinynet_blob_bf16)
    assert exp.header["dtype"] == "bfloat16" and exp.device == torch.device("cpu")
    assert exp.weight_avals["head.weight"] == ((N_CLASSES, 8), torch.float32)
    assert len(tinynet_blob) < 200_000  # no example weights saved with it
    text = export_lib.program_text(tinynet_blob)
    assert "def forward" in text and "weights_head_weight" in text


def test_validation_errors(tinynet_blob):
    """Each package refuses the other's blob, a program for another model,
    and one exported for another device."""
    jblob = jax_export.export_serving("tinynet", batch_size=BATCH)
    with pytest.raises(ValueError, match="magic"):
        export_lib.load_serving(jblob)
    with pytest.raises(ValueError, match="magic"):
        jax_export.load_serving(tinynet_blob)
    with pytest.raises(ValueError, match="magic"):
        export_lib.load_serving(b"junk" + tinynet_blob)
    with pytest.raises(ValueError, match="expected"):
        export_lib.load_serving(tinynet_blob, expect_model="resnet18")
    for device in ("cuda:0", "cuda"):
        with pytest.raises(ValueError, match="exported for cpu"):
            export_lib.load_serving(tinynet_blob, device=device)
    assert export_lib.load_serving(tinynet_blob, device=torch.device("cpu"))[0] == "tinynet"
    assert export_lib.sdfs_executable_name("tinynet") != jax_export.sdfs_executable_name("tinynet")
    assert export_lib.MAGIC != jax_export.MAGIC
    assert export_lib.SHARDED_MAGIC != jax_export.SHARDED_MAGIC
    _, exp = export_lib.load_serving(tinynet_blob)
    bad = tiny_variables(0)
    bad["params"]["head"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        exp.weights(bad)


def test_executable_through_sdfs_and_served(tinynet_blob_bf16, sdfs):
    """Publish the executable into the replicated store, pull it back and
    answer a ragged batch through ExportedServer with weights that force a
    known prediction, all without touching the model class."""
    assert sdfs.put_bytes(tinynet_blob_bf16, export_lib.sdfs_executable_name("tinynet"))[
        "version"] == 1
    version, exp = export_lib.fetch_executable(sdfs, "tinynet", device="cpu")
    assert version == 1
    server = export_lib.ExportedServer(exp, forcing_variables(5))
    idx, top = server(np.random.default_rng(1).integers(0, 256, (5, SIZE, SIZE, 3), np.uint8))
    assert idx.shape == (5,) and list(idx) == [5] * 5
    assert np.all(top > 1.0 / N_CLASSES)


def test_exported_backend_serves_shards_from_sdfs(tinynet_blob_bf16, sdfs, tmp_path):
    """A member backend answers job.predict shards with ONLY the SDFS
    artifact and weights blobs, the `train` hot-swap changes its answers,
    and a batch-2 artifact chunks a 6-query shard."""
    sdfs.put_bytes(tinynet_blob_bf16, export_lib.sdfs_executable_name("tinynet"))
    variables = forcing_variables(5)
    weights_lib.publish_weights(sdfs, "tinynet", variables)
    data_dir, _ = corpus.generate(tmp_path / "corpus", n_classes=3, images_per_class=1, size=32)

    backend = ExportedBackend("tinynet", data_dir, sdfs, device="cpu")
    worker = PredictWorker({"tinynet": backend})
    reply = worker._predict({"model": "tinynet",
                             "synsets": ["n00000000", "n00000001", "n00000002"]})
    assert reply["predictions"] == [5, 5, 5]

    variables["params"]["head"]["bias"][5] = 0.0
    variables["params"]["head"]["bias"][2] = 9.0
    backend.load_variables(variables)
    assert worker._predict({"model": "tinynet", "synsets": ["n00000001"]})["predictions"] == [2]

    sdfs.put_bytes(export_lib.export_serving("tinynet", batch_size=2, device="cpu"),
                   export_lib.sdfs_executable_name("tinynet"))
    small = ExportedBackend("tinynet", data_dir, sdfs, device="cpu")
    assert small([]) == []  # empty shard: no decode, no crash
    preds = small(["n00000000", "n00000001", "n00000002"] * 2)  # 6 queries, 3 chunks
    assert small._serve_batch == 2  # the ARTIFACT's batch, not node config
    assert preds == [5] * 6  # the v2 artifact with the v1 weights


class _Store:
    """An SDFS stand-in: the executable blob, and ``weights`` as given (a
    blob, or an exception to raise)."""

    def __init__(self, blob, weights):
        self.blob, self.weights = blob, weights

    def get_bytes(self, name, version=None):
        if name == export_lib.sdfs_executable_name("tinynet"):
            return 1, self.blob
        if isinstance(self.weights, Exception):
            raise self.weights
        return 1, self.weights


def test_exported_backend_weight_consent(tinynet_blob_bf16, tmp_path):
    """Random init only when the weights were never published; a transient
    failure or any other refusal propagates."""
    data_dir, _ = corpus.generate(tmp_path / "corpus", n_classes=2, images_per_class=1, size=32)
    fresh = ExportedBackend("tinynet", data_dir,
                            _Store(tinynet_blob_bf16, RpcError("models/tinynet not in SDFS")),
                            device="cpu")
    fresh.warmup()
    init = t_registry.get_model("tinynet").init_params(0, dtype=torch.float32).state_dict()
    for key, t in fresh._server.weights.items():
        torch.testing.assert_close(t, init[key], rtol=0, atol=0)
    for err in (RpcUnreachable("leader down"), RpcError("integrity: bad chunk")):
        backend = ExportedBackend("tinynet", data_dir, _Store(tinynet_blob_bf16, err),
                                  device="cpu")
        with pytest.raises(type(err)):
            backend(["n00000000"])
        assert backend._server is None


def test_exported_backend_embedder_answers_zeros(sdfs, tmp_path):
    sdfs.put_bytes(export_lib.export_serving("tinyembed", batch_size=2, device="cpu"),
                   export_lib.sdfs_executable_name("tinyembed"))
    weights_lib.publish_weights(sdfs, "tinyembed", embed_variables(1))
    data_dir, _ = corpus.generate(tmp_path / "corpus", n_classes=3, images_per_class=1, size=32)
    backend = ExportedBackend("tinyembed", data_dir, sdfs, device="cpu")
    assert backend(["n00000000", "n00000001", "n00000002"]) == [0, 0, 0]


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ExportedBackend("tinynet", tmp_path, None),
                 lambda: export_lib.export_serving("tinynet", batch_size=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_sharded_export_round_trips():
    """The gang's program for lm_wide at plan_axes(2) gives the unsharded
    program's token ids; a mesh of another shape or device list is
    refused."""
    from dmlc_tpu_torch.parallel import sharding as sl
    from dmlc_tpu_torch.parallel.mesh import make_mesh

    spec = t_registry.get_model("lm_wide")
    toks = np.random.default_rng(0).integers(0, spec.num_outputs, (8, 16)).astype(np.int32)
    want = sl.ShardedProgram("lm_wide", make_mesh({"dp": 1}, devices=["cpu"])).run(toks)
    axes = sl.plan_axes(2, num_heads=spec.num_heads)
    mesh = make_mesh(axes, devices=["cpu", "cpu"])
    blob = export_lib.export_sharded_serving("lm_wide", mesh, batch_size=len(toks),
                                             seq_len=toks.shape[1])
    with pytest.raises(ValueError, match="magic"):
        export_lib.load_serving(blob)
    name, mesh_axes, exp = export_lib.load_sharded_serving(blob, expect_model="lm_wide")
    assert name == "lm_wide" and mesh_axes == dict(axes) and exp.devices == ["cpu", "cpu"]
    fresh = make_mesh(mesh_axes, devices=exp.devices)
    exp.check_mesh(fresh)
    prog = sl.ShardedProgram("lm_wide", fresh)
    got = exp.call(prog.variables, toks).numpy()
    assert (got == want).all()
    wider = sl.ShardedProgram("lm_wide", make_mesh({"dp": 1}, devices=["cpu"]))
    with pytest.raises(ValueError, match="runs on mesh"):
        exp.call(wider.variables, toks)
    with pytest.raises(ValueError, match="runs on mesh"):
        exp.check_mesh(make_mesh({"dp": 2}, devices=["cpu", "cpu"]))


def test_cli_export_publishes_the_program(sdfs):
    """The `export` verb publishes the port's program under its own SDFS
    name, exported on the node's device at the node's batch."""
    from dmlc_tpu_torch.cli import WAITING, Cli

    class StubNode:
        device = "cpu"

        class config:
            batch_size = 4

    StubNode.sdfs = sdfs
    assert WAITING == {}
    out = Cli(StubNode()).run_command("export tinynet")
    assert out == "exported tinynet -> executables/tinynet.pt2 v1"
    _, exp = export_lib.fetch_executable(sdfs, "tinynet", device="cpu")
    assert exp.batch == 4
    assert "usage:" in Cli(StubNode()).run_command("export")
