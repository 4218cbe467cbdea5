"""The port's ViT and CLIP image encoders (models/vit.py, models/clip.py)
against the JAX package's, and their serving path.

Tiny configurations of the same classes (patch 8, image 32, hidden 64, 4
heads, 2 layers, MLP 128; 10 classes or a projection of 16; each family's
activation and LayerNorm eps) run the same numpy-seeded weights, carried
from the JAX tree by ``vit_from_jax``/``clip_from_jax``, on the same numpy
images:

- float32: logits and embeddings agree within ``F32_RTOL``/``F32_ATOL`` of
  their scale;
- bf16: top-1 agrees on every row whose float32 top-two logit gap exceeds
  ``BF16_GAP`` of the logits' scale, and embeddings have a row-wise cosine
  of at least ``BF16_COSINE``.

``vit_tiny`` and ``clip_tiny`` are registered in both packages' registries
for the engine, blob and template cases. Nothing here runs at full width
but shapes: the four registry entries' templates are built on the ``meta``
device, and the HF importers read zero-stride views.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from dmlc_tpu.models import registry as jax_registry
from dmlc_tpu.models import weights as jax_weights
from dmlc_tpu.models.clip import CLIPVisionEncoder as JaxCLIP
from dmlc_tpu.models.vit import ViT as JaxViT
from dmlc_tpu.parallel.inference import InferenceEngine as JaxEngine
from dmlc_tpu_torch.models import convert, registry, weights
from dmlc_tpu_torch.models.clip import CLIPVisionEncoder, clip_vit_b32, clip_vit_l14
from dmlc_tpu_torch.models.vit import ViT, quick_gelu, vit_b16, vit_l14
from dmlc_tpu_torch.parallel.inference import InferenceEngine
from dmlc_tpu_torch.scheduler.worker import EngineBackend, PredictWorker

# float32 on both sides; the products sum in another order (oneDNN vs XLA)
# through two blocks: outputs agree to 1e-4 of their scale.
F32_RTOL = 1e-4
F32_ATOL = 1e-4
# bf16 on both sides rounds the residual stream, the products and the
# probabilities at the same places but not always the same way: top-1 is
# compared on rows whose float32 top-two logit gap exceeds this share of
# the logits' largest magnitude, and embeddings must keep this cosine.
BF16_GAP = 0.05
BF16_COSINE = 0.999

IMAGE, PATCH, HIDDEN, HEADS, LAYERS, MLP = 32, 8, 64, 4, 2, 128
CLASSES, PROJECTION = 10, 16
BATCH = 8

TINY = {"patch_size": PATCH, "hidden_size": HIDDEN, "num_layers": LAYERS, "num_heads": HEADS,
        "mlp_dim": MLP}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def jax_vit(dtype=jnp.float32, num_classes=CLASSES, activation="gelu"):
    return JaxViT(num_classes=num_classes, dtype=dtype, activation=activation, **TINY)


def port_vit(dtype=torch.float32, num_classes=CLASSES, activation="gelu"):
    return ViT(num_classes=num_classes, dtype=dtype, activation=activation, image_size=IMAGE,
               **TINY)


def jax_clip(dtype=jnp.float32):
    return JaxCLIP(projection_dim=PROJECTION, dtype=dtype, **TINY)


def port_clip(dtype=torch.float32):
    return CLIPVisionEncoder(projection_dim=PROJECTION, dtype=dtype, image_size=IMAGE, **TINY)


if "vit_tiny" not in jax_registry.list_models():
    jax_registry.register(jax_registry.ModelSpec("vit_tiny", jax_vit, IMAGE, CLASSES))
    jax_registry.register(jax_registry.ModelSpec("clip_tiny", jax_clip, IMAGE, PROJECTION,
                                                 classifier=False))
if "vit_tiny" not in registry.list_models():
    registry.register(registry.ModelSpec("vit_tiny", port_vit, IMAGE, CLASSES,
                                         from_jax=convert.vit_from_jax,
                                         to_jax=convert.vit_to_jax))
    registry.register(registry.ModelSpec("clip_tiny", port_clip, IMAGE, PROJECTION,
                                         classifier=False, from_jax=convert.clip_from_jax,
                                         to_jax=convert.clip_to_jax))

FAMILIES = {"vit": (jax_vit, port_vit, convert.vit_from_jax, convert.vit_to_jax),
            "clip": (jax_clip, port_clip, convert.clip_from_jax, convert.clip_to_jax)}


def seeded(template, seed: int) -> dict:
    """A numpy draw for every leaf of a flax variables tree: kernels and
    tokens ~ N(0, 1/fan_in), biases 0.1 N(0, 1), LayerNorm scales in [0.5,
    1.5] (the JAX init zeroes ViT's class token and sets every scale to 1,
    which would test less)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = tuple(leaf.shape)
        if name.endswith("['bias']"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


def jax_template(module):
    x = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, train=False))


def images(seed: int, n: int = BATCH) -> np.ndarray:
    """Normalized-image-like inputs whose per-image brightness and contrast
    differ, so that images differ by more than their noise."""
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.3, 2.0, (n, 1, 1, 3))
    shift = rng.uniform(-1.5, 1.5, (n, 1, 1, 3))
    return (rng.normal(size=(n, IMAGE, IMAGE, 3)) * gain + shift).astype(np.float32)


def pair(family: str, dtype: torch.dtype, seed: int = 0, **kw):
    """The JAX module with seeded variables and the port module with the
    same weights carried over."""
    jax_build, port_build, from_jax, _ = FAMILIES[family]
    jmod = jax_build(JAX_DTYPES[dtype], **kw)
    variables = seeded(jax_template(jmod), seed)
    mod = port_build(dtype, **kw).eval()
    mod.load_state_dict(from_jax(variables))
    return jmod, variables, mod


def run_both(jmod, variables, mod, x):
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    return got, want


def cosines(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))


# ---------------------------------------------------------------------------
# The modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,activation", [("vit", "gelu"), ("vit", "quick_gelu"),
                                               ("clip", None)])
def test_float32_matches_jax(family, activation):
    kw = {} if activation is None else {"activation": activation}
    jmod, variables, mod = pair(family, torch.float32, seed=1, **kw)
    got, want = run_both(jmod, variables, mod, images(2))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == (BATCH, CLASSES if family == "vit" else PROJECTION)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL * np.abs(want).max())


def test_bf16_vit_top1_matches_jax_under_the_gap_rule():
    x = images(3, n=32)
    jmod, variables, mod = pair("vit", torch.bfloat16, seed=3)
    got, want = run_both(jmod, variables, mod, x)
    assert got.dtype == np.float32
    # The rows to compare: the float32 logits' top-two gap (the port's
    # float32 module, which test_float32_matches_jax holds to the JAX one's).
    f32 = port_vit().eval()
    f32.load_state_dict(convert.vit_from_jax(variables))
    with torch.no_grad():
        ref = f32(torch.from_numpy(x)).numpy()
    top2 = np.sort(ref, axis=-1)[:, -2:]
    mask = top2[:, 1] - top2[:, 0] > BF16_GAP * np.abs(ref).max()
    assert mask.sum() >= len(x) // 2, "too few rows clear the gap to test anything"
    np.testing.assert_array_equal(got.argmax(-1)[mask], want.argmax(-1)[mask])


def test_bf16_clip_embeddings_match_jax_within_the_cosine_bound():
    jmod, variables, mod = pair("clip", torch.bfloat16, seed=4)
    got, want = run_both(jmod, variables, mod, images(5, n=16))
    assert cosines(got, want).min() >= BF16_COSINE


def test_patch_tokens_keep_the_jax_reshape_order():
    # A single patch lit up: its token is the (h, w) row-major one, as the
    # JAX reshape of the NHWC conv output gives it.
    mod = port_vit()
    with torch.no_grad():
        for p in mod.parameters():
            p.zero_()
        mod.patch_embed.weight[:, 0] = 1.0  # every channel sums red
        x = torch.zeros(1, IMAGE, IMAGE, 3)
        x[0, 1 * PATCH, 2 * PATCH, 0] = 1.0  # patch (h=1, w=2)
        tokens = mod.tokens(x)[0, 1:, 0]
    grid = IMAGE // PATCH
    assert tokens.nonzero().flatten().tolist() == [1 * grid + 2]


def test_quick_gelu_is_x_sigmoid_1702x():
    x = torch.linspace(-4, 4, 17)
    torch.testing.assert_close(quick_gelu(x), x * torch.sigmoid(1.702 * x))


def test_init_params_draws_as_flax():
    torch.manual_seed(0)
    vit = registry.get_model("vit_tiny").init_params(7, dtype=torch.float32)
    clip = registry.get_model("clip_tiny").init_params(7, dtype=torch.float32)
    again = registry.get_model("vit_tiny").init_params(7, dtype=torch.float32)
    for a, b in zip(vit.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    vit.requires_grad_(False), clip.requires_grad_(False)
    assert not vit.cls_token.any() and clip.cls_token.std() > 0  # ViT zeros, CLIP N(0, 0.02²)
    for mod in (vit, clip):
        assert abs(float(mod.pos_embed.std()) - 0.02) < 0.005
        assert torch.equal(mod.block0.ln1.weight, torch.ones(HIDDEN))
        assert not mod.block0.ln1.bias.any() and not mod.block0.mlp_in.bias.any()
        assert abs(float(mod.block0.mlp_in.weight.std()) * HIDDEN**0.5 - 1) < 0.1
        fan_in = 3 * PATCH * PATCH
        assert abs(float(mod.patch_embed.weight.std()) * fan_in**0.5 - 1) < 0.1
    assert clip.patch_embed.bias is None and clip.projection.bias is None
    # bf16 compute over the same float32 parameters.
    half = registry.get_model("vit_tiny").init_params(7)
    assert half.block0.attn.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in half.parameters())


# ---------------------------------------------------------------------------
# Weight mappings, templates, importers
# ---------------------------------------------------------------------------


def assert_trees_equal(got, want):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        layout = ("data", "strides", "shape")
        if all(a.__array_interface__[k] == b.__array_interface__[k] for k in layout):
            continue  # one view of one buffer: the same values
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("family", ["vit", "clip"])
def test_to_jax_inverts_from_jax_bit_for_bit(family):
    jax_build, port_build, from_jax, to_jax = FAMILIES[family]
    template = jax_template(jax_build())
    variables = seeded(template, seed=11)
    assert_trees_equal(to_jax(from_jax(variables)), variables)
    # The meta-device template has the JAX tree's paths and shapes.
    with torch.device("meta"):
        meta = port_build().state_dict()
    shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), to_jax(meta))
    assert shapes == jax.tree_util.tree_map(lambda s: tuple(s.shape), template)


def test_to_jax_refuses_unknown_entries():
    with pytest.raises(KeyError, match="unexpected ViT/CLIP entry"):
        convert.vit_to_jax({"block0.attn.rope.weight": torch.zeros(1)})


@pytest.mark.parametrize("name,build,classes", [("vit_b16", vit_b16, 1000),
                                                ("vit_l14", vit_l14, 1000),
                                                ("clip_vit_l14", clip_vit_l14, 768),
                                                ("clip_vit_b32", clip_vit_b32, 512)])
def test_registry_entries(name, build, classes):
    spec, jspec = registry.get_model(name), jax_registry.get_model(name)
    assert (spec.input_size, spec.num_outputs, spec.classifier, spec.kind) == (
        224, classes, name.startswith("vit"), "image")
    assert spec.flops_per_item() == jspec.flops_per_item()
    assert spec.build is build
    if name == "vit_b16":  # tests/test_model_parity.py's canonical count
        assert spec.param_count() == 86_567_656
    with torch.device("meta"):
        module = spec.module(dtype=torch.float32)
    assert isinstance(module, ViT if name.startswith("vit") else CLIPVisionEncoder)


class FullWidthHF(dict):
    """A HuggingFace-layout state dict at a registry model's full width
    (hidden ``d``, MLP ``m``, patch ``p``, ``out`` classes or projection),
    each entry made on first reading: a seeded column broadcast over its
    other axes, so a transposed leaf differs from the straight one and no
    weights are allocated."""

    def __init__(self, d: int, m: int, p: int, out: int):
        super().__init__()
        self.d, self.m, self.p, self.out = d, m, p, out
        self.seq = 1 + (224 // p) ** 2

    def shape(self, key: str) -> tuple[int, ...]:
        d, m = self.d, self.m
        if "patch_embedding" in key and key.endswith("weight"):
            return (d, 3, self.p, self.p)
        if key.endswith("cls_token"):
            return (1, 1, d)
        if key.endswith("position_embeddings"):
            return (1, self.seq, d)
        if key.endswith("position_embedding.weight"):
            return (self.seq, d)
        weight = key.endswith("weight")
        if key.startswith(("classifier.", "visual_projection.")):
            return (self.out, d) if weight else (self.out,)
        if ".intermediate." in key or ".fc1." in key:
            return (m, d) if weight else (m,)
        if weight and (".fc2." in key or (
                ".output.dense." in key and ".attention." not in key)):
            return (d, m)
        if weight and "norm" not in key:
            return (d, d)
        return (d,)

    def __missing__(self, key):
        shape = self.shape(key)
        col = np.random.default_rng(len(self)).normal(size=shape[:1]).astype(np.float32)
        self[key] = np.broadcast_to(col.reshape(shape[:1] + (1,) * (len(shape) - 1)), shape)
        return self[key]


@pytest.mark.parametrize("name,hf", [("vit_b16", (768, 3072, 16, 1000)),
                                     ("clip_vit_l14", (1024, 4096, 14, 768))])
def test_import_external_equals_the_jax_package(name, hf):
    sd = FullWidthHF(*hf)
    got = weights.import_external(name, sd)  # validated against the port's template
    assert_trees_equal(got, jax_weights.import_external(name, sd))


@pytest.mark.parametrize("family", ["vit", "clip"])
def test_hf_checkpoint_through_the_port_matches_transformers(family, monkeypatch):
    # tests/test_model_parity.py's small configurations, carried HF -> the
    # JAX tree (the ported importers) -> the port's module. transformers'
    # image utilities import TensorFlow where it is installed, which the
    # torch models do not use: told it is absent, the first model import
    # takes half the time.
    monkeypatch.setattr(transformers.utils.import_utils, "_tf_available", False)
    kw = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, image_size=32, patch_size=8)
    torch.manual_seed(0)
    if family == "vit":
        cfg = transformers.ViTConfig(num_labels=10, **kw)
        hf = transformers.ViTForImageClassification(cfg).eval()
        variables = convert.vit_params_from_hf(
            {k: v.numpy() for k, v in hf.state_dict().items()}, 2)
        mod = ViT(num_classes=10, dtype=torch.float32, image_size=32,
                  layer_norm_eps=cfg.layer_norm_eps, **TINY)
        mod.load_state_dict(convert.vit_from_jax(variables))
    else:
        cfg = transformers.CLIPVisionConfig(projection_dim=32, **kw)
        hf = transformers.CLIPVisionModelWithProjection(cfg).eval()
        variables = convert.clip_params_from_hf(
            {k: v.numpy() for k, v in hf.state_dict().items()}, 2)
        mod = CLIPVisionEncoder(projection_dim=32, dtype=torch.float32, image_size=32,
                                layer_norm_eps=cfg.layer_norm_eps, **TINY)
        mod.load_state_dict(convert.clip_from_jax(variables))
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        out = hf(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2)))
        ref = (out.logits if family == "vit" else out.image_embeds).numpy()
        got = mod.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The serving path: engines, blobs, job.predict
# ---------------------------------------------------------------------------


def pixels(seed: int, n: int = BATCH) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, IMAGE, IMAGE, 3), np.uint8)


@functools.lru_cache(maxsize=None)
def jax_engine_of(name: str, seed: int) -> JaxEngine:
    """One compiled JAX engine a model and seed for the whole module."""
    variables = seeded(jax_weights.variables_template(name), seed)
    return JaxEngine(name, batch_size=BATCH, dtype=jnp.float32, use_pallas=True,
                     variables=jax.tree_util.tree_map(jnp.asarray, variables))


def engines(name: str, seed: int):
    """The JAX engine and a port engine with the same seeded weights."""
    variables = seeded(jax_weights.variables_template(name), seed)
    jax_engine = jax_engine_of(name, seed)
    engine = InferenceEngine(name, device="cpu", batch_size=BATCH, dtype=torch.float32,
                             variables=variables)
    return jax_engine, engine


@pytest.mark.parametrize("n", [BATCH, 5], ids=["full", "padded"])
def test_engine_serves_an_embedding_model_as_the_jax_engine(n):
    jax_engine, engine = engines("clip_tiny", 21)
    batch = pixels(22, n)
    got, want = engine.run_batch(batch), jax_engine.run_batch(batch)
    for field in ("top1_index", "top1_prob"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape == (n,) and not a.any()
    assert got.embeddings.dtype == np.float32 and got.embeddings.shape == (n, PROJECTION)
    scale = np.abs(want.embeddings).max()
    np.testing.assert_allclose(got.embeddings, want.embeddings, rtol=F32_RTOL,
                               atol=F32_ATOL * scale)
    # The stream pipeline: three batches, the last padded.
    paths = [f"img_{i}" for i in range(2 * BATCH + 3)]

    def source(chunk, size):
        return np.concatenate([pixels(int(p.split("_")[1]), 1) for p in chunk])

    stream = engine.run_paths_stream(paths, decode_source=source)
    jstream = jax_engine.run_paths_stream(paths, decode_source=source)
    assert stream.embeddings.shape == (len(paths), PROJECTION) and not stream.top1_index.any()
    np.testing.assert_allclose(stream.embeddings, jstream.embeddings, rtol=F32_RTOL,
                               atol=F32_ATOL * scale)


def test_job_predict_on_an_embedding_model_answers_zeros(tmp_path):
    variables = seeded(jax_weights.variables_template("clip_tiny"), seed=23)
    backend = EngineBackend("clip_tiny", tmp_path, batch_size=BATCH, device="cpu",
                            dtype=torch.float32, variables=variables,
                            image_source=lambda synsets: list(synsets))
    backend.warmup()
    seen = []
    backend.engine.device_work = lambda model, n, dt: seen.append((model, n))
    engine = backend.engine
    engine.run_paths = lambda paths: engine.run_batch(
        np.concatenate([pixels(int(p.split("_")[1]), 1) for p in paths]))
    predict = PredictWorker({"clip_tiny": backend}).methods()["job.predict"]
    assert predict({"model": "clip_tiny", "synsets": ["s_1", "s_2", "s_3"]}) == {
        "predictions": [0, 0, 0]}
    assert seen == [("clip_tiny", 3)]
    assert engine.resident_bytes() == 4 * registry.get_model("clip_tiny").param_count()


def test_jax_blob_of_a_vit_loads_into_the_port_with_equal_top1():
    variables = seeded(jax_weights.variables_template("vit_tiny"), seed=31)
    blob = jax_weights.weights_to_bytes("vit_tiny", jax.tree_util.tree_map(jnp.asarray, variables))
    name, loaded = weights.weights_from_bytes(blob, expect_model="vit_tiny")
    assert name == "vit_tiny"
    # The port writes the same bytes for the same tree.
    assert weights.weights_to_bytes("vit_tiny", loaded) == blob
    jax_engine = jax_engine_of("vit_tiny", 31)
    engine = InferenceEngine("vit_tiny", device="cpu", batch_size=BATCH, dtype=torch.float32,
                             seed=5)
    engine.load_variables(loaded)
    batch = pixels(32)
    got, want = engine.run_batch(batch), jax_engine.run_batch(batch)
    np.testing.assert_array_equal(got.top1_index, want.top1_index)
    np.testing.assert_allclose(got.top1_prob, want.top1_prob, rtol=1e-4)
    assert got.embeddings is None
    # A tree of the wrong width is refused with the JAX package's text.
    bad = seeded(jax_template(jax_vit(num_classes=CLASSES + 1)), seed=0)
    with pytest.raises(ValueError, match="shape mismatch for 'vit_tiny'"):
        weights.weights_to_bytes("vit_tiny", bad)
