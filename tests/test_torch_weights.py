"""The port's weights blob (models/weights.py) and weight mappings
(models/convert.py, models/registry.py) against the JAX package's.

- For the same variables, the port's blob equals the JAX package's byte
  for byte (tinynet, resnet18, lm_small; JAX-seeded and port-seeded), also
  in flax's chunked form and with bfloat16 leaves.
- A JAX blob loads into the port and a port blob into the JAX package;
  engines on either side of the load give the same top-1 (tinynet,
  resnet18) and greedy tokens (lm_small).
- Validation errors carry the JAX package's messages.
- variables_template, param_count and param_bytes equal the JAX package's
  for every registry model of the port; to_jax(from_jax(v)) == v bit for bit.
- The four external importers equal the JAX package's.
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from test_torch_engine import (  # registers tinynet
    BATCH,
    PROB_RTOL,
    seeded_pixels,
    tiny_variables,
)

from dmlc_tpu.generate.engine import GenerationEngine as JaxGenerationEngine
from dmlc_tpu.models import convert as jax_convert
from dmlc_tpu.models import registry as jax_registry
from dmlc_tpu.models import weights as jax_weights
from dmlc_tpu.parallel.inference import InferenceEngine as JaxEngine
from dmlc_tpu_torch.generate.engine import GenerationEngine
from dmlc_tpu_torch.models import convert
from dmlc_tpu_torch.models import registry
from dmlc_tpu_torch.models import weights
from dmlc_tpu_torch.parallel.inference import InferenceEngine

REPO = Path(__file__).resolve().parent.parent
PORT_MODELS = ["alexnet", "lm_small", "lm_wide", "resnet18", "resnet34", "resnet50"]
BLOB_MODELS = ["tinynet", "resnet18", "lm_small"]
#: The resnet18 parity batch: 224 px images, one for each of the JAX
#: engine's 8 virtual CPU devices.
RESNET_BATCH = 8


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_seeded(name: str, seed: int = 0) -> dict:
    """The JAX package's own init of a registry model, float32 numpy leaves."""
    if name == "tinynet":
        return tiny_variables(seed)
    _, v = jax_registry.get_model(name).init_params(jax.random.PRNGKey(seed), dtype=jnp.float32)
    return as_numpy(v)


def port_seeded(name: str, seed: int = 0) -> dict:
    """The port's seeded module, carried to the JAX tree by its to_jax."""
    spec = registry.get_model(name)
    if name == "tinynet":
        module = spec.module(dtype=torch.float32)
        module.load_state_dict(spec.from_jax(tiny_variables(seed + 7)))
    else:
        module = spec.init_params(seed, dtype=torch.float32)
    return spec.to_jax(module.state_dict())


def random_like_template(name: str, seed: int) -> dict:
    """Seeded float32 numpy leaves in the shape of the JAX package's template."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        jax_weights.variables_template(name))


def assert_trees_equal(got, want):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a = a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b, np.float32) if np.asarray(b).dtype == jnp.bfloat16 else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# The blob's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seeded", [jax_seeded, port_seeded], ids=["jax_init", "port_init"])
@pytest.mark.parametrize("name", BLOB_MODELS)
def test_blob_is_the_jax_blob_byte_for_byte(name, seeded):
    variables = seeded(name)
    blob = weights.weights_to_bytes(name, variables)
    assert blob == jax_weights.weights_to_bytes(name, variables)
    # Leaves handed over as torch tensors or in another dict order: the
    # same bytes.
    shuffled = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), variables)
    shuffled = {k: shuffled[k] for k in sorted(shuffled, reverse=True)}
    assert weights.weights_to_bytes(name, shuffled) == blob
    assert blob.startswith(weights.MAGIC + len(name).to_bytes(2, "big") + name.encode())


def test_chunked_blob_loads_and_is_written_alike(monkeypatch):
    variables = tiny_variables(4)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 96)
    chunked = jax_weights.weights_to_bytes("tinynet", variables)
    assert b"__msgpack_chunked_array__" in chunked
    name, got = weights.weights_from_bytes(chunked, expect_model="tinynet")
    assert name == "tinynet"
    assert_trees_equal(got, variables)
    monkeypatch.setattr(weights, "MAX_CHUNK_SIZE", 96)
    assert weights.weights_to_bytes("tinynet", variables) == chunked


def test_bfloat16_leaves_cross_both_ways():
    """numpy has no bfloat16: the port reads flax's bfloat16 arrays as
    bfloat16 tensors, and writes them back as the same bytes."""
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tiny_variables(5))
    blob = jax_weights.weights_to_bytes("tinynet", variables)
    _, got = weights.weights_from_bytes(blob)
    leaf = got["params"]["conv1"]["kernel"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    assert_trees_equal(got, variables)
    assert weights.weights_to_bytes("tinynet", got) == blob
    # And to a module's layout: bfloat16 values carried to float32 weights.
    np.testing.assert_array_equal(
        convert.dense_weight(got["params"]["head"]["kernel"]).numpy(),
        np.asarray(variables["params"]["head"]["kernel"], np.float32).T)


def test_msgpack_matches_flax_on_scalars_and_complex():
    tree = {"b": {"s": np.float32(2.5), "i": np.int64(-3), "c": 1.5 - 2.0j},
            "a": np.arange(6, dtype=np.int16).reshape(2, 3), "z": None, "f": 0.25,
            "u": np.zeros((0, 4), np.uint8), "l": [np.float64(1.0), 2]}
    blob = flax.serialization.msgpack_serialize(tree)
    assert weights.msgpack_serialize(tree) == blob
    got = weights.msgpack_restore(blob)
    want = flax.serialization.msgpack_restore(blob)
    assert got.keys() == want.keys() and got["z"] is None and got["f"] == 0.25
    assert got["b"]["c"] == want["b"]["c"] == 1.5 - 2.0j
    assert type(got["b"]["s"]) is type(want["b"]["s"]) and got["b"]["s"] == want["b"]["s"]
    assert got["b"]["i"] == want["b"]["i"] and got["l"] == want["l"]
    np.testing.assert_array_equal(got["a"], want["a"])
    assert got["u"].shape == (0, 4) and got["u"].dtype == np.uint8
    unknown = msgpack.packb({"x": msgpack.ExtType(9, b"??")})
    assert weights.msgpack_restore(unknown) == {"x": msgpack.ExtType(9, b"??")}


# ---------------------------------------------------------------------------
# Loads across the packages
# ---------------------------------------------------------------------------


def test_jax_blob_loads_into_port_with_equal_top1_tinynet():
    variables = tiny_variables(6)
    _, got = weights.weights_from_bytes(jax_weights.weights_to_bytes("tinynet", variables))
    engine = InferenceEngine("tinynet", device="cpu", batch_size=BATCH, dtype=torch.float32,
                             seed=9)
    engine.load_variables(got)
    jax_engine = JaxEngine("tinynet", batch_size=BATCH, dtype=jnp.float32, use_pallas=True,
                           variables=jax.tree_util.tree_map(jnp.asarray, variables))
    batch = seeded_pixels([f"img_{i}" for i in range(BATCH)])
    got, want = engine.run_batch(batch), jax_engine.run_batch(batch)
    np.testing.assert_array_equal(got.top1_index, want.top1_index)
    np.testing.assert_allclose(got.top1_prob, want.top1_prob, rtol=PROB_RTOL)


def test_blobs_load_both_ways_with_equal_top1_resnet18():
    """The port's seeded resnet18 (calibrated to a clear top class) goes to a
    JAX engine through a port blob, and comes back from a JAX blob into a
    port engine seeded otherwise: all three answer alike."""
    source = registry.get_model("resnet18").init_params(3, dtype=torch.float32)
    variables = registry.get_model("resnet18").to_jax(source.state_dict())
    port_blob = weights.weights_to_bytes("resnet18", variables)
    name, jax_tree = jax_weights.weights_from_bytes(port_blob, expect_model="resnet18")
    assert name == "resnet18"
    jax_engine = JaxEngine("resnet18", batch_size=RESNET_BATCH, dtype=jnp.float32,
                           use_pallas=True, variables=jax.tree_util.tree_map(jnp.asarray, jax_tree))
    _, port_tree = weights.weights_from_bytes(jax_weights.weights_to_bytes("resnet18", jax_tree))
    engine = InferenceEngine("resnet18", device="cpu", batch_size=RESNET_BATCH,
                             dtype=torch.float32, seed=11)
    batch = seeded_pixels([f"img_{i}" for i in range(RESNET_BATCH)], size=224)
    before = engine.run_batch(batch).top1_index
    engine.load_variables(port_tree)
    got = engine.run_batch(batch).top1_index
    want = jax_engine.run_batch(batch).top1_index
    np.testing.assert_array_equal(got, want)
    direct = InferenceEngine("resnet18", device="cpu", batch_size=RESNET_BATCH,
                             dtype=torch.float32, variables=source.state_dict())
    np.testing.assert_array_equal(direct.run_batch(batch).top1_index, want)
    assert not np.array_equal(before, got)


def test_jax_blob_loads_into_port_with_equal_greedy_tokens_lm_small():
    variables = jax_seeded("lm_small", seed=2)
    _, got = weights.weights_from_bytes(jax_weights.weights_to_bytes("lm_small", variables))
    kw = dict(max_slots=2, page_size=8, num_pages=32, max_prefill=16)
    ours = GenerationEngine("lm_small", device="cpu", seed=5, **kw)
    ours.load_variables(got)
    ref = JaxGenerationEngine("lm_small", variables=variables, **kw)
    prompt = np.random.default_rng(4).integers(
        0, registry.get_model("lm_small").num_outputs, size=9).astype(np.int32)
    toks = [ours.join(0, prompt)]
    want = [ref.join(0, prompt)]
    for _ in range(6):
        ours.ensure_capacity(0)
        ref.ensure_capacity(0)
        toks.append(int(ours.step()[0]))
        want.append(int(np.asarray(ref.step())[0]))
    assert toks == want


def test_port_blob_loads_through_the_jax_reader():
    for name in BLOB_MODELS:
        variables = port_seeded(name, seed=1)
        got_name, tree = jax_weights.weights_from_bytes(weights.weights_to_bytes(name, variables))
        assert got_name == name
        assert_trees_equal(tree, variables)


def test_publish_weights_puts_the_blob_under_its_name():
    class Client:
        def put_bytes(self, data, name):
            self.put = (data, name)
            return {"version": 4}

    client = Client()
    variables = tiny_variables(1)
    assert weights.publish_weights(client, "tinynet", variables) == 4
    assert client.put == (jax_weights.weights_to_bytes("tinynet", variables), "models/tinynet")
    assert weights.sdfs_weights_name("resnet18") == jax_weights.sdfs_weights_name("resnet18")
    err = RuntimeError("sdfs get models/x: not in SDFS")
    assert weights.not_published(err) and jax_weights.not_published(err)
    assert not weights.not_published(RuntimeError("integrity: digest mismatch"))


# ---------------------------------------------------------------------------
# Validation: the JAX package's messages
# ---------------------------------------------------------------------------


def error_text(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_validation_errors_are_the_jax_messages():
    variables = tiny_variables(0)
    blob = jax_weights.weights_to_bytes("tinynet", variables)
    bad_shape = as_numpy(variables)
    bad_shape["params"]["head"]["bias"] = np.zeros((41,), np.float32)
    missing = as_numpy(variables)
    del missing["params"]["head"]
    extra = as_numpy(variables)
    extra["params"]["conv1"]["scale"] = np.ones(8, np.float32)
    cases = [
        ("weights_from_bytes", (b"garbage" + blob,), {}),
        ("weights_from_bytes", (blob,), {"expect_model": "resnet18"}),
        ("weights_to_bytes", ("tinynet", bad_shape), {}),
        ("weights_to_bytes", ("tinynet", missing), {}),
        ("weights_to_bytes", ("tinynet", extra), {}),
        ("weights_to_bytes", ("resnet18", variables), {}),
    ]
    texts = []
    for fn, args, kw in cases:
        got = error_text(getattr(weights, fn), *args, **kw)
        assert got == error_text(getattr(jax_weights, fn), *args, **kw)
        texts.append(got)
    assert "bad magic" in texts[0] and "expected 'resnet18'" in texts[1]
    assert "shape mismatch for 'tinynet' at ['params']['head']['bias']" in texts[2]
    assert "tree mismatch" in texts[3] and "extra=[\"['params']['conv1']['scale']\"]" in texts[4]


def test_weights_refuses_to_import_without_msgpack():
    probe = ("import sys; sys.modules['msgpack'] = None\n"
             "try:\n    import dmlc_tpu_torch.models.weights\n"
             "except ImportError as e:\n    print('refused:', e)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert "refused:" in out.stdout and "msgpack" in out.stdout


# ---------------------------------------------------------------------------
# Templates, accounting, mappings
# ---------------------------------------------------------------------------


#: Templates and accounting only: their full-width trees are not drawn here.
TRANSFORMER_IMAGE_MODELS = ["clip_vit_b32", "clip_vit_l14", "vit_b16", "vit_l14"]


@pytest.mark.parametrize("name", PORT_MODELS + TRANSFORMER_IMAGE_MODELS + ["tinynet"])
def test_template_and_accounting_equal_the_jax_package(name):
    want = jax_weights.variables_template(name)
    got = weights.variables_template(name)
    w = [(jax.tree_util.keystr(p), tuple(s.shape), np.dtype(s.dtype))
         for p, s in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [(k, tuple(s.shape), s.dtype) for k, s in weights.flatten_with_keys(got)] == w
    if name == "tinynet":
        return
    spec, jspec = registry.get_model(name), jax_registry.get_model(name)
    assert spec.param_count() == jspec.param_count()
    assert spec.param_bytes() == jspec.param_bytes()
    assert spec.param_bytes(torch.bfloat16) == jspec.param_bytes(jnp.bfloat16)
    assert spec.param_bytes(np.float16) == jspec.param_bytes(jnp.float16)


@pytest.mark.parametrize("name", PORT_MODELS)
def test_to_jax_inverts_from_jax_bit_for_bit(name):
    spec = registry.get_model(name)
    variables = random_like_template(name, seed=len(name))
    sd = spec.from_jax(variables)
    assert_trees_equal(spec.to_jax(sd), variables)
    # And the state dict loads into the module as it stands.
    module = spec.module(dtype=torch.float32)
    convert.load_into(module, name, variables)
    assert_trees_equal(spec.to_jax(module.state_dict()), variables)


def test_to_jax_refuses_unknown_entries():
    with pytest.raises(KeyError, match="unexpected ResNet entry"):
        convert.resnet_to_jax({"layer1.0.relu.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="unexpected AlexNet entry"):
        convert.alexnet_to_jax({"features.1.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="unexpected language-model entry"):
        convert.lm_to_jax({"block0.attn.rope.weight": torch.zeros(1)})


class LazyStateDict(dict):
    """A state dict that makes each entry on first reading, seeded by its
    name, in the rank its layout needs: 4-D convs, 2-D dense weights and
    position tables, a [1, 1, D] class token, else 1-D."""

    def __missing__(self, key):
        rng = np.random.default_rng(int.from_bytes(key.encode()[-8:].rjust(8, b"\0"), "big"))
        if "patch_embedding" in key and key.endswith("weight"):
            shape = (6, 3, 2, 2)
        elif key.endswith("cls_token"):
            shape = (1, 1, 6)
        elif key.endswith("class_embedding"):
            shape = (6,)
        elif key.endswith("position_embeddings"):
            shape = (1, 5, 6)
        elif key.endswith("weight") and "norm" not in key:
            shape = (7, 6)
        else:
            shape = (6,)
        self[key] = rng.standard_normal(shape).astype(np.float32)
        return self[key]


def torchvision_state_dict(name: str, seed: int) -> dict:
    """Seeded numpy values in torchvision's layout (the port's modules use
    torchvision's names and shapes)."""
    rng = np.random.default_rng(seed)
    module = registry.get_model(name).module(dtype=torch.float32)
    return {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
            for k, v in module.state_dict().items() if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("family", ["vit", "clip"])
def test_hf_importers_equal_the_jax_package(family):
    fn = f"{family}_params_from_hf"
    sd = LazyStateDict()
    want = getattr(jax_convert, fn)(sd, 2)
    assert_trees_equal(getattr(convert, fn)(sd, 2), want)


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "alexnet"])
def test_torchvision_importers_equal_the_jax_package(name):
    sd = torchvision_state_dict(name, seed=8)
    want = jax_weights.import_external(name, sd)
    got = weights.import_external(name, sd)
    assert_trees_equal(got, want)
    if name == "alexnet":
        assert_trees_equal(convert.alexnet_params_from_torch(sd),
                           jax_convert.alexnet_params_from_torch(sd))
    else:
        sizes, bottleneck = weights._RESNET_STAGES[name]
        assert_trees_equal(convert.resnet_params_from_torch(sd, sizes, bottleneck),
                           jax_convert.resnet_params_from_torch(sd, sizes, bottleneck))
    # The import is the module's own state dict, carried to the JAX tree.
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert_trees_equal(registry.get_model(name).to_jax(tensors), want)


@pytest.mark.parametrize("name", ["tinynet"])
def test_import_external_refuses_what_the_port_cannot_serve(name):
    with pytest.raises(KeyError) as e:
        weights.import_external(name, {})
    assert str(e.value) == repr(f"no external-checkpoint importer for {name!r}")
