"""The port's partition-rule engine (parallel/sharding.py, parallel/mesh.py)
and its ShardedProgram, held against the JAX package's on the CPU.

- the engine: rule matching, rule audits, spec clamping, mesh planning,
  gang widths, per-chip byte counts and prompt encoding each equal the JAX
  package's answer for the same inputs (registry models' JAX trees, the
  same mesh shapes over the virtual CPU devices of conftest.py and, for the
  port, the CPU named at every position);
- ``ShardedProgram("lm_wide")`` with the JAX seed-0 tree carried across:
  tokens equal to the JAX program's at widths 1, 3 and 8 and ragged at
  ``{dp: 4}`` (as tests/test_sharding.py holds the JAX program to its
  width-1 tokens), float32 logits within ``LOGITS_RTOL`` relative L2; with
  non-zero biases drawn from a seed, the tensor-parallel widths' logits
  within ``LOGITS_RTOL`` of width 1 (a split on the wrong axis, or a
  row-split bias added on every partial, misses by far more);
- the image branch: a tiny ViT at ``{tp: 2}`` and a tiny ResNet at
  ``{dp: 2}`` give JAX's top-1, a tiny CLIP's embeddings are within
  ``LOGITS_RTOL`` relative L2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.models import registry as jax_registry
from dmlc_tpu.models.clip import CLIPVisionEncoder as JaxCLIP
from dmlc_tpu.models.resnet import resnet18 as jax_resnet18
from dmlc_tpu.models.vit import ViT as JaxViT
from dmlc_tpu.parallel import mesh as jax_mesh_lib
from dmlc_tpu.parallel import sharding as jsl
from dmlc_tpu_torch.models import convert, registry
from dmlc_tpu_torch.models.clip import CLIPVisionEncoder
from dmlc_tpu_torch.models.resnet import resnet18
from dmlc_tpu_torch.models.vit import ViT
from dmlc_tpu_torch.parallel import mesh as mesh_lib
from dmlc_tpu_torch.parallel import sharding as sl

# Both sides compute in float32; the products sum in another order (oneDNN
# vs XLA, and a tensor-parallel split's partial sums), which moves the
# outputs by a few ulps of their scale.
LOGITS_RTOL = 1e-5

#: The registry's own entries (other test modules register tiny models).
MODELS = ("alexnet", "clip_vit_b32", "clip_vit_l14", "lm_small", "lm_wide", "resnet18",
          "resnet34", "resnet50", "vit_b16", "vit_l14")
MESHES = [{"dp": 1}, {"tp": 2}, {"dp": 3}, {"dp": 2, "tp": 2}, {"dp": 2, "tp": 4}]


def spec_tuple(spec) -> tuple:
    return tuple(spec)


def jax_mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return jax_mesh_lib.make_mesh(axes, devices=jax.devices()[:n])


def port_mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return mesh_lib.make_mesh(axes, devices=["cpu"] * n)


_JAX_ABSTRACT_PARAMS = jsl.abstract_params


@functools.cache
def jax_tree(model: str):
    return _JAX_ABSTRACT_PARAMS(model)


@pytest.fixture
def cached_jax_trees(monkeypatch):
    """The JAX package's own functions, with its abstract trees traced once."""
    monkeypatch.setattr(jsl, "abstract_params", lambda name, dtype=jnp.float32: jax_tree(name))


def jax_specs(model: str) -> dict:
    specs = jsl.match_partition_rules(jsl.rules_for_model(model), jax_tree(model))
    return {p: spec_tuple(s) for p, s in jsl.tree_paths(specs)}


# ---------------------------------------------------------------------------
# The engine


@pytest.mark.parametrize("model", MODELS)
def test_registry_declares_the_reference_rules_and_heads(model):
    ours, ref = registry.get_model(model), jax_registry.get_model(model)
    assert ours.num_heads == ref.num_heads
    assert [(p, spec_tuple(s)) for p, s in ours.partition_rules] == \
        [(p, spec_tuple(s)) for p, s in ref.partition_rules]


@pytest.mark.parametrize("model", MODELS)
def test_match_partition_rules_and_audit_equal_jax(model, cached_jax_trees):
    ours = sl.match_partition_rules(sl.rules_for_model(model), sl.abstract_params(model))
    assert {p: spec_tuple(s) for p, s in sl.tree_paths(ours)} == jax_specs(model)
    report, ref = sl.validate_model_rules(model), jsl.validate_model_rules(model)
    assert (report.dead_rules, report.unmatched, report.ok) == \
        (ref.dead_rules, ref.unmatched, ref.ok)


TREE = {
    "params": {
        "attn": {
            "query": {"kernel": np.zeros((8, 16)), "bias": np.zeros((16,))},
            "out": {"kernel": np.zeros((16, 8)), "bias": np.zeros((8,))},
        },
        "scale": np.zeros(()),
    }
}


@pytest.mark.parametrize("rules", [
    ((r"query/kernel$", (None, "tp")), (r"query/bias$", ("tp",)),
     (r"out/kernel$", ("tp", None)), (r".*", ())),
    ((r"nothing_matches_this$", ("tp",)), (r"kernel$", ())),
    ((r"bias$", ("tp",)),),
], ids=["healthy", "dead_rule", "unmatched"])
def test_rule_mechanics_on_a_synthetic_tree_equal_jax(rules):
    ours = tuple((p, sl.PartitionSpec(*s)) for p, s in rules)
    ref = tuple((p, jax.sharding.PartitionSpec(*s)) for p, s in rules)
    a, b = sl.validate_rules(ours, TREE), jsl.validate_rules(ref, TREE)
    assert (a.dead_rules, a.unmatched) == (b.dead_rules, b.unmatched)
    got = {p: spec_tuple(s) for p, s in sl.tree_paths(
        sl.match_partition_rules(ours, TREE, strict=False))}
    want = {p: spec_tuple(s) for p, s in jsl.tree_paths(
        jsl.match_partition_rules(ref, TREE, strict=False))}
    assert got == want
    if b.unmatched:
        with pytest.raises(ValueError, match="no partition rule matches"):
            sl.match_partition_rules(ours, TREE)


@pytest.mark.parametrize("axes", MESHES + [{"tp": 4}, {"dp": 2, "sp": 2}])
@pytest.mark.parametrize("spec,shape", [
    (("sp", "tp"), (8, 6)), ((None, "tp"), (8, 16)), (("dp", "tp"), (8,)),
    (("tp", None), (1024, 512)), ((("dp", "tp"), None), (16, 4)), ((None, "tp"), (512, 2048)),
    (("tp",), (3,)), ((), (4, 4)),
])
def test_clamp_spec_equals_jax(axes, spec, shape):
    got = sl.clamp_spec(sl.PartitionSpec(*spec), port_mesh(axes), shape)
    want = jsl.clamp_spec(jax.sharding.PartitionSpec(*spec), jax_mesh(axes), shape)
    assert spec_tuple(got) == spec_tuple(want)


@pytest.mark.parametrize("n", range(1, 9))
def test_plan_axes_and_min_gang_width_equal_jax(n):
    for heads in (None, 1, 2, 4, 12, 16):
        for max_tp in (None, 1, 2, 4):
            assert sl.plan_axes(n, num_heads=heads, max_tp=max_tp) == \
                jsl.plan_axes(n, num_heads=heads, max_tp=max_tp)
    for model_bytes in (25_206_784, 10, 25e6):
        for budget in (0, 1, 10e6, 3_151_000, 25e6, 30e6):
            assert sl.min_gang_width(model_bytes, budget, max_width=n) == \
                jsl.min_gang_width(model_bytes, budget, max_width=n)


@pytest.mark.parametrize("model", MODELS)
def test_sharded_bytes_per_chip_equal_jax(model, cached_jax_trees):
    for axes in MESHES:
        got = sl.sharded_bytes_per_chip(model, port_mesh(axes))
        want = jsl.sharded_bytes_per_chip(model, jax_mesh(axes))
        assert isinstance(got, int) and got == int(want), axes
    bf16 = sl.sharded_bytes_per_chip(model, port_mesh({"dp": 2, "tp": 4}), dtype=torch.bfloat16)
    assert bf16 == int(jsl.sharded_bytes_per_chip(model, jax_mesh({"dp": 2, "tp": 4}),
                                                  dtype=jnp.bfloat16))


@pytest.mark.parametrize("length,vocab", [(16, 2048), (7, 1024), (1, 3)])
def test_encode_prompts_byte_for_byte(length, vocab):
    prompts = ["p0", "p17", "", "prompt ü", "n00000042"]
    ours, ref = sl.encode_prompts(prompts, length, vocab), jsl.encode_prompts(prompts, length, vocab)
    assert ours.dtype == ref.dtype == np.int32
    assert ours.tobytes() == ref.tobytes()


def test_make_mesh_axes_and_devices():
    mesh = mesh_lib.make_mesh({"dp": -1, "tp": 2}, devices=["cpu"] * 6)
    assert mesh.shape == {"dp": 3, "tp": 2} and mesh.axis_names == ("dp", "tp")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="wants 4 devices, have 3"):
        mesh_lib.make_mesh({"dp": 2, "tp": 2}, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.make_mesh({"dp": -1, "tp": 2}, devices=["cpu"] * 3)
    solo = mesh_lib.make_mesh(device="cpu")
    assert solo.shape == {"dp": 1} and solo.devices[0] == torch.device("cpu")


def test_param_spec_fallback_equals_jax():
    for path, leaf in jsl.tree_paths(jax_tree("lm_wide")):
        parts = tuple(path.split("/"))
        assert spec_tuple(mesh_lib.param_spec(parts, leaf)) == \
            spec_tuple(jax_mesh_lib.param_spec(parts, leaf)), path


def test_torch_specs_split_the_transposed_dim():
    specs = sl.torch_partition_specs("lm_wide")
    # flax [in, out] kernels: q/k/v, mlp_in and the head split their output,
    # which is dim 0 of a torch [out, in] weight; out/mlp_out their input.
    assert specs["block0.attn.query.weight"] == ("tp", None)
    assert specs["block1.mlp_in.weight"] == ("tp", None)
    assert specs["head.weight"] == ("tp", None)
    assert specs["block0.attn.out.weight"] == (None, "tp")
    assert specs["block1.mlp_out.weight"] == (None, "tp")
    assert specs["block0.mlp_in.bias"] == ("tp",)
    assert specs["block0.mlp_out.bias"] == (None,)
    assert specs["head.bias"] == (None,)
    assert specs["embed.weight"] == (None, None)
    conv = sl.torch_partition_specs("resnet18")
    assert conv["bn1.num_batches_tracked"] == () and set(conv["conv1.weight"]) == {None}


def test_shard_and_gather_round_trip():
    mesh = port_mesh({"dp": 2, "tp": 2})
    tree = {"w": np.arange(32, dtype=np.float32).reshape(4, 8), "b": np.arange(8.0)}
    shardings = {"w": sl.NamedSharding(mesh, sl.PartitionSpec(None, "tp")),
                 "b": sl.NamedSharding(mesh, sl.PartitionSpec(("dp", "tp")))}
    shard_fn, gather_fn = sl.make_shard_and_gather_fns(mesh, shardings)
    placed = shard_fn(tree)
    assert placed["w"].shards[0, 1].shape == (4, 4)
    np.testing.assert_array_equal(placed["w"].shards[1, 1].numpy(), tree["w"][:, 4:])
    np.testing.assert_array_equal(placed["b"].shards[1, 0].numpy(), tree["b"][4:6])
    # Each position holds its own tensor, even where positions share a device.
    assert placed["w"].shards[0, 1].data_ptr() != placed["w"].shards[1, 1].data_ptr()
    back = gather_fn(placed)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["b"], tree["b"])


# ---------------------------------------------------------------------------
# ShardedProgram("lm_wide") against the JAX program


@pytest.fixture(scope="module")
def lm_reference():
    prog = jsl.ShardedProgram("lm_wide", jax_mesh({"dp": 1}))
    toks = jsl.encode_prompts([f"p{i}" for i in range(6)], 16,
                              jax_registry.get_model("lm_wide").num_outputs)
    variables = jax.device_get(prog.variables)
    logits = np.asarray(prog.model.apply(prog.variables, jnp.asarray(toks)))
    return prog, variables, toks, prog.run(toks), logits


def port_program(axes: dict, variables) -> sl.ShardedProgram:
    prog = sl.ShardedProgram("lm_wide", port_mesh(axes))
    prog.load_variables(variables)
    return prog


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def test_lm_wide_width_one_equals_jax(lm_reference):
    _, variables, toks, want, logits = lm_reference
    prog = port_program({"dp": 1}, variables)
    got = prog.run(toks)
    assert got.dtype == np.int32 and (got == want).all()
    assert rel_l2(prog.outputs(toks), logits) < LOGITS_RTOL


@pytest.mark.parametrize("n", [3, 8])
def test_lm_wide_gang_tokens_equal_jax(n, lm_reference):
    _, variables, toks, _, _ = lm_reference
    axes = sl.plan_axes(n, num_heads=registry.get_model("lm_wide").num_heads)
    assert axes == jsl.plan_axes(n, num_heads=4)
    ref = jsl.ShardedProgram("lm_wide", jax_mesh(axes))
    want = ref.run(toks)
    prog = port_program(axes, variables)
    assert (prog.run(toks) == want).all(), f"n={n} axes={axes}"
    if axes["tp"] > 1:  # the big matrices are really split
        query = prog.variables["block0.attn.query.weight"].shards
        assert query[0, 0].shape == (512 // axes["tp"], 512)


def test_lm_wide_ragged_batch_pads_and_strips(lm_reference):
    _, variables, toks, want, _ = lm_reference
    prog = port_program({"dp": 4}, variables)
    got = prog.run(toks[:5])  # 5 % dp(4) != 0: the pad path
    assert got.shape == (5,) and (got == want[:5]).all()


def seeded_lm_tree(seed: int) -> dict:
    """lm_wide's JAX tree with every leaf drawn from a seed, biases and
    LayerNorm shifts included (the flax init zeroes them, which would hide a
    bias added on every partial sum)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = tuple(leaf.shape)
        if path.endswith("bias"):
            return (0.5 * rng.normal(size=shape)).astype(np.float32)
        if path.endswith("scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        fan_in = shape[0] if len(shape) > 1 else 1
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    tree: dict = {}
    for path, leaf in jsl.tree_paths(jax_tree("lm_wide")):
        node = tree
        *parents, name = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = draw(path, leaf)
    return tree


@pytest.mark.parametrize("axes", [{"tp": 2}, {"dp": 2, "tp": 4}, {"tp": 8}])
def test_tensor_parallel_logits_equal_width_one(axes, lm_reference):
    _, _, toks, _, _ = lm_reference
    tree = seeded_lm_tree(3)
    ref = jsl.ShardedProgram("lm_wide", jax_mesh({"dp": 1}))
    ref.load_variables(tree)
    want = np.asarray(ref.model.apply(ref.variables, jnp.asarray(toks)))
    solo = port_program({"dp": 1}, tree).outputs(toks)
    assert rel_l2(solo, want) < LOGITS_RTOL
    assert rel_l2(port_program(axes, tree).outputs(toks), solo) < LOGITS_RTOL


# ---------------------------------------------------------------------------
# The image branch


IMAGE, CLASSES, PROJECTION = 32, 10, 16
TINY = {"patch_size": 8, "hidden_size": 64, "num_layers": 2, "num_heads": 4, "mlp_dim": 128}
TABLE = {"transformer": (sl.TRANSFORMER_PARTITION_RULES, jsl.TRANSFORMER_PARTITION_RULES),
         "replicated": (sl.REPLICATED_PARTITION_RULES, jsl.REPLICATED_PARTITION_RULES)}
TINY_MODELS = {
    # name: (jax build, port build, from_jax, to_jax, outputs, classifier, table)
    "vit_tiny_gang": (
        lambda num_classes, dtype: JaxViT(num_classes=num_classes, dtype=dtype, **TINY),
        lambda num_classes, dtype: ViT(num_classes=num_classes, dtype=dtype, image_size=IMAGE,
                                       **TINY),
        convert.vit_from_jax, convert.vit_to_jax, CLASSES, True, "transformer"),
    "clip_tiny_gang": (
        lambda dtype: JaxCLIP(projection_dim=PROJECTION, dtype=dtype, **TINY),
        lambda dtype: CLIPVisionEncoder(projection_dim=PROJECTION, dtype=dtype,
                                        image_size=IMAGE, **TINY),
        convert.clip_from_jax, convert.clip_to_jax, PROJECTION, False, "transformer"),
    "resnet_tiny_gang": (
        lambda num_classes, dtype: jax_resnet18(num_classes=num_classes, dtype=dtype),
        lambda num_classes, dtype: resnet18(num_classes=num_classes, dtype=dtype),
        convert.resnet_from_jax, convert.resnet_to_jax, CLASSES, True, "replicated"),
}
for _name, (_jb, _pb, _fj, _tj, _out, _cls, _table) in TINY_MODELS.items():
    if _name not in jax_registry.list_models():
        jax_registry.register(jax_registry.ModelSpec(
            _name, _jb, IMAGE, _out, classifier=_cls, partition_rules=TABLE[_table][1],
            num_heads=TINY["num_heads"] if _table == "transformer" else None))
    if _name not in registry.list_models():
        registry.register(registry.ModelSpec(
            _name, _pb, IMAGE, _out, classifier=_cls, from_jax=_fj, to_jax=_tj,
            partition_rules=TABLE[_table][0],
            num_heads=TINY["num_heads"] if _table == "transformer" else None))


def seeded_tree(template, seed: int):
    """A numpy draw for every leaf of a JAX tree: kernels N(0, 1/fan_in),
    biases 0.1 N(0, 1), scales in [0.5, 1.5], BatchNorm variances in [0.5,
    1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = tuple(leaf.shape)
        if name.endswith(("['bias']", "['mean']")):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name.endswith(("['scale']", "['var']")):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


@pytest.mark.parametrize("model,axes", [("vit_tiny_gang", {"tp": 2}),
                                        ("resnet_tiny_gang", {"dp": 2}),
                                        ("clip_tiny_gang", {"tp": 2})])
def test_image_branch_equals_jax(model, axes):
    ref = jsl.ShardedProgram(model, jax_mesh(axes))
    tree = seeded_tree(jax.device_get(ref.variables), 5)
    ref.load_variables(tree)
    prog = sl.ShardedProgram(model, port_mesh(axes))
    prog.load_variables(tree)
    images = np.random.default_rng(6).integers(0, 256, (6, IMAGE, IMAGE, 3), np.uint8)
    want, got = ref.run(images), prog.run(images)
    if registry.get_model(model).classifier:
        assert got.dtype == np.int32 and (got == want).all()
    else:
        assert got.shape == (6, PROJECTION) and rel_l2(got, want) < LOGITS_RTOL
