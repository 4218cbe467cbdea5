"""The port's ResNet / AlexNet against the JAX models, with carried weights.

Every leaf of the JAX variables tree is drawn from a numpy seed (the JAX
init zeroes the last BatchNorm scale of each block, which would reduce the
blocks to their shortcuts and prove little), carried to the port with
``variables_from_jax``, and both models run the same numpy images in
float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmlc_tpu.models.convert as jax_convert
import dmlc_tpu.models.registry as jax_registry
import dmlc_tpu.models.resnet as jax_resnet
import dmlc_tpu_torch.models.registry as t_registry
import dmlc_tpu_torch.models.resnet as t_resnet
from dmlc_tpu.models.alexnet import AlexNet as JaxAlexNet
from dmlc_tpu_torch.models.alexnet import AlexNet, alexnet
from dmlc_tpu_torch.models.convert import alexnet_from_jax, resnet_from_jax

# float32 on both sides; convolutions sum in another order (oneDNN vs XLA),
# and a handful of layers compound it: logits agree to 1e-4 of their scale.
LOGIT_RTOL = 1e-4
LOGIT_ATOL = 1e-4
IMAGE = 64


def seeded_variables(variables, seed: int):
    """A numpy draw for every leaf of a flax variables tree (given as
    arrays or shape structs): weights ~ N(0, 1/fan_in), BatchNorm scales and
    variances positive."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = tuple(leaf.shape)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name.endswith("['mean']") or name.endswith("['bias']"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _images(seed, n=4, size=IMAGE):
    """Normalized-image-like inputs whose per-image, per-channel brightness
    and contrast differ, so that images differ by more than their noise."""
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.3, 2.0, (n, 1, 1, 3))
    shift = rng.uniform(-1.5, 1.5, (n, 1, 1, 3))
    return (rng.normal(size=(n, size, size, 3)) * gain + shift).astype(np.float32)


def _jax_init(model, size=IMAGE):
    """The variables tree's structure and shapes, without running init."""
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), x)


def _compare(jax_model, variables, torch_model, x):
    apply = jax.jit(lambda v, im: jax_model.apply(v, im, train=False))
    want = np.asarray(apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = torch_model.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL * scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("bottleneck", [False, True], ids=["basic", "bottleneck"])
def test_narrow_resnet_matches_jax(bottleneck):
    jblock = jax_resnet.Bottleneck if bottleneck else jax_resnet.BasicBlock
    tblock = t_resnet.Bottleneck if bottleneck else t_resnet.BasicBlock
    jm = jax_resnet.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=jblock, num_classes=10,
                           num_filters=8, dtype=jnp.float32)
    variables = seeded_variables(_jax_init(jm), seed=11 + bottleneck)
    tm = t_resnet.ResNet([1, 1, 1, 1], tblock, num_classes=10, num_filters=8, dtype=torch.float32)
    tm.load_state_dict(resnet_from_jax(variables))
    _compare(jm, variables, tm, _images(1))


def test_alexnet_matches_jax():
    jm = JaxAlexNet(num_classes=10, dtype=jnp.float32)
    variables = seeded_variables(_jax_init(jm), seed=13)
    tm = AlexNet(num_classes=10, dtype=torch.float32, image_size=IMAGE)
    tm.load_state_dict(alexnet_from_jax(variables))
    _compare(jm, variables, tm, _images(2))


def test_torchvision_named_state_dict_loads():
    """A state dict under torchvision's names (the names the JAX package's
    torchvision converters read) loads strictly into the port's modules and
    maps back through the JAX converter and variables_from_jax unchanged."""
    cases = [
        (t_resnet.resnet18(dtype=torch.float32),
         lambda sd: jax_convert.resnet_params_from_torch(sd, [2, 2, 2, 2], False),
         resnet_from_jax),
        (t_resnet.ResNet([1, 1, 1, 1], t_resnet.Bottleneck, 10, 8, torch.float32),
         lambda sd: jax_convert.resnet_params_from_torch(sd, [1, 1, 1, 1], True),
         resnet_from_jax),
        (alexnet(dtype=torch.float32), jax_convert.alexnet_params_from_torch,
         alexnet_from_jax),
    ]
    gen = torch.Generator().manual_seed(0)
    for model, to_jax, from_jax in cases:
        sd = {k: torch.randn(v.shape, generator=gen) if v.is_floating_point() else v
              for k, v in model.state_dict().items()}
        model.load_state_dict(sd)  # strict: every torchvision name is present
        back = from_jax(to_jax({k: v.numpy() for k, v in sd.items()}))
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k


def test_seeded_init_is_the_same_in_every_dtype_and_call():
    """init_params calibrates the head on a seeded batch in eval mode: an
    AlexNet's dropout draws nothing from the global generator, so the
    weights depend on the seed alone, in every compute dtype."""
    spec = t_registry.ModelSpec(
        "alexnet_64", lambda num_classes, dtype: AlexNet(num_classes, dtype=dtype,
                                                         image_size=IMAGE), IMAGE, 10)
    want = spec.init_params(3, dtype=torch.float32).state_dict()
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        got = spec.init_params(3, dtype=torch.bfloat16).state_dict()
        for key, value in want.items():
            assert torch.equal(got[key], value), key


def test_registry_matches_jax_registry():
    for name in t_registry.list_models():
        spec, jspec = t_registry.get_model(name), jax_registry.get_model(name)
        assert (spec.input_size, spec.num_outputs, spec.classifier, spec.kind) == (
            jspec.input_size, jspec.num_outputs, jspec.classifier, jspec.kind)
        assert spec.flops_per_item() == jspec.flops_per_item()
    assert {"resnet18", "alexnet"} <= set(t_registry.list_models())


def test_registry_param_count_matches_jax():
    """Parameters plus BatchNorm statistics (the JAX tree's leaves) agree
    with the JAX registry's analytic count; torch's per-BatchNorm
    num_batches_tracked counter has no JAX counterpart."""
    for name in ("resnet18", "alexnet"):
        model = t_registry.get_model(name).module(dtype=torch.float32)
        n = sum(v.numel() for k, v in model.state_dict().items()
                if not k.endswith("num_batches_tracked"))
        assert n == jax_registry.get_model(name).param_count()


def test_seeded_init_is_reproducible_and_input_dependent():
    spec = t_registry.get_model("resnet18")
    a, b = spec.init_params(3, torch.float32), spec.init_params(3, torch.float32)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    x = torch.from_numpy(_images(4, n=8, size=224))
    with torch.no_grad():
        logits = a(x)
    assert torch.isfinite(logits).all() and logits.shape == (8, 1000)
    assert len(set(logits.argmax(-1).tolist())) > 1  # not one class for every input


def test_bf16_model_keeps_float32_parameters():
    model = t_registry.get_model("alexnet").init_params(0, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.from_numpy(_images(5, n=2, size=224)))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
