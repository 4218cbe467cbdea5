"""The port's TransformerLM against the JAX package's SPTransformerLM.

Weights are the JAX registry's seeded init, carried to the port by
``models/convert.lm_from_jax``; both run float32 on the CPU at full width.
Logits agree within 1e-4: the two sum the same float32 products in another
order through two layers of 512-wide projections and a 2048-way head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.models.registry import get_model as jax_get_model
from dmlc_tpu_torch.models import registry as t_registry
from dmlc_tpu_torch.models.convert import lm_from_jax, variables_from_jax
from dmlc_tpu_torch.models.lm import TransformerLM

ATOL = 1e-4


def _jax_lm(name):
    module, variables = jax_get_model(name).init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    return module, jax.tree_util.tree_map(np.asarray, variables)


def _port_lm(name, variables):
    model = t_registry.get_model(name).module(dtype=torch.float32).eval()
    model.load_state_dict(lm_from_jax(variables))
    return model


@pytest.mark.parametrize("name,seq", [("lm_small", 24), ("lm_wide", 128)])
def test_forward_matches_flax(name, seq):
    module, variables = _jax_lm(name)
    vocab = jax_get_model(name).num_outputs
    tokens = np.random.default_rng(seq).integers(0, vocab, size=(2, seq)).astype(np.int32)
    want = np.asarray(module.apply(variables, jnp.asarray(tokens)))
    with torch.no_grad():
        got = _port_lm(name, variables)(torch.from_numpy(tokens).long())
    assert tuple(got.shape) == (2, seq, vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert (got.argmax(-1).numpy() == want.argmax(-1)).all()


def test_state_dict_maps_one_to_one_onto_the_flax_tree():
    _, variables = _jax_lm("lm_small")
    sd = variables_from_jax("lm_small", variables)
    model = t_registry.get_model("lm_small").module(dtype=torch.float32)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(variables))
    assert sum(t.numel() for t in sd.values()) == n_jax
    assert "block1.attn.query.weight" in sd and "ln_f.weight" in sd
    # Dense [in, out] kernels become [out, in] weights.
    np.testing.assert_array_equal(
        sd["block0.mlp_in.weight"].numpy(), variables["params"]["block0"]["mlp_in"]["kernel"].T)


def test_forward_refuses_past_max_len():
    model = TransformerLM(vocab=16, num_layers=1, num_heads=2, hidden=8, mlp_dim=16, max_len=4)
    with pytest.raises(ValueError, match="max_len"):
        model(torch.zeros(1, 5, dtype=torch.long))


def test_layer_norm_uses_flax_epsilon_and_tanh_gelu():
    """A zero-mean row of variance 1e-6 makes eps visible: 1e-6 (flax),
    not torch's 1e-5; and the MLP uses GELU's tanh approximation
    (jax.nn.gelu's default)."""
    import flax.linen as fnn

    x = np.array([[1e-3, -1e-3] * 4], np.float32)
    want = np.asarray(fnn.LayerNorm().apply({"params": {"scale": np.ones(8, np.float32),
                                                        "bias": np.zeros(8, np.float32)}},
                                            jnp.asarray(x)))
    model = TransformerLM(vocab=16, num_layers=1, num_heads=2, hidden=8, mlp_dim=16, max_len=4)
    np.testing.assert_allclose(model.ln_f(torch.from_numpy(x)).detach().numpy(), want,
                               rtol=0, atol=1e-5)
    h = np.linspace(-4, 4, 33, dtype=np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(h), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(h))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["lm_small", "lm_wide"])
def test_seeded_init_is_reproducible(name):
    spec = t_registry.get_model(name)
    a, b = spec.init_params(5, torch.float32), spec.init_params(5, torch.float32)
    c = spec.init_params(6, torch.float32)
    for (key, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                                 c.state_dict().values()):
        assert torch.equal(va, vb), key
    assert not torch.equal(a.head.weight, c.head.weight)
    assert torch.all(a.head.bias == 0) and torch.all(a.ln_f.weight == 1)
    width = a.hidden
    assert abs(float(a.embed.weight.detach().std()) - width**-0.5) < 0.1 * width**-0.5
