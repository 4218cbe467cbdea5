"""Sequence parallelism in the port (parallel/{ring_attention,ulysses,
sp_transformer}.py, models/lm.py under a mesh) against the JAX package's, on
the CPU.

The JAX side runs on conftest's eight virtual CPU devices, the flash
schedules through the Pallas interpreter; the port's side on a mesh of
eight ``cpu`` positions, its flash wrappers running their plain versions.
Inputs are numpy-seeded, LM weights carried from the JAX tree by
``lm_from_jax``. Every JAX reference is computed once per module.

- ``ring_attention``, ``ring_flash_attention`` and ``ulysses_attention``
  (dense and flash local attention) at {dp: 2, sp: 4}, causal and not:
  outputs and the gradients of q, k and v of sum(sin(out)) against
  ``jax.value_and_grad``, within atol 3e-5 and rtol 1e-4
  (tests/test_sp_transformer.py's bound between schedules);
- the LM at tests/test_sp_transformer.py's sizes under "ring",
  "ring_flash" and "ulysses" at {dp: 2, sp: 4}: logits at that bound, the
  first step's loss (atol 1e-5) and every gradient (atol 2e-6, rtol 1e-4,
  as tests/test_torch_train.py holds the flash LM) against
  ``jax.value_and_grad``, and 5 Adam(1e-2) steps with a falling loss; the
  same with every parameter moved to each position by a copy, as on a mesh
  of distinct devices (torch has one CPU device, so the copies are forced);
- one Block under each schedule, called on its own, against the dense
  Block (output and gradients);
- the refusals: Ulysses' heads % sp, and an sp schedule without a mesh
  or without an sp axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dmlc_tpu.parallel import make_mesh as jax_make_mesh
from dmlc_tpu.parallel.ring_attention import ring_attention as jax_ring
from dmlc_tpu.parallel.ring_attention import ring_flash_attention as jax_ring_flash
from dmlc_tpu.parallel.sp_transformer import SPTransformerLM as JaxSPTransformerLM
from dmlc_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from dmlc_tpu_torch.models.convert import lm_from_jax
from dmlc_tpu_torch.models.lm import Block, TransformerLM
from dmlc_tpu_torch.parallel import sp_transformer
from dmlc_tpu_torch.parallel.mesh import join_positions, make_mesh, split_to_positions
from dmlc_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention
from dmlc_tpu_torch.parallel.sp_transformer import SPTransformerLM
from dmlc_tpu_torch.parallel.train import lm_loss
from dmlc_tpu_torch.parallel.ulysses import ulysses_attention

ATOL, RTOL = 3e-5, 1e-4
LOSS_ATOL, GRAD_ATOL = 1e-5, 2e-6
MESH = {"dp": 2, "sp": 4}
QKV_SHAPE = (4, 4, 32, 16)  # B over dp 2, S over sp 4, 4 heads over sp 4 for Ulysses
VOCAB, LAYERS, HEADS, HIDDEN, MLP = 32, 2, 4, 32, 64
B, S = 4, 32
SP_SCHEDULES = ("ring", "ring_flash", "ulysses")

_JAX_ATTENTION = {
    "ring": jax_ring,
    "ring_flash": jax_ring_flash,
    "ulysses": jax_ulysses,
    "ulysses_flash": lambda *a, **kw: jax_ulysses(*a, use_flash=True, **kw),
}
_PORT_ATTENTION = {
    "ring": ring_attention,
    "ring_flash": ring_flash_attention,
    "ulysses": ulysses_attention,
    "ulysses_flash": lambda *a, **kw: ulysses_attention(*a, use_flash=True, **kw),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side here is thousands of tiny ops: one intra-op thread
    runs them several times faster than a pool, and keeps the workers of
    a parallel test run from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_mesh():
    return make_mesh(MESH, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def attention_refs():
    """Each JAX schedule's output and gradients, causal and not, once."""
    rng = np.random.default_rng(0)
    qkv = [rng.standard_normal(QKV_SHAPE).astype(np.float32) for _ in range(3)]
    mesh = jax_make_mesh(MESH)
    refs = {}
    for name, fn in _JAX_ATTENTION.items():
        for causal in (False, True):
            def f(q, k, v, fn=fn, causal=causal):
                o = fn(q, k, v, mesh, causal=causal)
                return jnp.sum(jnp.sin(o)), o

            # dmlc-lint: disable=J2 -- each iteration jits a DIFFERENT schedule; one compile each is the reference
            (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(t) for t in qkv))
            refs[name, causal] = (np.asarray(out), [np.asarray(g) for g in grads])
    return qkv, refs


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", list(_PORT_ATTENTION))
def test_attention_and_its_gradients_match_the_jax_schedule(attention_refs, name, causal):
    qkv, refs = attention_refs
    want_out, want_grads = refs[name, causal]
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in qkv)
    out = _PORT_ATTENTION[name](q, k, v, port_mesh(), causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL, rtol=RTOL)
    grads = torch.autograd.grad(torch.sin(out).sum(), (q, k, v))
    for g, w, which in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=f"d{which}")


def test_ulysses_refuses_heads_that_do_not_split_and_the_mesh_helpers_invert():
    q = torch.zeros(2, 6, 32, 8)
    with pytest.raises(ValueError, match="heads % sp"):
        ulysses_attention(q, q, q, port_mesh())  # 6 heads over sp=4
    x = torch.arange(4 * 6 * 32 * 8, dtype=torch.float32).reshape(4, 6, 32, 8)
    dims = {"dp": 0, "sp": 2}
    grid = split_to_positions(x, port_mesh(), dims)
    assert grid.shape == (2, 4) and tuple(grid[1, 3].shape) == (2, 6, 8, 8)
    assert torch.equal(grid[1, 3], x[2:, :, 24:])
    assert torch.equal(join_positions(grid, port_mesh(), dims), x)
    with pytest.raises(ValueError, match="split evenly"):
        split_to_positions(torch.zeros(4, 6, 30, 8), port_mesh(), dims)


# ---------------------------------------------------------------------------
# the LM under the sequence-parallel schedules
# ---------------------------------------------------------------------------


def _jax_lm(mesh, schedule):
    return JaxSPTransformerLM(vocab=VOCAB, num_layers=LAYERS, num_heads=HEADS, hidden=HIDDEN,
                              mlp_dim=MLP, max_len=S, mesh=mesh, schedule=schedule)


def _port_lm(variables, schedule, mesh=None):
    model = SPTransformerLM(vocab=VOCAB, num_layers=LAYERS, num_heads=HEADS, hidden=HIDDEN,
                            mlp_dim=MLP, max_len=S, mesh=mesh or port_mesh(), schedule=schedule)
    model.load_state_dict(lm_from_jax(variables))
    return model


@pytest.fixture(scope="module")
def lm_refs():
    """Tokens, the carried weights, and each JAX schedule's logits, loss
    and gradients with the tokens cut over dp and sp, once."""
    tokens = np.random.default_rng(1).integers(0, VOCAB, (B, S + 1)).astype(np.int32)
    variables = jax.tree_util.tree_map(np.asarray, _jax_lm(None, "dense").init(
        jax.random.PRNGKey(2), jnp.asarray(tokens[:, :-1])))
    mesh = jax_make_mesh(MESH)
    shd = NamedSharding(mesh, P("dp", "sp"))
    inputs = jax.device_put(jnp.asarray(tokens[:, :-1]), shd)
    targets = jax.device_put(jnp.asarray(tokens[:, 1:]), shd)
    refs = {}
    for schedule in SP_SCHEDULES:
        model = _jax_lm(mesh, schedule)

        def loss_fn(params, model=model):
            logits = model.apply(params, inputs)
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), targets).mean()
            return loss, logits

        # dmlc-lint: disable=J2 -- each iteration jits a DIFFERENT schedule's model; one compile each is the reference
        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
        refs[schedule] = (np.asarray(logits), float(loss),
                          lm_from_jax(jax.tree_util.tree_map(np.asarray, grads)))
    return tokens, variables, refs


def _hold_first_step(model, tokens, want_logits, want_loss, want_grads):
    batch = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits = model(batch[:, :-1]).numpy()
    np.testing.assert_allclose(logits, want_logits, atol=ATOL, rtol=RTOL)
    loss = lm_loss(model, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=LOSS_ATOL)
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), atol=GRAD_ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("schedule", SP_SCHEDULES)
def test_sp_lm_first_step_matches_value_and_grad_and_trains(lm_refs, schedule):
    tokens, variables, refs = lm_refs
    model = _port_lm(variables, schedule)
    _hold_first_step(model, tokens, *refs[schedule])
    model.zero_grad(set_to_none=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    batch = torch.from_numpy(tokens).long()
    losses = []
    for _ in range(5):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model, batch)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("schedule", ["ring_flash", "ulysses"])
def test_weights_copied_to_every_position_still_sum_their_gradients(lm_refs, schedule,
                                                                    monkeypatch):
    """On a mesh of distinct devices each position computes with its own
    autograd-tracked copy of every parameter; the copies' gradients must
    sum into the parameter's."""
    copies = []

    def copy(t, device):
        copies.append(t)
        return t.clone()

    monkeypatch.setattr(sp_transformer, "_to_position", copy)
    tokens, variables, refs = lm_refs
    _hold_first_step(_port_lm(variables, schedule), tokens, *refs[schedule])
    assert copies  # the copy path ran


@pytest.mark.parametrize("schedule", SP_SCHEDULES)
def test_one_block_under_a_mesh_equals_the_dense_block(schedule):
    """A Block called on its own cuts its input over the mesh and joins
    its output: equal to the dense Block, with equal gradients."""
    torch.manual_seed(3)
    dense = Block(HIDDEN, HEADS, MLP, torch.float32)
    block = Block(HIDDEN, HEADS, MLP, torch.float32, schedule, port_mesh())
    block.load_state_dict(dense.state_dict())
    x = torch.randn(B, S, HIDDEN)
    want, got = dense(x), block(x)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=ATOL, rtol=RTOL)
    want.square().sum().backward()
    got.square().sum().backward()
    for (name, p), q in zip(block.named_parameters(), dense.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_sp_schedules_need_a_mesh_with_an_sp_axis():
    for schedule in SP_SCHEDULES:
        with pytest.raises(ValueError, match="pass mesh="):
            TransformerLM(vocab=VOCAB, num_layers=1, num_heads=HEADS, hidden=HIDDEN,
                          mlp_dim=MLP, max_len=S, schedule=schedule)
    with pytest.raises(ValueError, match="needs an 'sp' axis"):
        TransformerLM(vocab=VOCAB, num_layers=1, num_heads=HEADS, hidden=HIDDEN, mlp_dim=MLP,
                      max_len=S, schedule="ring", mesh=make_mesh({"dp": 2}, devices=["cpu"] * 2))
