"""Pipeline (pp) and expert (ep) parallelism in the port
(parallel/pipeline.py, parallel/moe.py) against the JAX package's, on the
CPU: the JAX side on conftest's eight virtual CPU devices, the port's on a
mesh of eight ``cpu`` positions, at tests/test_pipeline_moe.py's stage
function and sizes, numpy-seeded.

- ``pipeline_apply`` at {pp: 4, dp: 2} (and {pp: 4} alone) against the JAX
  ``pipeline_apply``, for 1, 2, 4 and 8 microbatches: outputs within atol
  and rtol 2e-5 (that file's bound against its sequential reference), and
  the gradients of sum(out²) for the stacked parameters and the input
  within 1e-4 (its gradient bound); both ``ValueError``s with the JAX
  wording;
- ``top1_routing``/``top2_routing``: dispatch equal to JAX's exactly and
  combine within 2 ulps of float32 (softmax and the pair renormalization
  round in another order),
  capacity pressure included;
- ``MoEMlp`` top-1 and top-2 at {ep: 4, dp: 2} with weights carried by
  ``moe.from_jax``: outputs and aux loss against the JAX module applied to
  weights placed by its ``shard_moe_params``, atol and rtol 2e-5; one
  train step's gradients under the ep mesh against ``jax.grad``, 1e-4;
  the placement of ``shard_moe_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.parallel import mesh as jax_mesh
from dmlc_tpu.parallel.moe import MoEMlp as JaxMoEMlp
from dmlc_tpu.parallel.moe import shard_moe_params as jax_shard_moe_params
from dmlc_tpu.parallel.moe import top1_routing as jax_top1
from dmlc_tpu.parallel.moe import top2_routing as jax_top2
from dmlc_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from dmlc_tpu.parallel.pipeline import stack_stage_params as jax_stack
from dmlc_tpu_torch.parallel import moe
from dmlc_tpu_torch.parallel.mesh import make_mesh
from dmlc_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    reference_apply,
    stack_stage_params,
)

OUT_TOL, GRAD_TOL = 2e-5, 1e-4
D, BATCH, STAGES = 16, 16, 4
MICROBATCHES = (1, 2, 4, 8)


def jax_stage_fn(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def stage_fn(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side here is thousands of tiny ops: one intra-op thread
    runs them several times faster than a pool, and keeps the workers of
    a parallel test run from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def pipeline_refs():
    rng = np.random.default_rng(0)
    per_stage = [((rng.standard_normal((D, D)) * 0.3).astype(np.float32),
                  (rng.standard_normal(D) * 0.1).astype(np.float32)) for _ in range(STAGES)]
    x = rng.standard_normal((BATCH, D)).astype(np.float32)
    mesh = jax_mesh.make_mesh({"pp": STAGES, "dp": 2})
    stacked = jax_stack([tuple(jnp.asarray(a) for a in p) for p in per_stage])

    @jax.jit
    def run_all(stacked, x):
        return [jax_pipeline_apply(jax_stage_fn, stacked, x, mesh, n_micro=n)
                for n in MICROBATCHES]

    def loss(stacked, x):
        return jnp.sum(jax_pipeline_apply(jax_stage_fn, stacked, x, mesh, n_micro=4) ** 2)

    outs = dict(zip(MICROBATCHES, map(np.asarray, run_all(stacked, jnp.asarray(x)))))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(stacked, jnp.asarray(x))
    return per_stage, x, outs, jax.tree_util.tree_map(np.asarray, grads)


def _port_stacked(per_stage, grad=False):
    stacked = stack_stage_params([tuple(torch.from_numpy(a) for a in p) for p in per_stage])
    return tuple(a.requires_grad_(grad) for a in stacked)


@pytest.mark.parametrize("n_micro", MICROBATCHES)
def test_pipeline_matches_the_jax_pipeline(pipeline_refs, n_micro):
    per_stage, x, outs, _ = pipeline_refs
    got = pipeline_apply(stage_fn, _port_stacked(per_stage), torch.from_numpy(x),
                         port_mesh({"pp": STAGES, "dp": 2}), n_micro=n_micro)
    np.testing.assert_allclose(got.numpy(), outs[n_micro], atol=OUT_TOL, rtol=OUT_TOL)
    # Without a dp axis every microbatch may be a single row.
    alone = pipeline_apply(stage_fn, _port_stacked(per_stage), torch.from_numpy(x),
                           port_mesh({"pp": STAGES}), n_micro=BATCH)
    np.testing.assert_allclose(alone.numpy(), outs[n_micro], atol=OUT_TOL, rtol=OUT_TOL)


def test_pipeline_gradients_match_jax_grad(pipeline_refs):
    per_stage, x, _, (want_params, want_x) = pipeline_refs
    stacked = _port_stacked(per_stage, grad=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = pipeline_apply(stage_fn, stacked, xt, port_mesh({"pp": STAGES, "dp": 2}), n_micro=4)
    (out ** 2).sum().backward()
    for got, want in zip(stacked, want_params):
        np.testing.assert_allclose(got.grad.numpy(), want, atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_x, atol=GRAD_TOL, rtol=GRAD_TOL)
    # And the sequential reference's, through autograd alone.
    ref = [tuple(torch.from_numpy(a).requires_grad_() for a in p) for p in per_stage]
    (reference_apply(stage_fn, ref, torch.from_numpy(x)) ** 2).sum().backward()
    for s, p in enumerate(ref):
        np.testing.assert_allclose(stacked[0].grad[s].numpy(), p[0].grad.numpy(), atol=GRAD_TOL)


def test_pipeline_refuses_batches_that_do_not_split(pipeline_refs):
    per_stage, x, _, _ = pipeline_refs
    mesh = port_mesh({"pp": STAGES, "dp": 2})
    with pytest.raises(ValueError, match="batch 16 not divisible into 5 microbatches"):
        pipeline_apply(stage_fn, _port_stacked(per_stage), torch.from_numpy(x), mesh, n_micro=5)
    with pytest.raises(ValueError, match="microbatch 1 not divisible over dp=2"):
        pipeline_apply(stage_fn, _port_stacked(per_stage), torch.from_numpy(x), mesh, n_micro=16)


# ---------------------------------------------------------------------------
# routing and the MoE layer
# ---------------------------------------------------------------------------


def _routing_cases():
    rng = np.random.default_rng(1)
    skewed = rng.standard_normal((64, 4)).astype(np.float32)
    skewed[:, 0] += 2.0  # most tokens pick expert 0: capacity drops some
    return [(np.array([[5.0, 0.0], [4.0, 0.0], [3.0, 0.0], [0.0, 5.0]], np.float32), 2),
            (np.array([[5.0, 1.0], [5.0, 1.0], [5.0, 1.0], [0.0, 5.0]], np.float32), 2),
            (rng.standard_normal((32, 4)).astype(np.float32), 10),
            (skewed, 5)]


@pytest.mark.parametrize("k", [1, 2])
def test_routing_equals_the_jax_routing(k):
    jax_fn, port_fn = (jax_top1, moe.top1_routing) if k == 1 else (jax_top2, moe.top2_routing)
    jax_fn = jax.jit(jax_fn, static_argnums=1)
    for logits, capacity in _routing_cases():
        want = [np.asarray(a) for a in jax_fn(jnp.asarray(logits), capacity)]
        got = [a.numpy() for a in port_fn(torch.from_numpy(logits), capacity)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=2 ** -22, atol=0)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    assert want[0].sum() < k * logits.shape[0]  # the skewed case dropped tokens


MOE_T, MOE_D, MOE_H, MOE_E = 64, 8, 16, 4


@pytest.fixture(scope="module")
def moe_refs():
    """The JAX layer's output, aux loss and gradients under {ep: 4, dp: 2},
    top-1 and top-2, once."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((MOE_T, MOE_D)).astype(np.float32)
    y = rng.standard_normal((MOE_T, MOE_D)).astype(np.float32)
    mesh = jax_mesh.make_mesh({"ep": 4, "dp": 2})
    refs = {}
    for k in (1, 2):
        layer = JaxMoEMlp(num_experts=MOE_E, hidden_dim=MOE_H, router_top_k=k)
        variables = layer.init(jax.random.PRNGKey(3 + k), jnp.asarray(x))
        placed = jax_shard_moe_params(mesh, variables)

        def apply(v, x, layer=layer):
            out, state = layer.apply(v, x, mutable=["intermediates"])
            return out, state["intermediates"]["aux_loss"][0]

        def loss(v, x, y, layer=layer):
            return jnp.mean((layer.apply(v, x) - y) ** 2)

        # dmlc-lint: disable=J2 -- each iteration jits a DIFFERENT router (top-1, top-2); one compile each
        out, aux = jax.jit(apply)(placed, jnp.asarray(x))
        # dmlc-lint: disable=J2 -- as above: one gradient program per router
        grads = jax.jit(jax.grad(loss))(placed, jnp.asarray(x), jnp.asarray(y))
        refs[k] = (jax.tree_util.tree_map(np.asarray, variables), np.asarray(out), float(aux),
                   moe.from_jax(jax.tree_util.tree_map(np.asarray, grads)))
    return x, y, refs


def _port_layer(variables, k, mesh=None):
    layer = moe.MoEMlp(MOE_D, MOE_E, MOE_H, router_top_k=k, mesh=mesh)
    layer.load_state_dict(moe.from_jax(variables))
    return layer


@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_matches_the_jax_layer_under_the_ep_mesh(moe_refs, k):
    x, _, refs = moe_refs
    variables, want, want_aux, _ = refs[k]
    for mesh in (None, port_mesh({"ep": 4, "dp": 2})):
        with torch.no_grad():
            out, aux = _port_layer(variables, k, mesh)(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), want, atol=OUT_TOL, rtol=OUT_TOL)
        np.testing.assert_allclose(float(aux), want_aux, rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_train_step_under_the_ep_mesh_matches_jax_grad(moe_refs, k):
    x, y, refs = moe_refs
    variables, _, _, want = refs[k]
    layer = _port_layer(variables, k, port_mesh({"ep": 4, "dp": 2}))
    opt = torch.optim.AdamW(layer.parameters(), lr=1e-3, weight_decay=1e-4)
    out, _ = layer(torch.from_numpy(x))
    loss = ((out - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
    assert set(grads) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    before = {n: p.detach().clone() for n, p in layer.named_parameters()}
    opt.step()
    assert all(np.isfinite(p.detach().numpy()).all() for p in layer.parameters())
    assert not torch.equal(before["w_in"], layer.w_in.detach())


def test_shard_moe_params_places_each_ep_slice(moe_refs):
    _, _, refs = moe_refs
    layer = _port_layer(refs[1][0], 1)
    mesh = port_mesh({"ep": 4, "dp": 2})
    specs = {n: s.spec for n, s in moe.moe_param_shardings(mesh, layer.state_dict()).items()}
    assert specs == {"router.weight": (), "router.bias": (), "w_in": ("ep",),
                     "w_out": ("ep",)}
    placed = moe.shard_moe_params(mesh, layer.state_dict())
    for e in range(4):
        for d in range(2):
            assert torch.equal(placed["w_in"].shards[e, d], layer.w_in.detach()[e:e + 1])
            assert torch.equal(placed["router.weight"].shards[e, d], layer.router.weight.detach())
