"""The port's dp x tp train step (``make_train_step(mesh=)``) on the CPU
against ``dmlc_tpu.parallel.train.make_train_step`` on the conftest's 8
virtual CPU devices, at the JAX package's own test sizes
(tests/test_parallel.py: a ViT of hidden 32, 2 layers, 4 heads, MLP 64,
16 px, patch 8, 8 classes, batch 8; a ResNet of one BasicBlock a stage):

- at ``{dp:2, tp:2}`` and ``{dp:4, tp:2}``: the first step's loss (atol
  1e-5) and accuracy (exact), every parameter after 1 and 3 steps and
  AdamW's ``mu`` and ``nu`` after 3 steps. Parameters: atol 2e-5, except
  ``attn.key.bias``, whose gradient is zero in exact arithmetic (a shift of
  every key's score cancels in the softmax): both sides' gradients there are
  rounding noise, which Adam scales to steps of up to ``lr``, so it is held
  within ``2 * lr`` a step. ``mu``: atol 1e-5; ``nu``: rtol 1e-3 (atol 1e-12);
- ``state_shardings`` equal to the JAX ``state_shardings`` leaf by leaf for
  ``params``, ``mu`` and ``nu``;
- a BatchNorm ResNet at ``{dp:2}``: the loss (atol 1e-5) and every running
  statistic after one step (atol 1e-5), which normalizing each dp shard
  alone would miss; and with ``remat`` and ``grad_accum=4`` at ``{dp:2,
  sp:2, tp:2}`` (tests/test_parallel.py:195-211) its loss and statistics,
  which move;
- the reference's own cases: ``grad_accum=2`` at ``{dp:2, tp:4}`` equal to
  the full batch (atol 1e-6; ``attn.key.bias`` within ``2 * lr``, as
  above), the divisibility error, ``remat`` giving the
  same parameters (atol 1e-6), and the mesh step at ``{dp:1}`` equal to the
  one-device step (exactly);
- ``TrainingDriver(mesh=)``: a restart resumes at the saved step, and a
  checkpoint saved under ``{dp:2, tp:2}`` restores into a one-device state
  with equal parameters and moments, and back again;
- the rest of ``parallel/mesh.py`` (``batch_sharding``, ``replicated``,
  ``param_shardings``, ``shard_params``) and its process-layout refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.models.resnet import BasicBlock as JaxBasicBlock
from dmlc_tpu.models.resnet import ResNet as JaxResNet
from dmlc_tpu.models.vit import ViT as JaxViT
from dmlc_tpu.parallel import create_train_state as jax_create_train_state
from dmlc_tpu.parallel import default_optimizer as jax_default_optimizer
from dmlc_tpu.parallel import make_mesh as jax_make_mesh
from dmlc_tpu.parallel import make_train_step as jax_make_train_step
from dmlc_tpu.parallel import param_shardings as jax_param_shardings
from dmlc_tpu.parallel import state_shardings as jax_state_shardings
from dmlc_tpu_torch.models.convert import resnet_from_jax, vit_from_jax
from dmlc_tpu_torch.models.resnet import BasicBlock, ResNet
from dmlc_tpu_torch.models.vit import ViT
from dmlc_tpu_torch.parallel import mesh as mesh_lib
from dmlc_tpu_torch.parallel.mesh import Mesh, make_mesh, process_dp_coords
from dmlc_tpu_torch.parallel.sharding import PartitionSpec, ShardedLeaf, gather_leaf, tree_paths
from dmlc_tpu_torch.parallel.train import (
    TrainShardedLinear,
    create_train_state,
    default_optimizer,
    make_train_step,
    position_counts,
    state_dicts,
    state_shardings,
)
from dmlc_tpu_torch.parallel.trainer import TrainingDriver
from dmlc_tpu_torch.utils.checkpoint import LocalCheckpointer

VIT = {"patch_size": 8, "hidden_size": 32, "num_layers": 2, "num_heads": 4, "mlp_dim": 64}
IMAGE, CLASSES, BATCH, LR = 16, 8, 8, 1e-3
ZERO_GRAD_SUFFIX = "attn.key.bias"
MESHES = [{"dp": 2, "tp": 2}, {"dp": 4, "tp": 2}]


def _name(axes):
    return "_".join(f"{a}{n}" for a, n in axes.items())


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models are many small ops: one intra-op thread runs them faster
    and keeps a parallel run's workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


def _mesh(axes):
    return make_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))


def _host(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def vit_setup():
    jax_model = JaxViT(num_classes=CLASSES, dtype=jnp.float32, **VIT)
    rng = np.random.default_rng(11)
    images = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = (np.arange(BATCH) % CLASSES).astype(np.int32)
    variables = _host(jax_model.init(jax.random.PRNGKey(0), images, train=False))
    return jax_model, variables, images, labels


def _port_vit(variables):
    model = ViT(num_classes=CLASSES, dtype=torch.float32, image_size=IMAGE, **VIT)
    model.load_state_dict(vit_from_jax(variables))
    return model


def _port_state(model):
    return create_train_state(model, default_optimizer(model.parameters(), lr=LR), device="cpu")


_JAX_RUNS: dict = {}


def _jax_vit_run(vit_setup, axes):
    """The JAX step at ``axes``: each step's metrics and parameters, and the
    moments after three steps (computed once per mesh)."""
    key = _name(axes)
    if key not in _JAX_RUNS:
        jax_model, variables, images, labels = vit_setup
        state = jax_create_train_state(jax_model, variables, jax_default_optimizer(LR))
        state, step = jax_make_train_step(_jax_mesh(axes), state)
        metrics, params = [], []
        for _ in range(3):
            state, m = step(state, images, labels)
            metrics.append({k: float(v) for k, v in m.items()})
            params.append(vit_from_jax({"params": _host(state.params)}))
        adam = state.opt_state[0]
        _JAX_RUNS[key] = (metrics, params, vit_from_jax({"params": _host(adam.mu)}),
                          vit_from_jax({"params": _host(adam.nu)}))
    return _JAX_RUNS[key]


def _port_vit_run(vit_setup, axes, steps=3):
    _, variables, images, labels = vit_setup
    state, step = make_train_step(_port_state(_port_vit(variables)), mesh=_mesh(axes))
    metrics, params = [], []
    for _ in range(steps):
        state, m = step(state, torch.from_numpy(images), torch.from_numpy(labels).long())
        metrics.append({k: float(v) for k, v in m.items()})
        params.append({k: v.clone() for k, v in state_dicts(state)[0].items()})
    return state, metrics, params


def _hold_params(got, want, steps):
    assert set(got) == set(want)
    for k, w in want.items():
        atol = 2 * LR * steps if k.endswith(ZERO_GRAD_SUFFIX) else 2e-5
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=atol, err_msg=k)


@pytest.mark.parametrize("axes", MESHES, ids=_name)
def test_first_step_loss_accuracy_and_parameters_match_jax(vit_setup, axes):
    jax_metrics, jax_params, _, _ = _jax_vit_run(vit_setup, axes)
    state, metrics, params = _port_vit_run(vit_setup, axes, steps=1)
    np.testing.assert_allclose(metrics[0]["loss"], jax_metrics[0]["loss"], atol=1e-5)
    assert metrics[0]["accuracy"] == jax_metrics[0]["accuracy"]
    _hold_params(params[0], jax_params[0], 1)
    # The Megatron leaves are split: the q kernel's output features and the
    # out kernel's input features over tp, each shard a parameter.
    query = state.model.get_submodule("block0.attn.query")
    assert isinstance(query, TrainShardedLinear) and query.mode == "out"
    assert [tuple(w.shape) for w in query.weight_shards] == [(16, 32), (16, 32)]
    assert state.model.get_submodule("block1.mlp_out").mode == "in"


@pytest.mark.parametrize("axes", MESHES, ids=_name)
def test_three_steps_parameters_and_adam_moments_match_jax(vit_setup, axes):
    jax_metrics, jax_params, mu, nu = _jax_vit_run(vit_setup, axes)
    state, metrics, params = _port_vit_run(vit_setup, axes)
    np.testing.assert_allclose([m["loss"] for m in metrics],
                               [m["loss"] for m in jax_metrics], atol=2e-5)
    for step in range(3):
        _hold_params(params[step], jax_params[step], step + 1)
    _, opt = state_dicts(state)
    names = state.layout.param_names
    assert sorted(names) == sorted(mu)
    for i, name in enumerate(names):
        moments = opt["state"][i]
        np.testing.assert_allclose(moments["exp_avg"].numpy(), mu[name].numpy(), atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(moments["exp_avg_sq"].numpy(), nu[name].numpy(), rtol=1e-3,
                                   atol=1e-12, err_msg=name)
        assert int(moments["step"]) == 3
    # Each tp shard has its own moments: twice as many moment tensors as
    # parameter tensors, and a position holds one tensor per whole leaf.
    counts = position_counts(state)
    assert counts["per_position"]["param_tensors"] == counts["whole_leaves"] == len(names)
    assert counts["process_total"]["moment_tensors"] == \
        2 * counts["process_total"]["param_tensors"]


def _tiny_resnets(classes=CLASSES, batch=8, seed=3):
    jax_model = JaxResNet(stage_sizes=[1, 1], block_cls=JaxBasicBlock, num_classes=classes,
                          num_filters=8, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, classes, batch).astype(np.int32)
    variables = _host(jax_model.init(jax.random.PRNGKey(2), images, train=False))
    model = ResNet([1, 1], BasicBlock, num_classes=classes, num_filters=8, dtype=torch.float32)
    model.load_state_dict(resnet_from_jax(variables))
    return jax_model, variables, model, images, labels


def _jax_state_specs(jax_state, mesh, collection):
    shd = jax_state_shardings(mesh, jax_state)
    tree = {"params": shd.params, "mu": shd.opt_state[0].mu, "nu": shd.opt_state[0].nu}
    flat = jax.tree_util.tree_flatten_with_path(tree[collection])[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in flat}


@pytest.mark.parametrize("family,axes", [
    ("vit", {"dp": 2, "tp": 2}), ("vit", {"dp": 4, "tp": 2}), ("vit", {"dp": 8}),
    ("resnet", {"dp": 2, "sp": 2, "tp": 2}),
], ids=lambda v: v if isinstance(v, str) else _name(v))
def test_state_shardings_equal_the_jax_specs_leaf_by_leaf(vit_setup, family, axes):
    if family == "vit":
        jax_model, variables = vit_setup[:2]
        model = _port_vit(variables)
    else:
        jax_model, variables, model = _tiny_resnets()[:3]
    jax_state = jax_create_train_state(jax_model, variables, jax_default_optimizer(LR))
    jmesh, mesh = _jax_mesh(axes), _mesh(axes)
    want = {c: _jax_state_specs(jax_state, jmesh, c) for c in ("params", "mu", "nu")}
    state = _port_state(model)
    for placed in (False, True):  # the whole state, then the state placed on the mesh
        if placed:
            state, _ = make_train_step(state, mesh=mesh)
        got = state_shardings(mesh, state)
        assert tuple(got["step"].spec) == ()
        for c in ("params", "mu", "nu"):
            specs = {path: tuple(s.spec) for path, s in tree_paths(got[c])}
            assert specs == want[c], c
        if family == "resnet":
            assert all(tuple(s.spec) == () for _, s in tree_paths(got["batch_stats"]))
        else:
            assert got["batch_stats"] is None
    if "tp" in axes:
        assert any(s for s in want["params"].values())  # the Megatron leaves split


def _jax_resnet_step(axes, remat=False, grad_accum=1, batch=8):
    jax_model, variables, _, images, labels = _tiny_resnets(batch=batch)
    state = jax_create_train_state(jax_model, variables, jax_default_optimizer(LR))
    state, step = jax_make_train_step(_jax_mesh(axes), state, remat=remat, grad_accum=grad_accum)
    state, metrics = step(state, images, labels)
    return metrics, resnet_from_jax({"params": _host(state.params),
                                     "batch_stats": _host(state.batch_stats)})


def _port_resnet_step(axes, remat=False, grad_accum=1, batch=8):
    _, variables, model, images, labels = _tiny_resnets(batch=batch)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, step = make_train_step(_port_state(model), mesh=_mesh(axes), remat=remat,
                                  grad_accum=grad_accum)
    state, metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels).long())
    assert state.step == 1
    return metrics, state_dicts(state)[0], before


def _hold_statistics(got, want, before):
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 6  # stem, 2 per block, 1 projection
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
        assert not torch.allclose(got[k], before[k]), k  # the statistics moved


def test_batchnorm_resnet_at_dp2_matches_jax_loss_and_running_statistics():
    """The JAX program normalizes with the statistics of the whole batch;
    so does the port's step at {dp:2}. Each dp shard's own statistics
    would move the running mean and variance elsewhere."""
    axes = {"dp": 2}
    jax_metrics, want = _jax_resnet_step(axes)
    metrics, got, before = _port_resnet_step(axes)
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), atol=1e-5)
    assert float(metrics["accuracy"]) == float(jax_metrics["accuracy"])
    _hold_statistics(got, want, before)
    # Per-shard statistics would differ from the whole batch's by far more
    # than the tolerance: the first BatchNorm's mean over each half.
    _, _, model, images, _ = _tiny_resnets()
    with torch.no_grad():
        stem = model.conv1(torch.from_numpy(images).permute(0, 3, 1, 2))
    halves = [stem[:4].mean(dim=(0, 2, 3)), stem[4:].mean(dim=(0, 2, 3))]
    assert float((halves[0] - halves[1]).abs().max()) > 1e-3


def test_grad_accum_with_batchnorm_remat_at_dp2_sp2_tp2_matches_jax():
    """tests/test_parallel.py:195-211 at the same mesh and switches (remat,
    four microbatches of a batch of 8, BatchNorm statistics chaining
    through them in order, the head split over tp): the port's loss and
    statistics equal JAX's, and the statistics move."""
    axes = {"dp": 2, "sp": 2, "tp": 2}
    jax_metrics, want = _jax_resnet_step(axes, remat=True, grad_accum=4)
    metrics, got, before = _port_resnet_step(axes, remat=True, grad_accum=4)
    assert np.isfinite(float(metrics["loss"]))
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), atol=1e-5)
    _hold_statistics(got, want, before)


def test_grad_accum_2_at_dp2_tp4_equals_the_full_batch(vit_setup):
    axes = {"dp": 2, "tp": 4}
    _, variables, images, labels = vit_setup
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    out = []
    for grad_accum in (1, 2):
        state, step = make_train_step(_port_state(_port_vit(variables)), mesh=_mesh(axes),
                                      grad_accum=grad_accum)
        state, metrics = step(state, x, y)
        out.append((float(metrics["loss"]), state_dicts(state)[0]))
    (loss_a, a), (loss_b, b) = out
    assert loss_b == pytest.approx(loss_a, abs=1e-6)
    for k in a:
        atol = 2 * LR if k.endswith(ZERO_GRAD_SUFFIX) else 1e-6
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=atol, err_msg=k)


def test_grad_accum_divisibility_is_checked_with_the_reference_message(vit_setup):
    _, variables, images, labels = vit_setup
    state, step = make_train_step(_port_state(_port_vit(variables)), mesh=_mesh({"dp": 8}),
                                  grad_accum=3)
    with pytest.raises(ValueError, match=r"batch 8 not divisible by grad_accum=3 x dp=8 \(each "
                                         r"microbatch must still shard evenly over the dp axis\)"):
        step(state, torch.from_numpy(images), torch.from_numpy(labels).long())
    state, step = make_train_step(_port_state(_port_vit(variables)), mesh=_mesh({"dp": 4}),
                                  grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum=2 x dp=4"):
        step(state, torch.from_numpy(images[:4]), torch.from_numpy(labels[:4]).long())
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(_port_state(_port_vit(variables)), mesh=_mesh({"dp": 2}), grad_accum=0)


def test_remat_gives_the_same_parameters(vit_setup):
    _, variables, images, labels = vit_setup
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    out = []
    for remat in (False, True):
        state, step = make_train_step(_port_state(_port_vit(variables)),
                                      mesh=_mesh({"dp": 2, "tp": 2}), remat=remat)
        losses = []
        for _ in range(2):
            state, metrics = step(state, x, y)
            losses.append(float(metrics["loss"]))
        out.append((losses, state_dicts(state)[0]))
    np.testing.assert_allclose(out[1][0], out[0][0], atol=1e-6)
    for k in out[0][1]:
        np.testing.assert_allclose(out[1][1][k].numpy(), out[0][1][k].numpy(), atol=1e-6,
                                   err_msg=k)


def test_mesh_step_at_dp1_equals_the_one_device_step(vit_setup):
    _, variables, images, labels = vit_setup
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    plain, plain_step = make_train_step(_port_state(_port_vit(variables)))
    meshed, mesh_step = make_train_step(_port_state(_port_vit(variables)), mesh=_mesh({"dp": 1}))
    for _ in range(2):
        plain, a = plain_step(plain, x, y)
        meshed, b = mesh_step(meshed, x, y)
        assert float(a["loss"]) == float(b["loss"])
        assert float(a["accuracy"]) == float(b["accuracy"])
    want, got = state_dicts(plain), state_dicts(meshed)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for i, moments in want[1]["state"].items():
        assert torch.equal(got[1]["state"][i]["exp_avg_sq"], moments["exp_avg_sq"])


def _vit_data(step):
    rng = np.random.default_rng(200 + step)
    return (torch.from_numpy(rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, CLASSES, BATCH)))


def test_driver_on_a_mesh_resumes_at_the_saved_step(vit_setup, tmp_path):
    variables = vit_setup[1]
    mesh = _mesh({"dp": 2, "tp": 2})
    straight = TrainingDriver(_port_state(_port_vit(variables)), _vit_data, mesh=mesh)
    straight.run(4)
    ckpt = LocalCheckpointer(tmp_path)
    first = TrainingDriver(_port_state(_port_vit(variables)), _vit_data, ckpt,
                           checkpoint_every=2, mesh=mesh)
    first.run(2)
    other = _port_vit(variables)
    torch.nn.init.zeros_(other.head.weight)  # other weights: the restore must replace them
    resumed = TrainingDriver(_port_state(other), _vit_data, ckpt, checkpoint_every=2, mesh=mesh)
    assert resumed.start_step == 2 and resumed.state.step == 2
    resumed.run(2)
    assert [h["step"] for h in resumed.history] == [3, 4]
    np.testing.assert_allclose([h["loss"] for h in first.history + resumed.history],
                               [h["loss"] for h in straight.history], rtol=0, atol=0)


def test_checkpoint_under_dp2_tp2_restores_one_device_and_back(vit_setup, tmp_path):
    """The payload holds the whole, gathered state: a one-device state
    restores it with equal parameters and moments, and its checkpoint
    restores into a {dp:2, tp:2} state, which steps as the saved one."""
    variables, images, labels = vit_setup[1:]
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    mesh = _mesh({"dp": 2, "tp": 2})
    driver = TrainingDriver(_port_state(_port_vit(variables)), _vit_data,
                            LocalCheckpointer(tmp_path / "mesh"), checkpoint_every=2, mesh=mesh)
    driver.run(2)
    saved_model, saved_opt = state_dicts(driver.state)

    one = LocalCheckpointer(tmp_path / "mesh").restore(_port_state(_port_vit(variables)))[0]
    assert one.layout is None and one.step == 2
    for k, v in saved_model.items():
        assert torch.equal(one.model.state_dict()[k], v), k
    one_opt = one.optimizer.state_dict()
    for i, moments in saved_opt["state"].items():
        assert torch.equal(one_opt["state"][i]["exp_avg"], moments["exp_avg"])

    LocalCheckpointer(tmp_path / "one").save(one, 2)
    back = TrainingDriver(_port_state(_port_vit(variables)), _vit_data,
                          LocalCheckpointer(tmp_path / "one"), mesh=mesh)
    assert back.start_step == 2 and back.state.layout is not None
    got_model, got_opt = state_dicts(back.state)
    for k, v in saved_model.items():
        assert torch.equal(got_model[k], v), k
    _, a = driver.step_fn(driver.state, x, y)
    _, b = back.step_fn(back.state, x, y)
    assert float(a["loss"]) == float(b["loss"])


# ---------------------------------------------------------------------------
# parallel/mesh.py: the sharding helpers and the process layout
# ---------------------------------------------------------------------------


def test_batch_sharding_replicated_and_param_shardings_match_jax(vit_setup):
    variables = vit_setup[1]
    axes = {"dp": 2, "tp": 2}
    mesh = _mesh(axes)
    assert tuple(mesh_lib.batch_sharding(mesh).spec) == ("dp",)
    assert tuple(mesh_lib.batch_sharding(mesh, "tp").spec) == ("tp",)
    assert tuple(mesh_lib.replicated(mesh).spec) == ()
    want = jax.tree_util.tree_flatten_with_path(jax_param_shardings(_jax_mesh(axes), variables))[0]
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec) for path, s in want}
    got = {path: tuple(s.spec) for path, s in tree_paths(mesh_lib.param_shardings(mesh, variables))}
    assert got == want
    no_tp = mesh_lib.param_shardings(_mesh({"dp": 4}), variables)
    assert all(tuple(s.spec) == () for _, s in tree_paths(no_tp))


def test_shard_params_places_one_shard_per_position(vit_setup):
    variables = vit_setup[1]
    mesh = _mesh({"dp": 2, "tp": 2})
    placed = mesh_lib.shard_params(mesh, variables)
    query = placed["params"]["block0"]["attn"]["query"]["kernel"]
    assert isinstance(query, ShardedLeaf) and query.shards.shape == (2, 2)
    assert tuple(query.shards[0, 1].shape) == (32, 16)
    assert torch.equal(query.shards[1, 1], query.shards[0, 1])  # replicated over dp
    for path, leaf in tree_paths(placed):
        np.testing.assert_array_equal(gather_leaf(leaf), dict(tree_paths(variables))[path])
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh_lib.shard_params(_mesh({"tp": 3}), variables)


def _owned(axes, owners):
    """A mesh over CPU positions owned by the ranks ``owners`` (row-major),
    as ``make_mesh`` lays one over the processes of a default group."""
    mesh = _mesh(axes)
    return Mesh(mesh.devices, mesh.axis_names,
                np.asarray(owners).reshape(mesh.devices.shape))


def test_process_layout_refusals():
    """With several processes the dp axis must partition the rows by
    process, each process's coordinates one contiguous run
    (dmlc_tpu/parallel/inference.py:172-198)."""
    mesh = _owned({"dp": 2, "tp": 2}, [0, 0, 1, 1])
    assert mesh.process_count == 2
    assert mesh.local_positions(1) == [(1, 0), (1, 1)]
    assert process_dp_coords(mesh, rank=0) == [0] and process_dp_coords(mesh, rank=1) == [1]
    assert process_dp_coords(_owned({"dp": 4}, [0, 0, 1, 1]), rank=1) == [2, 3]
    with pytest.raises(ValueError, match="must partition rows by process"):
        process_dp_coords(_owned({"dp": 1, "tp": 2}, [0, 1]), rank=0)
    with pytest.raises(ValueError, match="must partition rows by process"):
        process_dp_coords(_owned({"dp": 2, "tp": 2}, [0, 1, 0, 1]), rank=1)
    with pytest.raises(ValueError, match="non-contiguous dp coordinates"):
        process_dp_coords(_owned({"dp": 4}, [0, 1, 1, 0]), rank=0)
    assert process_dp_coords(_mesh({"tp": 2})) == [0]  # one process, no dp axis
    assert _mesh({"dp": 4}).local_positions(rank=3) == [(0,), (1,), (2,), (3,)]


def test_mesh_step_refusals(vit_setup):
    variables = vit_setup[1]
    model = _port_vit(variables)
    sgd = create_train_state(model, torch.optim.SGD(model.parameters(), lr=0.1), device="cpu")
    with pytest.raises(TypeError, match="AdamW"):
        make_train_step(sgd, mesh=_mesh({"dp": 2}))
    state, _ = make_train_step(_port_state(_port_vit(variables)), mesh=_mesh({"dp": 2}))
    with pytest.raises(ValueError, match="pass mesh="):
        make_train_step(state)
    with pytest.raises(ValueError, match="another mesh"):
        make_train_step(state, mesh=_mesh({"dp": 4}))
    two = _owned({"dp": 2}, [0, 1])
    with pytest.raises(ValueError, match="spans 2 processes, the default group has 1"):
        make_train_step(_port_state(_port_vit(variables)), mesh=two)
    with pytest.raises(ValueError, match="does not split 3 ways"):
        make_train_step(_port_state(_port_vit(variables)), mesh=_mesh({"tp": 3}))
    assert PartitionSpec("tp") == ("tp",)
