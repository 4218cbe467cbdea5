"""The port's training path on the CPU against the JAX package's, on the same
numpy-seeded inputs and carried weights:

- ``TransformerLM(schedule="flash")`` logits against
  ``SPTransformerLM(schedule="flash")`` (Pallas interpret mode) at
  tests/test_sp_transformer.py's sizes: atol 3e-5, rtol 1e-4 (that test's
  own bound between schedules);
- one LM step's loss and every gradient against ``jax.value_and_grad`` of
  the same loss (at these sizes and at lm_small's width, heads of 64):
  loss atol 1e-5, gradients atol 2e-6 + rtol 1e-4; three AdamW steps'
  losses against optax: atol 1e-5 (float32 sums in another
  order, through two layers and the flash backward);
- ``make_train_step`` on a tiny ResNet: loss atol 1e-5 and the BatchNorm
  running statistics after one step (flax's biased variance) atol 1e-5;
- ``grad_accum=2`` equal to one full batch (atol 1e-6), the divisibility
  ``ValueError``, ``remat`` equal to no remat with BatchNorm statistics
  moved once;
- ``make_train_step`` on a tiny ViT (tests/test_torch_vit.py's sizes,
  float32, no BatchNorm): the first step's loss and every gradient
  against ``jax.value_and_grad`` (loss atol 1e-5, gradients atol 2e-6 +
  rtol 1e-4), three ``default_optimizer`` steps against
  ``optax.adamw(1e-3, weight_decay=1e-4)`` (each loss and the loss after,
  atol 1e-5), and ``remat`` giving the parameters of no remat (atol 1e-6);
- checkpoints: a ``TrainingDriver`` restart resumes at the saved step and
  ends where an uninterrupted run ends (exactly), locally and through an
  SDFS-style client, and the sequence-parallel schedules are refused
  without a mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from dmlc_tpu.models.resnet import BasicBlock as JaxBasicBlock
from dmlc_tpu.models.resnet import ResNet as JaxResNet
from dmlc_tpu.parallel import create_train_state as jax_create_train_state
from dmlc_tpu.parallel import make_mesh
from dmlc_tpu.parallel import make_train_step as jax_make_train_step
from dmlc_tpu.models.vit import ViT as JaxViT
from dmlc_tpu.parallel.sp_transformer import SPTransformerLM
from dmlc_tpu_torch.models.convert import lm_from_jax, resnet_from_jax, vit_from_jax
from dmlc_tpu_torch.models.lm import TransformerLM, lm_small
from dmlc_tpu_torch.models.resnet import BasicBlock, ResNet
from dmlc_tpu_torch.models.vit import ViT
from dmlc_tpu_torch.parallel.train import (
    create_train_state,
    cross_entropy,
    default_optimizer,
    lm_loss,
    lm_train_step,
    make_train_step,
)
from dmlc_tpu_torch.parallel.trainer import TrainingDriver
from dmlc_tpu_torch.utils.checkpoint import (
    CheckpointNotFound,
    LocalCheckpointer,
    SdfsCheckpointer,
    latest_local,
)

VOCAB, LAYERS, HEADS, HIDDEN, MLP = 32, 2, 4, 32, 64
B, S = 4, 32


def _jax_lm(schedule):
    return SPTransformerLM(vocab=VOCAB, num_layers=LAYERS, num_heads=HEADS, hidden=HIDDEN,
                           mlp_dim=MLP, max_len=S, schedule=schedule)


def _torch_lm(schedule):
    return TransformerLM(vocab=VOCAB, num_layers=LAYERS, num_heads=HEADS, hidden=HIDDEN,
                         mlp_dim=MLP, max_len=S, schedule=schedule)


@pytest.fixture(scope="module")
def lm_setup():
    tokens = np.random.default_rng(0).integers(0, VOCAB, (B, S + 1)).astype(np.int32)
    variables = _jax_lm("dense").init(jax.random.PRNGKey(1), jnp.asarray(tokens[:, :-1]))
    return tokens, jax.tree_util.tree_map(np.asarray, variables)


def _ported(variables, schedule="flash"):
    model = _torch_lm(schedule)
    model.load_state_dict(lm_from_jax(variables))
    return model


def test_flash_lm_logits_match_the_jax_flash_lm(lm_setup):
    tokens, variables = lm_setup
    x = tokens[:, :-1]
    want = np.asarray(jax.jit(_jax_lm("flash").apply)(variables, x))
    with torch.no_grad():
        got = _ported(variables)(torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    with torch.no_grad():
        auto = _ported(variables, "auto")(torch.from_numpy(x).long()).numpy()
    np.testing.assert_allclose(auto, want, atol=3e-5, rtol=1e-4)


def _jax_lm_loss(params, tokens):
    logits = _jax_lm("flash").apply(params, tokens[:, :-1])
    return optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), tokens[:, 1:]).mean()


def test_lm_step_loss_and_every_gradient_match_value_and_grad(lm_setup):
    tokens, variables = lm_setup
    loss, grads = jax.value_and_grad(_jax_lm_loss)(variables, jnp.asarray(tokens))
    want = lm_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    model = _ported(variables)
    got_loss = lm_loss(model, torch.from_numpy(tokens).long())
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), atol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=name)


def test_three_adamw_steps_follow_optax(lm_setup):
    tokens, variables = lm_setup
    tx = optax.adamw(1e-3, weight_decay=1e-4)

    @jax.jit
    def step(params, opt_state, toks):
        loss, grads = jax.value_and_grad(_jax_lm_loss)(params, toks)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params, opt_state, want = variables, tx.init(variables), []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tokens))
        want.append(float(loss))
    model = _ported(variables)
    opt = default_optimizer(model.parameters(), lr=1e-3)
    batch = torch.from_numpy(tokens).long()
    got = [float(lm_train_step(model, opt, batch, device="cpu")) for _ in range(3)]
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[-1] < got[0]
    with torch.no_grad():
        after = lm_loss(model, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(float(after), float(_jax_lm_loss(params, jnp.asarray(tokens))),
                               atol=1e-5)


def test_flash_lm_at_lm_small_width_matches_the_jax_flash_lm():
    """lm_small as the port's registry builds it (hidden 128, 2 heads of 64,
    MLP 256, vocab 1024, max_len 256; the head dim the kernels serve beside
    128) with the flash schedule, at S 64, B 2: its logits and one step's
    loss and gradients against SPTransformerLM's flash schedule at that
    width, at the tolerances above."""
    vocab, layers, heads, hidden, mlp, max_len, s, b = 1024, 2, 2, 128, 256, 256, 64, 2

    def jax_lm(schedule):
        return SPTransformerLM(vocab=vocab, num_layers=layers, num_heads=heads, hidden=hidden,
                               mlp_dim=mlp, max_len=max_len, schedule=schedule)

    tokens = np.random.default_rng(5).integers(0, vocab, (b, s + 1)).astype(np.int32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_lm("dense").init(jax.random.PRNGKey(6), jnp.asarray(tokens[:, :-1])))

    def loss_fn(params, toks):
        logits = jax_lm("flash").apply(params, toks[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), toks[:, 1:]).mean()

    want_logits = np.asarray(jax.jit(jax_lm("flash").apply)(variables, tokens[:, :-1]))
    loss, grads = jax.value_and_grad(loss_fn)(variables, jnp.asarray(tokens))
    want = lm_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    model = lm_small(schedule="flash")
    model.load_state_dict(lm_from_jax(variables))
    batch = torch.from_numpy(tokens).long()
    with torch.no_grad():
        got_logits = model(batch[:, :-1]).numpy()
    np.testing.assert_allclose(got_logits, want_logits, atol=3e-5, rtol=1e-4)
    got_loss = lm_loss(model, batch)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), atol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=name)


def test_sequence_parallel_schedules_are_refused():
    """Without a mesh the sp schedules are refused (they run over one:
    tests/test_torch_sp.py), as is a name outside the six."""
    for schedule in ("ring", "ring_flash", "ulysses"):
        with pytest.raises(ValueError, match="mesh"):
            _torch_lm(schedule)
    with pytest.raises(ValueError, match="schedule must be one of"):
        _torch_lm("sparse")


# ---------------------------------------------------------------------------
# make_train_step on a BatchNorm model
# ---------------------------------------------------------------------------


def _tiny_resnets():
    jax_model = JaxResNet(stage_sizes=[1, 1], block_cls=JaxBasicBlock, num_classes=10,
                          num_filters=8, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_model.init(jax.random.PRNGKey(2), images, train=False))
    model = ResNet([1, 1], BasicBlock, num_classes=10, num_filters=8, dtype=torch.float32)
    model.load_state_dict(resnet_from_jax(variables))
    return jax_model, variables, model, images, labels


def test_resnet_step_loss_and_batch_stats_match_flax():
    jax_model, variables, model, images, labels = _tiny_resnets()
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    jstate, jstep = jax_make_train_step(mesh, jax_create_train_state(jax_model, variables, tx))
    jstate, jmetrics = jstep(jstate, images, labels)

    state, step = make_train_step(create_train_state(model, device="cpu"))
    state, metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels).long())
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(jmetrics["accuracy"]), atol=1e-6)
    want = resnet_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                            "batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)})
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 6  # stem, 2 per block, 1 projection
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_remat_changes_memory_not_math():
    _, _, model_a, images, labels = _tiny_resnets()
    _, _, model_b, _, _ = _tiny_resnets()
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    sa, step_a = make_train_step(create_train_state(model_a, device="cpu"))
    sb, step_b = make_train_step(create_train_state(model_b, device="cpu"), remat=True)
    _, ma = step_a(sa, x, y)
    _, mb = step_b(sb, x, y)
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), abs=1e-6)
    a, b = model_a.state_dict(), model_b.state_dict()
    for k in a:  # BatchNorm statistics moved once, not twice
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# make_train_step on a ViT (no BatchNorm)
# ---------------------------------------------------------------------------

VIT = {"patch_size": 8, "hidden_size": 64, "num_layers": 2, "num_heads": 4, "mlp_dim": 128}
VIT_IMAGE, VIT_CLASSES, VIT_BATCH = 32, 10, 8


@pytest.fixture
def one_torch_thread():
    """A tiny ViT's step is many small ops: one intra-op thread runs them
    faster than a pool and keeps a parallel test run's workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def vit_setup():
    """A tiny ViT (tests/test_torch_vit.py's sizes) in float32 with flax's
    initial weights, a numpy batch, and the JAX step's loss and gradients,
    three optax.adamw(1e-3, weight_decay=1e-4) steps' losses and the loss
    after them, once."""
    jax_model = JaxViT(num_classes=VIT_CLASSES, dtype=jnp.float32, **VIT)
    rng = np.random.default_rng(8)
    images = rng.standard_normal((VIT_BATCH, VIT_IMAGE, VIT_IMAGE, 3)).astype(np.float32)
    labels = rng.integers(0, VIT_CLASSES, VIT_BATCH).astype(np.int32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_model.init(jax.random.PRNGKey(9), images, train=False))

    def loss_fn(params, x, y):
        logits = jax_model.apply({"params": params}, x, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    tx = optax.adamw(1e-3, weight_decay=1e-4)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params, opt_state, losses = variables["params"], tx.init(variables["params"]), []
    for i in range(3):
        params, opt_state, loss, grads = step(params, opt_state, images, labels)
        losses.append(float(loss))
        if i == 0:
            first_grads = vit_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    after = float(jax.jit(loss_fn)(params, images, labels))
    return variables, images, labels, first_grads, losses, after


def _port_vit(variables):
    model = ViT(num_classes=VIT_CLASSES, dtype=torch.float32, image_size=VIT_IMAGE, **VIT)
    model.load_state_dict(vit_from_jax(variables))
    return model


@pytest.mark.usefixtures("one_torch_thread")
def test_vit_first_step_loss_and_every_gradient_match_value_and_grad(vit_setup):
    variables, images, labels, want, losses, _ = vit_setup
    model = _port_vit(variables)
    state, step = make_train_step(create_train_state(model, device="cpu"))
    grads = {}
    for name, p in model.named_parameters():  # read each gradient before the update
        p.register_post_accumulate_grad_hook(lambda p, name=name: grads.update({name: p.grad.clone()}))
    state, metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(metrics["loss"]), losses[0], atol=1e-5)
    assert set(grads) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=name)


def _vit_steps(variables, images, labels, remat=False, steps=3):
    model = _port_vit(variables)
    assert not list(model.buffers())  # nothing for remat to put back
    state, step = make_train_step(create_train_state(model, device="cpu"), remat=remat)
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    losses = []
    for _ in range(steps):
        state, metrics = step(state, x, y)
        losses.append(float(metrics["loss"]))
    assert state.step == steps
    return model, losses


@pytest.mark.usefixtures("one_torch_thread")
def test_vit_three_default_optimizer_steps_follow_optax(vit_setup):
    """Three make_train_step steps against optax: each step's loss and the
    loss after them, atol 1e-5 (parameters are not compared: Adam's first
    steps scale a gradient element near zero, rounding noise on both
    sides, to a step of up to lr)."""
    variables, images, labels, _, want_losses, want_after = vit_setup
    model, losses = _vit_steps(variables, images, labels)
    np.testing.assert_allclose(losses, want_losses[:3], atol=1e-5)
    assert losses[-1] < losses[0]
    with torch.no_grad():
        after = cross_entropy(model(torch.from_numpy(images)), torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(after), want_after, atol=1e-5)


@pytest.mark.usefixtures("one_torch_thread")
def test_vit_remat_gives_the_same_parameters(vit_setup):
    variables, images, labels = vit_setup[:3]
    plain, plain_losses = _vit_steps(variables, images, labels)
    remat, remat_losses = _vit_steps(variables, images, labels, remat=True)
    np.testing.assert_allclose(remat_losses, plain_losses, atol=1e-6)
    a, b = plain.state_dict(), remat.state_dict()
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-6, err_msg=k)


class _Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(12, 16), nn.Linear(16, 5)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def _mlp_batch():
    rng = np.random.default_rng(4)
    return (torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 5, 8)))


def test_grad_accum_equals_one_full_batch():
    torch.manual_seed(0)
    a = _Mlp()
    b = _Mlp()
    b.load_state_dict(a.state_dict())
    x, y = _mlp_batch()
    sa, step_a = make_train_step(create_train_state(a, device="cpu"))
    sb, step_b = make_train_step(create_train_state(b, device="cpu"), grad_accum=2)
    _, ma = step_a(sa, x, y)
    _, mb = step_b(sb, x, y)
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), abs=1e-6)
    for pa, pb in zip(a.parameters(), b.parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(), atol=1e-6)


def test_training_refuses_a_model_off_its_device():
    state = create_train_state(_Mlp(), device="cpu")
    assert state.device == torch.device("cpu")
    state.model.to("meta")
    with pytest.raises(ValueError, match="not on cpu"):
        make_train_step(state)
    model = _torch_lm("flash").to("meta")
    opt = default_optimizer(model.parameters())
    with pytest.raises(ValueError, match="lm_train_step"):
        lm_train_step(model, opt, torch.zeros(1, S + 1, dtype=torch.long), device="cpu")


def test_grad_accum_divisibility_checked():
    x, y = _mlp_batch()
    state, step = make_train_step(create_train_state(_Mlp(), device="cpu"), grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum"):
        step(state, x, y)  # batch 8 over 3 microbatches
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(create_train_state(_Mlp(), device="cpu"), grad_accum=0)


# ---------------------------------------------------------------------------
# checkpoints and TrainingDriver
# ---------------------------------------------------------------------------


def _fresh(seed):
    torch.manual_seed(seed)
    return create_train_state(_Mlp(), device="cpu")


def _data(step):
    rng = np.random.default_rng(100 + step)
    return (torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 5, 8)))


class _FakeSdfs:
    """put_bytes/get_bytes over a dict of versions, as the SDFS client."""

    def __init__(self):
        self.files: dict[str, list[bytes]] = {}

    def put_bytes(self, data, name):
        self.files.setdefault(name, []).append(bytes(data))
        return {"version": len(self.files[name])}

    def get_bytes(self, name, version=None):
        versions = self.files[name]
        v = len(versions) if version is None else version
        return v, versions[v - 1]


@pytest.mark.parametrize("store", ["local", "sdfs"])
def test_driver_restart_resumes_at_the_saved_step(store, tmp_path):
    straight = TrainingDriver(_fresh(0), _data)
    straight.run(5)
    ckpt = LocalCheckpointer(tmp_path) if store == "local" else SdfsCheckpointer(_FakeSdfs())
    first = TrainingDriver(_fresh(0), _data, ckpt, checkpoint_every=2)
    first.run(3)  # checkpoints at steps 2 and 3
    if store == "local":
        assert latest_local(tmp_path)[0] == 3
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "checkpoint_00000002.pt", "checkpoint_00000003.pt"]
    else:
        assert len(ckpt.sdfs.files["checkpoints/train_state"]) == 2
    resumed = TrainingDriver(_fresh(1), _data, ckpt, checkpoint_every=2)
    assert resumed.start_step == 3 and resumed.state.step == 3
    resumed.run(2)
    assert [h["step"] for h in resumed.history] == [4, 5]
    assert [h["loss"] for h in first.history + resumed.history] == [
        h["loss"] for h in straight.history]
    for pa, pb in zip(straight.state.model.parameters(), resumed.state.model.parameters()):
        assert torch.equal(pa, pb)


def test_sdfs_checkpointer_refuses_missing_and_foreign_files():
    client = _FakeSdfs()
    ckpt = SdfsCheckpointer(client)
    with pytest.raises(CheckpointNotFound):
        ckpt.restore(_fresh(0))
    client.put_bytes(b"not a checkpoint", "checkpoints/train_state")
    with pytest.raises(ValueError, match="not a dmlc checkpoint"):
        ckpt.restore(_fresh(0))
    assert TrainingDriver(_fresh(0), _data, SdfsCheckpointer(_FakeSdfs())).start_step == 0
