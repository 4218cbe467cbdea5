"""The port's flash attention (ops/flash.py) on the CPU, where its wrappers
run the plain versions, against the JAX package's Pallas flash attention
run in interpret mode, as tests/test_pallas_kernels.py runs it.

Same numpy-seeded float32 inputs through both:

- ``flash_attention``'s out and its autograd gradients (through ``_Flash``:
  the plain forward, then the plain dq and dkv) against JAX's out and
  ``jax.grad`` through its custom VJP, causal and not, S in {32, 192, 193,
  512}; against the resident forward and against the streamed one (forced
  by shrinking ``_RESIDENT_KV_BYTES`` at test time);
- ``flash_attention_with_lse``'s lse and ``flash_attention_block_bwd``'s
  blockwise gradients against theirs;
- out and gradients at head dim 64 (the registry's other head dim, which
  the kernels are built for beside 128) against the same;
- at head dims 32 and 96, which the public functions zero-pad to 64 and
  128: out and gradients, lse and the blockwise gradients against the
  same; past 128 (160, 192, 256 and 130, padded to 192) the head dims the
  kernels built for 192 and 256 run at, 384 and 512, where float32 runs
  the three kernels built for them, and 576, 640 and 1024, past the 512
  the card once refused, and 712, not a multiple of 64, where all three
  run their kernels that take the head dim at run time in both dtypes;
  which head dim and entry point each (head dim,
  dtype) runs at on the card (``_run_head_dim``, ``_entry_name``: heads in
  (128, 256] padded to 192 or 256 for the three kernels of their own in
  both dtypes, in (256, 512] to the next multiple of 64 for the three of
  their own in both dtypes, past 512 to a multiple of 8 for the three's
  own in both dtypes),
  that padding 160 to 192, 200 to 256, and 264, 330 and 500 to 320, 384
  and 512 is exact in both dtypes' routing, that the forward's and the
  backward's shared memory past 256 fits a block (the kernels past 512 at
  every multiple of 8 up to 2048), and that no head-dim limit is left in
  the sources;
- the same ``ValueError`` for a length with no legal block (the backward's
  block rule in ``flash_attention_block_bwd`` too), and the same
  ``auto_picks_dense`` answers;
- each flash entry point dispatches head dims 64 and 128 in both dtypes
  (bf16 to ``sm90::``, float32 to ``f32::``), the set
  ``KERNEL_HEAD_DIMS``, and 192 and 256 (``SM90_WIDE_HEAD_DIMS``) in both
  dtypes, and 320, 384, 448 and 512 (``FWD_WIDE_HEAD_DIMS``): the forward
  in both dtypes, dQ and dK/dV in float32;
- each fault of ``tools/flash_fault_check.py`` (the paged decode kernel's
  too) and each lever of ``tools/flash_levers.py`` finds its line once in
  its kernel's source;
- every kernel source built on ``csrc/flash_sm90.cuh`` is one that
  ``chip_smoke.py``'s build phase checks, and exports its shared memory.

Tolerances: out and gradients atol 5e-5, rtol 1e-4 (float32 sums taken in
another order and blockwise online softmax against one dense softmax); lse
atol 1e-5.
"""

import ast
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.ops import pallas_kernels as pk
from dmlc_tpu_torch.ops import flash
from dmlc_tpu_torch.ops import kernels as K
from dmlc_tpu_torch.parallel.ring_attention import dense_attention

ATOL, RTOL = 5e-5, 1e-4
LSE_ATOL = 1e-5
B, H, D = 1, 2, 32
LENGTHS = [32, 192, 193, 512]


def _inputs(s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, s, D), dtype=np.float32) for _ in range(4)]


def _ours(q, k, v, g, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash.flash_attention(qt, kt, vt, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    return [t.detach().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]


def _theirs(q, k, v, g, causal):
    def loss(q, k, v):
        out = pk.flash_attention(q, k, v, causal=causal)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _assert_close(got, want, what):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", LENGTHS)
def test_out_and_grads_match_the_resident_forward(s, causal):
    q, k, v, g = _inputs(s)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), f"S={s}")


@pytest.mark.parametrize("s", [193, 256])
def test_out_and_grads_match_at_head_dim_64(s):
    rng = np.random.default_rng(4)
    q, k, v, g = (rng.standard_normal((B, H, s, 64), dtype=np.float32) for _ in range(4))
    _assert_close(_ours(q, k, v, g, True), _theirs(q, k, v, g, True), f"Dh 64 S={s}")


def _heads(s: int, dh: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, s, dh), dtype=np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [32, 193])
@pytest.mark.parametrize("dh", [32, 96])
def test_out_and_grads_match_at_padded_head_dims(dh, s, causal):
    """Head dims the kernels are not built for run zero-padded to the next
    of KERNEL_HEAD_DIMS; the scale stays the original head dim's."""
    q, k, v, g = _heads(s, dh, seed=5)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), f"Dh {dh} S={s}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_lse_and_block_backward_match_at_head_dim_96(causal):
    q, k, v, g = _heads(193, 96, seed=6)
    out, lse = flash.flash_attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                              causal=causal)
    j_out, j_lse = pk.flash_attention_with_lse(q, k, v, causal=causal)
    assert tuple(out.shape) == q.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=LSE_ATOL, rtol=0)
    got = flash.flash_attention_block_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, j_out, j_lse, g)), causal=causal)
    want = pk.flash_attention_block_bwd(q, k, v, j_out, j_lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == q.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name)


def test_kernel_head_dim_is_the_next_one_built():
    for dh in range(1, 130):
        want = 64 if dh <= 64 else 128 if dh <= 128 else None
        assert flash._kernel_head_dim(dh) == want, dh


def test_head_dims_past_128_run_plain_on_the_cpu_and_are_refused_on_the_card():
    """The card takes head dims 513 and 1000 (it refused past 512 before;
    the name is the test's old one): past 512 the head dim pads to a
    multiple of 8 in both dtypes, where all three wrappers run kernels of
    their own (which take the head dim at run time) in both dtypes; a CPU
    tensor runs the plain versions at the same padded head dim; below 256
    float32 pads to 192 or 256 as bf16 does."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert flash._run_head_dim(96) == 128 and flash._run_head_dim(32) == 64
    assert flash._run_head_dim(160) == 192 and flash._run_head_dim(130) == 192
    for dh, run in ((513, 520), (1000, 1000)):
        for dt in (f32, bf16):
            assert flash._run_head_dim(dh) == run
            assert {flash._entry_name(n, run, dt) for n in FLASH_ENTRIES} == set(FLASH_ENTRIES)
    q, k, v, g = _heads(32, 160, seed=7)
    _assert_close(_ours(q, k, v, g, True), _theirs(q, k, v, g, True), "Dh 160")


def test_every_head_dim_up_to_the_wide_limit_runs_on_the_card():
    """No wide limit is left: each head dim in (128, 1100] runs, in both
    dtypes, at a head dim
    that every wrapper has a kernel for: up to 512 at most 63 wider (192 or
    256, then 320, 384, 448 or 512), past it at most 7 wider; past 256
    both dtypes run the three kernels of their own; none at or below 128
    runs wide."""
    for dt in (torch.float32, torch.bfloat16):
        for dh in range(129, 1101):
            run = flash._run_head_dim(dh)
            step = 64 if dh <= 512 else flash.WIDE_HEAD_DIM_STEP
            assert dh <= run < dh + step and run % step == 0, (dh, dt)
            assert all(flash._entry_name(n, run, dt) for n in FLASH_ENTRIES), (dh, dt)
            if 256 < dh:
                assert {n: flash._entry_name(n, run, dt) for n in FLASH_ENTRIES} == OWN, dh
    assert all(flash._entry_name("flash_fwd", dh, dt) in (None, "flash_fwd")
               for dh in range(1, 129) for dt in (torch.float32, torch.bfloat16))


FLASH_ENTRIES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
OWN = {n: n for n in FLASH_ENTRIES}
# (head dim, dtype) -> (the head dim it runs at, the entry point of each
# wrapper there): in (128, 256] the three kernels of their own at 192 or
# 256 in both dtypes (the Hopper designs in bf16, the FMA ones in float32);
# in (256, 512] at the next multiple of 64 the three of their own in both
# dtypes; past 512 at a multiple of 8 the three of their own in both
# dtypes (the kernels that take the head dim at run time).
DISPATCH = {
    (130, "bfloat16"): (192, OWN), (130, "float32"): (192, OWN),
    (160, "bfloat16"): (192, OWN), (160, "float32"): (192, OWN),
    (192, "bfloat16"): (192, OWN), (192, "float32"): (192, OWN),
    (200, "bfloat16"): (256, OWN), (200, "float32"): (256, OWN),
    (256, "bfloat16"): (256, OWN), (256, "float32"): (256, OWN),
    (264, "bfloat16"): (320, OWN), (264, "float32"): (320, OWN),
    (384, "bfloat16"): (384, OWN), (384, "float32"): (384, OWN),
    (449, "bfloat16"): (512, OWN), (449, "float32"): (512, OWN),
    (513, "bfloat16"): (520, OWN), (513, "float32"): (520, OWN),
    (576, "float32"): (576, OWN), (712, "float32"): (712, OWN),
    (1000, "bfloat16"): (1000, OWN), (1000, "float32"): (1000, OWN),
}


@pytest.mark.parametrize("dh, dtype", sorted(DISPATCH))
def test_dispatch_table(dh, dtype):
    run, entries = DISPATCH[dh, dtype]
    dt = getattr(torch, dtype)
    assert flash._run_head_dim(dh) == run
    assert {n: flash._entry_name(n, run, dt) for n in FLASH_ENTRIES} == entries


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dh, causal", [(160, True), (200, False)])
def test_padding_to_the_hopper_head_dims_is_exact(dh, causal, dtype):
    """Heads of 160 and 200 run the three kernels of their own at 192 and
    256 in either dtype: the same inputs, padded by the helpers the card
    uses (``_run_head_dim``, ``_as_heads``), through the
    plain versions at the padded head dim and sliced back, against the JAX
    flash function at the head dim itself (out, lse, dq, dk, dv; float32
    data, so that only the padding differs: tolerances as above)."""
    q, k, v, g = _heads(48, dh, seed=10)
    run = flash._run_head_dim(dh)
    assert run in flash.SM90_WIDE_HEAD_DIMS and run > dh
    q3, k3, v3, g3 = (flash._as_heads(torch.from_numpy(x), run) for x in (q, k, v, g))
    kw = {"causal": causal, "scale": dh ** -0.5}
    out, lse = flash.flash_forward(q3, k3, v3, **kw)
    delta = flash._delta(out, g3)
    dq = flash.flash_bwd_dq(q3, k3, v3, g3, lse, delta, **kw)
    dk, dv = flash.flash_bwd_dkv(q3, k3, v3, g3, lse, delta, **kw)
    got = [flash._from_heads(x, q.shape).numpy() for x in (out, dq, dk, dv)]
    assert all(not x[..., dh:].any() for x in (out, dq, dk, dv))
    _assert_close(got, _theirs(q, k, v, g, causal), f"Dh {dh} padded to {run}")
    _, j_lse = pk.flash_attention_with_lse(q, k, v, causal=causal)
    np.testing.assert_allclose(lse.numpy().reshape(j_lse.shape), np.asarray(j_lse),
                               atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dh, causal", [(264, True), (330, False), (500, True)])
def test_padding_to_the_wide_forward_head_dims_is_exact(dh, causal, dtype):
    """Heads of 264, 330 and 500 run at 320, 384 and 512 the three kernels
    of their own in both dtypes: the same inputs, padded by the helpers
    the card uses, through the plain versions at the padded head dim and
    sliced back, against the JAX flash functions at the head dim itself
    (out, lse, dq, dk, dv; float32 data, tolerances as above)."""
    q, k, v, g = _heads(40, dh, seed=12)
    run, dt = flash._run_head_dim(dh), getattr(torch, dtype)
    assert run in flash.FWD_WIDE_HEAD_DIMS and dh < run < dh + 64
    assert {n: flash._entry_name(n, run, dt) for n in FLASH_ENTRIES} == OWN
    q3, k3, v3, g3 = (flash._as_heads(torch.from_numpy(x), run) for x in (q, k, v, g))
    kw = {"causal": causal, "scale": dh ** -0.5}
    out, lse = flash.flash_forward(q3, k3, v3, **kw)
    delta = flash._delta(out, g3)
    dq = flash.flash_bwd_dq(q3, k3, v3, g3, lse, delta, **kw)
    dk, dv = flash.flash_bwd_dkv(q3, k3, v3, g3, lse, delta, **kw)
    got = [flash._from_heads(x, q.shape).numpy() for x in (out, dq, dk, dv)]
    assert all(not x[..., dh:].any() for x in (out, dq, dk, dv))
    _assert_close(got, _theirs(q, k, v, g, causal), f"Dh {dh} padded to {run}")
    _, j_lse = pk.flash_attention_with_lse(q, k, v, causal=causal)
    np.testing.assert_allclose(lse.numpy().reshape(j_lse.shape), np.asarray(j_lse),
                               atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_out_and_grads_match_past_the_old_limit(causal):
    """Head dim 640, past the 512 the card refused before: the public
    functions (out and gradients) against JAX's Pallas flash attention."""
    q, k, v, g = _heads(32, 640, seed=11)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), "Dh 640")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dh", [576, 712, 1024])
def test_out_and_grads_match_past_head_dim_512(dh, causal):
    """Head dims 576, 712 (not a multiple of 64: the last slab of Dh is
    partly zero) and 1024, beside 640 above, where the forward runs its
    kernels that take the head dim at run time (O cut into two column
    chunks on the card; at 1024 Q streams beside K), and so do dQ and
    dK/dV in float32 (dK/dV in two chunks at 712, three at 1024; dQ in two
    at 1024): the public functions (out and gradients) against JAX's Pallas
    flash attention."""
    q, k, v, g = _heads(24, dh, seed=13)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), f"Dh {dh}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dh", [256, 130, 192, 384, 512])
def test_out_and_grads_match_past_head_dim_128(dh, causal):
    """Head dims past 128 (130 zero-padded to 192; 192 and 256, which the
    three kernels are built for in both dtypes; 384 and 512, where float32
    runs the three kernels built for them) against JAX's Pallas flash
    attention."""
    q, k, v, g = _heads(40, dh, seed=9)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), f"Dh {dh}")


def test_wide_kernels_limit_and_entry_points_are_their_sources():
    """No head-dim limit is left: not in csrc/flash_wide.cu (which takes
    any multiple of 8 past 128) nor in ops/flash.py; each wide entry point
    the wrappers call exists there with its kernel's arguments (text only,
    no nvcc)."""
    root = Path(flash.__file__).resolve().parent.parent
    text = (root / "csrc" / "flash_wide.cu").read_text()
    assert "kWideMaxDh" not in text and "max_head_dim" not in text
    assert "return bh <= 0 || s <= 0 || dh <= 128 || dh % 8 != 0;" in text
    assert flash.WIDE_HEAD_DIM_STEP == 8
    assert "WIDE_MAX_HEAD_DIM" not in (root / "ops" / "flash.py").read_text()
    assert not hasattr(flash, "WIDE_MAX_HEAD_DIM")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        wide = name.replace("flash_", "flash_wide_", 1)
        assert f'extern "C" int dmlc_{wide}(' in text
        assert K._SIGNATURES[wide][1] == K._SIGNATURES[name][1]
        assert K._LIBRARY[wide] == "flash_wide"


@pytest.mark.parametrize("dh, run, dtype", [
    (32, 64, "float32"), (96, 128, "float32"), (64, 64, "float32"), (160, 192, "float32"),
    (130, 192, "float32"), (200, 256, "float32"), (256, 256, "float32"), (264, 320, "float32"),
    (160, 192, "bfloat16"), (200, 256, "bfloat16"), (513, 520, "bfloat16"),
    (160, 192, "float64")])
def test_public_functions_hand_the_wrappers_the_padded_head_dim(dh, run, dtype, monkeypatch):
    """Every public entry point pads q, k, v, out and dO with zero columns
    before the wrappers (which launch the kernels on the card) and slices
    what they return, to the head dim of ``_run_head_dim``, in every
    dtype (float64, which only the CPU takes, pads as the kernels' dtypes
    do)."""
    seen = []

    def spy(fn):
        def call(*args, **kw):
            seen.append((fn.__name__, {a.shape[-1] for a in args if a.dim() == 3 and
                                       a.shape[-1] != 1}))
            return fn(*args, **kw)
        return call

    for name in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(flash, name, spy(getattr(flash, name)))
    q, k, v, g = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in _heads(32, dh, seed=8))
    qg = q.clone().requires_grad_()
    out = flash.flash_attention(qg, k, v, causal=True)
    out.backward(g)
    o2, lse = flash.flash_attention_with_lse(q, k, v, causal=True)
    grads = flash.flash_attention_block_bwd(q, k, v, o2, lse, g, causal=True)
    assert [n for n, _ in seen] == ["flash_forward", "flash_bwd_dq", "flash_bwd_dkv"] * 2
    assert all(dims == {run} for _, dims in seen), seen
    assert all(tuple(x.shape) == (B, H, 32, dh) for x in (out, qg.grad, o2, *grads))
    assert torch.equal(out.detach(), o2)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [192, 512])
def test_out_and_grads_match_the_streamed_forward(s, causal, monkeypatch):
    monkeypatch.setattr(pk, "_RESIDENT_KV_BYTES", 1)
    q, k, v, g = _inputs(s, seed=1)
    _assert_close(_ours(q, k, v, g, causal), _theirs(q, k, v, g, causal), f"streamed S={s}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", LENGTHS)
def test_lse_and_block_backward_match(s, causal):
    q, k, v, g = _inputs(s, seed=2)
    out, lse = flash.flash_attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                              causal=causal)
    j_out, j_lse = pk.flash_attention_with_lse(q, k, v, causal=causal)
    assert tuple(lse.shape) == (B, H, s, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=LSE_ATOL, rtol=0)
    # Blockwise gradients against the same (JAX) out and lse.
    got = flash.flash_attention_block_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, j_out, j_lse, g)), causal=causal)
    want = pk.flash_attention_block_bwd(q, k, v, j_out, j_lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name)


def test_the_same_lengths_are_refused():
    """A length past the single-block cap with no block divisor that is a
    multiple of 8 (8209 is prime) raises the same ValueError in both."""
    x = np.zeros((1, 1, 8209, 16), np.float32)
    with pytest.raises(ValueError, match="pad the sequence"):
        pk.flash_attention(x, x, x)
    t = torch.from_numpy(x)
    for call in (flash.flash_attention, flash.flash_attention_with_lse):
        with pytest.raises(ValueError, match="pad the sequence"):
            call(t, t, t)
    with pytest.raises(ValueError, match="pad the sequence"):
        flash.flash_attention(t, t, t, blk_q=4096)
    # The backward's own rule: the blockwise backward refuses the length too.
    with pytest.raises(ValueError, match="pad the sequence"):
        pk.flash_attention_block_bwd(x, x, x, x, x[..., :1], x)
    with pytest.raises(ValueError, match="pad the sequence"):
        flash.flash_attention_block_bwd(t, t, t, t, t[..., :1], t)
    # An odd length up to the cap runs as one block in both.
    assert flash._auto_block(193, None, 128) == pk._auto_block(193, None, 128) == 193


def test_auto_block_rule_is_the_jax_packages():
    for s in (8, 96, 192, 193, 1000, 1024, 1032, 2048, 4104, 16384):
        for req in (None, 8, 64, 100, 256, 4096):
            for default in (128, 256):
                try:
                    want = pk._auto_block(s, req, default)
                except ValueError:
                    with pytest.raises(ValueError):
                        flash._auto_block(s, req, default)
                else:
                    assert flash._auto_block(s, req, default) == want, (s, req, default)


def test_auto_dispatch_predicate_matches():
    assert flash.AUTO_FLASH_MIN_S == pk.AUTO_FLASH_MIN_S
    assert flash.AUTO_DENSE_SCORES_CAP_BYTES == pk.AUTO_DENSE_SCORES_CAP_BYTES
    for b in (1, 2, 8, 32):
        for h in (1, 6, 12):
            for s in (128, 1024, 2048, 2049, 4095, 4096, 8192):
                assert flash.auto_picks_dense(b, h, s) == pk.auto_picks_dense(b, h, s), (b, h, s)


def test_attention_dispatches_to_dense_below_the_crossover():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(64, seed=3))
    want = dense_attention(q, k, v, causal=True)
    assert torch.equal(flash.attention(q, k, v, causal=True), want)
    np.testing.assert_allclose(flash.flash_attention(q, k, v, causal=True).numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)


def test_gradient_dtypes_follow_the_inputs():
    """dq, dk, dv come back in q's, k's and v's dtype (bfloat16 here)."""
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in _inputs(32))
    flash.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("dh,dtype,entries", [
    (128, torch.bfloat16, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    (256, torch.bfloat16, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    (256, torch.float32, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    (200, torch.float32, ("flash_wide_fwd", "flash_wide_bwd_dq", "flash_wide_bwd_dkv")),
    (320, torch.bfloat16, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    (512, torch.float32, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    (640, torch.bfloat16, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    (1000, torch.float32, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
])
def test_wrappers_count_each_launch_by_entry_point(monkeypatch, dh, dtype, entries):
    """Each flash wrapper counts a launch under (entry point, head dim,
    dtype), the key ``_run`` returns for the entry point it launched;
    ``kernels.launch_counts`` sums them and ``entry_launch_counts`` reads
    them, and one reset clears both. The launch itself is stubbed: no
    card here."""
    launched = []
    monkeypatch.setattr(K, "_entry", lambda entry: (entry, entry))
    monkeypatch.setattr(K, "_launch", lambda first, fn, *args: launched.append(fn) or 0)
    monkeypatch.setattr(flash._build, "check", lambda lib, rc, what: None)
    q = torch.zeros(2, 16, dh, dtype=dtype)
    K.reset_launch_counts()
    for wrapper, entry in zip(("flash_forward", "flash_bwd_dq", "flash_bwd_dkv"), entries):
        name = {"flash_forward": "flash_fwd"}.get(wrapper, wrapper)
        key = flash._run(name, q)
        assert key == (entry, dh, dtype)
        K.KERNELS[wrapper].launches[key] += 1
    assert launched == list(entries)
    assert K.entry_launch_counts() == {(e, dh, dtype): 1 for e in entries}
    assert {K.launch_counts()[n] for n in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")} == {1}
    K.reset_launch_counts()
    assert not K.entry_launch_counts() and K.launch_counts()["flash_forward"] == 0


def test_wrappers_check_operands_and_count_no_cpu_launch():
    K.reset_launch_counts()
    q = torch.zeros(2, 16, 64)
    lse = torch.zeros(2, 16, 1)
    flash.flash_forward(q, q, q, causal=True, scale=0.125)
    flash.flash_bwd_dq(q, q, q, q, lse, lse, causal=True, scale=0.125)
    flash.flash_bwd_dkv(q, q, q, q, lse, lse, causal=True, scale=0.125)
    counts = K.launch_counts()
    assert {counts[n] for n in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")} == {0}
    with pytest.raises(ValueError, match="B\\*H, S, Dh"):
        flash.flash_forward(q[None], q[None], q[None], causal=False, scale=1.0)
    with pytest.raises(ValueError, match="expected"):
        flash.flash_forward(q, q[:, :8], q, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="float32"):
        flash.flash_bwd_dq(q, q, q, q, lse.double(), lse, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="device"):
        flash.flash_forward(q.to("meta"), q.to("meta"), q.to("meta"), causal=False, scale=1.0)


def _tool(name: str = "flash_fault_check"):
    path = Path(flash.__file__).resolve().parent.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("fault", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_f32",
                                   "flash_bwd_dq_f32", "flash_bwd_dkv_f32", "flash_fwd_dh64",
                                   "flash_fwd_dh256", "flash_fwd_s_chunk", "flash_bwd_dkv_dh256",
                                   "flash_bwd_dkv_swap", "flash_bwd_dq_dh256", "flash_bwd_dq_box",
                                   "flash_fwd_f32_dh256", "flash_bwd_dq_f32_dh256",
                                   "flash_bwd_dkv_f32_dh256", "flash_bwd_dkv_f32_dh192",
                                   "flash_bwd_dkv_f32_handoff", "flash_bwd_dq_f32_dh192",
                                   "flash_fwd_dh512", "flash_fwd_s_add", "flash_fwd_f32_dh512",
                                   "flash_fwd_f32_s_add", "flash_bwd_dq_f32_dh512",
                                   "flash_bwd_dq_f32_dp_add", "flash_bwd_dq_f32_last_step",
                                   "flash_bwd_dkv_f32_dh320", "flash_bwd_dkv_f32_dp_add",
                                   "flash_bwd_dkv_f32_last_step", "flash_bwd_dkv_f32_dh512",
                                   "flash_bwd_dkv_f32_handoff_dh512", "flash_fwd_xl_tiles",
                                   "flash_fwd_xl_s_drop", "flash_fwd_xl_chunk_shift",
                                   "flash_fwd_xl_lse_chunk", "flash_fwd_xl_pad",
                                   "flash_fwd_f32_xl_tiles", "flash_fwd_f32_xl_s_drop",
                                   "flash_fwd_f32_xl_chunk_shift", "flash_fwd_f32_xl_lse_chunk",
                                   "flash_fwd_f32_xl_pad", "flash_bwd_dq_f32_xl_dp_drop",
                                   "flash_bwd_dq_f32_xl_split", "flash_bwd_dq_f32_xl_chunk_shift",
                                   "flash_bwd_dq_f32_xl_ragged", "flash_bwd_dq_f32_xl_pad",
                                   "flash_bwd_dkv_f32_xl_s_drop", "flash_bwd_dkv_f32_xl_split",
                                   "flash_bwd_dkv_f32_xl_chunk_shift",
                                   "flash_bwd_dkv_f32_xl_ragged", "flash_bwd_dkv_f32_xl_pad",
                                   "flash_bwd_dq_wide_tiles", "flash_bwd_dq_wide_x_drop",
                                   "flash_bwd_dq_wide_shift", "flash_bwd_dq_wide_ragged",
                                   "flash_bwd_dq_wide_pad", "flash_bwd_dkv_wide_tiles",
                                   "flash_bwd_dkv_wide_s_drop", "flash_bwd_dkv_wide_shift",
                                   "flash_bwd_dkv_wide_ragged", "flash_bwd_dkv_wide_pad",
                                   "flash_bwd_dkv_wide_rank", "flash_bwd_dq_xl_tiles",
                                   "flash_bwd_dq_xl_x_drop", "flash_bwd_dq_xl_chunk_shift",
                                   "flash_bwd_dq_xl_ragged", "flash_bwd_dq_xl_pad",
                                   "flash_bwd_dq_xl_split", "flash_bwd_dkv_xl_tiles",
                                   "flash_bwd_dkv_xl_x_drop", "flash_bwd_dkv_xl_chunk_shift",
                                   "flash_bwd_dkv_xl_ragged", "flash_bwd_dkv_xl_pad",
                                   "flash_bwd_dkv_xl_split"])
def test_fault_check_finds_its_loop_once(fault):
    """flash_fault_check.py plants each fault by replacing one line of its
    kernel's source (or, for the bf16 ``_xl_pad``, of the shared header
    flash_sm90.cuh), and refuses unless that line occurs exactly once: a
    rewrite of the kernel must carry the pattern along (text only, no
    nvcc). Each fault runs the check in its kernel's dtype, at a head dim
    its kernel is built for (192 and 256 too, in both dtypes, the
    forward's 320 and 512, and dQ's and dK/dV's 320, 384 and 512 in both
    dtypes), or, for the kernels past 256 that take the head dim at run time
    (``_xl_``: the forward in both dtypes, dQ and dK/dV in float32), at a
    head dim no kernel is built for (two chunks where the fault needs them:
    the split and chunk-shift faults of dQ at 1024, of dK/dV at 640)."""
    tool = _tool()
    case = tool.FAULTS[fault]
    text = (tool.REPO / "dmlc_tpu_torch" / "csrc" / (case.file or f"{case.source}.cu")).read_text()
    assert text.count(case.old) == 1
    assert case.old != case.new and text.replace(case.old, case.new).count(case.new) == 1
    assert case.file in ("", "flash_sm90.cuh")
    dh = case.shape[3]
    assert case.dtype in ("bfloat16", "float32")
    assert flash._entry_name(case.source, dh, getattr(torch, case.dtype)) == case.source
    assert ("_f32" in fault) == (case.dtype == "float32")
    assert fault.endswith("_dh64") == (dh == 64)
    assert (dh in flash.SM90_WIDE_HEAD_DIMS) == fault.endswith(("_dh256", "_s_chunk", "_swap",
                                                                 "_box", "_handoff", "_dh192"))
    assert dh == 192 or not fault.endswith("_dh192")
    assert (dh in flash.FWD_WIDE_HEAD_DIMS) == fault.endswith((
        "_dh512", "_s_add", "_dp_add", "_last_step", "_dh320", "_wide_tiles", "_wide_x_drop",
        "_wide_shift", "_wide_ragged", "_wide_pad", "_wide_s_drop", "_wide_rank"))
    assert ("_xl_" in fault) == (dh > 256 and dh not in flash.FWD_WIDE_HEAD_DIMS)
    assert case.check == "flash"


@pytest.mark.parametrize("fault", ["paged_past_length", "paged_page0", "paged_split_twice"])
def test_paged_fault_finds_its_line_once(fault):
    """The paged decode kernel's planted faults: one line of
    csrc/paged_decode.cu each, run by chip_smoke.paged_check at a geometry
    it holds (text only, no nvcc)."""
    tool = _tool()
    case = tool.FAULTS[fault]
    text = (tool.REPO / "dmlc_tpu_torch" / "csrc" / f"{case.source}.cu").read_text()
    assert case.source == "paged_decode" and case.check == "paged"
    assert text.count(case.old) == 1
    assert case.old != case.new and text.replace(case.old, case.new).count(case.new) == 1
    geometry, dh = case.shape
    tree = ast.parse((tool.REPO / "chip_smoke.py").read_text())
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "paged_check" in names and geometry in ("lm_wide", "bench_decode") and dh == 128
    assert set(tool.CHECKS) == {"flash", "paged", "gather", "softmax"}


@pytest.mark.parametrize("fault", ["gather_last_chunk", "gather_read_wait", "gather_outside"])
def test_gather_fault_finds_its_line_once(fault):
    """The page gather's planted faults: one line of csrc/gather_pages.cu
    each, in the bulk kernel's path, run by chip_smoke.phase_kernels_gather
    (text only, no nvcc)."""
    tool = _tool()
    case = tool.FAULTS[fault]
    text = (tool.REPO / "dmlc_tpu_torch" / "csrc" / f"{case.source}.cu").read_text()
    assert case.source == "gather_pages" and case.check == "gather" and not case.file
    assert text.count(case.old) == 1
    assert case.old != case.new and text.replace(case.old, case.new).count(case.new) == 1
    bulk = text[text.index("gather_pages_bulk_kernel("):text.index("gather_pages_vec16_kernel(")]
    launch = text[text.index("int launch_gather("):]
    assert case.old in bulk or case.old in launch.split("} else if (aligned)")[0]
    tree = ast.parse((tool.REPO / "chip_smoke.py").read_text())
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"phase_kernels_gather", "gather_exact", "gather_cases"} <= names
    assert "phase_kernels_gather" in tool.CHECKS["gather"][0]


@pytest.mark.parametrize("fault", ["softmax_merge_tie", "softmax_tail", "softmax_nan",
                                   "softmax_pdl_wait"])
def test_softmax_fault_finds_its_line_once(fault):
    """softmax_top1's planted faults: one line of csrc/softmax_top1.cu
    each, on the vector kernel's path, run by
    chip_smoke.phase_kernels_softmax, which holds every case of
    softmax_cases first (text only, no nvcc)."""
    tool = _tool()
    case = tool.FAULTS[fault]
    text = (tool.REPO / "dmlc_tpu_torch" / "csrc" / f"{case.source}.cu").read_text()
    assert case.source == "softmax_top1" and case.check == "softmax" and not case.file
    assert text.count(case.old) == 1
    assert case.old != case.new and text.replace(case.old, case.new).count(case.new) == 1
    vec = text[:text.index("softmax_top1_long_kernel(")]
    assert case.old in vec
    tree = ast.parse((tool.REPO / "chip_smoke.py").read_text())
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"phase_kernels_softmax", "softmax_cases", "softmax_check"} <= names
    assert "phase_kernels_softmax" in tool.CHECKS["softmax"][0]


def _lever_sources_apply(group: str, lever: str) -> None:
    """flash_levers.py makes each variant by replacing text of the group's
    kernel sources and refuses unless each piece occurs exactly once (text
    only, no nvcc); a variant patches only kernels the group times, and one
    with no replacement is the checkout's sources."""
    tool = _tool("flash_levers")
    table = tool.GROUPS[group]
    assert lever in table.order and set(table.levers[lever]) <= set(table.kernels)
    sources = tool.variant_sources(group, lever)
    csrc = tool.REPO / "dmlc_tpu_torch" / "csrc"
    assert set(sources) == {f"{k}.cu" for k in table.levers[lever]}
    for name, text in sources.items():
        pieces = table.levers[lever][name[:-3]]
        assert pieces and all(new in text for _, new in pieces)
        assert text != (csrc / name).read_text()


@pytest.mark.parametrize("lever", ["a", "a0", "b", "c", "bc"])
def test_lever_tool_finds_its_lines_once(lever):
    """The bf16 flash_bwd_dq variants (group dq)."""
    _lever_sources_apply("dq", lever)


@pytest.mark.parametrize("lever", ["ship", "sync", "ring", "rows128", "keys64", "quad"])
def test_f32_lever_tool_finds_its_lines_once(lever):
    """The float32 forward and dK/dV variants (group f32)."""
    _lever_sources_apply("f32", lever)


@pytest.mark.parametrize("lever", ["ship", "ring", "rows32", "keys32", "keys64"])
def test_dq_f32_lever_tool_finds_its_lines_once(lever):
    """The float32 flash_bwd_dq variants (group dq_f32)."""
    _lever_sources_apply("dq_f32", lever)


@pytest.mark.parametrize("lever", ["ship", "split16", "warps8", "split64", "split128"])
def test_paged_lever_tool_finds_its_lines_once(lever):
    """The paged decode kernel's variants (group paged)."""
    _lever_sources_apply("paged", lever)


@pytest.mark.parametrize("lever", ["ship", "warp1", "warp2", "block64", "block256"])
def test_softmax_lever_tool_finds_its_lines_once(lever):
    """softmax_top1's layouts (group softmax), timed at the
    serve shape after every case of chip_smoke.softmax_cases."""
    _lever_sources_apply("softmax", lever)
    tool = _tool("flash_levers")
    assert tool.GROUPS["softmax"].script == "softmax" and "softmax" in tool.SCRIPTS


@pytest.mark.parametrize("lever", ["ctas3", "runs2", "runs8", "nofp", "stamps"])
def test_jpeg_lever_tool_finds_its_lines_once(lever):
    """jpeg_idct's variants (group jpeg), timed on the serve phase's corpus."""
    _lever_sources_apply("jpeg", lever)
    tool = _tool("flash_levers")
    assert tool.GROUPS["jpeg"].script == "jpeg" and "jpeg" in tool.SCRIPTS


@pytest.mark.parametrize("lever", ["vec16", "chunk8k", "chunk32k", "stages3", "blocks1",
                                   "waitall"])
def test_gather_lever_tool_finds_its_lines_once(lever):
    """The page gather's variants (group gather), timed at the two shapes
    of chip_smoke.gather_shapes."""
    _lever_sources_apply("gather", lever)
    tool = _tool("flash_levers")
    assert tool.GROUPS["gather"].shapes == ("lm_wide", "bench_decode")
    assert tool.GROUPS["gather"].script == "gather"


@pytest.mark.parametrize("lever", ["ship", "a", "b", "keys128", "keys64", "stages1"])
def test_wide_lever_tool_finds_its_lines_once(lever):
    """The bf16 forward and dK/dV variants at head dims 192 and 256 (group
    wide)."""
    _lever_sources_apply("wide", lever)


@pytest.mark.parametrize("lever", ["ship", "keys32", "stages1"])
def test_wide_dq_lever_tool_finds_its_lines_once(lever):
    """The bf16 flash_bwd_dq variants at head dims 192 and 256 (group
    wide_dq)."""
    _lever_sources_apply("wide_dq", lever)


@pytest.mark.parametrize("lever", ["ship", "stages1", "stages2", "block", "whole", "whole1",
                                   "keys16", "rows32"])
def test_wide_f32_lever_tool_finds_its_lines_once(lever):
    """The float32 forward variants at head dims 192 and 256 (group
    wide_f32)."""
    _lever_sources_apply("wide_f32", lever)


@pytest.mark.parametrize("lever", ["ship", "whole", "whole_f32", "stages1", "rows32"])
def test_wide_fwd_lever_tool_finds_its_lines_once(lever):
    """The forward's own kernels past head dim 256 in both dtypes (group
    wide_fwd), timed in both."""
    _lever_sources_apply("wide_fwd", lever)
    assert _tool("flash_levers").GROUPS["wide_fwd"].dtype == ("bfloat16", "float32")


@pytest.mark.parametrize("lever", ["ship", "stages1", "stages2", "whole", "parts", "whole1",
                                   "rows32"])
def test_wide_bwd_f32_lever_tool_finds_its_lines_once(lever):
    """The float32 flash_bwd_dq and flash_bwd_dkv variants at head dims
    192 and 256 (group wide_bwd_f32)."""
    _lever_sources_apply("wide_bwd_f32", lever)


@pytest.mark.parametrize("lever", ["ship", "slots2", "vk", "rows64", "keys16",
                                   "dkv_roles", "dkv_split", "rows32"])
def test_xl_bwd_f32_lever_tool_finds_its_lines_once(lever):
    """The float32 flash_bwd_dq and flash_bwd_dkv variants past head dim
    256 (group xl_bwd_f32), timed at the forward's shapes there."""
    _lever_sources_apply("xl_bwd_f32", lever)
    group = _tool("flash_levers").GROUPS["xl_bwd_f32"]
    assert group.dtype == "float32" and {s[3] for s in group.shapes} == {320, 384, 512}


@pytest.mark.parametrize("lever", ["ship", "chunks", "qstream", "slots2", "vstage1", "ring3",
                                   "xl_all"])
def test_xl_fwd_lever_tool_finds_its_lines_once(lever):
    """The forward's variants past head dim 512 in both dtypes (group
    xl_fwd), timed at [4, 4, 1024, 640], [4, 4, 1024, 1024], [8, 1, 2048,
    768] and [4, 4, 1024, 576], head dims the kernels built for a head dim
    do not take, and at ``wide_fwd``'s shapes, where ``xl_all`` runs them
    in place of the kernels built for 320, 384 and 512."""
    _lever_sources_apply("xl_fwd", lever)
    tool = _tool("flash_levers")
    group = tool.GROUPS["xl_fwd"]
    assert group.dtype == ("bfloat16", "float32")
    past = [s for s in group.shapes if s[3] > 512]
    assert len(past) == 4 and all(s[3] % 8 == 0 for s in past)
    assert set(group.shapes) - set(past) == set(tool.GROUPS["wide_fwd"].shapes)


@pytest.mark.parametrize("lever", ["ship", "chunks", "chunks6", "chunks3", "ring3", "qstream",
                                   "kvstream", "rows16", "keys16", "unroll"])
def test_xl_bwd512_lever_tool_finds_its_lines_once(lever):
    """The float32 flash_bwd_dq and flash_bwd_dkv variants past head dim
    512 (group xl_bwd512), timed at [4, 4, 1024, 640], [4, 4, 1024, 1024]
    and [8, 1, 2048, 768], head dims no kernel is built for."""
    _lever_sources_apply("xl_bwd512", lever)
    group = _tool("flash_levers").GROUPS["xl_bwd512"]
    assert group.dtype == "float32" and {s[3] for s in group.shapes} == {640, 1024, 768}
    assert all(dh > 512 and dh % 8 == 0 for (_, _, _, dh), _ in group.checks)



@pytest.mark.parametrize("lever", ["ship", "keys16", "vstage2", "stages3", "cluster320"])
def test_wide_bwd_bf16_lever_tool_finds_its_lines_once(lever):
    """The bf16 flash_bwd_dq and flash_bwd_dkv variants past head dim 256
    (group wide_bwd_bf16), timed at the forward's shapes there and checked
    at S 193 at every head dim they are built for."""
    _lever_sources_apply("wide_bwd_bf16", lever)
    group = _tool("flash_levers").GROUPS["wide_bwd_bf16"]
    assert group.dtype == "bfloat16" and {s[3] for s in group.shapes} == {320, 384, 512}
    assert {shape[3] for shape, _ in group.checks} == set(flash.FWD_WIDE_HEAD_DIMS)


@pytest.mark.parametrize("lever", ["ship", "dkv_cluster", "dq_cluster", "chunks", "keys16",
                                   "rows16", "slots2", "stages3"])
def test_xl_bwd_bf16_lever_tool_finds_its_lines_once(lever):
    """The bf16 flash_bwd_dq and flash_bwd_dkv variants past head dim 512
    (group xl_bwd_bf16: the scores by cluster or made again in each chunk,
    chunk widths, tile rows, ring depths), timed at [4, 4, 1024, 640],
    [4, 4, 1024, 1024] and [8, 1, 2048, 768], head dims no kernel is built
    for, ship first and last."""
    _lever_sources_apply("xl_bwd_bf16", lever)
    group = _tool("flash_levers").GROUPS["xl_bwd_bf16"]
    assert group.dtype == "bfloat16" and {s[3] for s in group.shapes} == {640, 1024, 768}
    assert all(dh > 512 and dh % 8 == 0 for (_, _, _, dh), _ in group.checks)
    assert group.order[0] == group.order[-1] == "ship"

def test_every_hopper_kernel_is_checked_by_the_build_phase():
    """Each csrc/*.cu that includes flash_sm90.cuh is named in
    chip_smoke.SM90_KERNELS (so the build phase reports its registers,
    spills and wgmma/TMA instructions) and exports dmlc_<name>_smem_bytes
    (read there for its shared memory a block). chip_smoke.py is read with
    ast, not imported."""
    tool = _tool()
    tree = ast.parse((tool.REPO / "chip_smoke.py").read_text())
    listed = next(ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign)
                  and any(getattr(tg, "id", None) == "SM90_KERNELS" for tg in node.targets))
    csrc = tool.REPO / "dmlc_tpu_torch" / "csrc"
    hopper = sorted(p.stem for p in csrc.glob("*.cu")
                    if '#include "flash_sm90.cuh"' in p.read_text())
    assert hopper == sorted(listed)
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= set(hopper)
    for name in hopper:
        text = (csrc / f"{name}.cu").read_text()
        assert f'extern "C" int dmlc_{name}_smem_bytes(int dh, int is_bf16)' in text


def test_each_entry_point_dispatches_both_head_dims_in_both_dtypes():
    """Each flash source's C entry point launches a kernel for head dim 64
    and 128 in bf16 (the Hopper kernels, flash::sm90) and in float32 (the
    FMA kernels, flash::f32), each instantiated at the head dim it is
    dispatched for; each also for SM90_WIDE_HEAD_DIMS and
    FWD_WIDE_HEAD_DIMS in both dtypes: the head dims ``_entry_name`` sends
    to them (text only, no nvcc)."""
    assert flash.KERNEL_HEAD_DIMS == (64, 128) and flash.SM90_WIDE_HEAD_DIMS == (192, 256)
    assert flash.FWD_WIDE_HEAD_DIMS == (320, 384, 448, 512)
    csrc = Path(flash.__file__).resolve().parent.parent / "csrc"
    pattern = re.compile(r"if \((!?)is_bf16 && dh == (\d+)\)\s*return \(int\)(sm90::|f32::)?"
                         r"launch_\w+<(\d+)>\(")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        text = (csrc / f"{name}.cu").read_text()
        body = text[text.index(f'extern "C" int dmlc_{name}('):]
        body = body[:body.index("\n}\n")]
        found = set()
        for neg, dh, ns, inst in pattern.findall(body):
            assert dh == inst, (name, dh, inst)
            assert ns == ("f32::" if neg else "sm90::"), (name, ns)
            found.add((neg == "", int(dh)))
        want = {(bf16, dh) for bf16 in (True, False) for dh in flash.KERNEL_HEAD_DIMS}
        wide = {(dt == torch.bfloat16, dh) for dt in (torch.bfloat16, torch.float32)
                for dh in flash.SM90_WIDE_HEAD_DIMS if flash._entry_name(name, dh, dt) == name}
        assert wide == {(bf16, dh) for bf16 in (True, False) for dh in (192, 256)}
        fwd_wide = {(dt == torch.bfloat16, dh) for dt in (torch.bfloat16, torch.float32)
                    for dh in flash.FWD_WIDE_HEAD_DIMS if flash._entry_name(name, dh, dt) == name}
        assert fwd_wide == {(bf16, dh) for bf16 in (True, False) for dh in flash.FWD_WIDE_HEAD_DIMS}
        assert found == want | wide | fwd_wide
        smem = text[text.index(f'extern "C" int dmlc_{name}_smem_bytes('):]
        for bf16, dh in wide | (fwd_wide if name != "flash_fwd" else set()):
            assert f"if (dh == {dh} && {'' if bf16 else '!'}is_bf16) return" in smem


def test_wide_forward_shared_memory_fits_a_block():
    """The forward's shared-memory entry (``dmlc_flash_fwd_smem_bytes``,
    which chip_smoke.py's build phase reads on the card) covers 320, 384,
    448 and 512 in both dtypes, from ``sm90::FwdWideCfg`` (bf16) and
    ``f32::FwdCfg`` (float32); each size, as those configs compute it from
    the lines checked here, is at most the 232448 bytes a block may take
    (text only, no nvcc)."""
    text = (Path(flash.__file__).resolve().parent.parent / "csrc" / "flash_fwd.cu").read_text()
    smem = text[text.index('extern "C" int dmlc_flash_fwd_smem_bytes('):]
    smem = smem[:smem.index("\n}\n")]
    for line in ("constexpr int kWideBQ = 64;", "  static constexpr int BK = 32;  ",
                 "  static constexpr int kStages = 2;  ", "kSplitS = true;         //",
                 "static constexpr uint32_t kX = 128 * (BK / 2) * 4;",
                 "constexpr int kFwdRows = 64;", "constexpr int kFwdKeys = 32;",
                 "  static constexpr int kParts = 2, kStages = 1;",
                 "BQ = DH <= 384 ? kFwdRows : 32, BK = kFwdKeys,"):
        assert text.count(line) == 1, line
    for dh in flash.FWD_WIDE_HEAD_DIMS:
        assert (f"if (dh == {dh}) return (int)(is_bf16 ? sm90::FwdWideCfg<{dh}>::kSmem : "
                f"f32::FwdCfg<{dh}>::bytes);") in smem
        q, kv, x = 64 * dh * 2, 32 * dh * 2, 128 * 16 * 4
        bf16 = q + 2 * 2 * kv + 4 * x + (1 + 3 * 2) * 8 + 1024
        rows, ld = (64 if dh <= 384 else 32), dh + 4
        f32 = 4 * (rows * ld + 2 * 32 * ld + 2 * rows * (32 + 4))
        assert bf16 <= 232448 and f32 <= 232448, (dh, bf16, f32)


def test_forward_past_512_takes_any_multiple_of_8_and_fits_a_block():
    """``dmlc_flash_fwd`` sends every multiple of 8 past 256 that no kernel
    is built for (every one past 512 on the public route) to the kernels
    that take the head dim at run time (``sm90::launch_fwd_xl`` in bf16,
    ``f32::launch_fwd_xl`` in float32), after the kernels built for a head
    dim, and ``dmlc_flash_fwd_smem_bytes`` answers for the same head dims
    from their plans (``XlPlan``). At every multiple of 8 in (256, 2048]
    the plan's shared memory, as the config lines checked here give it,
    fits the 232448 bytes a block may take, and the instantiation it picks
    (the boxes of O of the widest warpgroup or part) is one the launch
    builds (text only, no nvcc)."""
    text = (Path(flash.__file__).resolve().parent.parent / "csrc" / "flash_fwd.cu").read_text()
    entry = text[text.index('extern "C" int dmlc_flash_fwd('):]
    entry = entry[:entry.index("\n}\n")]
    xl = ("  if (dh > 256 && dh % 8 == 0)\n"
          "    return (int)(is_bf16 ? sm90::launch_fwd_xl(q, k, v, out, lse, bh, s, dh, causal, scale, st)\n"
          "                         : f32::launch_fwd_xl(q, k, v, out, lse, bh, s, dh, causal, scale, st));")
    assert xl in entry and entry.index(xl) > entry.index("launch_fwd<512>")
    smem = text[text.index('extern "C" int dmlc_flash_fwd_smem_bytes('):]
    smem = smem[:smem.index("\n}\n")]
    assert ("  if (dh > 256 && dh % 8 == 0)\n    return (int)(is_bf16 ? sm90::XlPlan(dh).bytes() : "
            "f32::XlPlan(dh).bytes());") in smem
    for line in ("  static constexpr int BK = 32, kMaxBoxes = 4;  //",
                 "  static constexpr int kSlots = 4;  ", "  static constexpr int kVStages = 2;  ",
                 "  static constexpr uint32_t kSlot = kKeyBox + kRowBox;  //",
                 "  static constexpr int BQ = 32, BK = 32, RPT = 4;  //",
                 "  static constexpr int kMaxSteps = 6;  ", "  static constexpr int kRing = 2;  ",
                 "  static constexpr int kQResidentSteps = 11;  ",
                 "  static constexpr int LDS = 64 + 4;  "):
        assert text.count(line) == 1, line
    built_bf16 = {int(w) for w in re.findall(r"case (\d): return launch_fwd_xl_w<\1>\(p, mq", text)}
    built_f32 = {int(w) for w in re.findall(r"case (\d): return launch_fwd_xl_w<\1>\(p, q,", text)}
    assert built_bf16 == {3, 4} and built_f32 == {3, 4, 5, 6}
    for dh in range(264, 2049, 8):
        if dh in flash.FWD_WIDE_HEAD_DIMS:
            continue
        nb = -(-dh // 64)
        chunks = -(-nb // 8)  # bf16: at most 4 boxes a warpgroup
        width = -(-(-(-nb // chunks)) // 2)
        slot = 32 * 128 + 64 * 128  # a slab of K and the same of Q, at every width
        v = max(2 * 2 * width * 32 * 128, 2 * width * 64 * 128)
        bf16 = v + 2 * 4 * slot + 4 * 128 * 16 * 4 + (4 * 4 + 2 * 2) * 8 + 1024
        assert width in built_bf16 and bf16 <= 232448, (dh, width, bf16)
        chunks = -(-nb // 12)  # float32: at most 6 steps a part
        widest = -(-nb // chunks)
        width = -(-widest // 2)
        q_res = nb <= 11
        slot = (2 * 32 + (0 if q_res else 2 * 32)) * 68
        f32 = 4 * ((32 * (64 * nb + 4) if q_res else 0) + 32 * (64 * widest + 4) + 2 * slot
                   + 2 * 32 * 36)
        assert width in built_f32 and f32 <= 232448, (dh, width, f32)


@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_float32_backward_is_built_past_256_and_fits_a_block(name):
    """``dmlc_flash_bwd_dq`` and ``dmlc_flash_bwd_dkv`` launch a float32
    kernel at 320, 384, 448 and 512 (``f32::DqCfg<DH, true>``,
    ``f32::DkvCfg<DH, true>``), and their shared-memory entries (which
    chip_smoke.py's build phase reads on the card) name the same; each
    size, as those configs compute it from the lines checked here, is at
    most the 232448 bytes a block may take (text only, no nvcc). The bf16
    kernels there are test_bf16_backward_is_built_past_256_and_fits_a_block's."""
    text = (Path(flash.__file__).resolve().parent.parent / "csrc" / f"{name}.cu").read_text()
    entry = text[text.index(f'extern "C" int dmlc_{name}('):]
    entry = entry[:entry.index("\n}\n")]
    smem = text[text.index(f'extern "C" int dmlc_{name}_smem_bytes('):]
    smem = smem[:smem.index("\n}\n")]
    launch = "launch_dq" if name == "flash_bwd_dq" else "launch_dkv"
    cfg = "DqCfg" if name == "flash_bwd_dq" else "DkvCfg"
    for dh in flash.FWD_WIDE_HEAD_DIMS:
        assert f"if (!is_bf16 && dh == {dh})\n    return (int)f32::{launch}<{dh}>(" in entry
        assert f"if (dh == {dh} && !is_bf16) return (int)f32::{cfg}<{dh}>::bytes;" in smem
        ld = dh + 4
        if name == "flash_bwd_dq":
            assert text.count("  static constexpr int BQ = 32, BK = 32, RPT = BQ / 8;") == 1
            assert text.count("  static constexpr int kTiles = 4; ") == 1
            assert text.count("  static constexpr bool kOneSlot = DH > 384; ") == 1
            size = 4 * (2 * 32 * ld + (1 if dh > 384 else 2) * 32 * ld + 4 * 32 * (32 + 4))
        else:
            assert text.count("  static constexpr int BK = 32, BQ = DH <= 384 ? 32 : 16,") == 1
            assert text.count("  static constexpr bool kSplit = DH <= 384; ") == 1
            bq, tiles = (32, 4) if dh <= 384 else (16, 2)
            size = 4 * (2 * 32 * ld + 2 * bq * ld + 2 * bq + tiles * 32 * (bq + 4))
        assert size <= 232448, (dh, size)


@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_bf16_backward_is_built_past_256_and_fits_a_block(name):
    """``dmlc_flash_bwd_dq`` and ``dmlc_flash_bwd_dkv`` launch a bf16 Hopper
    kernel at 320, 384, 448 and 512 (``sm90::launch_dq_wide``,
    ``sm90::launch_dkv_wide``), and their shared-memory entries (which
    chip_smoke.py's build phase reads on the card) name its config
    (``sm90::DqWideCfg``, ``sm90::DkvWideCfg``); each size, as the config
    computes it from the lines checked here, is at most the 232448 bytes a
    block may take. dK/dV launches its blocks past 320 as clusters of two,
    one column chunk of whole 64-column boxes each, at 320 one block over
    all of Dh (text only, no nvcc)."""
    text = (Path(flash.__file__).resolve().parent.parent / "csrc" / f"{name}.cu").read_text()
    entry = text[text.index(f'extern "C" int dmlc_{name}('):]
    entry = entry[:entry.index("\n}\n")]
    smem = text[text.index(f'extern "C" int dmlc_{name}_smem_bytes('):]
    smem = smem[:smem.index("\n}\n")]
    dq = name == "flash_bwd_dq"
    launch, cfg = ("launch_dq_wide", "DqWideCfg") if dq else ("launch_dkv_wide", "DkvWideCfg")
    for dh in flash.FWD_WIDE_HEAD_DIMS:
        assert f"if (is_bf16 && dh == {dh})\n    return (int)sm90::{launch}<{dh}>(" in entry
        assert f"if (dh == {dh} && is_bf16) return (int)sm90::{cfg}<{dh}>::kSmem;" in smem
    if dq:
        lines = ("constexpr int kDqWideBQ = 64;",
                 "  static constexpr int BK = DH == 320 ? 32 : 16;  // keys a K/V tile",
                 "  static constexpr int kStagesK = 2;              // K ring depth",
                 "  static constexpr int kStagesV = DH == 320 ? 2 : 1;  // V ring depth",
                 "  static constexpr uint32_t kX = 128 * (BK / 2) * 4;  ",
                 "      2 * kQ + (kStagesK + kStagesV) * kKV + 8 * kX + kBars * 8 + 1024;")
    else:
        lines = ("constexpr int kDkvWideBK = 64;", "  static constexpr int BQ = 32;  ",
                 "  static constexpr int kStages = 2;  ",
                 "  static constexpr int kChunks = DH == 320 ? 1 : 2;",
                 "  static constexpr int kCols0 = kChunks == 1 ? DH : 64 * ((DH / 64 + 1) / 2);",
                 "  static constexpr uint32_t kX = 128 * (BQ / 2) * 4;  ",
                 "      2 * kKV + 2 * kStages * kQ + kX + (kChunks == 1 ? 0 : 4 * kX);",
                 "  static constexpr int kBars = 1 + 2 * kStages + 4;",
                 "  static constexpr uint32_t kSmem = kRows + 2 * kStages * BQ * 4 + kBars * 8 + 1024;",
                 "  e = launch_clustered(flash_bwd_dkv_wide_kernel_sm90<DH>, (unsigned)blocks, "
                 "kThreads, C::kSmem,\n                       C::kChunks, stream,")
    for line in lines:
        assert text.count(line) == 1, line
    for dh in flash.FWD_WIDE_HEAD_DIMS:
        if dq:
            bk, stages_v = (32, 2) if dh == 320 else (16, 1)
            q, kv, x = 64 * dh * 2, bk * dh * 2, 128 * (bk // 2) * 4
            size = 2 * q + (2 + stages_v) * kv + 8 * x + (1 + 2 * 2 + 2 * stages_v) * 8 + 1024
        else:
            chunks = 1 if dh == 320 else 2
            cols0 = dh if chunks == 1 else 64 * ((dh // 64 + 1) // 2)  # rank 0's chunk
            assert chunks == 1 or (cols0 <= 256 and dh - cols0 <= cols0)
            kv, q, x = 64 * cols0 * 2, 32 * cols0 * 2, 128 * 16 * 4
            size = (2 * kv + 2 * 2 * q + x + (4 * x if chunks == 2 else 0) + 2 * 2 * 32 * 4
                    + (1 + 2 * 2 + 4) * 8 + 1024)
        assert size <= 232448, (dh, size)


def _xl_chunks(nb: int, chunk: int) -> int:
    """flash_common.cuh's xl_chunks: the least power of two of chunks of at
    most ``chunk`` 64-column steps that covers nb steps."""
    n = 1
    while n * chunk < nb:
        n *= 2
    return n


def _xl_width(nb: int, chunk: int, parts: int) -> int:
    """flash_common.cuh's xl_width: the steps the widest part holds where
    nb 64-column steps are cut into ``_xl_chunks`` chunks, shared by
    ``parts`` parts."""
    chunks = _xl_chunks(nb, chunk)
    return -(-(-(-nb // chunks)) // parts)


@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_float32_backward_past_512_takes_any_multiple_of_8_and_fits_a_block(name):
    """``dmlc_flash_bwd_dq`` and ``dmlc_flash_bwd_dkv`` send every float32
    multiple of 8 past 256 that no kernel is built for (every one past 512
    on the public route) to the kernel that takes the head dim at run time
    (``f32::launch_dq_xl``, ``f32::launch_dkv_xl``), after the kernels
    built for a head dim, and no bf16 one; their shared-memory entries
    answer for the same head dims from the plans (``DqXlPlan``,
    ``DkvXlPlan``), and their width entries name the instantiation. At
    every multiple of 8 in (512, 2048] the plan's shared memory, as the
    config lines checked here give it, fits the 232448 bytes a block may
    take, and the width it picks is one the launch builds: the launch
    instantiates every width from the least to the largest the plans give
    over 5 to 256 slabs (``xl_width_bound``), which this recomputes (text
    only, no nvcc)."""
    text = (Path(flash.__file__).resolve().parent.parent / "csrc" / f"{name}.cu").read_text()
    entry = text[text.index(f'extern "C" int dmlc_{name}('):]
    entry = entry[:entry.index("\n}\n")]
    smem = text[text.index(f'extern "C" int dmlc_{name}_smem_bytes('):]
    smem = smem[:smem.index("\n}\n")]
    dq = name == "flash_bwd_dq"
    launch, plan = ("launch_dq_xl", "DqXlPlan") if dq else ("launch_dkv_xl", "DkvXlPlan")
    outs = "dq" if dq else "dk, dv"
    xl = (f"  if (!is_bf16 && dh > 256 && dh % 8 == 0)\n    return (int)f32::{launch}(q, k, v, dout, "
          f"lse, delta, {outs}, bh, s, dh, causal, scale, st);")
    fixed = "launch_dq<512>" if dq else "launch_dkv<512>"
    assert xl in entry and entry.index(xl) > entry.index(fixed)
    assert (f"  if (!is_bf16 && dh > 256 && dh % 8 == 0) return (int)f32::{plan}(dh).bytes();"
            in smem)
    assert f'extern "C" int dmlc_{name}_xl_width(int dh, int is_bf16)' in text
    assert f"return by_width<{plan}::kMinWidth, {plan}::kMaxWidth>(p.width," in text
    assert text.count("        cluster(xl_cluster(chunks))") == 1
    common = (Path(flash.__file__).resolve().parent.parent / "csrc" / "flash_common.cuh").read_text()
    assert "constexpr int xl_cluster(int chunks) { return chunks < 8 ? chunks : 8; }" in common
    assert "  int n = 1;\n  while (n * chunk < nb) n *= 2;\n  return n;" in common
    if dq:
        lines = ("  static constexpr int BK = 32, BQ = 32, RPT = BQ / 8;  //",
                 "  static constexpr int kMaxSteps = 5;  ", "  static constexpr int kRing = 2;  ",
                 "  static constexpr int kQResidentSteps = 11;  ",
                 "  static constexpr int LDS = 64 + 4;  ", "  static constexpr int LDX = BK + 4,")
        chunk, parts = 10, 2  # dQ: two parts share a chunk's steps
    else:
        lines = ("  static constexpr int BK = 32, BQ = 32, KPT = BK / 8;  //",
                 "  static constexpr int kChunkSteps = 5;  ",
                 "  static constexpr int kRing = 2;  ",
                 "  static constexpr int kKvResidentSteps = 5;  ",
                 "  static constexpr int LDS = 64 + 4;  ", "  static constexpr int LDX = BQ + 4,")
        chunk, parts = 5, 1  # dK/dV by the roles: each part holds a whole chunk
    for line in lines:
        assert text.count(line) == 1, line
    widths = [_xl_width(nb, chunk, parts) for nb in range(5, 257)]
    built = range(min(widths), max(widths) + 1)
    assert min(widths) >= 2
    for dh in range(520, 2049, 8):
        nb = -(-dh // 64)
        cluster = min(_xl_chunks(nb, chunk), 8)  # xl_cluster
        most = -(-nb // cluster)  # the most slabs of the scores a block takes
        tiles = (8 if cluster > 1 else 4) * 32 * 36  # score tiles, and the block's sums
        if dq:
            q_res = most <= 11  # those of Q resident, or Q streamed beside K, V and dO
            share = (2 * 32 + (1 if q_res else 2) * 32) * 68
            size = 4 * ((32 * (64 * most + 4) if q_res else 0) + 2 * 2 * share + tiles)
        else:
            kv_res = most <= 5  # those of K and V resident, or streamed beside Q and dO
            share = (2 * 32 + (0 if kv_res else 2 * 32)) * 68
            size = 4 * ((2 * 32 * (64 * most + 4) if kv_res else 0) + 2 * 2 * share + tiles)
        assert _xl_width(nb, chunk, parts) in built and size <= 232448, (dh, size)



@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_bf16_backward_past_512_takes_any_multiple_of_8_and_fits_a_block(name):
    """``dmlc_flash_bwd_dq`` and ``dmlc_flash_bwd_dkv`` send every bf16
    multiple of 8 past 256 that no kernel is built for (every one past 512
    on the public route) to the Hopper kernel that takes the head dim at
    run time (``sm90::launch_dq_xl``, ``sm90::launch_dkv_xl``), after the
    kernels built for a head dim; their shared-memory entries answer for
    the same head dims from the plans (``sm90::DqXlPlan``,
    ``sm90::DkvXlPlan``), and their width entries name the instantiation.
    At every multiple of 8 from 264 to 2048 that no kernel is built for,
    the plan's chunks, width and shared memory, recomputed here from the
    config lines checked here, fit the 232448 bytes a block may take, both
    as shipped (each chunk's block makes the scores, as few chunks as fit)
    and with ``kCluster`` (a power of two of chunks whose blocks form a
    cluster, dQ's of at most 8 boxes: the lever tool's ``dq_cluster`` and
    ``dkv_cluster``), and the width the shipped plan picks
    is one the launch builds: every width from the least to the largest
    the plans give over 5 to 256 boxes (``xl_width_bound``) (text only, no
    nvcc)."""
    text = (Path(flash.__file__).resolve().parent.parent / "csrc" / f"{name}.cu").read_text()
    entry = text[text.index(f'extern "C" int dmlc_{name}('):]
    entry = entry[:entry.index("\n}\n")]
    smem = text[text.index(f'extern "C" int dmlc_{name}_smem_bytes('):]
    smem = smem[:smem.index("\n}\n")]
    width_entry = text[text.index(f'extern "C" int dmlc_{name}_xl_width('):]
    width_entry = width_entry[:width_entry.index("\n}\n")]
    dq = name == "flash_bwd_dq"
    launch, plan, cfg = (("launch_dq_xl", "DqXlPlan", "DqXlCfg") if dq
                         else ("launch_dkv_xl", "DkvXlPlan", "DkvXlCfg"))
    outs = "dq" if dq else "dk, dv"
    xl = (f"  if (is_bf16 && dh > 256 && dh % 8 == 0)\n    return (int)sm90::{launch}(q, k, v, dout, "
          f"lse, delta, {outs}, bh, s, dh, causal, scale, st);")
    fixed = "sm90::launch_dq_wide<512>" if dq else "sm90::launch_dkv_wide<512>"
    assert entry.count(xl) == 1 and entry.index(xl) > entry.index(fixed)
    assert (f"  if (is_bf16 && dh > 256 && dh % 8 == 0) return (int)sm90::{plan}(dh).bytes();"
            in smem)
    assert f"return is_bf16 ? sm90::{plan}(dh).width : f32::{plan}(dh).width;" in width_entry
    assert "if (dh <= 256 || dh % 8 != 0 || (dh <= 512 && dh % 64 == 0)) return 0;" in width_entry
    assert f"  return by_width<{plan}::kMinWidth, {plan}::kMaxWidth>(p.width, [&](auto w) {{" in text
    boxes = f"{'2 * ' if dq else ''}{cfg}::kMaxBoxes"
    parts = 2 if dq else 1  # dQ: two warpgroups share a chunk's boxes; dK/dV: each holds them all
    lines = (f"        chunks(xl_chunks_of(nb, {boxes}, {cfg}::kCluster)),\n",
             f"        width(xl_width(nb, {boxes}, {parts}, {cfg}::kCluster)),\n",
             f"        cluster({cfg}::kCluster ? xl_cluster(chunks) : 1) {{}}\n",
             "  static constexpr bool kCluster = false;  // the chunks' blocks split the scores over Dh\n")
    if dq:
        lines += ("  static constexpr int BK = 32;            // keys a K/V tile\n",
                  "  static constexpr int kMaxBoxes = 5;      // boxes of dQ a warpgroup holds\n",
                  "  static constexpr int kSlots = 4;         // slabs in flight a warpgroup\n",
                  "  static constexpr int kKStages = 2;       // the chunk's K tiles in flight\n",
                  "  static constexpr int kBars = 4 * DqXlCfg::kSlots + 2 * DqXlCfg::kKStages + 8;\n")
        chunk, cluster_chunk = 10, 8  # boxes a chunk; with kCluster (the lever's)
    else:
        lines += ("  static constexpr int BQ = 32, kMaxBoxes = 5;  // query rows a Q/dO tile; boxes"
                  " of dK, dV a block\n",
                  "  static constexpr int kSlots = 4;        // slabs in flight a warpgroup\n",
                  "  static constexpr int kOStages = 2;      // the chunk's Q/dO tiles in flight\n",
                  "  static constexpr int kBars = 4 * DkvXlCfg::kSlots + 2 * DkvXlCfg::kOStages + 8;\n")
        chunk = cluster_chunk = 5
    for line in lines:
        assert text.count(line) == 1, line
    common = (Path(flash.__file__).resolve().parent.parent / "csrc" / "flash_common.cuh").read_text()
    assert "  return pow2 ? xl_chunks(nb, chunk) : (nb + chunk - 1) / chunk;" in common

    def chunks_and_width(nb: int, cluster: bool) -> tuple[int, int]:
        chunks = _xl_chunks(nb, cluster_chunk) if cluster else -(-nb // chunk)
        return chunks, -(-(-(-nb // chunks)) // parts)

    widths = [chunks_and_width(nb, False)[1] for nb in range(5, 257)]
    built = range(min(widths), max(widths) + 1)
    assert min(widths) >= 2
    rows, slots, stages = 32, 4, 2  # keys (dQ) or query rows (dK/dV) a tile
    bars = (4 * slots + 2 * stages + 8) * 8 + 1024  # and the alignment
    ring = 2 * slots * (64 * 128 + rows * 128)  # a slab of 64 rows and one of the tile's rows
    partial = 128 * (rows // 2) * 4  # a warpgroup's P, dP, P^T or partial
    for dh in range(264, 2049, 8):
        if dh in flash.FWD_WIDE_HEAD_DIMS:
            continue
        nb = -(-dh // 64)
        assert chunks_and_width(nb, False)[1] in built, dh
        for cluster in (False, True):
            chunks, width = chunks_and_width(nb, cluster)
            assert chunks * (cluster_chunk if cluster else chunk) >= nb, dh
            assert width * parts * chunks >= nb, dh
            clustered = cluster and chunks > 1
            # dQ: the chunk's K tiles, or dQ staged; dK/dV: its Q and dO
            # tiles, or dK and dV staged.
            own = max(stages * 2 * width * rows * 128, 2 * width * 64 * 128)
            if dq:
                own += (8 if clustered else 4) * partial
            else:
                own += (5 if clustered else 1) * partial + 2 * stages * rows * 4
            size = own + ring + bars
            assert size <= 232448, (dh, cluster, size)

def test_ab_group_runs_the_parent_first_and_last(tmp_path, monkeypatch):
    """tools/flash_levers.py group ab (an earlier csrc/ against the
    checkout's): every script of the tool parses here (text only, no
    nvcc); with --parent it runs parent, ship, ship, parent, each in a copy
    of its own, the parent's with the earlier sources, through the ab
    script; and it refuses a --parent that holds no .cu source."""
    tool = _tool("flash_levers")
    for name, script in tool.SCRIPTS.items():
        compile(script, f"flash_levers.{name}", "exec")
    parent = tmp_path / "csrc"
    parent.mkdir()
    (parent / "flash_fwd.cu").write_text("// an earlier source\n")
    copies, scripts = [], []

    def run(cmd, **kw):
        scripts.append(cmd[2])
        return tool.subprocess.CompletedProcess(cmd, 0, '{"card": "none"}\n', "")

    monkeypatch.setattr(tool, "copy_port", lambda dest, sources: copies.append(
        (dest.name, sorted(sources))))
    monkeypatch.setattr(tool.subprocess, "run", run)
    out = tmp_path / "runs"
    assert tool.main(["flash_levers.py", str(out), "ab", "--parent", str(parent)]) == 0
    assert copies == [("0_parent0", ["flash_fwd.cu"]), ("1_ship", []), ("2_ship", []),
                      ("3_parent0", ["flash_fwd.cu"])]
    assert scripts == [tool.RUN_AB] * 4
    with pytest.raises(SystemExit):
        tool.main(["flash_levers.py", str(out), "ab", "--parent", str(tmp_path / "runs")])
