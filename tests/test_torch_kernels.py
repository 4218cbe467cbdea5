"""The port's normalize_u8 / softmax_top1 against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py); the JAX kernels run in Pallas interpret mode, as the JAX
package's own tests run them. Inputs come from numpy seeds and go to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.ops import pallas_kernels as pk
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops import preprocess as tpp

# normalize: the two packages compute x * scale + bias from identical
# float32 constants; the only licence is one rounding of the product-add
# (a fused multiply-add on one side), i.e. 1 ulp of the output type at the
# output's magnitude (|y| < 4: 2**-22 in float32, 2**-6 in bfloat16).
F32_ATOL = 2.0**-22
BF16_ATOL = 2.0**-6
# softmax_top1: indices exactly; the probability 1/sum(exp(x - max)) sums in
# another order, so a relative 1e-6.
PROB_RTOL = 1e-6


def _batch(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize(
    "shape,stats",
    [
        ((4, 32, 32, 3), (tpp.IMAGENET_MEAN, tpp.IMAGENET_STD)),
        ((2, 16, 24, 3), (tpp.CLIP_MEAN, tpp.CLIP_STD)),
        ((3, 5, 7, 3), (tpp.IMAGENET_MEAN, tpp.IMAGENET_STD)),
    ],
)
def test_normalize_f32_matches_pallas(shape, stats):
    batch = _batch(0, shape)
    mean, std = stats
    want = np.asarray(pk.normalize_u8(batch, mean, std, jnp.float32))
    got = kernels.normalize_u8(torch.from_numpy(batch), mean, std, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)


def test_normalize_bf16_matches_pallas():
    batch = _batch(1, (2, 16, 16, 3))
    want = np.asarray(
        pk.normalize_u8(batch, tpp.IMAGENET_MEAN, tpp.IMAGENET_STD, jnp.bfloat16), np.float32
    )
    got = kernels.normalize_u8(
        torch.from_numpy(batch), tpp.IMAGENET_MEAN, tpp.IMAGENET_STD, torch.bfloat16
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_ATOL)


def test_normalize_bf16_is_one_rounding_of_f32():
    """Writing bf16 directly equals normalizing to f32 and casting once —
    the rounding the JAX engine applies when its model casts the image."""
    batch = torch.from_numpy(_batch(2, (2, 8, 8, 3)))
    f32 = kernels.normalize_u8(batch, tpp.IMAGENET_MEAN, tpp.IMAGENET_STD, torch.float32)
    bf16 = kernels.normalize_u8(batch, tpp.IMAGENET_MEAN, tpp.IMAGENET_STD, torch.bfloat16)
    assert torch.equal(f32.to(torch.bfloat16), bf16)


def test_normalize_matches_host_formula():
    batch = _batch(3, (2, 8, 8, 3))
    got = kernels.normalize_u8(torch.from_numpy(batch), tpp.IMAGENET_MEAN, tpp.IMAGENET_STD)
    want = tpp.normalize(torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * F32_ATOL)


@pytest.mark.parametrize(
    "bad,err",
    [
        (torch.zeros(2, 4, 4, 3, dtype=torch.float32), TypeError),
        (torch.zeros(4, 4, 3, dtype=torch.uint8), ValueError),
        (torch.zeros(2, 4, 4, 3, dtype=torch.uint8).transpose(1, 2), ValueError),
    ],
)
def test_normalize_rejects_bad_input(bad, err):
    with pytest.raises(err):
        kernels.normalize_u8(bad, tpp.IMAGENET_MEAN, tpp.IMAGENET_STD)


def test_normalize_rejects_mismatched_stats_and_dtype():
    batch = torch.zeros(1, 2, 2, 3, dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.normalize_u8(batch, [0.5, 0.5], [0.2, 0.2])
    with pytest.raises(TypeError):
        kernels.normalize_u8(batch, tpp.IMAGENET_MEAN, tpp.IMAGENET_STD, torch.float16)


def _check_top1(logits: np.ndarray):
    want_idx, want_prob = (np.asarray(a) for a in pk.softmax_top1(jnp.asarray(logits)))
    idx, prob = kernels.softmax_top1(torch.from_numpy(logits))
    assert idx.dtype == torch.int32 and prob.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(prob.numpy(), want_prob, rtol=PROB_RTOL)
    return idx.numpy(), prob.numpy()


@pytest.mark.parametrize("shape,scale", [((32, 1000), 4.0), ((7, 10), 1.0), ((3, 1), 1.0)])
def test_softmax_top1_matches_pallas(shape, scale):
    logits = (np.random.default_rng(4).normal(size=shape) * scale).astype(np.float32)
    _check_top1(logits)


def test_softmax_top1_ties_pick_first_index():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(6, 50)).astype(np.float32)
    for r, cols in enumerate([(3, 7), (0, 49), (10, 11, 12), (48, 49), (5, 40)]):
        logits[r, list(cols)] = logits[r].max() + 1.0
    logits[5] = 0.25  # a whole row tied
    idx, _ = _check_top1(logits)
    np.testing.assert_array_equal(idx, [3, 0, 10, 48, 5, 0])


def test_softmax_top1_extreme_logits_stable():
    logits = np.array([[1e4, -1e4, 0.0, 9.9e3], [-1e4, -1e4, -1e4, 1e4]], np.float32)
    idx, prob = _check_top1(logits)
    np.testing.assert_array_equal(idx, [0, 3])
    assert np.isfinite(prob).all() and (prob > 0).all() and (prob <= 1).all()


@pytest.mark.parametrize(
    "bad,err",
    [
        (torch.zeros(4, 10, dtype=torch.float64), TypeError),
        (torch.zeros(4, dtype=torch.float32), ValueError),
        (torch.zeros(4, 0, dtype=torch.float32), ValueError),
        (torch.zeros(10, 4, dtype=torch.float32).t(), ValueError),
    ],
)
def test_softmax_top1_rejects_bad_input(bad, err):
    with pytest.raises(err):
        kernels.softmax_top1(bad)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    kernels.reset_launch_counts()
    batch = torch.from_numpy(_batch(6, (1, 4, 4, 3)))
    x = kernels.normalize_u8(batch, tpp.IMAGENET_MEAN, tpp.IMAGENET_STD)
    assert torch.equal(x, kernels.normalize_u8_reference(batch, tpp.IMAGENET_MEAN, tpp.IMAGENET_STD))
    logits = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    got, want = kernels.softmax_top1(logits), kernels.softmax_top1_reference(logits)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launch_counts() == {"normalize_u8": 0, "softmax_top1": 0, "gather_kv_pages": 0,
                                       "paged_decode_attention": 0, "flash_forward": 0,
                                       "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
