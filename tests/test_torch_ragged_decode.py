"""The port's page gather and decode attention against the JAX package's.

On the CPU ``gather_kv_pages`` runs its plain version (the CUDA kernel is
held against that same plain version on the card by chip_smoke.py); the
JAX side runs its Pallas page gather in interpret mode, as
tests/test_generate.py does, and its XLA gather. Inputs come from numpy
seeds and go to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.ops import ragged_decode as jrd
from dmlc_tpu.parallel.ring_attention import dense_attention as jax_dense_attention
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops import ragged_decode as trd
from dmlc_tpu_torch.parallel.ring_attention import dense_attention

# The gather moves bytes: equal, bit for bit. The attention sums in another
# order than XLA's einsum over at most 24 positions of float32 products:
# 1e-5 absolute on outputs of magnitude ~1.
ATOL = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,table", [
    ((10, 4, 2, 8), "random"),
    ((6, 16, 4, 128), "repeats"),
])
def test_gather_matches_jax_pallas_and_xla(dtype, shape, table):
    rng = np.random.default_rng(0)
    pool = rng.standard_normal(shape).astype(np.float32)
    if table == "random":
        ids = rng.integers(0, shape[0], size=(3, 5)).astype(np.int32)
    else:  # repeated ids and the scratch page 0, as the engine's tables hold
        ids = np.array([[3, 3, 0, 0], [0, 5, 1, 5]], np.int32)
    jpool = jnp.asarray(pool, getattr(jnp, dtype))
    want = np.array(jrd.gather_kv_pages(jpool, jnp.asarray(ids), use_pallas=True)
                      .astype(jnp.float32))
    xla = np.array(jrd.gather_kv_pages(jpool, jnp.asarray(ids), use_pallas=False)
                     .astype(jnp.float32))
    tpool = torch.from_numpy(pool).to(getattr(torch, dtype))
    got = trd.gather_kv_pages(tpool, torch.from_numpy(ids))
    assert got.dtype == tpool.dtype
    assert tuple(got.shape) == (ids.shape[0], ids.shape[1] * shape[1], *shape[2:])
    assert torch.equal(got.float(), torch.from_numpy(want))
    assert torch.equal(got.float(), torch.from_numpy(xla))
    assert torch.equal(got, trd.gather_kv_pages_reference(tpool, torch.from_numpy(ids)))


def test_gather_on_the_cpu_launches_nothing():
    kernels.reset_launch_counts()
    pool = torch.zeros(4, 2, 1, 8)
    trd.gather_kv_pages(pool, torch.zeros(2, 3, dtype=torch.int32))
    assert kernels.launch_counts()["gather_kv_pages"] == 0


@pytest.mark.parametrize("bad", [-1, 4, 99])
def test_gather_out_of_range_id_raises(bad):
    pool = torch.zeros(4, 2, 1, 8)
    table = torch.tensor([[0, 1], [2, bad]], dtype=torch.int32)
    with pytest.raises(IndexError, match="outside"):
        trd.gather_kv_pages(pool, table)
    with pytest.raises(IndexError, match="outside"):
        trd.check_page_table(table.numpy(), 4)


@pytest.mark.parametrize("pool,table,err", [
    (torch.zeros(4, 2, 8), torch.zeros(1, 2, dtype=torch.int32), ValueError),
    (torch.zeros(4, 2, 1, 8), torch.zeros(1, 2, dtype=torch.int64), ValueError),
    (torch.zeros(4, 2, 1, 8), torch.zeros(2, dtype=torch.int32), ValueError),
    (torch.zeros(4, 8, 1, 2).transpose(1, 3), torch.zeros(1, 2, dtype=torch.int32), ValueError),
    (np.zeros((4, 2, 1, 8)), torch.zeros(1, 2, dtype=torch.int32), TypeError),
])
def test_gather_rejects_bad_inputs(pool, table, err):
    with pytest.raises(err):
        trd.gather_kv_pages(pool, table)


def test_gather_wrapper_is_counted_with_the_other_kernels():
    assert set(kernels.KERNELS) == {"normalize_u8", "softmax_top1", "gather_kv_pages",
                                    "flash_forward", "flash_bwd_dq", "flash_bwd_dkv"}
    assert kernels.KERNELS["gather_kv_pages"] is trd.gather_kv_pages


def test_ragged_decode_attention_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 2, 16)).astype(np.float32)
    k = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    lengths = np.array([1, 13, 24], np.int32)
    want = np.asarray(jrd.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)))
    got = trd.ragged_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_paged_decode_attention_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 2, 8)).astype(np.float32)
    kp = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    vp = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    table = np.array([[1, 2, 0], [3, 4, 5]], np.int32)
    lengths = np.array([6, 12], np.int32)
    want = np.asarray(jrd.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), use_pallas=True))
    got = trd.paged_decode_attention(*(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seq", [1, 7, 16])
def test_dense_attention_causal_matches_jax(seq):
    rng = np.random.default_rng(seq)
    q, k, v = (rng.standard_normal((2, 3, seq, 16)).astype(np.float32) for _ in range(3))
    for causal in (True, False):
        want = np.asarray(jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=causal))
        got = dense_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_ragged_mask_excludes_beyond_length():
    """Rewriting positions past a row's length leaves that row's output
    unchanged; the full-length row sees them (tests/test_generate.py's
    poisoning check)."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 6, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 6, 2, 8)).astype(np.float32))
    lengths = torch.tensor([3, 6], dtype=torch.int32)
    out_short = trd.ragged_decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[:, 3:] = 99.0
    v2[:, 3:] = -99.0
    out_poisoned = trd.ragged_decode_attention(q, k2, v2, lengths)
    np.testing.assert_allclose(out_short[0].numpy(), out_poisoned[0].numpy(), atol=1e-6)
    assert not np.allclose(out_short[1].numpy(), out_poisoned[1].numpy())


def test_attention_keeps_the_query_dtype():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(np.float32)).bfloat16()
    out = trd.ragged_decode_attention(q, k, k, torch.tensor([4]))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 2, 8)
