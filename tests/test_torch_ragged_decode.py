"""The port's page gather and decode attention against the JAX package's.

On the CPU ``gather_kv_pages`` and ``paged_decode_attention`` run their
plain versions (the CUDA kernels are held against those same plain
versions on the card by chip_smoke.py); the JAX side runs its Pallas page
gather in interpret mode, as tests/test_generate.py does, and its XLA
gather. Inputs come from numpy seeds and go to both.
"""

import ctypes
import re
from pathlib import Path

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
# paged_decode_attention against JAX's over up to 48 positions: float32
# within ATOL; bf16 rounds both outputs to bf16 from float32 sums taken in
# another order, so they may round one bf16 ulp apart: 2^-7 relative.
PAGED_TOL = {"float32": {"rtol": 0, "atol": ATOL}, "bfloat16": {"rtol": 2.0**-7, "atol": 1e-6}}


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
                                    "paged_decode_attention", "flash_forward", "flash_bwd_dq",
                                    "flash_bwd_dkv", "jpeg_idct"}
    assert kernels.KERNELS["gather_kv_pages"] is trd.gather_kv_pages
    assert kernels.KERNELS["paged_decode_attention"] is trd.paged_decode_attention


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


def _paged_case(dh: int, layout: str, seed: int):
    """q [B, H, Dh], pools, table and ragged lengths (1 to full) as numpy.
    "engine": each slot's pages drawn distinct from the pool, the rest of
    its row the scratch page 0 (repeated); "contiguous": one page a slot
    holding the slot's whole sequence, table [[0], [1], ...]."""
    rng = np.random.default_rng(seed)
    b, h, page, cols = 4, 2, 4, 6
    if layout == "engine":
        pool = (1 + b * 4, page, h, dh)
        table = np.zeros((b, cols), np.int32)
        table[:, :4] = rng.permutation(np.arange(1, pool[0]))[: b * 4].reshape(b, 4)
        full = 4 * page
    else:
        pool = (b, cols * page, h, dh)
        table = np.arange(b, dtype=np.int32)[:, None]
        full = cols * page
    lengths = np.array([1, full, *rng.integers(1, full + 1, b - 2)], np.int32)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp, vp = (rng.standard_normal(pool).astype(np.float32) for _ in range(2))
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("layout", ["engine", "contiguous"])
@pytest.mark.parametrize("dh", [64, 128, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_attention_matches_jax_pallas_and_xla(dtype, dh, layout):
    q, kp, vp, table, lengths = _paged_case(dh, layout, seed=dh)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, kp, vp)]
    jargs += [jnp.asarray(table), jnp.asarray(lengths)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, kp, vp)]
    targs += [torch.from_numpy(table), torch.from_numpy(lengths)]
    got = trd.paged_decode_attention(*targs)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == q.shape
    for use_pallas in (True, False):
        want = np.asarray(jrd.paged_decode_attention(*jargs, use_pallas=use_pallas)
                          .astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, **PAGED_TOL[dtype],
                                   err_msg=f"use_pallas={use_pallas}")
    assert torch.equal(got, trd.paged_decode_attention_reference(*targs))


def test_paged_decode_attention_takes_int64_lengths_and_a_scale():
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in _paged_case(64, "engine", 3))
    want = np.asarray(jrd.paged_decode_attention(
        *(jnp.asarray(t.numpy()) for t in (q, kp, vp, table, lengths)), scale=0.3))
    got = trd.paged_decode_attention(q, kp, vp, table, lengths.long(), scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_paged_decode_attention_on_the_cpu_launches_nothing():
    kernels.reset_launch_counts()
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in _paged_case(64, "engine", 4))
    trd.paged_decode_attention(q, kp, vp, table, lengths)
    assert kernels.launch_counts()["paged_decode_attention"] == 0


def _bad_paged_inputs():
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in _paged_case(64, "engine", 5))
    meta = torch.device("meta")
    return [
        ((q[0], kp, vp, table, lengths), ValueError),              # q not [B, H, Dh]
        ((q, kp, vp[:, :, :1], table, lengths), ValueError),       # pools of other heads
        ((q, kp[..., :32], vp[..., :32], table, lengths), ValueError),  # another head dim
        ((q, kp, vp, table.long(), lengths), ValueError),          # table dtype
        ((q, kp, vp, table[:2], lengths), ValueError),             # table rows
        ((q, kp, vp, table, lengths.float()), ValueError),         # lengths dtype
        ((q, kp, vp, table, lengths[:2]), ValueError),             # lengths shape
        ((q.to(meta), kp.to(meta), vp.to(meta), table.to(meta), lengths.to(meta)), ValueError),
        ((q, kp, vp.to(meta), table, lengths), ValueError),        # devices differ
        ((q.numpy(), kp, vp, table, lengths), TypeError),
        ((q, kp, vp, table + 100, lengths), IndexError),           # ids outside the pool
    ]


@pytest.mark.parametrize("case", range(11))
def test_paged_decode_attention_rejects_bad_inputs(case):
    args, err = _bad_paged_inputs()[case]
    with pytest.raises(err):
        trd.paged_decode_attention(*args)


def test_paged_kernel_constants_match_its_source():
    """The wrapper refuses head dims past PAGED_MAX_HEAD_DIM, the source's,
    and reads the split it sizes the scratch by from the library (text
    only, no nvcc)."""
    text = (Path(trd.__file__).resolve().parent.parent / "csrc" / "paged_decode.cu").read_text()
    assert f"constexpr int kGenericMaxDh = {trd.PAGED_MAX_HEAD_DIM};" in text
    for name in ("paged_decode", "paged_decode_split"):
        symbol, _ = kernels._SIGNATURES[name]
        assert f'extern "C" int {symbol}(' in text
    assert kernels._LIBRARY["paged_decode_split"] == "paged_decode"


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong}


def test_gather_kernel_constants_fit_a_block():
    """The bulk gather's chunk is a multiple of 16 bytes, its ring (with the
    zero chunk) fits a block's shared memory, its entry points take what
    the wrappers pass, and it runs on the 16-byte condition the bulk
    engine needs (text only, no nvcc)."""
    text = (Path(trd.__file__).resolve().parent.parent / "csrc" / "gather_pages.cu").read_text()
    chunk = int(re.search(r"constexpr int kChunkBytes = (\d+);", text).group(1))
    stages = int(re.search(r"constexpr int kStages = (\d+);", text).group(1))
    assert chunk % 16 == 0 and stages >= 2
    assert "constexpr int kBulkSmemBytes = (kStages + 1) * kChunkBytes;" in text
    assert (stages + 1) * chunk <= 232448
    for name in ("gather_pages", "gather_pages_vec16", "gather_pages_smem_bytes"):
        symbol, argtypes = kernels._SIGNATURES[name]
        params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text).group(1)
        types = [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",") if p.strip()]
        assert [_C_TYPES[c] for c in types] == list(argtypes), name
        assert kernels._LIBRARY.get(name, name) == "gather_pages"
    assert kernels._SIGNATURES["gather_pages_vec16"][1] == kernels._SIGNATURES["gather_pages"][1]
    aligned = ("const bool aligned = ((reinterpret_cast<uintptr_t>(pool) | "
               "reinterpret_cast<uintptr_t>(out) |\n                         "
               "(uintptr_t)page_bytes) & 15u) == 0;")
    assert aligned in text
    assert "if (aligned && bulk) {" in text
    assert "return launch_gather(pool, num_pages, page_bytes, ids, n_out, out, stream, true);" in text


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
