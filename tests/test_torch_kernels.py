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
    return _check_top1_typed(torch.from_numpy(logits), jnp.float32)


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


# The logits dtypes the TPU kernel takes (it casts each to float32), and
# the columns where the card's kernel changes path: fewer columns than one
# 16-byte vector, one vector's worth and a ragged tail (f32 4 a vector,
# bf16/f16 8), the serve shape's 1000 and its ragged neighbours, and a row
# longer than a 128-thread row group's eight vectors a thread in float32.
TOP1_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
               "float16": (torch.float16, jnp.float16)}
TOP1_COLS = (1, 3, 31, 33, 999, 1000, 1001, 4099)


def _check_top1_typed(x: torch.Tensor, jdtype):
    """The port's softmax_top1 on ``x`` (any strides the wrapper takes)
    against the Pallas kernel on the same values in the JAX dtype: indices
    exactly, probabilities within PROB_RTOL, NaN where it gives NaN."""
    want_idx, want_prob = (np.asarray(a) for a in pk.softmax_top1(
        jnp.asarray(x.float().numpy()).astype(jdtype)))
    idx, prob = kernels.softmax_top1(x)
    assert idx.dtype == torch.int32 and prob.dtype == torch.float32
    assert want_idx.dtype == np.int32 and want_prob.dtype == np.float32
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(prob.numpy(), want_prob, rtol=PROB_RTOL)
    return idx.numpy(), prob.numpy()


def _typed_logits(cols: int, dtype: torch.dtype, seed: int) -> tuple[torch.Tensor, list]:
    """Five rows of ``cols`` logits in ``dtype`` and the index each must
    give, where the rows fix it: random; the maximum tied at a third, a
    half and the last of the columns (other lanes, and from 1000 columns
    other warps of a 128-thread row group); the maximum alone in the last
    column; the maximum tied at the two sides of a vector's and of a warp's
    columns; a whole row tied."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(5, cols)) * 4).astype(np.float32)).to(dtype)
    top = float(x.float().max()) + 8.0
    want = [None]
    spread = sorted({0, cols // 3, cols // 2, cols - 1} if cols > 1 else {0})
    x[1, spread[1:] if len(spread) > 1 else spread] = top
    want.append(spread[1] if len(spread) > 1 else 0)
    x[2, cols - 1] = top
    want.append(cols - 1)
    edges = [c for c in (7, 8, 127, 128, 129, 512, 513) if c < cols]
    x[3, edges or [cols - 1]] = top
    want.append(edges[0] if edges else cols - 1)
    x[4] = 0.25
    want.append(0)
    return x, want


@pytest.mark.parametrize("cols", TOP1_COLS)
@pytest.mark.parametrize("dtype", list(TOP1_DTYPES))
def test_softmax_top1_dtypes_and_widths_match_pallas(dtype, cols):
    """float32, bfloat16 and float16 logits at every column count where the
    card's kernel changes path, with ties spanning lanes and warps and the
    maximum in the last column."""
    tdtype, jdtype = TOP1_DTYPES[dtype]
    x, want = _typed_logits(cols, tdtype, seed=cols)
    idx, prob = _check_top1_typed(x, jdtype)
    assert want[1:] == idx[1:].tolist()
    assert np.isfinite(prob).all()


def _special_rows(case: str, cols: int = 1000) -> tuple[np.ndarray, int]:
    """A row of ``cols`` random logits with NaN or infinities placed, and
    the index it must give."""
    x = np.random.default_rng(11).normal(size=(1, cols)).astype(np.float32)
    if case == "nan_first":
        x[0, 0], want = np.nan, 0
    elif case == "nan_last":
        x[0, -1], want = np.nan, cols - 1
    elif case == "nan_twice":
        x[0, [500, 501]], want = np.nan, 500
    elif case == "all_neg_inf":
        x[0], want = -np.inf, 0
    else:  # ties at +inf, the first in the second warp's columns
        x[0, [130, 131, 600, 999]], want = np.inf, 130
    return x, want


@pytest.mark.parametrize("case", ["nan_first", "nan_last", "nan_twice", "all_neg_inf",
                                  "pos_inf_ties"])
@pytest.mark.parametrize("dtype", list(TOP1_DTYPES))
def test_softmax_top1_nan_and_infinities_match_pallas(dtype, case):
    """A NaN is the maximum (the first of two), a row of all -inf gives
    index 0, ties at +inf give the first; the probability is NaN in every
    such row, as the Pallas kernel's is."""
    tdtype, jdtype = TOP1_DTYPES[dtype]
    x, want = _special_rows(case)
    rows = np.concatenate([x, np.random.default_rng(12).normal(size=(2, 1000)).astype(np.float32)])
    idx, prob = _check_top1_typed(torch.from_numpy(rows).to(tdtype), jdtype)
    assert idx[0] == want and np.isnan(prob[0]) and np.isfinite(prob[1:]).all()


@pytest.mark.parametrize("cols", [1000, 1001])
@pytest.mark.parametrize("dtype", list(TOP1_DTYPES))
def test_softmax_top1_view_with_a_storage_offset_matches_pallas(dtype, cols):
    """A contiguous view one element into its storage (on the card, no row
    starts on a 16-byte boundary: every row has a head of scalars)."""
    tdtype, jdtype = TOP1_DTYPES[dtype]
    flat = torch.from_numpy(np.random.default_rng(13).normal(size=6 * cols + 1)
                            .astype(np.float32) * 4).to(tdtype)
    x = flat[1:].view(6, cols)
    assert x.is_contiguous() and x.storage_offset() == 1
    x[2, 0] = x[3, cols - 1] = float(x.float().max()) + 8.0
    idx, _ = _check_top1_typed(x, jdtype)
    assert idx[2] == 0 and idx[3] == cols - 1


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


# ---------------------------------------------------------------------------
# The thinned launch path: every refusal keeps its exception type
# ---------------------------------------------------------------------------

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from dmlc_tpu_torch.ops import flash as tflash  # noqa: E402
from dmlc_tpu_torch.ops import ragged_decode as trd  # noqa: E402

_META = torch.device("meta")


def _paged_args():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((3, 2, 8)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((6, 4, 2, 8)).astype(np.float32))
    table = torch.tensor([[1, 2], [3, 0], [4, 5]], dtype=torch.int32)
    return q, kp, kp.clone(), table, torch.tensor([3, 5, 8], dtype=torch.int32)


def _refusals():
    """(call, exception type): the cases of test_gather_rejects_bad_inputs,
    test_paged_decode_attention_rejects_bad_inputs,
    test_normalize_rejects_bad_input and test_softmax_top1_rejects_bad_input,
    each wrapper on a tensor of an unsupported device, and a device
    mismatch between two arguments of each multi-tensor wrapper."""
    gather, paged = trd.gather_kv_pages, trd.paged_decode_attention
    t2 = torch.zeros(1, 2, dtype=torch.int32)
    pool = torch.zeros(4, 2, 1, 8)
    q, kp, vp, table, lengths = _paged_args()
    m = torch.zeros(2, 16, 64)
    lse = torch.zeros(2, 16, 1)

    def norm(bad):
        return lambda: kernels.normalize_u8(bad, tpp.IMAGENET_MEAN, tpp.IMAGENET_STD)

    return [
        (lambda: gather(torch.zeros(4, 2, 8), t2), ValueError),
        (lambda: gather(pool, torch.zeros(1, 2, dtype=torch.int64)), ValueError),
        (lambda: gather(pool, torch.zeros(2, dtype=torch.int32)), ValueError),
        (lambda: gather(torch.zeros(4, 8, 1, 2).transpose(1, 3), t2), ValueError),
        (lambda: gather(np.zeros((4, 2, 1, 8)), t2), TypeError),
        (lambda: gather(pool.to(_META), t2.to(_META)), ValueError),
        (lambda: gather(pool, t2.to(_META)), ValueError),                    # devices differ
        (lambda: paged(q[0], kp, vp, table, lengths), ValueError),
        (lambda: paged(q, kp, vp[:, :, :1], table, lengths), ValueError),
        (lambda: paged(q, kp[..., :4], vp[..., :4], table, lengths), ValueError),
        (lambda: paged(q, kp, vp, table.long(), lengths), ValueError),
        (lambda: paged(q, kp, vp, table[:2], lengths), ValueError),
        (lambda: paged(q, kp, vp, table, lengths.float()), ValueError),
        (lambda: paged(q, kp, vp, table, lengths[:2]), ValueError),
        (lambda: paged(*(x.to(_META) for x in (q, kp, vp, table, lengths))), ValueError),
        (lambda: paged(q, kp, vp.to(_META), table, lengths), ValueError),    # devices differ
        (lambda: paged(q, kp, vp, table, lengths.to(_META)), ValueError),    # devices differ
        (lambda: paged(q.numpy(), kp, vp, table, lengths), TypeError),
        (lambda: paged(q, kp, vp, table, lengths.numpy()), TypeError),
        (lambda: paged(q, kp, vp, table + 100, lengths), IndexError),
        (norm(torch.zeros(2, 4, 4, 3, dtype=torch.float32)), TypeError),
        (norm(torch.zeros(4, 4, 3, dtype=torch.uint8)), ValueError),
        (norm(torch.zeros(2, 4, 4, 3, dtype=torch.uint8).transpose(1, 2)), ValueError),
        (norm(torch.zeros(2, 4, 4, 3, dtype=torch.uint8, device=_META)), ValueError),
        (lambda: kernels.softmax_top1(torch.zeros(4, 10, dtype=torch.float64)), TypeError),
        (lambda: kernels.softmax_top1(torch.zeros(4, dtype=torch.float32)), ValueError),
        (lambda: kernels.softmax_top1(torch.zeros(4, 0, dtype=torch.float32)), ValueError),
        (lambda: kernels.softmax_top1(torch.zeros(10, 4, dtype=torch.float32).t()), ValueError),
        (lambda: kernels.softmax_top1(torch.zeros(4, 10, device=_META)), ValueError),
        (lambda: tflash.flash_forward(m, m.to(_META), m, causal=False, scale=1.0),
         ValueError),                                                        # devices differ
        (lambda: tflash.flash_bwd_dq(m, m, m, m, lse, lse.to(_META), causal=False, scale=1.0),
         ValueError),                                                        # devices differ
        (lambda: tflash.flash_bwd_dkv(m, m, m, np.zeros((2, 16, 64)), lse, lse, causal=False,
                                      scale=1.0), TypeError),
    ]


@pytest.mark.parametrize("case", range(32))
def test_every_wrapper_refusal_keeps_its_exception_type(case):
    call, err = _refusals()[case]
    with pytest.raises(err):
        call()


def test_refusal_cases_are_all_run():
    assert len(_refusals()) == 32


# The checks as they stood before the launch path was thinned (each read
# ``t.device`` per tensor and compared torch.device objects): the verdicts
# the thinned checks must keep.


def _old_require_device(t, what):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _old_check_gather(pages, page_table):
    if not isinstance(pages, torch.Tensor) or not isinstance(page_table, torch.Tensor):
        raise TypeError("gather_kv_pages: pages and page_table must be torch.Tensors")
    _old_require_device(pages, "gather_kv_pages")
    if pages.dim() != 4:
        raise ValueError("pages")
    if page_table.dim() != 2 or page_table.dtype != torch.int32:
        raise ValueError("page_table")
    if page_table.device != pages.device:
        raise ValueError("devices")
    if not (pages.is_contiguous() and page_table.is_contiguous()):
        raise ValueError("contiguous")


def _old_check_paged(q, k_pages, v_pages, page_table, kv_lengths):
    what = "paged_decode_attention"
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages, "page_table": page_table,
             "kv_lengths": kv_lengths}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(name)
        _old_require_device(t, what)
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(name)
    if q.dim() != 3:
        raise ValueError("q")
    b, heads, dh = q.shape
    if (k_pages.dim() != 4 or k_pages.shape != v_pages.shape
            or tuple(k_pages.shape[2:]) != (heads, dh)):
        raise ValueError("pools")
    if page_table.dim() != 2 or page_table.dtype != torch.int32 or page_table.shape[0] != b:
        raise ValueError("table")
    if tuple(kv_lengths.shape) != (b,) or kv_lengths.dtype not in (torch.int32, torch.int64):
        raise ValueError("lengths")


def _old_check_logits(logits):
    if not isinstance(logits, torch.Tensor):
        raise TypeError("logits")
    _old_require_device(logits, "softmax_top1")
    # The dtypes the TPU kernel takes (bf16 and float16 since the kernel's
    # redesign; float32 only before).
    if logits.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError("dtype")
    if logits.dim() != 2 or logits.shape[1] == 0:
        raise ValueError("shape")
    if not logits.is_contiguous():
        raise ValueError("contiguous")


def _old_check_normalize(batch_u8, out_dtype):
    if not isinstance(batch_u8, torch.Tensor):
        raise TypeError("batch")
    _old_require_device(batch_u8, "normalize_u8")
    if batch_u8.dtype != torch.uint8:
        raise TypeError("dtype")
    if batch_u8.dim() != 4:
        raise ValueError("shape")
    if not batch_u8.is_contiguous():
        raise ValueError("contiguous")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("out_dtype")


def _old_check_operands(what, mats, rows):
    first = next(iter(mats.values()))
    for name, t in {**mats, **rows}.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(name)
        _old_require_device(t, what)
        if t.device != first.device:
            raise ValueError(name)
    if first.dim() != 3:
        raise ValueError("shape")
    bh, s, dh = first.shape
    for name, t in mats.items():
        if tuple(t.shape) != (bh, s, dh):
            raise ValueError(name)
    for name, t in rows.items():
        if tuple(t.shape) != (bh, s, 1) or t.dtype != torch.float32:
            raise ValueError(name)


def _verdict(check, *args):
    """The exception type ``check(*args)`` raises, or None."""
    try:
        check(*args)
    except (TypeError, ValueError) as e:
        return type(e)
    return None


_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int32, torch.int64,
           torch.uint8)


@st.composite
def _tensors(draw, shape):
    """A tensor near ``shape``: one size changed, a dimension dropped or
    added, or the shape kept; in one of _DTYPES; contiguous, transposed or
    sliced with a stride; on the CPU or the meta device; or no tensor."""
    shape = list(shape)
    edit = draw(st.sampled_from(["keep", "keep", "keep", "size", "drop", "add"]))
    if edit == "size" and shape:
        shape[draw(st.integers(0, len(shape) - 1))] = draw(st.integers(0, 4))
    elif edit == "drop" and shape:
        shape.pop()
    elif edit == "add":
        shape.append(draw(st.integers(1, 3)))
    layout = draw(st.sampled_from(["contiguous", "contiguous", "transposed", "strided"]))
    dtype = draw(st.sampled_from(_DTYPES))
    if draw(st.integers(0, 9)) == 0:
        return np.zeros(shape)
    if layout == "strided" and shape:
        t = torch.zeros(*shape[:-1], 2 * shape[-1], dtype=dtype)[..., ::2]
    else:
        t = torch.zeros(shape, dtype=dtype)
        if layout == "transposed" and len(shape) >= 2:
            t = t.transpose(0, 1)
    return t.to(_META) if draw(st.integers(0, 7)) == 0 else t


@settings(max_examples=300, deadline=None)
@given(st.data())
def test_thinned_checks_give_the_old_verdicts(data):
    """Each check the launch path's thinning rewrote gives the same verdict
    (the exception type, or none) as the check it replaced, over drawn
    shapes, dtypes, strides and devices of every argument."""
    draw = data.draw
    pages = draw(_tensors((5, 2, 3, 8)))
    table = draw(_tensors((2, 3)))
    assert _verdict(trd._check_gather, pages, table) == _verdict(_old_check_gather, pages, table)
    q, kp, vp, tab, lens = (draw(_tensors(s)) for s in ((3, 2, 8), (6, 4, 2, 8), (6, 4, 2, 8),
                                                        (3, 2), (3,)))
    args = (q, kp, vp, tab, lens)
    assert _verdict(trd._check_paged, *args) == _verdict(_old_check_paged, *args)
    logits = draw(_tensors((4, 10)))
    assert _verdict(kernels._check_logits, logits) == _verdict(_old_check_logits, logits)
    u8 = draw(_tensors((2, 4, 4, 3)))
    out = draw(st.sampled_from(_DTYPES))
    assert _verdict(kernels._check_normalize, u8, out) == _verdict(_old_check_normalize, u8, out)
    mats = {n: draw(_tensors((2, 16, 8))) for n in ("q", "k", "v", "do")}
    rows = {n: draw(_tensors((2, 16, 1))) for n in ("lse", "delta")}
    assert _verdict(tflash._check_operands, "flash_bwd_dq", mats, rows) == \
        _verdict(_old_check_operands, "flash_bwd_dq", mats, rows)


def test_launch_host_imports_an_earlier_ops_beside_the_checkout(tmp_path, monkeypatch):
    """tools/launch_host.py --parent copies the package under another name
    with the earlier ops/ in it, so that both launch paths import into one
    process and are timed there in turns; it tells the two layouts apart
    and refuses a scratch directory inside the checkout (no card)."""
    import importlib
    import importlib.util
    import types
    from pathlib import Path

    path = Path(kernels.__file__).resolve().parent.parent / "tools" / "launch_host.py"
    spec = importlib.util.spec_from_file_location("launch_host", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ops = Path(kernels.__file__).resolve().parent
    name = tool._parent_package(ops, tmp_path)
    monkeypatch.syspath_prepend(str(tmp_path))
    copy = importlib.import_module(f"{name}.ops.ragged_decode")
    assert copy.kernels is importlib.import_module(f"{name}.ops.kernels")
    assert copy.kernels is not kernels and copy.kernels.KERNELS is not kernels.KERNELS
    assert tool._layout(copy.kernels) == tool._layout(kernels) == "raw_stream"
    assert tool._layout(types.SimpleNamespace(_launch=None)) == "stream_object"
    with pytest.raises(SystemExit):
        tool.main(["launch_host.py", "--parent", str(ops), str(tool.REPO / "smoke_tree")])
