"""The device stage of the JPEG decode: coefficients -> uint8 RGB images.

``jpeg_idct`` takes one entropy-decoded batch (``native/jpeg.py``
``Coefficients``, copied to the card in one piece) and writes each image
the host decoder took as uint8 [size, size, 3]: dequantization, the M-point
scaled IDCT (libjpeg's ``jpeg_idct_MxM`` semantics over the first M
coefficients of each row and column, level shift 128, clamp), chroma
brought to the luma grid (a 2M-point IDCT where 2M <= 8, else its
full-resolution samples upsampled by libjpeg's fancy triangle filter and
resampled by the triangle filter), libjpeg's integer YCbCr->RGB, and the
triangle resample of
``native/image_pipeline.cpp`` ``make_taps`` (the weights of
``ops/device_resize.triangle_weights``) to size x size, skipped where the
scaled image already is size x size. The kernel is ``csrc/jpeg_idct.cu``;
it replaces no TPU kernel (the JAX package decodes on the host).

The kernel works from a plan the host builds for each batch
(:func:`batch_plan`, in C++: ``native/jpeg_plan.cpp``, built into the
entropy decoder's library): the IDCT's runs (up to ``RUN_BLOCKS`` blocks of
one component's block row each, so no CTA launches idle) and, for each
image geometry, the colour pass's tiles (:func:`geometry_plan`: an output
range, the scaled and source extents and the plane boxes it stages in
shared memory, within ``SMEM_BUDGET``) and its resample tables
(:func:`trimmed_taps`: ``resample_taps``' float32 weights without their
zero taps, so no weight is computed on the card). A new geometry costs
tens of microseconds on the host, most of it its tables' divisions, and
its record is kept for later batches; a batch's plan is cached by the
record fields it depends on, with its copy on the card, so a batch like a
recent one costs neither.

On a CUDA batch the wrapper launches the kernel, on a CPU batch it runs
the plain PyTorch version ``jpeg_idct_reference``, which computes the same
function with the same separately rounded float operations in the same
order, so the two give the same bytes (a zero tap adds exactly 0 to a sum
of non-negative terms, so the trimmed tables change no bit). A failed
build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from dmlc_tpu_torch.native import jpeg as nj
from dmlc_tpu_torch.native.jpeg import MAX_COMPS, Coefficients
from dmlc_tpu_torch.ops import _build, kernels

# The arena's five regions (basis, images, comps, qtables, coef); the plan;
# n, the IDCT's runs, the colour pass's tiles and its shared memory; the
# planes and out; size; the stream.
kernels._SIGNATURES["jpeg_idct"] = (
    "dmlc_jpeg_idct",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_void_p],
)

#: Blocks of one component's block row an IDCT CTA takes (8 threads a block).
RUN_BLOCKS = 16
#: Output rows a colour tile takes before the plan shrinks it to fit.
TILE_ROWS = 16
#: Shared memory a colour tile may stage (4 CTAs an SM: kColorCtas in
#: csrc/jpeg_idct.cu), and what a block can have at most on an H100
#: (227 KB). native/jpeg_plan.cpp plans with these.
SMEM_BUDGET = 64 * 1024
SMEM_MAX = 232448
#: int32 fields of the plan's header (n, runs, tiles, shared memory), of a
#: geometry record and of a tile record (csrc/jpeg_idct.cu reads them).
PLAN_HDR, GEOM_INTS, TILE_INTS = 4, 28, 32
#: A geometry record: its tile count and the offset of its tiles; whether
#: it resamples to size x size, and the offsets of that resample's row and
#: column tables; each component's row and column tables to the scaled
#: grid (-1: not resampled); the shared-memory offsets, for each component,
#: of its samples on the scaled extent (S, a component not resampled), of
#: its fancy samples on the source extent and of its horizontal pass (F
#: and H, a resampled one), and of its plane box (Q, a component that is
#: fancy-upsampled); of the scaled RGB or the staged output (P), the final
#: horizontal pass (T) and the staged output of the final resample (O);
#: the total bytes; and whether the two chroma components are twins (the
#: same source grid and upsampling, so the same tables, extents and boxes,
#: which the kernel makes in one pass). Offsets are int32 units from the
#: record's start (-1: none), shared-memory ones bytes.
G_NTILES, G_TILES, G_RESIZE, G_FY, G_FX, G_CY, G_CX = 0, 1, 2, 3, 4, 5, 8
G_S, G_F, G_H, G_Q, G_P, G_T, G_O, G_SMEM, G_TWIN = 11, 14, 17, 20, 23, 24, 25, 26, 27
#: A tile record: the output rows and columns [oy0, oy1) x [ox0, ox1), the
#: scaled extent [Y0, Y1) x [X0, X1) it stages; for each component its
#: source extent [SY0, SY1) x [SX0, SX1) (the scaled extent where it is
#: not resampled) and the box of plane rows and columns [r0, r1) x
#: [c0, c1) its fancy samples there read.
T_OUT, T_SCALED, T_SRC, T_BOX = 0, 4, 8, 20


def kernel_entry():
    """(library, entry point) of the kernel, built and bound on first use."""
    return kernels._entry("jpeg_idct")


def _check(coefs: Coefficients, out: torch.Tensor | None) -> int:
    if not isinstance(coefs, Coefficients):
        raise TypeError("jpeg_idct: coefs must be a native.jpeg.Coefficients")
    index = kernels._device_index(coefs.data, "jpeg_idct")
    if out is not None:
        shape = (coefs.n, coefs.size, coefs.size, 3)
        if out.dtype != torch.uint8 or tuple(out.shape) != shape or not out.is_contiguous():
            raise ValueError(f"jpeg_idct: out must be a contiguous uint8 tensor of shape {shape}")
        if kernels._device_index(out, "jpeg_idct") != index:
            raise ValueError("jpeg_idct: out lies on another device than the coefficients")
    return index


def jpeg_idct(coefs: Coefficients, out: torch.Tensor | None = None) -> torch.Tensor:
    """Coefficients -> uint8 [n, size, size, 3] on the batch's device
    (``out`` when given). Rows of refused images (status != 0) are left as
    they were. One wrapper call is one launch (two kernels)."""
    index = _check(coefs, out)
    if index < 0:
        return jpeg_idct_reference(coefs, out)
    if out is None:
        out = coefs.data.new_empty((coefs.n, coefs.size, coefs.size, 3))
    if coefs.n == 0 or not (coefs.images[:, 0] == 0).any():
        return out
    plan = batch_plan(coefs)
    on_card = plan.to(coefs.data.device)
    planes = coefs.data.new_empty(max(coefs.plane_bytes, 1))
    base = coefs.data.data_ptr()
    off = coefs.offsets
    lib, fn = kernel_entry()
    rc = kernels._launch(coefs.data, fn, base + off["basis"], base + off["images"],
                         base + off["comps"], base + off["qt"], base + off["coef"],
                         on_card.data_ptr(), coefs.n, plan.runs, plan.tiles, plan.smem,
                         planes.data_ptr(), out.data_ptr(), coefs.size)
    _build.check(lib, rc, "jpeg_idct")
    jpeg_idct.launches += 1
    return out


jpeg_idct.launches = 0  # type: ignore[attr-defined]
kernels.KERNELS["jpeg_idct"] = jpeg_idct


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _ptr(a: np.ndarray, ctype=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _plan_call(call, what: str) -> np.ndarray:
    """int32 output of a ``native/jpeg_plan.cpp`` entry: ``call()`` builds
    it in the library and returns its length or an error code; for a
    geometry past SMEM_MAX it keeps the image and the bytes its 1x1 tile
    stages."""
    lib = nj.load()
    rc = int(call(lib))
    out = np.empty(max(rc, 2), np.int32)
    lib.dmlc_jpeg_plan_take(_ptr(out), out.size)
    if rc == -2:
        raise ValueError(f"{what}: a 1x1 tile of image {out[0]} stages {out[1]} bytes, "
                         f"past {SMEM_MAX}")
    if rc < 0:
        reason = {-1: "bad arguments", -3: "past int32", -4: "an output with no weight"}
        raise ValueError(f"{what}: the plan was refused ({reason.get(rc, rc)})")
    return out


def trimmed_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``resample_taps(in_size, out_size)`` without its zero taps, as
    ``native/jpeg_plan.cpp`` makes the kernel's tables: (int32 [out] first
    source index, int32 [out] tap count, float32 [out, K] weights, rows
    padded with 0). Each row keeps its taps in order, so a sum over them
    equals the full row's bit for bit."""
    first, count = np.empty(out_size, np.int32), np.empty(out_size, np.int32)
    cap = out_size * (int(2 * max(1.0, in_size / out_size)) + 3)
    w = np.empty(cap, np.float32)
    k = nj.load().dmlc_jpeg_taps(in_size, out_size, _ptr(first), _ptr(count),
                                 _ptr(w, ctypes.c_float), cap)
    if k <= 0 or out_size * k > cap:
        raise ValueError(f"resample {in_size} -> {out_size}: refused ({k})")
    return first, count, w[:out_size * k].reshape(out_size, k).copy()


@dataclass(frozen=True)
class GeometryPlan:
    """The colour pass's plan for one image geometry: ``record`` is what
    the kernel reads (the geometry record, its tiles, its tables);
    ``tiles`` int32 [T, TILE_INTS]; ``tables`` the trimmed taps by name
    (``fy``, ``fx``: to size x size; ``cy<c>``, ``cx<c>``: component c to
    the scaled grid); ``rows`` x ``cols`` the first tile's output."""

    record: np.ndarray
    tiles: np.ndarray
    tables: dict
    rows: int
    cols: int
    smem: int


def geometry_plan(ncomp: int, ws: int, hs: int, comps: tuple, size: int) -> GeometryPlan:
    """The plan of an image of ``ncomp`` components whose scaled image is
    ws x hs and whose component c sits on the source grid (srcw, srch),
    fancy-upsampled by (fx, fy) from its plane: ``comps[c]``, as
    ``batch_plan`` places it (``native/jpeg_plan.cpp``): tiles start at
    TILE_ROWS full-width rows and halve their rows or columns, whichever
    stages less, until they fit SMEM_BUDGET."""
    if len(comps) != ncomp:
        raise ValueError(f"{ncomp} components but {len(comps)} component geometries")
    arr = np.asarray(comps, np.int32).reshape(-1)
    record = _plan_call(lambda lib: lib.dmlc_jpeg_geometry_plan(ncomp, ws, hs, _ptr(arr), size),
                        f"geometry {(ncomp, ws, hs, comps, size)}")
    tiles = record[GEOM_INTS:GEOM_INTS + record[G_NTILES] * TILE_INTS].reshape(-1, TILE_INTS)
    tables = {}
    slots = {"fy": G_FY, "fx": G_FX, **{f"c{a}{c}": (G_CY if a == "y" else G_CX) + c
                                       for c in range(ncomp) for a in "yx"}}
    for name, slot in slots.items():
        at = int(record[slot])
        if at >= 0:
            n, k = int(record[at]), int(record[at + 1])
            body = record[at + 2:at + 2 + 2 * n + n * k]
            tables[name] = (body[:n], body[n:2 * n], body[2 * n:].view(np.float32).reshape(n, k))
    return GeometryPlan(record=record, tiles=tiles, tables=tables,
                        rows=int(tiles[0, 1] - tiles[0, 0]), cols=int(tiles[0, 3] - tiles[0, 2]),
                        smem=int(record[G_SMEM]))


@dataclass(frozen=True)
class BatchPlan:
    """One batch's plan (int32 ``data``): the header, each image's first
    tile (a prefix of n + 1), the offset of each image's geometry record,
    each component record's first IDCT run (a prefix of 3n + 1), then the
    geometry records; and the launch's runs, tiles and shared memory."""

    data: np.ndarray
    runs: int
    tiles: int
    smem: int
    on_card: dict = field(default_factory=dict, compare=False, repr=False)

    def to(self, device: torch.device) -> torch.Tensor:
        """``data`` on ``device``, copied there once: a batch whose records
        repeat a cached plan's costs no copy."""
        t = self.on_card.get(device)
        if t is None:
            t = self.on_card[device] = torch.from_numpy(self.data).to(device)
        return t


def batch_plan(coefs: Coefficients) -> BatchPlan:
    """The plan ``jpeg_idct``'s kernel reads for this batch
    (``native/jpeg_plan.cpp``), cached on the record fields it depends on
    (so a stream of like batches builds it once)."""
    return _batch_plan(coefs.images[:, [0, 3, 5, 6]].tobytes(),
                       coefs.comps[:, [1, 2, 12, 13, 8, 9]].tobytes(), coefs.n, coefs.size)


def forget_plans() -> None:
    """Drops every cached plan, the batches' and the geometries' kept by
    ``native/jpeg_plan.cpp``: the next batch makes its plan anew."""
    _batch_plan.cache_clear()
    nj.load().dmlc_jpeg_plan_forget()


@functools.lru_cache(maxsize=16)
def _batch_plan(images: bytes, comps: bytes, n: int, size: int) -> BatchPlan:
    """``images``: int32 [n, 4] status, ncomp, ws, hs; ``comps``: int32
    [n * MAX_COMPS, 6] bw, bh, srcw, srch, fx, fy."""
    img, rec = np.frombuffer(images, np.int32), np.frombuffer(comps, np.int32)
    data = _plan_call(lambda lib: lib.dmlc_jpeg_batch_plan(_ptr(img), _ptr(rec), n, size),
                      f"batch of {n}")
    return BatchPlan(data=data, runs=int(data[1]), tiles=int(data[2]), smem=int(data[3]))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def idct_blocks(coef: torch.Tensor, q: torch.Tensor, nx: int, basis: torch.Tensor,
                ny: int | None = None) -> torch.Tensor:
    """int16 [nb, 64] coefficients (natural order) and their table ->
    float32 [nb, ny, nx] before the level shift (``ny`` defaults to
    ``nx``): dequantize, then the row pass ``T[v, x] = sum_u F[v, u]
    Bx[x, u]`` over the first nx coefficients of a row and the column pass
    ``O[y, x] = sum_v T[v, x] By[y, v]`` over the first ny, each sum taken
    term by term from u (v) = 0."""
    ny = nx if ny is None else ny
    f = (coef.to(torch.float32) * q.to(torch.float32)).view(-1, 8, 8)
    bx, by = basis[nx - 1], basis[ny - 1]
    t = torch.zeros((f.shape[0], ny, nx), dtype=torch.float32, device=f.device)
    for u in range(nx):
        t = t + f[:, :ny, u, None] * bx[None, None, :nx, u]
    o = torch.zeros_like(t)
    for v in range(ny):
        o = o + t[:, v, None, :] * by[None, :ny, v, None]
    return o


def _fancy(plane: torch.Tensor, rec: np.ndarray, hs: int, ws: int) -> torch.Tensor:
    """The component at every position of its source grid, int32 [hs, ws]:
    libjpeg's fancy upsampling along an axis of factor 2."""
    cw, ch, fx, fy = (int(v) for v in rec[6:10])
    dev = plane.device
    j = torch.arange(hs, device=dev)
    i = torch.arange(ws, device=dev)
    if fx == 1 and fy == 1:
        return plane[:hs, :ws]
    r0 = r1 = j
    c0 = c1 = i
    if fy == 2:
        r0 = j >> 1
        r1 = torch.where((j & 1) == 1, r0 + 1, r0 - 1).clamp(0, ch - 1)
    if fx == 2:
        c0 = i >> 1
        c1 = torch.where((i & 1) == 1, c0 + 1, c0 - 1).clamp(0, cw - 1)
    if fx == 2 and fy == 2:
        s0 = 3 * plane[r0][:, c0] + plane[r1][:, c0]
        s1 = 3 * plane[r0][:, c1] + plane[r1][:, c1]
        bias = torch.where((i & 1) == 1, 7, 8)
        return (3 * s0 + s1 + bias) >> 4
    if fx == 2:
        bias = torch.where((i & 1) == 1, 2, 1)
        return (3 * plane[j][:, c0] + plane[j][:, c1] + bias) >> 2
    bias = torch.where((j & 1) == 1, 2, 1)[:, None]
    return (3 * plane[r0][:, i] + plane[r1][:, i] + bias) >> 2


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """libjpeg's integer colour conversion (jdcolor.c, JFIF BT.601 full
    range, 16-bit fixed point) on int32 samples -> int32 [..., 3]."""
    cb = cb - 128
    cr = cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255)


@functools.lru_cache(maxsize=256)
def resample_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(int64 [out, K] source indices, float32 [out, K] weights) of the
    triangle resample ``in_size -> out_size``: make_taps's weights (the
    kernel's), each unnormalised weight in double, summed one after the
    other and divided by the sum; rows padded to K taps with weight 0."""
    scale = in_size / out_size
    support = max(1.0, scale)
    div = scale if support > 1.0 else 1.0
    rows = []
    for o in range(out_size):
        center = (o + 0.5) * scale
        lo = max(0, int(math.floor(center - support)))
        hi = min(in_size, int(math.ceil(center + support)))
        ds = [abs((j + 0.5 - center) / div) for j in range(lo, hi)]
        ws = [1.0 - d if d < 1.0 else 0.0 for d in ds]
        total = 0.0
        for w in ws:
            total += w
        if total <= 0.0:
            near = min(max(int(center), lo), hi - 1)
            ws = [1.0 if j == near else 0.0 for j in range(lo, hi)]
            total = 1.0
        rows.append((lo, [w / total for w in ws]))
    k = max(len(w) for _, w in rows)
    idx = np.zeros((out_size, k), np.int64)
    wts = np.zeros((out_size, k), np.float32)
    for o, (lo, w) in enumerate(rows):
        idx[o] = lo
        idx[o, :len(w)] = np.arange(lo, lo + len(w))
        wts[o, :len(w)] = np.asarray(w, np.float64).astype(np.float32)
    return idx, wts


def resample(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """float32 [h, w, c] -> float32 [out_h, out_w, c] of whole numbers in
    [0, 255]: the horizontal pass over each row's taps in order, then the
    vertical pass, round (to nearest even), clamp."""
    h, w, c = x.shape
    ix, wx = (torch.from_numpy(a).to(x.device) for a in resample_taps(w, out_w))
    iy, wy = (torch.from_numpy(a).to(x.device) for a in resample_taps(h, out_h))
    tmp = torch.zeros((h, out_w, c), dtype=torch.float32, device=x.device)
    for k in range(ix.shape[1]):
        tmp = tmp + wx[None, :, k, None] * x[:, ix[:, k], :]
    acc = torch.zeros((out_h, out_w, c), dtype=torch.float32, device=x.device)
    for k in range(iy.shape[1]):
        acc = acc + wy[:, k, None, None] * tmp[iy[:, k]]
    return acc.round().clamp(0, 255)


def decode_image(coefs: Coefficients, i: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Image ``i`` of the batch by the plain version: (int32 [hs, ws, 3]
    scaled RGB, uint8 [size, size, 3])."""
    status, _, _, ncomp, _, ws, hs, first = (int(v) for v in coefs.images[i])
    if status:
        raise ValueError(f"image {i} was refused (status {status})")
    basis = coefs.region("basis", torch.float32, 512).view(8, 8, 8)
    qt = coefs.region("qt", torch.int32, coefs.n * MAX_COMPS * 64).view(-1, 64)
    coef = coefs.region("coef", torch.int16, coefs.total_blocks * 64)
    comps = []
    for c in range(ncomp):
        rec = coefs.comps[first + c]
        block_off, bw, bh = int(rec[0]), int(rec[1]), int(rec[2])
        nx, ny, srcw, srch = (int(v) for v in rec[10:14])
        blocks = coef[block_off * 64:(block_off + bw * bh) * 64].view(-1, 64)
        o = idct_blocks(blocks, qt[first + c], nx, basis, ny)
        pix = (o + 128.0).round().clamp(0, 255).to(torch.int32)
        plane = pix.view(bh, bw, ny, nx).permute(0, 2, 1, 3).reshape(bh * ny, bw * nx)
        up = _fancy(plane, rec, srch, srcw)
        if (srch, srcw) != (hs, ws):
            up = resample(up.to(torch.float32)[..., None], hs, ws)[..., 0].to(torch.int32)
        comps.append(up)
    if ncomp == 1:
        rgb = comps[0][..., None].expand(hs, ws, 3)
    else:
        rgb = ycbcr_to_rgb(*comps)
    size = coefs.size
    if ws == size and hs == size:
        return rgb, rgb.to(torch.uint8)
    return rgb, resample(rgb.to(torch.float32), size, size).to(torch.uint8)


def jpeg_idct_reference(coefs: Coefficients, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``jpeg_idct``, on the batch's device, one
    image at a time: the IDCT as products with the cosine basis, the
    upsample, the colour conversion and the resample on tensors."""
    _check(coefs, out)
    if out is None:
        out = coefs.data.new_empty((coefs.n, coefs.size, coefs.size, 3))
    for i in range(coefs.n):
        if coefs.images[i, 0] == 0:
            out[i] = decode_image(coefs, i)[1]
    return out

