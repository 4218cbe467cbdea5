"""The predict path's two hand-written CUDA kernels, with their plain versions,
and the launch counts of every kernel wrapper in the package.

Counterpart of ``dmlc_tpu/ops/pallas_kernels.py`` for the kernels on the
``job.predict`` path:

- ``normalize_u8`` (``csrc/normalize_u8.cu``): uint8 NHWC -> normalized
  float, one read and one write per element;
- ``softmax_top1`` (``csrc/softmax_top1.cu``): [B, C] float32, bfloat16 or
  float16 logits -> top-1 index and probability without writing the
  softmax matrix.

Each wrapper checks its inputs, then runs the plain PyTorch version
(``*_reference``) when the tensor lies on the CPU and launches its kernel
when it lies on a CUDA device. A failed build or launch raises; there is no
fallback from the kernel to the plain version.

The launch path is shared by every wrapper and costs the host a few
microseconds beside the ctypes call: the checks read each tensor's device
as one int (``_device_index``: ``is_cuda``/``is_cpu`` and ``get_device()``,
no ``torch.device`` built), and ``_launch`` compares that index with the
current device and passes the device's current stream as a raw pointer
(``_raw_stream``), read at each call, with no ``torch.cuda.Stream`` built.
Outputs come from the input's ``new_empty`` (its dtype and device, none
parsed). The paged attention's output and scratch are views of one
allocation; two small outputs (``softmax_top1``'s) stay two, which
measured cheaper than one allocation cut by views. The entry points are
loaded with ``ctypes.CDLL``, which releases the GIL around the call
(``ctypes.PyDLL``, which keeps it, measured the same). Each wrapper counts its
kernel launches in its ``launches`` attribute (the flash wrappers, which
pick among several entry points, in a ``Counter`` by entry point, head dim
and dtype); ``KERNELS`` lists every wrapper of the package (``ops/ragged_decode.py`` adds the page gather and
the paged decode attention, ``ops/flash.py`` the three flash-attention
kernels when the ``ops`` package is imported), so one reset and one read
cover them all.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from dmlc_tpu_torch.ops import _build

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_MAX_CHANNELS = 4


class _NormParams(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_float * 4), ("bias", ctypes.c_float * 4)]


_SIGNATURES = {
    "normalize_u8": (
        "dmlc_normalize_u8",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, _NormParams, ctypes.c_void_p],
    ),
    # float32 logits (softmax_top1_bf16 and _f16 below take the others).
    "softmax_top1": (
        "dmlc_softmax_top1",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p],
    ),
    "gather_pages": (
        "dmlc_gather_pages",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    ),
    # Dynamic shared memory a block of the bulk kernel takes.
    "gather_pages_smem_bytes": ("dmlc_gather_pages_smem_bytes", []),
    # Paged decode attention (ops/ragged_decode.py): q, k_pages, v_pages;
    # num_pages, page_size, heads, dh; table, b, max_pages; lengths,
    # len_is_i64, scale, is_bf16; scratch, out; the stream.
    "paged_decode": (
        "dmlc_paged_decode",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 2
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p] * 3,
    ),
    # The positions a block of it takes (the scratch is sized by them).
    "paged_decode_split": ("dmlc_paged_decode_split", []),
    # Flash attention (ops/flash.py): tensor pointers, then bh, s, dh,
    # causal, scale, is_bf16 and the stream.
    "flash_fwd": (
        "dmlc_flash_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                      ctypes.c_void_p],
    ),
    "flash_bwd_dq": (
        "dmlc_flash_bwd_dq",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                      ctypes.c_void_p],
    ),
    "flash_bwd_dkv": (
        "dmlc_flash_bwd_dkv",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                      ctypes.c_void_p],
    ),
}
# The same three at any head dim past 128 (csrc/flash_wide.cu): the public
# functions reach the bf16 backward's past 512 (ops/flash._entry_name
# picks), with the same arguments.
_SIGNATURES.update({
    f"flash_wide_{name[6:]}": (f"dmlc_flash_wide_{name[6:]}", _SIGNATURES[name][1])
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
})
# The page gather's design before the bulk-copy kernel (its 16-byte vector
# kernel on the aligned path), with the same arguments: timed beside the
# bulk kernel, never called by a wrapper.
_SIGNATURES["gather_pages_vec16"] = ("dmlc_gather_pages_vec16", _SIGNATURES["gather_pages"][1])
# softmax_top1 on bf16 and float16 logits; and, float32 only, timed beside
# it and never called by a wrapper, its vector kernel launched without the
# programmatic launch (``nopdl``) and the warp-a-row design it replaced
# (``warp``); all with the same arguments.
_SIGNATURES.update({
    f"softmax_top1_{tag}": (f"dmlc_softmax_top1_{tag}", _SIGNATURES["softmax_top1"][1])
    for tag in ("bf16", "f16", "nopdl", "warp")
})
# An empty kernel's launch (the device time any launch pays), for timing.
_SIGNATURES["launch_floor"] = ("dmlc_launch_floor", [ctypes.c_void_p])
#: The library (csrc/<name>.cu) of each entry point that does not live in
#: its own name's.
_LIBRARY = {name: "flash_wide" for name in _SIGNATURES if name.startswith("flash_wide_")}
_LIBRARY.update(paged_decode_split="paged_decode", gather_pages_vec16="gather_pages",
                gather_pages_smem_bytes="gather_pages", launch_floor="softmax_top1",
                **{f"softmax_top1_{tag}": "softmax_top1" for tag in ("bf16", "f16", "nopdl", "warp")})


_ENTRIES: dict[str, tuple] = {}


def _entry(name: str):
    """(library, C entry point with its argtypes set) of kernel ``name``,
    built and bound once per process."""
    entry = _ENTRIES.get(name)
    if entry is None:
        lib = _build.load(_LIBRARY.get(name, name))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entry = _ENTRIES[name] = (lib, fn)
    return entry


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device ``index``, as the pointer a kernel
    entry point takes: one call into PyTorch's C++ (the function its own
    generated code uses), where ``torch.cuda.current_stream()`` builds a
    Python ``Stream`` object first."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(t: torch.Tensor, fn, *args) -> int:
    """Call kernel entry point ``fn`` on CUDA tensor ``t``'s device and that
    device's current stream, read at this call. A tensor on another device
    than the current one launches under that device's guard."""
    index = t.get_device()
    if index == torch._C._cuda_getDevice():
        return fn(*args, _raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, _raw_stream(index))


def _device_index(t: torch.Tensor, what: str) -> int:
    """``t``'s device as one int, -1 for the CPU and the device index for
    CUDA, read without building a ``torch.device``; any other device type
    raises ``ValueError``. Two tensors that pass lie on the same device
    exactly when their indices are equal."""
    if t.is_cuda:
        return t.get_device()
    if t.is_cpu:
        return -1
    raise ValueError(f"{what}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# uint8 -> normalized float (NHWC)
# ---------------------------------------------------------------------------


def affine_constants(mean, std, channels: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel ``scale = 1 / (255 * std)`` and ``bias = -mean / std`` in
    float32, computed exactly as the JAX kernel computes them, so both
    packages multiply by the same constants."""
    mean = np.asarray(mean, np.float32).reshape(-1)
    std = np.asarray(std, np.float32).reshape(-1)
    if mean.shape != (channels,) or std.shape != (channels,):
        raise ValueError(
            f"mean/std must have {channels} entries, got {mean.shape} and {std.shape}"
        )
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    bias = (-mean / std).astype(np.float32)
    return scale, bias


def _check_normalize(batch_u8: torch.Tensor, out_dtype: torch.dtype) -> int:
    """Raises on what neither version takes; returns the device index
    (``_device_index``)."""
    if not isinstance(batch_u8, torch.Tensor):
        raise TypeError("normalize_u8: batch_u8 must be a torch.Tensor")
    index = _device_index(batch_u8, "normalize_u8")
    if batch_u8.dtype != torch.uint8:
        raise TypeError(f"normalize_u8: expected uint8, got {batch_u8.dtype}")
    if batch_u8.dim() != 4:
        raise ValueError(f"normalize_u8: expected [N, H, W, C], got {tuple(batch_u8.shape)}")
    if not batch_u8.is_contiguous():
        raise ValueError("normalize_u8: batch_u8 must be contiguous (NHWC)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"normalize_u8: out_dtype must be one of {_OUT_DTYPES}")
    return index


def normalize_u8_reference(
    batch_u8: torch.Tensor, mean, std, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch version: ``x * scale + bias`` in float32 (multiply and
    add each rounded), then one cast to ``out_dtype``."""
    scale, bias = affine_constants(mean, std, batch_u8.shape[-1])
    x = batch_u8.to(torch.float32)
    y = x * torch.from_numpy(scale).to(x.device) + torch.from_numpy(bias).to(x.device)
    return y.to(out_dtype)


def normalize_u8(
    batch_u8: torch.Tensor, mean, std, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 [N, H, W, C] -> ((x / 255) - mean) / std as ``out_dtype``
    (float32 or bfloat16), same shape and layout. One pass: each byte is
    read once and each output written once."""
    index = _check_normalize(batch_u8, out_dtype)
    c = batch_u8.shape[-1]
    if index < 0:
        return normalize_u8_reference(batch_u8, mean, std, out_dtype)
    if c > _MAX_CHANNELS:
        raise ValueError(f"normalize_u8: the kernel takes at most {_MAX_CHANNELS} channels, got {c}")
    scale, bias = affine_constants(mean, std, c)
    out = batch_u8.new_empty(batch_u8.shape, dtype=out_dtype)
    if batch_u8.numel() == 0:
        return out
    params = _NormParams()
    for i in range(c):
        params.scale[i] = float(scale[i])
        params.bias[i] = float(bias[i])
    lib, fn = _entry("normalize_u8")
    rc = _launch(batch_u8, fn, batch_u8.data_ptr(), out.data_ptr(), batch_u8.numel(), c,
                 int(out_dtype == torch.bfloat16), params)
    _build.check(lib, rc, "normalize_u8")
    normalize_u8.launches += 1
    return out


normalize_u8.launches = 0  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# fused softmax + top-1 readout
# ---------------------------------------------------------------------------


#: The entry point of each logits dtype softmax_top1 takes: those the TPU
#: kernel takes (it casts any float to float32). float64 is refused: JAX
#: holds none with x64 off.
_TOP1_ENTRIES = {torch.float32: "softmax_top1", torch.bfloat16: "softmax_top1_bf16",
                 torch.float16: "softmax_top1_f16"}


def _check_logits(logits: torch.Tensor) -> int:
    """Raises on what neither version takes; returns the device index
    (``_device_index``)."""
    if not isinstance(logits, torch.Tensor):
        raise TypeError("softmax_top1: logits must be a torch.Tensor")
    index = _device_index(logits, "softmax_top1")
    if logits.dtype not in _TOP1_ENTRIES:
        raise TypeError(f"softmax_top1: expected float32, bfloat16 or float16 logits, "
                        f"got {logits.dtype}")
    if logits.dim() != 2 or logits.shape[1] == 0:
        raise ValueError(f"softmax_top1: expected [B, C] with C > 0, got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("softmax_top1: logits must be contiguous")
    return index


def softmax_top1_reference(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. The index is the FIRST column holding the row
    maximum (a NaN counts as the maximum), written out explicitly rather
    than left to ``torch.argmax``'s tie order; the probability is
    ``1 / sum(exp(x - max))``."""
    x = logits.to(torch.float32)
    m = x.max(dim=1, keepdim=True).values  # NaN-propagating
    is_top = (x == m) | torch.isnan(x)
    cols = torch.arange(x.shape[1], device=x.device).expand_as(x)
    idx = torch.where(is_top, cols, x.shape[1]).min(dim=1).values.to(torch.int32)
    prob = 1.0 / torch.exp(x - m).sum(dim=1)
    return idx, prob


def softmax_top1(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, C] float32, bfloat16 or float16 logits -> (top-1 index int32
    [B], top-1 probability float32 [B]), each logit read once and taken to
    float32 exactly; the softmax matrix is never written."""
    index = _check_logits(logits)
    if index < 0:
        return softmax_top1_reference(logits)
    b, c = logits.shape
    idx = logits.new_empty(b, dtype=torch.int32)
    prob = logits.new_empty(b, dtype=torch.float32)
    if b == 0:
        return idx, prob
    lib, fn = _entry(_TOP1_ENTRIES[logits.dtype])
    rc = _launch(logits, fn, logits.data_ptr(), b, c, idx.data_ptr(), prob.data_ptr())
    _build.check(lib, rc, "softmax_top1")
    softmax_top1.launches += 1
    return idx, prob


softmax_top1.launches = 0  # type: ignore[attr-defined]


#: The wrappers whose ``launches`` a run can read and reset (the page
#: gather, the paged decode attention and the flash kernels register
#: themselves from ``ops/ragged_decode.py`` and ``ops/flash.py``).
KERNELS = {"normalize_u8": normalize_u8, "softmax_top1": softmax_top1}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = type(fn.launches)()  # type: ignore[attr-defined]


def launch_counts() -> dict[str, int]:
    """Launches of each wrapper since the last reset."""
    return {name: sum(fn.launches.values()) if isinstance(fn.launches, Counter)  # type: ignore[attr-defined]
            else int(fn.launches) for name, fn in KERNELS.items()}  # type: ignore[attr-defined]


def entry_launch_counts() -> Counter:
    """Launches since the last reset of the wrappers that pick an entry
    point (the flash kernels), by (entry point, head dim, dtype): which
    kernel ran each head dim."""
    counts: Counter = Counter()
    for fn in KERNELS.values():
        if isinstance(fn.launches, Counter):  # type: ignore[attr-defined]
            counts.update(fn.launches)  # type: ignore[attr-defined]
    return counts
