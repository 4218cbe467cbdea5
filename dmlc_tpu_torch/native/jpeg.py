"""ctypes binding of the baseline JPEG entropy decoder, ``jpeg_entropy.cpp``.

The host stage of the device decode (``ops/preprocess.load_batch_device``):
each JPEG of a batch is parsed and Huffman-decoded into quantized DCT
coefficients, with no libjpeg and no other library, into a caller-owned
arena (:class:`JpegArena`) that is reused from batch to batch and copied to
the card in one piece; the ``jpeg_idct`` kernel (``ops/jpeg.py``) does the
rest there, from the plan ``jpeg_plan.cpp`` builds for each batch (the
IDCT's runs, the colour pass's tiles and resample tables; ``ops/jpeg.py``
``batch_plan``). ``g++`` builds both sources into
``dmlc_tpu_torch/_build/libdmlc_jpeg.so`` (a directory ``.gitignore``
lists) at first use, or when a source or this file is newer than the
library; a failed build raises.

Status codes (``STATUS``) name why an image was refused; a refused image
has no blocks in the arena, and the callers decode it through PIL.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading
from dataclasses import dataclass, replace
from functools import lru_cache
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent / "jpeg_entropy.cpp"
_PLAN_SRC = _SRC.with_name("jpeg_plan.cpp")
_LIB_PATH = Path(__file__).resolve().parent.parent / "_build" / "libdmlc_jpeg.so"
# No fused multiply-add: the plan's tap weights round each double operation
# as ops/jpeg.py resample_taps does.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off")
LDFLAGS = ("-shared", "-lpthread")
_ABI_VERSION = 1

#: Status of an image, as jpeg_entropy.cpp writes it.
STATUS = {0: "ok", 1: "read_failed", 2: "not_jpeg", 3: "progressive", 4: "arithmetic",
          5: "unsupported_sof", 6: "precision", 7: "color_space", 8: "sampling",
          9: "corrupt", 10: "truncated", 11: "too_large"}

#: int32 fields of the arena's header, of an image record (status, width,
#: height, ncomp, M, ws, hs, first component) and of a component record
#: (jpeg_entropy.cpp).
HDR_INTS, IMG_INTS, COMP_INTS, MAX_COMPS = 16, 8, 16, 3
COMP_FIELDS = ("block_off", "bw", "bh", "plane_off", "pw", "ph", "cw", "ch", "fx", "fy", "nx",
               "ny", "srcw", "srch", "image", "reserved")

_lib = None
_LOCK = threading.Lock()


def build_command(out: Path = _LIB_PATH) -> list[str]:
    """The g++ command line that builds the library into ``out``."""
    return ["g++", *CXXFLAGS, str(_SRC), str(_PLAN_SRC), "-o", str(out), *LDFLAGS]


def build() -> None:
    """Compile the library with g++; raises with the compiler's output on
    failure. Written under a name of this thread's own and moved into
    place, so concurrent builds never load a half-written file."""
    global _lib
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f".{_LIB_PATH.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        done = subprocess.run(build_command(tmp), capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"jpeg_entropy build failed (g++ exit {done.returncode}): "
                               f"{done.stderr.strip()}")
        os.replace(tmp, _LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
    _lib = None


def _stale() -> bool:
    if not _LIB_PATH.exists():
        return True
    built = _LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in (_SRC, _PLAN_SRC, Path(__file__)))


def load() -> ctypes.CDLL:
    """The loaded library, built first when missing or stale. Raises when
    it cannot be built or loaded."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        if lib.dmlc_jpeg_abi_version() != _ABI_VERSION:
            raise RuntimeError(f"{_LIB_PATH}: ABI {lib.dmlc_jpeg_abi_version()}, "
                               f"expected {_ABI_VERSION}")
        lib.dmlc_jpeg_layout.restype = None
        lib.dmlc_jpeg_layout.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
        lib.dmlc_jpeg_decode_batch.restype = ctypes.c_int
        lib.dmlc_jpeg_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        lib.dmlc_jpeg_pool_size.restype = ctypes.c_int
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.dmlc_jpeg_taps.restype = ctypes.c_int64
        lib.dmlc_jpeg_taps.argtypes = [ctypes.c_int, ctypes.c_int, p32, p32,
                                       ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.dmlc_jpeg_geometry_plan.restype = ctypes.c_int64
        lib.dmlc_jpeg_geometry_plan.argtypes = [ctypes.c_int] * 3 + [p32, ctypes.c_int]
        lib.dmlc_jpeg_batch_plan.restype = ctypes.c_int64
        lib.dmlc_jpeg_batch_plan.argtypes = [p32, p32, ctypes.c_int, ctypes.c_int]
        lib.dmlc_jpeg_plan_take.restype = ctypes.c_int64
        lib.dmlc_jpeg_plan_take.argtypes = [p32, ctypes.c_int64]
        lib.dmlc_jpeg_plan_forget.restype = None
        _lib = lib
        return lib


@lru_cache(maxsize=None)
def layout(n: int) -> dict[str, int]:
    """Byte offsets of the arena's regions for a batch of ``n``."""
    out = (ctypes.c_int64 * 5)()
    load().dmlc_jpeg_layout(int(n), out)
    return dict(zip(("basis", "images", "comps", "qt", "coef"), (int(v) for v in out)))


@lru_cache(maxsize=1)
def idct_basis() -> np.ndarray:
    """float32 [8, 8, 8]: ``basis[N - 1, x, u] = c(u) cos((2x + 1) u pi /
    2N) / sqrt(8)`` for x, u < N (zeros elsewhere), c(0) = 1 and c(u) =
    sqrt(2): the two passes of an N-point IDCT over the first N
    coefficients of each row and column then carry libjpeg's 1/8."""
    b = np.zeros((8, 8, 8), np.float64)
    for m in range(1, 9):
        for x in range(m):
            for u in range(m):
                c = 1.0 if u == 0 else math.sqrt(2.0)
                b[m - 1, x, u] = c * math.cos((2 * x + 1) * u * math.pi / (2 * m)) / math.sqrt(8.0)
    return b.astype(np.float32)


class JpegArena:
    """A caller-owned, grow-only buffer a batch's coefficients land in:
    pinned host memory when ``pin`` (the card's copy then runs
    asynchronously). ``lock`` serialises its users, each of whom has
    finished its copy out of the arena before it lets go."""

    def __init__(self, pin: bool = False):
        self.pin = bool(pin)
        self.tensor: torch.Tensor | None = None
        self.lock = threading.Lock()

    def reserve(self, nbytes: int) -> torch.Tensor:
        if self.tensor is None or self.tensor.numel() < nbytes:
            size = max(int(nbytes * 1.25), 1 << 20)
            t = torch.empty(size, dtype=torch.uint8, pin_memory=self.pin)
            base = layout(0)["basis"]
            basis = idct_basis().view(np.uint8).reshape(-1)
            t.numpy()[base:base + basis.size] = basis
            self.tensor = t
        return self.tensor


@dataclass(frozen=True)
class Coefficients:
    """One entropy-decoded batch. ``data`` holds the arena's first
    ``nbytes`` bytes (on the host, or on the card after :meth:`to`);
    ``images`` and ``comps`` are host copies of its records."""

    data: torch.Tensor
    nbytes: int
    n: int
    size: int
    offsets: dict
    total_blocks: int
    plane_bytes: int
    images: np.ndarray  # int32 [n, IMG_INTS]
    comps: np.ndarray   # int32 [n * MAX_COMPS, COMP_INTS]

    @property
    def status(self) -> np.ndarray:
        return self.images[:, 0].copy()

    def to(self, device: torch.device) -> "Coefficients":
        """The batch with ``data`` copied to ``device`` in one copy on the
        current stream (asynchronous from pinned memory)."""
        return replace(self, data=self.data[:self.nbytes].to(device, non_blocking=True))

    def region(self, name: str, dtype: torch.dtype, count: int) -> torch.Tensor:
        """``count`` elements of ``dtype`` at region ``name`` of ``data``."""
        start = self.offsets[name]
        size = torch.empty((), dtype=dtype).element_size()
        return self.data[start:start + count * size].view(dtype)


def decode(srcs: Sequence[str | os.PathLike | bytes], size: int, arena: JpegArena,
           workers: int = 0) -> Coefficients:
    """Entropy-decode ``srcs`` (all file paths, or all in-memory bytes)
    into ``arena``; the caller holds ``arena.lock`` and has waited for its
    last copy. ``workers`` sizes the library's persistent pool (grow-only;
    0 = hardware concurrency)."""
    lib = load()
    n = len(srcs)
    offsets = layout(n)
    raw = bool(n) and isinstance(srcs[0], (bytes, bytearray, memoryview))
    if raw:
        keep = [bytes(s) for s in srcs]
        bufs = (ctypes.c_void_p * n)(*[ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p).value
                                       for b in keep])
        lens = (ctypes.c_int64 * n)(*[len(b) for b in keep])
        paths = None
    else:
        paths = (ctypes.c_char_p * max(n, 1))(*[os.fsencode(os.fspath(s)) for s in srcs])
        bufs = lens = None
    needed = ctypes.c_int64(0)
    tensor = arena.reserve(offsets["coef"])
    for _ in range(2):
        rc = lib.dmlc_jpeg_decode_batch(paths, bufs, lens, n, int(size), tensor.data_ptr(),
                                        tensor.numel(), ctypes.byref(needed), int(workers))
        if rc != -1:
            break
        tensor = arena.reserve(needed.value)
    if rc < 0:
        raise RuntimeError(f"jpeg_entropy: batch of {n} refused (rc {rc}): its blocks or "
                           f"planes overflow the arena's int32 offsets")
    host = tensor.numpy()
    hdr = host[:HDR_INTS * 4].view(np.int32)
    images = host[offsets["images"]:offsets["comps"]].view(np.int32).reshape(n, IMG_INTS).copy()
    comps = host[offsets["comps"]:offsets["qt"]].view(np.int32).reshape(
        n * MAX_COMPS, COMP_INTS).copy()
    return Coefficients(data=tensor, nbytes=int(needed.value), n=n, size=int(size),
                        offsets=offsets, total_blocks=int(hdr[2]), plane_bytes=int(hdr[3]),
                        images=images, comps=comps)


def pool_size() -> int:
    """Workers of the library's persistent pool."""
    return int(load().dmlc_jpeg_pool_size())
