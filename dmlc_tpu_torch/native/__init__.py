"""ctypes bindings for the native (C++) data-plane library.

Copied from ``dmlc_tpu/native/__init__.py``, with the package's own copy of
the source, ``image_pipeline.cpp`` beside this file, built by ``g++`` into
``dmlc_tpu_torch/_build/libdmlc_native.so`` (a directory ``.gitignore``
lists) with the flags of ``native/Makefile``; it needs libjpeg's headers and
library.

``decode_resize_batch`` is the high-throughput replacement for the PIL path
in ops/preprocess.py — libjpeg DCT-domain downscaling + thread-pooled
triangle resampling (PIL BILINEAR semantics), one call per shard. When the
library is absent the callers fall back to PIL transparently, so nothing in
the framework hard-requires the toolchain at runtime.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "image_pipeline.cpp"
_LIB_PATH = Path(__file__).resolve().parent.parent / "_build" / "libdmlc_native.so"
# native/Makefile's CXXFLAGS and LDFLAGS.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-ljpeg", "-lpthread")
# v2: persistent decode pool (dmlc_pool_size/dmlc_pool_shutdown) replacing
# the spawn-and-join-per-call threading of v1.
_ABI_VERSION = 2

_lib = None
_load_failed = False


def _load():
    """Bind to an ALREADY-BUILT library. Never compiles: _load sits on the
    serving hot path (load_batch -> available()), and a surprise g++ run
    there would stall the first inference shard. Compilation happens only
    through ensure_built()/build(), called off the per-shard path."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        if lib.dmlc_native_abi_version() != _ABI_VERSION:
            log.warning("native library ABI mismatch; rebuild with native.build()")
            return None
        lib.dmlc_decode_resize_batch.restype = ctypes.c_int
        lib.dmlc_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.dmlc_pool_size.restype = ctypes.c_int
        lib.dmlc_pool_size.argtypes = []
        lib.dmlc_pool_shutdown.restype = None
        lib.dmlc_pool_shutdown.argtypes = []
        _lib = lib
    except Exception as e:
        log.warning("native image pipeline unavailable (%s); using PIL", e)
        _load_failed = True
    return _lib


def build() -> None:
    """Compile the library with g++. Raises on failure. The library is
    written under a name of this thread's own and moved into place, so
    threads or processes that build at once never load a half-written file."""
    global _lib, _load_failed
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f".{_LIB_PATH.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        done = subprocess.run(
            ["g++", *CXXFLAGS, str(_SRC), "-o", str(tmp), *LDFLAGS],
            capture_output=True, text=True,
        )
        if done.returncode:
            raise RuntimeError(f"g++ failed ({done.returncode}): {done.stderr.strip()}")
        os.replace(tmp, _LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
    _lib, _load_failed = None, False  # rebind on next use


def _stale() -> bool:
    """Is the .so missing or older than its source or its flags (this
    file)? Checked in Python so a prebuilt library on a toolchain-less host
    never spawns g++."""
    if not _LIB_PATH.exists():
        return True
    so_mtime = _LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > so_mtime for s in (_SRC, Path(__file__)))


def ensure_built() -> bool:
    """Build if missing or source-stale (best effort) and report
    availability. Call at start-up — never from the per-shard path."""
    if not _load_failed and _stale():
        try:
            build()
        except Exception as e:
            log.warning("native build failed (%s); PIL fallback stays active", e)
    return available()


def available() -> bool:
    return _load() is not None


def decode_resize_batch(
    paths,
    size: int = 224,
    workers: int = 0,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode+resize JPEGs -> (uint8 [N, size, size, 3], status int32 [N]).

    ``out``, when given, is a caller-owned reusable arena the batch decodes
    into (C-contiguous uint8 [N, size, size, 3]) — repeated batches then
    allocate nothing per call; None allocates fresh. status[i] != 0 marks a
    failed decode (that slot is zeros). ``workers`` sizes the library's
    persistent worker pool (grow-only; 0 = hardware concurrency). Raises
    RuntimeError if the native library is unavailable — callers that want
    the automatic PIL fallback go through ops.preprocess.load_batch.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native image pipeline not available")
    n = len(paths)
    shape = (n, size, size, 3)
    if out is None:
        out = np.empty(shape, np.uint8)
    elif (
        not isinstance(out, np.ndarray)
        or out.shape != shape
        or out.dtype != np.uint8
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {shape}")
    status = np.zeros(n, np.int32)
    if n == 0:
        return out, status
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.dmlc_decode_resize_batch(
        c_paths,
        n,
        size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        int(workers),
    )
    return out, status


def pool_size() -> int:
    """Worker count of the library's persistent decode pool (0 before the
    first batch or when the library is absent)."""
    lib = _load()
    return int(lib.dmlc_pool_size()) if lib is not None else 0


def pool_shutdown() -> None:
    """Join the persistent pool's workers (no-op without the library).
    Restartable: the next decode call re-grows the pool."""
    lib = _load()
    if lib is not None:
        lib.dmlc_pool_shutdown()
