"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/lib<name>.so``
(the build directory is listed in ``.gitignore``) with a plain C interface:
pointers and the CUDA stream are passed as ``void*``, and every entry point
returns ``cudaGetLastError()`` so the Python wrapper can raise on a refused
launch. A library is rebuilt when its source is newer than it. Stale
libraries are compiled in parallel, one ``nvcc`` process per source, all
started together. A failed build raises; nothing falls back. Each library
compiled is recorded in the device monitor's build census
(``cluster/devicemon.CENSUS``) under ``kernel/<name>``; one loaded from
``_build/`` without a compile is not.

Nothing here runs at import time: the CPU-only test environment imports this
module and never builds.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: sm_90a (not sm_90): the Hopper-only instructions (wgmma, setmaxnreg) that
#: later kernels need exist only for the "a" target.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: ptxas report (registers, shared memory, spills) of the last build of
#: each kernel in this process, keyed by kernel name.
build_log: dict[str, str] = {}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    """Every kernel source in ``csrc/``, by stem."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    src_mtime = max(
        [(CSRC_DIR / f"{name}.cu").stat().st_mtime]
        + [h.stat().st_mtime for h in CSRC_DIR.glob("*.cuh")]
    )
    return lib.stat().st_mtime < src_mtime


def build(names: list[str] | None = None) -> float:
    """Compile every stale kernel in ``names`` (default: all), in parallel.
    Returns the wall seconds spent; raises ``RuntimeError`` with the
    compiler's output when any compile fails. Each library compiled is
    recorded in ``devicemon.CENSUS`` as ``kernel/<name>`` with its own nvcc
    process's wall seconds."""
    from dmlc_tpu_torch.cluster.devicemon import CENSUS

    names = kernel_names() if names is None else list(names)
    for name in names:
        if not (CSRC_DIR / f"{name}.cu").is_file():
            raise FileNotFoundError(f"no kernel source csrc/{name}.cu")
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        # Compile to a private name, then rename: a concurrent build of
        # the same kernel never leaves a half-written library behind.
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))

    def reap(entry):
        # One thread a compiler: each library's wall ends when its own nvcc
        # exits, not when the slowest one before it in the list does.
        name, tmp, proc = entry
        out, _ = proc.communicate()
        return name, tmp, proc, out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(procs)) as pool:
        reaped = list(pool.map(reap, procs))
    failures = []
    for name, tmp, proc, out, seconds in reaped:
        build_log[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- csrc/{name}.cu (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, library_path(name))
            CENSUS.record(f"kernel/{name}", seconds)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if stale. Loaded
    once per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a kernel entry point of ``lib`` returned a CUDA error."""
    if rc != 0:
        fn = lib.dmlc_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc} ({fn(rc).decode()}) at launch")
