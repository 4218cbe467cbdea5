"""Build the native AOTInductor serving host, ``native/aoti_host.cpp``.

One ``g++`` process compiles the host into ``_build/aoti_host`` (the build
directory is listed in ``.gitignore``) against the torch install's own
headers (``include/``, ``include/torch/csrc/api/include``) and libraries
(``lib/``, with an rpath, so the binary finds them with no environment),
with torch's C++ ABI flag:

- ``-ltorch -ltorch_cpu -lc10`` always, linked with ``--no-as-needed`` so
  the libraries that register torch's devices load even though the host
  names none of their symbols;
- ``-ltorch_cuda -lc10_cuda`` and ``-DDMLC_WITH_CUDA`` when torch has CUDA
  (the CUDA toolkit's headers, and those of the ``nvidia`` wheels torch
  brings, on the include path);
- ``native/image_pipeline.cpp``, ``-ljpeg`` and ``-DDMLC_WITH_DECODER`` only
  where ``g++`` can build a program against libjpeg here (the probe
  ``jpeg_toolchain``); without it the host refuses JPEG paths.

The binary is rebuilt when it is missing, older than its sources or this
file, or was built by another command line (``_build/aoti_host.cmd``
records it: a binary linked against another torch install, or without a
decoder this machine could build, is stale). A failed build raises;
nothing falls back. Nothing runs at import.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
HOST_SRC = PKG_DIR / "native" / "aoti_host.cpp"
DECODER_SRC = PKG_DIR / "native" / "image_pipeline.cpp"
HOST_PATH = PKG_DIR / "_build" / "aoti_host"
HOST_STAMP = HOST_PATH.with_name("aoti_host.cmd")

#: The native decoder's own flags (``native/__init__.CXXFLAGS``), so the
#: host decodes the same bytes as the ctypes library.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_LOCK = threading.Lock()

#: The last build's report (seconds, decoder, cuda, the g++ command).
last_build: dict = {}


def jpeg_toolchain() -> str | None:
    """None when g++ compiles and links a program against libjpeg here
    (the decoder's needs: jpeglib.h and libjpeg.so); else why not."""
    if shutil.which("g++") is None:
        return "no g++ on PATH"
    with tempfile.TemporaryDirectory(prefix="dmlc-jpeg-probe-") as td:
        done = subprocess.run(
            ["g++", "-x", "c++", "-", "-o", str(Path(td) / "probe"), "-ljpeg"],
            input="#include <cstdio>\n#include <jpeglib.h>\n"
                  "int main() { jpeg_decompress_struct d; (void)d; return 0; }\n",
            capture_output=True, text=True, timeout=120)
    if done.returncode:
        lines = [ln for ln in done.stderr.splitlines()
                 if "error" in ln or "cannot find" in ln] or done.stderr.splitlines()
        return f"g++ cannot build against libjpeg: {lines[0].strip() if lines else done.returncode}"
    return None


def openmp_cxx() -> str:
    """A C++ compiler that builds OpenMP code, which AOTInductor's wrapper
    needs (it always compiles with ``-fopenmp`` on Linux): ``$CXX``, then
    each ``g++`` and ``c++`` on PATH in order. Raises when none does (a
    compiler whose install lacks ``libgomp.spec`` cannot)."""
    candidates = [os.environ["CXX"]] if os.environ.get("CXX") else []
    for d in os.environ.get("PATH", "").split(os.pathsep):
        candidates += [str(Path(d) / n) for n in ("g++", "c++") if (Path(d) / n).is_file()]
    tried = []
    with tempfile.TemporaryDirectory(prefix="dmlc-omp-probe-") as td:
        for cxx in dict.fromkeys(candidates):
            done = subprocess.run(
                [cxx, "-fopenmp", "-x", "c++", "-", "-o", str(Path(td) / "probe")],
                input="#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n",
                capture_output=True, text=True, timeout=120)
            if done.returncode == 0:
                return cxx
            tried.append(f"{cxx}: {done.stderr.strip().splitlines()[-1:]}")
    raise RuntimeError(f"no C++ compiler here builds OpenMP code: {tried}")


def _cuda_includes() -> list[str]:
    """The CUDA toolkit's headers, then those of the ``nvidia`` wheels."""
    dirs = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    if (Path(home) / "include").is_dir():
        dirs.append(str(Path(home) / "include"))
    for root in map(Path, sys.path):
        nvidia = root / "nvidia"
        if nvidia.is_dir():
            dirs += sorted(str(p) for p in nvidia.glob("*/include") if p.is_dir())
    return dirs


def command(out: Path, decoder: bool) -> list[str]:
    """The g++ command line that builds the host into ``out``."""
    import torch

    root = Path(torch.__file__).resolve().parent
    lib = root / "lib"
    cuda = torch.version.cuda is not None
    cmd = ["g++", *CXXFLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
           f"-I{root / 'include'}", f"-I{root / 'include' / 'torch' / 'csrc' / 'api' / 'include'}"]
    if cuda:
        cmd += ["-DDMLC_WITH_CUDA", *(f"-I{d}" for d in _cuda_includes())]
    srcs = [str(HOST_SRC)]
    if decoder:
        cmd.append("-DDMLC_WITH_DECODER")
        srcs.append(str(DECODER_SRC))
    libs = ["-ltorch", "-ltorch_cpu", "-lc10"] + (["-ltorch_cuda", "-lc10_cuda"] if cuda else [])
    return [*cmd, *srcs, "-o", str(out), f"-L{lib}", f"-Wl,-rpath,{lib}",
            "-Wl,--no-as-needed", *libs, "-Wl,--as-needed",
            *(["-ljpeg"] if decoder else []), "-lpthread"]


def build() -> dict:
    """Compile the host; returns the report (also ``last_build``). Raises
    ``RuntimeError`` with the compiler's output on failure. The binary is
    written under a name of this thread's own and moved into place."""
    import torch

    decoder = jpeg_toolchain() is None
    HOST_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = HOST_PATH.with_name(f".{HOST_PATH.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = command(tmp, decoder)
    t0 = time.perf_counter()
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"aoti_host build failed (g++ exit {done.returncode}):\n"
                               f"{done.stderr[-6000:]}")
        os.replace(tmp, HOST_PATH)
        HOST_STAMP.write_text(json.dumps(command(HOST_PATH, decoder)))
    finally:
        tmp.unlink(missing_ok=True)
    last_build.clear()
    last_build.update(seconds=time.perf_counter() - t0, decoder=decoder,
                      cuda=torch.version.cuda is not None, command=cmd)
    return dict(last_build)


def stale() -> bool:
    """Is the host missing, older than its sources or this file, or built
    by another command line than this machine's?"""
    if not HOST_PATH.exists() or not HOST_STAMP.exists():
        return True
    built = HOST_PATH.stat().st_mtime
    if any(p.stat().st_mtime > built for p in (HOST_SRC, DECODER_SRC, Path(__file__))):
        return True
    return HOST_STAMP.read_text() != json.dumps(command(HOST_PATH, jpeg_toolchain() is None))


def ensure_host() -> Path:
    """The host binary, built first if stale (at first use)."""
    with _LOCK:
        if stale():
            build()
    return HOST_PATH
