"""Image preprocessing: decode, resize, ImageNet-normalize, batch.

Host side of ``dmlc_tpu/ops/preprocess.py``: JPEG/PNG decode and resize to
uint8 HWC, the synset-words and fixture-path utilities, and the decode
tier's bytes-in decoder. Decodes go through the native libjpeg pipeline
(``dmlc_tpu_torch.native``) when it is built, else through PIL on a cached
thread pool; the ``backend`` argument picks. ``normalize`` is the device
side in PyTorch; the serving engine uses the ``normalize_u8`` kernel
(ops/kernels.py) instead.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from dmlc_tpu_torch.utils.hotpath import hot_path

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

# ---- cached host decode pool ----------------------------------------------
# One module-level pool shared by every load_batch call, grow-only: a bigger
# ``workers`` request replaces the pool; the abandoned smaller pool's idle
# threads are reclaimed at interpreter exit.
_HOST_POOL: concurrent.futures.ThreadPoolExecutor | None = None
_HOST_POOL_WORKERS = 0
_HOST_POOL_LOCK = threading.Lock()


def _host_pool(workers: int) -> concurrent.futures.ThreadPoolExecutor:
    global _HOST_POOL, _HOST_POOL_WORKERS
    with _HOST_POOL_LOCK:
        if _HOST_POOL is None or _HOST_POOL_WORKERS < workers:
            _HOST_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="pp-decode"
            )
            _HOST_POOL_WORKERS = workers
        return _HOST_POOL


def load_synset_words(path: str | Path) -> list[tuple[str, str]]:
    """Parse synset_words.txt lines 'n01440764 tench, Tinca tinca' ->
    [(synset_id, label), ...] in file order. The file order defines the
    class index order."""
    out: list[tuple[str, str]] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        synset, _, label = line.partition(" ")
        out.append((synset, label))
    return out


def class_image_path(data_dir: str | Path, synset: str) -> Path:
    """First image in the per-class fixture directory."""
    d = Path(data_dir) / synset
    files = sorted(p for p in d.iterdir() if p.is_file())
    if not files:
        raise FileNotFoundError(f"no images under {d}")
    return files[0]


def decode_resize(path: str | Path, size: int = 224) -> np.ndarray:
    """JPEG/PNG -> uint8 [size, size, 3] RGB, bilinear resize straight to the
    target square (no shortest-side resize + center crop)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (size, size):  # already-staged sizes skip the resample
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


@hot_path
def load_batch(
    paths: Sequence[str | Path],
    size: int = 224,
    workers: int | None = None,
    backend: str = "auto",
) -> np.ndarray:
    """Decode+resize a batch -> uint8 [N, size, size, 3] (fresh array)."""
    out = np.empty((len(paths), size, size, 3), np.uint8)
    return load_batch_into(out, paths, size=size, workers=workers, backend=backend)


@hot_path
def load_batch_into(
    out: np.ndarray,
    paths: Sequence[str | Path],
    size: int = 224,
    workers: int | None = None,
    backend: str = "auto",
) -> np.ndarray:
    """Decode+resize a batch into the caller-owned arena ``out`` (returned),
    which must be C-contiguous uint8 [len(paths), size, size, 3]; both the
    native and the PIL path fill it in place. ``workers`` is a concurrency
    hint the cached pools (module-level here, persistent in-library for
    native) grow to. ``backend``:

    - "native" — the C++ pipeline (dmlc_tpu_torch.native): libjpeg with
      DCT-domain downscaling + a persistent thread-pooled triangle
      resample, GIL-free. Raises when the library is not built or an image
      fails to decode.
    - "pil" — PIL decode on the cached thread pool (decode releases the GIL).
    - "auto" — native when the library is built, else PIL. The two resize
      paths agree to within JPEG-noise tolerance (mean |diff| < 0.5/255 on
      the fixture corpus); a native decode failure redoes the whole batch
      through PIL.
    """
    n = len(paths)
    shape = (n, size, size, 3)
    if (
        not isinstance(out, np.ndarray)
        or out.shape != shape
        or out.dtype != np.uint8
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {shape}")
    if not n:
        return out
    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("auto", "native"):
        from dmlc_tpu_torch import native

        if native.available():
            _, status = native.decode_resize_batch(
                paths, size, workers=workers or 0, out=out
            )
            if not status.any():
                return out
            if backend == "native":
                bad = [str(paths[i]) for i in np.nonzero(status)[0][:3]]
                raise ValueError(f"native decode failed for {bad}")
            # auto: a non-JPEG (e.g. PNG) snuck in — redo the batch via PIL.
        elif backend == "native":
            raise RuntimeError("native image pipeline not built")
    workers = workers or min(32, (os.cpu_count() or 8))
    if n == 1 or workers == 1:
        for i, p in enumerate(paths):
            out[i] = decode_resize(p, size)
        return out
    pool = _host_pool(workers)

    def fill(i: int) -> None:
        out[i] = decode_resize(paths[i], size)

    list(pool.map(fill, range(n)))  # list() re-raises worker exceptions
    return out


#: Images load_batch_device's host decoder refused (a progressive JPEG, a
#: PNG, a corrupt file) and PIL decoded instead, since import.
jpeg_refused_images = 0
_REFUSED_LOCK = threading.Lock()
_ARENAS: dict = {}


def _default_arena(cuda: bool):
    from dmlc_tpu_torch.native.jpeg import JpegArena

    with _REFUSED_LOCK:
        arena = _ARENAS.get(cuda)
        if arena is None:
            arena = _ARENAS[cuda] = JpegArena(pin=cuda)
        return arena


@hot_path
def load_batch_device(
    paths: Sequence[str | Path | bytes],
    size: int = 224,
    device: str | torch.device | None = None,
    workers: int | None = None,
    out: torch.Tensor | None = None,
    arena=None,
) -> tuple[torch.Tensor, np.ndarray]:
    """Decode+resize a batch (file paths, or encoded bytes) on ``device``
    -> (uint8 [N, size, size, 3] there, int32 status [N] of the host
    decoder, nonzero where it refused the image).

    The host parses and Huffman-decodes every JPEG into a pinned arena
    (``native/jpeg.py``; ``arena`` when given, else one shared by the
    callers of this device type), one non-blocking copy on the current
    stream takes it to the card, and the ``jpeg_idct`` kernel writes the
    pixels, into ``out`` when given (a contiguous uint8 [N, size, size, 3]
    on ``device``); the call returns when the stream has done both. On the
    CPU the plain version writes them. Images the
    host decoder refuses are decoded alone by PIL (``decode_resize``) and
    copied into their rows; ``jpeg_refused_images`` counts them. A failed
    build or launch raises, and nothing falls back from the kernel. The
    spans ``host/decode`` and ``device/decode`` time the two stages."""
    global jpeg_refused_images
    from dmlc_tpu_torch.native import jpeg as native_jpeg
    from dmlc_tpu_torch.ops import jpeg as jpeg_ops
    from dmlc_tpu_torch.utils.device import resolve_device
    from dmlc_tpu_torch.utils.tracing import tracer

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        jpeg_ops.kernel_entry()  # built (or refused) before any work
    n = len(paths)
    if out is None:
        out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=dev)
    elif tuple(out.shape) != (n, size, size, 3) or out.dtype != torch.uint8 \
            or out.device != dev or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous uint8 tensor of shape {(n, size, size, 3)} "
                         f"on {dev}")
    if not n:
        return out, np.zeros(0, np.int32)
    arena = arena if arena is not None else _default_arena(cuda)
    with arena.lock:
        with tracer.span("host/decode", n=n):
            coefs = native_jpeg.decode(paths, size, arena, workers=workers or 0)
        with tracer.span("device/decode", n=n):
            if cuda:
                coefs = coefs.to(dev)
            jpeg_ops.jpeg_idct(coefs, out)
            if cuda:  # the span holds the copy and the kernel; the arena is free again
                torch.cuda.current_stream(dev).synchronize()
    status = coefs.status
    refused = np.nonzero(status)[0]
    for i in refused:
        src = paths[i]
        row = decode_blob(src, size) if isinstance(src, (bytes, bytearray, memoryview)) \
            else decode_resize(src, size)
        out[i].copy_(torch.tensor(row))
    if refused.size:
        with _REFUSED_LOCK:
            jpeg_refused_images += int(refused.size)
    return out, status


def decode_blob(data: bytes, size: int = 224) -> np.ndarray:
    """One encoded image's raw BYTES -> uint8 [size, size, 3] RGB, with the
    resize semantics of :func:`decode_resize`. Raises on undecodable bytes."""
    from io import BytesIO

    from PIL import Image

    with Image.open(BytesIO(data)) as im:
        im = im.convert("RGB")
        if im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


@hot_path
def decode_blobs(
    blobs: Sequence[bytes],
    size: int = 224,
    workers: int | None = None,
    backend: str = "auto",
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of raw encoded-image bytes (the decode tier's wire
    unit) -> ``(uint8 [N, size, size, 3], status uint8 [N])``. A nonzero
    status marks an undecodable blob, whose rows are zeros: per-blob failure
    is data, so the ``job.decode`` handler can name the poison indices.
    Backend selection mirrors :func:`load_batch_into`: the native path lands
    blobs in a throwaway tmpdir so the persistent C++ decode pool
    (path-based ABI) does the GIL-free work, and redoes only the refused
    slots through PIL, which has the last word on a poison blob; the PIL
    path decodes from memory on the cached host pool. "native" raises only
    when the library is not built.
    """
    n = len(blobs)
    out = np.zeros((n, size, size, 3), np.uint8)
    status = np.zeros(n, np.uint8)
    if not n:
        return out, status
    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("auto", "native"):
        from dmlc_tpu_torch import native

        if native.available():
            import tempfile

            with tempfile.TemporaryDirectory(prefix="dmlc-blobs-") as td:
                paths = []
                for i, b in enumerate(blobs):
                    p = Path(td) / f"{i}.img"
                    p.write_bytes(b)
                    paths.append(p)
                _, st = native.decode_resize_batch(
                    paths, size, workers=workers or 0, out=out
                )
            bad = np.nonzero(st)[0]
            if not bad.size:
                return out, status
            # Redo only the refused slots via PIL (a PNG snuck in, or the
            # blob really is poison — PIL gets the final word in "auto").
            for i in bad:
                try:
                    out[i] = decode_blob(blobs[i], size)
                except Exception:  # a poison blob is reported through its status slot
                    out[i] = 0
                    status[i] = 1
            return out, status
        if backend == "native":
            raise RuntimeError("native image pipeline not built")

    def fill(i: int) -> None:
        try:
            out[i] = decode_blob(blobs[i], size)
        except Exception:  # a poison blob is reported through its status slot
            out[i] = 0
            status[i] = 1

    workers = workers or min(32, (os.cpu_count() or 8))
    if n == 1 or workers == 1:
        for i in range(n):
            fill(i)
        return out, status
    list(_host_pool(workers).map(fill, range(n)))
    return out, status


def normalize(
    batch_u8: torch.Tensor,
    mean: np.ndarray = IMAGENET_MEAN,
    std: np.ndarray = IMAGENET_STD,
) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NHWC, as ``(x / 255 - mean) / std``
    on the tensor's own device."""
    x = torch.as_tensor(batch_u8).to(torch.float32) / 255.0
    m = torch.as_tensor(np.asarray(mean, np.float32), device=x.device)
    s = torch.as_tensor(np.asarray(std, np.float32), device=x.device)
    return (x - m) / s


def stats_for_model(model_name: str) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (numpy) normalization stats — always the same module-level
    constant objects, never rebuilt, so callers may key caches on identity."""
    if model_name.startswith("clip"):
        return CLIP_MEAN, CLIP_STD
    return IMAGENET_MEAN, IMAGENET_STD
