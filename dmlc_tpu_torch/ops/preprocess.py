"""Image preprocessing: decode, resize, ImageNet-normalize, batch.

Host side of ``dmlc_tpu/ops/preprocess.py``: JPEG/PNG decode and resize to
uint8 HWC (PIL on a cached thread pool), the synset-words and fixture-path
utilities, and the decode tier's bytes-in decoder. The native libjpeg
pipeline of the JAX package is not bound here yet, so every decode goes
through PIL. ``normalize`` is the device side in PyTorch; the serving
engine uses the ``normalize_u8`` kernel (ops/kernels.py) instead.
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
    paths: Sequence[str | Path], size: int = 224, workers: int | None = None
) -> np.ndarray:
    """Decode+resize a batch -> uint8 [N, size, size, 3] (fresh array)."""
    out = np.empty((len(paths), size, size, 3), np.uint8)
    return load_batch_into(out, paths, size=size, workers=workers)


@hot_path
def load_batch_into(
    out: np.ndarray,
    paths: Sequence[str | Path],
    size: int = 224,
    workers: int | None = None,
) -> np.ndarray:
    """Decode+resize a batch into the caller-owned arena ``out`` (returned),
    which must be C-contiguous uint8 [len(paths), size, size, 3]. Images
    decode on the cached host pool (PIL releases the GIL while decoding);
    ``workers`` is a concurrency hint the pool grows to."""
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
    blobs: Sequence[bytes], size: int = 224, workers: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of raw encoded-image bytes (the decode tier's wire
    unit) -> ``(uint8 [N, size, size, 3], status uint8 [N])``. A nonzero
    status marks an undecodable blob, whose rows are zeros: per-blob failure
    is data, so the ``job.decode`` handler can name the poison indices."""
    n = len(blobs)
    out = np.zeros((n, size, size, 3), np.uint8)
    status = np.zeros(n, np.uint8)
    if not n:
        return out, status

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
