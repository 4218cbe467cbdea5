"""On-device image resize as two matrix products.

Port of ``dmlc_tpu/ops/device_resize.py``. A separable triangle-filter
resample is LINEAR in the image, so ``out = Wy @ img @ Wx^T`` per channel,
with banded weight matrices precomputed on the host per (in_size, out_size)
pair — the tap weights of the native C++ decoder (native/image_pipeline.cpp
make_taps) and PIL BILINEAR semantics. The JAX package computes it outside
Pallas, as two einsums; here it is two ``torch.einsum`` calls on the
engine's device, which run as batched GEMMs on the card. The host ships
the raw uint8 pixels and no host resample runs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 row-stochastic triangle-filter weights
    (PIL BILINEAR: filter support widens by the downscale ratio)."""
    w = np.zeros((out_size, in_size), np.float32)
    scale = in_size / out_size
    support = max(1.0, scale)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(0, int(np.floor(center - support)))
        hi = min(in_size, int(np.ceil(center + support)))
        js = np.arange(lo, hi)
        d = np.abs((js + 0.5 - center) / (scale if support > 1.0 else 1.0))
        ws = np.where(d < 1.0, 1.0 - d, 0.0)
        total = ws.sum()
        if total <= 0.0:  # degenerate: nearest
            ws[:] = 0.0
            ws[np.clip(int(center), lo, hi - 1) - lo] = total = 1.0
        w[i, lo:hi] = ws / total
    return w


# Shape combinations already seen by resize_batch: each NEW (N, H, W, out)
# is recorded once in the device census (cluster/devicemon.py), as the JAX
# package records the compile such a shape costs there.
_SEEN_SHAPES: set = set()


def resize_batch(images, out_size: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[N, H, W, C] (any numeric dtype; a tensor, or an array taken to the
    CPU) -> [N, out, out, C] ``dtype`` on the input's device.

    Two einsums over precomputed weight matrices."""
    x = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.asarray(images))
    n, h, w, c = x.shape
    combo = (int(n), int(h), int(w), int(out_size))
    if combo not in _SEEN_SHAPES:
        _SEEN_SHAPES.add(combo)
        from dmlc_tpu_torch.cluster.devicemon import CENSUS

        CENSUS.record(f"device_resize/{h}x{w}->{out_size}")
    wy = torch.from_numpy(triangle_weights(int(h), out_size)).to(x.device, dtype)
    wx = torch.from_numpy(triangle_weights(int(w), out_size)).to(x.device, dtype)
    x = x.to(dtype)
    x = torch.einsum("oh,nhwc->nowc", wy, x)
    return torch.einsum("pw,nowc->nopc", wx, x)


def reference_resize(images_u8: np.ndarray, out_size: int) -> np.ndarray:
    """Pure-numpy reference (same weights) for parity tests."""
    n, h, w, c = images_u8.shape
    wy = triangle_weights(h, out_size)
    wx = triangle_weights(w, out_size)
    x = images_u8.astype(np.float32)
    x = np.einsum("oh,nhwc->nowc", wy, x)
    return np.einsum("pw,nowc->nopc", wx, x)
