"""Ragged paged-KV decode attention: the per-step op of the generation engine.

Counterpart of ``dmlc_tpu/ops/ragged_decode.py``. Decode attends one new
query token per slot against that slot's cached K/V, whose length differs
per slot. The cache is paged (``generate/kvcache.py``): fixed-size pages
from a shared pool, stitched into a per-slot sequence by an int32 page
table.

- ``gather_kv_pages`` assembles the per-slot contiguous view. On a CUDA
  tensor it launches the hand-written page-gather kernel
  (``csrc/gather_pages.cu``); on a CPU tensor it runs the plain version
  ``gather_kv_pages_reference``. The device decides; there is no fallback
  from the kernel to the plain version.
- ``ragged_decode_attention`` is the masked attention over the gathered
  view, plain PyTorch (the JAX version is XLA, not Pallas), with
  ``parallel/ring_attention.dense_attention``'s float32 score discipline.
"""

from __future__ import annotations

import numpy as np
import torch

from dmlc_tpu_torch.ops import _build, kernels


def check_page_table(table: np.ndarray, num_pages: int) -> None:
    """Raise ``IndexError`` when a host page table holds an id outside
    ``[0, num_pages)``. The engine's table is host-owned numpy, so it is
    checked here before each upload, with no device synchronisation."""
    if table.size and (int(table.min()) < 0 or int(table.max()) >= num_pages):
        bad = table[(table < 0) | (table >= num_pages)]
        raise IndexError(
            f"gather_kv_pages: page id {int(bad.flat[0])} outside [0, {num_pages})"
        )


def _check_gather(pages: torch.Tensor, page_table: torch.Tensor) -> None:
    if not isinstance(pages, torch.Tensor) or not isinstance(page_table, torch.Tensor):
        raise TypeError("gather_kv_pages: pages and page_table must be torch.Tensors")
    kernels._require_device(pages, "gather_kv_pages")
    if pages.dim() != 4:
        raise ValueError(
            f"gather_kv_pages: pages must be [num_pages, page_size, H, Dh], got {tuple(pages.shape)}"
        )
    if page_table.dim() != 2 or page_table.dtype != torch.int32:
        raise ValueError(
            "gather_kv_pages: page_table must be int32 [B, max_pages], got "
            f"{page_table.dtype} {tuple(page_table.shape)}"
        )
    if page_table.device != pages.device:
        raise ValueError(
            f"gather_kv_pages: page_table on {page_table.device}, pages on {pages.device}"
        )
    if not (pages.is_contiguous() and page_table.is_contiguous()):
        raise ValueError("gather_kv_pages: pages and page_table must be contiguous")


def gather_kv_pages_reference(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one ``index_select`` over the flattened table,
    then a reshape to ``[B, max_pages * page_size, H, Dh]``."""
    b, max_pages = page_table.shape
    _, page_size, heads, head_dim = pages.shape
    out = torch.index_select(pages, 0, page_table.reshape(-1))
    return out.reshape(b, max_pages * page_size, heads, head_dim)


def gather_kv_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Assemble the per-slot contiguous cache view from the shared pool.

    ``pages``: [num_pages, page_size, H, Dh] (one layer's K or V pool, any
    dtype); ``page_table``: int32 [B, max_pages] on the same device — row
    b's sequence is its pages in table order (unused entries point at the
    scratch page 0 and are masked out by the attention lengths). Returns
    [B, max_pages * page_size, H, Dh].

    A CPU table is checked for ids outside ``[0, num_pages)``. A CUDA table
    is not re-checked here (that would synchronise with the device): its
    owner checks it on the host before upload (``check_page_table``), and
    the kernel writes zeros for an out-of-range id instead of reading
    outside the pool.
    """
    _check_gather(pages, page_table)
    num_pages = pages.shape[0]
    if pages.device.type == "cpu":
        check_page_table(page_table.numpy(), num_pages)
        return gather_kv_pages_reference(pages, page_table)
    b, max_pages = page_table.shape
    _, page_size, heads, head_dim = pages.shape
    out = torch.empty((b, max_pages * page_size, heads, head_dim),
                      dtype=pages.dtype, device=pages.device)
    if out.numel() == 0:
        return out
    page_bytes = page_size * heads * head_dim * pages.element_size()
    lib, fn = kernels._entry("gather_pages")
    rc = kernels._launch(pages, fn, pages.data_ptr(), num_pages, page_bytes,
                         page_table.data_ptr(), b * max_pages, out.data_ptr())
    _build.check(lib, rc, "gather_kv_pages")
    gather_kv_pages.launches += 1  # type: ignore[attr-defined]
    return out


gather_kv_pages.launches = 0  # type: ignore[attr-defined]
kernels.KERNELS["gather_kv_pages"] = gather_kv_pages


def ragged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_lengths: torch.Tensor, *,
                            scale: float | None = None) -> torch.Tensor:
    """One decode step of attention over ragged per-slot lengths.

    ``q``: [B, H, Dh] (the one new position per slot); ``k``/``v``:
    [B, S_max, H, Dh] padded cache views; ``kv_lengths``: int [B] — slot b
    attends positions [0, kv_lengths[b]). q and k are cast to float32, q is
    scaled before the product, positions at or past the length are masked
    to -inf and the softmax runs in float32; the output is cast back to q's
    dtype. Callers guarantee kv_lengths >= 1 for every row.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s_max = k.shape[1]
    scores = torch.einsum("bhd,bshd->bhs", q.to(torch.float32) * scale, k.to(torch.float32))
    mask = torch.arange(s_max, device=q.device)[None, None, :] < kv_lengths[:, None, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, kv_lengths: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """Gather + ragged attention in one call: the engine's per-layer step."""
    k = gather_kv_pages(k_pages, page_table)
    v = gather_kv_pages(v_pages, page_table)
    return ragged_decode_attention(q, k, v, kv_lengths, scale=scale)
