"""Ragged paged-KV decode attention: the per-step op of the generation engine.

Counterpart of ``dmlc_tpu/ops/ragged_decode.py``. Decode attends one new
query token per slot against that slot's cached K/V, whose length differs
per slot. The cache is paged (``generate/kvcache.py``): fixed-size pages
from a shared pool, stitched into a per-slot sequence by an int32 page
table.

- ``gather_kv_pages`` assembles the per-slot contiguous view. On a CUDA
  tensor it launches the hand-written page-gather kernel
  (``csrc/gather_pages.cu``, on Hopper's bulk-copy engine); on a CPU
  tensor it runs the plain version
  ``gather_kv_pages_reference``. The device decides; there is no fallback
  from the kernel to the plain version.
- ``ragged_decode_attention`` is the masked attention over the gathered
  view, plain PyTorch (the JAX version is XLA, not Pallas), with
  ``parallel/ring_attention.dense_attention``'s float32 score discipline.
- ``paged_decode_attention``, the engine's per-layer step, computes what
  the gather and the attention compute together. On a CUDA tensor it
  launches one hand-written kernel (``csrc/paged_decode.cu``) that reads
  the pages through the table at the live positions only and writes no
  view; on a CPU tensor it runs the plain version
  ``paged_decode_attention_reference``, the two composed. The engine
  no longer gathers; ``gather_kv_pages`` stays as the counterpart of the
  JAX package's public gather.
"""

from __future__ import annotations

import functools

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
            f"page table: page id {int(bad.flat[0])} outside [0, {num_pages})"
        )


def _check_gather(pages: torch.Tensor, page_table: torch.Tensor) -> int:
    """Raises on what neither version takes; returns the device index
    (``kernels._device_index``)."""
    if not isinstance(pages, torch.Tensor) or not isinstance(page_table, torch.Tensor):
        raise TypeError("gather_kv_pages: pages and page_table must be torch.Tensors")
    index = kernels._device_index(pages, "gather_kv_pages")
    if pages.dim() != 4:
        raise ValueError(
            f"gather_kv_pages: pages must be [num_pages, page_size, H, Dh], got {tuple(pages.shape)}"
        )
    if page_table.dim() != 2 or page_table.dtype != torch.int32:
        raise ValueError(
            "gather_kv_pages: page_table must be int32 [B, max_pages], got "
            f"{page_table.dtype} {tuple(page_table.shape)}"
        )
    if not (page_table.is_cuda or page_table.is_cpu) or page_table.get_device() != index:
        raise ValueError(
            f"gather_kv_pages: page_table on {page_table.device}, pages on {pages.device}"
        )
    if not (pages.is_contiguous() and page_table.is_contiguous()):
        raise ValueError("gather_kv_pages: pages and page_table must be contiguous")
    return index


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
    index = _check_gather(pages, page_table)
    num_pages = pages.shape[0]
    if index < 0:
        check_page_table(page_table.numpy(), num_pages)
        return gather_kv_pages_reference(pages, page_table)
    b, max_pages = page_table.shape
    _, page_size, heads, head_dim = pages.shape
    out = pages.new_empty((b, max_pages * page_size, heads, head_dim))
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


#: The largest head dim the paged kernel takes (``kGenericMaxDh`` in
#: ``csrc/paged_decode.cu``).
PAGED_MAX_HEAD_DIM = 8192
_PAGED_DTYPES = (torch.float32, torch.bfloat16)


def _check_paged(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 page_table: torch.Tensor, kv_lengths: torch.Tensor) -> int:
    """Raises on what neither version takes (on the card also what the
    kernel does not take); returns the device index
    (``kernels._device_index``)."""
    what = "paged_decode_attention"
    named = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages), ("page_table", page_table),
             ("kv_lengths", kv_lengths))
    indices = []
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a torch.Tensor")
        indices.append(kernels._device_index(t, what))
    index = indices[0]
    for (name, t), i in zip(named, indices):
        if i != index:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
    if q.dim() != 3:
        raise ValueError(f"{what}: q must be [B, H, Dh], got {tuple(q.shape)}")
    b, heads, dh = q.shape
    if (k_pages.dim() != 4 or k_pages.shape != v_pages.shape
            or k_pages.shape[2:] != (heads, dh)):
        raise ValueError(f"{what}: k_pages and v_pages must both be [num_pages, page_size, "
                         f"{heads}, {dh}], got {tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    if page_table.dim() != 2 or page_table.dtype != torch.int32 or page_table.shape[0] != b:
        raise ValueError(f"{what}: page_table must be int32 [{b}, max_pages], got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    if kv_lengths.shape != (b,) or kv_lengths.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: kv_lengths must be int32 or int64 [{b}], got "
                         f"{kv_lengths.dtype} {tuple(kv_lengths.shape)}")
    if index >= 0:
        if q.dtype not in _PAGED_DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise TypeError(f"{what}: the kernel takes q and the pools in one dtype of "
                            f"{_PAGED_DTYPES}, got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
        if k_pages.shape[0] * k_pages.shape[1] * page_table.shape[1] == 0:
            raise ValueError(f"{what}: the kernel takes at least one page, one row a page and "
                             "one table column")
        if dh > PAGED_MAX_HEAD_DIM:
            raise ValueError(f"{what}: head dim {dh} is past {PAGED_MAX_HEAD_DIM}, the largest "
                             "the kernel takes")
        for name, t in named:
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    return index


@functools.cache
def _paged_split() -> int:
    """Positions a block of the paged kernel takes (its source's
    ``kSplit``): the wrapper sizes the kernel's scratch by it."""
    _, fn = kernels._entry("paged_decode_split")
    return int(fn())


def paged_decode_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor, page_table: torch.Tensor,
                                     kv_lengths: torch.Tensor, *,
                                     scale: float | None = None) -> torch.Tensor:
    """Plain version of ``paged_decode_attention``: both pools gathered by
    ``gather_kv_pages_reference``, then ``ragged_decode_attention``."""
    k = gather_kv_pages_reference(k_pages, page_table)
    v = gather_kv_pages_reference(v_pages, page_table)
    return ragged_decode_attention(q, k, v, kv_lengths, scale=scale)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor, kv_lengths: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """One decode step of attention straight from the paged pools: the
    engine's per-layer step, what ``gather_kv_pages`` on each pool followed
    by ``ragged_decode_attention`` computes.

    ``q``: [B, H, Dh]; ``k_pages``/``v_pages``: [num_pages, page_size, H,
    Dh]; ``page_table``: int32 [B, max_pages] on the same device;
    ``kv_lengths``: int32 or int64 [B] — slot b attends positions [0,
    kv_lengths[b]) of its pages in table order. Scores and softmax are
    float32 with q scaled before the product; the output is [B, H, Dh] in
    q's dtype. On the card q and both pools share one dtype, float32 or
    bfloat16, and the kernel's sums run in an order that depends on the
    positions alone, so a contiguous cache passed as one page a slot
    (table [[0], [1], ...]) gives the same bits as that state paged.

    A CPU table is checked for ids outside ``[0, num_pages)``. A CUDA table
    is not (that would synchronise with the device): its owner checks it
    on the host before upload (``check_page_table``), and the kernel
    counts a row on an out-of-range page as zeros instead of reading
    outside the pool. On the card the output is a view of the one
    allocation that also holds the kernel's scratch, after it.
    """
    index = _check_paged(q, k_pages, v_pages, page_table, kv_lengths)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    num_pages, page_size = k_pages.shape[:2]
    if index < 0:
        check_page_table(page_table.numpy(), num_pages)
        return paged_decode_attention_reference(q, k_pages, v_pages, page_table, kv_lengths,
                                                scale=scale)
    b, heads, dh = q.shape
    if b * heads * dh == 0:
        return q.new_empty((b, heads, dh))
    max_pages = page_table.shape[1]
    # One allocation holds the output (in q's dtype, rounded up to 16
    # bytes) and, after it, the kernel's float32 scratch.
    nsplit = -(-max_pages * page_size // _paged_split())
    item = q.element_size()
    out_elems = -(-b * heads * dh * item // 16) * 16 // item
    buf = q.new_empty(out_elems + b * heads * nsplit * (dh + 2) * 4 // item)
    out = buf.as_strided((b, heads, dh), (heads * dh, dh, 1))
    lib, fn = kernels._entry("paged_decode")
    rc = kernels._launch(q, fn, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), num_pages,
                         page_size, heads, dh, page_table.data_ptr(), b, max_pages,
                         kv_lengths.data_ptr(), int(kv_lengths.dtype == torch.int64),
                         float(scale), int(q.dtype == torch.bfloat16),
                         buf.data_ptr() + out_elems * item, buf.data_ptr())
    _build.check(lib, rc, "paged_decode_attention")
    paged_decode_attention.launches += 1  # type: ignore[attr-defined]
    return out


paged_decode_attention.launches = 0  # type: ignore[attr-defined]
kernels.KERNELS["paged_decode_attention"] = paged_decode_attention
