"""Ulysses attention: all-to-all sequence parallelism over a mesh's ``sp`` axis.

Port of ``dmlc_tpu/parallel/ulysses.py``. Where the ring
(``parallel/ring_attention.py``) rotates K/V blocks and keeps the sequence
cut throughout, Ulysses re-cuts around the attention: the blocks arrive
sequence-cut ``[B, H, S/n, Dh]``, one all-to-all a tensor swaps the cut
axis from the sequence to the heads ``[B, H/n, S, Dh]``, each position
attends its heads over the whole sequence, and one all-to-all on the
output swaps back. It needs ``H % n == 0``; the ring has no such limit.

The all-to-all keeps the JAX package's tiled order: after the swap,
position p holds heads ``p·(H/n) … (p+1)·(H/n) - 1`` of the whole
sequence, its S gathered in position order. The mesh is one process over
a device list (``parallel/mesh.py``): the swap is a split and a
concatenation across the positions' tensors, each part moved to its new
position's device, and autograd differentiates it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dmlc_tpu_torch.parallel.mesh import Mesh
from dmlc_tpu_torch.parallel.ring_attention import Shards, dense_attention, over_rings


def _check_heads(heads: int, n: int) -> None:
    if heads % n:
        raise ValueError(f"ulysses needs heads % sp == 0: {heads} heads over sp={n}")


def _heads_to_sequence(blocks: Shards, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """[B, H, S/n, Dh] a position -> [B, H/n, S, Dh]: heads scatter,
    sequence gathers (``lax.all_to_all(split_axis=1, concat_axis=2,
    tiled=True)``)."""
    n, h = len(blocks), blocks[0].shape[1] // len(blocks)
    return [torch.cat([t[:, p * h:(p + 1) * h].to(devices[p]) for t in blocks], dim=2)
            for p in range(n)]


def _sequence_to_heads(blocks: Shards, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """The inverse: [B, H/n, S, Dh] a position -> [B, H, S/n, Dh]."""
    n, s = len(blocks), blocks[0].shape[2] // len(blocks)
    return [torch.cat([t[:, :, p * s:(p + 1) * s].to(devices[p]) for t in blocks], dim=1)
            for p in range(n)]


def ulysses_attention_shards(qs: Shards, ks: Shards, vs: Shards, devices: Sequence[torch.device],
                             *, causal: bool = False, scale: float | None = None,
                             use_flash: bool = False) -> list[torch.Tensor]:
    """One ring of ``ulysses_attention``: position p's [B, H, S/n, Dh]
    blocks on ``devices[p]`` -> its output block. The local attention is
    ``dense_attention``, or ``ops/flash.flash_attention`` (the flash
    kernels on the card) with ``use_flash``."""
    _check_heads(qs[0].shape[1], len(qs))
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    if use_flash:
        from dmlc_tpu_torch.ops.flash import flash_attention as attend
    else:
        attend = dense_attention
    qh, kh, vh = (_heads_to_sequence(t, devices) for t in (qs, ks, vs))
    outs = [attend(q, k, v, causal=causal, scale=scale) for q, k, v in zip(qh, kh, vh)]
    return _sequence_to_heads(outs, devices)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *,
                      axis_name: str = "sp", causal: bool = False, scale: float | None = None,
                      use_flash: bool = False) -> torch.Tensor:
    """Sequence-parallel attention by head/sequence all-to-all: [B, H, S,
    Dh] q, k, v with S cut over ``axis_name`` (and B over ``dp``) -> [B,
    H, S, Dh] on q's device. Raises ``ValueError`` before any work when
    the heads do not divide over ``axis_name``."""
    _check_heads(q.shape[1], mesh.shape.get(axis_name, 1))
    return over_rings(ulysses_attention_shards, q, k, v, mesh, axis_name, causal=causal,
                      scale=scale, use_flash=use_flash)
