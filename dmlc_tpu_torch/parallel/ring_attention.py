"""Single-device attention of ``dmlc_tpu/parallel/ring_attention.py``.

Only ``dense_attention``, the reference schedule the LM's prefill and full
forward run. The flash schedule is ``ops/flash.py``; the ring, ring-flash
and Ulysses schedules shard the sequence over several devices and come with
the ``torch.distributed`` slice.
"""

from __future__ import annotations

import torch


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: float | None = None) -> torch.Tensor:
    """[B, H, S, Dh] attention with float32 scores: q and k cast to float32,
    q scaled before the product, future positions masked to -inf when
    ``causal``, softmax in float32, output cast back to q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * scale, k.to(torch.float32))
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = (torch.arange(s_k, device=q.device)[None, :]
                <= torch.arange(s_q, device=q.device)[:, None])
        scores = scores.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32)).to(q.dtype)
