"""Ring attention: sequence parallelism over a mesh's ``sp`` axis.

Port of ``dmlc_tpu/parallel/ring_attention.py``. A sequence too long for
one device is cut into equal blocks, one per ``sp`` position; each position
keeps its Q block and the K/V blocks travel round the ring, one position a
step, while an accumulator absorbs each block. No position ever holds the
[S, S] scores.

- ``ring_attention``: the dense online-softmax accumulator in float32
  (q scaled before the product), differentiated by autograd as JAX
  differentiates through its scan. A step holds one [S/n, S/n] block of
  float32 scores.
- ``ring_flash_attention``: the accumulator is the flash forward
  (``ops/flash.flash_attention_with_lse``, the hand-written CUDA kernel on
  the card) merged by log-sum-exp, and its backward (``_RingFlash``) rings
  (k, v, dk, dv) together through ``flash_attention_block_bwd``: no
  [S/n, S/n] matrix exists in the forward or the backward.
- ``dense_attention``: the single-device reference, which the LM's prefill
  and full forward also run.

The mesh is one process over a device list (``parallel/mesh.py``): each
position's block is its own tensor on its position's device, and the
ring's ``lax.ppermute`` is a block moving to the next position's device.
At step i position p holds block ``(p - i) % n``, so its own (diagonal)
block comes first. The global functions take and return [B, H, S, Dh]
tensors with S cut over ``sp`` and B over ``dp`` when the mesh has it; the
``*_shards`` functions take one ring's blocks, as the LM's blocks keep
their activations cut between attentions (``parallel/sp_transformer.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from dmlc_tpu_torch.parallel.mesh import Mesh, join_positions, split_to_positions

Shards = Sequence[torch.Tensor]


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


def _rotate(blocks: list, devices: Sequence[torch.device]) -> list:
    """One ring step: position p takes position p-1's tuple of tensors."""
    n = len(blocks)
    return [tuple(t.to(devices[p]) for t in blocks[(p - 1) % n]) for p in range(n)]


def _check_ring(qs: Shards, ks: Shards, vs: Shards, devices: Sequence[torch.device]) -> None:
    n = len(qs)
    if not (len(ks) == len(vs) == len(devices) == n) or n == 0:
        raise ValueError(f"a ring takes one q, k, v block per position: {len(qs)}, {len(ks)}, "
                         f"{len(vs)} blocks over {len(devices)} positions")
    shapes = {tuple(t.shape) for t in (*qs, *ks, *vs)}
    if len(shapes) != 1:
        raise ValueError(f"ring blocks must be of one shape, got {sorted(shapes)}")


def ring_attention_shards(qs: Shards, ks: Shards, vs: Shards, devices: Sequence[torch.device],
                          *, causal: bool = False, scale: float | None = None
                          ) -> list[torch.Tensor]:
    """One ring of ``ring_attention``: ``qs[p]``, ``ks[p]``, ``vs[p]`` are
    position p's [B, H, S/n, Dh] blocks on ``devices[p]``; returns each
    position's output block in q's dtype."""
    _check_ring(qs, ks, vs, devices)
    n = len(qs)
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    s_local = qs[0].shape[2]
    q32 = [q.to(torch.float32) * scale for q in qs]
    o = [torch.zeros_like(q) for q in q32]
    m = [torch.full_like(q[..., 0], float("-inf")) for q in q32]
    l = [torch.zeros_like(q[..., 0]) for q in q32]
    blocks = list(zip(ks, vs))
    for step in range(n):
        for p in range(n):
            src = (p - step) % n
            k_blk, v_blk = blocks[p]
            scores = torch.einsum("bhqd,bhkd->bhqk", q32[p], k_blk.to(torch.float32))
            if causal:
                pos = torch.arange(s_local, device=scores.device)
                visible = (src * s_local + pos)[None, :] <= (p * s_local + pos)[:, None]
                scores = scores.masked_fill(~visible[None, None], float("-inf"))
            m_new = torch.maximum(m[p], scores.amax(dim=-1))
            # Where a row is fully masked m_new stays -inf: the correction
            # must then be 1, and p 0 where the score is -inf. Both guards
            # select before the exp, so no nan reaches the backward.
            corr = torch.exp(torch.where(torch.isneginf(m_new), 0.0, m[p] - m_new))
            probs = torch.exp(torch.where(torch.isneginf(scores), float("-inf"),
                                          scores - m_new[..., None]))
            l[p] = l[p] * corr + probs.sum(dim=-1)
            o[p] = o[p] * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", probs,
                                                          v_blk.to(torch.float32))
            m[p] = m_new
        if step < n - 1:
            blocks = _rotate(blocks, devices)
    return [(o[p] / l[p].clamp_min(1e-30)[..., None]).to(qs[p].dtype) for p in range(n)]


def _merge_blocks(o32: torch.Tensor, lse: torch.Tensor, o_blk: torch.Tensor,
                  lse_blk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact log-sum-exp merge of two normalized partial attentions in
    float32. A contribution with lse -inf (no visible key) weighs 0."""
    lse_new = torch.logaddexp(lse, lse_blk)
    w_old = torch.where(torch.isneginf(lse), 0.0, torch.exp(lse - lse_new))
    w_new = torch.where(torch.isneginf(lse_blk), 0.0, torch.exp(lse_blk - lse_new))
    return o32 * w_old + o_blk.to(torch.float32) * w_new, lse_new


def _block_causal(causal: bool, p: int, src: int) -> bool | None:
    """How position p attends the block of position src (the JAX package's
    ``_block_branches``): a block before the rows in full (False), the
    diagonal block with ``causal``'s mask, and a block after the rows not
    at all (None). Not causal: every block in full."""
    if not causal or src < p:
        return False
    return True if src == p else None


class _RingFlash(torch.autograd.Function):
    """The flash ring over one ring's blocks (the JAX package's
    ``_ring_flash`` custom VJP). Inputs: the positions' devices, causal,
    scale, n, then the n q, n k and n v blocks; outputs the n out blocks."""

    @staticmethod
    def forward(ctx, devices, causal: bool, scale: float, n: int, *blocks):  # type: ignore[override]
        from dmlc_tpu_torch.ops.flash import flash_attention_with_lse

        qs, ks, vs = blocks[:n], blocks[n:2 * n], blocks[2 * n:]
        # Step 0 is every position's own block, which each position
        # attends (its diagonal), so it fills o and lse.
        o: list[torch.Tensor] = [None] * n  # type: ignore[list-item]
        lse: list[torch.Tensor] = [None] * n  # type: ignore[list-item]
        kv = list(zip(ks, vs))
        for step in range(n):
            for p in range(n):
                mode = _block_causal(causal, p, (p - step) % n)
                if mode is None:
                    continue  # a block after the rows: no kernel, no contribution
                o_blk, lse_blk = flash_attention_with_lse(qs[p], *kv[p], causal=mode, scale=scale)
                if step == 0:
                    # The merge into the empty accumulator (lse -inf) is
                    # exactly the block itself.
                    o[p], lse[p] = o_blk.to(torch.float32), lse_blk
                else:
                    o[p], lse[p] = _merge_blocks(o[p], lse[p], o_blk, lse_blk)
            if step < n - 1:
                kv = _rotate(kv, devices)
        outs = [x.to(q.dtype) for x, q in zip(o, qs)]
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lse)
        ctx.devices, ctx.causal, ctx.scale, ctx.n = devices, causal, scale, n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):  # type: ignore[override]
        from dmlc_tpu_torch.ops.flash import flash_attention_block_bwd

        n, causal, scale, devices = ctx.n, ctx.causal, ctx.scale, ctx.devices
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lse = (saved[i * n:(i + 1) * n] for i in range(5))
        dos = [d.to(o.dtype).contiguous() for d, o in zip(dos, outs)]
        # The softmax Jacobian's row term, once for the whole ring.
        delta = [(o.to(torch.float32) * d.to(torch.float32)).sum(dim=-1, keepdim=True)
                 for o, d in zip(outs, dos)]
        dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
        # dk and dv travel in float32 with their block and come home
        # complete after n rotations; dq stays home.
        ring = [(k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                 torch.zeros(v.shape, dtype=torch.float32, device=v.device))
                for k, v in zip(ks, vs)]
        for step in range(n):
            for p in range(n):
                mode = _block_causal(causal, p, (p - step) % n)
                if mode is None:
                    continue
                k_blk, v_blk, dk_blk, dv_blk = ring[p]
                dq_c, dk_c, dv_c = flash_attention_block_bwd(
                    qs[p], k_blk, v_blk, outs[p], lse[p], dos[p], causal=mode, scale=scale,
                    delta=delta[p])
                # In place: each accumulator has one owner, and a bf16
                # addend is added in float32.
                dq[p].add_(dq_c)
                dk_blk.add_(dk_c)
                dv_blk.add_(dv_c)
            ring = _rotate(ring, devices)
        return (None, None, None, None, *(g.to(q.dtype) for g, q in zip(dq, qs)),
                *(r[2].to(k.dtype) for r, k in zip(ring, ks)),
                *(r[3].to(v.dtype) for r, v in zip(ring, vs)))


def ring_flash_attention_shards(qs: Shards, ks: Shards, vs: Shards,
                                devices: Sequence[torch.device], *, causal: bool = False,
                                scale: float | None = None) -> list[torch.Tensor]:
    """One ring of ``ring_flash_attention`` (as ``ring_attention_shards``).
    A causal ring of n positions launches the flash forward, dQ and dK/dV
    n(n+1)/2 times each: a block after a position's rows launches none."""
    _check_ring(qs, ks, vs, devices)
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    return list(_RingFlash.apply(tuple(devices), bool(causal), float(scale), len(qs),
                                 *qs, *ks, *vs))


def over_rings(line_fn: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mesh: Mesh, axis_name: str = "sp", **kw) -> torch.Tensor:
    """Cut global [B, H, S, Dh] q, k, v over the mesh (S over
    ``axis_name``, B over ``dp`` when the mesh has it), run
    ``line_fn(qs, ks, vs, devices, **kw)`` on every ring along
    ``axis_name`` and join the outputs on q's device. Axes other than
    ``axis_name`` and ``dp`` hold replicas, as ``shard_map`` does for an
    axis its spec does not name."""
    dims = {axis_name: 2, **({"dp": 0} if "dp" in mesh.axis_names else {})}
    grids = [split_to_positions(t, mesh, dims) for t in (q, k, v)]
    out = np.empty(mesh.devices.shape, dtype=object)
    for line in mesh.lines(axis_name):
        res = line_fn(*([g[p] for p in line] for g in grids), [mesh.devices[p] for p in line],
                      **kw)
        for p, o in zip(line, res):
            out[p] = o
    return join_positions(out, mesh, dims, q.device)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *,
                   axis_name: str = "sp", causal: bool = False,
                   scale: float | None = None) -> torch.Tensor:
    """Sequence-parallel attention: [B, H, S, Dh] q, k, v with S cut over
    ``axis_name`` (and B over ``dp``) -> [B, H, S, Dh] on q's device."""
    return over_rings(ring_attention_shards, q, k, v, mesh, axis_name, causal=causal,
                      scale=scale)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *,
                         axis_name: str = "sp", causal: bool = False,
                         scale: float | None = None) -> torch.Tensor:
    """``ring_attention``'s contract over the flash kernels: no [S/n, S/n]
    score matrix exists in the forward or the backward."""
    return over_rings(ring_flash_attention_shards, q, k, v, mesh, axis_name, causal=causal,
                      scale=scale)
