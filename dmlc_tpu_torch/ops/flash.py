"""Flash attention: the causal LM's training attention, forward and backward.

Counterpart of the flash half of ``dmlc_tpu/ops/pallas_kernels.py``
(``flash_attention``, ``flash_attention_with_lse``,
``flash_attention_block_bwd``, ``attention``, ``auto_picks_dense``). Three
hand-written CUDA kernels carry it on the card:

- ``flash_forward`` (``csrc/flash_fwd.cu``): out and the per-row
  log-sum-exp, with the [S, S] score matrix never written. One Hopper
  kernel replaces both TPU forwards (K/V resident and K/V streamed): a
  head's K/V at S=2048 does not fit a block's shared memory, so every
  length streams K/V tiles through the same loop;
- ``flash_bwd_dq`` (``csrc/flash_bwd_dq.cu``): dQ, p recomputed from lse;
- ``flash_bwd_dkv`` (``csrc/flash_bwd_dkv.cu``): dK and dV.

Each wrapper takes [B*H, S, Dh] tensors, checks them, runs its plain
version (``*_reference``: exact float32 dense math of the same function)
when they lie on the CPU and launches its kernel when they lie on a CUDA
device. There is no fallback from the kernel to the plain version. The
wrappers count their launches by (entry point, head dim, dtype), which
says which kernel ran each head dim, and are listed in
``ops/kernels.KERNELS``.

``flash_attention`` is differentiable through ``_Flash``, a
``torch.autograd.Function``: the forward saves q, k, v, out and lse; the
backward computes ``delta = rowsum(dO * O)`` in float32 with plain torch
(XLA does this outside the kernels in the JAX package) and launches the
dq and dkv kernels. dq, dk and dv come back in q's, k's and v's dtype.

Shapes follow the JAX package: [B, H, S, Dh], lse [B*H, S, 1] inside and
[B, H, S, 1] from ``flash_attention_with_lse``. Sequence lengths are
checked by the JAX package's block rule (``_auto_block``), so the same
inputs raise the same ``ValueError``; the CUDA kernels then pick their own
tiles and mask the ragged edge.

Head dims: the three kernels are built for ``KERNEL_HEAD_DIMS`` (64,
128), for ``SM90_WIDE_HEAD_DIMS`` (192, 256) and for
``FWD_WIDE_HEAD_DIMS`` (320, 384, 448, 512), in both dtypes (bf16 on the
Hopper designs, float32 on register-tiled FMA). Past 512 all three run
kernels of their own in both dtypes that take the head dim at run time
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu``, ``csrc/flash_bwd_dkv.cu``,
any multiple of 8: bf16 on ``wgmma``, float32 on register tiles, the
output cut into column chunks). The simple kernels of
``csrc/flash_wide.cu`` run only through a direct call of their entry
points. No head dim is refused.
The public functions zero-pad q, k, v, out and dO along Dh up to
``_run_head_dim(Dh)`` (the next of ``KERNEL_HEAD_DIMS``; past 128, up to
512, the next multiple of 64; past that the next multiple of 8) on every
device, run the wrappers there and slice the results back; the forward
and its backward see one width.
The padding is exact: zero columns of Q and K leave Q K^T unchanged, zero
columns of V and dO leave out's first Dh columns, lse, delta and dP
unchanged, and dQ, dK, dV get zero columns. ``scale`` defaults to the
original Dh's.
"""

from __future__ import annotations

from collections import Counter

import torch

from dmlc_tpu_torch.ops import _build, kernels
from dmlc_tpu_torch.parallel.ring_attention import dense_attention

# The JAX package's forward schedule switch (K/V bytes per batch-head) and
# single-block cap. Here they only pick the default block sizes that
# ``_auto_block`` validates, so the port accepts and refuses exactly the
# lengths the JAX package does.
_RESIDENT_KV_BYTES = 4 * 1024 * 1024
_FULL_BLOCK_CAP = 1024

#: The head dims the CUDA kernels are compiled for, in both dtypes: every
#: transformer of the model registry has heads of 64 or 128. The public
#: functions pad any smaller head dim up to one of them.
KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: The wider head dims the three kernels are compiled for in both dtypes
#: (csrc/flash_fwd.cu, csrc/flash_bwd_dq.cu, csrc/flash_bwd_dkv.cu); a head
#: dim in (128, 256] pads up to one of them.
SM90_WIDE_HEAD_DIMS = (192, 256)
#: The head dims past 256 the three kernels are built for in both dtypes
#: (csrc/flash_fwd.cu, csrc/flash_bwd_dq.cu, csrc/flash_bwd_dkv.cu); a head
#: dim in (256, 512] pads up to one of them.
FWD_WIDE_HEAD_DIMS = (320, 384, 448, 512)
#: Every head dim past 512 pads to a multiple of WIDE_HEAD_DIM_STEP and
#: runs the kernels of the three sources that take the head dim at run
#: time, in both dtypes; csrc/flash_wide.cu, which takes any past 128, runs
#: only through a direct call of its entry points.
WIDE_HEAD_DIM_STEP = 8


def _kernel_head_dim(dh: int) -> int | None:
    """The smallest head dim of ``KERNEL_HEAD_DIMS`` that is at least
    ``dh``; None past the largest."""
    return next((k for k in KERNEL_HEAD_DIMS if k >= dh), None)


def _run_head_dim(dh: int) -> int:
    """The head dim the public functions run heads of ``dh`` at, in either
    dtype and on every device, so that a forward and its backward see one
    width: ``_kernel_head_dim(dh)``; past it the next of
    ``SM90_WIDE_HEAD_DIMS`` and ``FWD_WIDE_HEAD_DIMS``; past those ``dh``
    rounded up to a multiple of ``WIDE_HEAD_DIM_STEP``."""
    wider = SM90_WIDE_HEAD_DIMS + FWD_WIDE_HEAD_DIMS
    padded = _kernel_head_dim(dh) or next((k for k in wider if k >= dh), None)
    return padded or -(-dh // WIDE_HEAD_DIM_STEP) * WIDE_HEAD_DIM_STEP


def _entry_name(name: str, dh: int, dtype: torch.dtype) -> str | None:
    """The entry point that wrapper kernel ``name`` (``flash_fwd``,
    ``flash_bwd_dq`` or ``flash_bwd_dkv``) launches at head dim ``dh`` in
    ``dtype``: its own kernel at ``KERNEL_HEAD_DIMS``,
    ``SM90_WIDE_HEAD_DIMS`` and ``FWD_WIDE_HEAD_DIMS``, and at every other
    multiple of ``WIDE_HEAD_DIM_STEP`` past 256 (the kernels that take the
    head dim at run time), in both dtypes; else, at the other multiples of
    8 in (128, 256), the wide kernel (``flash_wide_*``, which the public
    functions never send: they pad those to 192 or 256); None for a head
    dim no kernel takes."""
    if dh in KERNEL_HEAD_DIMS + SM90_WIDE_HEAD_DIMS + FWD_WIDE_HEAD_DIMS:
        return name
    if dh > KERNEL_HEAD_DIMS[-1] and dh % WIDE_HEAD_DIM_STEP == 0:
        return name if dh > SM90_WIDE_HEAD_DIMS[-1] else name.replace("flash_", "flash_wide_", 1)
    return None


def _auto_block(s: int, requested: int | None, default: int) -> int:
    """The JAX package's block rule: the largest divisor of ``s`` that is a
    multiple of 8 and at most the requested size; a length with no such
    divisor runs as one block up to ``_FULL_BLOCK_CAP`` and is refused
    past it."""
    blk = min(requested if requested is not None else default, s)
    if blk >= s and s > _FULL_BLOCK_CAP:
        blk = min(default, s - 8)
    if blk < s:
        for d in range(blk - blk % 8, 7, -8):
            if s % d == 0:
                return d
    if s <= _FULL_BLOCK_CAP:
        return s
    raise ValueError(
        f"sequence {s} has no block divisor that is a multiple of 8 and is "
        f"too long for a single full-sequence block (> {_FULL_BLOCK_CAP}): "
        "pad the sequence"
    )


def _check_blocks(q: torch.Tensor, blk_q: int | None, blk_k: int | None) -> None:
    """Apply the JAX package's shape contract to [B, H, S, Dh] ``q``: the
    forward's blocks (given or default) and the backward's."""
    s, dh = q.shape[2], q.shape[3]
    resident = 2 * s * dh * q.element_size() <= _RESIDENT_KV_BYTES
    _auto_block(s, blk_q, 128 if resident else 256)
    _auto_block(s, blk_k, 128 if resident else 256)
    _auto_block(s, None, 256)


# ---------------------------------------------------------------------------
# plain versions: exact float32 dense math
# ---------------------------------------------------------------------------

# Batch-heads per chunk of the plain versions, so a long sequence's [S, S]
# float32 scores stay near 1 GiB per chunk.
_REF_CHUNK_ELEMENTS = 1 << 28


def _ref_chunks(bh: int, s: int) -> list[slice]:
    step = max(1, _REF_CHUNK_ELEMENTS // (s * s))
    return [slice(i, min(i + step, bh)) for i in range(0, bh, step)]


def _scores_and_mask(q: torch.Tensor, k: torch.Tensor, causal: bool, scale: float):
    """float32 scores (q scaled before the product) and the visibility mask."""
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32) * scale, k.to(torch.float32))
    if causal:
        n = s.shape[-1]
        pos = torch.arange(n, device=q.device)
        keep = pos[None, :] <= pos[:, None]
    else:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    return s, keep[None]


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_forward``: dense float32 softmax attention.
    Returns out in q's dtype and lse float32 [BH, S, 1]; a row with no
    visible key gets out 0 and lse -inf."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((*q.shape[:2], 1), dtype=torch.float32, device=q.device)
    for c in _ref_chunks(q.shape[0], q.shape[1]):
        s, keep = _scores_and_mask(q[c], k[c], causal, scale)
        s = s.masked_fill(~keep, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m_safe = torch.where(torch.isneginf(m), 0.0, m)
        p = torch.exp(s - m_safe)
        l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[c] = (torch.einsum("bqk,bkd->bqd", p, v[c].to(torch.float32)) / l_safe).to(q.dtype)
        lse[c] = m + torch.log(l_safe)
    return out, lse


def _probs_and_dscores(q, k, v, do, lse, delta, causal: bool, scale: float):
    """p = exp(scores - lse) (0 where not visible) and dS = p * (dP - delta)."""
    s, keep = _scores_and_mask(q, k, causal, scale)
    p = torch.where(keep, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bqd,bkd->bqk", do.to(torch.float32), v.to(torch.float32))
    return p, p * (dp - delta)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal: bool,
                           scale: float) -> torch.Tensor:
    """Plain version of ``flash_bwd_dq``: dQ = scale * dS @ K, float32 dense
    math, returned in q's dtype."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for c in _ref_chunks(q.shape[0], q.shape[1]):
        _, ds = _probs_and_dscores(q[c], k[c], v[c], do[c], lse[c], delta[c], causal, scale)
        dq[c] = (torch.einsum("bqk,bkd->bqd", ds, k[c].to(torch.float32)) * scale).to(q.dtype)
    return dq


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, causal: bool,
                            scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_bwd_dkv``: dV = P^T @ dO and dK = dS^T @
    (scale * Q), float32 dense math, returned in k's and v's dtypes."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for c in _ref_chunks(q.shape[0], q.shape[1]):
        p, ds = _probs_and_dscores(q[c], k[c], v[c], do[c], lse[c], delta[c], causal, scale)
        dv[c] = torch.einsum("bqk,bqd->bkd", p, do[c].to(torch.float32)).to(v.dtype)
        qs = q[c].to(torch.float32) * scale
        dk[c] = torch.einsum("bqk,bqd->bkd", ds, qs).to(k.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(what: str, mats: dict[str, torch.Tensor],
                    rows: dict[str, torch.Tensor]) -> tuple[int, int, int]:
    """[BH, S, Dh] matrices of one shape on one device, and float32 [BH, S,
    1] row vectors; on a CUDA device also what the kernels take: float32
    or bfloat16, one dtype, a head dim of ``KERNEL_HEAD_DIMS`` or a
    multiple of ``WIDE_HEAD_DIM_STEP`` past them, contiguous and 16-byte
    aligned."""
    first = next(iter(mats.values()))
    index = None
    for name, t in {**mats, **rows}.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a torch.Tensor")
        i = kernels._device_index(t, what)
        if index is None:
            index = i
        elif i != index:
            raise ValueError(f"{what}: {name} on {t.device}, {next(iter(mats))} on {first.device}")
    if first.dim() != 3:
        raise ValueError(f"{what}: expected [B*H, S, Dh], got {tuple(first.shape)}")
    bh, s, dh = first.shape
    for name, t in mats.items():
        if tuple(t.shape) != (bh, s, dh):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, expected {(bh, s, dh)}")
    for name, t in rows.items():
        if tuple(t.shape) != (bh, s, 1) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 {(bh, s, 1)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if index >= 0:
        if first.dtype not in _KERNEL_DTYPES or any(t.dtype != first.dtype for t in mats.values()):
            raise TypeError(f"{what}: the kernel takes one dtype of {_KERNEL_DTYPES} for "
                            f"{list(mats)}, got {[t.dtype for t in mats.values()]}")
        if _entry_name("flash_fwd", dh, first.dtype) is None:
            raise ValueError(
                f"{what}: the kernels are built for head dims {KERNEL_HEAD_DIMS} and the "
                f"multiples of {WIDE_HEAD_DIM_STEP} past {KERNEL_HEAD_DIMS[-1]}, got {dh}")
        for name, t in {**mats, **rows}.items():
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    return bh, s, dh


def _run(name: str, first: torch.Tensor, *args) -> tuple[str, int, torch.dtype]:
    """Launch kernel ``name`` (``flash_fwd``, ``flash_bwd_dq`` or
    ``flash_bwd_dkv``) on ``first``'s device through the entry point
    ``_entry_name`` picks for its head dim and dtype; returns the key the
    wrapper counts the launch under: (entry point, head dim, dtype)."""
    dh, dtype = first.shape[-1], first.dtype
    entry = _entry_name(name, dh, dtype)
    lib, fn = kernels._entry(entry)
    rc = kernels._launch(first, fn, *args)
    _build.check(lib, rc, entry)
    return entry, dh, dtype


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """[BH, S, Dh] q, k, v -> (out in q's dtype, lse float32 [BH, S, 1])."""
    bh, s, dh = _check_operands("flash_forward", {"q": q, "k": k, "v": v}, {})
    if q.is_cpu:
        return flash_forward_reference(q, k, v, causal=causal, scale=scale)
    out = torch.empty_like(q)
    lse = q.new_empty((bh, s, 1), dtype=torch.float32)
    if q.numel():
        key = _run("flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr(), bh, s, dh, int(causal), float(scale),
                   int(q.dtype == torch.bfloat16))
        flash_forward.launches[key] += 1  # type: ignore[attr-defined]
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float) -> torch.Tensor:
    """dQ of attention against the forward's lse and ``delta = rowsum(dO *
    O)`` (both float32 [BH, S, 1]), in q's dtype."""
    bh, s, dh = _check_operands("flash_bwd_dq", {"q": q, "k": k, "v": v, "do": do},
                                {"lse": lse, "delta": delta})
    if q.is_cpu:
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dq = torch.empty_like(q)
    if q.numel():
        key = _run("flash_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, dh, int(causal),
                   float(scale), int(q.dtype == torch.bfloat16))
        flash_bwd_dq.launches[key] += 1  # type: ignore[attr-defined]
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of attention against the forward's lse and delta, in k's
    and v's dtypes."""
    bh, s, dh = _check_operands("flash_bwd_dkv", {"q": q, "k": k, "v": v, "do": do},
                                {"lse": lse, "delta": delta})
    if q.is_cpu:
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        key = _run("flash_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s, dh,
                   int(causal), float(scale), int(q.dtype == torch.bfloat16))
        flash_bwd_dkv.launches[key] += 1  # type: ignore[attr-defined]
    return dk, dv


flash_forward.launches = Counter()  # type: ignore[attr-defined]
flash_bwd_dq.launches = Counter()  # type: ignore[attr-defined]
flash_bwd_dkv.launches = Counter()  # type: ignore[attr-defined]
kernels.KERNELS.update(flash_forward=flash_forward, flash_bwd_dq=flash_bwd_dq,
                       flash_bwd_dkv=flash_bwd_dkv)


# ---------------------------------------------------------------------------
# public attention
# ---------------------------------------------------------------------------


def _as_heads(x: torch.Tensor, dh: int) -> torch.Tensor:
    """[B, H, S, Dx] -> contiguous, 16-byte aligned [B*H, S, dh] with zero
    columns past Dx, as the kernels take it (a copy only when needed)."""
    b, h, s, dx = x.shape
    if dh != dx:
        x = torch.nn.functional.pad(x, (0, dh - dx))
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x.view(b * h, s, dh)


def _from_heads(x: torch.Tensor, shape) -> torch.Tensor:
    """[B*H, S, dh] -> [B, H, S, Dh] of ``shape``, the padding columns
    dropped."""
    if x.shape[-1] == shape[-1]:
        return x.view(shape)
    return x[..., : shape[-1]].contiguous().view(shape)


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in float32, [BH, S, 1]: the softmax Jacobian's row term."""
    return (out.to(torch.float32) * do.to(torch.float32)).sum(dim=-1, keepdim=True)


class _Flash(torch.autograd.Function):
    """Flash attention with the FlashAttention-2 backward (the JAX
    package's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):  # type: ignore[override]
        dh = _run_head_dim(q.shape[-1])
        q3, k3, v3 = (_as_heads(x, dh) for x in (q, k, v))
        out, lse = flash_forward(q3, k3, v3, causal=causal, scale=scale)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return _from_heads(out, q.shape)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        q3, k3, v3, out, lse = ctx.saved_tensors
        do = _as_heads(g, q3.shape[-1])
        delta = _delta(out, do)
        kw = {"causal": ctx.causal, "scale": ctx.scale}
        dq = flash_bwd_dq(q3, k3, v3, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q3, k3, v3, do, lse, delta, **kw)
        return (*(_from_heads(x, g.shape) for x in (dq, dk, dv)), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
                    scale: float | None = None, blk_q: int | None = None,
                    blk_k: int | None = None) -> torch.Tensor:
    """Blockwise attention [B, H, S, Dh] -> [B, H, S, Dh] in q's dtype,
    differentiable with O(S) memory: the forward keeps only the per-row
    log-sum-exp and the backward recomputes p tile by tile. ``blk_q`` and
    ``blk_k`` are checked against the JAX package's block rule (an S
    with no legal block raises ``ValueError``: pad the sequence); the
    kernels choose their own tiles. A head dim the kernels are not built
    for runs zero-padded to ``_run_head_dim``."""
    _check_blocks(q, blk_q, blk_k)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, bool(causal), float(scale))


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = False, scale: float | None = None,
                             blk_q: int | None = None, blk_k: int | None = None):
    """Forward only: ``(out, lse)`` with lse float32 [B, H, S, 1], the
    composition primitive of the ring schedules. Not differentiable on its
    own: a composed schedule builds its backward on
    ``flash_attention_block_bwd`` against the merged out and lse."""
    _check_blocks(q, blk_q, blk_k)
    b, h, s, dh = q.shape
    if scale is None:
        scale = dh ** -0.5
    run_dh = _run_head_dim(dh)
    with torch.no_grad():
        out, lse = flash_forward(*(_as_heads(x, run_dh) for x in (q, k, v)), causal=causal,
                                 scale=float(scale))
    return _from_heads(out, q.shape), lse.view(b, h, s, 1)


def flash_attention_block_bwd(q, k, v, out, lse, do, *, causal: bool = False,
                              scale: float | None = None, delta=None):
    """(dq, dk, dv) of one (q, k-block) pair against the GLOBAL out and lse
    ([B, H, S, 1]); ``delta`` ([B, H, S, 1]) may be passed precomputed. S
    is checked by the JAX package's backward block rule, so a length with
    no legal block raises ``ValueError`` (pad the sequence) as it does
    there."""
    _auto_block(q.shape[2], None, 256)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, s, dh = q.shape
    run_dh = _run_head_dim(dh)
    q3, k3, v3, o3, do3 = (_as_heads(x, run_dh) for x in (q, k, v, out, do))
    lse3 = lse.reshape(b * h, s, 1).to(torch.float32).contiguous()
    delta3 = (_delta(o3, do3) if delta is None
              else delta.reshape(b * h, s, 1).to(torch.float32).contiguous())
    kw = {"causal": causal, "scale": float(scale)}
    with torch.no_grad():
        dq = flash_bwd_dq(q3, k3, v3, do3, lse3, delta3, **kw)
        dk, dv = flash_bwd_dkv(q3, k3, v3, do3, lse3, delta3, **kw)
    return tuple(_from_heads(x, q.shape) for x in (dq, dk, dv))


# The JAX package's crossover between dense and flash attention, kept equal
# so that ``attention`` dispatches as it does there: flash from S = 4096 on,
# or where the float32 [B, H, S, S] scores would pass 256 MiB.
AUTO_FLASH_MIN_S = 4096
AUTO_DENSE_SCORES_CAP_BYTES = 256 * 1024 * 1024


def auto_picks_dense(b: int, h: int, s: int) -> bool:
    """The dispatch predicate of ``attention``."""
    return s < AUTO_FLASH_MIN_S and 4 * b * h * s * s <= AUTO_DENSE_SCORES_CAP_BYTES


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
              scale: float | None = None) -> torch.Tensor:
    """Dense attention where ``auto_picks_dense`` says so, flash otherwise."""
    b, h, s, _ = q.shape
    if auto_picks_dense(b, h, s):
        return dense_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)
