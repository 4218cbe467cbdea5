"""Causal language models: served by the generation engine, trained by
``parallel/train.py``.

Counterpart of ``dmlc_tpu/models/lm.py`` and of
``dmlc_tpu/parallel/sp_transformer.SPTransformerLM``. The attention
``schedule`` is ``"dense"`` (the default, and the one both registry LMs
use), ``"flash"`` (``ops/flash.flash_attention``, the hand-written CUDA
kernels on the card: the training schedule) or ``"auto"``
(``ops/flash.attention``, the JAX package's dense/flash crossover); or,
given a ``mesh`` with an ``sp`` axis, one of the sequence-parallel
schedules ``"ring"``, ``"ring_flash"`` and ``"ulysses"``, under which the
activations stay cut over the mesh's positions between attentions
(``parallel/sp_transformer.py``).
Submodules keep flax's names (``embed``, ``pos_embed``, ``block{i}.{ln1, attn.{query,key,value,out},
ln2, mlp_in, mlp_out}``, ``ln_f``, ``head``), so the JAX parameter tree maps
one to one onto the state dict (``models/convert.lm_from_jax``).

flax semantics kept: LayerNorm with eps 1e-6 (``layers.LayerNorm``), the
tanh approximation of GELU (``jax.nn.gelu``'s default), float32 parameters
computing in the model's dtype, and attention scores in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmlc_tpu_torch.models.layers import LayerNorm, Linear
from dmlc_tpu_torch.ops.flash import attention, flash_attention
from dmlc_tpu_torch.parallel.mesh import Mesh, join_positions, split_to_positions
from dmlc_tpu_torch.parallel.ring_attention import dense_attention
from dmlc_tpu_torch.parallel.sp_transformer import (
    SP_AXIS,
    SP_SCHEDULES,
    PositionRunner,
    attend_shards,
    check_schedule,
    token_dims,
    unzip,
)

_ATTENTION = {"dense": dense_attention, "flash": flash_attention, "auto": attention}

LM_WIDE_VOCAB = 2048
LM_WIDE_MAX_LEN = 128
LM_WIDE_NUM_HEADS = 4

LM_SMALL_VOCAB = 1024
LM_SMALL_MAX_LEN = 256


class SelfAttention(nn.Module):
    """Multi-head self-attention projections (flax ``SPSelfAttention``)."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"model dim {hidden} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.query = Linear(hidden, hidden, compute_dtype=dtype)
        self.key = Linear(hidden, hidden, compute_dtype=dtype)
        self.value = Linear(hidden, hidden, compute_dtype=dtype)
        self.out = Linear(hidden, hidden, compute_dtype=dtype)

    def qkv(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[..., D] -> q, k, v as [..., H, Dh]."""
        split = (*h.shape[:-1], self.num_heads, h.shape[-1] // self.num_heads)
        return (self.query(h).reshape(split), self.key(h).reshape(split),
                self.value(h).reshape(split))


class Block(nn.Module):
    """Pre-LN block: causal attention and a position-wise MLP, both residual.
    Under a sequence-parallel schedule ``mesh`` gives its positions."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, dtype: torch.dtype,
                 schedule: str = "dense", mesh: Mesh | None = None):
        super().__init__()
        check_schedule(schedule, mesh)
        self.schedule, self.mesh = schedule, mesh
        self.ln1 = LayerNorm(hidden, compute_dtype=dtype)
        self.attn = SelfAttention(hidden, num_heads, dtype)
        self.ln2 = LayerNorm(hidden, compute_dtype=dtype)
        self.mlp_in = Linear(hidden, mlp_dim, compute_dtype=dtype)
        self.mlp_out = Linear(mlp_dim, hidden, compute_dtype=dtype)

    def attend_out(self, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        """Residual after attention, then the MLP residual. ``att`` is the
        attention output [..., H, Dh] for the positions of ``x`` [..., D]."""
        x = x + self.attn.out(att.reshape(x.shape))
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, S, D]
        if self.schedule in SP_SCHEDULES:
            dims = token_dims(self.mesh)
            xs = split_to_positions(x, self.mesh, dims)
            out = self.forward_shards(xs, PositionRunner(self, self.mesh))
            return join_positions(out, self.mesh, dims, x.device)
        q, k, v = self.attn.qkv(self.ln1(x))
        att = _ATTENTION[self.schedule](q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                        causal=True).transpose(1, 2)
        return self.attend_out(x, att)

    def forward_shards(self, xs: np.ndarray, run: PositionRunner) -> np.ndarray:
        """The block over the mesh's positions: ``xs`` holds each position's
        [B/dp, S/sp, D] shard (an object array of the mesh's shape); only
        the attention crosses positions. ``run`` runs the position-wise
        parts with the parameters on each position's device."""

        def heads(pos, dev, x):  # [B, S/n, H, Dh] -> contiguous [B, H, S/n, Dh], once
            return tuple(t.transpose(1, 2).contiguous() for t in self.attn.qkv(self.ln1(x)))

        q, k, v = unzip(run(heads, xs), 3)
        att = attend_shards(self.schedule, q, k, v, self.mesh, causal=True)
        return run(lambda pos, dev, x, a: self.attend_out(x, a.transpose(1, 2)), xs, att)


class TransformerLM(nn.Module):
    """Token embed + learned positions -> N pre-LN blocks -> LayerNorm ->
    untied head. ``schedule`` picks every block's attention (module
    docstring)."""

    def __init__(self, *, vocab: int, num_layers: int, num_heads: int, hidden: int,
                 mlp_dim: int, max_len: int, dtype: torch.dtype = torch.float32,
                 schedule: str = "dense", mesh: Mesh | None = None):
        super().__init__()
        check_schedule(schedule, mesh)
        self.schedule, self.mesh = schedule, mesh
        self.vocab, self.num_layers, self.num_heads = vocab, num_layers, num_heads
        self.hidden, self.mlp_dim, self.max_len, self.dtype = hidden, mlp_dim, max_len, dtype
        self.embed = nn.Embedding(vocab, hidden)
        self.pos_embed = nn.Embedding(max_len, hidden)
        for i in range(num_layers):
            self.add_module(f"block{i}", Block(hidden, num_heads, mlp_dim, dtype, schedule, mesh))
        self.ln_f = LayerNorm(hidden, compute_dtype=dtype)
        self.head = Linear(hidden, vocab, compute_dtype=dtype)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def embed_at(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token plus position embedding, in the compute dtype."""
        return (self.embed(tokens) + self.pos_embed(positions)).to(self.dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # [B, S] -> [B, S, V]
        b, s = tokens.shape
        if s > self.max_len:
            # An embedding lookup past the table would fail or, on some
            # paths, clamp silently: refuse, as the JAX module does.
            raise ValueError(f"sequence length {s} exceeds max_len {self.max_len}")
        if self.schedule in SP_SCHEDULES:
            return self._forward_shards(tokens)
        x = self.embed_at(tokens, torch.arange(s, device=tokens.device)[None, :])
        for blk in self.blocks():
            x = blk(x)
        return self.head(self.ln_f(x))

    def _forward_shards(self, tokens: torch.Tensor) -> torch.Tensor:
        """The forward with the sequence cut over ``sp`` (and the batch over
        ``dp``): one shard per position from the embedding to the head,
        each embedded at its global positions; the logits joined on the
        tokens' device."""
        mesh, dims = self.mesh, token_dims(self.mesh)
        toks = split_to_positions(tokens, mesh, dims)
        s_local = tokens.shape[1] // mesh.shape[SP_AXIS]
        k = mesh.axis_names.index(SP_AXIS)
        run = PositionRunner(self, mesh)

        def embed(pos, dev, t):
            start = pos[k] * s_local
            return self.embed_at(t, torch.arange(start, start + s_local, device=dev)[None, :])

        x = run(embed, toks)
        for blk in self.blocks():
            x = blk.forward_shards(x, run)
        logits = run(lambda pos, dev, h: self.head(self.ln_f(h)), x)
        return join_positions(logits, mesh, dims, tokens.device)


def lm_wide(dtype: torch.dtype = torch.float32) -> TransformerLM:
    """4 heads x 128 = 512 hidden, 2 layers, MLP 1024, vocab 2048, max_len
    128 (``dmlc_tpu/models/lm.py:lm_wide``)."""
    return TransformerLM(vocab=LM_WIDE_VOCAB, num_layers=2, num_heads=LM_WIDE_NUM_HEADS,
                         hidden=512, mlp_dim=1024, max_len=LM_WIDE_MAX_LEN, dtype=dtype)


def lm_small(dtype: torch.dtype = torch.float32, schedule: str = "dense") -> TransformerLM:
    """2 heads x 64 = 128 hidden, 2 layers, MLP 256, vocab 1024, max_len 256
    (``dmlc_tpu/models/lm.py:lm_small``)."""
    return TransformerLM(vocab=LM_SMALL_VOCAB, num_layers=2, num_heads=2, hidden=128,
                         mlp_dim=256, max_len=LM_SMALL_MAX_LEN, dtype=dtype, schedule=schedule)
