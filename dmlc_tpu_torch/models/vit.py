"""Vision Transformer (ViT-B/16 class) in PyTorch.

Port of ``dmlc_tpu/models/vit.py``. Submodules keep flax's names
(``patch_embed``, ``cls_token``, ``pos_embed``, ``block{i}.{ln1,
attn.{query,key,value,out}, ln2, mlp_in, mlp_out}``, ``ln_final``,
``head``), so the JAX parameter tree maps one to one onto the state dict
(``models/convert.vit_from_jax``). Parameters are float32; compute runs in
``dtype`` (bfloat16 by default).

flax semantics kept:

- the input is NHWC and the patch tokens come out in the JAX reshape's
  (h, w) row-major order;
- the residual stream stays in the compute dtype (in bf16 the adds round
  in bf16);
- attention is a plain chain of matrix products, as the JAX package's is
  (XLA computes it there, no Pallas kernel): q·kᵀ in the compute dtype,
  divided by the float32 sqrt(head dim), which promotes the scores to
  float32; a float32 softmax; probabilities cast back to the compute dtype
  before the product with v. ``scaled_dot_product_attention`` would round
  differently;
- GELU is erf-exact for ViT and ``x·sigmoid(1.702x)`` for CLIP;
- LayerNorm statistics in float32 with each family's eps (1e-12 here).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmlc_tpu_torch.models.layers import Conv2d, LayerNorm, Linear


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    # erf-based GELU (what torch/HF "gelu" means), not flax's tanh default.
    return F.gelu(x)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu_exact, "quick_gelu": quick_gelu}


class MultiHeadAttention(nn.Module):
    """Standard MHA with separate q/k/v/out projections (HF-compatible layout)."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"model dim {hidden} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dtype = dtype
        # The JAX module divides by np.sqrt(head_dim).astype(np.float32).
        self.scale = float(np.sqrt(hidden // num_heads).astype(np.float32))
        self.query = Linear(hidden, hidden, compute_dtype=dtype)
        self.key = Linear(hidden, hidden, compute_dtype=dtype)
        self.value = Linear(hidden, hidden, compute_dtype=dtype)
        self.out = Linear(hidden, hidden, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, S, D]
        b, s, d = x.shape

        def split(t: torch.Tensor) -> torch.Tensor:  # [B, S, D] -> [B, H, S, hd]
            return t.reshape(b, s, self.num_heads, d // self.num_heads).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) / self.scale
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, d)
        return self.out(out)


class TransformerBlock(nn.Module):
    """Pre-LN transformer block: LN→MHA→res, LN→MLP→res."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16, layer_norm_eps: float = 1e-12,
                 activation: str = "gelu"):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.ln1 = LayerNorm(hidden, compute_dtype=dtype, eps=layer_norm_eps)
        self.attn = MultiHeadAttention(hidden, num_heads, dtype)
        self.ln2 = LayerNorm(hidden, compute_dtype=dtype, eps=layer_norm_eps)
        self.mlp_in = Linear(hidden, mlp_dim, compute_dtype=dtype)
        self.mlp_out = Linear(mlp_dim, hidden, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp_out(self.act(self.mlp_in(self.ln2(x))))


class PatchTokens(nn.Module):
    """The patch-embedding conv, the class token and the learned positions:
    NHWC images -> [B, 1 + (image/patch)^2, D] tokens in the compute dtype.
    ``token_std`` gives the standard deviation flax draws each token
    parameter with (0: zeros), for ``registry.init_params``."""

    token_std: dict[str, float] = {"cls_token": 0.0, "pos_embed": 0.02}

    def __init__(self, image: int, patch: int, hidden: int, dtype: torch.dtype,
                 patch_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = Conv2d(3, hidden, patch, patch, bias=patch_bias, compute_dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + (image // patch) ** 2, hidden))

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.patch_embed(x.permute(0, 3, 1, 2).to(self.dtype))  # [B, D, h, w]
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, D], (h, w) row-major
        cls = self.cls_token.to(self.dtype).expand(b, -1, -1)
        return torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)


class ViT(PatchTokens):
    """ViT encoder for classification. Input NHWC images, output [B,
    num_classes] float32 logits."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 dtype: torch.dtype = torch.bfloat16, layer_norm_eps: float = 1e-12,
                 activation: str = "gelu", image_size: int = 224):
        super().__init__(image_size, patch_size, hidden_size, dtype)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block{i}", TransformerBlock(
                hidden_size, num_heads, mlp_dim, dtype, layer_norm_eps, activation))
        self.ln_final = LayerNorm(hidden_size, compute_dtype=dtype, eps=layer_norm_eps)
        self.head = Linear(hidden_size, num_classes, compute_dtype=dtype)

    def blocks(self) -> list[TransformerBlock]:
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.tokens(x)
        for blk in self.blocks():
            x = blk(x)
        # LayerNorm is per token: the class token's alone is the JAX
        # module's ln_final(x)[:, 0].
        return self.head(self.ln_final(x[:, 0])).to(torch.float32)


def vit_b16(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16) -> ViT:
    return ViT(num_classes=num_classes, dtype=dtype)


def vit_l14(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16) -> ViT:
    return ViT(num_classes=num_classes, patch_size=14, hidden_size=1024, num_layers=24,
               num_heads=16, mlp_dim=4096, dtype=dtype)
