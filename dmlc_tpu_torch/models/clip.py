"""CLIP image encoder (ViT-L/14 class) in PyTorch for batch embedding.

Port of ``dmlc_tpu/models/clip.py``. Differences from the classification
ViT (``models/vit.py``), whose blocks it runs:

- a bias-free patch conv and a class token drawn N(0, 0.02²) at init;
- a LayerNorm after the position embeddings (``pre_ln``);
- quick-GELU blocks, LayerNorm eps 1e-5;
- the pooled output is ``post_ln`` of the class token, then a bias-free
  ``projection`` to the shared embedding space, returned as float32.

Submodules keep flax's names, as in ``models/vit.py``
(``models/convert.clip_from_jax``).
"""

from __future__ import annotations

import torch

from dmlc_tpu_torch.models.layers import LayerNorm, Linear
from dmlc_tpu_torch.models.vit import PatchTokens, TransformerBlock


class CLIPVisionEncoder(PatchTokens):
    """Input NHWC images, output [B, projection_dim] float32 embeddings."""

    token_std = {"cls_token": 0.02, "pos_embed": 0.02}

    def __init__(self, projection_dim: int = 768, patch_size: int = 14, hidden_size: int = 1024,
                 num_layers: int = 24, num_heads: int = 16, mlp_dim: int = 4096,
                 dtype: torch.dtype = torch.bfloat16, layer_norm_eps: float = 1e-5,
                 image_size: int = 224):
        super().__init__(image_size, patch_size, hidden_size, dtype, patch_bias=False)
        self.num_layers = num_layers
        self.pre_ln = LayerNorm(hidden_size, compute_dtype=dtype, eps=layer_norm_eps)
        for i in range(num_layers):
            self.add_module(f"block{i}", TransformerBlock(
                hidden_size, num_heads, mlp_dim, dtype, layer_norm_eps, "quick_gelu"))
        self.post_ln = LayerNorm(hidden_size, compute_dtype=dtype, eps=layer_norm_eps)
        self.projection = Linear(hidden_size, projection_dim, bias=False, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_ln(self.tokens(x))
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        return self.projection(self.post_ln(x[:, 0])).to(torch.float32)


def clip_vit_l14(dtype: torch.dtype = torch.bfloat16) -> CLIPVisionEncoder:
    return CLIPVisionEncoder(dtype=dtype)


def clip_vit_b32(dtype: torch.dtype = torch.bfloat16) -> CLIPVisionEncoder:
    return CLIPVisionEncoder(projection_dim=512, patch_size=32, hidden_size=768, num_layers=12,
                             num_heads=12, mlp_dim=3072, dtype=dtype)
