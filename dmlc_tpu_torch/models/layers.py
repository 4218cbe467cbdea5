"""Layers that keep float32 parameters and compute in a chosen dtype.

The JAX models declare ``param_dtype=float32, dtype=bfloat16``: weights are
stored in float32 and cast to the compute dtype at every call. These
subclasses of the ``torch.nn`` layers do the same, so a float32 state dict
(torchvision's, or one carried from the JAX variables) loads as it is and
the compute dtype is a constructor argument.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` over float32 parameters."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.bfloat16, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` over float32 parameters."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.bfloat16, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` over float32 statistics.

    In eval mode it is ``nn.BatchNorm2d``: the running statistics in
    float32, the input's dtype out. In training it normalizes with the
    batch mean and the biased batch variance, as torch does, but, as flax
    does and torch does not, it moves the running variance toward that
    biased variance too (torch uses the unbiased one). ``momentum`` is
    torch's (flax momentum 0.9 is 0.1 here)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, training=True, momentum=0.0,
                         eps=self.eps)
        with torch.no_grad():
            xf = x.to(torch.float32)
            self.running_mean.lerp_(xf.mean(dim=(0, 2, 3)), self.momentum)
            self.running_var.lerp_(xf.var(dim=(0, 2, 3), unbiased=False), self.momentum)
            self.num_batches_tracked += 1
        return y


def batch_norm(channels: int) -> BatchNorm2d:
    """BatchNorm over float32 statistics with eps 1e-5 and flax's training
    semantics (``BatchNorm2d``; flax momentum 0.9 is torch momentum 0.1)."""
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: population variance over the last axis with
    eps 1e-6 by default (flax's, not torch's 1e-5; ViT takes 1e-12 and CLIP
    1e-5), statistics in float32 over float32 parameters, output in
    ``compute_dtype``."""

    def __init__(self, features: int, compute_dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__(features, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return y.to(self.compute_dtype)
