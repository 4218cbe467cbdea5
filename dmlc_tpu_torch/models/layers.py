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


def batch_norm(channels: int) -> nn.BatchNorm2d:
    """BatchNorm over float32 statistics with eps 1e-5 (flax momentum 0.9 is
    torch momentum 0.1). In eval mode it normalizes with the running
    statistics in float32 and returns the input's dtype, as flax does."""
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
