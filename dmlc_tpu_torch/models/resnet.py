"""ResNet-18 / 34 / 50 in PyTorch.

Port of ``dmlc_tpu/models/resnet.py``: ResNet v1 with bias-free convs,
BatchNorm (eval mode, eps 1e-5), a 7x7/2 stem with padding 3, a 3x3/2
max-pool with padding 1, a 1x1 projection shortcut exactly when a block
changes the shape, global average pooling and a dense head whose logits are
returned as float32. Parameters are float32; compute runs in ``dtype``
(bfloat16 by default).

The public input is NHWC float, as in the JAX model. Inside, the image is
permuted to NCHW with ``channels_last`` strides (a view, no copy), which is
the layout cuDNN's NHWC convolutions take. Submodules carry torchvision's
names (``conv1``, ``bn1``, ``layer{i}.{j}.conv1``, ``downsample.0/1``,
``fc``), so a torchvision ``state_dict`` loads as it is.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dmlc_tpu_torch.models.layers import Conv2d, Linear, batch_norm


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_planes: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = Conv2d(in_planes, filters, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(filters)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn2 = batch_norm(filters)
        self.relu = nn.ReLU()
        self.downsample = _projection(in_planes, filters, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride) -> 1x1 expand (x4) residual block
    (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_planes: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = Conv2d(in_planes, filters, 1, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn2 = batch_norm(filters)
        self.conv3 = Conv2d(filters, out, 1, bias=False, compute_dtype=dtype)
        self.bn3 = batch_norm(out)
        self.relu = nn.ReLU()
        self.downsample = _projection(in_planes, out, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


def _projection(in_planes: int, out: int, stride: int, dtype: torch.dtype) -> nn.Module | None:
    """The 1x1 projection shortcut, present exactly when the block changes
    the shape (stride or width), as the JAX block's shape test decides."""
    if stride == 1 and in_planes == out:
        return None
    return nn.Sequential(
        Conv2d(in_planes, out, 1, stride, bias=False, compute_dtype=dtype),
        batch_norm(out),
    )


class ResNet(nn.Module):
    """ResNet v1. Input NHWC float images; output [N, num_classes] float32
    logits."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: type[BasicBlock] | type[Bottleneck],
        num_classes: int = 1000,
        num_filters: int = 64,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.stage_sizes = list(stage_sizes)
        self.block_cls = block_cls
        self.num_classes = num_classes
        self.num_filters = num_filters
        self.dtype = dtype
        self.conv1 = Conv2d(3, num_filters, 7, 2, 3, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(num_filters)
        self.relu = nn.ReLU()
        # Implicit -inf padding, as flax's max_pool pads.
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_planes = num_filters
        for i, count in enumerate(self.stage_sizes):
            blocks = []
            for j in range(count):
                filters = num_filters * 2**i
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(in_planes, filters, stride, dtype))
                in_planes = filters * block_cls.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = Linear(in_planes, num_classes, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view, channels_last
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
        x = x.mean(dim=(2, 3))  # global average pool
        return self.fc(x).to(torch.float32)


def resnet18(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes=num_classes, dtype=dtype)


def resnet34(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes=num_classes, dtype=dtype)


def resnet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, num_classes=num_classes, dtype=dtype)
