"""AlexNet in PyTorch.

Port of ``dmlc_tpu/models/alexnet.py`` (the canonical torchvision topology):
five convs with bias and ReLU, three 3x3/2 max-pools without padding, a
flatten in CHW order, and three dense layers with dropout (off in eval).
Parameters are float32; compute runs in ``dtype``. The public input is NHWC
float, permuted inside to an NCHW view with ``channels_last`` strides.
Submodules carry torchvision's names (``features.{0,3,6,8,10}``,
``classifier.{1,4,6}``), so a torchvision ``state_dict`` loads as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from dmlc_tpu_torch.models.layers import Conv2d, Linear


def _out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


class AlexNet(nn.Module):
    def __init__(
        self,
        num_classes: int = 1000,
        dtype: torch.dtype = torch.bfloat16,
        dropout_rate: float = 0.5,
        image_size: int = 224,
    ):
        super().__init__()
        self.dtype = dtype

        def conv(cin: int, cout: int, kernel: int, stride: int = 1, pad: int = 0) -> Conv2d:
            return Conv2d(cin, cout, kernel, stride, pad, compute_dtype=dtype)

        self.features = nn.Sequential(
            conv(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            conv(64, 192, 5, pad=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            conv(192, 384, 3, pad=1), nn.ReLU(),
            conv(384, 256, 3, pad=1), nn.ReLU(),
            conv(256, 256, 3, pad=1), nn.ReLU(), nn.MaxPool2d(3, 2),
        )
        # The JAX Dense infers its input width from the image; here it is
        # computed from image_size (6x6x256 at 224).
        side = _out(_out(_out(_out(image_size, 11, 4, 2), 3, 2, 0), 3, 2, 0), 3, 2, 0)
        flat = 256 * side * side
        self.classifier = nn.Sequential(
            nn.Dropout(dropout_rate), Linear(flat, 4096, compute_dtype=dtype), nn.ReLU(),
            nn.Dropout(dropout_rate), Linear(4096, 4096, compute_dtype=dtype), nn.ReLU(),
            Linear(4096, num_classes, compute_dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view, channels_last
        x = self.features(x)
        # CHW flatten: the JAX model transposes NHWC -> NCHW before its
        # reshape for the same torchvision weight layout.
        x = torch.flatten(x, 1)
        return self.classifier(x).to(torch.float32)


def alexnet(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16) -> AlexNet:
    return AlexNet(num_classes=num_classes, dtype=dtype)
