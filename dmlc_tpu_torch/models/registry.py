"""Model registry.

Port of ``dmlc_tpu/models/registry.py`` for the image classifiers of the
serving path: the reference's two jobs, ``resnet18`` and ``alexnet``, plus
``resnet34`` and ``resnet50``. Models are looked up by name together with
their input geometry, so the worker, the engine and the smoke script agree
on model identity by string name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch
from torch import nn

from dmlc_tpu_torch.models.alexnet import alexnet
from dmlc_tpu_torch.models.convert import alexnet_from_jax, resnet_from_jax
from dmlc_tpu_torch.models.resnet import resnet18, resnet34, resnet50

#: Images in the seeded batch that calibrates BatchNorm statistics.
_CALIBRATION_BATCH = 8
#: Standard deviation the seeded head gives the calibration batch's logits:
#: wide enough that most images have a clear top class.
_LOGIT_SPREAD = 4.0


@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[..., nn.Module]    # (num_classes=..., dtype=...) -> nn.Module
    input_size: int                    # square image side
    num_outputs: int                   # classes / embedding dim
    classifier: bool = True            # False => embedding model (no top-1)
    kind: str = "image"
    # JAX variables tree -> this package's state dict (models/convert.py).
    from_jax: Callable[[Mapping], dict[str, torch.Tensor]] | None = None

    def module(self, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
        if self.classifier:
            return self.build(num_classes=self.num_outputs, dtype=dtype)
        return self.build(dtype=dtype)

    def init_params(self, seed: int, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
        """A module whose weights are drawn from ``seed`` alone, on the CPU:
        He-normal conv and dense weights, zero biases, unit BatchNorm scale,
        zero BatchNorm shift. One float32 pass over a batch of seeded
        N(0, 1) images then calibrates the BatchNorm running statistics to
        that batch, sets the head's bias to centre its logits on it and
        scales the head to give them a standard deviation of
        ``_LOGIT_SPREAD``.
        Without the calibration, a random network answers one class for
        nearly every input, because the positive mean of its ReLU features
        dominates the logits."""
        model = self.module(dtype=torch.float32).eval()
        gen = torch.Generator().manual_seed(int(seed))
        bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
        head = [m for m in model.modules() if isinstance(m, nn.Linear)][-1]
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, (nn.Conv2d, nn.Linear)):
                    fan_in = math.prod(mod.weight.shape[1:])
                    mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
                    if mod.bias is not None:
                        mod.bias.zero_()
            for bn in bns:
                bn.reset_parameters()
                bn.momentum = None  # cumulative: running stats = this batch's
                bn.train()
            size = self.input_size
            logits = model(torch.randn(_CALIBRATION_BATCH, size, size, 3, generator=gen))
            head.bias.sub_(logits.mean(dim=0))
            gain = _LOGIT_SPREAD / float((logits - logits.mean(dim=0)).std())
            head.weight.mul_(gain)
            head.bias.mul_(gain)
            for bn in bns:
                bn.momentum = 0.1
        model.eval()
        if dtype == torch.float32:
            return model
        out = self.module(dtype=dtype)
        out.load_state_dict(model.state_dict())
        return out.eval()

    def flops_per_item(self) -> float | None:
        """Analytic forward FLOPs for one image (a multiply-accumulate is 2
        FLOPs; elementwise, norm and pool terms are omitted). None for
        models without a formula."""
        fn = _FLOPS_PER_ITEM.get(self.name)
        return float(fn()) if fn is not None else None


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    """Output side of a square conv/pool with explicit symmetric padding."""
    return (size + 2 * pad - kernel) // stride + 1


def _resnet_flops(blocks: tuple[int, ...], bottleneck: bool,
                  num_classes: int = 1000, image: int = 224) -> float:
    """Conv-walk of models/resnet.py: stem 7x7/2 -> maxpool 3x3/2 -> four
    stages (filters 64*2^i, first block of stages 2-4 strides 2), basic
    blocks (two 3x3) or bottlenecks (1x1 -> 3x3 stride s -> 1x1 expand x4),
    1x1 projection downsample exactly when the residual shape changes."""
    size = _conv_out(image, 7, 2, 3)
    fl = 2.0 * size * size * 64 * 3 * 49           # stem conv, bias-free
    size = _conv_out(size, 3, 2, 1)                # maxpool
    cin = 64
    for i, n in enumerate(blocks):
        f = 64 * 2 ** i
        for b in range(n):
            s = 2 if (i > 0 and b == 0) else 1
            out = _conv_out(size, 3, s, 1)
            if bottleneck:
                fl += 2.0 * size * size * f * cin           # 1x1 reduce
                fl += 2.0 * out * out * f * f * 9           # 3x3, stride s
                fl += 2.0 * out * out * (4 * f) * f         # 1x1 expand
                if s != 1 or cin != 4 * f:
                    fl += 2.0 * out * out * (4 * f) * cin   # projection shortcut
                cin = 4 * f
            else:
                fl += 2.0 * out * out * f * cin * 9
                fl += 2.0 * out * out * f * f * 9
                if s != 1 or cin != f:
                    fl += 2.0 * out * out * f * cin
                cin = f
            size = out
    return fl + 2.0 * cin * num_classes            # pooled head


def _alexnet_flops(num_classes: int = 1000, image: int = 224) -> float:
    """Conv/fc walk of models/alexnet.py (all convs/denses carry bias —
    bias adds are sub-percent and omitted like every elementwise term)."""
    s1 = _conv_out(image, 11, 4, 2)                # 55
    fl = 2.0 * s1 * s1 * 64 * 3 * 121
    s2 = _conv_out(s1, 3, 2, 0)                    # 27
    fl += 2.0 * s2 * s2 * 192 * 64 * 25
    s3 = _conv_out(s2, 3, 2, 0)                    # 13
    fl += 2.0 * s3 * s3 * 384 * 192 * 9
    fl += 2.0 * s3 * s3 * 256 * 384 * 9
    fl += 2.0 * s3 * s3 * 256 * 256 * 9
    s4 = _conv_out(s3, 3, 2, 0)                    # 6
    flat = 256 * s4 * s4
    return fl + 2.0 * (flat * 4096 + 4096 * 4096 + 4096 * num_classes)


_FLOPS_PER_ITEM: dict[str, Callable[[], float]] = {
    "resnet18": lambda: _resnet_flops((2, 2, 2, 2), False),
    "resnet34": lambda: _resnet_flops((3, 4, 6, 3), False),
    "resnet50": lambda: _resnet_flops((3, 4, 6, 3), True),
    "alexnet": lambda: _alexnet_flops(),
}


_REGISTRY: dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def _spec(name: str, build: Callable[..., nn.Module], from_jax: Any) -> ModelSpec:
    return ModelSpec(name, build, 224, 1000, from_jax=from_jax)


for _s in [
    _spec("resnet18", resnet18, resnet_from_jax),
    _spec("resnet34", resnet34, resnet_from_jax),
    _spec("resnet50", resnet50, resnet_from_jax),
    _spec("alexnet", alexnet, alexnet_from_jax),
]:
    register(_s)
