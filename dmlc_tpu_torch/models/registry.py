"""Model registry.

Port of ``dmlc_tpu/models/registry.py`` for the image models of the
serving path: the reference's two jobs, ``resnet18`` and ``alexnet``, plus
``resnet34``, ``resnet50``, ``vit_b16`` and ``vit_l14``, and the CLIP
image encoders ``clip_vit_l14`` and ``clip_vit_b32`` (``classifier=False``:
``num_outputs`` is the embedding width); and for the generation path's
language models ``lm_small`` and ``lm_wide`` (``kind="lm"``:
``input_size`` carries max_len and ``num_outputs`` the vocab). Models are
looked up by name together with their input geometry, so the workers, the
engines and the smoke script agree on model identity by string name. Each
entry declares its partition rules as the JAX package's does
(``parallel/sharding.py``): replicated for the CNNs, the transformer table
with its head count for ViT, CLIP and the language models.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from dmlc_tpu_torch.models.alexnet import alexnet
from dmlc_tpu_torch.models.clip import clip_vit_b32, clip_vit_l14
from dmlc_tpu_torch.models.convert import (
    alexnet_from_jax,
    alexnet_to_jax,
    clip_from_jax,
    clip_to_jax,
    lm_from_jax,
    lm_to_jax,
    resnet_from_jax,
    resnet_to_jax,
    vit_from_jax,
    vit_to_jax,
)
from dmlc_tpu_torch.models.lm import (
    LM_SMALL_MAX_LEN,
    LM_SMALL_VOCAB,
    LM_WIDE_MAX_LEN,
    LM_WIDE_NUM_HEADS,
    LM_WIDE_VOCAB,
    TransformerLM,
    lm_small,
    lm_wide,
)
from dmlc_tpu_torch.models.resnet import resnet18, resnet34, resnet50
from dmlc_tpu_torch.models.vit import PatchTokens, vit_b16, vit_l14
from dmlc_tpu_torch.parallel.sharding import (
    REPLICATED_PARTITION_RULES,
    TRANSFORMER_PARTITION_RULES,
)

#: Images in the seeded batch that calibrates BatchNorm statistics.
_CALIBRATION_BATCH = 8
#: Standard deviation the seeded head gives the calibration batch's logits:
#: wide enough that most images have a clear top class.
_LOGIT_SPREAD = 4.0


@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[..., nn.Module]    # (num_classes=..., dtype=...) -> nn.Module
    input_size: int                    # square image side; max_len for kind="lm"
    num_outputs: int                   # classes / embedding dim; vocab for "lm"
    classifier: bool = True            # False => embedding model (no top-1)
    kind: str = "image"                # "image" | "lm" (autoregressive decode)
    # JAX variables tree -> this package's state dict, and back
    # (models/convert.py).
    from_jax: Callable[[Mapping], dict[str, torch.Tensor]] | None = None
    to_jax: Callable[[Mapping], dict] | None = None
    # Ordered (regex, PartitionSpec) table consumed by parallel/sharding.py,
    # matched against the JAX variables tree. None => fully replicated.
    # num_heads bounds tp.
    partition_rules: tuple[tuple[str, Any], ...] | None = None
    num_heads: int | None = None

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
        dominates the logits.

        A language model, a ViT or a CLIP encoder is drawn as flax
        initialises it (``_draw_as_flax``); nothing is calibrated."""
        gen = torch.Generator().manual_seed(int(seed))
        out = self.module(dtype=dtype).eval()
        if isinstance(out, (TransformerLM, PatchTokens)):
            _draw_as_flax(out, gen)
            return out
        # Calibrated in eval mode (BatchNorm switched to training below): a
        # dropout layer must not drop units of the calibration batch.
        model = out if dtype == torch.float32 else self.module(dtype=torch.float32).eval()
        bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
        head = [m for m in model.modules() if isinstance(m, nn.Linear)][-1]
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, (nn.Conv2d, nn.Linear)):
                    fan_in = math.prod(mod.weight.shape[1:])
                    mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
                    if mod.bias is not None:
                        mod.bias.zero_()
            # Each BatchNorm normalizes the batch by its own statistics, and
            # its running statistics become that batch's mean and unbiased
            # variance (what torch's cumulative average records for one
            # batch, which the seeded weights have always used).
            def calibrate(bn, inputs, _output):
                x = inputs[0].to(torch.float32)
                bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
                bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=True))

            hooks = [bn.register_forward_hook(calibrate) for bn in bns]
            for bn in bns:
                bn.reset_parameters()
                bn.train()
            size = self.input_size
            logits = model(torch.randn(_CALIBRATION_BATCH, size, size, 3, generator=gen))
            for hook in hooks:
                hook.remove()
            head.bias.sub_(logits.mean(dim=0))
            gain = _LOGIT_SPREAD / float((logits - logits.mean(dim=0)).std())
            head.weight.mul_(gain)
            head.bias.mul_(gain)
        model.eval()
        if model is not out:
            out.load_state_dict(model.state_dict())
        return out

    # ---- analytic model accounting ---------------------------------------

    def param_count(self) -> int:
        """Total parameter and statistic scalars of the JAX variables tree
        (params + batch_stats), from the shapes of ``variables_template``:
        no weights are allocated."""
        return sum(math.prod(leaf.shape) for leaf in _template_leaves(self.name))

    def param_bytes(self, dtype: Any = None) -> int:
        """Resident bytes of the variables tree: each leaf's element count
        times its template dtype's width (float32), or ``dtype``'s (a torch
        or numpy dtype) when the serving engine casts."""
        if dtype is None:
            itemsize = None
        elif isinstance(dtype, torch.dtype):
            itemsize = torch.empty((), dtype=dtype).element_size()
        else:
            itemsize = np.dtype(dtype).itemsize
        return sum(math.prod(leaf.shape) * (itemsize or leaf.dtype.itemsize)
                   for leaf in _template_leaves(self.name))

    def flops_per_item(self) -> float | None:
        """Analytic forward FLOPs for one item: an image, or one generated
        token (a decode step at max_len context) for ``kind="lm"`` (a
        multiply-accumulate is 2 FLOPs; elementwise, norm and pool terms are
        omitted). None for models without a formula."""
        fn = _FLOPS_PER_ITEM.get(self.name)
        return float(fn()) if fn is not None else None


def _draw_as_flax(model: nn.Module, gen: torch.Generator) -> None:
    """flax's initialisers, drawn from ``gen``: LeCun-normal dense and conv
    weights (std 1/sqrt(fan_in)), zero biases, unit LayerNorm scale and
    zero shift, embedding tables with std 1/sqrt(hidden), and each token
    parameter a ViT or CLIP module lists in ``token_std`` N(0, std²)
    (zeros at std 0)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = math.prod(mod.weight.shape[1:])
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim), generator=gen)
            elif isinstance(mod, nn.LayerNorm):
                mod.reset_parameters()
        for name, std in getattr(model, "token_std", {}).items():
            param = getattr(model, name)
            if std:
                param.normal_(0.0, std, generator=gen)
            else:
                param.zero_()


def _template_leaves(name: str) -> list:
    from dmlc_tpu_torch.models import weights

    return [leaf for _, leaf in weights.flatten_with_keys(weights.variables_template(name))]


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


def _vit_flops(patch: int, hidden: int, layers: int, mlp: int,
               out_dim: int, image: int = 224, cls_tokens: int = 1) -> float:
    """Transformer walk shared by models/vit.py and the CLIP vision trunk:
    patch-embed conv + per-block (q/k/v/out projections, score+mix
    attention, MLP) + head/projection read off the cls token."""
    grid = image // patch
    seq = grid * grid + cls_tokens
    fl = 2.0 * grid * grid * hidden * 3 * patch * patch
    per_block = (
        8.0 * seq * hidden * hidden        # q, k, v, out projections
        + 4.0 * seq * seq * hidden         # QK^T scores + attention-weighted V
        + 4.0 * seq * hidden * mlp         # MLP in + out
    )
    return fl + layers * per_block + 2.0 * hidden * out_dim


def _lm_decode_flops(vocab: int, layers: int, hidden: int, mlp: int,
                     context: int) -> float:
    """One decode step (one generated token) at ``context`` resident
    tokens: per-layer q/k/v/out projections + paged-KV attention + MLP,
    plus the vocab head. The embedding lookup is a gather (no MACs)."""
    per_layer = (
        8.0 * hidden * hidden              # q, k, v, out projections
        + 4.0 * context * hidden           # scores + mix against the KV pages
        + 4.0 * hidden * mlp               # MLP in + out
    )
    return layers * per_layer + 2.0 * hidden * vocab


_FLOPS_PER_ITEM: dict[str, Callable[[], float]] = {
    "resnet18": lambda: _resnet_flops((2, 2, 2, 2), False),
    "resnet34": lambda: _resnet_flops((3, 4, 6, 3), False),
    "resnet50": lambda: _resnet_flops((3, 4, 6, 3), True),
    "alexnet": lambda: _alexnet_flops(),
    "vit_b16": lambda: _vit_flops(16, 768, 12, 3072, 1000),
    "vit_l14": lambda: _vit_flops(14, 1024, 24, 4096, 1000),
    "clip_vit_l14": lambda: _vit_flops(14, 1024, 24, 4096, 768),
    "clip_vit_b32": lambda: _vit_flops(32, 768, 12, 3072, 512),
    "lm_small": lambda: _lm_decode_flops(LM_SMALL_VOCAB, 2, 128, 256, LM_SMALL_MAX_LEN),
    "lm_wide": lambda: _lm_decode_flops(LM_WIDE_VOCAB, 2, 512, 1024, LM_WIDE_MAX_LEN),
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


def _spec(name: str, build: Callable[..., nn.Module], from_jax: Any, to_jax: Any,
          num_outputs: int = 1000, classifier: bool = True,
          num_heads: int | None = None) -> ModelSpec:
    rules = REPLICATED_PARTITION_RULES if num_heads is None else TRANSFORMER_PARTITION_RULES
    return ModelSpec(name, build, 224, num_outputs, classifier=classifier, from_jax=from_jax,
                     to_jax=to_jax, partition_rules=rules, num_heads=num_heads)


for _s in [
    _spec("resnet18", resnet18, resnet_from_jax, resnet_to_jax),
    _spec("resnet34", resnet34, resnet_from_jax, resnet_to_jax),
    _spec("resnet50", resnet50, resnet_from_jax, resnet_to_jax),
    _spec("alexnet", alexnet, alexnet_from_jax, alexnet_to_jax),
    _spec("vit_b16", vit_b16, vit_from_jax, vit_to_jax, num_heads=12),
    _spec("vit_l14", vit_l14, vit_from_jax, vit_to_jax, num_heads=16),
    _spec("clip_vit_l14", clip_vit_l14, clip_from_jax, clip_to_jax, 768, classifier=False,
          num_heads=16),
    _spec("clip_vit_b32", clip_vit_b32, clip_from_jax, clip_to_jax, 512, classifier=False,
          num_heads=12),
    ModelSpec("lm_small", lm_small, LM_SMALL_MAX_LEN, LM_SMALL_VOCAB, classifier=False,
              kind="lm", from_jax=lm_from_jax, to_jax=lm_to_jax,
              partition_rules=TRANSFORMER_PARTITION_RULES, num_heads=2),
    ModelSpec("lm_wide", lm_wide, LM_WIDE_MAX_LEN, LM_WIDE_VOCAB, classifier=False,
              kind="lm", from_jax=lm_from_jax, to_jax=lm_to_jax,
              partition_rules=TRANSFORMER_PARTITION_RULES, num_heads=LM_WIDE_NUM_HEADS),
]:
    register(_s)
