"""Carry weights from the JAX package's variables to this package's modules.

Inverts the torchvision -> flax mappings of ``dmlc_tpu/models/convert.py``:
flax HWIO conv kernels become OIHW weights, dense ``[in, out]`` kernels are
transposed to ``[out, in]``, and the ``batch_stats`` collection becomes each
BatchNorm's ``running_mean`` / ``running_var``. The language models',
ViT's and CLIP's trees map name for name (``lm_from_jax``, ``vit_from_jax``,
``clip_from_jax``; their class tokens and positions are parameters of the
top module). Inputs are the JAX ``{"params", "batch_stats"}`` tree with
numpy leaves (``jax.device_get`` first); outputs are float32 state dicts
named as torchvision names them.

The way back, ``resnet_to_jax``, ``alexnet_to_jax``, ``lm_to_jax``,
``vit_to_jax`` and ``clip_to_jax``, is the exact inverse: a state dict of
this package's module becomes the JAX variables tree with float32 numpy
leaves (``num_batches_tracked`` is dropped), so ``to_jax(from_jax(v))``
equals ``v`` bit for bit. Given the module's state dict on the ``meta``
device it gives the tree's key paths and shapes alone, as ``LeafSpec``
leaves (models/weights.py's template).

The four external importers, ``vit_params_from_hf``,
``clip_params_from_hf``, ``resnet_params_from_torch`` and
``alexnet_params_from_torch``, are copied from
``dmlc_tpu/models/convert.py``: numpy state dicts in torchvision's or
HuggingFace's layout to the JAX variables tree.
Nothing here imports JAX.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch


def _f32(a: Any) -> np.ndarray:
    """A leaf as a float32 numpy array (a bfloat16 tensor read from a
    weights blob included)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(_f32(a))


def conv_weight(kernel: Any) -> torch.Tensor:
    """flax HWIO conv kernel -> torch OIHW weight."""
    return _t(np.transpose(_f32(kernel), (3, 2, 0, 1)))


def dense_weight(kernel: Any) -> torch.Tensor:
    """flax [in, out] dense kernel -> torch [out, in] weight."""
    return _t(np.transpose(_f32(kernel)))


def _bn(sd: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


_BLOCK_RE = re.compile(r"stage(\d+)_block(\d+)$")


def resnet_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """models.resnet.ResNet variables -> this package's ResNet state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {"conv1.weight": conv_weight(params["conv_init"]["kernel"])}
    _bn(sd, "bn1", params["bn_init"], stats["bn_init"])
    for name, block in params.items():
        m = _BLOCK_RE.match(name)
        if m is None:
            continue
        ours = f"layer{m.group(1)}.{int(m.group(2)) - 1}"
        bstats = stats[name]
        for key, leaf in block.items():
            if key.startswith("Conv_"):
                c = int(key.split("_")[1]) + 1
                sd[f"{ours}.conv{c}.weight"] = conv_weight(leaf["kernel"])
            elif key.startswith("BatchNorm_"):
                c = int(key.split("_")[1]) + 1
                _bn(sd, f"{ours}.bn{c}", leaf, bstats[key])
            elif key == "downsample_conv":
                sd[f"{ours}.downsample.0.weight"] = conv_weight(leaf["kernel"])
            elif key == "downsample_bn":
                _bn(sd, f"{ours}.downsample.1", leaf, bstats[key])
            else:
                raise KeyError(f"unexpected ResNet block entry {name}/{key}")
    sd["fc.weight"] = dense_weight(params["head"]["kernel"])
    sd["fc.bias"] = _t(params["head"]["bias"])
    return sd


_ALEXNET_CONVS = {"conv1": 0, "conv2": 3, "conv3": 6, "conv4": 8, "conv5": 10}
_ALEXNET_DENSE = {"fc1": 1, "fc2": 4, "head": 6}


def alexnet_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """models.alexnet.AlexNet variables -> this package's AlexNet state dict."""
    params = variables["params"]
    sd: dict[str, torch.Tensor] = {}
    for ours, idx in _ALEXNET_CONVS.items():
        sd[f"features.{idx}.weight"] = conv_weight(params[ours]["kernel"])
        sd[f"features.{idx}.bias"] = _t(params[ours]["bias"])
    for ours, idx in _ALEXNET_DENSE.items():
        sd[f"classifier.{idx}.weight"] = dense_weight(params[ours]["kernel"])
        sd[f"classifier.{idx}.bias"] = _t(params[ours]["bias"])
    return sd


def _dense(sd: dict, prefix: str, leaf: Mapping) -> None:
    sd[f"{prefix}.weight"] = dense_weight(leaf["kernel"])
    if "bias" in leaf:
        sd[f"{prefix}.bias"] = _t(leaf["bias"])


def _layer_norm(sd: dict, prefix: str, leaf: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(leaf["scale"])
    sd[f"{prefix}.bias"] = _t(leaf["bias"])


def lm_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """SPTransformerLM variables -> this package's TransformerLM state dict:
    dense ``[in, out]`` kernels become ``[out, in]`` weights, embedding
    tables ``[V, D]`` stay as they are, LayerNorm ``scale`` becomes
    ``weight``."""
    params = variables["params"]
    sd: dict[str, torch.Tensor] = {
        "embed.weight": _t(params["embed"]["embedding"]),
        "pos_embed.weight": _t(params["pos_embed"]["embedding"]),
    }
    _blocks(sd, params)
    _layer_norm(sd, "ln_f", params["ln_f"])
    _dense(sd, "head", params["head"])
    return sd


def _blocks(sd: dict, params: Mapping) -> None:
    """The pre-LN blocks the language models, ViT and CLIP share:
    ``block{i}/{ln1, attn/{query,key,value,out}, ln2, mlp_in, mlp_out}``."""
    for name, block in params.items():
        if not name.startswith("block"):
            continue
        _layer_norm(sd, f"{name}.ln1", block["ln1"])
        _layer_norm(sd, f"{name}.ln2", block["ln2"])
        for proj in ("query", "key", "value", "out"):
            _dense(sd, f"{name}.attn.{proj}", block["attn"][proj])
        _dense(sd, f"{name}.mlp_in", block["mlp_in"])
        _dense(sd, f"{name}.mlp_out", block["mlp_out"])


def _patch_tokens(params: Mapping) -> dict[str, torch.Tensor]:
    """ViT/CLIP ``patch_embed`` (CLIP's without bias), ``cls_token`` and
    ``pos_embed``."""
    patch = params["patch_embed"]
    sd = {"patch_embed.weight": conv_weight(patch["kernel"]),
          "cls_token": _t(params["cls_token"]), "pos_embed": _t(params["pos_embed"])}
    if "bias" in patch:
        sd["patch_embed.bias"] = _t(patch["bias"])
    return sd


def vit_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """models.vit.ViT variables -> this package's ViT state dict."""
    params = variables["params"]
    sd = _patch_tokens(params)
    _blocks(sd, params)
    _layer_norm(sd, "ln_final", params["ln_final"])
    _dense(sd, "head", params["head"])
    return sd


def clip_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """models.clip.CLIPVisionEncoder variables -> this package's
    CLIPVisionEncoder state dict."""
    params = variables["params"]
    sd = _patch_tokens(params)
    _layer_norm(sd, "pre_ln", params["pre_ln"])
    _blocks(sd, params)
    _layer_norm(sd, "post_ln", params["post_ln"])
    _dense(sd, "projection", params["projection"])
    return sd


def load_into(model: torch.nn.Module, model_name: str, variables: Mapping) -> None:
    """Copy weights into ``model``'s resident tensors. ``variables`` is
    either this package's state dict or the JAX package's ``{"params",
    ...}`` tree (numpy leaves), carried over by ``variables_from_jax``. Keys
    and shapes must match exactly; nothing is reallocated."""
    if "params" in variables:
        variables = variables_from_jax(model_name, variables)
    current = model.state_dict()
    missing = sorted(set(current) - set(variables))
    extra = sorted(set(variables) - set(current))
    if missing or extra:
        raise ValueError(f"variables mismatch: missing {missing[:8]}, unexpected {extra[:8]}")
    new = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
           for k, v in variables.items()}
    for key, cur in current.items():
        if tuple(new[key].shape) != tuple(cur.shape):
            raise ValueError(
                f"shape mismatch at {key}: got {tuple(new[key].shape)}, "
                f"model has {tuple(cur.shape)}"
            )
    with torch.no_grad():
        for key, cur in current.items():
            cur.copy_(new[key])


def variables_from_jax(model_name: str, variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX variables tree of registry model ``model_name`` -> the state
    dict of this package's module for that model."""
    from dmlc_tpu_torch.models.registry import get_model

    spec = get_model(model_name)
    if spec.from_jax is None:
        raise KeyError(f"model {model_name!r} has no JAX weight mapping")
    return spec.from_jax(variables)


# ---------------------------------------------------------------------------
# The way back: this package's state dicts -> the JAX variables tree
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafSpec:
    """Shape and dtype of one leaf of a variables tree, without its values
    (what ``jax.ShapeDtypeStruct`` is to the JAX package's template)."""

    shape: tuple[int, ...]
    dtype: np.dtype


def _leaf(t: torch.Tensor) -> np.ndarray | LeafSpec:
    if t.is_meta:
        return LeafSpec(tuple(t.shape), np.dtype(np.float32))
    return np.array(t.detach().to("cpu", torch.float32).contiguous().numpy())


def _hwio(w: torch.Tensor) -> np.ndarray | LeafSpec:
    """torch OIHW conv weight -> flax HWIO kernel."""
    return _leaf(w.permute(2, 3, 1, 0))


def _in_out(w: torch.Tensor) -> np.ndarray | LeafSpec:
    """torch [out, in] weight -> flax [in, out] kernel."""
    return _leaf(w.t())


# kind -> field of the torch module -> (collection, flax leaf name, map).
_FIELDS: dict[str, dict[str, tuple[str, str, Callable]]] = {
    "conv": {"weight": ("params", "kernel", _hwio), "bias": ("params", "bias", _leaf)},
    "dense": {"weight": ("params", "kernel", _in_out), "bias": ("params", "bias", _leaf)},
    "bn": {"weight": ("params", "scale", _leaf), "bias": ("params", "bias", _leaf),
           "running_mean": ("batch_stats", "mean", _leaf),
           "running_var": ("batch_stats", "var", _leaf)},
    "ln": {"weight": ("params", "scale", _leaf), "bias": ("params", "bias", _leaf)},
    "embed": {"weight": ("params", "embedding", _leaf)},
    # Parameters of the top module itself (ViT's and CLIP's tokens).
    "tokens": {"cls_token": ("params", "cls_token", _leaf),
               "pos_embed": ("params", "pos_embed", _leaf)},
}


def state_dict_to_jax(sd: Mapping[str, torch.Tensor],
                      locate: Callable[[str], tuple[tuple[str, ...], str]]) -> dict:
    """A state dict -> the JAX variables tree. ``locate`` maps a torch
    module's dotted name to its flax path and its kind (a key of
    ``_FIELDS``); BatchNorm's ``num_batches_tracked`` has no flax leaf."""
    out: dict = {}
    for key, t in sd.items():
        module, _, field = key.rpartition(".")
        if field == "num_batches_tracked":
            continue
        path, kind = locate(module)
        collection, name, fn = _FIELDS[kind][field]
        node = out.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[name] = fn(t)
    return out


_RESNET_TOP = {"conv1": ("conv_init", "conv"), "bn1": ("bn_init", "bn"), "fc": ("head", "dense")}
_RESNET_BLOCK_RE = re.compile(r"layer(\d+)\.(\d+)\.(?:(conv|bn)(\d+)|downsample\.([01]))")


def _resnet_locate(module: str) -> tuple[tuple[str, ...], str]:
    if module in _RESNET_TOP:
        name, kind = _RESNET_TOP[module]
        return (name,), kind
    m = _RESNET_BLOCK_RE.fullmatch(module)
    if m is None:
        raise KeyError(f"unexpected ResNet entry {module}")
    block = f"stage{m.group(1)}_block{int(m.group(2)) + 1}"
    if m.group(5) is not None:
        return ((block, "downsample_conv"), "conv") if m.group(5) == "0" else \
            ((block, "downsample_bn"), "bn")
    kind = m.group(3)
    flax = "Conv" if kind == "conv" else "BatchNorm"
    return (block, f"{flax}_{int(m.group(4)) - 1}"), kind


def resnet_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """This package's ResNet state dict -> models.resnet.ResNet variables
    (``params`` and ``batch_stats``); the inverse of ``resnet_from_jax``."""
    return state_dict_to_jax(sd, _resnet_locate)


_ALEXNET_BACK = {f"features.{i}": (name, "conv") for name, i in _ALEXNET_CONVS.items()} | {
    f"classifier.{i}": (name, "dense") for name, i in _ALEXNET_DENSE.items()}


def _alexnet_locate(module: str) -> tuple[tuple[str, ...], str]:
    if module not in _ALEXNET_BACK:
        raise KeyError(f"unexpected AlexNet entry {module}")
    name, kind = _ALEXNET_BACK[module]
    return (name,), kind


def alexnet_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """This package's AlexNet state dict -> models.alexnet.AlexNet
    variables; the inverse of ``alexnet_from_jax``."""
    return state_dict_to_jax(sd, _alexnet_locate)


_LM_BLOCK_RE = re.compile(r"(block\d+)\.(ln1|ln2|mlp_in|mlp_out|attn\.(?:query|key|value|out))")


def _lm_locate(module: str) -> tuple[tuple[str, ...], str]:
    if module in ("embed", "pos_embed"):
        return (module,), "embed"
    if module in ("ln_f", "head"):
        return (module,), "ln" if module == "ln_f" else "dense"
    m = _LM_BLOCK_RE.fullmatch(module)
    if m is None:
        raise KeyError(f"unexpected language-model entry {module}")
    inner = m.group(2)
    return (m.group(1), *inner.split(".")), "ln" if inner.startswith("ln") else "dense"


def lm_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """This package's TransformerLM state dict -> SPTransformerLM
    variables; the inverse of ``lm_from_jax``."""
    return state_dict_to_jax(sd, _lm_locate)


_IMAGE_TRANSFORMER_TOP = {"": "tokens", "patch_embed": "conv", "pre_ln": "ln",
                          "ln_final": "ln", "post_ln": "ln", "head": "dense",
                          "projection": "dense"}


def _image_transformer_locate(module: str) -> tuple[tuple[str, ...], str]:
    if module in _IMAGE_TRANSFORMER_TOP:
        return ((module,) if module else ()), _IMAGE_TRANSFORMER_TOP[module]
    m = _LM_BLOCK_RE.fullmatch(module)
    if m is None:
        raise KeyError(f"unexpected ViT/CLIP entry {module}")
    inner = m.group(2)
    return (m.group(1), *inner.split(".")), "ln" if inner.startswith("ln") else "dense"


def vit_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """This package's ViT state dict -> models.vit.ViT variables; the
    inverse of ``vit_from_jax``."""
    return state_dict_to_jax(sd, _image_transformer_locate)


def clip_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """This package's CLIPVisionEncoder state dict ->
    models.clip.CLIPVisionEncoder variables; the inverse of
    ``clip_from_jax``."""
    return state_dict_to_jax(sd, _image_transformer_locate)


def to_jax_for(model: torch.nn.Module) -> Callable[[Mapping], dict]:
    """The way back for a module of this package's families, by its class
    (a module built outside the registry, at any width)."""
    from dmlc_tpu_torch.models.alexnet import AlexNet
    from dmlc_tpu_torch.models.clip import CLIPVisionEncoder
    from dmlc_tpu_torch.models.lm import TransformerLM
    from dmlc_tpu_torch.models.resnet import ResNet
    from dmlc_tpu_torch.models.vit import ViT

    for cls, fn in ((ResNet, resnet_to_jax), (AlexNet, alexnet_to_jax), (ViT, vit_to_jax),
                    (CLIPVisionEncoder, clip_to_jax), (TransformerLM, lm_to_jax)):
        if isinstance(model, cls):
            return fn
    raise TypeError(f"no JAX variables layout for {type(model).__name__}")


# ---------------------------------------------------------------------------
# External checkpoint layouts -> the JAX variables tree (numpy only)
# ---------------------------------------------------------------------------


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    """torch OIHW conv weight -> flax HWIO kernel."""
    return np.transpose(w, (2, 3, 1, 0))


def _out_in_to_in_out(w: np.ndarray) -> np.ndarray:
    """torch [out, in] linear weight -> flax [in, out] kernel."""
    return np.transpose(w)


def vit_params_from_hf(sd: Mapping[str, np.ndarray], num_layers: int) -> dict:
    """HF ViTForImageClassification state dict -> models.vit.ViT variables."""
    p = {
        "patch_embed": {
            "kernel": _oihw_to_hwio(sd["vit.embeddings.patch_embeddings.projection.weight"]),
            "bias": sd["vit.embeddings.patch_embeddings.projection.bias"],
        },
        "cls_token": sd["vit.embeddings.cls_token"],
        "pos_embed": sd["vit.embeddings.position_embeddings"],
        "ln_final": {
            "scale": sd["vit.layernorm.weight"],
            "bias": sd["vit.layernorm.bias"],
        },
        "head": {"kernel": _out_in_to_in_out(sd["classifier.weight"]),
                 "bias": sd["classifier.bias"]},
    }
    for i in range(num_layers):
        h = f"vit.encoder.layer.{i}"
        p[f"block{i}"] = {
            "ln1": {"scale": sd[f"{h}.layernorm_before.weight"],
                    "bias": sd[f"{h}.layernorm_before.bias"]},
            "ln2": {"scale": sd[f"{h}.layernorm_after.weight"],
                    "bias": sd[f"{h}.layernorm_after.bias"]},
            "attn": {
                name: {
                    "kernel": _out_in_to_in_out(sd[f"{h}.attention.attention.{name}.weight"]),
                    "bias": sd[f"{h}.attention.attention.{name}.bias"],
                }
                for name in ("query", "key", "value")
            }
            | {
                "out": {
                    "kernel": _out_in_to_in_out(sd[f"{h}.attention.output.dense.weight"]),
                    "bias": sd[f"{h}.attention.output.dense.bias"],
                }
            },
            "mlp_in": {"kernel": _out_in_to_in_out(sd[f"{h}.intermediate.dense.weight"]),
                       "bias": sd[f"{h}.intermediate.dense.bias"]},
            "mlp_out": {"kernel": _out_in_to_in_out(sd[f"{h}.output.dense.weight"]),
                        "bias": sd[f"{h}.output.dense.bias"]},
        }
    return {"params": p}


def clip_params_from_hf(sd: Mapping[str, np.ndarray], num_layers: int) -> dict:
    """HF CLIPVisionModelWithProjection state dict -> CLIPVisionEncoder vars."""
    v = "vision_model"
    p = {
        "patch_embed": {"kernel": _oihw_to_hwio(sd[f"{v}.embeddings.patch_embedding.weight"])},
        "cls_token": sd[f"{v}.embeddings.class_embedding"].reshape(1, 1, -1),
        "pos_embed": sd[f"{v}.embeddings.position_embedding.weight"][None],
        "pre_ln": {"scale": sd[f"{v}.pre_layrnorm.weight"], "bias": sd[f"{v}.pre_layrnorm.bias"]},
        "post_ln": {"scale": sd[f"{v}.post_layernorm.weight"],
                    "bias": sd[f"{v}.post_layernorm.bias"]},
        "projection": {"kernel": _out_in_to_in_out(sd["visual_projection.weight"])},
    }
    for i in range(num_layers):
        h = f"{v}.encoder.layers.{i}"
        p[f"block{i}"] = {
            "ln1": {"scale": sd[f"{h}.layer_norm1.weight"], "bias": sd[f"{h}.layer_norm1.bias"]},
            "ln2": {"scale": sd[f"{h}.layer_norm2.weight"], "bias": sd[f"{h}.layer_norm2.bias"]},
            "attn": {
                ours: {
                    "kernel": _out_in_to_in_out(sd[f"{h}.self_attn.{theirs}.weight"]),
                    "bias": sd[f"{h}.self_attn.{theirs}.bias"],
                }
                for ours, theirs in (
                    ("query", "q_proj"),
                    ("key", "k_proj"),
                    ("value", "v_proj"),
                    ("out", "out_proj"),
                )
            },
            "mlp_in": {"kernel": _out_in_to_in_out(sd[f"{h}.mlp.fc1.weight"]),
                       "bias": sd[f"{h}.mlp.fc1.bias"]},
            "mlp_out": {"kernel": _out_in_to_in_out(sd[f"{h}.mlp.fc2.weight"]),
                        "bias": sd[f"{h}.mlp.fc2.bias"]},
        }
    return {"params": p}


def _bn_from_torch(sd: Mapping[str, np.ndarray], prefix: str) -> tuple[dict, dict]:
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    return params, stats


def resnet_params_from_torch(
    sd: Mapping[str, np.ndarray], stage_sizes: list[int], bottleneck: bool
) -> dict:
    """torchvision ResNet state dict -> models.resnet.ResNet variables
    (params + batch_stats). stage_sizes e.g. [2,2,2,2] for resnet18,
    bottleneck=True for resnet50-style blocks."""
    params: dict = {}
    stats: dict = {}

    params["conv_init"] = {"kernel": _oihw_to_hwio(sd["conv1.weight"])}
    params["bn_init"], stats["bn_init"] = _bn_from_torch(sd, "bn1")
    n_convs = 3 if bottleneck else 2
    for i, count in enumerate(stage_sizes):
        for j in range(count):
            ours = f"stage{i + 1}_block{j + 1}"
            theirs = f"layer{i + 1}.{j}"
            bp: dict = {}
            bs: dict = {}
            for c in range(n_convs):
                bp[f"Conv_{c}"] = {"kernel": _oihw_to_hwio(sd[f"{theirs}.conv{c + 1}.weight"])}
                bp[f"BatchNorm_{c}"], bs[f"BatchNorm_{c}"] = _bn_from_torch(
                    sd, f"{theirs}.bn{c + 1}")
            if f"{theirs}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {
                    "kernel": _oihw_to_hwio(sd[f"{theirs}.downsample.0.weight"])}
                bp["downsample_bn"], bs["downsample_bn"] = _bn_from_torch(
                    sd, f"{theirs}.downsample.1")
            params[ours] = bp
            stats[ours] = bs
    params["head"] = {"kernel": _out_in_to_in_out(sd["fc.weight"]), "bias": sd["fc.bias"]}
    return {"params": params, "batch_stats": stats}


def alexnet_params_from_torch(sd: Mapping[str, np.ndarray]) -> dict:
    """torchvision AlexNet state dict -> models.alexnet.AlexNet variables."""
    p: dict = {}
    for ours, idx in _ALEXNET_CONVS.items():
        p[ours] = {
            "kernel": _oihw_to_hwio(sd[f"features.{idx}.weight"]),
            "bias": sd[f"features.{idx}.bias"],
        }
    for ours, idx in _ALEXNET_DENSE.items():
        p[ours] = {
            "kernel": _out_in_to_in_out(sd[f"classifier.{idx}.weight"]),
            "bias": sd[f"classifier.{idx}.bias"],
        }
    return {"params": p}
