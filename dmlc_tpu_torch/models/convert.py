"""Carry weights from the JAX package's variables to this package's modules.

Inverts the torchvision -> flax mappings of ``dmlc_tpu/models/convert.py``:
flax HWIO conv kernels become OIHW weights, dense ``[in, out]`` kernels are
transposed to ``[out, in]``, and the ``batch_stats`` collection becomes each
BatchNorm's ``running_mean`` / ``running_var``. The language models' trees
map name for name (``lm_from_jax``). Inputs are the JAX
``{"params", "batch_stats"}`` tree with numpy leaves (``jax.device_get``
first); outputs are float32 state dicts named as torchvision names them.
Nothing here imports JAX.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def conv_weight(kernel: Any) -> torch.Tensor:
    """flax HWIO conv kernel -> torch OIHW weight."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def dense_weight(kernel: Any) -> torch.Tensor:
    """flax [in, out] dense kernel -> torch [out, in] weight."""
    return _t(np.transpose(np.asarray(kernel)))


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
    for name, block in params.items():
        if not name.startswith("block"):
            continue
        _layer_norm(sd, f"{name}.ln1", block["ln1"])
        _layer_norm(sd, f"{name}.ln2", block["ln2"])
        for proj in ("query", "key", "value", "out"):
            _dense(sd, f"{name}.attn.{proj}", block["attn"][proj])
        _dense(sd, f"{name}.mlp_in", block["mlp_in"])
        _dense(sd, f"{name}.mlp_out", block["mlp_out"])
    _layer_norm(sd, "ln_f", params["ln_f"])
    _dense(sd, "head", params["head"])
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
