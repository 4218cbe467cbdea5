"""Carry weights from the JAX package's variables to this package's modules.

Inverts the torchvision -> flax mappings of ``dmlc_tpu/models/convert.py``:
flax HWIO conv kernels become OIHW weights, dense ``[in, out]`` kernels are
transposed to ``[out, in]``, and the ``batch_stats`` collection becomes each
BatchNorm's ``running_mean`` / ``running_var``. Inputs are the JAX
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
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


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


def variables_from_jax(model_name: str, variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX variables tree of registry model ``model_name`` -> the state
    dict of this package's module for that model."""
    from dmlc_tpu_torch.models.registry import get_model

    spec = get_model(model_name)
    if spec.from_jax is None:
        raise KeyError(f"model {model_name!r} has no JAX weight mapping")
    return spec.from_jax(variables)
