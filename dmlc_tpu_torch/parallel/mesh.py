"""Device meshes: named axes over a grid of ``torch.device``s.

Port of the part of ``dmlc_tpu/parallel/mesh.py`` that the partition-rule
engine (``parallel/sharding.py``) uses: ``make_mesh`` and the Megatron
fallback ``param_spec``. The axes keep the JAX package's names:

- ``dp`` — data parallel (the batch dimension);
- ``tp`` — tensor parallel (attention heads, MLP hidden, the vocab head).

A ``Mesh`` is the axis names over a numpy object grid of devices. The
default device list is the card's, ``cuda:0 … cuda:{n-1}``; ``device="cpu"``
gives ``[cpu]``. A device list passed explicitly may name one device at
several positions: each position still holds its own shard tensors
(``sharding.make_shard_and_gather_fns``), so a width-8 mesh runs on one
card, or on the CPU, as the JAX package's tests run widths up to 8 on
virtual CPU devices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from dmlc_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def default_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """Every device of ``device``'s kind: the card's CUDA devices (raising
    when there is none), or ``[cpu]`` for ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    axes: Mapping[str, int] | None = None,
    *,
    devices: Sequence[str | torch.device] | None = None,
    device: str | torch.device | None = None,
) -> Mesh:
    """A Mesh with the given axis sizes, e.g. ``{"dp": 4, "tp": 2}``.

    Axis size -1 absorbs the remaining devices. Default axes: every device
    on a single ``dp`` axis. ``devices`` defaults to ``default_devices(device)``."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices(device))]
    if axes is None:
        axes = {"dp": len(devs)}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if len(devs) % known:
            raise ValueError(f"{len(devs)} devices not divisible by {known}")
        sizes[sizes.index(-1)] = len(devs) // known
    if math.prod(sizes) != len(devs):
        raise ValueError(f"mesh {dict(zip(names, sizes))} wants {math.prod(sizes)} devices, "
                         f"have {len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(sizes), tuple(names))


def param_spec(path: tuple[str, ...], leaf, tp_axis: str = "tp"):
    """Megatron tensor-parallel spec for a leaf of the JAX variables tree
    (the engine's fallback for a model that declares no rule table):
    attention q/k/v and MLP-in split the output feature dim of their
    ``[in, out]`` kernel over tp, attention-out and MLP-out its input dim,
    the head its output dim; everything else replicates."""
    from dmlc_tpu_torch.parallel.sharding import PartitionSpec as P

    names = list(path)
    name = names[-2] if len(names) >= 2 else ""
    leaf_kind = names[-1] if names else ""
    if leaf_kind == "kernel" and len(leaf.shape) == 2:
        if name in ("query", "key", "value", "mlp_in"):
            return P(None, tp_axis)
        if name in ("out", "mlp_out"):
            return P(tp_axis, None)
        if name == "head":
            return P(None, tp_axis)  # vocab/class dim
    if leaf_kind == "bias" and name in ("query", "key", "value", "mlp_in"):
        return P(tp_axis)
    return P()
