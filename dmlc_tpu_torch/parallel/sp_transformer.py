"""Sequence-parallel transformer: the attention schedules inside the LM.

Port of ``dmlc_tpu/parallel/sp_transformer.py``. The schedule table and
its dispatch live here; the one LM class is ``models/lm.TransformerLM``,
which takes a ``mesh`` and a ``schedule``, and ``SPTransformerLM`` builds
it with the JAX module's keywords.

Six schedules, as ``SPSelfAttention`` dispatches them:

- on one device: ``"dense"`` (``ring_attention.dense_attention``),
  ``"flash"`` (``ops/flash.flash_attention``, the flash kernels on the
  card) and ``"auto"`` (``ops/flash.attention``, dense below the
  crossover and flash past it);
- over the ``sp`` axis of a mesh: ``"ring"``, ``"ring_flash"`` and
  ``"ulysses"`` (``parallel/ring_attention.py``, ``parallel/ulysses.py``).

Under a sequence-parallel schedule the activations stay cut through the
whole model, as in the JAX module: the tokens are cut into one shard per
``(dp, sp)`` position, and embeddings, LayerNorms, projections, the MLP and
the head run on each position's shard. Only the attention crosses
positions. A shard's position embedding is that of its global positions.
Each position computes with the model's parameters moved to its device by
an autograd-tracked copy (``PositionRunner``; no copy where the position's
device is the parameters' own), so one optimizer over the model's
parameters gets the sum of every position's gradient, as JAX's SPMD
gradient does.
"""

from __future__ import annotations

from itertools import chain
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from dmlc_tpu_torch.parallel.mesh import Mesh
from dmlc_tpu_torch.parallel.ring_attention import (
    ring_attention_shards,
    ring_flash_attention_shards,
)
from dmlc_tpu_torch.parallel.ulysses import ulysses_attention_shards

_SCHEDULES = ("ring", "ring_flash", "ulysses", "dense", "flash", "auto")
#: The schedules that cut the sequence over a mesh's ``SP_AXIS``.
SP_SCHEDULES = _SCHEDULES[:3]
#: The schedules of one device.
SCHEDULES = _SCHEDULES[3:]
SP_AXIS = "sp"

_SHARD_ATTENTION: dict[str, Callable] = {
    "ring": ring_attention_shards,
    "ring_flash": ring_flash_attention_shards,
    "ulysses": ulysses_attention_shards,
}


def check_schedule(schedule: str, mesh: Mesh | None = None) -> None:
    """Raise ``ValueError`` for a schedule the model cannot run: a name
    outside the six, or a sequence-parallel schedule without a mesh that
    has an ``sp`` axis."""
    if schedule not in _SCHEDULES:
        raise ValueError(f"schedule must be one of {_SCHEDULES}, got {schedule!r}")
    if schedule in SP_SCHEDULES:
        if mesh is None:
            raise ValueError(f"schedule {schedule!r} cuts the sequence over the {SP_AXIS!r} "
                             "axis of a mesh: pass mesh= (parallel/mesh.make_mesh)")
        if SP_AXIS not in mesh.axis_names:
            raise ValueError(f"schedule {schedule!r} needs an {SP_AXIS!r} axis, the mesh has "
                             f"{mesh.axis_names}")


def token_dims(mesh: Mesh) -> dict[str, int]:
    """How the model cuts [B, S, ...] activations: S over ``sp``, B over
    ``dp`` when the mesh has it."""
    return {SP_AXIS: 1, **({"dp": 0} if "dp" in mesh.axis_names else {})}


def attend_shards(schedule: str, qs: np.ndarray, ks: np.ndarray, vs: np.ndarray, mesh: Mesh, *,
                  causal: bool, scale: float | None = None) -> np.ndarray:
    """The attention of one layer over the mesh: q, k, v as object arrays of
    the mesh's shape holding each position's [B, H, S/n, Dh] shard; each
    ring along ``sp`` runs ``schedule``. Returns the outputs likewise."""
    fn = _SHARD_ATTENTION[schedule]
    out = np.empty(mesh.devices.shape, dtype=object)
    for line in mesh.lines(SP_AXIS):
        res = fn([qs[p] for p in line], [ks[p] for p in line], [vs[p] for p in line],
                 [mesh.devices[p] for p in line], causal=causal, scale=scale)
        for p, o in zip(line, res):
            out[p] = o
    return out


def unzip(grid: np.ndarray, n: int) -> list[np.ndarray]:
    """An object array of n-tuples -> n object arrays of the same shape."""
    out = [np.empty(grid.shape, dtype=object) for _ in range(n)]
    for pos in np.ndindex(*grid.shape):
        for i in range(n):
            out[i][pos] = grid[pos][i]
    return out


def _to_position(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A parameter as a position on ``device`` computes with it: the tensor
    itself on its own device, else an autograd-tracked copy."""
    return t.to(device)


class _Swap(nn.Module):
    """Holds a module so that ``functional_call`` can swap its tensors for
    the duration of ``body``."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, body: Callable[[], None]) -> None:
        body()


class PositionRunner:
    """Runs a function at every position of ``mesh`` with ``module``'s
    parameters and buffers as that position's device holds them
    (``_to_position``, made once for each device). Positions that share a
    device run in position order under one swap; with no copy to swap
    in, the module runs as it is."""

    def __init__(self, module: nn.Module, mesh: Mesh):
        self.module, self.mesh = module, mesh
        self.groups: dict[torch.device, list[tuple[int, ...]]] = {}
        for pos in np.ndindex(*mesh.devices.shape):
            self.groups.setdefault(mesh.devices[pos], []).append(pos)
        self.swaps: dict[torch.device, dict | None] = {}
        for dev in self.groups:
            moved = {n: (t, _to_position(t, dev))
                     for n, t in chain(module.named_parameters(), module.named_buffers())}
            self.swaps[dev] = (None if all(a is b for a, b in moved.values())
                               else {f"module.{n}": b for n, (_, b) in moved.items()})

    def __call__(self, fn: Callable, *grids: np.ndarray) -> np.ndarray:
        """``fn(pos, device, *shards)`` at every position -> an object array
        of the mesh's shape of its results."""
        out = np.empty(self.mesh.devices.shape, dtype=object)
        for dev, positions in self.groups.items():
            def body(dev=dev, positions=positions) -> None:
                for pos in positions:
                    out[pos] = fn(pos, dev, *(g[pos] for g in grids))

            swap = self.swaps[dev]
            if swap is None:
                body()
            else:
                functional_call(_Swap(self.module), swap, (body,))
        return out


def SPTransformerLM(*, vocab: int, num_layers: int, num_heads: int, hidden: int, mlp_dim: int,
                    max_len: int = 2048, mesh: Mesh | None = None, schedule: str = "ring",
                    dtype: torch.dtype = torch.float32):
    """The JAX package's ``SPTransformerLM`` keywords -> a
    ``models/lm.TransformerLM`` (causal blocks, ``schedule`` over ``mesh``)."""
    from dmlc_tpu_torch.models.lm import TransformerLM

    return TransformerLM(vocab=vocab, num_layers=num_layers, num_heads=num_heads, hidden=hidden,
                         mlp_dim=mlp_dim, max_len=max_len, dtype=dtype, schedule=schedule,
                         mesh=mesh)
