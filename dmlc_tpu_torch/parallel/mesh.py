"""Device meshes: named axes over a grid of ``torch.device``s.

Port of ``dmlc_tpu/parallel/mesh.py``: ``make_mesh``, the Megatron
fallback ``param_spec`` and the sharding helpers ``batch_sharding``,
``replicated``, ``param_shardings`` and ``shard_params`` (over
``parallel/sharding.py``'s ``PartitionSpec``, ``NamedSharding`` and
``shard_leaf``); and what the JAX package's ``shard_map`` programs do
with an array: ``split_to_positions`` cuts a tensor into one
shard per mesh position, on that position's device, and
``join_positions`` puts the shards back together. The axes keep the JAX
package's names:

- ``dp`` — data parallel (the batch dimension);
- ``tp`` — tensor parallel (attention heads, MLP hidden, the vocab head);
- ``sp`` — sequence parallel (``parallel/ring_attention.py``,
  ``parallel/ulysses.py``, ``parallel/sp_transformer.py``);
- ``pp`` — pipeline stages (``parallel/pipeline.py``);
- ``ep`` — experts (``parallel/moe.py``).

A ``Mesh`` is the axis names over a numpy object grid of devices. The
default device list is the card's, ``cuda:0 … cuda:{n-1}``; ``device="cpu"``
gives ``[cpu]``. A device list passed explicitly may name one device at
several positions: each position still holds its own shard tensors
(``sharding.make_shard_and_gather_fns``), so a width-8 mesh runs on one
card, or on the CPU, as the JAX package's tests run widths up to 8 on
virtual CPU devices.

Within one process, what a collective of the JAX package does over its
axis is done here between the positions' tensors: ``lax.ppermute`` is a
shard moving to the next position's device (``Tensor.to``, which autograd
differentiates and which is no copy where both positions name one
device), ``lax.all_to_all`` a split and a concatenation across positions,
``lax.all_gather`` a concatenation.

Processes. Once the processes of a fleet have joined one default
``torch.distributed`` group (``parallel/multihost.py``), ``make_mesh``
without an explicit device list lays the mesh over ``world x local
devices``, the process the slowest-varying position, as the JAX package's
global ``jax.devices()`` does after ``jax.distributed.initialize``. Each
position knows the rank that owns it (``Mesh.processes``, as a JAX
``Device`` knows its ``process_index``); a process runs only its own
positions, and what crosses processes goes through ``torch.distributed``
collectives. ``process_dp_coords`` holds a mesh to the layout that a
batch over processes needs: each process owns an equal, contiguous run
of dp coordinates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from dmlc_tpu_torch.utils.device import resolve_device


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of the default ``torch.distributed`` group, or
    (0, 1) when none is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis per name.
    ``processes``: an int array of the same shape, the rank that owns each
    position (None: every position is this process's)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    processes: np.ndarray | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def process_count(self) -> int:
        return 1 if self.processes is None else int(self.processes.max()) + 1

    def process_of(self, pos: tuple[int, ...]) -> int:
        """The rank that owns position ``pos``."""
        return 0 if self.processes is None else int(self.processes[pos])

    def local_positions(self, rank: int | None = None) -> list[tuple[int, ...]]:
        """The positions that ``rank`` (this process's by default) owns, in
        position order: every position of a mesh without ``processes``."""
        every = list(np.ndindex(*self.devices.shape))
        if self.processes is None:
            return every
        if rank is None:
            rank = process_index_count()[0]
        return [pos for pos in every if self.process_of(pos) == rank]

    def lines(self, axis_name: str) -> list[list[tuple[int, ...]]]:
        """The positions along ``axis_name``, in axis order, one list for
        each index of the other axes (a ring or a pipeline per list)."""
        if axis_name not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis_name!r} axis")
        k = self.axis_names.index(axis_name)
        others = list(self.devices.shape)
        n, others[k] = others[k], 1
        return [[(*pos[:k], j, *pos[k + 1:]) for j in range(n)] for pos in np.ndindex(*others)]


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
    on a single ``dp`` axis. ``devices`` defaults to ``default_devices(device)``;
    under an initialized default group of ``world`` > 1 processes the
    default is that list once for each rank, rank 0's first (every process
    names its own devices alike), each position owned by its rank. An
    explicit list is this process's alone."""
    _, world = process_index_count()
    processes = None
    if devices is None and world > 1:
        local = default_devices(device)
        devices = local * world
        processes = [r for r in range(world) for _ in local]
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
    owners = None if processes is None else np.asarray(processes, np.int64).reshape(sizes)
    return Mesh(grid.reshape(sizes), tuple(names), owners)


def process_dp_coords(mesh: Mesh, dp_axis: str = "dp", rank: int | None = None) -> list[int]:
    """The dp coordinates that process ``rank`` (this one by default) owns,
    after the refusals of the JAX package's engine
    (``dmlc_tpu/parallel/inference.py:172-198``): with several processes,
    the dp axis must partition the batch rows by process (every process
    owns ``dp / processes`` coordinates, and no coordinate is split between
    two processes), and each process's coordinates must be one contiguous
    run, so that its rows are one contiguous slice of the global batch.
    A mesh without ``dp_axis`` has one dp coordinate, 0. Raises
    ``ValueError``."""
    if mesh.processes is None:
        rank = 0
    elif rank is None:
        rank = process_index_count()[0]
    names = mesh.axis_names
    axis = names.index(dp_axis) if dp_axis in names else None
    dp = mesh.devices.shape[axis] if axis is not None else 1
    owners: dict[int, set[int]] = {}
    for pos in np.ndindex(*mesh.devices.shape):
        owners.setdefault(pos[axis] if axis is not None else 0, set()).add(mesh.process_of(pos))
    procs = mesh.process_count
    coords = sorted(c for c, who in owners.items() if rank in who)
    shared = sorted(c for c, who in owners.items() if len(who) > 1)
    if procs > 1 and (shared or len(coords) * procs != dp):
        raise ValueError(
            f"mesh layout puts {len(coords)} of {dp} dp coordinates on process {rank} of "
            f"{procs}{f' and splits coordinates {shared} between processes' if shared else ''}: "
            "the dp axis must partition rows by process — lay dp over processes "
            "(slowest-varying mesh axis), tp/sp within hosts")
    if coords != list(range(coords[0], coords[0] + len(coords))):
        raise ValueError(
            f"process {rank} owns non-contiguous dp coordinates {coords}: each process's dp "
            "slice must be one contiguous run so local row order matches global row order "
            "— build the mesh with an unpermuted device list")
    return coords


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


def batch_sharding(mesh: Mesh, axis: str = "dp"):
    """Shard the leading (batch) dim over ``axis``, replicate the rest."""
    from dmlc_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh):
    from dmlc_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P())


def param_shardings(mesh: Mesh, variables, tp_axis: str = "tp"):
    """Tree of ``NamedSharding``s for a JAX variables tree (nested mappings
    of arrays, or of anything with ``.shape``) under ``mesh``, by
    ``param_spec``. If the mesh has no tp axis, everything replicates (pure
    dp)."""
    from dmlc_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec as P, map_tree

    has_tp = tp_axis in mesh.axis_names
    return map_tree(lambda path, leaf: NamedSharding(
        mesh, param_spec(tuple(path.split("/")), leaf, tp_axis) if has_tp else P()), variables)


def shard_params(mesh: Mesh, variables, tp_axis: str = "tp"):
    """Place a host variables tree onto the mesh by ``param_shardings``: a
    tree of ``sharding.ShardedLeaf``, each position holding its own shard
    on its own device (positions of other processes hold None). A split dim
    that the axis does not divide raises ``ValueError``."""
    from dmlc_tpu_torch.parallel.sharding import map_tree, shard_leaf, tree_paths

    shardings = dict(tree_paths(param_shardings(mesh, variables, tp_axis)))
    return map_tree(lambda path, leaf: shard_leaf(leaf, shardings[path]), variables)


def split_to_positions(x: torch.Tensor, mesh: Mesh, dims: Mapping[str, int]) -> np.ndarray:
    """One shard of ``x`` per mesh position, as an object array of the
    mesh's shape: ``x`` cut into equal parts along dim ``dims[a]`` over the
    positions of each named axis ``a`` (major to minor in the mesh's axis
    order), whole along the mesh's other axes, each shard moved to its
    position's device by an autograd-tracked ``Tensor.to``. A dim that the
    axis does not divide raises ``ValueError``, as ``shard_map`` refuses
    unequal shards."""
    sizes = mesh.shape
    for a, d in dims.items():
        if a not in sizes:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {a!r} axis")
        if x.shape[d] % sizes[a]:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split evenly over "
                             f"{a}={sizes[a]}")
    grid = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(*mesh.devices.shape):
        coord = dict(zip(mesh.axis_names, pos))
        index = [slice(None)] * x.dim()
        for a, d in dims.items():
            step = x.shape[d] // sizes[a]
            index[d] = slice(coord[a] * step, (coord[a] + 1) * step)
        grid[pos] = x[tuple(index)].to(mesh.devices[pos])
    return grid


def join_positions(grid: np.ndarray, mesh: Mesh, dims: Mapping[str, int],
                   device: str | torch.device | None = None) -> torch.Tensor:
    """The inverse of ``split_to_positions``: the shards at index 0 of every
    axis not named in ``dims``, concatenated along ``dims[a]`` in the order
    of each named axis's positions, on ``device`` (the first position's
    when None)."""
    names = [a for a in mesh.axis_names if a in dims]
    sub = grid[tuple(slice(None) if a in dims else 0 for a in mesh.axis_names)]
    dev = torch.device(device) if device is not None else mesh.devices.flat[0]

    def cat(part, axes: list[str]) -> torch.Tensor:
        if not axes:
            return (part[()] if isinstance(part, np.ndarray) else part).to(dev)
        return torch.cat([cat(part[i], axes[1:]) for i in range(part.shape[0])],
                         dim=dims[axes[0]])

    return cat(sub, names)
