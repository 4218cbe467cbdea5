"""Partition-rule engine: regex rules -> PartitionSpec trees -> sharded programs.

Port of ``dmlc_tpu/parallel/sharding.py``. Every registry model declares
its sharding once, as an ordered table of ``(regex, PartitionSpec)`` rules
(``ModelSpec.partition_rules``). The engine matches each rule with
``re.search`` against the '/'-joined path of every leaf of the model's JAX
variables tree (``models/weights.variables_template``: names and shapes,
no weights) — first match wins, scalars and size-1 leaves always
replicate — and clamps the result to any mesh shape: axes a mesh does not
carry, or that do not divide a leaf's dim, replicate. So one table serves a
1-device replica, a 2-wide tensor-parallel gang and a dp x tp grid.

Because the rules run over the JAX tree, ``validate_model_rules`` and
``sharded_bytes_per_chip`` count exactly the JAX package's leaves (a torch
state dict would add BatchNorm's ``num_batches_tracked``), and a leader of
either package plans from the same integers.

``ShardedProgram`` carries each leaf's spec to the torch tensor that the
model's ``from_jax`` makes of it (``torch_partition_specs``: a flax dense
``[in, out]`` kernel split on its output is a torch ``[out, in]`` weight
split on dim 0), places one shard per mesh position, and runs the model's
own modules with each split ``Linear`` swapped for a ``ShardedLinear``.
The forward is plain torch over the shards and launches none of the
package's kernels, as the JAX program reaches no Pallas kernel.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmlc_tpu_torch.parallel.mesh import Mesh

Tree = Any


class PartitionSpec(tuple):
    """One entry per leading dim of a leaf: a mesh axis name, a tuple of
    names, or None (replicated along that dim)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


PartitionRule = tuple[str, PartitionSpec]

# Megatron-style table for every transformer of the registry (the LMs, ViT,
# the CLIP vision trunk — they share Dense naming): attention q/k/v and
# MLP-in split the OUTPUT feature dim over tp, attention-out and MLP-out
# split the INPUT dim, so each block sums partials once; the vocab/class
# head splits its output and is gathered once at the end. Everything else
# (embeddings, norms, convs, the out-projection biases added after the sum)
# replicates via the terminal catch-all.
TRANSFORMER_PARTITION_RULES: tuple[PartitionRule, ...] = (
    (r"(query|key|value|mlp_in)/kernel$", PartitionSpec(None, "tp")),
    (r"(query|key|value|mlp_in)/bias$", PartitionSpec("tp")),
    (r"(out|mlp_out)/kernel$", PartitionSpec("tp", None)),
    (r"(head|projection)/kernel$", PartitionSpec(None, "tp")),
    (r".*", PartitionSpec()),
)

# CNN families: the win is dp over the batch.
REPLICATED_PARTITION_RULES: tuple[PartitionRule, ...] = ((r".*", PartitionSpec()),)


# ---------------------------------------------------------------------------
# Trees: nested mappings, flattened in jax.tree_util's order


def tree_paths(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """Flatten a tree of nested mappings to ``[('joined/param/path', leaf),
    ...]``, keys sorted."""
    if not isinstance(tree, Mapping):
        return [(prefix, tree)]
    return [item for key in sorted(tree)
            for item in tree_paths(tree[key], f"{prefix}/{key}" if prefix else str(key))]


def map_tree(fn: Callable[[str, Any], Any], tree: Tree, prefix: str = "") -> Tree:
    """The tree with every leaf replaced by ``fn(joined path, leaf)``."""
    if not isinstance(tree, Mapping):
        return fn(prefix, tree)
    return {key: map_tree(fn, sub, f"{prefix}/{key}" if prefix else str(key))
            for key, sub in tree.items()}


def _shape(leaf: Any) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


# ---------------------------------------------------------------------------
# Rules


def match_partition_rules(
    rules: Sequence[PartitionRule], tree: Tree, *, strict: bool = True
) -> Tree:
    """Map every leaf to the spec of the FIRST rule whose regex ``search``es
    its '/'-joined path. Scalars and size-1 leaves always get ``P()``. With
    ``strict`` (the default), a leaf no rule matches raises ``ValueError``."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def one(name: str, leaf: Any) -> PartitionSpec:
        shape = _shape(leaf)
        if not shape or math.prod(shape) == 1:
            return PartitionSpec()
        for pat, spec in compiled:
            if pat.search(name):
                return PartitionSpec(*spec)
        if strict:
            raise ValueError(f"no partition rule matches param {name!r}")
        return PartitionSpec()

    return map_tree(one, tree)


@dataclass(frozen=True)
class RuleReport:
    """Dynamic rule-table audit."""

    dead_rules: tuple[str, ...]  # patterns matching NO param path in the tree
    unmatched: tuple[str, ...]   # param paths no rule matches

    @property
    def ok(self) -> bool:
        return not self.dead_rules and not self.unmatched


def validate_rules(rules: Sequence[PartitionRule], tree: Tree) -> RuleReport:
    """Audit a rule table against a real (or abstract) parameter tree."""
    paths = [p for p, _ in tree_paths(tree)]
    compiled = [(pat, re.compile(pat)) for pat, _ in rules]
    dead = tuple(pat for pat, rx in compiled if not any(rx.search(p) for p in paths))
    unmatched = tuple(p for p in paths if not any(rx.search(p) for _, rx in compiled))
    return RuleReport(dead_rules=dead, unmatched=unmatched)


def _entry_axes(entry: Any) -> tuple[str, ...]:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return tuple(str(a) for a in axes if a is not None)


def clamp_spec(spec: PartitionSpec, mesh: Mesh, shape: Sequence[int]) -> PartitionSpec:
    """Make a spec valid on THIS mesh and leaf shape: drop axes the mesh does
    not carry (or carries at size 1), and fall back to replication on any dim
    the surviving axes do not divide evenly. The rank is trimmed to the
    leaf's, never padded."""
    sizes = mesh.shape
    out: list[Any] = []
    for dim, entry in enumerate(tuple(spec)[: len(shape)]):
        keep = [a for a in _entry_axes(entry) if sizes.get(a, 1) > 1]
        factor = math.prod(sizes[a] for a in keep) if keep else 1
        if factor > 1 and shape[dim] % factor:
            keep = []
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return PartitionSpec(*out)


@dataclass(frozen=True)
class NamedSharding:
    """A clamped spec on a mesh."""

    mesh: Mesh
    spec: PartitionSpec


def shardings_for_tree(
    mesh: Mesh, tree: Tree, rules: Sequence[PartitionRule], *, strict: bool = True
) -> Tree:
    """Rule table + abstract/real param tree -> tree of NamedShardings,
    clamped to this mesh."""
    specs = dict(tree_paths(match_partition_rules(rules, tree, strict=strict)))
    return map_tree(
        lambda name, leaf: NamedSharding(mesh, clamp_spec(specs[name], mesh, _shape(leaf))), tree
    )


# ---------------------------------------------------------------------------
# Placement: one shard per mesh position


@dataclass
class ShardedLeaf:
    """A leaf placed on a mesh: ``shards`` is an object array of the mesh's
    shape holding each position's own tensor, on that position's device."""

    shards: np.ndarray
    sharding: NamedSharding
    shape: tuple[int, ...]


def _shard_index(spec: PartitionSpec, mesh: Mesh, pos: tuple[int, ...]) -> list[tuple[int, int]]:
    """Per dim of ``spec``: (which shard, how many shards) at mesh position
    ``pos``; a dim split over several axes counts them major to minor."""
    coord = dict(zip(mesh.axis_names, pos))
    sizes = mesh.shape
    out = []
    for entry in spec:
        k, f = 0, 1
        for a in _entry_axes(entry):
            k, f = k * sizes[a] + coord[a], f * sizes[a]
        out.append((k, f))
    return out


def _slices(sharding: NamedSharding, pos: tuple[int, ...],
            shape: tuple[int, ...]) -> tuple[slice, ...]:
    out = []
    for dim, (k, f) in enumerate(_shard_index(sharding.spec, sharding.mesh, pos)):
        step = shape[dim] // f
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))


def shard_leaf(leaf: Any, sharding: NamedSharding) -> ShardedLeaf:
    """Place one leaf: each of this process's mesh positions gets its own
    copy of its slice, on its own device (positions that name one device
    hold one copy each; positions of other processes hold None). A split
    dim that its axes do not divide raises ``ValueError``."""
    mesh = sharding.mesh
    t = _as_tensor(leaf)
    for dim, (_, f) in enumerate(_shard_index(sharding.spec, mesh, (0,) * mesh.devices.ndim)):
        if t.shape[dim] % f:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split evenly {f} ways "
                             f"under {sharding.spec}")
    grid = np.empty(mesh.devices.shape, dtype=object)
    for pos in mesh.local_positions():
        grid[pos] = t[_slices(sharding, pos, tuple(t.shape))].to(
            mesh.devices[pos], copy=True, memory_format=torch.contiguous_format)
    return ShardedLeaf(grid, sharding, tuple(t.shape))


def gather_leaf(leaf: ShardedLeaf) -> np.ndarray:
    """A placed leaf back to one host array, from the shards this process
    holds (``ValueError`` if a part of the leaf lies only in another
    process)."""
    held = [pos for pos in np.ndindex(*leaf.shards.shape) if leaf.shards[pos] is not None]
    out = torch.empty(leaf.shape, dtype=leaf.shards[held[0]].dtype)
    seen = torch.zeros(leaf.shape, dtype=torch.bool)
    for pos in held:
        where = _slices(leaf.sharding, pos, leaf.shape)
        out[where] = leaf.shards[pos].cpu()
        seen[where] = True
    if not bool(seen.all()):
        raise ValueError("part of the leaf lies only in another process's positions")
    return out.numpy()


def make_shard_and_gather_fns(
    mesh: Mesh, shardings: Tree
) -> tuple[Callable[[Tree], Tree], Callable[[Tree], Tree]]:
    """``(shard_fn, gather_fn)``: shard_fn places a host tree onto the mesh
    per the shardings (a ``ShardedLeaf`` per leaf); gather_fn brings a
    placed tree back to host numpy."""
    by_path = dict(tree_paths(shardings))

    def shard_fn(tree: Tree) -> Tree:
        return map_tree(lambda name, leaf: shard_leaf(leaf, by_path[name]), tree)

    def gather_fn(tree: Tree) -> Tree:
        return map_tree(lambda name, leaf: gather_leaf(leaf), tree)

    return shard_fn, gather_fn


# ---------------------------------------------------------------------------
# Mesh planning and byte accounting


def plan_axes(
    n_devices: int, *, num_heads: int | None = None, max_tp: int | None = None
) -> dict[str, int]:
    """Mesh-shape selection for a gang of ``n_devices`` chips: tp is the
    largest divisor of n that also divides the head count, capped by
    ``max_tp``; the rest is dp. A prime gang (n=3) with 4 heads runs pure
    dp; n=8 with 4 heads runs dp=2 x tp=4."""
    if n_devices < 1:
        raise ValueError(f"gang needs at least one device, got {n_devices}")
    cap = n_devices if max_tp is None else max(1, min(max_tp, n_devices))
    tp = 1
    for cand in range(1, n_devices + 1):
        if n_devices % cand or cand > cap:
            continue
        if num_heads is not None and num_heads % cand:
            continue
        tp = cand
    return {"dp": n_devices // tp, "tp": tp}


def min_gang_width(model_bytes: int, per_chip_budget: int, *, max_width: int) -> int | None:
    """Smallest gang width whose even ceil-share of the model's resident
    bytes fits the per-chip budget. None when even the widest gang cannot
    fit."""
    if per_chip_budget <= 0:
        return None
    for width in range(1, max(1, max_width) + 1):
        if -(-model_bytes // width) <= per_chip_budget:
            return width
    return None


def rules_for_model(model_name: str) -> tuple[PartitionRule, ...]:
    """The registry model's declared table, or full replication."""
    from dmlc_tpu_torch.models.registry import get_model

    rules = get_model(model_name).partition_rules
    return tuple(rules) if rules else REPLICATED_PARTITION_RULES


def abstract_params(model_name: str) -> Tree:
    """The JAX variables tree of a registry model with shape-only leaves
    (``models/weights.variables_template``; no weights allocated)."""
    from dmlc_tpu_torch.models.weights import variables_template

    return variables_template(model_name)


def validate_model_rules(model_name: str) -> RuleReport:
    """Audit a registry model's declared table against its abstract tree."""
    return validate_rules(rules_for_model(model_name), abstract_params(model_name))


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def sharded_bytes_per_chip(model_name: str, mesh: Mesh, dtype: Any = torch.float32) -> int:
    """Per-chip resident weight bytes under this mesh: each leaf of the JAX
    tree contributes its bytes at ``dtype`` (a torch or numpy dtype; None:
    the leaf's own) divided, rounding up, by the product of the mesh-axis
    sizes its clamped spec shards over. The gauge a gang member publishes."""
    tree = abstract_params(model_name)
    specs = dict(tree_paths(match_partition_rules(rules_for_model(model_name), tree,
                                                  strict=False)))
    sizes = mesh.shape
    total = 0
    for path, leaf in tree_paths(tree):
        shape = tuple(leaf.shape)
        factor = 1
        for entry in clamp_spec(specs[path], mesh, shape):
            for ax in _entry_axes(entry):
                factor *= sizes.get(ax, 1)
        width = _itemsize(dtype) if dtype is not None else np.dtype(leaf.dtype).itemsize
        total += -(-math.prod(shape) * width // factor)
    return total


#: Distinct dim sizes of the probe tensors that find how ``to_jax`` permutes
#: a torch tensor's dims into its JAX leaf.
_PROBE_DIMS = (2, 3, 5, 7, 11, 13)


def torch_partition_specs(model_name: str) -> dict[str, PartitionSpec]:
    """State-dict key -> the spec of its tensor, in torch's dim order.

    Each leaf's spec comes from the rule table on the JAX tree; the JAX
    leaf a torch tensor becomes, and the order of its dims there, come from
    the model's own ``to_jax`` (the inverse of ``from_jax``) applied to a
    ``meta`` probe of distinct dim sizes. A flax kernel ``[in, out]`` with
    ``P(None, "tp")`` is so a torch weight ``[out, in]`` split on dim 0. A
    tensor with no JAX leaf (``num_batches_tracked``) replicates."""
    from dmlc_tpu_torch.models.registry import get_model

    spec = get_model(model_name)
    jax_specs = dict(tree_paths(match_partition_rules(rules_for_model(model_name),
                                                      abstract_params(model_name))))
    with torch.device("meta"):
        module = spec.module(dtype=torch.float32)
    return carry_specs(spec.to_jax, module.state_dict(), jax_specs)


def carry_specs(to_jax: Callable[[Mapping], Tree], tensors: Mapping[str, torch.Tensor],
                jax_specs: Mapping[str, PartitionSpec]) -> dict[str, PartitionSpec]:
    """Each torch tensor's spec, in torch's dim order, from the spec of the
    JAX leaf it becomes (``jax_specs``: '/'-joined path -> spec). The leaf,
    and the order of its dims, come from ``to_jax`` (a model's converter to
    the JAX tree) applied to a ``meta`` probe of distinct dim sizes. A
    tensor with no JAX leaf (``num_batches_tracked``) replicates."""
    out: dict[str, PartitionSpec] = {}
    for key, t in tensors.items():
        probe = torch.empty(_PROBE_DIMS[: t.dim()], device="meta")
        leaves = tree_paths(to_jax({key: probe}))
        if not leaves:
            out[key] = PartitionSpec()
            continue
        ((path, leaf),) = leaves
        entries: list[Any] = [None] * t.dim()
        for jax_dim, entry in enumerate(jax_specs[path]):
            entries[_PROBE_DIMS.index(leaf.shape[jax_dim])] = entry
        out[key] = PartitionSpec(*entries)
    return out


# ---------------------------------------------------------------------------
# Sharded program construction


class ShardedLinear(nn.Module):
    """A ``Linear`` split over the tensor-parallel positions of one dp group,
    one shard on each position's device.

    - ``mode="out"`` (q, k, v, MLP-in, head): weight ``[out, in]`` split on
      dim 0. Each shard computes its columns (with its slice of the bias)
      and the columns are concatenated in order on the input's device.
    - ``mode="in"`` (attention-out, MLP-out): weight split on dim 1. Each
      shard multiplies its slice of the input features; the partial
      products are summed in shard order on the input's device, and the
      replicated bias is added once, after the sum.

    Computes in ``compute_dtype`` over float32 shards, as ``layers.Linear``."""

    def __init__(self, mode: str, weights: list[torch.Tensor], biases: list[torch.Tensor] | None,
                 bias: torch.Tensor | None, compute_dtype: torch.dtype):
        super().__init__()
        self.mode = mode
        self.weights = weights
        self.biases = biases
        self.bias = bias
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sharded_linear(x, self.mode, self.weights, self.biases, self.bias,
                              self.compute_dtype)


def sharded_linear(x: torch.Tensor, mode: str, weights: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor] | None, bias: torch.Tensor | None,
                   dt: torch.dtype) -> torch.Tensor:
    """``ShardedLinear``'s product: ``mode="out"`` concatenates each shard's
    columns (with its bias slice ``biases[j]``) on the input's device,
    ``mode="in"`` sums the shards' partial products in shard order there
    and adds the replicated ``bias`` once, after the sum."""
    home = x.device
    x = x.to(dt)
    if mode == "out":
        parts = []
        for j, w in enumerate(weights):
            b = None if biases is None else biases[j].to(w.device, dt)
            parts.append(F.linear(x.to(w.device), w.to(dt), b).to(home))
        return torch.cat(parts, dim=-1)
    total = None
    for xj, w in zip(x.split(weights[0].shape[1], dim=-1), weights):
        part = F.linear(xj.to(w.device), w.to(dt)).to(home)
        total = part if total is None else total + part
    return total if bias is None else total + bias.to(dt)


#: ImageNet statistics in [0, 1] units (``dmlc_tpu/parallel/sharding.py``'s).
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class ShardedProgram:
    """A registry model placed at a specific mesh shape: rule-sharded
    weights, one shard per mesh position, and a forward with the batch over
    dp — the next-token argmax for a language model, the top-1 for a
    classifier, the embedding otherwise. A mesh of one device is the
    unsharded reference.

    One process runs every position, as the JAX package's program runs over
    its local mesh: dp group ``i`` (the positions at dp coordinate ``i``)
    runs rows ``i·B/dp …`` through the model's own modules, its replicated
    weights on the group's first device and each split ``Linear`` swapped
    for a ``ShardedLinear`` over the group's positions."""

    def __init__(self, model_name: str, mesh: Mesh, *, dtype: torch.dtype = torch.float32,
                 seed: int = 0) -> None:
        from dmlc_tpu_torch.models.registry import get_model

        self.model_name = model_name
        self.mesh = mesh
        self.dtype = dtype
        self.spec = get_model(model_name)
        self._torch_specs = torch_partition_specs(model_name)
        self.variables: dict[str, ShardedLeaf] = {}
        self._groups: list[tuple[torch.device, nn.Module]] = []
        self.load_variables(self.spec.init_params(seed, dtype=dtype).state_dict())

    @property
    def dp(self) -> int:
        return int(self.mesh.shape.get("dp", 1))

    def load_variables(self, variables: Mapping) -> None:
        """Swap weights (this package's state dict, or the JAX package's
        ``{"params", ...}`` tree), re-sharded under the same rules."""
        from dmlc_tpu_torch.models.convert import variables_from_jax

        if "params" in variables:
            variables = variables_from_jax(self.model_name, variables)
        sd = {k: _as_tensor(v) for k, v in variables.items()}
        want = self._torch_specs
        if set(sd) != set(want):
            raise ValueError(f"variables mismatch: missing {sorted(set(want) - set(sd))[:8]}, "
                             f"unexpected {sorted(set(sd) - set(want))[:8]}")
        shardings = {k: NamedSharding(self.mesh, clamp_spec(want[k], self.mesh, tuple(t.shape)))
                     for k, t in sd.items()}
        shard_fn, _ = make_shard_and_gather_fns(self.mesh, shardings)
        self.variables = shard_fn(sd)
        self._groups = [self._build_group(i) for i in range(self.dp)]

    def _group_positions(self, i: int) -> list[tuple[int, ...]]:
        names = self.mesh.axis_names
        axis = names.index("dp") if "dp" in names else None
        return [pos for pos in np.ndindex(*self.mesh.devices.shape)
                if axis is None or pos[axis] == i]

    def _shard_positions(self, key: str, positions: list[tuple[int, ...]],
                         dim: int) -> list[tuple[int, ...]]:
        """For a leaf split on ``dim``: the first group position holding each
        shard, in shard order."""
        leaf = self.variables[key]
        first: dict[int, tuple[int, ...]] = {}
        f = 1
        for pos in positions:
            k, f = _shard_index(leaf.sharding.spec, self.mesh, pos)[dim]
            first.setdefault(k, pos)
        if sorted(first) != list(range(f)):
            raise NotImplementedError(f"{self.model_name}: {key} is split over the batch axis")
        return [first[k] for k in range(f)]

    def _build_group(self, i: int) -> tuple[torch.device, nn.Module]:
        positions = self._group_positions(i)
        home = positions[0]
        with torch.device("meta"):
            model = self.spec.module(dtype=self.dtype)
        model.eval().requires_grad_(False)
        taken: set[str] = set()
        for name, mod in list(model.named_modules()):
            if isinstance(mod, nn.Linear):
                swapped = self._sharded_linear(name, mod, positions)
                if swapped is not None:
                    parent, _, child = name.rpartition(".")
                    setattr(model.get_submodule(parent), child, swapped)
                    taken.update(k for k in (f"{name}.weight", f"{name}.bias")
                                 if k in self.variables)
        for key, leaf in self.variables.items():
            if key not in taken and any(_entry_axes(e) for e in leaf.sharding.spec):
                raise NotImplementedError(
                    f"{self.model_name}: {key} is split, but only a Linear's weight and bias "
                    f"can run split")
        model.load_state_dict({k: leaf.shards[home] for k, leaf in self.variables.items()
                               if k not in taken}, strict=True, assign=True)
        return self.mesh.devices[home], model

    def _sharded_linear(self, name: str, mod: nn.Linear,
                        positions: list[tuple[int, ...]]) -> ShardedLinear | None:
        wkey, bkey = f"{name}.weight", f"{name}.bias"
        wspec = self.variables[wkey].sharding.spec
        dims = [d for d, e in enumerate(wspec) if _entry_axes(e)]
        if not dims:
            return None
        if len(dims) > 1:
            raise NotImplementedError(f"{self.model_name}: {wkey} is split on both dims")
        dim = dims[0]
        at = self._shard_positions(wkey, positions, dim)
        weights = [self.variables[wkey].shards[p] for p in at]
        dt = getattr(mod, "compute_dtype", self.dtype)
        if mod.bias is None:
            return ShardedLinear("out" if dim == 0 else "in", weights, None, None, dt)
        bleaf = self.variables[bkey]
        bias_split = bool(bleaf.sharding.spec) and bool(_entry_axes(bleaf.sharding.spec[0]))
        if dim == 1:
            if bias_split:
                raise NotImplementedError(f"{self.model_name}: {bkey} is split, but its "
                                          f"weight is split on the input dim")
            return ShardedLinear("in", weights, None, bleaf.shards[positions[0]], dt)
        if bias_split:
            biases = [bleaf.shards[p] for p in self._shard_positions(bkey, positions, 0)]
        else:
            step = weights[0].shape[0]
            biases = [bleaf.shards[p][k * step:(k + 1) * step] for k, p in enumerate(at)]
        return ShardedLinear("out", weights, biases, None, dt)

    def _pad_to_dp(self, batch: np.ndarray) -> tuple[np.ndarray, int]:
        n = batch.shape[0]
        pad = (-n) % self.dp
        if pad:
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)], axis=0)
        return batch, n

    def _output(self, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """The model's own output on one dp group's rows: a language
        model's logits [B, S, V], an image model's [B, C] or [B, D] after
        the reference's normalization (plain ops, in its order)."""
        if self.spec.kind == "lm":
            return model(x.long())
        mean = torch.tensor(_MEAN, dtype=self.dtype, device=x.device) * 255.0
        std = torch.tensor(_STD, dtype=self.dtype, device=x.device) * 255.0
        return model((x.to(self.dtype) - mean) / std)

    def _answer(self, out: torch.Tensor) -> torch.Tensor:
        if self.spec.kind == "lm":
            return torch.argmax(out[:, -1, :], dim=-1).to(torch.int32)
        if self.spec.classifier:
            return torch.argmax(out, dim=-1).to(torch.int32)
        return out

    @torch.inference_mode()
    def _over_dp(self, batch: np.ndarray, fn) -> np.ndarray:
        padded, n = self._pad_to_dp(np.asarray(batch))
        rows = padded.shape[0] // self.dp
        outs = [fn(model, torch.from_numpy(
                    np.ascontiguousarray(padded[i * rows:(i + 1) * rows])).to(home))
                for i, (home, model) in enumerate(self._groups)]
        return np.concatenate([o.cpu().numpy() for o in outs])[:n]

    def run(self, batch: np.ndarray) -> np.ndarray:
        """Forward a host batch (tokens [B, S] int32 for a language model,
        uint8 NHWC for an image model); returns host numpy, padding
        stripped: the next-token argmax, the top-1 (both int32; the first
        of equal values, as ``jnp.argmax``) or the embedding."""
        return self._over_dp(batch, lambda model, x: self._answer(self._output(model, x)))

    def outputs(self, batch: np.ndarray) -> np.ndarray:
        """The model's output rows before ``run``'s argmax (logits for a
        language model or a classifier)."""
        return self._over_dp(batch, self._output)


def tokens_for_prompt(prompt: str, length: int, vocab: int) -> np.ndarray:
    """Deterministic prompt encoding shared by every serving path (cluster
    members, the reference process): pure arithmetic on a crc32 seed, so it
    is stable across processes, PYTHONHASHSEED and platforms."""
    import zlib

    seed = zlib.crc32(prompt.encode("utf-8"))
    return np.asarray([(seed + i * 2654435761) % vocab for i in range(length)], dtype=np.int32)


def encode_prompts(prompts: Iterable[str], length: int, vocab: int) -> np.ndarray:
    return np.stack([tokens_for_prompt(p, length, vocab) for p in prompts])
