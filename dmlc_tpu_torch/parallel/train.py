"""The train step: on one device, or over a dp x tp mesh.

Counterpart of ``dmlc_tpu/parallel/train.py``. Works for both families:
BatchNorm CNNs (ResNet, whose running statistics are buffers of the
model) and transformers (ViT, CLIP), and ``lm_train_step`` trains the
causal LM (a sequence-parallel LM cuts its own activations over its mesh,
``parallel/sp_transformer.py``).

Without a mesh, ``make_train_step`` drives one model on one device. With
``mesh=``, it follows the JAX package's SPMD step over a ``{dp, tp}``
mesh:

- the batch splits over ``dp``: dp coordinate ``i`` runs rows
  ``i·B/dp …`` on its positions, and the loss is the mean over the global
  batch;
- the Megatron leaves (``mesh.param_spec``: attention q/k/v and MLP-in
  split their output features, attention-out and MLP-out their input
  features, the head its classes) split over ``tp``. Each split ``Linear``
  becomes a ``TrainShardedLinear`` (``sharding.ShardedLinear``'s product)
  whose tp shards are parameters of their own, on their positions'
  devices, so that AdamW keeps each shard's moments beside it. That is the
  sharded optimizer state: AdamW is elementwise, so the shards step as the
  whole leaf would. ``state_shardings`` gives every leaf's spec in the JAX
  tree's terms;
- each dp group computes with the parameters as its positions' devices
  hold them (an autograd-tracked ``Tensor.to``, no copy where the device
  is the parameter's own), so the gradients of every group sum into the
  parameters, as JAX's SPMD gradient does. Mesh axes other than dp and tp
  replicate: their index-0 positions compute;
- a BatchNorm model normalizes with the statistics of the whole batch, as
  the JAX program does: the dp groups of one process run as one batch on
  the first group's positions, and across processes the statistics are
  summed by a differentiable ``all_reduce`` (``ProcessBatchNorm2d``).
  Normalizing each dp group's rows alone would train another model;
- across processes (a mesh over the default ``torch.distributed`` group,
  ``parallel/multihost.py``), each process runs its own dp coordinates on
  its own rows, sums the gradients with one ``all_reduce`` and returns the
  loss and accuracy of the whole batch, the same float on every rank.

optax's AdamW and torch's are written differently but are the same algebra
(bias-corrected moments, decoupled weight decay on every parameter, applied
to the parameter before the step). Every hyperparameter is set explicitly:
optax's default decay is 1e-4 on every leaf, torch's is 1e-2.

The entry points (``create_train_state``, and through it ``make_train_step``
and ``TrainingDriver``; ``lm_train_step``) run on the CUDA device unless the
caller passes ``device="cpu"``, and raise without a card
(``utils/device.resolve_device``). A model whose tensors lie elsewhere than
the resolved device is refused.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from dmlc_tpu_torch.models.layers import BatchNorm2d
from dmlc_tpu_torch.parallel.mesh import Mesh, param_spec, process_dp_coords, process_index_count
from dmlc_tpu_torch.parallel.sharding import (
    NamedSharding,
    PartitionSpec,
    carry_specs,
    map_tree,
    sharded_linear,
    tree_paths,
)
from dmlc_tpu_torch.utils.device import resolve_device

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
#: The AdamW constructor's keywords, as its ``param_groups`` keep them.
_ADAMW_KEYS = ("lr", "betas", "eps", "weight_decay", "amsgrad", "maximize", "foreach",
               "capturable", "differentiable", "fused")


@dataclass
class TrainState:
    """The step counter, the model (its parameters and, for BatchNorm
    models, its running statistics), the optimizer (its moments) and the
    device they live on. ``make_train_step(mesh=)`` places the state on
    the mesh: ``mesh`` and ``layout`` are then set, ``model`` holds the tp
    shards as parameters of their own and ``device`` is the first local dp
    group's first position."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    device: torch.device
    mesh: Mesh | None = None
    layout: "MeshLayout | None" = None


def default_optimizer(params: Iterable[torch.Tensor], lr: float = 1e-3,
                      weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay)``: betas (0.9, 0.999),
    eps 1e-8, decay on every parameter."""
    return torch.optim.AdamW(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                             weight_decay=weight_decay)


def require_on_device(model: nn.Module, device: torch.device, what: str) -> None:
    """Raise ``ValueError`` unless every parameter and buffer of ``model``
    lies on ``device``."""
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not on {device}")


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer | None = None, *,
                       device: str | torch.device | None = None) -> TrainState:
    """Step 0 over ``model``, moved to ``device`` (the CUDA device unless
    ``"cpu"`` is named), with ``default_optimizer`` unless one is given. A
    given optimizer must be over ``model``'s parameters and not have
    stepped yet: the move keeps its parameter objects but not its moments."""
    dev = resolve_device(device)
    model.to(dev)
    if optimizer is None:
        optimizer = default_optimizer(model.parameters())
    return TrainState(step=0, model=model, optimizer=optimizer, device=dev)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, in the logits' dtype
    (``optax.softmax_cross_entropy_with_integer_labels(...).mean()``).
    Leading axes are flattened."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def make_train_step(state: TrainState, *, remat: bool = False, grad_accum: int = 1,
                    mesh: Mesh | None = None, dp_axis: str = "dp", tp_axis: str = "tp"
                    ) -> tuple[TrainState, Callable]:
    """Returns ``(state, step_fn)``; ``step_fn(state, images, labels) ->
    (state, {"loss", "accuracy"})`` runs one update in place (the state's
    model and optimizer) and returns the state with its step advanced. The
    metrics are float32 scalar tensors on the model's device.

    With ``mesh``, the state is first placed on the mesh (``shard_state``)
    and the step runs over it (the module docstring); ``images`` and
    ``labels`` are then this process's rows: the whole batch in one
    process, process ``p``'s contiguous share of it (every process passing
    as many rows) over several.

    ``remat`` recomputes the forward during the backward
    (``torch.utils.checkpoint``) instead of keeping its activations. The
    recomputation would move BatchNorm's running statistics a second
    time, so the buffers as the first forward left them are put back after
    the backward.

    ``grad_accum`` > 1 splits the batch into that many microbatches and
    runs one update on the mean of their gradients. The batch must split
    evenly; BatchNorm statistics move in microbatch order.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if mesh is not None:
        state = shard_state(state, mesh, dp_axis=dp_axis, tp_axis=tp_axis)
        return state, _mesh_step(state, remat, grad_accum)
    if state.layout is not None:
        raise ValueError("make_train_step: the state is placed on a mesh; pass mesh=")
    require_on_device(state.model, state.device, "make_train_step")

    def forward(model: nn.Module, images: torch.Tensor, labels: torch.Tensor):
        logits = model(images)
        return cross_entropy(logits, labels), logits

    def micro(model: nn.Module, images: torch.Tensor, labels: torch.Tensor, weight: float):
        if remat:
            loss, logits = checkpoint(forward, model, images, labels, use_reentrant=False)
            saved = [b.clone() for b in model.buffers()]
            (loss * weight).backward()
            with torch.no_grad():
                for b, s in zip(model.buffers(), saved):
                    b.copy_(s)
        else:
            loss, logits = forward(model, images, labels)
            (loss * weight).backward()
        acc = (logits.detach().argmax(dim=-1) == labels).to(torch.float32).mean()
        return loss.detach().to(torch.float32), acc

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model, opt = state.model, state.optimizer
        images, labels = images.to(state.device), labels.to(state.device)
        model.train()
        opt.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss, acc = micro(model, images, labels, 1.0)
        else:
            if images.shape[0] % grad_accum:
                raise ValueError(
                    f"batch {images.shape[0]} not divisible by "
                    f"grad_accum={grad_accum} x dp=1 (each microbatch "
                    f"must still shard evenly over the dp axis)"
                )
            parts = [micro(model, x, y, 1.0 / grad_accum)
                     for x, y in zip(images.chunk(grad_accum), labels.chunk(grad_accum))]
            loss = torch.stack([p[0] for p in parts]).mean()
            acc = torch.stack([p[1] for p in parts]).mean()
        opt.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": acc}

    return state, step_fn


def lm_loss(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of a causal LM over ``tokens`` [B, S+1]:
    inputs ``tokens[:, :-1]``, targets ``tokens[:, 1:]``, logits cast to
    float32 first (``bench.py``'s LM train leg)."""
    logits = model(tokens[:, :-1])
    return cross_entropy(logits.to(torch.float32), tokens[:, 1:])


def lm_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, tokens: torch.Tensor,
                  *, device: str | torch.device | None = None) -> torch.Tensor:
    """One AdamW update of ``model`` on ``lm_loss``; returns the loss
    before the update (a float32 scalar tensor, not synchronized). The
    model must lie on ``device`` (the CUDA device unless ``"cpu"`` is
    named); ``tokens`` are moved there."""
    dev = resolve_device(device)
    require_on_device(model, dev, "lm_train_step")
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens.to(dev))
    loss.backward()
    optimizer.step()
    return loss.detach()


# ---------------------------------------------------------------------------
# The dp x tp step over a mesh
# ---------------------------------------------------------------------------


class TrainShardedLinear(nn.Module):
    """A ``Linear`` split over the tp positions, for training:
    ``sharding.ShardedLinear``'s product over shards that are parameters
    of their own (``weight_shards``, and ``bias_shards`` where the bias
    splits with the output features), so that an optimizer keeps each
    shard's state beside it. A bias that does not split (attention-out,
    MLP-out, the head) is one replicated parameter, ``bias``; under
    ``mode="out"`` each shard adds its slice of it."""

    def __init__(self, mode: str, weights: list[nn.Parameter],
                 biases: list[nn.Parameter] | None, bias: nn.Parameter | None,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.mode = mode
        self.compute_dtype = compute_dtype
        self.weight_shards = nn.ParameterList(weights)
        self.bias_shards = None if biases is None else nn.ParameterList(biases)
        self.bias = bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = list(self.weight_shards)
        biases = None if self.bias_shards is None else list(self.bias_shards)
        bias = self.bias
        if self.mode == "out" and bias is not None:
            step = weights[0].shape[0]
            biases = [bias[j * step:(j + 1) * step] for j in range(len(weights))]
            bias = None
        return sharded_linear(x, self.mode, weights, biases, bias, self.compute_dtype)


class ProcessBatchNorm2d(BatchNorm2d):
    """``BatchNorm2d`` whose training statistics are those of every
    process's rows: the per-channel sums and the sums of squared deviations
    go through a differentiable ``all_reduce`` over the default group, so
    the gradient reaches every process's rows through the shared mean and
    variance (as the JAX program's global-batch statistics do). The running
    statistics move toward the global mean and biased variance, alike on
    every rank."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        xf = x.to(torch.float32)
        count = torch.full((1,), float(x.numel() // c), device=x.device)
        sums = all_reduce(torch.cat([xf.sum(dim=(0, 2, 3)), count]))
        n = sums[c]
        mean = sums[:c] / n
        centered = xf - mean.view(1, c, 1, 1)
        var = all_reduce(centered.square().sum(dim=(0, 2, 3))) / n
        y = (centered * torch.rsqrt(var + self.eps).view(1, c, 1, 1)
             * self.weight.view(1, c, 1, 1) + self.bias.view(1, c, 1, 1))
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
            self.num_batches_tracked += 1
        return y.to(x.dtype)


@dataclass
class DpGroup:
    """One dp coordinate of this process: its tp positions' devices, in tp
    order (one device without a tp axis); ``home`` holds its rows and its
    replicated parameters."""

    coord: int
    devices: list[torch.device]

    @property
    def home(self) -> torch.device:
        return self.devices[0]


@dataclass
class MeshLayout:
    """How a train state lies on a mesh: this process's dp groups, each
    whole parameter's split (dim and the names of its shards in the placed
    model) and the whole state dict's keys and shapes, from which
    ``state_dicts`` gathers and ``load_state_dicts`` re-shards."""

    mesh: Mesh
    dp_axis: str
    tp_axis: str
    world: int
    groups: list[DpGroup]
    keys: list[str]
    param_names: list[str]
    shapes: dict[str, tuple[int, ...]]
    split: dict[str, tuple[int, list[str]]]
    origin: dict[str, tuple[str, int | None]]
    to_jax: Callable[[Mapping], dict]
    has_bn: bool
    allreduce_s: list[float] = field(default_factory=list)

    @property
    def dp(self) -> int:
        return self.mesh.shape.get(self.dp_axis, 1)

    @property
    def tp(self) -> int:
        return self.mesh.shape.get(self.tp_axis, 1)

    def row_span(self, rows: int) -> tuple[int, int]:
        """This process's rows of a global batch of ``rows``."""
        step = rows // self.dp
        return self.groups[0].coord * step, (self.groups[-1].coord + 1) * step

    def device_of(self, name: str, group: DpGroup) -> torch.device:
        """Where ``group`` computes with the placed model's tensor ``name``."""
        j = self.origin.get(name, (name, None))[1]
        return group.home if j is None else group.devices[j]


def _dp_groups(mesh: Mesh, dp_axis: str, tp_axis: str, coords: list[int]) -> list[DpGroup]:
    groups = []
    for c in coords:
        index = tuple(c if a == dp_axis else slice(None) if a == tp_axis else 0
                      for a in mesh.axis_names)
        devs = mesh.devices[index]
        groups.append(DpGroup(c, list(devs.flat) if isinstance(devs, np.ndarray) else [devs]))
    return groups


def _meta_state(model: nn.Module) -> dict[str, torch.Tensor]:
    return {k: torch.empty(t.shape, device="meta") for k, t in model.state_dict().items()}


def _jax_specs(tree: Mapping, mesh: Mesh, tp_axis: str) -> dict[str, PartitionSpec]:
    """'/'-joined path of every leaf of a JAX variables tree -> its spec
    under ``mesh``: ``param_spec`` when the mesh has the tp axis, else
    replicated."""
    has_tp = tp_axis in mesh.axis_names
    return {path: param_spec(tuple(path.split("/")), leaf, tp_axis) if has_tp else PartitionSpec()
            for path, leaf in tree_paths(tree)}


def state_shardings(mesh: Mesh, state: TrainState, tp_axis: str = "tp") -> dict:
    """The spec of every leaf of the train state, in the JAX tree's terms:
    ``{"step", "params", "mu", "nu", "batch_stats"}``, each a tree of
    ``NamedSharding`` over the JAX variables tree's paths (``batch_stats``
    None for a model without BatchNorm). AdamW's moments mirror the
    parameters, so the one path-based rule, ``mesh.param_spec``, covers
    ``params``, ``mu`` and ``nu`` alike; the step and ``batch_stats``
    replicate. A placed state gives the specs of its whole leaves."""
    from dmlc_tpu_torch.models.convert import to_jax_for

    if state.layout is not None:
        meta = {k: torch.empty(shape, device="meta") for k, shape in state.layout.shapes.items()}
        to_jax = state.layout.to_jax
    else:
        meta, to_jax = _meta_state(state.model), to_jax_for(state.model)
    tree = to_jax(meta)
    specs = _jax_specs(tree, mesh, tp_axis)

    def collection(name: str):
        if name not in tree:
            return None
        return map_tree(lambda path, leaf: NamedSharding(mesh, specs[f"{name}/{path}"]),
                        tree[name])

    params = collection("params")
    return {"step": NamedSharding(mesh, PartitionSpec()), "params": params,
            "mu": collection("params"), "nu": collection("params"),
            "batch_stats": collection("batch_stats")}


def _split_linears(model: nn.Module, tp: int, tp_axis: str,
                   torch_specs: Mapping[str, PartitionSpec]) -> dict[str, tuple[int, bool]]:
    """The Linear modules the tp axis splits: module name -> (the weight's
    split dim, whether the bias splits with it). Refuses a split leaf that
    is not a Linear's weight or bias, and a split that tp does not
    divide."""
    split = {k: [d for d, e in enumerate(spec) if e is not None]
             for k, spec in torch_specs.items()}
    split = {k: dims for k, dims in split.items() if dims}
    out: dict[str, tuple[int, bool]] = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Linear) or f"{name}.weight" not in split:
            continue
        dims = split.pop(f"{name}.weight")
        bias_split = split.pop(f"{name}.bias", None) is not None
        if len(dims) > 1 or (bias_split and dims != [0]):
            raise NotImplementedError(f"make_train_step: {name} is split on its input dim "
                                      "and its bias too, or on both dims")
        if mod.weight.shape[dims[0]] % tp:
            raise ValueError(f"{name}.weight {tuple(mod.weight.shape)}: dim {dims[0]} does not "
                             f"split {tp} ways over {tp_axis!r}")
        out[name] = (dims[0], bias_split)
    if split:
        raise NotImplementedError(f"make_train_step: {sorted(split)[0]} is split over "
                                  f"{tp_axis!r}, but only a Linear's weight and bias can run split")
    return out


def _shards(t: torch.Tensor, dim: int, devices: list[torch.device]) -> list[nn.Parameter]:
    """``t`` cut into ``len(devices)`` parts along ``dim``, each a parameter
    of its own on its device."""
    return [nn.Parameter(part.detach().to(dev, copy=True, memory_format=torch.contiguous_format))
            for part, dev in zip(t.chunk(len(devices), dim=dim), devices)]


def shard_state(state: TrainState, mesh: Mesh, *, dp_axis: str = "dp",
                tp_axis: str = "tp") -> TrainState:
    """Place a one-device train state on ``mesh`` in place: each Linear that
    ``mesh.param_spec`` splits over ``tp_axis`` becomes a
    ``TrainShardedLinear`` whose shards lie on the first local dp group's
    tp positions, the rest of the model on that group's first position, and
    the optimizer (AdamW) is rebuilt over the placed parameters with its
    moments split alike. Over several processes the BatchNorm layers
    become ``ProcessBatchNorm2d``. Refuses a mesh whose dp axis does not
    partition the batch by process (``mesh.process_dp_coords``), or one
    that does not span the default group's processes."""
    from dmlc_tpu_torch.models.convert import to_jax_for

    if state.layout is not None:
        if state.mesh is mesh and state.layout.dp_axis == dp_axis \
                and state.layout.tp_axis == tp_axis:
            return state
        raise ValueError("shard_state: the state is already placed on another mesh")
    opt = state.optimizer
    if type(opt) is not torch.optim.AdamW or len(opt.param_groups) != 1:
        raise TypeError("make_train_step(mesh=) shards the moments of a torch.optim.AdamW "
                        "with one parameter group")
    rank, world = process_index_count()
    if mesh.process_count != world:
        raise ValueError(f"the mesh spans {mesh.process_count} processes, the default group "
                         f"has {world}")
    model = state.model
    param_names = [n for n, _ in model.named_parameters()]
    if len(param_names) != len(opt.param_groups[0]["params"]):
        raise ValueError("the optimizer is not over every parameter of the model")
    whole_opt = opt.state_dict()
    meta = _meta_state(model)
    to_jax = to_jax_for(model)
    torch_specs = carry_specs(to_jax, meta, _jax_specs(to_jax(meta), mesh, tp_axis))
    tp = mesh.shape.get(tp_axis, 1)
    linears = _split_linears(model, tp, tp_axis, torch_specs)
    groups = _dp_groups(mesh, dp_axis, tp_axis, process_dp_coords(mesh, dp_axis, rank))
    first = groups[0]
    model.to(first.home)
    split: dict[str, tuple[int, list[str]]] = {}
    origin: dict[str, tuple[str, int | None]] = {}
    for name, (dim, bias_split) in linears.items():
        lin = model.get_submodule(name)
        weights = _shards(lin.weight, dim, first.devices)
        biases = _shards(lin.bias, 0, first.devices) if bias_split else None
        bias = lin.bias if lin.bias is not None and not bias_split else None
        placed = TrainShardedLinear("out" if dim == 0 else "in", weights, biases, bias,
                                    getattr(lin, "compute_dtype", lin.weight.dtype))
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, placed)
        leaves = [("weight", dim, "weight_shards")] + [("bias", 0, "bias_shards")] * bias_split
        for leaf, d, field_name in leaves:
            names = [f"{name}.{field_name}.{j}" for j in range(tp)]
            split[f"{name}.{leaf}"] = (d, names)
            origin.update({n: (f"{name}.{leaf}", j) for j, n in enumerate(names)})
    has_bn = any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in model.modules())
    if world > 1:
        for m in model.modules():
            if type(m) is BatchNorm2d:
                m.__class__ = ProcessBatchNorm2d
    hyper = opt.param_groups[0]
    state.optimizer = torch.optim.AdamW(model.parameters(),
                                        **{k: hyper[k] for k in _ADAMW_KEYS if k in hyper})
    state.layout = MeshLayout(mesh, dp_axis, tp_axis, world, groups, list(meta),
                              param_names, {k: tuple(t.shape) for k, t in meta.items()},
                              split, origin, to_jax, has_bn)
    state.mesh, state.device = mesh, first.home
    _load_optimizer(state, whole_opt)
    return state


def state_dicts(state: TrainState) -> tuple[dict, dict]:
    """``(model, optimizer)`` state dicts of the whole state, as a
    one-device state of the same model has them: a placed state's shards
    (parameters and AdamW moments) concatenated back into whole leaves,
    under the one-device keys and parameter indices."""
    model, opt, layout = state.model, state.optimizer, state.layout
    if layout is None:
        return model.state_dict(), opt.state_dict()
    home = layout.groups[0].home
    placed = model.state_dict()
    sd = {}
    for key in layout.keys:
        if key in layout.split:
            dim, names = layout.split[key]
            sd[key] = torch.cat([placed[n].to(home) for n in names], dim=dim)
        else:
            sd[key] = placed[key]
    osd = opt.state_dict()
    index = {n: i for i, (n, _) in enumerate(model.named_parameters())}
    whole: dict[int, dict] = {}
    for wi, name in enumerate(layout.param_names):
        if name in layout.split:
            dim, names = layout.split[name]
            parts = [osd["state"].get(index[n]) for n in names]
            if parts[0] is None:
                continue
            whole[wi] = {k: torch.cat([p[k].to(home) for p in parts], dim=dim) if v.dim() else v
                         for k, v in parts[0].items()}
        elif index[name] in osd["state"]:
            whole[wi] = osd["state"][index[name]]
    group = {k: v for k, v in osd["param_groups"][0].items() if k != "params"}
    return sd, {"state": whole,
                "param_groups": [{**group, "params": list(range(len(layout.param_names)))}]}


def load_state_dicts(state: TrainState, model_sd: Mapping, optimizer_sd: Mapping) -> TrainState:
    """Load whole state dicts (``state_dicts``' form) into ``state``: a
    one-device state loads them as they are, a placed state splits them
    into its shards."""
    layout = state.layout
    if layout is None:
        state.model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(optimizer_sd)
        return state
    if set(model_sd) != set(layout.keys):
        raise ValueError(f"state dict mismatch: missing {sorted(set(layout.keys) - set(model_sd))[:8]}, "
                         f"unexpected {sorted(set(model_sd) - set(layout.keys))[:8]}")
    placed = dict(state.model.named_parameters()) | dict(state.model.named_buffers())
    with torch.no_grad():
        for key, value in model_sd.items():
            if tuple(value.shape) != layout.shapes[key]:
                raise ValueError(f"{key}: shape {tuple(value.shape)}, expected {layout.shapes[key]}")
            if key in layout.split:
                dim, names = layout.split[key]
                for n, part in zip(names, value.chunk(layout.tp, dim=dim)):
                    placed[n].copy_(part)
            else:
                placed[key].copy_(value)
    _load_optimizer(state, optimizer_sd)
    return state


def _load_optimizer(state: TrainState, whole: Mapping) -> None:
    """Split a whole optimizer state dict into the placed optimizer."""
    layout = state.layout
    wi = {n: i for i, n in enumerate(layout.param_names)}
    moments = {int(k): v for k, v in whole["state"].items()}
    placed: dict[int, dict] = {}
    names = [n for n, _ in state.model.named_parameters()]
    for k, name in enumerate(names):
        wname, j = layout.origin.get(name, (name, None))
        st = moments.get(wi[wname])
        if st is None:
            continue
        if j is not None:
            dim = layout.split[wname][0]
            st = {key: v.chunk(layout.tp, dim=dim)[j].clone() if v.dim() else v.clone()
                  for key, v in st.items()}
        placed[k] = st
    group = {k: v for k, v in whole["param_groups"][0].items() if k != "params"}
    state.optimizer.load_state_dict({"state": placed,
                                     "param_groups": [{**group, "params": list(range(len(names)))}]})


def position_counts(state: TrainState) -> dict:
    """What one tp position holds of a placed state: its parameter tensors
    (the replicated ones and its shard of each split leaf), their elements
    and its AdamW moment tensors; and the totals over the process."""
    layout, opt = state.layout, state.optimizer
    per = {"param_tensors": 0, "param_elements": 0, "moment_tensors": 0}
    total = dict(per)
    for name, p in state.model.named_parameters():
        moments = sum(1 for k in ("exp_avg", "exp_avg_sq") if k in opt.state.get(p, {}))
        held = layout.origin.get(name, (name, None))[1] in (None, 0)
        for into in (total, per) if held else (total,):
            into["param_tensors"] += 1
            into["param_elements"] += p.numel()
            into["moment_tensors"] += moments
    return {"per_position": per, "process_total": total, "whole_leaves": len(layout.param_names),
            "tp": layout.tp, "dp": layout.dp}


def _gather_rows(t: torch.Tensor, world: int) -> torch.Tensor:
    """Every process's rows of ``t``, rank 0's first. Gloo gathers host
    tensors only, so a CUDA tensor is staged through a pinned host buffer
    under gloo."""
    import torch.distributed as dist

    staged = t
    if t.is_cuda and dist.get_backend() == "gloo":
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        staged.copy_(t)
    parts = [torch.empty_like(staged) for _ in range(world)]
    dist.all_gather(parts, staged)
    return torch.cat(parts).to(t.device)


def _all_reduce_grads(model: nn.Module) -> None:
    """Sum every parameter's gradient over the default group: one
    ``all_reduce`` of a flat buffer for each (device, dtype)."""
    import torch.distributed as dist

    buckets: dict[tuple, list[nn.Parameter]] = {}
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        buckets.setdefault((p.device, p.dtype), []).append(p)
    for params in buckets.values():
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat)
        offset = 0
        for p in params:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
            offset += p.numel()


def _mesh_step(state: TrainState, remat: bool, grad_accum: int) -> Callable:
    """The step over a placed state (``make_train_step``'s ``step_fn``)."""
    layout, model, opt = state.layout, state.model, state.optimizer
    groups, world, dp = layout.groups, layout.world, layout.dp
    home = groups[0].home

    def forward(group: DpGroup, x: torch.Tensor) -> torch.Tensor:
        moved = {}
        for name, t in (*model.named_parameters(), *model.named_buffers()):
            dev = layout.device_of(name, group)
            if t.device != dev:
                moved[name] = t.to(dev)
        return functional_call(model, moved, (x,)) if moved else model(x)

    def run(group: DpGroup, x: torch.Tensor, y: torch.Tensor):
        def body(x: torch.Tensor, y: torch.Tensor):
            logits = forward(group, x)
            return cross_entropy(logits, y), logits

        if remat:
            return checkpoint(body, x, y, use_reentrant=False)
        return body(x, y)

    def micro(xs: torch.Tensor, ys: torch.Tensor, weight: float):
        """One microbatch: this process's rows ``xs`` of it, split over its
        dp groups (one batch for a BatchNorm model); returns this
        process's shares of the microbatch's mean loss and accuracy."""
        total = xs.shape[0] * world
        if layout.has_bn:
            parts = [(groups[0], xs, ys)]
        else:
            r = xs.shape[0] // len(groups)
            parts = [(g, xs[i * r:(i + 1) * r], ys[i * r:(i + 1) * r])
                     for i, g in enumerate(groups)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=home)
        acc_sum = torch.zeros((), dtype=torch.float32, device=home)
        for group, x, y in parts:
            x, y = x.to(group.home), y.to(group.home)
            loss, logits = run(group, x, y)
            saved = [b.clone() for b in model.buffers()] if remat else None
            share = x.shape[0] / total
            (loss * (share * weight)).backward()
            if saved is not None:  # the recomputation moved BatchNorm's statistics again
                with torch.no_grad():
                    for b, s in zip(model.buffers(), saved):
                        b.copy_(s)
            acc = (logits.detach().argmax(dim=-1) == y).to(torch.float32).mean()
            loss_sum += (loss.detach().to(torch.float32) * share).to(home)
            acc_sum += (acc * share).to(home)
        return loss_sum, acc_sum

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model.train()
        opt.zero_grad(set_to_none=True)
        rows = images.shape[0] * world
        if rows % dp:
            raise ValueError(f"batch {rows} not divisible by dp={dp}")
        if grad_accum == 1:
            batches = [(images, labels)]
        else:
            if rows % (grad_accum * dp):
                raise ValueError(
                    f"batch {rows} not divisible by "
                    f"grad_accum={grad_accum} x dp={dp} (each microbatch "
                    f"must still shard evenly over the dp axis)"
                )
            if world > 1:
                images, labels = _gather_rows(images, world), _gather_rows(labels, world)
            m = rows // grad_accum
            lo, hi = layout.row_span(m)
            batches = [(images[k * m + lo:k * m + hi], labels[k * m + lo:k * m + hi])
                       for k in range(grad_accum)]
        loss = torch.zeros((), dtype=torch.float32, device=home)
        acc = torch.zeros((), dtype=torch.float32, device=home)
        for xs, ys in batches:
            mb_loss, mb_acc = micro(xs, ys.long(), 1.0 / grad_accum)
            loss, acc = loss + mb_loss, acc + mb_acc
        loss, acc = loss / grad_accum, acc / grad_accum
        if world > 1:
            import torch.distributed as dist

            if home.type == "cuda":
                torch.cuda.synchronize(home)
            t = time.perf_counter()
            _all_reduce_grads(model)
            if home.type == "cuda":
                torch.cuda.synchronize(home)
            layout.allreduce_s.append(time.perf_counter() - t)
            both = torch.stack([loss, acc])
            dist.all_reduce(both)
            loss, acc = both[0], both[1]
        opt.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": acc}

    return step_fn
