"""Pipeline parallelism: GPipe microbatches over a mesh's ``pp`` axis.

Port of ``dmlc_tpu/parallel/pipeline.py``. Each position along ``pp`` holds
one stage's parameters (the stacked parameters' leading axis, one entry a
stage) and activations move stage to stage, one position a tick: the
microbatches fill the pipeline, the steady state keeps every stage busy and
the drain empties it, ``n_micro + n_stages - 1`` ticks in all (the JAX
package's ``_pipeline_local``). Stage 0 injects microbatch ``t`` at tick
``t``, stage s works on microbatch ``t - s``, and the last stage banks
microbatch ``t - (n_stages - 1)``. A stage whose tick holds no microbatch
(the fill and drain bubble) runs nothing; the JAX program computes there on
zeros or on a repeated microbatch and throws the result away.

The mesh is one process over a device list (``parallel/mesh.py``): a
stage's parameters are moved to its position's device by an
autograd-tracked ``Tensor.to``, an activation's hop is a move to the next
position's device, and the last stage's outputs come back to the input's
device, where the JAX program gathers them to every position. With a
``dp`` axis every dp row of the mesh pipelines its own slice of each
microbatch. ``stage_fn(params, x)`` is a plain torch function, and
gradients flow through ``pipeline_apply`` by autograd.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from dmlc_tpu_torch.parallel.mesh import Mesh

Tree = Any


def _tree_map(fn: Callable, *trees: Tree) -> Tree:
    """``fn`` over the leaves of parallel trees of tuples, lists and dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params: list) -> Tree:
    """Per-stage parameter trees -> one tree whose leaves carry a new
    leading stage axis; ``pipeline_apply`` gives entry s to stage s."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def _run_pipeline(stage_fn: Callable, stage_params: list, xm: torch.Tensor,
                  devices: list[torch.device]) -> list[torch.Tensor]:
    """One pipeline (one dp row of the mesh): ``xm`` [n_micro, mb, ...];
    returns the last stage's output of each microbatch."""
    n_stages, n_micro = len(devices), xm.shape[0]
    recv: list[torch.Tensor | None] = [None] * n_stages
    banked: list[torch.Tensor | None] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        outs: list[torch.Tensor | None] = [None] * n_stages
        for s in range(n_stages):
            micro = t - s
            if not 0 <= micro < n_micro:
                continue  # the bubble
            inp = xm[micro].to(devices[0]) if s == 0 else recv[s]
            out = stage_fn(stage_params[s], inp)
            if tuple(out.shape) != tuple(inp.shape):
                raise ValueError("pipeline stages must preserve activation shape "
                                 f"(got {tuple(out.shape)} from {tuple(inp.shape)})")
            outs[s] = out
            if s == n_stages - 1:
                banked[micro] = out
        # Activations rotate one stage a tick.
        recv = [None] + [None if o is None else o.to(devices[s + 1])
                         for s, o in enumerate(outs[:-1])]
    return banked  # type: ignore[return-value]


def pipeline_apply(stage_fn: Callable, stacked_params: Tree, x: torch.Tensor, mesh: Mesh, *,
                   n_micro: int, axis_name: str = "pp", batch_axis: str | None = "dp"
                   ) -> torch.Tensor:
    """Run ``x`` [batch, ...] through the pipeline: ``stage_fn(params,
    activation[mb, ...]) -> activation[mb, ...]``, ``stacked_params`` a
    tree whose leaves lead with the stage axis, of the size of the mesh's
    ``axis_name``. The batch splits into ``n_micro`` microbatches, and each
    microbatch over the mesh's ``batch_axis`` when the mesh has it. Returns
    [batch, ...] on ``x``'s device."""
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible into {n_micro} microbatches")
    mb = batch // n_micro
    use_dp = batch_axis is not None and batch_axis in mesh.axis_names
    n_dp = mesh.shape[batch_axis] if use_dp else 1
    if use_dp and mb % n_dp:
        raise ValueError(f"microbatch {mb} not divisible over {batch_axis}={n_dp}")
    n_stages = mesh.shape[axis_name]
    leaves: list[torch.Tensor] = []
    _tree_map(leaves.append, stacked_params)
    if any(a.shape[0] != n_stages for a in leaves):
        raise ValueError(f"stacked params lead with {sorted({a.shape[0] for a in leaves})} "
                         f"stages, the mesh has {axis_name}={n_stages}")
    xm = x.reshape(n_micro, mb, *x.shape[1:])
    part = mb // n_dp
    k = mesh.axis_names.index(axis_name)
    rows = []
    for d in range(n_dp):
        # This dp row's pipeline; other axes of the mesh hold replicas.
        base = [0] * len(mesh.axis_names)
        if use_dp:
            base[mesh.axis_names.index(batch_axis)] = d
        devices = [mesh.devices[(*base[:k], s, *base[k + 1:])] for s in range(n_stages)]
        params = [_tree_map(lambda a, s=s: a[s].to(devices[s]), stacked_params)
                  for s in range(n_stages)]
        banked = _run_pipeline(stage_fn, params, xm[:, d * part:(d + 1) * part], devices)
        rows.append(torch.stack([o.to(x.device) for o in banked]))
    out = torch.cat(rows, dim=1)  # [n_micro, mb, ...], dp rows in order
    return out.reshape(batch, *out.shape[2:])


def reference_apply(stage_fn: Callable, per_stage_params: list, x: torch.Tensor) -> torch.Tensor:
    """The stages in turn on one device: the reference for parity tests."""
    for p in per_stage_params:
        x = stage_fn(p, x)
    return x
