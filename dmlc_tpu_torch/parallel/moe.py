"""Expert parallelism: a Mixture-of-Experts MLP whose experts are cut over a
mesh's ``ep`` axis.

Port of ``dmlc_tpu/parallel/moe.py`` (the Mesh-TensorFlow/GShard
formulation). Routing makes dense one-hot ``dispatch`` and gate-weighted
``combine`` tensors [T, E, C]; the experts' compute is one batched product
over a leading expert axis. Each expert takes at most ``capacity =
max(1, int(capacity_factor · k · T / E))`` tokens a batch; a token past
its expert's capacity passes through the residual only, so shapes stay
fixed whatever the routing.

Under a mesh the token -> expert product's [E, C, D] buffers are cut over
the positions: E over ``ep`` and C over ``dp`` when the mesh has them
(the JAX program's all_to_all), each position runs its experts' FFN with
its slice of ``w_in``/``w_out`` moved to its device by an autograd-tracked
``Tensor.to``, and the outputs are joined for the expert -> token combine.
Routing is global, as in the JAX program, so the dispatch, the combine
and the dropped tokens do not depend on the mesh. ``moe_param_shardings``
and ``shard_moe_params`` place each ``ep`` position's slice of the expert
weights, as the JAX functions of the same names do.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmlc_tpu_torch.parallel.mesh import Mesh, join_positions, split_to_positions
from dmlc_tpu_torch.parallel.sharding import (
    NamedSharding,
    PartitionSpec as P,
    map_tree,
    clamp_spec,
    shard_leaf,
    tree_paths,
)


def _one_hot(index: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: all zeros for an index outside [0, n)."""
    inside = (index >= 0) & (index < n)
    return F.one_hot(index.clamp(0, n - 1), n).to(dtype) * inside[..., None].to(dtype)


def _queue(mask: torch.Tensor, capacity: int, offset: torch.Tensor | float = 0.0):
    """Each token's slot in its expert's queue (cumulative count, behind
    ``offset`` earlier entries) -> the one-hot dispatch [T, E, C] of the
    tokens within capacity."""
    pos = (torch.cumsum(mask, dim=0) + offset) * mask - 1.0  # [T, E], -1 elsewhere
    kept = (pos >= 0) & (pos < capacity)
    pos_oh = _one_hot(pos.amax(dim=-1).to(torch.int64), capacity, mask.dtype)  # [T, C]
    return mask[:, :, None] * pos_oh[:, None, :] * kept.amax(dim=-1).to(mask.dtype)[:, None, None]


def top1_routing(logits: torch.Tensor, capacity: int):
    """GShard top-1 routing with per-expert capacity: logits [T, E] ->
    (dispatch [T, E, C] one-hot, combine [T, E, C] gate-weighted, the
    Switch load-balancing aux loss)."""
    e = logits.shape[-1]
    gates = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(gates.argmax(dim=-1), e).to(logits.dtype)
    dispatch = _queue(onehot, capacity)
    combine = dispatch * (gates * onehot).sum(-1)[:, None, None]
    aux = (onehot.mean(dim=0) * gates.mean(dim=0)).sum() * e
    return dispatch, combine, aux


def top2_routing(logits: torch.Tensor, capacity: int):
    """GShard top-2 routing: each token goes to its two highest-gate
    experts, gates renormalized over the pair; second choices queue behind
    every first choice at the same expert. Returns (dispatch, combine,
    aux) as ``top1_routing``; the aux loss is on the first choices."""
    e = logits.shape[-1]
    if e < 2:
        raise ValueError(f"top-2 routing needs >= 2 experts, got {e}")
    gates = torch.softmax(logits, dim=-1)
    mask1 = F.one_hot(gates.argmax(dim=-1), e).to(logits.dtype)
    gates_wo1 = torch.where(mask1 > 0, float("-inf"), gates)
    mask2 = F.one_hot(gates_wo1.argmax(dim=-1), e).to(logits.dtype)
    g1, g2 = (gates * mask1).sum(-1), (gates * mask2).sum(-1)
    denom = torch.clamp_min(g1 + g2, 1e-9)
    g1, g2 = g1 / denom, g2 / denom
    d1 = _queue(mask1, capacity)
    d2 = _queue(mask2, capacity, mask1.sum(dim=0)[None, :])
    aux = (mask1.mean(dim=0) * gates.mean(dim=0)).sum() * e
    return d1 + d2, d1 * g1[:, None, None] + d2 * g2[:, None, None], aux


def _lecun_normal(shape: tuple[int, ...], fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal (±2) of variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std)


class MoEMlp(nn.Module):
    """router -> E expert FFNs -> combine, with the residual: [T, D] tokens
    (batch and sequence flattened first) -> ([T, D], aux loss). The
    router is float32; the experts compute in ``dtype`` over float32
    ``w_in`` [E, D, H] and ``w_out`` [E, H, D] (the JAX layout). Given a
    ``mesh``, the experts run cut over its ``ep`` (and ``dp``) positions."""

    def __init__(self, d_model: int, num_experts: int, hidden_dim: int, *,
                 capacity_factor: float = 1.25, router_top_k: int = 1,
                 dtype: torch.dtype = torch.float32, mesh: Mesh | None = None):
        super().__init__()
        if router_top_k not in (1, 2):
            raise ValueError(f"router_top_k must be 1 or 2, got {router_top_k}")
        self.num_experts, self.hidden_dim = num_experts, hidden_dim
        self.capacity_factor, self.router_top_k = capacity_factor, router_top_k
        self.dtype, self.mesh = dtype, mesh
        self.router = nn.Linear(d_model, num_experts)
        self.w_in = nn.Parameter(_lecun_normal((num_experts, d_model, hidden_dim), d_model))
        self.w_out = nn.Parameter(_lecun_normal((num_experts, hidden_dim, d_model), hidden_dim))

    def capacity(self, tokens: int) -> int:
        return max(1, int(self.capacity_factor * self.router_top_k * tokens / self.num_experts))

    def route(self, x: torch.Tensor):
        """(dispatch, combine, aux) of [T, D] tokens, the router in float32."""
        routing = top1_routing if self.router_top_k == 1 else top2_routing
        logits = F.linear(x.to(torch.float32), self.router.weight.to(torch.float32),
                          self.router.bias.to(torch.float32))
        return routing(logits, self.capacity(x.shape[0]))

    def _experts(self, xs: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
        """[E', C', D] buffers through their experts' FFN (tanh GELU)."""
        h = F.gelu(torch.einsum("ecd,edh->ech", xs, w_in.to(self.dtype)), approximate="tanh")
        return torch.einsum("ech,ehd->ecd", h, w_out.to(self.dtype))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dispatch, combine, aux = self.route(x)
        dispatch, combine = dispatch.to(self.dtype), combine.to(self.dtype)
        xs = torch.einsum("tec,td->ecd", dispatch, x.to(self.dtype))  # [E, C, D]
        if self.mesh is None:
            ys = self._experts(xs, self.w_in, self.w_out)
        else:
            ys = self._experts_over_mesh(xs)
        out = torch.einsum("tec,ecd->td", combine, ys)
        return x + out.to(x.dtype), aux

    def _experts_over_mesh(self, xs: torch.Tensor) -> torch.Tensor:
        """The [E, C, D] buffers cut over the mesh (E over ``ep``, C over
        ``dp`` where it divides), each position's experts on its device,
        joined on xs's."""
        mesh = self.mesh
        sizes = mesh.shape
        dims = {"ep": 0} if "ep" in sizes else {}
        if "dp" in sizes and xs.shape[1] % sizes["dp"] == 0:
            dims["dp"] = 1  # a capacity dp does not divide stays whole
        bufs = split_to_positions(xs, mesh, dims)
        w_dims = {"ep": 0} if "ep" in dims else {}
        w_in = split_to_positions(self.w_in, mesh, w_dims)
        w_out = split_to_positions(self.w_out, mesh, w_dims)
        out = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(*mesh.devices.shape):
            # Positions past index 0 of an axis the experts do not use hold
            # replicas; only those the join reads compute.
            if any(i for a, i in zip(mesh.axis_names, pos) if a not in dims):
                continue
            out[pos] = self._experts(bufs[pos], w_in[pos], w_out[pos])
        return join_positions(out, mesh, dims, xs.device)


def from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ``MoEMlp``'s variables or params tree -> this module's state
    dict: ``router/{kernel,bias}`` (flax's [in, out] kernel transposed),
    ``w_in`` [E, D, H] and ``w_out`` [E, H, D] as they are."""
    params = params.get("params", params)

    def t(a: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    return {"router.weight": t(params["router"]["kernel"]).T.contiguous(),
            "router.bias": t(params["router"]["bias"]),
            "w_in": t(params["w_in"]), "w_out": t(params["w_out"])}


def moe_param_spec(path: tuple[str, ...], leaf) -> P:
    """The expert weights cut their leading E axis over ``ep``; the router
    replicates."""
    if any(n in ("w_in", "w_out") for n in path):
        return P("ep")
    return P()


def moe_param_shardings(mesh: Mesh, variables: Mapping) -> Mapping:
    """A tree of ``NamedSharding``s over ``variables`` (a state dict, or the
    JAX variables tree), each spec clamped to the mesh."""

    def one(name: str, leaf) -> NamedSharding:
        path = tuple(name.replace(".", "/").split("/"))
        return NamedSharding(mesh, clamp_spec(moe_param_spec(path, leaf), mesh,
                                              tuple(leaf.shape)))

    return map_tree(one, variables)


def shard_moe_params(mesh: Mesh, variables: Mapping) -> Mapping:
    """Place ``variables`` on the mesh: each leaf a ``ShardedLeaf`` whose
    positions hold their own slice (an ``ep`` position its experts' slice
    of ``w_in``/``w_out``) on their own device."""
    shardings = dict(tree_paths(moe_param_shardings(mesh, variables)))
    return map_tree(lambda name, leaf: shard_leaf(leaf, shardings[name]), variables)

