"""Pretrained-weight distribution: serialize, validate, publish, import.

Counterpart of ``dmlc_tpu/models/weights.py`` without flax or JAX. The blob
is the JAX package's, byte for byte: ``MAGIC``, a 2-byte big-endian length
of the model name, the name, then flax's msgpack of the JAX variables tree
(``flax.serialization.msgpack_serialize``), encoded here with ``msgpack``
itself:

- the tree is rebuilt with every dict's keys sorted and every leaf a numpy
  array, as the JAX package's ``tree_map(np.asarray, ...)`` rebuilds it;
- an array is ``ExtType(1, packb((shape, dtype name, C-order bytes)))``, a
  numpy scalar ``ExtType(3, ...)`` of the same, a complex ``ExtType(2,
  packb((real, imag)))``; the top level is packed with ``strict_types``;
- an array above ``MAX_CHUNK_SIZE`` bytes is split into flat chunks under
  ``'__msgpack_chunked_array__'``, as flax splits it.

``weights_from_bytes`` reads any blob flax writes: dtype names are read as
bytes, as flax reads them, and a ``bfloat16`` array, which numpy has no
type for, becomes a bfloat16 torch tensor.

A blob carries the JAX package's variables tree, so a blob published by
either package loads into the other; ``models/convert.py`` carries the tree
to this package's modules (``from_jax``) and back (``to_jax``). Every tree
is validated against the registry model's template (key paths and shapes)
before it can reach an engine, with the JAX package's messages.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping

import numpy as np
import torch

try:
    import msgpack
except ImportError as e:  # the blob format itself: there is no other encoding
    raise ImportError("dmlc_tpu_torch.models.weights needs msgpack for the weights blob") from e

from dmlc_tpu_torch.models import convert
from dmlc_tpu_torch.models.registry import get_model

MAGIC = b"DMLCWTS1"

#: flax's bound on one array leaf's bytes before it is chunked
#: (``flax.serialization.MAX_CHUNK_SIZE``).
MAX_CHUNK_SIZE = 2**30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def not_published(err: Exception) -> bool:
    """True when an SDFS error means the blob was never published (vs a
    corrupt blob or transient replica failure, which callers must surface).
    The one place the leader's not-found message text is interpreted —
    RPC errors travel as message strings."""
    return "not in SDFS" in str(err)


def sdfs_weights_name(model_name: str) -> str:
    """Canonical SDFS name for a model's weights blob (the `train` payload)."""
    return f"models/{model_name}"


# ---------------------------------------------------------------------------
# The tree: key paths as jax.tree_util.keystr renders them
# ---------------------------------------------------------------------------


def flatten_with_keys(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) pairs in ``jax.tree_util``'s order: dict keys
    sorted, ``None`` an empty subtree; paths render as ``keystr`` does
    (``['params']['head']['bias']``)."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        out = []
        for key in sorted(tree):
            out.extend(flatten_with_keys(tree[key], f"{prefix}[{key!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out.extend(flatten_with_keys(sub, f"{prefix}[{i}]"))
        return out
    return [(prefix, tree)]


def _shape(leaf: Any) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))


@functools.lru_cache(maxsize=None)
def variables_template(model_name: str) -> dict:
    """The JAX variables tree of a registry model with ``LeafSpec`` leaves
    (shape, float32): the module is built on the ``meta`` device, so no
    weights are allocated, and its state dict's names and shapes are
    mapped through the model's ``to_jax``. Cached: every model.load
    validates against it."""
    spec = get_model(model_name)
    if spec.to_jax is None:
        raise KeyError(f"model {model_name!r} has no JAX weight mapping")
    with torch.device("meta"):
        model = spec.module(dtype=torch.float32)
    return spec.to_jax(model.state_dict())


def check_variables(model_name: str, variables) -> None:
    """Raise ValueError unless ``variables`` matches the model's tree
    structure and leaf shapes."""
    t_map = {k: leaf.shape for k, leaf in flatten_with_keys(variables_template(model_name))}
    v_map = {k: _shape(leaf) for k, leaf in flatten_with_keys(variables)}
    if t_map.keys() != v_map.keys():
        missing = sorted(t_map.keys() - v_map.keys())[:3]
        extra = sorted(v_map.keys() - t_map.keys())[:3]
        raise ValueError(
            f"variables tree mismatch for {model_name!r}: missing={missing} extra={extra}"
        )
    for key, shape in t_map.items():
        if tuple(v_map[key]) != tuple(shape):
            raise ValueError(
                f"shape mismatch for {model_name!r} at {key}: "
                f"got {tuple(v_map[key])}, want {tuple(shape)}"
            )


# ---------------------------------------------------------------------------
# flax's msgpack, without flax
# ---------------------------------------------------------------------------


def _as_arrays(tree: Any) -> Any:
    """``tree_map(np.asarray, tree)``: dicts rebuilt with sorted keys, every
    leaf a numpy array; a bfloat16 tensor stays a (CPU) tensor, since
    numpy has no bfloat16."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {key: _as_arrays(tree[key]) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_arrays(sub) for sub in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)


def _array_bytes(arr: np.ndarray | torch.Tensor) -> bytes:
    if isinstance(arr, torch.Tensor):  # bfloat16 (see _as_arrays)
        raw = arr.contiguous().view(torch.int16).numpy().tobytes("C")
        return msgpack.packb((tuple(arr.shape), "bfloat16", raw), use_bin_type=True)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _ext_pack(x: Any) -> Any:
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return msgpack.ExtType(_EXT_NDARRAY, _array_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _array_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    return x


def _chunk(arr: np.ndarray | torch.Tensor) -> dict:
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _nbytes(arr: np.ndarray | torch.Tensor) -> int:
    return arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes


def _rebuild(tree: Any, chunk: bool = True) -> Any:
    """flax's copy of the tree before packing (``tree_map(lambda x: x,
    ...)``): dicts rebuilt with sorted keys; an array above
    ``MAX_CHUNK_SIZE`` bytes chunked where flax looks for one, at the top
    and in dicts, not under a list."""
    if isinstance(tree, Mapping):
        return {key: _rebuild(tree[key], chunk) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, False) for sub in tree)
    if chunk and isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """flax's ``msgpack_serialize`` of a tree of dicts, lists and leaves."""
    return msgpack.packb(_rebuild(tree), default=_ext_pack, strict_types=True)


def _array_from_bytes(data: bytes) -> np.ndarray | torch.Tensor:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        if not buffer:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name), count=-1,
                         offset=0).reshape(shape, order="C")


def _ext_unpack(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if all(isinstance(c, torch.Tensor) for c in chunks):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(encoded: bytes) -> Any:
    """flax's ``msgpack_restore``: the tree, chunked arrays joined."""
    return _unchunk(msgpack.unpackb(encoded, ext_hook=_ext_unpack, raw=False))


# ---------------------------------------------------------------------------
# The blob
# ---------------------------------------------------------------------------


def weights_to_bytes(model_name: str, variables) -> bytes:
    """Serialize a validated variables tree into the distribution blob."""
    check_variables(model_name, variables)
    name_b = model_name.encode()
    payload = msgpack_serialize(_as_arrays(variables))
    return MAGIC + len(name_b).to_bytes(2, "big") + name_b + payload


def weights_from_bytes(data: bytes, expect_model: str | None = None):
    """-> (model_name, variables), validated against the registry model."""
    if data[: len(MAGIC)] != MAGIC:
        raise ValueError("not a dmlc weights blob (bad magic)")
    off = len(MAGIC)
    n = int.from_bytes(data[off : off + 2], "big")
    model_name = data[off + 2 : off + 2 + n].decode()
    if expect_model is not None and model_name != expect_model:
        raise ValueError(f"weights are for {model_name!r}, expected {expect_model!r}")
    variables = msgpack_restore(data[off + 2 + n :])
    check_variables(model_name, variables)
    return model_name, variables


def publish_weights(sdfs_client, model_name: str, variables) -> int:
    """Put a new weights version into SDFS; returns the version number."""
    blob = weights_to_bytes(model_name, variables)
    return sdfs_client.put_bytes(blob, sdfs_weights_name(model_name))["version"]


# ---------------------------------------------------------------------------
# External checkpoint import (dispatch over models/convert.py)
# ---------------------------------------------------------------------------

_RESNET_STAGES = {
    "resnet18": ([2, 2, 2, 2], False),
    "resnet34": ([3, 4, 6, 3], False),
    "resnet50": ([3, 4, 6, 3], True),
}
_VIT_LAYERS = {"vit_b16": 12, "vit_l14": 24}
_CLIP_LAYERS = {"clip_vit_l14": 24, "clip_vit_b32": 12}


def import_external(model_name: str, state_dict) -> dict:
    """External state dict (numpy values) -> validated variables tree.

    torchvision layouts for resnet/alexnet, HuggingFace layouts for
    vit/clip — the layouts the ecosystem's pretrained checkpoints ship in
    (the reference's `.ot` files played this role, services.rs:513-524).
    """
    if model_name in _RESNET_STAGES:
        sizes, bottleneck = _RESNET_STAGES[model_name]
        variables = convert.resnet_params_from_torch(state_dict, sizes, bottleneck)
    elif model_name == "alexnet":
        variables = convert.alexnet_params_from_torch(state_dict)
    elif model_name in _VIT_LAYERS:
        variables = convert.vit_params_from_hf(state_dict, _VIT_LAYERS[model_name])
    elif model_name in _CLIP_LAYERS:
        variables = convert.clip_params_from_hf(state_dict, _CLIP_LAYERS[model_name])
    else:
        raise KeyError(f"no external-checkpoint importer for {model_name!r}")
    check_variables(model_name, variables)
    return variables
