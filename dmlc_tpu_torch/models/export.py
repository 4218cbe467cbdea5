"""``torch.export`` serving programs: models as portable executables.

Counterpart of ``dmlc_tpu/models/export.py``. A model travels through the
SDFS as two artifacts:

- **weights** (``models/weights.py``): the variables tree, hot-swappable;
- **executables** (this module): the whole serving program (uint8 NHWC ->
  ``/255`` -> ``(x - mean) / std`` -> forward -> softmax -> top-1, or the
  embedding of an encoder) exported by ``torch.export`` and saved as a
  ``.pt2`` program. The program is weight-agnostic: every weight is a user
  input of the graph, none is lifted into it as a parameter, buffer or
  constant, so the artifact stays small and a weight update never
  re-exports. Loading it needs no model source: ``torch.export.load`` and
  the graph's own code are the whole loader.

The program is plain torch, as the JAX package's is plain ``jnp``: it runs
no hand-written kernel. The input avals (batch, input size, dtypes) are
fixed at export, and so is the device: ``torch.export`` records it in the
graph's tensor checks, so a program is exported on the device it will run
on, the blob records that device, and a loader asked for another device
refuses the blob.

The blobs carry magics and SDFS names of their own (``DMLCTEX1``,
``DMLCTEX2``, ``executables/<m>.pt2``), so a JAX member and a port member of
one fleet never fetch each other's program, and each package's loader
refuses the other's blob ("bad magic").

Blob layout: magic, a 2-byte big-endian length and the model name, a 4-byte
big-endian length and a JSON header (device, dtype, shapes, weight keys; a
sharded blob also its mesh axes and position devices), then the bytes of
``torch.export.save``.
"""

from __future__ import annotations

import copy
import io
import json
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
from torch import nn

from dmlc_tpu_torch.models.convert import variables_from_jax
from dmlc_tpu_torch.models.registry import get_model
from dmlc_tpu_torch.ops import preprocess as pp
from dmlc_tpu_torch.utils.device import resolve_device

MAGIC = b"DMLCTEX1"
# Gang-sharded executables: the program runs every position of one mesh
# shape, so the blob also records the mesh axes and each position's device.
SHARDED_MAGIC = b"DMLCTEX2"


def sdfs_executable_name(model_name: str) -> str:
    """Canonical SDFS name for a model's serving program (beside the JAX
    package's ``executables/<m>``)."""
    return f"executables/{model_name}.pt2"


def sdfs_sharded_executable_name(model_name: str, n_devices: int) -> str:
    """Canonical SDFS name for a gang's sharded program: one artifact per
    (model, gang width)."""
    return f"executables/{model_name}@{int(n_devices)}.pt2"


def _read_by_forward(key: str) -> bool:
    """Every state-dict tensor is a program input but BatchNorm's
    ``num_batches_tracked``, which an eval forward never reads."""
    return not key.endswith("num_batches_tracked")


def serving_leaves(model_name: str, variables: Mapping) -> dict[str, torch.Tensor]:
    """``variables`` (this package's state dict, or the JAX package's
    ``{"params", ...}`` tree, carried over by ``models/convert.py``) as the
    serving program's weight leaves by state-dict key, as given."""
    if "params" in variables:
        variables = variables_from_jax(model_name, variables)
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in variables.items() if _read_by_forward(k)}


class ServingForward(nn.Module):
    """The serving program of a registry model, owning no parameters: its
    forward takes ``(weights, u8)`` and calls the model, built on the
    ``meta`` device, through ``torch.func.functional_call``, so every weight
    (BatchNorm's running statistics included) is an input. The model keeps
    float32 weights and casts them to ``dtype`` inside each call, as the
    engines do. Mean and std enter as Python floats, one channel at a
    time, so the graph holds no constant tensor."""

    def __init__(self, model_name: str, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        spec = get_model(model_name)
        with torch.device("meta"):
            model = spec.module(dtype=dtype)
        model.eval().requires_grad_(False)
        # Not a submodule: the exported root must own no parameters.
        object.__setattr__(self, "_model", model)
        self.classifier = spec.classifier
        self.input_size = spec.input_size
        mean, std = pp.stats_for_model(model_name)
        self._stats = tuple(zip((float(m) for m in mean), (float(s) for s in std)))
        sd = model.state_dict()
        self.weight_avals = {k: (tuple(t.shape), t.dtype) for k, t in sd.items()
                             if _read_by_forward(k)}

    def forward(self, weights: dict[str, torch.Tensor], u8: torch.Tensor):
        x = u8.to(torch.float32) / 255.0
        x = torch.stack([(x[..., c] - m) / s for c, (m, s) in enumerate(self._stats)], dim=-1)
        out = torch.func.functional_call(self._model, weights, (x,))
        if self.classifier:
            probs = torch.softmax(out, dim=-1)
            return torch.argmax(probs, dim=-1).to(torch.int32), torch.amax(probs, dim=-1)
        return out


def build_serving_forward(model_name: str, dtype: torch.dtype = torch.bfloat16) -> ServingForward:
    """The serving program: uint8 NHWC -> (top1_index, top1_prob) for
    classifiers, or the embedding matrix for encoders."""
    return ServingForward(model_name, dtype=dtype)


def check_weight_inputs(ep: torch.export.ExportedProgram) -> None:
    """Raise unless every input of the exported graph is a user input: a
    lifted parameter, buffer or constant would bake weights (or a device)
    into the artifact."""
    from torch.export.graph_signature import InputKind

    lifted = [s.target or s.arg.name for s in ep.graph_signature.input_specs
              if s.kind != InputKind.USER_INPUT]
    if lifted:
        raise ValueError(f"exported program lifted {lifted[:8]} into the graph; "
                         "every weight must be an input")


def _save(ep: torch.export.ExportedProgram) -> bytes:
    # The example inputs (the example weights) would otherwise be saved
    # with the program.
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _pack(magic: bytes, model_name: str, header: dict, program: bytes) -> bytes:
    name_b = model_name.encode()
    head_b = json.dumps(header, sort_keys=True).encode()
    return (magic + len(name_b).to_bytes(2, "big") + name_b
            + len(head_b).to_bytes(4, "big") + head_b + program)


def _unpack(data: bytes, magic: bytes, what: str,
            expect_model: str | None) -> tuple[str, dict, bytes]:
    if data[: len(magic)] != magic:
        raise ValueError(f"not a dmlc_tpu_torch {what} blob (bad magic)")
    off = len(magic)
    n = int.from_bytes(data[off : off + 2], "big")
    model_name = data[off + 2 : off + 2 + n].decode()
    if expect_model is not None and model_name != expect_model:
        raise ValueError(f"executable is for {model_name!r}, expected {expect_model!r}")
    off += 2 + n
    m = int.from_bytes(data[off : off + 4], "big")
    header = json.loads(data[off + 4 : off + 4 + m])
    return model_name, header, data[off + 4 + m :]


def _canonical(device: str | torch.device) -> torch.device:
    """A CUDA device without an index names the current one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def export_program(model_name: str, batch_size: int = 256, dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None) -> torch.export.ExportedProgram:
    """Trace and export the serving program at a fixed batch on ``device``
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    prog = build_serving_forward(model_name, dtype=dtype)
    size = prog.input_size
    weights = {k: torch.zeros(shape, dtype=dt, device=dev)
               for k, (shape, dt) in prog.weight_avals.items()}
    u8 = torch.zeros((int(batch_size), size, size, 3), dtype=torch.uint8, device=dev)
    ep = torch.export.export(prog, (weights, u8), strict=False)
    check_weight_inputs(ep)
    return ep


def export_serving(model_name: str, batch_size: int = 256, dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None) -> bytes:
    """Export the serving program -> one blob (magic + model name + header
    + the saved program)."""
    dev = resolve_device(device)
    ep = export_program(model_name, batch_size=batch_size, dtype=dtype, device=dev)
    prog = build_serving_forward(model_name, dtype=dtype)
    header = {
        "device": str(dev), "dtype": _dtype_name(dtype), "batch": int(batch_size),
        "input_size": prog.input_size, "classifier": prog.classifier,
        "weights": [[k, list(shape), _dtype_name(dt)]
                    for k, (shape, dt) in prog.weight_avals.items()],
    }
    return _pack(MAGIC, model_name, header, _save(ep))


@dataclass
class Exported:
    """A loaded serving program: ``call(weights, u8)`` runs it."""

    model_name: str
    program: torch.export.ExportedProgram
    header: dict

    def __post_init__(self):
        self._module = self.program.module()

    @property
    def device(self) -> torch.device:
        return torch.device(self.header["device"])

    @property
    def batch(self) -> int:
        return int(self.header["batch"])

    @property
    def input_size(self) -> int:
        return int(self.header["input_size"])

    @property
    def classifier(self) -> bool:
        return bool(self.header["classifier"])

    @property
    def weight_avals(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        return {k: (tuple(shape), _dtype(dt)) for k, shape, dt in self.header["weights"]}

    def weights(self, variables: Mapping) -> dict[str, torch.Tensor]:
        """The program's weight inputs from ``variables`` (``serving_leaves``),
        on the program's device, in its dtypes. Converted once, when weights
        are loaded; keys and shapes must match."""
        leaves = serving_leaves(self.model_name, variables)
        avals = self.weight_avals
        missing, extra = sorted(set(avals) - set(leaves)), sorted(set(leaves) - set(avals))
        if missing or extra:
            raise ValueError(f"variables mismatch: missing {missing[:8]}, unexpected {extra[:8]}")
        out = {}
        for key, (shape, dt) in avals.items():
            t = leaves[key]
            if tuple(t.shape) != shape:
                raise ValueError(f"shape mismatch at {key}: got {tuple(t.shape)}, "
                                 f"program takes {shape}")
            out[key] = t.detach().to(device=self.device, dtype=dt).contiguous()
        return out

    def call(self, weights: Mapping[str, torch.Tensor], u8: torch.Tensor):
        """Run the program on tensors already on its device."""
        ordered = {k: weights[k] for k in self.weight_avals}
        with torch.inference_mode():
            return self._module(ordered, u8)


def load_serving(data: bytes, expect_model: str | None = None,
                 device: str | torch.device | None = None) -> tuple[str, Exported]:
    """-> (model_name, exported): the loaded program. With ``device`` the
    blob must have been exported there."""
    model_name, header, program = _unpack(data, MAGIC, "executable", expect_model)
    if device is not None and _canonical(header["device"]) != _canonical(device):
        raise ValueError(f"executable for {model_name!r} was exported for "
                         f"{header['device']}, not {device}")
    ep = torch.export.load(io.BytesIO(program))
    return model_name, Exported(model_name, ep, header)


def program_text(data: bytes) -> str:
    """The exported graph's code, readable (the counterpart of the JAX
    package's ``stablehlo_text``)."""
    _, exported = load_serving(data)
    return exported.program.graph_module.code


def publish_executable(sdfs_client, model_name: str, batch_size: int = 256,
                       dtype: torch.dtype = torch.bfloat16,
                       device: str | torch.device | None = None) -> int:
    """Export and put a new executable version into SDFS; returns version."""
    blob = export_serving(model_name, batch_size=batch_size, dtype=dtype, device=device)
    return sdfs_client.put_bytes(blob, sdfs_executable_name(model_name))["version"]


def fetch_executable(sdfs_client, model_name: str, version: int | None = None,
                     device: str | torch.device | None = None) -> tuple[int, Exported]:
    """Pull and load a model's executable from SDFS -> (version, exported)."""
    v, blob = sdfs_client.get_bytes(sdfs_executable_name(model_name), version=version)
    _, exported = load_serving(blob, expect_model=model_name, device=device)
    return v, exported


class ExportedServer:
    """Serve batches straight from a loaded program: everything a member
    needs to answer predict shards is the blob and the weights, no model
    source. ``variables`` are converted once, here and in
    ``load_variables``, onto the program's device."""

    def __init__(self, exported: Exported, variables: Mapping):
        self.exported = exported
        self.batch_size = exported.batch
        self.classifier = exported.classifier
        self.load_variables(variables)

    def load_variables(self, variables: Mapping) -> None:
        self.weights = self.exported.weights(variables)

    def __call__(self, batch_u8: np.ndarray):
        n = batch_u8.shape[0]
        if n < self.batch_size:
            pad = np.zeros((self.batch_size - n, *batch_u8.shape[1:]), batch_u8.dtype)
            batch_u8 = np.concatenate([batch_u8, pad])
        u8 = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.exported.device)
        out = self.exported.call(self.weights, u8)
        if self.classifier:
            idx, top = (o[:n].cpu().numpy() for o in out)
            return idx, top
        return out[:n].cpu().numpy()


# ---------------------------------------------------------------------------
# The gang's program at one mesh shape


class ShardedForward(nn.Module):
    """``parallel/sharding.ShardedProgram``'s forward as a program over its
    shards: ``forward(shards, data)`` takes every position's shard of every
    leaf (``"<key>@<i>"``, ``i`` the position's index in row-major order)
    and rebuilds the dp groups around them, so the weights are inputs. The
    program records the positions' devices: a copy between two positions
    is a ``.to`` of the device it was traced with."""

    def __init__(self, prog):
        super().__init__()
        object.__setattr__(self, "_prog", prog)

    def forward(self, shards: dict[str, torch.Tensor], data: torch.Tensor) -> torch.Tensor:
        from dmlc_tpu_torch.parallel.sharding import ShardedLeaf

        prog = self._prog
        view = copy.copy(prog)
        view.variables = {}
        for key, leaf in prog.variables.items():
            grid = np.empty(leaf.shards.shape, dtype=object)
            for i, pos in enumerate(np.ndindex(*grid.shape)):
                grid[pos] = shards[f"{key}@{i}"]
            view.variables[key] = ShardedLeaf(grid, leaf.sharding, leaf.shape)
        rows = data.shape[0] // view.dp
        outs = []
        for i in range(view.dp):
            home, model = view._build_group(i)
            x = data[i * rows : (i + 1) * rows].to(home)
            outs.append(view._answer(view._output(model, x)).to(data.device))
        return torch.cat(outs)


def shard_inputs(variables: Mapping) -> dict[str, torch.Tensor]:
    """A ``ShardedProgram``'s placed ``variables`` as the sharded program's
    inputs (``ShardedForward``'s naming)."""
    return {f"{key}@{i}": leaf.shards[pos] for key, leaf in variables.items()
            for i, pos in enumerate(np.ndindex(*leaf.shards.shape))}


def export_sharded_serving(model_name: str, mesh, *, batch_size: int = 8, seq_len: int = 16,
                           dtype: torch.dtype = torch.float32) -> bytes:
    """Export the partition-rule-sharded serving program at a mesh shape:
    the gang's executable. The blob records the mesh axes and each
    position's device, because the program runs only on such a mesh."""
    from dmlc_tpu_torch.parallel.sharding import ShardedProgram

    spec = get_model(model_name)
    prog = ShardedProgram(model_name, mesh, dtype=dtype)
    if batch_size % prog.dp:
        raise ValueError(f"batch {batch_size} does not split over dp={prog.dp}")
    devices = [str(mesh.devices[pos]) for pos in np.ndindex(*mesh.devices.shape)]
    if spec.kind == "lm":
        data = torch.zeros((batch_size, seq_len), dtype=torch.int32, device=devices[0])
    else:
        size = spec.input_size
        data = torch.zeros((batch_size, size, size, 3), dtype=torch.uint8, device=devices[0])
    example = {k: torch.empty_like(t) for k, t in shard_inputs(prog.variables).items()}
    # Under no_grad, the groups' load_state_dict (which takes no_grad
    # itself) changes no grad mode, so the graph holds no grad-mode region.
    with torch.no_grad():
        ep = torch.export.export(ShardedForward(prog), (example, data), strict=False)
    check_weight_inputs(ep)
    header = {"axes": dict(mesh.shape), "devices": devices, "dtype": _dtype_name(dtype),
              "data": [list(data.shape), _dtype_name(data.dtype)]}
    return _pack(SHARDED_MAGIC, model_name, header, _save(ep))


@dataclass
class ShardedExported:
    """A loaded gang program: ``call(variables, data)`` runs it over a
    ``ShardedProgram``'s placed variables on a mesh of the recorded shape
    and devices."""

    model_name: str
    mesh_axes: dict[str, int]
    devices: list[str]
    program: torch.export.ExportedProgram

    def __post_init__(self):
        self._module = self.program.module()

    def check_mesh(self, mesh) -> None:
        """Refuse a mesh of another shape or device list."""
        devices = [str(mesh.devices[pos]) for pos in np.ndindex(*mesh.devices.shape)]
        if dict(mesh.shape) != self.mesh_axes or devices != self.devices:
            raise ValueError(f"executable for {self.model_name!r} runs on mesh "
                             f"{self.mesh_axes} over {self.devices}, not {dict(mesh.shape)} "
                             f"over {devices}")

    def call(self, variables: Mapping, data) -> torch.Tensor:
        grids = {leaf.shards.shape for leaf in variables.values()}
        shape = tuple(self.mesh_axes.values())
        if grids != {shape}:
            raise ValueError(f"executable for {self.model_name!r} runs on mesh {self.mesh_axes}; "
                             f"the variables are placed on {sorted(grids)}")
        inputs = shard_inputs(variables)
        for key, t in inputs.items():
            i = int(key.rsplit("@", 1)[1])
            if str(t.device) != self.devices[i]:
                raise ValueError(f"executable for {self.model_name!r} runs position {i} on "
                                 f"{self.devices[i]}, not {t.device}")
        x = torch.as_tensor(np.asarray(data)).to(self.devices[0])
        with torch.inference_mode():
            return self._module(inputs, x)


def load_sharded_serving(data: bytes, expect_model: str | None = None
                         ) -> tuple[str, dict[str, int], ShardedExported]:
    """-> (model_name, mesh_axes, exported) for a gang executable blob. The
    caller builds a mesh of exactly ``mesh_axes`` over the recorded devices
    (``exported.devices``) before ``exported.call``; any other mesh is
    refused."""
    model_name, header, program = _unpack(data, SHARDED_MAGIC, "sharded executable",
                                          expect_model)
    axes = {k: int(v) for k, v in header["axes"].items()}
    ep = torch.export.load(io.BytesIO(program))
    return model_name, axes, ShardedExported(model_name, axes, list(header["devices"]), ep)

