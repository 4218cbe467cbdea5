"""Export a serving model as a bundle for the native AOTInductor host.

Counterpart of ``dmlc_tpu/models/pjrt_bundle.py``. Produces the directory
``dmlc_tpu_torch/_build/aoti_host run`` consumes: a serving deployment with
no Python in its process (``native/aoti_host.cpp`` loads the package through
libtorch's ``AOTIModelPackageLoader``):

    bundle/
      program.pt2     the serving program of ``models/export.py`` (uint8 NHWC
                      -> top-1 index + prob, or the embedding), compiled by
                      AOTInductor for the device it was exported on, weights
                      as INPUTS
      args.txt        manifest: one "dtype:d0,d1,...[=file]" line per program
                      input, in the program's input order
      arg<N>.raw      raw row-major bytes of each weight leaf
      image.raw       (optional) decoded JPEGs for the image input

Weights ship as raw files SEPARATE from the program, so a weight update
(the `train` verb's SDFS republish) never recompiles, the same split
``ExportedBackend`` uses. PJRT's ``compile_options.pb`` and
``client_options.txt`` have no counterpart here.

Entry points: the port CLI's `export-bundle` verb and
``python3 dmlc_tpu_torch/tools/export_aoti_bundle.py --model resnet18
--batch 8 --out /tmp/bundle``.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from dmlc_tpu_torch.ops._build_host import openmp_cxx
from dmlc_tpu_torch.utils.device import resolve_device

_DTYPE_NAMES = {torch.uint8: "u8", torch.float32: "f32", torch.int32: "i32",
                torch.bfloat16: "bf16"}


def _raw(t: torch.Tensor) -> bytes:
    """Row-major bytes of a CPU tensor (bfloat16 too, which numpy lacks)."""
    t = t.detach().to("cpu").contiguous()
    return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""


def _leaves(model_name: str, keys: list[str], variables, seed: int) -> tuple[list, int]:
    """The weight leaves in the program's key order, and how many leaves the
    given tree holds (``export.serving_leaves``; None draws the registry's
    seeded init)."""
    from dmlc_tpu_torch.models.export import serving_leaves
    from dmlc_tpu_torch.models.registry import get_model

    if variables is None:
        variables = get_model(model_name).init_params(seed, dtype=torch.float32).state_dict()
    leaves = serving_leaves(model_name, variables)
    return [leaves[k] for k in keys if k in leaves], len(leaves)


def export_bundle(
    model_name: str,
    batch_size: int,
    out_dir: Path,
    seed: int = 0,
    image_paths: list[str] | None = None,
    variables=None,
    device: str | torch.device | None = None,
) -> dict:
    """Write the bundle for ``model_name`` at ``batch_size`` on ``device``
    (the card unless the caller asks for the CPU). ``variables`` lets
    callers bundle LIVE weights (the CLI verb passes the cluster's
    published SDFS weights); the default is the seeded init. The guards
    run before the AOTInductor compile, so a bad bundle fails fast."""
    from dmlc_tpu_torch.models import export as export_lib

    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ep = export_lib.export_program(model_name, batch_size=batch_size, device=dev)
    export_s = time.perf_counter() - t0
    keys = list(export_lib.build_serving_forward(model_name).weight_avals)
    flat_vars, n_leaves = _leaves(model_name, keys, variables, seed)

    lines = []
    n_weight_args = 0
    for node in (n for n in ep.graph.nodes if n.op == "placeholder"):
        aval = node.meta["val"]
        dt = _DTYPE_NAMES.get(aval.dtype)
        if dt is None:
            raise ValueError(f"unsupported exported input dtype {aval.dtype}")
        shape = ",".join(str(d) for d in aval.shape)
        if aval.dtype == torch.uint8 and aval.dim() == 4:
            if image_paths:
                # Stage REAL decoded pixels so the native host classifies
                # actual JPEG data, not zeros; pad the batch by repeating.
                import numpy as np

                from dmlc_tpu_torch.ops import preprocess as pp

                if len(image_paths) > batch_size:
                    raise ValueError(
                        f"{len(image_paths)} images but batch size "
                        f"{batch_size}: the extras would be silently "
                        "dropped — raise --batch or trim --image"
                    )
                size = int(aval.shape[1])
                batch = pp.load_batch(image_paths, size=size)
                reps = -(-batch_size // batch.shape[0])
                batch = np.tile(batch, (reps, 1, 1, 1))[:batch_size]
                if tuple(batch.shape) != tuple(aval.shape):
                    # Mirrors the weight-leaf guard: fail at export time,
                    # not at the host's byte-size check.
                    raise ValueError(
                        f"staged image batch {batch.shape} != exported "
                        f"input aval {tuple(aval.shape)}"
                    )
                (out_dir / "image.raw").write_bytes(batch.tobytes())
                lines.append(f"{dt}:{shape}=image.raw")
            else:
                lines.append(f"{dt}:{shape}")  # the image batch: zeros
            continue
        if n_weight_args >= len(flat_vars):
            raise ValueError(
                f"exported input {node.name} has no weight leaf: the tree has "
                f"{len(flat_vars)} of the program's {len(keys)} weights"
            )
        leaf = flat_vars[n_weight_args]
        if tuple(leaf.shape) != tuple(aval.shape):
            raise ValueError(
                f"weight leaf {n_weight_args} shape {tuple(leaf.shape)} != "
                f"exported aval {tuple(aval.shape)} — flatten order drifted"
            )
        if leaf.dtype != aval.dtype:
            # Same-itemsize mismatches (i32 vs f32) would otherwise write
            # silently-wrong raw bytes the host stages verbatim. Precision
            # differences (a bf16 checkpoint feeding a float32 input) are
            # cast; anything kind-crossing is a flatten drift and fails here.
            if leaf.dtype.is_floating_point and aval.dtype.is_floating_point:
                leaf = leaf.to(aval.dtype)
            else:
                raise ValueError(
                    f"weight leaf {n_weight_args} dtype {leaf.dtype} != "
                    f"exported aval dtype {aval.dtype} — flatten order drifted"
                )
        fname = f"arg{n_weight_args}.raw"
        (out_dir / fname).write_bytes(_raw(leaf))
        lines.append(f"{dt}:{shape}={fname}")
        n_weight_args += 1
    if n_weight_args != n_leaves:
        raise ValueError(
            f"exported {n_weight_args} weight inputs but the tree has "
            f"{n_leaves} leaves"
        )
    (out_dir / "args.txt").write_text("\n".join(lines) + "\n")

    t0 = time.perf_counter()
    package = out_dir / "program.pt2"
    torch._inductor.aoti_compile_and_package(
        ep, package_path=str(package), inductor_configs={"cpp.cxx": (openmp_cxx(),)})
    compile_s = time.perf_counter() - t0
    return {
        "model": model_name,
        "batch": batch_size,
        "device": str(dev),
        "inputs": len(lines),
        "weight_args": n_weight_args,
        "program_bytes": package.stat().st_size,
        "export_s": export_s,
        "compile_s": compile_s,
    }
