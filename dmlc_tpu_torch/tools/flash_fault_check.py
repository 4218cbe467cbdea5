#!/usr/bin/env python3
"""Shows that chip_smoke.py's kernel checks catch a planted fault.

    python3 dmlc_tpu_torch/tools/flash_fault_check.py SCRATCH_DIR [FAULT ...]

For each fault of FAULTS (default: all) it copies chip_smoke.py and
dmlc_tpu_torch/ (without its build directory) into SCRATCH_DIR/<fault>,
plants the fault in the copy's source, builds the copy and runs the fault's
check there. A flash fault (one late tile skipped) runs
``chip_smoke.flash_check``, causal, in the fault's dtype at its shape (the
LM train shape, or its Dh-64 twin):

- flash_fwd (bf16): the last 128-row Q tile skips its last K/V tile (the
  diagonal one); the count of K/V tiles is shared by the producer and the
  consumers, so both skip it;
- flash_bwd_dq (bf16): the last 128-row Q tile skips its last 64-key K/V
  tile (the diagonal one of its upper 64 rows); as in the forward, the
  count is shared by the producer and the consumers;
- flash_bwd_dkv (bf16): the last 128-key tile skips its last 64-row Q tile
  (the only one that reaches its last 64 keys);
- flash_fwd_f32 (float32): the last 64-row Q tile skips its last 32-key
  K/V tile (the diagonal one of its last 32 rows);
- flash_bwd_dq_f32 (float32): the last 64-row Q tile skips its last 32-key
  K/V tile (the diagonal one of its last 32 rows);
- flash_bwd_dkv_f32 (float32): the last 32-key block skips its last 32-row
  Q tile (the only one that reaches its keys);
- flash_fwd_dh64 (bf16, head dim 64): the fault of flash_fwd, which the
  Dh-64 instantiation shares.

A paged fault runs ``chip_smoke.paged_check`` on paged_decode_attention
(csrc/paged_decode.cu) in float32 at the decode bench's geometry, head dim
128, ragged lengths:

- paged_past_length: each split reads one position past the slot's
  kv length;
- paged_page0: the first page of each split is read from page 0 in place
  of the table's id;
- paged_split_twice: the merge adds split 0 twice.

The check must fail on every fault. Prints one JSON line per fault (the
check's message) and exits non-zero if a fault passes. Needs a CUDA device
and nvcc; the checkout it is run from is only read.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

sys.path.insert(0, str(Path(__file__).resolve().parent))  # tools/ is not a package
from flash_levers import DH64_SHAPE, REPO, TRAIN_SHAPE, copy_port, outside_checkout  # noqa: E402


class Fault(NamedTuple):
    source: str  # csrc/<source>.cu
    old: str     # the line replaced, exactly once in the source
    new: str
    dtype: str   # the check run on the copy
    shape: tuple  # flash: [B, H, S, Dh]; paged: (geometry, Dh)
    check: str = "flash"  # a key of CHECKS


FWD_SM90 = ("  return ((causal ? min(q0 + kFwdBQ, S) : S) + kFwdBK - 1) / kFwdBK;",
            "  return ((causal ? min(q0 + kFwdBQ, S) : S) + kFwdBK - 1) / kFwdBK"
            " - (q0 + kFwdBQ >= S ? 1 : 0);")

FAULTS = {
    "flash_fwd": Fault("flash_fwd", *FWD_SM90, "bfloat16", TRAIN_SHAPE),
    "flash_bwd_dq": Fault(
        "flash_bwd_dq", "  return ((causal ? min(q0 + kDqBQ, S) : S) + kDqBK - 1) / kDqBK;",
        "  return ((causal ? min(q0 + kDqBQ, S) : S) + kDqBK - 1) / kDqBK"
        " - (q0 + kDqBQ >= S ? 1 : 0);", "bfloat16", TRAIN_SHAPE),
    "flash_bwd_dkv": Fault(
        "flash_bwd_dkv", "  const int t_end = (S + kDkvBQ - 1) / kDkvBQ;",
        "  const int t_end = (S + kDkvBQ - 1) / kDkvBQ - (k0 + kDkvBK >= S ? 1 : 0);",
        "bfloat16", TRAIN_SHAPE),
    "flash_fwd_f32": Fault(
        "flash_fwd", "  return ((causal ? min(q0 + kFwdRows, S) : S) + kFwdKeys - 1) / kFwdKeys;",
        "  return ((causal ? min(q0 + kFwdRows, S) : S) + kFwdKeys - 1) / kFwdKeys"
        " - (q0 + kFwdRows >= S ? 1 : 0);", "float32", TRAIN_SHAPE),
    "flash_bwd_dq_f32": Fault(
        "flash_bwd_dq", "  return ((causal ? min(q0 + kDqRows, S) : S) + BK - 1) / BK;",
        "  return ((causal ? min(q0 + kDqRows, S) : S) + BK - 1) / BK"
        " - (q0 + kDqRows >= S ? 1 : 0);", "float32", TRAIN_SHAPE),
    "flash_bwd_dkv_f32": Fault(
        "flash_bwd_dkv", "  const int q_tiles = (S + C::BQ - 1) / C::BQ;",
        "  const int q_tiles = (S + C::BQ - 1) / C::BQ - (k0 + C::BK >= S ? 1 : 0);",
        "float32", TRAIN_SHAPE),
    "flash_fwd_dh64": Fault("flash_fwd", *FWD_SM90, "bfloat16", DH64_SHAPE),
}

PAGED_CASE = ("bench_decode", 128)
FAULTS.update({
    "paged_past_length": Fault(
        "paged_decode",
        "__device__ __forceinline__ int split_end(int p0, int len) "
        "{ return min(p0 + kSplit, len); }",
        "__device__ __forceinline__ int split_end(int p0, int len) "
        "{ return min(p0 + kSplit, len + 1); }", "float32", PAGED_CASE, "paged"),
    "paged_page0": Fault(
        "paged_decode", "    ids[i] = (id >= 0 && id < a.num_pages) ? id : -1;",
        "    ids[i] = (id >= 0 && id < a.num_pages) ? (i > 0 ? id : 0) : -1;",
        "float32", PAGED_CASE, "paged"),
    "paged_split_twice": Fault(
        "paged_decode", "      o += part[(size_t)s * a.dh + d] * c;",
        "      o += part[(size_t)s * a.dh + d] * c * (s == 0 ? 2.f : 1.f);",
        "float32", PAGED_CASE, "paged"),
})

#: Each check: the script run in the copy, and what its failure prints.
CHECKS = {
    "flash": ("""
import torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build
_build.build(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
cs.flash_check({shape}, torch.{dtype}, True)
""", "AssertionError: flash"),
    "paged": ("""
import torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build
_build.build(["paged_decode"])
cs.paged_check({shape}, torch.{dtype})
""", "AssertionError: paged_decode_attention"),
}


def plant(name: str, root: Path) -> Path:
    """A copy of the port under ``root / name`` with fault ``name``."""
    fault = FAULTS[name]
    src = REPO / "dmlc_tpu_torch" / "csrc" / f"{fault.source}.cu"
    text = src.read_text()
    if text.count(fault.old) != 1:
        raise RuntimeError(f"{src.name}: the loop to break is not there once: {fault.old!r}")
    dest = root / name
    copy_port(dest, {src.name: text.replace(fault.old, fault.new)})
    return dest


def main(argv: list[str]) -> int:
    names = argv[2:] or list(FAULTS)
    if len(argv) < 2 or any(n not in FAULTS for n in names):
        print(__doc__, file=sys.stderr)
        return 2
    root = outside_checkout(argv[1])
    if root is None:
        print("flash_fault_check: SCRATCH_DIR must lie outside the checkout", file=sys.stderr)
        return 2
    missed = []
    for name in names:
        fault = FAULTS[name]
        dest = plant(name, root)
        script, failure = CHECKS[fault.check]
        check = script.format(shape=fault.shape, dtype=fault.dtype)
        run = subprocess.run([sys.executable, "-c", check], cwd=dest, capture_output=True,
                             text=True, timeout=900)
        lines = (run.stderr.strip() or run.stdout.strip()).splitlines()
        caught = run.returncode != 0 and failure in run.stderr
        print(json.dumps({"fault": name, "caught": caught, "rc": run.returncode,
                          "message": lines[-1] if lines else ""}), flush=True)
        if not caught:
            missed.append(name)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
