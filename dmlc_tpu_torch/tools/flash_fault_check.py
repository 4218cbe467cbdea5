#!/usr/bin/env python3
"""Shows that chip_smoke.py's flash check catches a fault in one late tile.

    python3 dmlc_tpu_torch/tools/flash_fault_check.py SCRATCH_DIR

For each flash kernel it copies chip_smoke.py and dmlc_tpu_torch/ (without
its build directory) into SCRATCH_DIR/<kernel>, plants a fault in the copy's
source that skips one late tile, builds the copy and runs
``chip_smoke.flash_check`` there at the LM train shape in bf16, causal:

- flash_fwd (bf16): the last 128-row Q tile skips its last K/V tile (the
  diagonal one); the count of K/V tiles is shared by the producer and the
  consumers, so both skip it;
- flash_bwd_dq (bf16): the last 128-row Q tile skips its last 64-key K/V
  tile (the diagonal one of its upper 64 rows); as in the forward, the
  count is shared by the producer and the consumers;
- flash_bwd_dkv (bf16): the last 128-key tile skips its last 64-row Q tile
  (the only one that reaches its last 64 keys).

The check must fail on every fault. Prints one JSON line per fault (the
check's message) and exits non-zero if a fault passes. Needs a CUDA device
and nvcc; the checkout it is run from is only read.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

FAULTS = {
    "flash_fwd": ("  return ((causal ? min(q0 + kFwdBQ, S) : S) + kFwdBK - 1) / kFwdBK;",
                  "  return ((causal ? min(q0 + kFwdBQ, S) : S) + kFwdBK - 1) / kFwdBK"
                  " - (q0 + kFwdBQ >= S ? 1 : 0);"),
    "flash_bwd_dq": ("  return ((causal ? min(q0 + kDqBQ, S) : S) + kDqBK - 1) / kDqBK;",
                     "  return ((causal ? min(q0 + kDqBQ, S) : S) + kDqBK - 1) / kDqBK"
                     " - (q0 + kDqBQ >= S ? 1 : 0);"),
    "flash_bwd_dkv": ("  const int t_end = (S + kDkvBQ - 1) / kDkvBQ;",
                      "  const int t_end = (S + kDkvBQ - 1) / kDkvBQ - (k0 + kDkvBK >= S ? 1 : 0);"),
}

CHECK = """
import torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build
_build.build(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
cs.flash_check(cs.TRAIN_SHAPE, torch.bfloat16, True)
"""


def plant(kernel: str, root: Path) -> Path:
    """A copy of the port under ``root / kernel`` with ``kernel``'s fault."""
    dest = root / kernel
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copy2(REPO / "chip_smoke.py", dest / "chip_smoke.py")
    shutil.copytree(REPO / "dmlc_tpu_torch", dest / "dmlc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = dest / "dmlc_tpu_torch" / "csrc" / f"{kernel}.cu"
    text = src.read_text()
    old, new = FAULTS[kernel]
    if text.count(old) != 1:
        raise RuntimeError(f"{src.name}: the loop to break is not there once: {old!r}")
    src.write_text(text.replace(old, new))
    return dest


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[1]).resolve()
    if root == REPO or REPO in root.parents:
        print("flash_fault_check: SCRATCH_DIR must lie outside the checkout", file=sys.stderr)
        return 2
    missed = []
    for kernel in FAULTS:
        dest = plant(kernel, root)
        run = subprocess.run([sys.executable, "-c", CHECK], cwd=dest, capture_output=True,
                             text=True, timeout=900)
        lines = (run.stderr.strip() or run.stdout.strip()).splitlines()
        caught = run.returncode != 0 and "AssertionError: flash" in run.stderr
        print(json.dumps({"fault": kernel, "caught": caught, "rc": run.returncode,
                          "message": lines[-1] if lines else ""}), flush=True)
        if not caught:
            missed.append(kernel)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
