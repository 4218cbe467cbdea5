#!/usr/bin/env python3
"""Times chip_smoke.py's LM train leg on two trees in turns, in one call.

    python3 dmlc_tpu_torch/tools/train_ab.py PARENT_DIR [--rounds N]

PARENT_DIR is an earlier checkout (or ``git archive`` of one) holding
chip_smoke.py and dmlc_tpu_torch/. Runs ``chip_smoke.phase_train`` (after
its device and build phases) in one process per turn, from PARENT_DIR and
from this checkout alternately: parent, this, this, parent, repeated N
times (default 1). Prints one JSON line per turn: step p50 and mean, the
traced step's device ms by class (flash, GEMMs, rest) and the loss after
10 steps. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

RUN = """
import json, chip_smoke as cs
d = cs.phase_device()
cs.phase_build()
r = cs.phase_train(d)
print("AB " + json.dumps({"step_ms_p50": r["step_ms_p50"], "step_ms_mean": r["step_ms_mean"],
                          "device_ms_by_class": r["traced_step"]["device_ms_by_class"],
                          "loss_after": r["loss_after"], "nvidia_smi": d["nvidia_smi"]}))
"""


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv[1:])
    trees = [("parent", args.parent.resolve()), ("this", REPO)]
    order = [trees[0], trees[1], trees[1], trees[0]] * args.rounds
    for turn, (name, root) in enumerate(order):
        run = subprocess.run([sys.executable, "-c", RUN], cwd=root, capture_output=True,
                             text=True, timeout=900)
        lines = [ln[3:] for ln in run.stdout.splitlines() if ln.startswith("AB ")]
        if run.returncode != 0 or not lines:
            err = run.stderr.strip().splitlines()
            print(json.dumps({"turn": turn, "tree": name, "rc": run.returncode,
                              "message": err[-1] if err else ""}), flush=True)
            return 1
        print(json.dumps({"turn": turn, "tree": name, **json.loads(lines[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
