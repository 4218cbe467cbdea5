#!/usr/bin/env python3
"""Times the design levers of the bf16 flash_bwd_dq kernel, one at a time.

    python3 dmlc_tpu_torch/tools/flash_dq_levers.py SCRATCH_DIR [--parent FILE] [VARIANT ...]

Runs the variants named (default: ORDER) in turn. Each run copies
chip_smoke.py and dmlc_tpu_torch/ (without its build directory) into
SCRATCH_DIR/<n>_<variant>. The copy's csrc/flash_bwd_dq.cu is the
checkout's with the lines of LEVERS[variant] replaced; with --parent, FILE
is an earlier flash_bwd_dq.cu that replaces the file whole (the variant
"parent"), run first and last so that drift between runs shows. The
copy is built, its kernels must pass ``chip_smoke.flash_check`` in bf16 at
the LM train shape (causal) and at S 193 and 1000 (causal and not), and
``chip_smoke.kernel_device_ms`` times flash_bwd_dq at the train shape
(three readings of 20 calls).

Prints one JSON line per run: device ms, dq's errors at the train shape,
registers and spills (ptxas) and HGMMA/UTMALDG counts (SASS) of the bf16
kernel, or the failure's last line. Exits non-zero if a run fails. Needs a
CUDA device and nvcc; the checkout it is run from is only read.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

KEYS_128 = ("constexpr int kDqBQ = 128, kDqBK = 64;",
            "constexpr int kDqBQ = 128, kDqBK = 128;")
NO_OVERLAP = ("  wgmma_wait<1>();\n", "  wgmma_wait<0>();\n")
CALL = """      dq_tile<kDqBK>(dqr, Qw, dOw, Kt, Vt, &full_v[s], ph, lse2, dlt, k0, qi0, S, causal, edge,
                     scale_log2);
"""
HALF = (CALL, """      if (causal && k0 + kDqBK / 2 > row0 + 63)  // the upper half is past every row
        dq_tile<kDqBK / 2>(dqr, Qw, dOw, Kt, Vt, &full_v[s], ph, lse2, dlt, k0, qi0, S, causal,
                           edge, scale_log2);
      else
""" + CALL)
LAST_SKIP = ("    mbar_wait(bar_q, 0);\n    for (int j = 0; j < n_k; ++j) {",
             "    mbar_wait(bar_q, 0);\n"
             "    const int n_own = causal ? min(n_k, (row0 + 64 + kDqBK - 1) / kDqBK) : n_k;\n"
             "    for (int j = 0; j < n_own; ++j) {")

#: a: 128-key K/V tiles, P made while dP is multiplied, every tile whole;
#: a0: a with S and dP waited for together; b: 64-key tiles (the checkout's
#: source); c: a with warpgroup 0 multiplying only the visible half of the
#: diagonal tile; bc: b with warpgroup 0 stopping before the last tile,
#: whose keys all lie past its rows.
LEVERS = {
    "a": (KEYS_128,),
    "a0": (KEYS_128, NO_OVERLAP),
    "b": (),
    "c": (KEYS_128, HALF),
    "bc": (LAST_SKIP,),
}
ORDER = ("a", "a0", "b", "c", "bc", "b", "a")

RUN = """
import json, torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build, flash as FL
_build.build(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
log = _build.build_log["flash_bwd_dq"]
marker = "_sm90" if "_sm90" in log else "__nv_bfloat16"
report = {"ptxas": cs.ptxas_entry(log, marker),
          "sass": cs.sass_counts(_build.library_path("flash_bwd_dq"), marker)}
for shape, causal in ((cs.TRAIN_SHAPE, True), ((2, 3, 193, 128), False),
                      ((2, 3, 193, 128), True), ((1, 2, 1000, 128), False),
                      ((1, 2, 1000, 128), True)):
    check = cs.flash_check(shape, torch.bfloat16, causal)
    report.setdefault("dq_train", {k: check["dq"][k] for k in ("rel_l2", "row_rel_max")})
q, k, v, do = cs.flash_operands(cs.TRAIN_SHAPE, torch.bfloat16, seed=12)
kw = {"causal": True, "scale": cs.TRAIN_SHAPE[3] ** -0.5}
out, lse = FL.flash_forward(q, k, v, **kw)
delta = (out.float() * do.float()).sum(-1, keepdim=True)
report["device_ms"] = [
    cs.kernel_device_ms(lambda: FL.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                        "flash_bwd_dq_kernel", calls=20) for _ in range(3)]
report["card"] = torch.cuda.get_device_name(0)
print(json.dumps(report))
"""


def variant_source(name: str, parent: str | None) -> str:
    """flash_bwd_dq.cu of variant ``name``."""
    if name == "parent":
        return parent
    text = (REPO / "dmlc_tpu_torch" / "csrc" / "flash_bwd_dq.cu").read_text()
    for old, new in LEVERS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"flash_bwd_dq.cu: the text of lever {name} is not there once: "
                               f"{old!r}")
        text = text.replace(old, new)
    return text


def copy_port(dest: Path, source: str) -> None:
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copy2(REPO / "chip_smoke.py", dest / "chip_smoke.py")
    shutil.copytree(REPO / "dmlc_tpu_torch", dest / "dmlc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (dest / "dmlc_tpu_torch" / "csrc" / "flash_bwd_dq.cu").write_text(source)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scratch")
    ap.add_argument("--parent", type=Path)
    ap.add_argument("variants", nargs="*", default=list(ORDER), help=f"of {list(LEVERS)}")
    args = ap.parse_args(argv[1:])
    unknown = [v for v in args.variants if v not in LEVERS]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {list(LEVERS)}")
    root = Path(args.scratch).resolve()
    if root == REPO or REPO in root.parents:
        print("flash_dq_levers: SCRATCH_DIR must lie outside the checkout", file=sys.stderr)
        return 2
    parent = args.parent.read_text() if args.parent else None
    runs = ("parent",) * bool(parent) + tuple(args.variants) + ("parent",) * bool(parent)
    failed = []
    for i, name in enumerate(runs):
        dest = root / f"{i}_{name}"
        copy_port(dest, variant_source(name, parent))
        run = subprocess.run([sys.executable, "-c", RUN], cwd=dest, capture_output=True,
                             text=True, timeout=900)
        lines = run.stdout.strip().splitlines()
        if run.returncode == 0 and lines:
            result = json.loads(lines[-1])
        else:
            err = run.stderr.strip().splitlines()
            result = {"rc": run.returncode, "message": err[-1] if err else ""}
            failed.append(name)
        print(json.dumps({"run": i, "variant": name, **result}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
