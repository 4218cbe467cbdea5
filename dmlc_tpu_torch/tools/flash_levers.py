#!/usr/bin/env python3
"""Times design variants (levers) of the flash kernels, one at a time.

    python3 dmlc_tpu_torch/tools/flash_levers.py SCRATCH_DIR GROUP [--parent CSRC_DIR] [VARIANT ...]

GROUP names a table of GROUPS: ``dq`` (the bf16 flash_bwd_dq kernel, timed
at the LM train shape), ``f32`` (the float32 forward and dK/dV) or
``dq_f32`` (the float32 flash_bwd_dq), both timed at the train shape and at
its Dh-64 twin. Runs the group's variants named
(default: its ORDER) in turn. Each run copies chip_smoke.py and
dmlc_tpu_torch/ (without its build directory) into SCRATCH_DIR/<n>_<variant>;
each csrc source a variant patches is the checkout's with those pieces of
text replaced. With --parent (repeatable), CSRC_DIR is an earlier csrc/
whose sources and headers replace the copy's whole (the variant
"parent<j>"), run first and last so that drift between runs shows. The
copy is built; the group's kernels must pass ``chip_smoke.flash_check`` in
the group's dtype at the LM train shape (causal), at S 193 and 1000
(causal and not) and at each timed shape, and ``chip_smoke.kernel_device_ms``
times each of them at each timed shape (three readings of 20 calls). A
parent without a timed shape's head dim reports the error for that shape.

Prints one JSON line per run: device ms, the errors at the train shape, and
registers and spills (ptxas) of the group's kernels in its dtype, with
HGMMA/UTMALDG counts (SASS) in bf16; or the failure's last line. Exits
non-zero if a run fails. Needs a CUDA device and nvcc; the checkout it is
run from is only read.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

REPO = Path(__file__).resolve().parents[2]
TRAIN_SHAPE = (8, 6, 2048, 128)
DH64_SHAPE = (8, 12, 2048, 64)


class Group(NamedTuple):
    dtype: str                # checked and timed in this dtype
    kernels: tuple[str, ...]  # csrc/<kernel>.cu, each checked and timed
    shapes: tuple             # timed shapes, causal
    levers: dict              # variant -> {kernel: [(old, new), ...]}
    order: tuple              # the variants run by default


# flash_bwd_dq (bf16). a: 128-key K/V tiles, P made while dP is multiplied,
# every tile whole; a0: a with S and dP waited for together; b: 64-key tiles
# (the checkout's source); c: a with warpgroup 0 multiplying only the
# visible half of the diagonal tile; bc: b with warpgroup 0 stopping before
# the last tile, whose keys all lie past its rows.
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

# float32 forward and dK/dV. ship: the checkout's sources (the forward's
# 2-stage K/V ring; dK/dV's Q/dO ring at Dh 128, one stage at Dh 64);
# sync: one stage for both (each tile loaded after the products of the one
# before); ring: dK/dV's 2-stage ring at Dh 64 too; rows128: the forward
# with 128-row Q tiles (256 threads, one block an SM at Dh 128); keys64:
# dK/dV with 64-key blocks (the same); quad: dK/dV's S^T and dP^T with a
# warp's lanes on 4 keys x 8 queries, so a warp's 16-byte load reads 4 K
# rows or 8 Q rows in one wavefront, P^T and dS^T then passed to other warps
# through a block barrier.
FWD_SYNC = [
    ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 1;"),
    ("    if (j + 1 < n_k) load_kv(j + 1, (j + 1) % kFwdStages);\n", ""),
    ("    __syncthreads();  // every reader of this stage and of P is done\n",
     "    __syncthreads();  // every reader of this stage and of P is done\n"
     "    if (j + 1 < n_k) load_kv(j + 1, 0);\n"),
]
DKV_STAGES = "  static constexpr int kStages = DH == 64 ? 1 : 2;\n"
QUAD = [
    ("  static constexpr int LDP = BQ + 4;   // P^T, dS^T rows\n",
     "  static constexpr int LDP = BQ + 8;   // P^T, dS^T rows\n"),
    ("  static_assert(BK * BQ == 8 * C::kThreads, \"S^T is 4 keys x 2 queries a thread\");\n",
     "  static_assert(BK * BQ == 8 * C::kThreads, \"S^T is 4 keys x 2 queries a thread\");\n"
     "  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
     "  const int sk0 = 16 * (warp % (BK / 16)) + lane / 8;\n"
     "  const int sq0 = 16 * (warp / (BK / 16)) + lane % 8;\n"),
    ("        bq[u] = ld4(Qt + (c + 16 * u) * LD + kk);\n"
     "        bo[u] = ld4(dOt + (c + 16 * u) * LD + kk);\n",
     "        bq[u] = ld4(Qt + (sq0 + 8 * u) * LD + kk);\n"
     "        bo[u] = ld4(dOt + (sq0 + 8 * u) * LD + kk);\n"),
    ("        const float4 a = ld4(Ks + (g + G * i) * LD + kk);\n"
     "        const float4 a2 = ld4(Vs + (g + G * i) * LD + kk);\n",
     "        const float4 a = ld4(Ks + (sk0 + 4 * i) * LD + kk);\n"
     "        const float4 a2 = ld4(Vs + (sk0 + 4 * i) * LD + kk);\n"),
    ("      const int row = g + G * i, key = k0 + row;\n",
     "      const int row = sk0 + 4 * i, key = k0 + row;\n"),
    ("        const int col = c + 16 * u, qi = q0 + col;\n",
     "        const int col = sq0 + 8 * u, qi = q0 + col;\n"),
    ("    __syncwarp();  // P^T and dS^T rows are written and read by one half-warp\n",
     "    __syncthreads();  // P^T and dS^T for every thread\n"),
]

# float32 flash_bwd_dq. ship: the checkout's source (64-row Q tiles, 128
# threads; K/V tiles of 64 keys at Dh 64 and 32 at Dh 128, one stage: each
# tile loaded after the products of the one before); ring: a 2-stage K/V
# ring, the next tile loading while this one is multiplied; rows32: 32-row
# Q tiles, 4 rows a row group (128 threads); keys32 and keys64: 32-key and
# 64-key K/V tiles at both head dims.
DQ_KEYS = "BK = DH == 64 ? 64 : 32,"
DQ_F32 = {
    "ship": {},
    "ring": {"flash_bwd_dq": [("constexpr int kDqStages = 1;", "constexpr int kDqStages = 2;")]},
    "rows32": {"flash_bwd_dq": [("constexpr int kDqRows = 64;", "constexpr int kDqRows = 32;"),
                                ("constexpr int kDqRowsPerThread = 8;",
                                 "constexpr int kDqRowsPerThread = 4;")]},
    "keys32": {"flash_bwd_dq": [(DQ_KEYS, "BK = 32,")]},
    "keys64": {"flash_bwd_dq": [(DQ_KEYS, "BK = 64,")]},
}

GROUPS = {
    "dq": Group("bfloat16", ("flash_bwd_dq",), (TRAIN_SHAPE,), {
        "a": {"flash_bwd_dq": [KEYS_128]},
        "a0": {"flash_bwd_dq": [KEYS_128, NO_OVERLAP]},
        "b": {},
        "c": {"flash_bwd_dq": [KEYS_128, HALF]},
        "bc": {"flash_bwd_dq": [LAST_SKIP]},
    }, ("a", "a0", "b", "c", "bc", "b", "a")),
    "f32": Group("float32", ("flash_fwd", "flash_bwd_dkv"), (TRAIN_SHAPE, DH64_SHAPE), {
        "ship": {},
        "sync": {"flash_fwd": FWD_SYNC,
                 "flash_bwd_dkv": [(DKV_STAGES, DKV_STAGES.replace("DH == 64 ? 1 : 2", "1"))]},
        "ring": {"flash_bwd_dkv": [(DKV_STAGES, DKV_STAGES.replace("DH == 64 ? 1 : 2", "2"))]},
        "rows128": {"flash_fwd": [("constexpr int kFwdRows = 64;",
                                   "constexpr int kFwdRows = 128;")]},
        "keys64": {"flash_bwd_dkv": [("constexpr int kDkvKeys = 32;",
                                      "constexpr int kDkvKeys = 64;")]},
        "quad": {"flash_bwd_dkv": QUAD},
    }, ("ship", "sync", "ring", "rows128", "keys64", "quad", "ship")),
    "dq_f32": Group("float32", ("flash_bwd_dq",), (TRAIN_SHAPE, DH64_SHAPE), DQ_F32,
                    ("ship", "ring", "rows32", "keys32", "keys64", "ship")),
}

RUN = """
import json, sys, torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build, flash as FL
dtype, kernels, shapes = json.loads(sys.argv[1])
dt = getattr(torch, dtype)
_build.build(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
report = {"card": torch.cuda.get_device_name(0)}
for name in kernels:
    entries = {}
    for mangled, e in cs.ptxas_entries(_build.build_log[name]).items():
        inst = cs.flash_instance(mangled)
        if inst is not None and inst[0] != dtype:
            continue
        if dtype == "bfloat16":
            e["sass"] = cs.sass_counts(_build.library_path(name), mangled)
        entries[f"dh{inst[1]}" if inst else mangled[:60]] = e
    report[name] = entries
for shape, causal in ((cs.TRAIN_SHAPE, True), ((2, 3, 193, 128), False),
                      ((2, 3, 193, 128), True), ((1, 2, 1000, 128), False),
                      ((1, 2, 1000, 128), True)):
    check = cs.flash_check(shape, dt, causal)
    report.setdefault("train_errors", {n: [check[n]["rel_l2"], check[n]["row_rel_max"]]
                                       for n in ("out", "dq", "dk", "dv")})
CALLS = {"flash_fwd": lambda a, kw: FL.flash_forward(*a[:3], **kw),
         "flash_bwd_dq": lambda a, kw: FL.flash_bwd_dq(*a, **kw),
         "flash_bwd_dkv": lambda a, kw: FL.flash_bwd_dkv(*a, **kw)}
for shape in map(tuple, shapes):
    q, k, v, do = cs.flash_operands(shape, dt, seed=12)
    kw = {"causal": True, "scale": shape[3] ** -0.5}
    try:
        out, lse = FL.flash_forward(q, k, v, **kw)
    except (ValueError, RuntimeError) as e:  # an earlier source without this head dim
        report[f"dh{shape[3]}"] = str(e)[:120]
        continue
    if shape != cs.TRAIN_SHAPE:
        cs.flash_check(shape, dt, True)
    args = (q, k, v, do, lse, (out.float() * do.float()).sum(-1, keepdim=True))
    report[f"dh{shape[3]}"] = {
        f"{name}_ms": [cs.kernel_device_ms(lambda: CALLS[name](args, kw), name, calls=20)
                       for _ in range(3)] for name in kernels}
print(json.dumps(report))
"""


def variant_sources(group: str, name: str, parent: Path | None = None) -> dict[str, str]:
    """The csrc files of ``group``'s variant ``name`` that differ from the
    checkout's (or, for a parent, all of its csrc/), by file name."""
    if parent is not None:
        return {f.name: f.read_text() for f in parent.iterdir() if f.suffix in (".cu", ".cuh")}
    out = {}
    for kernel, pieces in GROUPS[group].levers[name].items():
        text = (REPO / "dmlc_tpu_torch" / "csrc" / f"{kernel}.cu").read_text()
        for old, new in pieces:
            if text.count(old) != 1:
                raise RuntimeError(f"{kernel}.cu: the text of lever {name} is not there once: "
                                   f"{old!r}")
            text = text.replace(old, new)
        out[f"{kernel}.cu"] = text
    return out


def copy_port(dest: Path, sources: dict[str, str]) -> None:
    """chip_smoke.py and dmlc_tpu_torch/ (without its build) into ``dest``,
    with the csrc files of ``sources`` (file name -> text) replaced."""
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copy2(REPO / "chip_smoke.py", dest / "chip_smoke.py")
    shutil.copytree(REPO / "dmlc_tpu_torch", dest / "dmlc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, text in sources.items():
        (dest / "dmlc_tpu_torch" / "csrc" / name).write_text(text)


def outside_checkout(scratch: str) -> Path | None:
    """``scratch`` resolved, or None where it lies in the checkout."""
    root = Path(scratch).resolve()
    return None if root == REPO or REPO in root.parents else root


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scratch")
    ap.add_argument("group", choices=sorted(GROUPS))
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an earlier csrc/; may be given more than once")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_intermixed_args(argv[1:])
    group = GROUPS[args.group]
    variants = args.variants or list(group.order)
    unknown = [v for v in variants if v not in group.levers]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {list(group.levers)}")
    root = outside_checkout(args.scratch)
    if root is None:
        print("flash_levers: SCRATCH_DIR must lie outside the checkout", file=sys.stderr)
        return 2
    spec = json.dumps([group.dtype, group.kernels, group.shapes])
    parents = [(f"parent{j}", d) for j, d in enumerate(args.parent)]
    runs = parents + [(v, None) for v in variants] + parents[::-1]
    failed = []
    for i, (name, parent) in enumerate(runs):
        dest = root / f"{i}_{name}"
        copy_port(dest, variant_sources(args.group, name, parent))
        run = subprocess.run([sys.executable, "-c", RUN, spec], cwd=dest, capture_output=True,
                             text=True, timeout=900)
        lines = run.stdout.strip().splitlines()
        if run.returncode == 0 and lines:
            result = json.loads(lines[-1])
        else:
            err = run.stderr.strip().splitlines()
            result = {"rc": run.returncode, "message": err[-1] if err else ""}
            failed.append(name)
        print(json.dumps({"run": i, "group": args.group, "variant": name,
                          "parent": str(parent or ""), **result}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
