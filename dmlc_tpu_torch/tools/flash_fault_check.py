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
  Dh-64 instantiation shares;
- flash_fwd_dh256 (bf16, head dim 256, [8, 3, 2048, 256]): the same fault
  in the Dh-256 instantiation (its K/V tiles take 64 keys);
- flash_fwd_s_chunk (bf16, head dim 256): S = Q K^T skips its last 64
  columns of Dh (the last four k16 steps) past head dim 128;
- flash_bwd_dkv_dh256 (bf16, head dim 256): the fault of flash_bwd_dkv in
  the split layout (64-key blocks): the last block skips its last Q tile;
- flash_bwd_dkv_swap (bf16, head dim 256): the split layout's warpgroups
  write their accumulators to each other's output (dV to dk, dK to dv);
- flash_bwd_dq_dh256 (bf16, head dim 256): the fault of flash_bwd_dq in
  the Dh-256 instantiation (64-key K/V tiles, V in one stage);
- flash_bwd_dq_box (bf16, head dim 256): dQ += dS K takes K's 64-column
  boxes at twice their distance past head dim 128, so dQ's columns [64,
  128) read K's [128, 192) and the second accumulator reads past the tile;
- flash_fwd_f32_dh256 (float32, head dim 256): the fault of flash_fwd_f32
  in the Dh-256 instantiation (two parts of 128 threads);
- flash_bwd_dq_f32_dh256 (float32, head dim 256): the fault of
  flash_bwd_dq_f32 in the Dh-256 instantiation (dQ 128 floats a thread);
- flash_bwd_dkv_f32_dh256 (float32, head dim 256): the fault of
  flash_bwd_dkv_f32 in the Dh-256 instantiation (one part, dK and dV 128
  floats a thread);
- flash_bwd_dkv_f32_dh192 (float32, head dim 192): the last 32-key block
  of the two-part kernel, which only Dh 192 runs, skips its last Q tile;
- flash_bwd_dkv_f32_handoff (float32, head dim 192): part 1 of the
  two-part dK/dV makes dS^T from the P^T of the neighbouring key (row g ^
  1 of the handed tile);
- flash_bwd_dq_f32_dh192 (float32, head dim 192, [8, 4, 2048, 192]): the
  one-part dQ, which Dh 192 runs with three float4 columns a thread,
  stores its third column chunk over the first;
- flash_fwd_dh512 (bf16, head dim 512, [4, 4, 1024, 512]): the forward
  past Dh 256 (64-row Q tiles, 32-key K/V tiles): the last Q tile skips its
  last K/V tile, in the producer and both consumer warpgroups;
- flash_fwd_s_add (bf16, head dim 320, [4, 4, 1024, 320]): its warpgroups
  add each other's partial S only to the first 16 keys of each tile;
- flash_fwd_f32_dh512 (float32, head dim 512): the fault of flash_fwd_f32
  in the Dh-512 instantiation (32-row Q tiles, two parts of 256 columns);
- flash_fwd_f32_s_add (float32, head dim 320): the two parts add each
  other's partial S only to their keys c, not c + 16 (the uneven split:
  192 and 128 columns of O);
- flash_bwd_dq_f32_dh512 (float32, head dim 512, S 193, [2, 3, 193,
  512]): the float32 dQ past Dh 256 (two parts, 32-row Q tiles, 32-key
  tiles, V and then K through one slot past 384): the last Q tile skips
  its last K/V tile (key 192);
- flash_bwd_dq_f32_dp_add (float32, head dim 320): each part adds the
  other's partial dP of the neighbouring row (g ^ 1) to its own;
- flash_bwd_dq_f32_last_step (float32, head dim 320): part 1 stores its
  first 64-column step of dQ in place of its last (dQ's columns [256,
  320));
- flash_bwd_dkv_f32_dh320 (float32, head dim 320, S 193): the float32
  dK/dV's column split (up to Dh 384): the last key block skips its last
  Q tile;
- flash_bwd_dkv_f32_dp_add (float32, head dim 320): the column split adds
  the other part's partial dP^T of the neighbouring key (kr ^ 1);
- flash_bwd_dkv_f32_last_step (float32, head dim 320): in the column
  split, part 1 adds dS^T Q with Q's first 64 columns of its share in
  place of its last ones (dK's columns [256, 320));
- flash_bwd_dkv_f32_dh512 (float32, head dim 512, S 193): the two-part
  roles kernel past 384 (32-key blocks, 16-row Q tiles): the last key
  block skips its last Q tile;
- flash_bwd_dkv_f32_handoff_dh512 (float32, head dim 512): the fault of
  flash_bwd_dkv_f32_handoff in the Dh-512 instantiation.

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
from flash_levers import (DH64_SHAPE, REPO, TRAIN_SHAPE, WIDE192_SHAPE,  # noqa: E402
                          WIDE256_SHAPE, WIDE320_SHAPE, WIDE512_SHAPE, copy_port,
                          outside_checkout)


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

DQ_SM90 = ("  return ((causal ? min(q0 + kDqBQ, S) : S) + kDqBK - 1) / kDqBK;",
           "  return ((causal ? min(q0 + kDqBQ, S) : S) + kDqBK - 1) / kDqBK"
           " - (q0 + kDqBQ >= S ? 1 : 0);")
DQ_BOX = ("  for (int kk = 0; kk < NK / 16; ++kk) dq.mma(dsa[kk], Kt + kk * 16 * 128, BK * 128);",
          "  for (int kk = 0; kk < NK / 16; ++kk)"
          " dq.mma(dsa[kk], Kt + kk * 16 * 128, BK * 128 * (DH > 128 ? 2 : 1));")
# The float32 dK/dV's count of Q tiles (one part).
DKV_F32 = ("  const int q_tiles = (S + C::BQ - 1) / C::BQ;",
           "  const int q_tiles = (S + C::BQ - 1) / C::BQ - (k0 + C::BK >= S ? 1 : 0);")
# The float32 forward's and dQ's count of K/V tiles (fwd_tiles, dq_tiles).
FWD_F32 = ("  return ((causal ? min(q0 + C::BQ, S) : S) + C::BK - 1) / C::BK;",
           "  return ((causal ? min(q0 + C::BQ, S) : S) + C::BK - 1) / C::BK"
           " - (q0 + C::BQ >= S ? 1 : 0);")
DKV_SM90 = ("  const int t_end = (S + kDkvBQ - 1) / kDkvBQ;",
            "  const int t_end = (S + kDkvBQ - 1) / kDkvBQ - (k0 + kDkvBK >= S ? 1 : 0);")
S_CHUNK = ("      for (int kk = 0; kk < DH / 16; ++kk) {\n        const uint32_t aq",
           "      for (int kk = 0; kk < DH / 16 - (DH > 128 ? 4 : 0); ++kk) {\n"
           "        const uint32_t aq")
FWD_WIDE = ("  return ((causal ? min(q0 + kWideBQ, S) : S) + BK - 1) / BK;",
            "  return ((causal ? min(q0 + kWideBQ, S) : S) + BK - 1) / BK"
            " - (q0 + kWideBQ >= S ? 1 : 0);")
S_ADD = ("      for (int v = 0; v < BK / 8; ++v) {\n        const float4 x = theirs[v * 128 + t];",
         "      for (int v = 0; v < BK / 16; ++v) {\n        const float4 x = theirs[v * 128 + t];")
F32_ADD = "        for (int u = 0; u < {}; ++u) s[i][u] += Pp[(g + G * i) * LDP + c + 16 * u];"
S_ADD_F32 = (F32_ADD.format("NKT"), F32_ADD.format("NKT - 1"))
# The float32 dK/dV's two-part kernel (Dh 192, and past 256).
DKV_PARTS_TILES = ("  const int q_tiles = (S + BQ - 1) / BQ;",
                   "  const int q_tiles = (S + BQ - 1) / BQ - (k0 + BK >= S ? 1 : 0);")
DKV_HANDOFF = ("          dST[kr * LDP + qc] = PT[kr * LDP + qc] * (sc[i][u] - delta_s[qc]);",
               "          dST[kr * LDP + qc] = PT[(kr ^ 1) * LDP + qc] * (sc[i][u] - delta_s[qc]);")
# The float32 dQ and dK/dV past Dh 256 at a ragged length.
XL_RAGGED320, XL_RAGGED512 = (2, 3, 193, 320), (2, 3, 193, 512)
SWAP = ("      acc.store(1.f, 1.f, Ks, kDkvBK, 0, dv + base, k0, S, 1);\n    else\n"
        "      acc.store(scale, scale, Vs, kDkvBK, 0, dk + base, k0, S, 2);",
        "      acc.store(1.f, 1.f, Ks, kDkvBK, 0, dk + base, k0, S, 1);\n    else\n"
        "      acc.store(scale, scale, Vs, kDkvBK, 0, dv + base, k0, S, 2);")

FAULTS = {
    "flash_fwd": Fault("flash_fwd", *FWD_SM90, "bfloat16", TRAIN_SHAPE),
    "flash_bwd_dq": Fault("flash_bwd_dq", *DQ_SM90, "bfloat16", TRAIN_SHAPE),
    "flash_bwd_dkv": Fault("flash_bwd_dkv", *DKV_SM90, "bfloat16", TRAIN_SHAPE),
    "flash_fwd_f32": Fault("flash_fwd", *FWD_F32, "float32", TRAIN_SHAPE),
    "flash_bwd_dq_f32": Fault("flash_bwd_dq", *FWD_F32, "float32", TRAIN_SHAPE),
    "flash_bwd_dkv_f32": Fault("flash_bwd_dkv", *DKV_F32, "float32", TRAIN_SHAPE),
    "flash_fwd_dh64": Fault("flash_fwd", *FWD_SM90, "bfloat16", DH64_SHAPE),
    "flash_fwd_dh256": Fault("flash_fwd", *FWD_SM90, "bfloat16", WIDE256_SHAPE),
    "flash_fwd_s_chunk": Fault("flash_fwd", *S_CHUNK, "bfloat16", WIDE256_SHAPE),
    "flash_bwd_dkv_dh256": Fault("flash_bwd_dkv", *DKV_SM90, "bfloat16", WIDE256_SHAPE),
    "flash_bwd_dkv_swap": Fault("flash_bwd_dkv", *SWAP, "bfloat16", WIDE256_SHAPE),
    "flash_bwd_dq_dh256": Fault("flash_bwd_dq", *DQ_SM90, "bfloat16", WIDE256_SHAPE),
    "flash_bwd_dq_box": Fault("flash_bwd_dq", *DQ_BOX, "bfloat16", WIDE256_SHAPE),
    "flash_fwd_f32_dh256": Fault("flash_fwd", *FWD_F32, "float32", WIDE256_SHAPE),
    "flash_bwd_dq_f32_dh256": Fault("flash_bwd_dq", *FWD_F32, "float32", WIDE256_SHAPE),
    "flash_bwd_dkv_f32_dh256": Fault("flash_bwd_dkv", *DKV_F32, "float32", WIDE256_SHAPE),
    "flash_bwd_dkv_f32_dh192": Fault("flash_bwd_dkv", *DKV_PARTS_TILES, "float32", WIDE192_SHAPE),
    "flash_bwd_dkv_f32_handoff": Fault("flash_bwd_dkv", *DKV_HANDOFF, "float32", WIDE192_SHAPE),
    "flash_bwd_dq_f32_dh192": Fault(
        "flash_bwd_dq",
        "        *reinterpret_cast<float4*>(dq + base + (size_t)qi * DH + 64 * h + 4 * c) =",
        "        *reinterpret_cast<float4*>(dq + base + (size_t)qi * DH + 64 * (h % 2) + 4 * c) =",
        "float32", WIDE192_SHAPE),
    "flash_fwd_dh512": Fault("flash_fwd", *FWD_WIDE, "bfloat16", WIDE512_SHAPE),
    "flash_fwd_s_add": Fault("flash_fwd", *S_ADD, "bfloat16", WIDE320_SHAPE),
    "flash_fwd_f32_dh512": Fault("flash_fwd", *FWD_F32, "float32", WIDE512_SHAPE),
    "flash_fwd_f32_s_add": Fault("flash_fwd", *S_ADD_F32, "float32", WIDE320_SHAPE),
    "flash_bwd_dq_f32_dh512": Fault("flash_bwd_dq", *FWD_F32, "float32", XL_RAGGED512),
    "flash_bwd_dq_f32_dp_add": Fault(
        "flash_bwd_dq",
        "        dp[i][u] += Xother[(2 * BQ + g + G * i) * LDS + c + 16 * u];",
        "        dp[i][u] += Xother[(2 * BQ + (g ^ 1) + G * i) * LDS + c + 16 * u];",
        "float32", WIDE320_SHAPE),
    "flash_bwd_dq_f32_last_step": Fault(
        "flash_bwd_dq", "        const float* a = acc[i][h];",
        "        const float* a = acc[i][part && h == NC4 - 1 ? 0 : h];", "float32", WIDE320_SHAPE),
    "flash_bwd_dkv_f32_dh320": Fault(
        "flash_bwd_dkv", "  const int t_end = (S + BQ - 1) / BQ;",
        "  const int t_end = (S + BQ - 1) / BQ - (k0 + BK >= S ? 1 : 0);", "float32", XL_RAGGED320),
    "flash_bwd_dkv_f32_dp_add": Fault(
        "flash_bwd_dkv",
        "        const float dp_t = dpt[i][u] + PT[(2 * BK + kr) * LDP + qc];",
        "        const float dp_t = dpt[i][u] + PT[(2 * BK + (kr ^ 1)) * LDP + qc];",
        "float32", WIDE320_SHAPE),
    "flash_bwd_dkv_f32_last_step": Fault(
        "flash_bwd_dkv",
        "          bq[h] = ld4(Qt + (qq + e) * LD + col0 + 64 * h + 4 * c);",
        "          bq[h] = ld4(Qt + (qq + e) * LD + col0 + 64 * (part && h == NC4 - 1 ? 0 : h)"
        " + 4 * c);", "float32", WIDE320_SHAPE),
    "flash_bwd_dkv_f32_dh512": Fault("flash_bwd_dkv", *DKV_PARTS_TILES, "float32", XL_RAGGED512),
    "flash_bwd_dkv_f32_handoff_dh512": Fault("flash_bwd_dkv", *DKV_HANDOFF, "float32",
                                             WIDE512_SHAPE),
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
