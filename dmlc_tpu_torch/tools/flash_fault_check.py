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
  flash_bwd_dkv_f32_handoff in the Dh-512 instantiation;
- the forward past 512, which takes the head dim at run time and cuts O
  into column chunks (bf16 flash_fwd_xl_*, float32 flash_fwd_f32_xl_*):
  _tiles (head dim 640, [4, 4, 1024, 640]): the last Q tile's count of K/V
  tiles one short (in bf16 the producer's and both consumers'); _s_drop
  (640): the other warpgroup's (part's) partial S dropped from half of
  each tile's keys; _chunk_shift (bf16 at 640, float32 at 1024, S 193, the
  widths where they cut O in two chunks): chunk 1 stores its columns one
  64-column box to the right; _lse_chunk (bf16 at 328, S 193, which the
  wrapper takes as one chunk; float32 at 640, S 193, one chunk): lse
  written by the block of chunk 1 in place of chunk 0, so no block writes
  it (where there are two, both hold the same m and l: harmless by
  design); _pad ([4, 4, 1024, 520]): the last 64-column slab of Q and K
  not zeroed past Dh (bf16: csrc/flash_sm90.cuh's encode_map gives every
  map a row of Dh rounded up to 64 columns, which changes no map of a
  head dim that is a multiple of 64; float32: the copies past Dh read the
  next row);
- the float32 dQ and dK/dV past 512, which take the head dim at run time
  and cut their output into column chunks (flash_bwd_dq_f32_xl_*,
  flash_bwd_dkv_f32_xl_*): _dp_drop (dQ, [4, 4, 1024, 640]) and _s_drop
  (dK/dV, the same shape): the other part's partial dP (dQ) or S^T (dK/dV)
  dropped from half of each tile's keys (queries); _split (dQ at 1024, S
  193, two chunks of dQ; dK/dV at 640, S 193, two chunks): in every block
  of a cluster past the first, part 1 takes its slabs of the scores one to
  the right, so the split depends on the chunk and that block's last slab
  is dropped from the scores of every chunk;
  _chunk_shift (the same shapes): chunk 1 stores its columns one 64-column
  step to the right; _ragged (640, S 193): the mask at the end of S one
  short, so the last key (dQ) or query (dK/dV) counts as past it (a mask
  one long changes nothing: the rows past S are zero-filled, and their
  products with dS or P^T vanish); _pad ([4, 4, 1024, 520]): the slabs'
  columns past Dh not zeroed (the copies read the next row).
- the bf16 dQ and dK/dV past Dh 256 (flash_bwd_dq_wide_*,
  flash_bwd_dkv_wide_*; 64-row Q tiles and 16-key K/V tiles shared by two
  warpgroups in dQ, 64-key blocks in clusters of two column chunks in
  dK/dV): _tiles ([4, 4, 1024, 512] in dQ, [2, 3, 193, 512] in dK/dV):
  the last Q tile skips its last K/V tile (dQ), the last key block its last
  Q tile (dK/dV), in the producer and both consumer warpgroups; _x_drop
  (dQ at 320): the other warpgroup's partial S and dP dropped from half of
  each tile's keys; _s_drop (dK/dV at [4, 4, 1024, 384], where it runs in
  clusters): the other block's partial S^T and dP^T dropped from half of
  each tile's queries; _shift (dQ at 320, dK/dV at 384): dQ's warpgroup 1
  stages its columns one 64-column box to the left (and copies out Q's),
  dK/dV's block of rank 1 stores its chunk one box to the left;
  _ragged ([2, 3, 193, 384]): the mask at the end of S one short, so the
  last key (dQ) or query (dK/dV) counts as past it; _pad (512): dQ's
  warpgroup 1 multiplies dS by K's boxes one to the right, its last past
  Dh, and dK/dV's block of rank 1 reads its boxes of K, V, Q and dO one to
  the right, its last past Dh (zero-filled); _rank (dK/dV at 384): each
  block pushes its partial into its own buffer in place of the other
  block's, so it adds its own partial twice.
- the bf16 dQ and dK/dV past 512, which take the head dim at run time and
  cut their output into column chunks (flash_bwd_dq_xl_*,
  flash_bwd_dkv_xl_*): _tiles ([4, 4, 1024, 640] in dQ, [2, 3, 193, 640]
  in dK/dV): the last Q tile one K/V tile short (dQ), the last key block
  one Q tile short (dK/dV), in the producer and both consumer warpgroups;
  _x_drop (640): the other warpgroup's P or dP (dQ) or the P^T handed to
  warpgroup 1 (dK/dV) dropped from half of each tile's keys (queries);
  _chunk_shift (dQ at 1024, dK/dV at 640, S 193, two chunks): chunk 1
  stores its columns one 64-column box to the right; _ragged (640, S 193): the mask at the end of
  S one short; _pad ([4, 4, 1024, 520]): the last box of every map not
  zero-filled past Dh (encode_map's row rounded up to 64 columns, as for
  the forward's _pad); _split (dQ at 1024, dK/dV at 640, S 193, two
  chunks each making the scores again): the blocks of chunks past the
  first start the scores' slabs one to the right, so they drop slab 0 and
  make other scores than chunk 0.

A paged fault runs ``chip_smoke.paged_check`` on paged_decode_attention
(csrc/paged_decode.cu) in float32 at the decode bench's geometry, head dim
128, ragged lengths:

- paged_past_length: each split reads one position past the slot's
  kv length;
- paged_page0: the first page of each split is read from page 0 in place
  of the table's id;
- paged_split_twice: the merge adds split 0 twice.

A gather fault runs ``chip_smoke.phase_kernels_gather`` on the page
gather's bulk kernel (csrc/gather_pages.cu):

- gather_last_chunk: each page's last chunk is skipped where the page is
  not a whole number of chunks (the chunk count rounds down);
- gather_read_wait: a stage is loaded again without waiting for its store
  to have read it (the wait_group.read dropped);
- gather_outside: an id outside the pool is copied from past the pool's
  ends instead of stored as zeros.

A softmax fault runs ``chip_smoke.phase_kernels_softmax`` on softmax_top1
(csrc/softmax_top1.cu), whose exact cases come first:

- softmax_merge_tie: the merge across a row group's warps takes the larger
  index on a tie;
- softmax_tail: the vector path drops the row's tail past the last whole
  16-byte vector;
- softmax_nan: a NaN loses to a number;
- softmax_pdl_wait: the kernels no longer wait (griddepcontrol.wait) for
  the grid before them on the stream, so under the programmatic launch
  they may read logits that kernel has not finished writing.

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
    source: str  # csrc/<source>.cu: the kernel checked
    old: str     # the line replaced, exactly once in the source
    new: str
    dtype: str   # the check run on the copy
    shape: tuple  # flash: [B, H, S, Dh]; paged: (geometry, Dh)
    check: str = "flash"  # a key of CHECKS
    file: str = ""  # the csrc file patched, where it is not <source>.cu


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
# The forward past 512: [4, 4, 1024, Dh] and ragged lengths.
XL640, XL520 = (4, 4, 1024, 640), (4, 4, 1024, 520)
XL_RAGGED328, XL_RAGGED640, XL_RAGGED1024 = (2, 3, 193, 328), (2, 3, 193, 640), (2, 3, 193, 1024)
XL_TILES = ("  const int end = causal ? min(q0 + {}, S) : S;  // one past the last key read",
            "  const int end = (causal ? min(q0 + {0}, S) : S) - (q0 + {0} >= S ? FwdXlCfg::BK : 0);")
XL_PAD = "  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)s, (cuuint64_t)bh};"
# The float32 dQ and dK/dV past 512: the split of the scores' slabs, the
# chunk's columns stored, and the slab copies (the same line in both).
XLB_SPLIT = ("      const int d = part * nd0 + i;", "      const int d = part * (nd0 + (b0 > 0)) + i;")
XLB_PAD = ("    cp_span<C::kThreads>(sm, ld, src + base, dh, row0, rows, S, 64 * d, 64 * nd, dh);",
           "    cp_span<C::kThreads>(sm, ld, src + base, dh, row0, rows, S, 64 * d, 64 * nd, dh + 64);")
XLB_SHIFT = ("const int col = 64 * (b0 + {}h) + 4 * c;", "const int col = 64 * (b0 + (b0 > 0) + {}h) + 4 * c;")
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
    "flash_fwd_xl_tiles": Fault("flash_fwd", *(t.format("kWideBQ") for t in XL_TILES),
                                "bfloat16", XL640),
    "flash_fwd_xl_s_drop": Fault(
        "flash_fwd", "      const float4 y = other[v * 128 + t];",
        "      const float4 y = v < BK / 16 ? other[v * 128 + t] : make_float4(0.f, 0.f, 0.f, 0.f);",
        "bfloat16", XL640),
    "flash_fwd_xl_chunk_shift": Fault("flash_fwd", "    const int gcol = 64 * b0 + col;",
                                    "    const int gcol = 64 * (b0 + (b0 > 0)) + col;",
                                    "bfloat16", XL640),
    "flash_fwd_xl_lse_chunk": Fault("flash_fwd", "    const bool writes_lse = chunk == 0 && wg == 0;",
                                    "    const bool writes_lse = chunk == 1 && wg == 0;",
                                    "bfloat16", XL_RAGGED328),
    "flash_fwd_xl_pad": Fault("flash_fwd", XL_PAD,
                              XL_PAD.replace("(cuuint64_t)dh,", "(cuuint64_t)((dh + 63) / 64 * 64),"),
                              "bfloat16", XL520, file="flash_sm90.cuh"),
    "flash_fwd_f32_xl_tiles": Fault("flash_fwd", *(t.format("FwdXlCfg::BQ") for t in XL_TILES),
                                    "float32", XL640),
    "flash_fwd_f32_xl_s_drop": Fault(
        "flash_fwd",
        "      for (int u = 0; u < NKT; ++u) s[i][u] = s[i][u] + Pp[(g + G * i) * LDP + c + 16 * u];",
        "      for (int u = 0; u < NKT - 1; ++u) s[i][u] = s[i][u] + Pp[(g + G * i) * LDP + c + 16 * u];",
        "float32", XL640),
    "flash_fwd_f32_xl_chunk_shift": Fault(
        "flash_fwd", "        const int col = 64 * (b0 + c0 + h) + 4 * c;",
        "        const int col = 64 * (b0 + (b0 > 0) + c0 + h) + 4 * c;", "float32", XL_RAGGED1024),
    "flash_fwd_f32_xl_lse_chunk": Fault(
        "flash_fwd", "  const bool writes_lse = chunk == 0 && part == 0;",
        "  const bool writes_lse = chunk == 1 && part == 0;", "float32", XL_RAGGED640),
    "flash_fwd_f32_xl_pad": Fault("flash_fwd", "    const bool ok = row0 + r < S && c0 + cc < dh;",
                                  "    const bool ok = row0 + r < S;", "float32", XL520),
    "flash_bwd_dq_f32_xl_dp_drop": Fault(
        "flash_bwd_dq", "        dp[i][u] += Xother[(2 * BQ + g + G * i) * LDX + c + 16 * u];",
        "        dp[i][u] += u < NKT - 1 ? Xother[(2 * BQ + g + G * i) * LDX + c + 16 * u] : 0.f;",
        "float32", XL640),
    "flash_bwd_dq_f32_xl_split": Fault("flash_bwd_dq", *XLB_SPLIT, "float32", XL_RAGGED1024),
    "flash_bwd_dq_f32_xl_chunk_shift": Fault(
        "flash_bwd_dq", *(" " * 8 + s.format("c0 + ") for s in XLB_SHIFT), "float32",
        XL_RAGGED1024),
    "flash_bwd_dq_f32_xl_ragged": Fault(
        "flash_bwd_dq", "          if (kj >= S || (causal && kj > qi)) pr = 0.f;",
        "          if (kj >= S - 1 || (causal && kj > qi)) pr = 0.f;", "float32", XL_RAGGED640),
    "flash_bwd_dq_f32_xl_pad": Fault("flash_bwd_dq", *XLB_PAD, "float32", XL520),
    "flash_bwd_dkv_f32_xl_s_drop": Fault(
        "flash_bwd_dkv", "        st[i][u] += PT[(g + G * i) * LDX + c + 16 * u];",
        "        st[i][u] += u < NQT - 1 ? PT[(g + G * i) * LDX + c + 16 * u] : 0.f;",
        "float32", XL640),
    "flash_bwd_dkv_f32_xl_split": Fault("flash_bwd_dkv", *XLB_SPLIT, "float32", XL_RAGGED640),
    "flash_bwd_dkv_f32_xl_chunk_shift": Fault(
        "flash_bwd_dkv", *(" " * 8 + s.format("") for s in XLB_SHIFT), "float32", XL_RAGGED640),
    "flash_bwd_dkv_f32_xl_ragged": Fault(
        "flash_bwd_dkv",
        "        if (edge && (qi >= S || key >= S || (causal && key > qi))) pr = 0.f;",
        "        if (edge && (qi >= S - 1 || key >= S || (causal && key > qi))) pr = 0.f;",
        "float32", XL_RAGGED640),
    "flash_bwd_dkv_f32_xl_pad": Fault("flash_bwd_dkv", *XLB_PAD, "float32", XL520),
}

# The bf16 dQ and dK/dV past Dh 256.
WIDE_RAGGED384, WIDE_DH384 = (2, 3, 193, 384), (4, 4, 1024, 384)
DQW_MASK = "      const bool masked = edge && (kj >= S || (causal && kj > qi0 + 8 * h));"
DKVW_MASK = "          const bool masked = edge && (qi >= S || key >= S || (causal && key > qi));"
DKVW_PUSH = "      const uint32_t peer = peer_addr(theirs + x * (N / 4) * 128 + t, 1 - rank);"
DKVW_C0 = "  const int c0 = rank == 0 ? 0 : C::kCols0, boxes"
WIDE_BWD_FAULTS = {
    "flash_bwd_dq_wide_tiles": Fault(
        "flash_bwd_dq", "  return ((causal ? min(q0 + kDqWideBQ, S) : S) + BK - 1) / BK;",
        "  return ((causal ? min(q0 + kDqWideBQ, S) : S) + BK - 1) / BK"
        " - (q0 + kDqWideBQ >= S ? 1 : 0);", "bfloat16", WIDE512_SHAPE),
    "flash_bwd_dq_wide_x_drop": Fault(
        "flash_bwd_dq", "    for (int v = 0; v < BK / 8; ++v) {\n      const float4 x = theirs[v * 128 + t];",
        "    for (int v = 0; v < BK / 16; ++v) {\n      const float4 x = theirs[v * 128 + t];",
        "bfloat16", WIDE320_SHAPE),
    "flash_bwd_dq_wide_shift": Fault(
        "flash_bwd_dq", "  acc.stage(scale, scale, Qs, kDqWideBQ, 0, C0);",
        "  acc.stage(scale, scale, Qs, kDqWideBQ, 0, C0 - (C0 > 0 ? 64 : 0));", "bfloat16",
        WIDE320_SHAPE),
    "flash_bwd_dq_wide_ragged": Fault("flash_bwd_dq", DQW_MASK, DQW_MASK.replace(
        "kj >= S ||", "kj >= S - 1 ||"), "bfloat16", WIDE_RAGGED384),
    "flash_bwd_dq_wide_pad": Fault(
        "flash_bwd_dq",
        "      acc.mma(dsa[kk], Kt + (C0 / 64) * (BK * 128) + kk * 16 * 128, BK * 128);",
        "      acc.mma(dsa[kk], Kt + (C0 / 64 + (C0 > 0)) * (BK * 128) + kk * 16 * 128, BK * 128);",
        "bfloat16", WIDE512_SHAPE),
    "flash_bwd_dkv_wide_tiles": Fault(
        "flash_bwd_dkv", "  const int t_end = (S - 1) / BQ + 1;  // S > 0",
        "  const int t_end = (S - 1) / BQ + 1 - (k0 + kDkvWideBK >= S ? 1 : 0);", "bfloat16",
        XL_RAGGED512),
    "flash_bwd_dkv_wide_s_drop": Fault(
        "flash_bwd_dkv", "      for (int v = 0; v < N / 4; ++v) {\n        const float4 o =",
        "      for (int v = 0; v < N / 8; ++v) {\n        const float4 o =", "bfloat16",
        WIDE_DH384),
    "flash_bwd_dkv_wide_shift": Fault(
        "flash_bwd_dkv", "  const size_t base = (size_t)bh * S * DH + C0;",
        "  const size_t base = (size_t)bh * S * DH + C0 - (C0 > 0 ? 64 : 0);", "bfloat16",
        WIDE_DH384),
    "flash_bwd_dkv_wide_ragged": Fault("flash_bwd_dkv", DKVW_MASK, DKVW_MASK.replace(
        "qi >= S ||", "qi >= S - 1 ||"), "bfloat16", WIDE_RAGGED384),
    "flash_bwd_dkv_wide_pad": Fault("flash_bwd_dkv", DKVW_C0, DKVW_C0.replace(
        "C::kCols0, boxes", "C::kCols0 + 64, boxes"), "bfloat16", WIDE512_SHAPE),
    "flash_bwd_dkv_wide_rank": Fault("flash_bwd_dkv", DKVW_PUSH, DKVW_PUSH.replace(
        "1 - rank);", "rank);"), "bfloat16", WIDE_DH384),
}
FAULTS.update(WIDE_BWD_FAULTS)

# The bf16 dQ and dK/dV past 512.
XB_SHARE = "  const int s0 = rank * p.nb / p.cluster, s1 = (rank + 1) * p.nb / p.cluster;"
XL_BWD_FAULTS = {
    "flash_bwd_dq_xl_tiles": Fault(
        "flash_bwd_dq", "  const int end = causal ? min(q0 + kDqWideBQ, S) : S;  // one past the last key read",
        "  const int end = (causal ? min(q0 + kDqWideBQ, S) : S) - (q0 + kDqWideBQ >= S ? DqXlCfg::BK : 0);",
        "bfloat16", XL640),
    "flash_bwd_dq_xl_x_drop": Fault(
        "flash_bwd_dq", "      const float4 y = other[v * 128 + t];",
        "      const float4 y = v < N / 8 ? other[v * 128 + t] : make_float4(0.f, 0.f, 0.f, 0.f);",
        "bfloat16", XL640),
    "flash_bwd_dq_xl_chunk_shift": Fault(
        "flash_bwd_dq", "  copy_boxes<NB>(Ks, c0, dq + (size_t)bh * S * dh, dh, q0, S, 64 * b0, 5 + wg);",
        "  copy_boxes<NB>(Ks, c0, dq + (size_t)bh * S * dh, dh, q0, S, 64 * (b0 + (b0 > 0)), 5 + wg);",
        "bfloat16", XL_RAGGED1024),
    "flash_bwd_dq_xl_ragged": Fault(
        "flash_bwd_dq", "        const bool off = edge && (kj >= S || (causal && kj > qi0 + 8 * h));",
        "        const bool off = edge && (kj >= S - 1 || (causal && kj > qi0 + 8 * h));",
        "bfloat16", XL_RAGGED640),
    "flash_bwd_dq_xl_pad": Fault("flash_bwd_dq", XL_PAD, XL_PAD.replace(
        "(cuuint64_t)dh,", "(cuuint64_t)((dh + 63) / 64 * 64),"), "bfloat16", XL520,
        file="flash_sm90.cuh"),
    "flash_bwd_dq_xl_split": Fault("flash_bwd_dq", XB_SHARE, XB_SHARE.replace(
        "s0 = rank * p.nb / p.cluster,", "s0 = rank * p.nb / p.cluster + (chunk > 0),"),
        "bfloat16", XL_RAGGED1024),
    "flash_bwd_dkv_xl_tiles": Fault(
        "flash_bwd_dkv", "  const int t_end = 1 + (S - 1) / BQ;  // S > 0",
        "  const int t_end = 1 + (S - 1) / BQ - (k0 + kDkvWideBK >= S ? 1 : 0);", "bfloat16",
        XL_RAGGED640),
    "flash_bwd_dkv_xl_x_drop": Fault(
        "flash_bwd_dkv", "        const float4 y = handed[128 * v + t];",
        "        const float4 y = v < N / 8 ? handed[128 * v + t] : make_float4(0.f, 0.f, 0.f, 0.f);",
        "bfloat16", XL640),
    "flash_bwd_dkv_xl_chunk_shift": Fault(
        "flash_bwd_dkv",
        "  copy_boxes<NB>(tile, 0, (wg == 0 ? dv : dk) + (size_t)bh * S * dh, dh, k0, S, 64 * b0, 6 + wg);",
        "  copy_boxes<NB>(tile, 0, (wg == 0 ? dv : dk) + (size_t)bh * S * dh, dh, k0, S,"
        " 64 * (b0 + (b0 > 0)), 6 + wg);", "bfloat16", XL_RAGGED640),
    "flash_bwd_dkv_xl_ragged": Fault(
        "flash_bwd_dkv",
        "          const bool off = edge && (qi >= S || key >= S || (causal && key > qi));",
        "          const bool off = edge && (qi >= S - 1 || key >= S || (causal && key > qi));",
        "bfloat16", XL_RAGGED640),
    "flash_bwd_dkv_xl_pad": Fault("flash_bwd_dkv", XL_PAD, XL_PAD.replace(
        "(cuuint64_t)dh,", "(cuuint64_t)((dh + 63) / 64 * 64),"), "bfloat16", XL520,
        file="flash_sm90.cuh"),
    "flash_bwd_dkv_xl_split": Fault("flash_bwd_dkv", XB_SHARE, XB_SHARE.replace(
        "s0 = rank * p.nb / p.cluster,", "s0 = rank * p.nb / p.cluster + (chunk > 0),"),
        "bfloat16", XL_RAGGED640),
}
FAULTS.update(XL_BWD_FAULTS)

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

# The page gather's bulk kernel (csrc/gather_pages.cu), checked by
# chip_smoke.phase_kernels_gather (every exact case, each output block
# filled with NaN before the call).
GATHER_CASE = ("lm_wide", "bench_decode")
GATHER_WAIT = '      asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: "memory");'
FAULTS.update({
    "gather_last_chunk": Fault(
        "gather_pages", "    const long long chunks = (page_bytes + kChunkBytes - 1) / kChunkBytes;",
        "    const long long chunks = page_bytes / kChunkBytes;", "float32", GATHER_CASE,
        "gather"),
    "gather_read_wait": Fault(
        "gather_pages", GATHER_WAIT, "      // (the stage's store may not have read it)",
        "float32", GATHER_CASE, "gather"),
    "gather_outside": Fault(
        "gather_pages", "    const bool ok = id >= 0 && id < num_pages;",
        "    const bool ok = true;", "float32", GATHER_CASE, "gather"),
})

# softmax_top1's kernels (csrc/softmax_top1.cu), checked by
# chip_smoke.phase_kernels_softmax (every case of softmax_cases first).
SOFTMAX_CASE = ("serve",)
FAULTS.update({
    "softmax_merge_tie": Fault(
        "softmax_top1", "      if (beats(s.m[w], s.i[w], m, mi)) {",
        "      if (beats(s.m[w], -s.i[w], m, -mi)) {", "float32", SOFTMAX_CASE, "softmax"),
    "softmax_tail": Fault(
        "softmax_top1", "  const int tail = cols - head - nvec * E;", "  const int tail = 0;",
        "float32", SOFTMAX_CASE, "softmax"),
    "softmax_nan": Fault(
        "softmax_top1", "  if (vn || mn) return vn && (!mn || i < mi);",
        "  if (vn || mn) return mn && (!vn || i < mi);", "float32", SOFTMAX_CASE, "softmax"),
    "softmax_pdl_wait": Fault(
        "softmax_top1", '  asm volatile("griddepcontrol.wait;\\n" ::: "memory");',
        "  // (no wait for the grid before)", "float32", SOFTMAX_CASE, "softmax"),
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
    "gather": ("""
import chip_smoke as cs
from dmlc_tpu_torch.ops import _build
_build.build(["gather_pages"])
cs.phase_kernels_gather(cs.phase_device()["mem_bytes_per_s"])
""", "AssertionError: gather_kv_pages"),
    "softmax": ("""
import chip_smoke as cs
from dmlc_tpu_torch.ops import _build
_build.build(["softmax_top1"])
cs.phase_kernels_softmax(cs.phase_device())
""", "AssertionError: softmax_top1"),
}


def plant(name: str, root: Path) -> Path:
    """A copy of the port under ``root / name`` with fault ``name``."""
    fault = FAULTS[name]
    src = REPO / "dmlc_tpu_torch" / "csrc" / (fault.file or f"{fault.source}.cu")
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
