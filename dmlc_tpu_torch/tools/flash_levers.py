#!/usr/bin/env python3
"""Times design variants (levers) of the flash, paged decode, page gather and softmax_top1 kernels, one at a time.

    python3 dmlc_tpu_torch/tools/flash_levers.py SCRATCH_DIR GROUP [--parent CSRC_DIR] [VARIANT ...]

GROUP names a table of GROUPS: ``dq`` (the bf16 flash_bwd_dq kernel, timed
at the LM train shape), ``f32`` (the float32 forward and dK/dV) or
``dq_f32`` (the float32 flash_bwd_dq), both timed at the train shape and at
its Dh-64 twin; ``wide`` (the bf16 forward and dK/dV at head dims 256 and
192, timed at the train shape's FLOPs with heads of 256 and of 192,
[8, 3, 2048, 256] and [8, 4, 2048, 192]); ``wide_dq`` (the bf16
flash_bwd_dq at those head dims and shapes); ``wide_f32`` (the float32
forward there); ``wide_bwd_f32`` (the float32 flash_bwd_dq and
flash_bwd_dkv there); ``wide_fwd`` (the forward's own kernels past head
dim 256 in both dtypes, timed at [4, 4, 1024, 320], [4, 4, 1024, 512] and
the train shape's FLOPs with heads of 384, [8, 2, 2048, 384]);
``xl_bwd_f32`` (the float32 flash_bwd_dq and flash_bwd_dkv past head dim
256, at the same shapes); ``xl_fwd`` (the forward past 512 in both
dtypes, which takes the head dim at run time, timed at [4, 4, 1024, 640],
[4, 4, 1024, 1024], the train shape's FLOPs as one head of 768,
[8, 1, 2048, 768], and [4, 4, 1024, 576], and beside the kernels built for
320, 384 and 512 at ``wide_fwd``'s shapes); ``wide_bwd_bf16`` (the bf16
flash_bwd_dq and flash_bwd_dkv past head dim 256, at ``wide_fwd``'s
shapes, checked at S 193 at 320, 384, 448 and 512); ``softmax``
(softmax_top1's layouts, checked on every case of
``chip_smoke.softmax_cases``, then timed at the serve shape [256, 1000]
in float32 and bf16: device time, and time a call back to back with the
queue full, alone and after the bf16 logits' cast to float32); ``gather`` (the page
gather's bulk kernel and its variants, checked bit-equal on every case of
``chip_smoke.gather_cases`` and both timed shapes, then timed at lm_wide's
serving shape and the decode bench's, warm and with a cold L2); ``paged``
(paged_decode_attention in float32 at the
decode bench's one-step state and at lm_wide's geometry, Dh 128, both
kernels of a call timed together, after ``chip_smoke.paged_check`` at each
geometry and head dim); or ``ab``, an earlier csrc/ against the checkout's
(give --parent): the three flash kernels in both dtypes at the train shape
and its Dh-64 twin, the wide kernels (csrc/flash_wide.cu, through their
entry points whatever the wrappers pick) at [4, 4, 1024, Dh] for Dh 160
and 256 in both dtypes (three readings of 10 calls), the three flash
kernels through the wrappers at [8, 3, 2048, 256], [8, 4, 2048, 192], [8,
2, 2048, 384], [4, 4, 1024, 320], [4, 4, 1024, 512] and [4, 4, 1024, 640]
in both dtypes (the kernel each picks, or the error of a source without
it), and the LM train
leg
(``chip_smoke.phase_train``: step wall p50, the flash kernels' device ms
in one traced step, the loss), in turns parent, ship, ship, parent. Runs
the group's variants named
(default: its ORDER) in turn. Each run copies chip_smoke.py and
dmlc_tpu_torch/ (without its build directory) into SCRATCH_DIR/<n>_<variant>;
each csrc source a variant patches is the checkout's with those pieces of
text replaced. With --parent (repeatable), CSRC_DIR is an earlier csrc/
whose sources and headers replace the copy's whole (the variant
"parent<j>"), run first and last so that drift between runs shows. The
copy is built; the group's kernels must pass ``chip_smoke.flash_check`` in
the group's dtypes at the group's checks (by default the LM train shape,
causal, and S 193 and 1000, causal and not; for ``wide``, ``wide_dq``,
``wide_f32`` and ``wide_bwd_f32`` S 193 at head dims 256 and 192, causal
and not; for ``wide_fwd`` and ``xl_bwd_f32`` S 193 at 320 and 512; for
``xl_fwd`` S 193 at 328, 520 and 1024) and at
each timed shape, and
``chip_smoke.kernel_device_ms``
times each of them at each timed shape (three readings of 20 calls). A
parent without a timed shape's head dim reports the error for that shape.

Prints one JSON line per run: device ms, the errors at the train shape, and
registers and spills (ptxas) of the group's kernels in its dtypes, with
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
# The train shape's FLOPs with wide heads: hidden 768 as 3 heads of 256 and
# as 4 of 192.
WIDE256_SHAPE = (8, 3, 2048, 256)
WIDE192_SHAPE = (8, 4, 2048, 192)
# ... and as 2 heads of 384; the forward past 256 is also timed at [4, 4,
# 1024, 320] and [4, 4, 1024, 512].
WIDE384_SHAPE = (8, 2, 2048, 384)
WIDE320_SHAPE = (4, 4, 1024, 320)
WIDE512_SHAPE = (4, 4, 1024, 512)
# The forward past 512: [4, 4, 1024, 640] and 1024, the train shape's FLOPs
# as one head of 768, and [4, 4, 1024, 576] (9 boxes of 64 columns).
XL640_SHAPE, XL1024_SHAPE, XL768_SHAPE = (4, 4, 1024, 640), (4, 4, 1024, 1024), (8, 1, 2048, 768)
XL576_SHAPE = (4, 4, 1024, 576)


# The flash checks a variant must pass before it is timed (and each timed
# shape, causal): the train shape, and ragged lengths where the kernels
# mask a partial tile.
FLASH_CHECKS = ((TRAIN_SHAPE, True), ((2, 3, 193, 128), False), ((2, 3, 193, 128), True),
                ((1, 2, 1000, 128), False), ((1, 2, 1000, 128), True))
WIDE_CHECKS = tuple(((2, 3, 193, dh), causal) for dh in (256, 192) for causal in (True, False))
FWD_WIDE_CHECKS = tuple(((2, 3, 193, dh), causal) for dh in (320, 512)
                        for causal in (True, False))
XL_FWD_CHECKS = tuple(((2, 3, 193, dh), causal) for dh in (328, 520, 1024)
                      for causal in (True, False))
XL_BWD_CHECKS = tuple(((2, 3, 193, dh), causal) for dh in (520, 640, 1024)
                      for causal in (True, False))
WIDE_BWD_CHECKS = tuple(((2, 3, 193, dh), causal) for dh in (320, 384, 448, 512)
                        for causal in (True, False))


class Group(NamedTuple):
    dtype: str | tuple        # checked and timed in this dtype (or each of these)
    kernels: tuple[str, ...]  # csrc/<kernel>.cu, each checked and timed
    shapes: tuple             # timed shapes: flash [B, H, S, Dh], causal; paged (geometry, Dh)
    levers: dict              # variant -> {kernel: [(old, new), ...]}
    order: tuple              # the variants run by default
    script: str = "flash"     # the key of SCRIPTS run in each copy
    checks: tuple = FLASH_CHECKS  # flash: (shape, causal) checked before the timings


# flash_bwd_dq (bf16). a: 128-key K/V tiles, P made while dP is multiplied,
# every tile whole; a0: a with S and dP waited for together; b: 64-key tiles
# (the checkout's source); c: a with warpgroup 0 multiplying only the
# visible half of the diagonal tile; bc: b with warpgroup 0 stopping before
# the last tile, whose keys all lie past its rows.
DQ_KEYS_LINE = "constexpr int kDqBQ = 128, kDqKeys = 64;\n"
KEYS_128 = (DQ_KEYS_LINE, DQ_KEYS_LINE.replace("64", "128"))
NO_OVERLAP = ("  wgmma_wait<1>();\n", "  wgmma_wait<0>();\n")
CALL = """      dq_tile<DH, kDqBK>(acc, Qw, dOw, Kt, Vt, &full_v[sv], (j / SV) & 1, release_v, lse2, dlt,
                         k0, qi0, S, causal, edge, scale_log2);
"""
HALF = (CALL, """      if (causal && k0 + kDqBK / 2 > row0 + 63)  // the upper half is past every row
        dq_tile<DH, kDqBK / 2>(acc, Qw, dOw, Kt, Vt, &full_v[sv], (j / SV) & 1, release_v, lse2,
                               dlt, k0, qi0, S, causal, edge, scale_log2);
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
FWD_SYNC = [("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 1;")]
DKV_STAGES = "  static constexpr int kStages = DH == 64 || DH == 192 ? 1 : 2;\n"
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

# paged_decode_attention (float32). ship: the checkout's source (32-position
# splits, 4 warps of 8 positions, each lane loading its 8 K and 8 V rows at
# Dh 128 before using any); split16: 16-position splits (4 warps of 4,
# twice the blocks); warps8: 8 warps of 4 positions; split64: 64-position
# splits (4 warps of 16, two rounds of 8 loads a lane); split128:
# 128-position splits over 8 warps of 16.
THREADS = "constexpr int kThreads = 128;"
SPLIT = "constexpr int kSplit = 32; "

# The bf16 forward and dK/dV at Dh 192 and 256 (group wide). ship: the
# checkout's sources (forward: 64-key K/V tiles at 256 and 96-key ones at
# 192, 2 stages; dK/dV: 64-key blocks, warpgroup 0 keeps dV and hands P^T
# to warpgroup 1, which keeps dK); stages1: one stage of K/V (forward) and
# of Q/dO (dK/dV) tiles at both; keys128: the forward at Dh 192 with
# 128-key tiles in one stage; keys64: the forward at Dh 192 with 64-key
# tiles; a (dK/dV at Dh 256): each warpgroup makes S^T and dP^T for all 64
# keys and keeps dK and dV over its 128 columns (the score products twice,
# 1.5x the FLOPs); b (dK/dV at Dh 256): warpgroup 0 makes P^T, warpgroup 1
# dP^T and dS^T, both go to shared memory as bf16 A operands (16 KB) and
# each warpgroup keeps dK and dV over its 128 columns.
FWD_BK = "  static constexpr int BK = DH <= 128 ? 128 : DH == 192 ? 96 : 64;\n"
STAGES = "  static constexpr int kStages = 2;\n"
DKV_CFG = "constexpr int kBarPEmpty = 4;  // split layout: warpgroup 1 has read it\n"
N128T = DKV_CFG + """
// D[64 x 128] (+)= A . B, both from shared memory, A K-major, B MN-major.
__device__ __forceinline__ void wgmma_ss_n128_t(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}
"""
SPLIT_BRANCH = "  } else {\n    // Split layout: keys k0 + [0, 64); warpgroup 0 makes P^T and keeps dV,\n"
# Layouts (a) and (b) share their epilogue: both warpgroups stage their
# column halves of dK (through K) and dV (through V) after a barrier over
# both, then warpgroup 0 copies dK out and warpgroup 1 dV.
HALVES_EPILOGUE = """
    consumers_wait(5);  // both warpgroups: every read of K and V is done
    stage_rows(dka.r, scale, scale, Ks, kDkvBK, 0, 128 * wg);
    stage_rows(dva.r, 1.f, 1.f, Vs, kDkvBK, 0, 128 * wg);
    consumers_wait(6);  // both halves staged
    const size_t base = (size_t)bh * S * DH;
    if (wg == 0)
      copy_rows<DH>(Ks, kDkvBK, 0, dk + base, k0, S, 1);
    else
      copy_rows<DH>(Vs, kDkvBK, 0, dv + base, k0, S, 2);
  } else {
"""
LAYOUT_A = """  } else if constexpr (DH == 256) {
    // Layout (a): keys k0 + [0, 64); each warpgroup makes S^T and dP^T for
    // all of them and keeps dK and dV over its 128 columns.
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int key_lo = k0 + 16 * (t / 32) + lane / 4, key_hi = key_lo + 8;
    const uint32_t col = wg * 2 * kDkvBQ * 128;  // this warpgroup's two boxes of Q and dO
    OutAcc<128> dka, dva;
    dka.zero();
    dva.zero();
    mbar_wait(bar_kv, 0);
    for (int tq = t0; tq < t_end; ++tq) {
      const int it = tq - t0, s = it % kStages, q0 = tq * kDkvBQ;
      unsigned char* Qt = Qs + s * kDkvQ;
      unsigned char* dOt = dOs + s * kDkvQ;
      mbar_wait(&full[s], (it / kStages) & 1);
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t a = (kk / 4) * (kDkvBK * 128) + (kk % 4) * 32;
        const uint32_t b = (kk / 4) * (kDkvBQ * 128) + (kk % 4) * 32;
        wgmma_ss_n64(st, desc(Ks + a, 16, 1024), desc(Qt + b, 16, 1024), kk);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t a = (kk / 4) * (kDkvBK * 128) + (kk % 4) * 32;
        const uint32_t b = (kk / 4) * (kDkvBQ * 128) + (kk % 4) * 32;
        wgmma_ss_n64(dpt, desc(Vs + a, 16, 1024), desc(dOt + b, 16, 1024), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);
      const bool edge = q0 + kDkvBQ > S || k0 + kDkvBK > S || (causal && k0 + 63 > q0);
      const float* lrow = lse_s + s * kDkvBQ;
      const float* drow = delta_s + s * kDkvBQ;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int qc = 8 * (i / 4) + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(drow + qc);
        const int key = (i % 4) < 2 ? key_lo : key_hi;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float p = exp2f(st[i + u] * scale_log2 - (u ? l2.y : l2.x));
          if (edge) {
            const int qi = q0 + qc + u;
            if (qi >= S || key >= S || (causal && key > qi)) p = 0.f;
          }
          dpt[i + u] = p * (dpt[i + u] - (u ? d2.y : d2.x));
          st[i + u] = p;
        }
      }
      uint32_t pa[4][4], dsa[4][4];
      to_a_operand(st, pa);
      to_a_operand(dpt, dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) dva.mma(pa[kk], dOt + col + kk * 16 * 128, kDkvBQ * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) dka.mma(dsa[kk], Qt + col + kk * 16 * 128, kDkvBQ * 128);
      wgmma_commit();
      wgmma_wait<0>();
      dva.fence();
      dka.fence();
      mbar_arrive(&empty[s]);
    }""" + HALVES_EPILOGUE
LAYOUT_B = """  } else if constexpr (DH == 256) {
    // Layout (b): keys k0 + [0, 64); warpgroup 0 makes P^T, warpgroup 1
    // dP^T and dS^T; both go to shared memory as bf16 A operands and each
    // warpgroup keeps dK and dV over its 128 columns.
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int key_lo = k0 + 16 * (t / 32) + lane / 4, key_hi = key_lo + 8;
    const uint32_t col = wg * 2 * kDkvBQ * 128;
    unsigned char* Pb = smem + 2 * kDkvKV + 2 * kStages * kDkvQ;  // [64 keys, 64 queries] bf16
    unsigned char* dSb = Pb + 64 * 128;
    const unsigned char* A = wg == 0 ? Ks : Vs;
    OutAcc<128> dka, dva;
    dka.zero();
    dva.zero();
    mbar_wait(bar_kv, 0);
    for (int tq = t0; tq < t_end; ++tq) {
      const int it = tq - t0, s = it % kStages, q0 = tq * kDkvBQ;
      unsigned char* Qt = Qs + s * kDkvQ;
      unsigned char* dOt = dOs + s * kDkvQ;
      mbar_wait(&full[s], (it / kStages) & 1);
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t a = (kk / 4) * (kDkvBK * 128) + (kk % 4) * 32;
        const uint32_t b = (kk / 4) * (kDkvBQ * 128) + (kk % 4) * 32;
        wgmma_ss_n64(sc, desc(A + a, 16, 1024), desc((wg == 0 ? Qt : dOt) + b, 16, 1024), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      if (wg == 0) {
        const bool edge = q0 + kDkvBQ > S || k0 + kDkvBK > S || (causal && k0 + 63 > q0);
        const float* lrow = lse_s + s * kDkvBQ;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int qc = 8 * (i / 4) + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(lrow + qc);
          const int key = (i % 4) < 2 ? key_lo : key_hi;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float p = exp2f(sc[i + u] * scale_log2 - (u ? l2.y : l2.x));
            if (edge) {
              const int qi = q0 + qc + u;
              if (qi >= S || key >= S || (causal && key > qi)) p = 0.f;
            }
            sc[i + u] = p;
          }
        }
        if (it > 0) consumers_wait(kBarPEmpty);  // warpgroup 1's products of the last tile are done
        stage_rows(sc, 1.f, 1.f, Pb, 64, 0, 0);
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        consumers_arrive(kBarPFull);
        consumers_wait(5);  // dS^T staged
      } else {
        consumers_wait(kBarPFull);
        const float* drow = delta_s + s * kDkvBQ;
        const int r_lo = 16 * (t / 32) + lane / 4;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = r_lo + 8 * ((i % 4) / 2), qc = 8 * (i / 4) + 2 * (lane % 4);
          const float2 p2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Pb + tile_offset(row, qc, 64)));
          const float2 d2 = *reinterpret_cast<const float2*>(drow + qc);
          sc[i] = p2.x * (sc[i] - d2.x);
          sc[i + 1] = p2.y * (sc[i + 1] - d2.y);
        }
        stage_rows(sc, 1.f, 1.f, dSb, 64, 0, 0);
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        consumers_arrive(5);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128_t(dva.r, desc(Pb + kk * 32, 16, 1024),
                        desc(dOt + col + kk * 16 * 128, kDkvBQ * 128, 1024), 1);
        wgmma_ss_n128_t(dka.r, desc(dSb + kk * 32, 16, 1024),
                        desc(Qt + col + kk * 16 * 128, kDkvBQ * 128, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      dva.fence();
      dka.fence();
      // Warpgroup 0 writes the next P^T once warpgroup 1's products are
      // done; warpgroup 1 writes the next dS^T after the next P^T, which
      // warpgroup 0 hands over after its own products.
      if (wg == 1 && tq + 1 < t_end) consumers_arrive(kBarPEmpty);
      mbar_arrive(&empty[s]);
    }""" + HALVES_EPILOGUE

# The bf16 flash_bwd_dq at Dh 192 and 256 (group wide_dq). ship: the
# checkout's source (64-key K/V tiles; at Dh 256 two K stages and one V
# stage, V released once dP is multiplied; 2 stages of each at 192);
# keys32: 32-key K/V tiles in 2 stages each at Dh 256 (S and dP on
# m64n32k16 of flash_sm90.cuh, two k16 steps of dQ a tile); stages1:
# 64-key tiles in one stage of K and of V at Dh 256.
DQ_BK = "  static constexpr int BK = kDqKeys;\n"
DQ_STAGES_K = "  static constexpr int kStagesK = 2;\n"
DQ_STAGES_V = "  static constexpr int kStagesV = DH == 256 ? 1 : 2;\n"

# The float32 forward at Dh 192 and 256 (group wide_f32). ship: the
# checkout's source (Dh 256: two parts of 128 threads, each owning half of
# O's columns, partial S added through shared memory behind a barrier over
# each pair of warps that hold the same rows, 2-stage K/V ring; Dh 192: one
# part, one stage); stages1: one stage at 256 too; stages2: two stages at
# 192 too; block: the partial S exchanged behind a barrier over the whole
# block; whole: one part of 128 threads at 256 (O 128 floats a thread, one
# block an SM); whole1: the same in one stage; keys16: 16-key
# K/V tiles at both; rows32: 32-row Q tiles (4 rows a row group) at both.
F32_PARTS = "  static constexpr int kParts = DH == 256 ? 2 : 1;\n"
F32_STAGES = "  static constexpr int kStages = DH == 192 ? 1 : kFwdStages;\n"
F32_TILE = "  static constexpr int BQ = kFwdRows, BK = kFwdKeys, RPT = kFwdRowsPerThread;\n"
F32_ONE_STAGE = (F32_STAGES, F32_STAGES.replace("DH == 192", "DH > 128"))
F32_EXCHANGE = ("        for (int u = 0; u < NKT; ++u)"
                " Sp[(g + G * i) * LDP + c + 16 * u] = s[i][u];\n")
F32_BLOCK = (F32_EXCHANGE + (
    "      // Warp w of each part holds the same rows: the pair waits for each other only.\n"
    "      pair_sync(1 + tp / 32);\n"),
    F32_EXCHANGE + "      __syncthreads();\n")
F32_WHOLE = (F32_PARTS, F32_PARTS.replace("DH == 256 ? 2 : 1", "1"))

# The float32 dQ and dK/dV at Dh 192 and 256 (group wide_bwd_f32). ship:
# the checkout's sources (dQ: one part of 128 threads at both, one K/V
# stage; dK/dV: at 256 one part (dK and dV together, 128 floats a thread)
# with a 2-stage Q/dO ring, at 192 two parts, part 0 making P^T and keeping
# dV, part 1 making dP^T and dS^T and keeping dK, in one stage, two blocks
# an SM); stages1: dK/dV with one Q/dO stage at 256 too; stages2: dK/dV
# with two stages at 192 too; whole: dK/dV in one part at 192 too (96
# floats a thread); parts: dK/dV in two parts at 256 too; whole1: one part,
# one stage at both; rows32: dQ at 192 with 32-row Q tiles (4 rows a row
# group, two blocks an SM).
DKV_PARTS = "  static constexpr int kParts = DH == 192 ? 2 : 1;\n"
DKV_ONE_STAGE = (DKV_STAGES, DKV_STAGES.replace("DH == 192", "DH > 128"))
DKV_TWO_STAGES = (DKV_STAGES, DKV_STAGES.replace("DH == 64 || DH == 192", "DH == 64"))
DKV_WHOLE = (DKV_PARTS, DKV_PARTS.replace("DH == 192 ? 2 : 1", "1"))
DKV_TWO_PARTS = (DKV_PARTS, DKV_PARTS.replace("DH == 192", "DH > 128"))

# The forward's own kernels past Dh 256 in both dtypes (group wide_fwd).
# ship: the checkout's source (bf16: 64-row Q tiles shared by both consumer
# warpgroups, each owning part of O's columns and making S over half of
# Dh, the partial S added through shared memory, 32-key K/V tiles in 2
# stages; float32: two parts split the same way, 64-row Q tiles up to 384
# and 32-row ones past it, one K/V stage); whole: bf16 with each
# warpgroup making the whole S (no exchange, 1.5x the tensor work);
# whole_f32: the same in float32 (1.5x the FMA work); stages1: bf16 with
# one K/V stage; rows32: float32 with 32-row Q tiles at 320 and 384 too.
XL_SPLIT = "  static constexpr bool kSplitS = true;         // S over half of Dh a warpgroup\n"
XL_SPLIT_F32 = "  static constexpr bool kSplitS = true;  // S over half of Dh a part\n"
XL_STAGES = "  static constexpr int kStages = 2;             // K/V ring depth\n"
XL_ROWS = "BQ = DH <= 384 ? kFwdRows : 32,"

# The float32 dQ and dK/dV past Dh 256 (group xl_bwd_f32), timed at the
# forward's shapes past 256. ship: the checkout's sources (dQ: two parts
# owning whole 64-column steps of dQ, S and dP each over half of Dh, the
# partials added through shared memory, 32-row Q tiles, 32-key K/V tiles,
# one stage, past 384 V and then K through one tile slot; dK/dV: 32-key
# blocks, one stage, up to 384 split by columns with 32-row Q/dO tiles,
# each part making S^T and dP^T over half of Dh and keeping dK and dV
# over its columns, past it the roles of Dh 192 with 16-row tiles, part 0
# P^T and dV, part 1 dP^T, dS^T and dK over all of Dh); slots2: dQ with K
# and V in two slots past 384 too (16-key tiles there); vk: dQ with one
# slot at 320 and 384 too; rows64: dQ at 320 with 64-row Q tiles and
# 16-key K/V tiles; keys16: 16-key K/V tiles (dQ) and key blocks (dK/dV);
# dkv_roles: dK/dV by roles at 320 and 384 too; dkv_split: dK/dV split by
# columns past 384 too; rows32: dK/dV past 384 with 16-key blocks and
# 32-row Q/dO tiles.
XLB_DQ_TILE = "  static constexpr int BQ = 32, BK = 32, RPT = BQ / 8;\n"
XLB_DKV_TILE = "  static constexpr int BK = 32, BQ = DH <= 384 ? 32 : 16, KPT = BK / 8;\n"
XLB_ONE_SLOT = "  static constexpr bool kOneSlot = DH > 384;    // V, then K, in one K/V tile\n"
XLB_SPLIT = "  static constexpr bool kSplit = DH <= 384;  // the column split, else the roles\n"
XLB_DQ_KEYS16_XL = (XLB_DQ_TILE, XLB_DQ_TILE.replace("BK = 32", "BK = DH <= 384 ? 32 : 16"))
XLB_TWO_SLOTS = (XLB_ONE_SLOT, XLB_ONE_SLOT.replace("DH > 384", "false"))

# The forward past 512 in both dtypes (group xl_fwd). ship: the
# checkout's source (bf16: 64-row Q tiles, 32-key tiles, O in chunks of at
# most 8 boxes, 4 a warpgroup, S over Dh's 64-column slabs split between
# the two consumer warpgroups, each slab of K and Q through a ring of 4 a
# warpgroup, V in 2 stages; float32: 32-row tiles, two parts of at most 6
# steps of O, a 2-slot slab ring, Q resident up to 704); chunks: O in
# narrower chunks (bf16 2 boxes a warpgroup, float32 4 steps a part: 640 in
# three chunks in bf16 and two in float32, more recomputed S); qstream:
# float32 with Q streamed beside each K slab at every width; slots2: bf16
# with 2 slabs in flight a warpgroup; vstage1: bf16 with one V stage;
# ring3: float32 with a 3-slot slab ring; xl_all: both dtypes' kernels
# past 512 also at 320, 384 and 512, in place of the kernels built for
# those head dims (ship runs those there).
XL_MAX = "  static constexpr int BK = 32, kMaxBoxes = 4;  // keys a K/V tile; boxes of O a warpgroup holds\n"
XL_F32_MAX = "  static constexpr int kMaxSteps = 6;         // 64-column steps of O a part holds\n"
XL_W3 = ("    case 3: return launch_fwd_xl_w<3>(p, mq, mk, mv, out, lse, bh, s, dh, causal, scale,"
         " stream);\n")
XL_F32_QRES = "  static constexpr int kQResidentSteps = 11;  // Q stays in shared memory up to Dh 704\n"
XL_SLOTS = "  static constexpr int kSlots = 4;              // K and Q slabs in flight a warpgroup\n"
XL_VSTAGES = "  static constexpr int kVStages = 2;            // V tiles in flight\n"
XL_F32_RING = "  static constexpr int kRing = 2;             // slab ring depth\n"
XL_FIRST_FIXED = "  if (is_bf16 && dh == 320)\n    return (int)sm90::launch_fwd_wide<320>("
XL_ROUTE = ("  if (dh > 256 && dh % 8 == 0)\n"
            "    return (int)(is_bf16 ? sm90::launch_fwd_xl(q, k, v, out, lse, bh, s, dh, causal, scale, st)\n"
            "                         : f32::launch_fwd_xl(q, k, v, out, lse, bh, s, dh, causal, scale, st));\n")

# The float32 dQ and dK/dV past 512 (group xl_bwd512). ship: the
# checkout's sources (32-row Q tiles, 32-key tiles, two parts splitting S
# and dP over Dh's slabs; a power of two of column chunks, whose blocks
# form a cluster that splits the scores over the slabs again; a 2-slot
# ring; dQ in chunks of at most 10 steps, 5 a part, the block's slabs of Q
# resident up to 11; dK/dV by the roles, part 0 dV and part 1 dK over a
# whole chunk of at most 5 steps, the block's slabs of K and V resident up
# to 5); chunks, chunks6, chunks3: other chunk widths (dQ 8, 12 or 6
# steps, dK/dV 4, 6 or 3; a chunk adds blocks to a cluster, not work);
# ring3: dK/dV with a 3-slot ring (dQ's third slot does not fit);
# qstream: dQ with Q streamed; kvstream: dK/dV with K and V streamed;
# rows16: 16-row Q (dQ) and Q/dO (dK/dV) tiles; keys16: dK/dV with 16-key
# blocks and chunks of 10 steps (640 in one chunk); unroll: the score
# products' loop over a slab unrolled the other way (dQ's not, dK/dV's by
# two).
XLB2_DQ_TILE = "  static constexpr int BK = 32, BQ = 32, RPT = BQ / 8;  // keys, query rows, rows a row group\n"
XLB2_DQ_STEPS = "  static constexpr int kMaxSteps = 5;        // 64-column steps of dQ a part holds\n"
XLB2_DQ_RING = "  static constexpr int kRing = 2;            // slab ring depth\n"
XLB2_DQ_QRES = ("  static constexpr int kQResidentSteps = 11;  // Q stays in shared memory up to this"
                " many slabs\n")
XLB2_DKV_TILE = ("  static constexpr int BK = 32, BQ = 32, KPT = BK / 8;  // keys a block, Q rows a tile,"
                 " keys a group\n")
XLB2_DKV_STEPS = "  static constexpr int kChunkSteps = 5;  // 64-column steps of dK and dV a block\n"
XLB2_DKV_KVRES = ("  static constexpr int kKvResidentSteps = 5;  // K and V stay in shared memory up to"
                  " this many slabs\n")
XLB2_DKV_RING = "  static constexpr int kRing = 2;        // slab ring depth\n"
XLB2_UNROLL = "#pragma unroll {}\n        for (int kk = 0; kk < 64; kk += 4) {{\n"

# The bf16 flash_bwd_dq and flash_bwd_dkv past head dim 256 (group
# wide_bwd_bf16). ship: the checkout's (dQ: 32-key K/V tiles in two stages
# at 320, past it 16-key tiles, two stages of K and one of V; dK/dV:
# 32-row Q/dO tiles in two stages, one block over all of Dh at 320, past
# it clusters of two column chunks); keys16: dQ's 16-key tiles at 320 too;
# vstage2: two stages of V past 320 too; stages3: three dK/dV stages;
# cluster320: dK/dV's cluster of two chunks at 320 too.
WB_DQ_BK = "  static constexpr int BK = DH == 320 ? 32 : 16;  // keys a K/V tile\n"
WB_DQ_SV = "  static constexpr int kStagesV = DH == 320 ? 2 : 1;  // V ring depth\n"
WB_DKV_STAGES = "  static constexpr int kStages = 2;      // Q/dO ring depth\n"
WB_DKV_CHUNKS = "  static constexpr int kChunks = DH == 320 ? 1 : 2;\n"

# The bf16 flash_bwd_dq and flash_bwd_dkv past 512 (group xl_bwd_bf16).
# ship: the checkout's (each chunk's block makes the scores over all of
# Dh, as few chunks as fit; dQ: chunks of at most 10 boxes, 32-key K/V
# tiles; dK/dV: chunks of at most 5 boxes, 32-row Q/dO tiles; both with
# slab rings of 4 a warpgroup and two stages of the chunk's K or Q/dO
# tiles); dkv_cluster, dq_cluster: the chunks' blocks a cluster (a power of
# two of chunks) splitting the scores over Dh, the blocks' partials added
# in rank order (dQ's chunks then of at most 8 boxes, to fit its shared
# memory); chunks: narrower chunks (dQ 8 boxes, dK/dV 4); keys16:
# dQ's 16-key tiles; rows16: dK/dV's 16-row tiles; slots2: slab rings of
# 2; stages3: three stages of the chunk's tiles.
XB_CLUSTER = "  static constexpr bool kCluster = false;  // the chunks' blocks split the scores over Dh\n"
XB_DQ_BOXES = "  static constexpr int kMaxBoxes = 5;      // boxes of dQ a warpgroup holds\n"
XB_DQ_BK = "  static constexpr int BK = 32;            // keys a K/V tile\n"
XB_DKV_TILE = "  static constexpr int BQ = 32, kMaxBoxes = 5;  // query rows a Q/dO tile; boxes of dK, dV a block\n"
XB_DQ_SLOTS = "  static constexpr int kSlots = 4;         // slabs in flight a warpgroup\n"
XB_DKV_SLOTS = "  static constexpr int kSlots = 4;        // slabs in flight a warpgroup\n"
XB_DQ_STAGES = "  static constexpr int kKStages = 2;       // the chunk's K tiles in flight\n"

# The page gather (csrc/gather_pages.cu). ship: the checkout's bulk kernel
# (16 KB chunks, a ring of 4, at most 2 blocks an SM); vec16: the route on
# the design it replaced (the 16-byte vector kernel); chunk8k and chunk32k:
# chunks of half and twice the shipped size; stages3: one stage fewer;
# blocks1: one block an SM against two; waitall: each block waits at its
# end for its stores' writes, not only for their reads of the ring.
G_CHUNK = "constexpr int kChunkBytes = 16384;"
G_STAGES = "constexpr int kStages = 4;"
G_BLOCKS = "constexpr int kBlocksPerSm = 2;"
G_ROUTE = "  return launch_gather(pool, num_pages, page_bytes, ids, n_out, out, stream, true);"
G_END = '  if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");'
XB_DKV_STAGES = "  static constexpr int kOStages = 2;      // the chunk's Q/dO tiles in flight\n"

# softmax_top1 (csrc/softmax_top1.cu). ship: the checkout's layout (128
# threads a row, 2 vectors a thread at [256, 1000] float32); warp1 and
# warp2: a warp a row, one or two rows a block (8 vectors a lane); block64
# and block256: 64 or 256 threads a row (4 vectors a thread, or 1).
SM_THREADS = "constexpr int kRowThreads = 128;"
SM_ROWS = "constexpr int kRowsPerBlock = 1;"

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
        "sync": {"flash_fwd": FWD_SYNC, "flash_bwd_dkv": [(DKV_STAGES, DKV_STAGES.replace(
            "DH == 64 || DH == 192 ? 1 : 2", "1"))]},
        "ring": {"flash_bwd_dkv": [(DKV_STAGES, DKV_STAGES.replace(
            "DH == 64 || DH == 192 ? 1 : 2", "2"))]},
        "rows128": {"flash_fwd": [("constexpr int kFwdRows = 64;",
                                   "constexpr int kFwdRows = 128;")]},
        "keys64": {"flash_bwd_dkv": [("constexpr int kDkvKeys = 32;",
                                      "constexpr int kDkvKeys = 64;")]},
        "quad": {"flash_bwd_dkv": QUAD},
    }, ("ship", "sync", "ring", "rows128", "keys64", "quad", "ship")),
    "dq_f32": Group("float32", ("flash_bwd_dq",), (TRAIN_SHAPE, DH64_SHAPE), DQ_F32,
                    ("ship", "ring", "rows32", "keys32", "keys64", "ship")),
    "paged": Group("float32", ("paged_decode",), (("bench_decode", 128), ("lm_wide", 128)), {
        "ship": {},
        "split16": {"paged_decode": [(SPLIT, SPLIT.replace("32", "16"))]},
        "warps8": {"paged_decode": [(THREADS, THREADS.replace("128", "256"))]},
        "split64": {"paged_decode": [(SPLIT, SPLIT.replace("32", "64"))]},
        "split128": {"paged_decode": [(SPLIT, SPLIT.replace("32", "128")),
                                      (THREADS, THREADS.replace("128", "256"))]},
    }, ("ship", "split16", "warps8", "split64", "split128", "ship"), "paged"),
    "wide": Group("bfloat16", ("flash_fwd", "flash_bwd_dkv"), (WIDE256_SHAPE, WIDE192_SHAPE), {
        "ship": {},
        "stages1": {"flash_fwd": [(STAGES, STAGES.replace("2;", "DH <= 128 ? 2 : 1;"))],
                    "flash_bwd_dkv": [(STAGES, STAGES.replace("2;", "DH <= 128 ? 2 : 1;"))]},
        "keys128": {"flash_fwd": [(FWD_BK, FWD_BK.replace("DH == 192 ? 96", "DH == 192 ? 128")),
                                  (STAGES, STAGES.replace("2;", "DH == 192 ? 1 : 2;"))]},
        "keys64": {"flash_fwd": [(FWD_BK, FWD_BK.replace("DH == 192 ? 96", "DH == 192 ? 64"))]},
        "a": {"flash_bwd_dkv": [(SPLIT_BRANCH, LAYOUT_A + SPLIT_BRANCH[len("  } else {\n"):])]},
        "b": {"flash_bwd_dkv": [(DKV_CFG, N128T),
                                (SPLIT_BRANCH, LAYOUT_B + SPLIT_BRANCH[len("  } else {\n"):])]},
    }, ("ship", "stages1", "keys128", "keys64", "a", "b", "ship"), checks=WIDE_CHECKS),
    "wide_dq": Group("bfloat16", ("flash_bwd_dq",), (WIDE256_SHAPE, WIDE192_SHAPE), {
        "ship": {},
        "keys32": {"flash_bwd_dq": [(DQ_BK, DQ_BK.replace("kDqKeys", "DH == 256 ? 32 : kDqKeys")),
                                    (DQ_STAGES_V, DQ_STAGES_V.replace("DH == 256 ? 1 : 2", "2"))]},
        "stages1": {"flash_bwd_dq": [(DQ_STAGES_K, DQ_STAGES_K.replace("2", "DH == 256 ? 1 : 2"))]},
    }, ("ship", "keys32", "stages1", "ship"), checks=WIDE_CHECKS),
    "wide_f32": Group("float32", ("flash_fwd",), (WIDE256_SHAPE, WIDE192_SHAPE), {
        "ship": {},
        "stages1": {"flash_fwd": [F32_ONE_STAGE]},
        "stages2": {"flash_fwd": [(F32_STAGES, F32_STAGES.replace("DH == 192 ? 1 : kFwdStages",
                                                                  "kFwdStages"))]},
        "block": {"flash_fwd": [F32_BLOCK]},
        "whole": {"flash_fwd": [F32_WHOLE]},
        "whole1": {"flash_fwd": [F32_WHOLE, F32_ONE_STAGE]},
        "keys16": {"flash_fwd": [(F32_TILE, F32_TILE.replace("BK = kFwdKeys",
                                                             "BK = DH > 128 ? 16 : kFwdKeys"))]},
        "rows32": {"flash_fwd": [(F32_TILE, F32_TILE.replace(
            "BQ = kFwdRows", "BQ = DH > 128 ? 32 : kFwdRows").replace(
            "RPT = kFwdRowsPerThread", "RPT = DH > 128 ? 4 : kFwdRowsPerThread"))]},
    }, ("ship", "stages1", "stages2", "block", "whole", "whole1", "keys16", "rows32", "ship"),
        checks=WIDE_CHECKS),
    "wide_bwd_f32": Group("float32", ("flash_bwd_dq", "flash_bwd_dkv"),
                          (WIDE256_SHAPE, WIDE192_SHAPE), {
        "ship": {},
        "stages1": {"flash_bwd_dkv": [DKV_ONE_STAGE]},
        "stages2": {"flash_bwd_dkv": [DKV_TWO_STAGES]},
        "whole": {"flash_bwd_dkv": [DKV_WHOLE]},
        "parts": {"flash_bwd_dkv": [DKV_TWO_PARTS]},
        "whole1": {"flash_bwd_dkv": [DKV_WHOLE, DKV_ONE_STAGE]},
        "rows32": {"flash_bwd_dq": [("BQ = kDqRows,", "BQ = DH == 192 ? 32 : kDqRows,"),
                                    ("RPT = kDqRowsPerThread;",
                                     "RPT = DH == 192 ? 4 : kDqRowsPerThread;")]},
    }, ("ship", "stages1", "stages2", "whole", "parts", "whole1", "rows32", "ship"),
        checks=WIDE_CHECKS),
    "wide_fwd": Group(("bfloat16", "float32"), ("flash_fwd",),
                      (WIDE320_SHAPE, WIDE512_SHAPE, WIDE384_SHAPE), {
        "ship": {},
        "whole": {"flash_fwd": [(XL_SPLIT, XL_SPLIT.replace("true", "false"))]},
        "whole_f32": {"flash_fwd": [(XL_SPLIT_F32, XL_SPLIT_F32.replace("true", "false"))]},
        "stages1": {"flash_fwd": [(XL_STAGES, XL_STAGES.replace("2;", "1;"))]},
        "rows32": {"flash_fwd": [(XL_ROWS, "BQ = 32,")]},
    }, ("ship", "whole", "whole_f32", "stages1", "rows32", "ship"), checks=FWD_WIDE_CHECKS),
    "xl_bwd_f32": Group("float32", ("flash_bwd_dq", "flash_bwd_dkv"),
                        (WIDE320_SHAPE, WIDE512_SHAPE, WIDE384_SHAPE), {
        "ship": {},
        "slots2": {"flash_bwd_dq": [XLB_TWO_SLOTS, XLB_DQ_KEYS16_XL]},
        "vk": {"flash_bwd_dq": [(XLB_ONE_SLOT, XLB_ONE_SLOT.replace("DH > 384", "true"))]},
        "rows64": {"flash_bwd_dq": [(XLB_DQ_TILE, XLB_DQ_TILE.replace(
            "BQ = 32, BK = 32", "BQ = DH == 320 ? 64 : 32, BK = DH == 320 ? 16 : 32"))]},
        "keys16": {"flash_bwd_dq": [(XLB_DQ_TILE, XLB_DQ_TILE.replace("BK = 32", "BK = 16"))],
                   "flash_bwd_dkv": [(XLB_DKV_TILE, XLB_DKV_TILE.replace("BK = 32", "BK = 16"))]},
        "dkv_roles": {"flash_bwd_dkv": [(XLB_SPLIT, XLB_SPLIT.replace("DH <= 384", "false"))]},
        "dkv_split": {"flash_bwd_dkv": [(XLB_SPLIT, XLB_SPLIT.replace("DH <= 384", "true"))]},
        "rows32": {"flash_bwd_dkv": [(XLB_DKV_TILE, XLB_DKV_TILE.replace(
            "BK = 32, BQ = DH <= 384 ? 32 : 16", "BK = DH <= 384 ? 32 : 16, BQ = 32"))]},
    }, ("ship", "slots2", "vk", "rows64", "keys16", "dkv_roles", "dkv_split", "rows32",
        "ship"), checks=FWD_WIDE_CHECKS),
    "xl_fwd": Group(("bfloat16", "float32"), ("flash_fwd",),
                    (XL640_SHAPE, XL1024_SHAPE, XL768_SHAPE, XL576_SHAPE, WIDE320_SHAPE,
                     WIDE512_SHAPE, WIDE384_SHAPE), {
        "ship": {},
        "chunks": {"flash_fwd": [(XL_MAX, XL_MAX.replace("kMaxBoxes = 4", "kMaxBoxes = 2")),
                                 (XL_W3, XL_W3.replace("3", "2") + XL_W3),
                                 (XL_F32_MAX, XL_F32_MAX.replace("6", "4"))]},
        "qstream": {"flash_fwd": [(XL_F32_QRES, XL_F32_QRES.replace("= 11", "= 0"))]},
        "slots2": {"flash_fwd": [(XL_SLOTS, XL_SLOTS.replace("= 4", "= 2"))]},
        "vstage1": {"flash_fwd": [(XL_VSTAGES, XL_VSTAGES.replace("= 2", "= 1"))]},
        "ring3": {"flash_fwd": [(XL_F32_RING, XL_F32_RING.replace("= 2", "= 3"))]},
        "xl_all": {"flash_fwd": [(XL_FIRST_FIXED, XL_ROUTE + XL_FIRST_FIXED)]},
    }, ("ship", "chunks", "qstream", "slots2", "vstage1", "ring3", "xl_all", "ship"),
        checks=XL_FWD_CHECKS),
    "xl_bwd512": Group("float32", ("flash_bwd_dq", "flash_bwd_dkv"),
                       (XL640_SHAPE, XL1024_SHAPE, XL768_SHAPE), {
        "ship": {},
        **{name: {"flash_bwd_dq": [(XLB2_DQ_STEPS, XLB2_DQ_STEPS.replace("= 5", f"= {n}"))],
                  "flash_bwd_dkv": [(XLB2_DKV_STEPS, XLB2_DKV_STEPS.replace("= 5", f"= {n}"))]}
           for name, n in (("chunks", 4), ("chunks6", 6), ("chunks3", 3))},
        "ring3": {"flash_bwd_dkv": [(XLB2_DKV_RING, XLB2_DKV_RING.replace("= 2", "= 3"))]},
        "qstream": {"flash_bwd_dq": [(XLB2_DQ_QRES, XLB2_DQ_QRES.replace("= 11", "= 0"))]},
        "kvstream": {"flash_bwd_dkv": [(XLB2_DKV_KVRES, XLB2_DKV_KVRES.replace("= 5", "= 0"))]},
        "rows16": {"flash_bwd_dq": [(XLB2_DQ_TILE, XLB2_DQ_TILE.replace("BQ = 32", "BQ = 16"))],
                   "flash_bwd_dkv": [(XLB2_DKV_TILE, XLB2_DKV_TILE.replace("BQ = 32", "BQ = 16"))]},
        "keys16": {"flash_bwd_dkv": [(XLB2_DKV_TILE, XLB2_DKV_TILE.replace("BK = 32", "BK = 16")),
                                     (XLB2_DKV_STEPS, XLB2_DKV_STEPS.replace("= 5", "= 10"))]},
        "unroll": {"flash_bwd_dq": [(XLB2_UNROLL.format(2), XLB2_UNROLL.format(1))],
                   "flash_bwd_dkv": [(XLB2_UNROLL.format(1), XLB2_UNROLL.format(2))]},
    }, ("ship", "chunks", "chunks6", "chunks3", "ring3", "qstream", "kvstream", "rows16", "keys16",
        "unroll", "ship"), checks=XL_BWD_CHECKS),
    "wide_bwd_bf16": Group("bfloat16", ("flash_bwd_dq", "flash_bwd_dkv"),
                           (WIDE320_SHAPE, WIDE512_SHAPE, WIDE384_SHAPE), {
        "ship": {},
        "keys16": {"flash_bwd_dq": [(WB_DQ_BK, WB_DQ_BK.replace("DH == 320 ? 32 : 16;", "16;"))]},
        "vstage2": {"flash_bwd_dq": [(WB_DQ_SV, WB_DQ_SV.replace("DH == 320 ? 2 : 1;", "2;"))]},
        "stages3": {"flash_bwd_dkv": [(WB_DKV_STAGES, WB_DKV_STAGES.replace("2;", "3;"))]},
        "cluster320": {"flash_bwd_dkv": [(WB_DKV_CHUNKS, WB_DKV_CHUNKS.replace(
            "DH == 320 ? 1 : 2;", "2;"))]},
    }, ("ship", "keys16", "vstage2", "stages3", "cluster320", "ship"), checks=WIDE_BWD_CHECKS),
    "xl_bwd_bf16": Group("bfloat16", ("flash_bwd_dq", "flash_bwd_dkv"),
                         (XL640_SHAPE, XL1024_SHAPE, XL768_SHAPE), {
        "ship": {},
        "dkv_cluster": {"flash_bwd_dkv": [(XB_CLUSTER, XB_CLUSTER.replace("false", "true"))]},
        "dq_cluster": {"flash_bwd_dq": [(XB_CLUSTER, XB_CLUSTER.replace("false", "true")),
                                        (XB_DQ_BOXES, XB_DQ_BOXES.replace("= 5", "= 4"))]},
        "chunks": {"flash_bwd_dq": [(XB_DQ_BOXES, XB_DQ_BOXES.replace("= 5", "= 4"))],
                   "flash_bwd_dkv": [(XB_DKV_TILE, XB_DKV_TILE.replace("= 5", "= 4"))]},
        "keys16": {"flash_bwd_dq": [(XB_DQ_BK, XB_DQ_BK.replace("= 32", "= 16"))]},
        "rows16": {"flash_bwd_dkv": [(XB_DKV_TILE, XB_DKV_TILE.replace("= 32", "= 16"))]},
        "slots2": {"flash_bwd_dq": [(XB_DQ_SLOTS, XB_DQ_SLOTS.replace("= 4", "= 2"))],
                   "flash_bwd_dkv": [(XB_DKV_SLOTS, XB_DKV_SLOTS.replace("= 4", "= 2"))]},
        "stages3": {"flash_bwd_dq": [(XB_DQ_STAGES, XB_DQ_STAGES.replace("= 2", "= 3"))],
                    "flash_bwd_dkv": [(XB_DKV_STAGES, XB_DKV_STAGES.replace("= 2", "= 3"))]},
    }, ("ship", "dkv_cluster", "dq_cluster", "chunks", "keys16", "rows16", "slots2", "stages3",
        "ship"), checks=XL_BWD_CHECKS),
    "gather": Group("float32", ("gather_pages",), ("lm_wide", "bench_decode"), {
        "ship": {},
        "vec16": {"gather_pages": [(G_ROUTE, G_ROUTE.replace("true", "false"))]},
        "chunk8k": {"gather_pages": [(G_CHUNK, G_CHUNK.replace("16384", "8192"))]},
        "chunk32k": {"gather_pages": [(G_CHUNK, G_CHUNK.replace("16384", "32768"))]},
        "stages3": {"gather_pages": [(G_STAGES, G_STAGES.replace("4", "3"))]},
        "blocks1": {"gather_pages": [(G_BLOCKS, G_BLOCKS.replace("2", "1"))]},
        "waitall": {"gather_pages": [(G_END, G_END.replace(".read 0", " 0"))]},
    }, ("ship", "vec16", "chunk8k", "chunk32k", "stages3", "blocks1", "waitall", "ship"),
        "gather"),
    "softmax": Group("float32", ("softmax_top1",), ("serve",), {
        "ship": {},
        "warp1": {"softmax_top1": [(SM_THREADS, SM_THREADS.replace("128", "32"))]},
        "warp2": {"softmax_top1": [(SM_THREADS, SM_THREADS.replace("128", "32")),
                                   (SM_ROWS, SM_ROWS.replace("1", "2"))]},
        "block64": {"softmax_top1": [(SM_THREADS, SM_THREADS.replace("128", "64"))]},
        "block256": {"softmax_top1": [(SM_THREADS, SM_THREADS.replace("128", "256"))]},
    }, ("ship", "warp1", "warp2", "block64", "block256", "ship"), "softmax"),
    "ab": Group("bfloat16", ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                (TRAIN_SHAPE, DH64_SHAPE), {"ship": {}}, ("ship", "ship"), "ab",
                checks=((TRAIN_SHAPE, True),)),
}

# The wrapper call of each flash kernel, on (q, k, v, do, lse, delta).
CALLS = """
CALLS = {"flash_fwd": lambda a, kw: FL.flash_forward(*a[:3], **kw),
         "flash_bwd_dq": lambda a, kw: FL.flash_bwd_dq(*a, **kw),
         "flash_bwd_dkv": lambda a, kw: FL.flash_bwd_dkv(*a, **kw)}
"""

RUN = """
import json, sys, torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build, flash as FL
dtype, kernels, shapes, checks = json.loads(sys.argv[1])
dtypes = [dtype] if isinstance(dtype, str) else dtype
tag = (lambda d: "") if len(dtypes) == 1 else (lambda d: "_" + d)
_build.build(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_wide"])
report = {"card": cs.phase_device()["nvidia_smi"]}
for name in kernels:
    entries = {}
    for mangled, e in cs.ptxas_entries(_build.build_log[name]).items():
        inst = cs.flash_instance(mangled)
        if inst is not None and inst[0] not in dtypes:
            continue
        if inst is not None and inst[0] == "bfloat16":
            e["sass"] = cs.sass_counts(_build.library_path(name), mangled)
        entries[f"{inst[1]}{tag(inst[0])}" if inst else mangled[:60]] = e
    report[name] = entries
""" + CALLS + """
for dtype in dtypes:
    dt = getattr(torch, dtype)
    for shape, causal in checks:
        check = cs.flash_check(tuple(shape), dt, causal)
        report.setdefault("train_errors" + tag(dtype), {
            n: [check[n]["rel_l2"], check[n]["row_rel_max"]] for n in ("out", "dq", "dk", "dv")})
    for shape in map(tuple, shapes):
        key = f"dh{shape[3]}{tag(dtype)}"
        q, k, v, do = cs.flash_operands(shape, dt, seed=12)
        kw = {"causal": True, "scale": shape[3] ** -0.5}
        try:
            out, lse = FL.flash_forward(q, k, v, **kw)
        except (ValueError, RuntimeError) as e:  # an earlier source without this head dim
            report[key] = str(e)[:120]
            continue
        if [list(shape), True] not in checks:
            cs.flash_check(shape, dt, True)
        args = (q, k, v, do, lse, (out.float() * do.float()).sum(-1, keepdim=True))
        report[key] = {
            f"{name}_ms": [cs.kernel_device_ms(lambda: CALLS[name](args, kw), name, calls=20)
                           for _ in range(3)] for name in kernels}
print(json.dumps(report))
"""


RUN_PAGED = """
import json, sys, numpy as np, torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build, ragged_decode as RD
dtype, kernels, shapes, _ = json.loads(sys.argv[1])
dt = getattr(torch, dtype)
_build.build(["paged_decode"])
report = {"card": torch.cuda.get_device_name(0),
          "paged_decode": {m[-40:]: e for m, e in
                           cs.ptxas_entries(_build.build_log["paged_decode"]).items()}}
for geometry, dh in shapes:
    slots = cs.PAGED_GEOMETRIES[geometry][0]
    uniform = np.full(slots, cs.PAGED_BENCH_LENGTH)
    for d in cs.PAGED_HEAD_DIMS:
        cs.paged_check((geometry, d), dt)
        cs.paged_check((geometry, d), dt, uniform)
    x = cs.paged_inputs(geometry, dt, dh, uniform if geometry == "bench_decode" else None, seed=1)
    args = (x["q"], x["k"], x["v"], x["table"], x["lengths"])
    report[f"{geometry}_dh{dh}"] = {
        "device_ms": [cs.kernel_device_ms(lambda: RD.paged_decode_attention(*args),
                                          ("paged_decode", "paged_combine")) for _ in range(3)],
        "call_ms": cs.time_ms(lambda: RD.paged_decode_attention(*args))}
print(json.dumps(report))
"""


RUN_GATHER = """
import json, sys, numpy as np, torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build, ragged_decode as RD
_build.build(["gather_pages"])
dev = cs.phase_device()
report = {"card": dev["nvidia_smi"],
          "gather_pages": {m[-40:]: e for m, e in
                           cs.ptxas_entries(_build.build_log["gather_pages"]).items()}}
gen = torch.Generator(device="cuda").manual_seed(1)
shapes = cs.gather_shapes(gen, np.random.default_rng(1))
for pool, table in cs.gather_cases(gen, shapes["lm_wide"][0]):
    cs.gather_exact(pool, table)
flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
for name, (pool, table) in shapes.items():
    cs.gather_exact(pool, table, flush)
    ids = torch.from_numpy(table).cuda()
    call = lambda: RD.gather_kv_pages(pool, ids)
    report[name] = {
        "device_ms": [cs.kernel_device_ms(call, "gather_pages") for _ in range(3)],
        "device_ms_cold_l2": [cs.kernel_device_ms(call, "gather_pages", flush=flush)
                              for _ in range(3)]}
print(json.dumps(report))
"""


RUN_AB = """
import json, sys, torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build, flash as FL
_, kernels, shapes, checks = json.loads(sys.argv[1])
_build.build(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_wide"])
dev = cs.phase_device()
report = {"card": dev["nvidia_smi"]}
""" + CALLS + """
for dt in (torch.bfloat16, torch.float32):
    for shape, causal in checks:
        cs.flash_check(tuple(shape), dt, causal)
    for shape in map(tuple, shapes):
        q, k, v, do = cs.flash_operands(shape, dt, seed=12)
        kw = {"causal": True, "scale": shape[3] ** -0.5}
        out, lse = FL.flash_forward(q, k, v, **kw)
        args = (q, k, v, do, lse, (out.float() * do.float()).sum(-1, keepdim=True))
        report[f"dh{shape[3]}_{str(dt)[6:]}"] = {
            f"{name}_ms": [cs.kernel_device_ms(lambda: CALLS[name](args, kw), name, calls=20)
                           for _ in range(3)] for name in kernels}

for dh in (160, 256):
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = cs.flash_operands((4, 4, 1024, dh), dt, 1)
        out, lse = FL.flash_forward_reference(q, k, v, causal=True, scale=dh ** -0.5)
        delta = (out.float() * do.float()).sum(-1, keepdim=True)
        report[f"wide_dh{dh}_{str(dt)[6:]}"] = {
            e: [cs.kernel_device_ms(lambda e=e: cs.launch_wide(e, q, k, v, do, lse, delta), e,
                                    calls=10)
                for _ in range(3)]
            for e in ("flash_wide_fwd", "flash_wide_bwd_dq", "flash_wide_bwd_dkv")}
# The train leg's FLOPs with wide heads and [4, 4, 1024, 320] and 512,
# through the wrappers in both dtypes; each kernel is looked up by the
# entry point the checkout's wrappers pick. An earlier source without that
# kernel reports the error.
for shape in (cs.WIDE256_SHAPE, cs.WIDE192_SHAPE, cs.WIDE384_SHAPE, (4, 4, 1024, 320),
              (4, 4, 1024, 512), (4, 4, 1024, 640)):
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = cs.flash_operands(shape, dt, seed=12)
        kw = {"causal": True, "scale": shape[3] ** -0.5}
        out, lse = FL.flash_forward_reference(q, k, v, **kw)
        args = (q, k, v, do, lse, (out.float() * do.float()).sum(-1, keepdim=True))
        row = {}
        for name in kernels:
            entry = FL._entry_name(name, shape[3], dt)
            try:
                row[f"{entry}_ms"] = [cs.kernel_device_ms(lambda: CALLS[name](args, kw), entry,
                                                          calls=10) for _ in range(3)]
            except (ValueError, RuntimeError) as e:
                row[f"{entry}_ms"] = str(e)[:120]
        report[f"{'w' if shape[0] == 8 else 'dh'}{shape[3]}_{str(dt)[6:]}"] = row
train = cs.phase_train(dev)
report["train"] = {"step_ms_p50": train["step_ms_p50"], "loss_after": train["loss_after"],
                   "flash_ms": train["traced_step"]["device_ms_by_class"]["flash"]}
print(json.dumps(report))
"""


RUN_SOFTMAX = """
import json, torch, chip_smoke as cs
from dmlc_tpu_torch.ops import _build, kernels as K
_build.build(["softmax_top1"])
dev = cs.phase_device()
report = {"card": dev["nvidia_smi"],
          "softmax_top1": {m[-48:]: e for m, e in
                           cs.ptxas_entries(_build.build_log["softmax_top1"]).items()}}
gen = torch.Generator(device="cuda").manual_seed(3)
for name, x, want in cs.softmax_cases(gen):
    cs.softmax_check(x, name, want)
x32 = torch.randn(cs.BATCH, cs.NUM_CLASSES, device="cuda", generator=gen) * 4
for dt in (torch.float32, torch.bfloat16):
    x = x32.to(dt)
    call = lambda: K.softmax_top1(x)
    report[str(dt)[6:]] = {
        "device_ms": [cs.kernel_device_ms(call, "softmax_top1") for _ in range(3)],
        "queued_us": [cs.queued_us(call) for _ in range(3)]}
# The serve path's pair: the model's bf16 logits cast to float32, then
# softmax_top1, back to back with the queue full.
x16 = x32.to(torch.bfloat16)
report["cast_pair_queued_us"] = [cs.queued_us(lambda: K.softmax_top1(x16.float()))
                                 for _ in range(3)]
report["cast_queued_us"] = [cs.queued_us(lambda: x16.float()) for _ in range(3)]
print(json.dumps(report))
"""


SCRIPTS = {"flash": RUN, "paged": RUN_PAGED, "gather": RUN_GATHER, "softmax": RUN_SOFTMAX,
           "ab": RUN_AB}


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
    if any(not list(p.glob("*.cu")) for p in args.parent):
        ap.error(f"a --parent holds no .cu sources: {args.parent}")
    root = outside_checkout(args.scratch)
    if root is None:
        print("flash_levers: SCRATCH_DIR must lie outside the checkout", file=sys.stderr)
        return 2
    spec = json.dumps([group.dtype, group.kernels, group.shapes, group.checks])
    parents = [(f"parent{j}", d) for j, d in enumerate(args.parent)]
    runs = parents + [(v, None) for v in variants] + parents[::-1]
    failed = []
    for i, (name, parent) in enumerate(runs):
        dest = root / f"{i}_{name}"
        copy_port(dest, variant_sources(args.group, name, parent))
        run = subprocess.run([sys.executable, "-c", SCRIPTS[group.script], spec], cwd=dest,
                             capture_output=True, text=True, timeout=900)
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
