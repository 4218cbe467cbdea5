// flash_bwd_dq: the query gradient of flash attention (FlashAttention-2).
//
// Replaces the TPU kernel dmlc_tpu/ops/pallas_kernels.py:_flash_bwd_dq_kernel
// (pallas_call at :559, via _flash_backward), the dQ half of
// flash_attention's custom VJP. There a sequential grid axis walks K blocks
// and carries dQ in VMEM scratch; here a loop inside the block does.
//
// Inputs q, k, v, dO: [BH, S, DH] row-major, float32 or bfloat16, DH 64,
// 128, 192, 256, 320, 384, 448 or 512, and also, at run time, any other
// multiple of 8 past 256 (ops/flash.py zero-pads a head dim up to 512 to
// one of the fixed ones, and a wider one to a multiple of 8); lse and
// delta = rowsum(dO * O): float32 [BH, S]. Output dq (q's dtype):
// dq = scale * sum_k dS k, with p = exp(scale q k^T - lse) recomputed per
// tile (0 where a key is masked: a row with lse = -inf would otherwise
// give exp(-inf - -inf) = nan, pallas_kernels.py:297) and
// dS = p * (dO v^T - delta).
//
// What bounds it on the H100: operations, three products of the
// (causally halved) [S, S] tile set, 3 * 2 * BH * S^2 * DH / 2 FLOPs:
// 77.3 GFLOP at the LM train shape (BH 48, S 2048, DH 128), 78 us at the
// 989 TFLOP/s bf16 dense peak (H100 SXM data sheet).
//
// bf16, the Hopper design (flash_sm90.cuh; the forward's skeleton with one
// more product and no online softmax): one block per (BH, 128-row Q tile),
// 384 threads. Two consumer warpgroups own 64 query rows each; one
// producer warpgroup gives its registers to them (setmaxnreg) and one of
// its threads issues every copy. TMA loads the Q and dO tiles once (64 KB)
// and streams 64-key K and V tiles through a 2-stage ring (full and empty
// mbarriers per stage; 130 KB of shared memory). Per tile, S = Q K^T and
// dP = dO V^T are wgmma from shared memory into registers, P = exp2(S scale
// log2(e) - lse log2(e)) is made while dP is multiplied, and dS = P (dP -
// delta) is made in place and rounded to bf16 as the register A operand of
// dQ += dS K (K MN-major, the transpose bit set; m64n128k16 at Dh 128,
// m64n64k16 at 64). dQ ([64, Dh] float32 a warpgroup) stays in registers
// for the whole key loop; scale is applied once, in the epilogue. A thread's accumulator rows are fixed, so it reads
// its two rows' lse and delta from global memory once. Masks run only on
// the tiles that cross the diagonal or the end of S. Causal blocks stop at
// the diagonal; the longest Q tiles of every head launch first. 64-key
// tiles ran about 1% faster than 128-key ones, and than 128-key ones with
// warpgroup 0 multiplying only the visible half of the diagonal tile
// (PERF.md, section 6; tools/flash_levers.py group dq).
//
// bf16 at Dh 192 and 256 (DqCfg): the same kernel. dQ ([64, Dh] float32,
// Dh / 2 a consumer thread: 128 registers at 256, beside S's and dP's 32
// each under the consumers' 240) is two wgmma accumulators (OutAcc in
// flash_sm90.cuh): columns [0, 128) on m64n128k16 and [128, Dh) on
// m64n64k16 at 192 or m64n128k16 at 256, both with dS as the A operand.
// The Q and dO tiles and two stages of 64-key K and V tiles take 256 KB at
// Dh 256, past the 227 KB a block can use; there V keeps one stage and
// has barriers of its own (224 KB): a warpgroup releases it once dP is
// multiplied, so the next V loads while dS, dQ and the next S are made.
// At Dh 256 one stage of K and of V ran 18% slower, and 32-key tiles in
// two stages each (S and dP on m64n32k16) 12% slower (PERF.md, section 6;
// tools/flash_levers.py group wide_dq). Its bound at [8, 3, 2048, 256]
// (the LM train shape's FLOPs as 3 heads of 256): operations, 78 us.
//
// bf16 past Dh 256 (320, 384, 448, 512; DqWideCfg, dq_wide_consumer,
// flash_bwd_dq_wide_kernel_sm90): every bf16 head in (256, 512] pads to
// one of them. The design of Dh 256 does not fit: a [128, 512] Q tile and
// its dO tile take 256 KB, and dQ over all of Dh would be 256 floats a
// thread. So a block holds 64 query rows, which both consumer warpgroups
// share (the bf16 forward's split past 256, csrc/flash_fwd.cu
// FwdWideCfg): warpgroup 0 owns dQ's first whole 64-column boxes (192 of
// 320, 256 of 448), warpgroup 1 the rest, at most 128 floats a thread
// (OutAcc). S = Q K^T and dP = dO V^T (m64nBKk16) are split over Dh's k16
// steps: each warpgroup makes its half of both, writes the partials to
// shared memory (double-buffered by tile parity), waits on one named
// barrier of both warpgroups and adds the other's; a + b == b + a, so
// both hold the same S, P and dS, which each rounds to bf16 as the
// register A operand of dQ += dS K over its own boxes of K (MN-major).
// Q and dO take 128 KB at 512, so past 320 K/V tiles take 16 keys, two
// stages of K and one of V (V released once dP is made; 48 KB), and the
// partials 32 KB: 209 KB at 512; at 320, 32-key tiles in two stages each
// (225 KB). On an H100 80GB HBM3 at 700 W (PERF.md, section 6;
// tools/flash_levers.py group wide_bwd_bf16) 32-key tiles ran 19-23%
// faster than 16-key ones at 320, and one V stage 4-5% faster than two at
// [8, 2, 2048, 384] (at 512 within the 4% by which two readings of one
// build differed). Scale is applied once, in the epilogue, which stages
// each warpgroup's columns through Q; a thread reads its rows' lse and
// delta once; masks run only on the tiles that cross the diagonal or the
// end of S; the longest causal Q tiles launch first.
// Bound at [4, 4, 1024, 512]: operations, 26 us.
//
// float32, the FMA design (flash::f32 below; the float32 forward's, with one
// more product and no online softmax): Hopper has no full-float32
// tensor-core product, so the products are register-tiled FMA on the CUDA
// cores in full float32 (no TF32), bound by the 67 TFLOP/s float32 peak
// (1.15 ms at the train shape). One block of 128 threads per (BH, 64-row Q
// tile). The threads form 8 row groups of 16 (a half-warp each); group g
// owns query rows g + 8 i (i < 8). Q and dO stay in shared memory; K and V
// tiles (32 keys at Dh 128, 64 at Dh 64) come by cp.async, each loaded
// after the products of the one before. Per tile a thread computes S = Q
// K^T and dP = dO V^T for its 8 rows x 2 (4) keys (c + 16 u) in registers,
// in one pass along Dh (float4 reads; Q's and dO's broadcast across the
// half-warp), then p = exp(S scale - lse) and dS = p (dP - delta) there,
// with its rows' lse and delta read once before the loop. dS goes to shared
// memory once, read back only by the half-warp that wrote it, as the A
// operand of dQ += dS K; dQ ([8 rows, Dh / 16 columns] a thread) stays in
// registers for the whole loop and scale is applied once, in the epilogue.
// The two products' steps are the forward's (dot4, pv4; flash_common.cuh).
// Masks run only on the tiles that cross the diagonal or the end of S;
// causal blocks stop at the diagonal and the longest Q tiles of every head
// launch first. Shared memory: 108 KB at Dh 128 (two blocks an SM), 85 KB
// at Dh 64. Loading each tile after the products beat a 2-stage ring (the
// ring's extra K/V tiles leave fewer blocks an SM), 64-row Q tiles beat
// 32-row ones, and 64-key tiles beat 32-key ones at Dh 64 but not at 128
// (PERF.md, section 6; tools/flash_levers.py group dq_f32).
//
// float32 at Dh 192 and 256 (DqCfg): heads in (128, 256] pad to them. The
// same kernel: dQ 96 or 128 floats a thread, one K/V stage (160 or 204 KB:
// one block of 4 warps an SM). Two parts of 128 threads sharing the tiles
// at 256, part 0 making S and P and part 1 dP and dS, each keeping half of
// dQ's columns (8 warps an SM), ran 1.2% faster in one call, less than
// the 4% by which repeated calls of one build differed, so this kernel
// serves both. Splitting Dh between two parts instead, as the float32
// forward does at 256, adds partial S and dP in another order than one dot
// product; that moved the dQ row of a causal head's first query (whose
// exact value is 0) past the 2e-5 row limit. 32-row Q tiles at 192 (two
// blocks an SM) ran 10% slower. Bound at [8, 3, 2048, 256]: operations,
// 1.15 ms at the float32 peak (PERF.md, section 6; tools/flash_levers.py
// group wide_bwd_f32).
//
// float32 past Dh 256 (320, 384, 448, 512; DqCfg<DH, true>, dq_part,
// flash_bwd_dq_f32_wide_kernel): every float32 head in (256, 512] pads to
// one of them. The kernel above does not fit there: a [64, 516] Q tile
// and its dO tile take 264 KB at 512, and dQ over all of Dh would be 256
// floats a thread. So two parts of 128 threads share the block's 32-row Q
// and dO tiles and 32-key K/V tiles (row group g owns rows g + 8 i, i <
// 4). Part 0 owns dQ's first whole 64-column steps (192 of 320, 256 of
// 448), part 1 the rest: at most 64 floats a thread. Each part makes S =
// Q K^T and dP = dO V^T over its half of Dh, writes both partials to
// shared memory, waits for its twin warp in the other part (a named
// barrier of 64 threads) and adds the other's partials; a + b == b + a,
// so both parts hold the same S, dP and dS, which each writes over the
// other's partial S and reads back as the A operand of its dQ += dS K.
// (The halves move a row of dQ by float32 rounding only; the flash check
// floors each row's norm at the tensor's RMS row norm, under which the
// exact-zero row noted above stays within the 2e-5 row limit.)
// Shared memory: Q and dO 83-132 KB; up to 384 K and V of 32 keys beside
// them (184-217 KB); past 384 they do not both fit, so V and then K pass
// through one slot (kOneSlot): V is read only by dP, and K loads once dP
// is made (192-217 KB). One block of 8 warps an SM; 158-173 registers, no
// spill. Bound at [4, 4, 1024, 512]: operations, 0.385 ms at the float32
// peak. Levers that lost (PERF.md, section 6; tools/flash_levers.py group
// xl_bwd_f32): part 0 making S and part 1 dP over all of Dh, P and dS
// handed over (even at 320 and 384; past 384 it has no one-slot form, and
// with 16-key tiles in two slots it ran 24% slower); 16-key tiles (28-31%
// slower); 64-row Q tiles with 16-key tiles at 320 (8-11%); one slot at
// 320 and 384 too (4-5%).
//
// float32 past Dh 512, at any multiple of 8 past 256 (DqXlCfg, DqXlPlan,
// dq_xl_part, flash_bwd_dq_xl_f32_kernel<W>): every float32 head past 512
// pads to a multiple of 8, and a direct call takes any other past 256.
// The kernels above keep whole-Dh tiles, and a padded 32-row float32 tile
// of 640 columns already takes 82 KB; so here the head dim is a run-time
// argument and shared memory does not grow with it. dQ is cut into column
// chunks of at most 10 64-column steps, one a block, in a power of two of
// chunks (640 in one, 768 and 1024 in two); part 0 owns the larger half of
// a chunk's steps, at most 80 floats a thread. The blocks of one Q tile's
// chunks form a thread-block cluster, and S = Q K^T and dP = dO V^T are
// split over Dh's 64-column slabs between its blocks and, within a block,
// between the two parts. Each part adds the other's partials behind its
// twin warp's named barrier, and each block the cluster's block sums
// through distributed shared memory in rank order (one cluster barrier a
// K/V tile, the sums double-buffered by its parity): a + b == b + a, so
// every part of every chunk's block holds the same S, dP and dS to the
// bit, and no chunk makes the scores again. K, V and dO stream in
// 64-column slabs through a 2-slot cp.async ring, both parts' in a slot;
// the block's slabs of Q stay resident (up to 11, every head dim the
// public functions take up to 1408) and stream beside K past that; after
// dS, the chunk's K slabs pass through the same ring, two steps of each
// part a slot. 228-254 registers, no spill. Bound at [4, 4, 1024, 640]:
// operations, 0.481 ms at the float32 peak. On an H100 80GB HBM3 at 700 W
// (PERF.md, section 6; tools/flash_levers.py group xl_bwd512): Q streamed
// ran 5-8% slower; chunks of 8 or 6 steps, which put 640 in two blocks,
// 66% slower there; 16-row tiles 43-50%; a 3-slot ring 6-18% slower
// (before the clusters; with them it no longer fits); chunks of 12 steps
// spill at 6 a part. Before the clusters, each chunk's block made the
// whole scores, and 1024 ran 1.45x the time.
//
// bf16 past Dh 512, at any multiple of 8 past 256 (DqXlCfg, DqXlPlan,
// dq_xl_consumer, flash_bwd_dq_xl_kernel_sm90<W>): every bf16 head past
// 512 pads to a multiple of 8, and a direct call takes any other past 256.
// The bf16 design above keeps 64-row Q and dO tiles resident: 160 KB at
// 640, and past the 227 KB a block can use beside K/V tiles and partials
// from 520 on. So here Q and dO stream too, and the head dim is a run-time
// argument. A block holds 64 query rows and one column chunk of dQ of at
// most 10 boxes, in as few chunks as fit (520 and 640 in one, 768 and
// 1024 in two), the first half of its boxes to warpgroup 0 and the rest to
// warpgroup 1 (WideAcc of at most 320 columns, 160 floats a thread).
// Warpgroup 0 makes S = Q K^T and
// warpgroup 1 dP = dO V^T (m64n32k16), each over all of Dh's 64-column
// slabs, streamed through a TMA ring of 4 slots of its own (xl_score in
// flash_sm90.cuh; a slot holds a slab of Q or dO and the same of K or V).
// The two hand each other P and dP through shared memory (one named
// barrier a tile) and both make dS = P (dP - delta) from the same floats,
// the register A operand of dQ += dS K over their boxes of the chunk's K
// columns (two tiles in flight). So every chunk's block makes the scores
// again, in one order, and holds the same P and dS to the bit: 5/3 of the
// FLOPs at two chunks. 168 registers at launch, 240 a consumer thread, no
// spill (the block's indices are made by each role after setmaxnreg,
// dq_xl_block, as in the dK/dV past 512); at most 214240 bytes of shared
// memory. Bound at [4, 4, 1024, 640]: operations, 33 us. On an H100 80GB
// HBM3 at 700 W (PERF.md, section 6; tools/flash_levers.py group
// xl_bwd_bf16; 0.180, 0.470 and 0.661 ms at [4, 4, 1024, 640], 1024 and
// [8, 1, 2048, 768]): chunks of 8 boxes (640 in two) ran 73% slower at
// 640; the chunks' blocks as a thread-block cluster that splits the slabs
// and adds the blocks' partial S and dP in rank order (kCluster,
// xl_cluster_sum; chunks of 8 boxes) 26-58% slower than those chunks each
// making the scores; 16-key tiles 57-61% slower; slab rings of 2 55-67%
// slower; three K stages the same.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {

namespace f32 {

constexpr int kDqRows = 64;          // query rows a block
constexpr int kDqRowsPerThread = 8;  // rows a row group (16 threads) owns
constexpr int kDqStages = 1;         // K/V ring depth
constexpr int kDqThreads = 16 * kDqRows / kDqRowsPerThread;

// The float32 dQ's tiles at head dim DH. Dh 192 and 256 keep dQ's 96 and
// 128 floats a thread beside one K/V stage (160 and 204 KB of shared
// memory, one block of 4 warps an SM).
template <int DH, bool kWide = (DH > 256)>
struct DqCfg {
  // Keys a K/V tile: 64 at Dh 64; 32 from Dh 128, where 64 ran 9% slower
  // (PERF.md, section 6).
  static constexpr int BQ = kDqRows, BK = DH == 64 ? 64 : 32, RPT = kDqRowsPerThread;
  static constexpr int kThreads = kDqThreads, G = BQ / RPT;  // G row groups
  static constexpr int LD = DH + 4;    // Q, dO, K, V rows (floats), padded by 16 bytes
  static constexpr int LDS = BK + 4;   // dS rows
  static constexpr int NKT = BK / 16;  // keys a thread owns in S and dP
  static constexpr int NC4 = DH / 64;  // float4 columns a thread owns in dQ
  static constexpr size_t bytes = sizeof(float) * (2 * (size_t)BQ * LD +
                                                   2 * kDqStages * (size_t)BK * LD +
                                                   (size_t)BQ * LDS);
};

// Past Dh 256 (320, 384, 448, 512): two parts of 128 threads share the
// block's Q, dO, K and V tiles. Part 0 owns dQ's first W0 columns (whole
// 64-column steps, the larger share at 320 and 448), part 1 the rest: at
// most 256 columns, 64 floats a thread. Each part makes S = Q K^T and dP
// = dO V^T over half of Dh (WS columns from s0) and adds the other's
// partials through shared memory, so both hold the same S, dP and dS (four
// score tiles: each part's partial S and dP). A padded row takes 4 (DH +
// 4) bytes, 2 KB at 512: 32-row Q tiles (4 rows a row group) and 32-key
// K/V tiles, one stage. Past 384 K and V do not both fit beside Q and dO
// with 32 keys, so V and then K pass through one tile slot (kOneSlot): V
// is read only by dP, K is loaded once dP is made (142-217 KB).
template <int DH>
struct DqCfg<DH, true> {
  static constexpr int kParts = 2;
  static constexpr bool kOneSlot = DH > 384;    // V, then K, in one K/V tile
  static constexpr int BQ = 32, BK = 32, RPT = BQ / 8;
  static constexpr int G = BQ / RPT, kPartThreads = 16 * G, kThreads = kParts * kPartThreads;
  static constexpr int W0 = 64 * ((DH / 64 + 1) / 2), W1 = DH - W0;
  static constexpr int WS = DH / 2;  // S and dP over half of Dh a part
  static constexpr int LD = DH + 4, LDS = BK + 4, NKT = BK / 16;
  static constexpr int kTiles = 4;  // [BQ, LDS] score tiles
  // Q, dO, K and V (kOneSlot: one of them), the score tiles.
  static constexpr size_t bytes = sizeof(float) * (2 * (size_t)BQ * LD +
                                                   (kOneSlot ? 1 : 2) * (size_t)BK * LD +
                                                   kTiles * (size_t)BQ * LDS);
};

// K/V tiles that the Q tile at q0 reads: up to its diagonal when causal.
template <int DH>
__device__ __forceinline__ int dq_tiles(int q0, int S, int causal) {
  typedef DqCfg<DH> C;
  return ((causal ? min(q0 + C::BQ, S) : S) + C::BK - 1) / C::BK;
}

template <int DH>
__global__ void __launch_bounds__(kDqThreads, DH == 64 ? 2 : 1)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int BH, int S, int causal, float scale) {
  typedef DqCfg<DH> C;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDS = C::LDS, G = C::G, RPT = C::RPT;
  constexpr int NKT = C::NKT, NC4 = C::NC4, STAGES = kDqStages;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * LD;
  float* KVs = dOs + BQ * LD;  // stage s: K at KVs + 2 s BK LD, V BK LD after it
  float* dSs = KVs + 2 * STAGES * BK * LD;

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * BQ;
  const size_t base = (size_t)bh * S * DH;
  const int g = threadIdx.x / 16, c = threadIdx.x % 16;
  const int n_k = dq_tiles<DH>(q0, S, causal);

  // Tile j goes to stage j % STAGES, one commit group a tile: the first
  // STAGES tiles (Q and dO with the first) now, tile j + STAGES once every
  // thread is done with tile j.
  auto load_kv = [&](int j) {
    if (j < n_k) {
      float* Kt = KVs + (j % STAGES) * 2 * BK * LD;
      cp_tile<BK, DH, LD, C::kThreads>(Kt, k + base, j * BK, S);
      cp_tile<BK, DH, LD, C::kThreads>(Kt + BK * LD, v + base, j * BK, S);
    }
    cp_async_commit();
  };
  cp_tile<BQ, DH, LD, C::kThreads>(Qs, q + base, q0, S);
  cp_tile<BQ, DH, LD, C::kThreads>(dOs, dout + base, q0, S);
#pragma unroll
  for (int j = 0; j < STAGES; ++j) load_kv(j);

  // The thread's rows' lse and delta, and its part of dQ.
  float lse_r[RPT], dlt[RPT], acc[RPT][NC4][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + g + G * i;
    lse_r[i] = qi < S ? lse[(size_t)bh * S + qi] : 0.f;
    dlt[i] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
#pragma unroll
    for (int h = 0; h < NC4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.f;
  }

  for (int j = 0; j < n_k; ++j) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile j (and Q, dO) in shared memory for every thread
    const float* Kt = KVs + (j % STAGES) * 2 * BK * LD;
    const float* Vt = Kt + BK * LD;
    const int k0 = j * BK;

    // S = Q K^T and dP = dO V^T for rows g + G i and keys c + 16 u.
    float s[RPT][NKT], dp[RPT][NKT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) s[i][u] = dp[i][u] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DH; kk += 4) {
      dot4<RPT, NKT, G, LD>(s, Qs + kk, Kt + kk, g, c);
      dot4<RPT, NKT, G, LD>(dp, dOs + kk, Vt + kk, g, c);
    }

    // p = exp(S scale - lse), 0 where masked, which only the tiles crossing
    // the diagonal or the end of S need; dS = p (dP - delta) to shared.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = g + G * i, qi = q0 + row;
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        float p = expf(s[i][u] * scale - lse_r[i]);
        if (edge) {
          const int kj = k0 + c + 16 * u;
          if (kj >= S || (causal && kj > qi)) p = 0.f;
        }
        dSs[row * LDS + c + 16 * u] = p * (dp[i][u] - dlt[i]);
      }
    }
    __syncwarp();  // a row group's dS rows are written and read by its own half-warp

    // dQ += dS K: dS rows along the keys as float4, K rows at columns 64 h + 4 c.
#pragma unroll 2
    for (int jj = 0; jj < BK; jj += 4) pv4<RPT, NC4, G, LDS, LD>(acc, dSs + jj, Kt + jj * LD, g, c);
    __syncthreads();  // every reader of this stage and of dS is done
    load_kv(j + STAGES);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + g + G * i;
    if (qi < S) {
#pragma unroll
      for (int h = 0; h < NC4; ++h)
        *reinterpret_cast<float4*>(dq + base + (size_t)qi * DH + 64 * h + 4 * c) =
            make_float4(acc[i][h][0] * scale, acc[i][h][1] * scale, acc[i][h][2] * scale,
                        acc[i][h][3] * scale);
    }
  }
}

// One part's loop and epilogue past Dh 256 (DqCfg<DH, true>): dQ's 64 NC4
// columns from col0 (NC4 float4 columns a thread). Q, dO and the K/V tile
// are the block's; Xs holds its kTiles [BQ, LDS] score tiles.
template <int DH, int NC4>
__device__ __forceinline__ void dq_part(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, float* __restrict__ dq,
                                        float* Qs, float* dOs, float* KVs, float* Xs, int bh,
                                        int S, int q0, int causal, float scale, int part,
                                        int col0) {
  typedef DqCfg<DH> C;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDS = C::LDS, G = C::G, RPT = C::RPT;
  constexpr int NKT = C::NKT;
  const size_t base = (size_t)bh * S * DH;
  const int tp = threadIdx.x % C::kPartThreads, g = tp / 16, c = tp % 16;
  const int pair = 1 + tp / 32;  // the barrier of this warp and its twin in the other part
  const int n_k = dq_tiles<DH>(q0, S, causal);
  float* Kt = KVs;
  float* Vt = C::kOneSlot ? KVs : KVs + BK * LD;
  // Part p writes its partial S and dP to tiles p and 2 + p, reads the
  // other's from 1 - p and 3 - p, and writes dS over the other's partial S
  // (read back only by the half-warp that wrote it).
  float* Xmine = Xs + part * BQ * LDS;
  float* Xother = Xs + (1 - part) * BQ * LDS;
  float* dSs = Xother;

  auto load_k = [&](int j) { cp_tile<BK, DH, LD, C::kThreads>(Kt, k + base, j * BK, S); };
  auto load_v = [&](int j) { cp_tile<BK, DH, LD, C::kThreads>(Vt, v + base, j * BK, S); };
  cp_tile<BQ, DH, LD, C::kThreads>(Qs, q + base, q0, S);
  cp_tile<BQ, DH, LD, C::kThreads>(dOs, dout + base, q0, S);
  if (!C::kOneSlot) load_k(0);
  load_v(0);
  cp_async_commit();

  // The thread's rows' lse and delta, and its part of dQ.
  float lse_r[RPT], dlt[RPT], acc[RPT][NC4][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + g + G * i;
    lse_r[i] = qi < S ? lse[(size_t)bh * S + qi] : 0.f;
    dlt[i] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
#pragma unroll
    for (int h = 0; h < NC4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.f;
  }

  const int s0 = part * C::WS;
  for (int j = 0; j < n_k; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j (and Q, dO) in shared memory for every thread
    const int k0 = j * BK;

    // S = Q K^T and dP = dO V^T for rows g + G i and keys c + 16 u, over
    // this part's half of Dh.
    float s[RPT][NKT], dp[RPT][NKT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) s[i][u] = dp[i][u] = 0.f;
    if constexpr (C::kOneSlot) {
#pragma unroll 4
      for (int kk = s0; kk < s0 + C::WS; kk += 4)
        dot4<RPT, NKT, G, LD>(dp, dOs + kk, Vt + kk, g, c);
      __syncthreads();  // every read of V is done: K takes its slot
      load_k(j);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 4
      for (int kk = s0; kk < s0 + C::WS; kk += 4) dot4<RPT, NKT, G, LD>(s, Qs + kk, Kt + kk, g, c);
    } else {
#pragma unroll 4
      for (int kk = s0; kk < s0 + C::WS; kk += 4) {
        dot4<RPT, NKT, G, LD>(s, Qs + kk, Kt + kk, g, c);
        dot4<RPT, NKT, G, LD>(dp, dOs + kk, Vt + kk, g, c);
      }
    }
    // The two parts' dot products: S and dP are their sums (the same in both).
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        Xmine[(g + G * i) * LDS + c + 16 * u] = s[i][u];
        Xmine[(2 * BQ + g + G * i) * LDS + c + 16 * u] = dp[i][u];
      }
    pair_sync(pair);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        s[i][u] += Xother[(g + G * i) * LDS + c + 16 * u];
        dp[i][u] += Xother[(2 * BQ + g + G * i) * LDS + c + 16 * u];
      }

    // p = exp(S scale - lse), 0 where masked, which only the tiles crossing
    // the diagonal or the end of S need; dS = p (dP - delta) to shared.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = g + G * i, qi = q0 + row;
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        float p = expf(s[i][u] * scale - lse_r[i]);
        if (edge) {
          const int kj = k0 + c + 16 * u;
          if (kj >= S || (causal && kj > qi)) p = 0.f;
        }
        dSs[row * LDS + c + 16 * u] = p * (dp[i][u] - dlt[i]);
      }
    }
    __syncwarp();  // a half-warp reads back the dS rows its own half-warp wrote

    // dQ += dS K: dS rows along the keys as float4, K rows at columns col0 + 64 h + 4 c.
#pragma unroll 2
    for (int jj = 0; jj < BK; jj += 4)
      pv4<RPT, NC4, G, LDS, LD>(acc, dSs + jj, Kt + jj * LD + col0, g, c);
    __syncthreads();  // every reader of the K/V tile and of the score tiles is done
    if (j + 1 < n_k) {
      if (!C::kOneSlot) load_k(j + 1);
      load_v(j + 1);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy left in flight when the block exits

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + g + G * i;
    if (qi < S) {
#pragma unroll
      for (int h = 0; h < NC4; ++h) {
        const float* a = acc[i][h];
        *reinterpret_cast<float4*>(dq + base + (size_t)qi * DH + col0 + 64 * h + 4 * c) =
            make_float4(a[0] * scale, a[1] * scale, a[2] * scale, a[3] * scale);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(DqCfg<DH>::kThreads, 1)
    flash_bwd_dq_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 float* __restrict__ dq, int BH, int S, int causal, float scale) {
  typedef DqCfg<DH> C;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + C::BQ * C::LD;
  float* KVs = dOs + C::BQ * C::LD;  // K, then V (kOneSlot: one tile)
  float* Xs = KVs + (C::kOneSlot ? 1 : 2) * C::BK * C::LD;

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + C::BQ - 1) / C::BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * C::BQ;
  const int part = threadIdx.x / C::kPartThreads;
  if constexpr (C::W0 == C::W1) {
    dq_part<DH, C::W0 / 64>(q, k, v, dout, lse, delta, dq, Qs, dOs, KVs, Xs, bh, S, q0, causal,
                            scale, part, part * C::W0);
  } else if (part == 0) {
    dq_part<DH, C::W0 / 64>(q, k, v, dout, lse, delta, dq, Qs, dOs, KVs, Xs, bh, S, q0, causal,
                            scale, 0, 0);
  } else {
    dq_part<DH, C::W1 / 64>(q, k, v, dout, lse, delta, dq, Qs, dOs, KVs, Xs, bh, S, q0, causal,
                            scale, 1, C::W0);
  }
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s, int causal,
                      float scale, cudaStream_t stream) {
  typedef DqCfg<DH> C;
  auto run = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, C::bytes);
    if (e != cudaSuccess) return e;
    const long long blocks = (long long)((s + C::BQ - 1) / C::BQ) * bh;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, C::kThreads, C::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq), bh, s, causal, scale);
    return cudaGetLastError();
  };
  if constexpr (DH > 256)
    return run(flash_bwd_dq_f32_wide_kernel<DH>);
  else
    return run(flash_bwd_dq_f32_kernel<DH>);
}

// The float32 dQ at any other head dim past 256 (every multiple of 8 past
// 512 on the public route; flash_bwd_dq_xl_f32_kernel). Tiles of 32 query
// rows and 32 keys; two parts of 128 threads, 8 row groups of RPT rows
// each. dQ is cut into column chunks, one a block, of at most 2 kMaxSteps
// 64-column steps; part 0 owns the larger half of a chunk's steps, part 1
// the rest. The blocks of one Q tile's chunks form clusters of
// DqXlPlan::cluster blocks (all of them up to 8 chunks), and the cluster
// splits S = Q K^T and dP = dO V^T over Dh's 64-column slabs: block r of R
// takes slabs [r nb / R, (r + 1) nb / R), part 0 of it the first half of
// those and part 1 the rest. Each part adds the other's partials, then
// each block the cluster's block sums, read through distributed shared
// memory in rank order, so every part of every chunk's block holds the
// same S, dP and dS to the bit. The slabs pass through a cp.async ring of
// kRing slots, both parts' in a slot: K, V and dO (and Q, unless the
// block's slabs of it stay resident) for the scores, then the chunk's K for
// dQ += dS K, two steps of each part a slot.
struct DqXlCfg {
  static constexpr int BK = 32, BQ = 32, RPT = BQ / 8;  // keys, query rows, rows a row group
  static constexpr int G = 8, kPartThreads = 16 * G, kThreads = 2 * kPartThreads;
  static constexpr int kMaxSteps = 5;        // 64-column steps of dQ a part holds
  static constexpr int kRing = 2;            // slab ring depth
  static constexpr int kQResidentSteps = 11;  // Q stays in shared memory up to this many slabs
  static constexpr int LDS = 64 + 4;         // a slab's rows (floats), padded by 16 bytes
  static constexpr int LDX = BK + 4, NKT = BK / 16;
};

// What a head dim gives the float32 dQ past 256: nb 64-column slabs of Dh
// (the last one zero past it), the chunks of dQ, the steps of the widest
// part, whether Q stays resident, and the block's shared memory.
struct DqXlPlan {
  int nb, chunks, width, cluster;
  bool q_res;
  __host__ __device__ explicit DqXlPlan(int dh)
      : nb((dh + 63) / 64),
        chunks(xl_chunks(nb, 2 * DqXlCfg::kMaxSteps)),
        width(xl_width(nb, 2 * DqXlCfg::kMaxSteps, 2)),
        cluster(xl_cluster(chunks)),
        q_res(most_slabs() <= DqXlCfg::kQResidentSteps) {}
  // The most slabs of the scores a block of a cluster takes.
  __host__ __device__ int most_slabs() const { return (nb + cluster - 1) / cluster; }
  // The least and the most steps the widest part of a head dim past 256
  // holds: the instantiations built.
  static constexpr int kMinWidth = xl_width_bound(2 * DqXlCfg::kMaxSteps, 2, false);
  static constexpr int kMaxWidth = xl_width_bound(2 * DqXlCfg::kMaxSteps, 2, true);
  __host__ __device__ int ldq() const { return 64 * most_slabs() + 4; }
  __host__ __device__ int q_floats() const { return q_res ? DqXlCfg::BQ * ldq() : 0; }
  // A part's share of a ring slot: its K, V and dO slabs, and Q's unless resident.
  __host__ __device__ int share_floats() const {
    return (2 * DqXlCfg::BK + (q_res ? 1 : 2) * DqXlCfg::BQ) * DqXlCfg::LDS;
  }
  // Q (resident), the ring, four [BQ, LDX] score tiles, and in a cluster
  // two more for each parity of the K/V tile: the block's sums of S and dP.
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)q_floats() + (size_t)DqXlCfg::kRing * 2 * share_floats() +
                            (cluster > 1 ? 8 : 4) * DqXlCfg::BQ * DqXlCfg::LDX);
  }
};

// K/V tiles that the Q tile at q0 reads: up to its diagonal when causal.
__device__ __forceinline__ int dq_xl_tiles(int q0, int S, int causal) {
  const int end = causal ? min(q0 + DqXlCfg::BQ, S) : S;  // one past the last key read
  return (end + DqXlCfg::BK - 1) / DqXlCfg::BK;
}

// One part of the float32 dQ past 256: NC 64-column steps of dQ from the
// chunk's step c0 (the chunk's first column is 64 b0).
template <int NC>
__device__ __forceinline__ void dq_xl_part(const DqXlPlan& p, const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ dout,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           float* __restrict__ dq, float* Qs, float* ring,
                                           float* Xs, int bh, int S, int dh, int q0, int causal,
                                           float scale, int part, int rank, int b0, int nbc,
                                           int c0) {
  typedef DqXlCfg C;
  constexpr int BQ = C::BQ, BK = C::BK, RPT = C::RPT, G = C::G, LDS = C::LDS, LDX = C::LDX;
  constexpr int NKT = C::NKT;
  const size_t base = (size_t)bh * S * dh;
  const int tp = threadIdx.x % C::kPartThreads, g = tp / 16, c = tp % 16;
  const int pair = 1 + tp / 32;  // the barrier of this warp and its twin in the other part
  // The block's slabs of S and dP, from s0 (part 0 the first nd0 of them,
  // part 1 the rest): the same for the block of this rank in every cluster.
  const int s0 = rank * p.nb / p.cluster, ns = (rank + 1) * p.nb / p.cluster - s0;
  const int nd0 = (ns + 1) / 2;
  const int n0 = (nbc + 1) / 2;    // part 0's steps of the chunk; part 1 the rest
  const int n_out = (n0 + 1) / 2;  // ring steps of dQ += dS K a tile
  const int per_tile = nd0 + n_out, share = p.share_floats(), slot = 2 * share;
  const int n_k = dq_xl_tiles(q0, S, causal), n_loads = n_k * per_tile;
  // Part p writes its partial S and dP to tiles p and 2 + p, reads the
  // other's from 1 - p and 3 - p, and writes dS over the other's partial S
  // (read back only by the half-warp that wrote it).
  float* Xmine = Xs + part * BQ * LDX;
  float* Xother = Xs + (1 - part) * BQ * LDX;
  float* dSs = Xother;
  float* sums = Xs + 4 * BQ * LDX;  // the block's S and dP sums, two a K/V tile parity

  // Slabs [d, d + nd) (64 columns each) of rows [row0, row0 + rows) of
  // src into a tile of row stride ld: zero past S and past Dh.
  auto span = [&](float* sm, int ld, const float* src, int row0, int rows, int d, int nd) {
    cp_span<C::kThreads>(sm, ld, src + base, dh, row0, rows, S, 64 * d, 64 * nd, dh);
  };
  auto slab = [&](float* sm, const float* src, int row0, int rows, int d) {
    span(sm, LDS, src, row0, rows, d, 1);
  };
  // Load n, step r = n % per_tile of K/V tile j = n / per_tile: for r <
  // nd0 slab r of part 0 and nd0 + r of part 1 (K, V, dO, and Q unless it
  // is resident: a part's share of the slot holds them in that order),
  // after that the chunk's K slabs of each part's dQ steps 2 (r - nd0) and
  // the next.
  auto load = [&](int n) {
    const int j = n / per_tile, r = n % per_tile;
    float* dst = ring + (n % C::kRing) * slot;
#pragma unroll
    for (int h = 0; h < 2; ++h, dst += share) {
      if (r < nd0) {
        const int d = h * nd0 + r;
        if (d < ns) {
          slab(dst, k, j * BK, BK, s0 + d);
          slab(dst + BK * LDS, v, j * BK, BK, s0 + d);
          slab(dst + 2 * BK * LDS, dout, q0, BQ, s0 + d);
          if (!p.q_res) slab(dst + (2 * BK + BQ) * LDS, q, q0, BQ, s0 + d);
        }
      } else {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int st = 2 * (r - nd0) + x;  // the part's step
          if (st < (h == 0 ? n0 : nbc - n0))
            slab(dst + x * BK * LDS, k, j * BK, BK, b0 + h * n0 + st);
        }
      }
    }
  };
  // Ring step n: load n + kRing - 1 starts and load n is waited for.
  auto step_in = [&](int n) {
    if (n + C::kRing - 1 < n_loads) load(n + C::kRing - 1);
    cp_async_commit();
    cp_async_wait<C::kRing - 1>();
    __syncthreads();  // load n (and Q with the first) in shared memory for every thread
  };
  if (p.q_res) span(Qs, p.ldq(), q, q0, BQ, s0, ns);
#pragma unroll
  for (int n = 0; n < C::kRing - 1; ++n) {
    if (n < n_loads) load(n);
    cp_async_commit();
  }

  // The thread's rows' lse and delta, and its steps of dQ.
  float lse_r[RPT], dlt[RPT], acc[NC][RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + g + G * i;
    lse_r[i] = qi < S ? lse[(size_t)bh * S + qi] : 0.f;
    dlt[i] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
#pragma unroll
    for (int h = 0; h < NC; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][i][e] = 0.f;
  }

  int ld = 0;  // loads consumed
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK;
    // Partial S = Q K^T and dP = dO V^T for rows g + G i and keys c + 16 u,
    // over this part's slabs.
    float s[RPT][NKT], dp[RPT][NKT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) s[i][u] = dp[i][u] = 0.f;
    for (int i = 0; i < nd0; ++i, ++ld) {
      step_in(ld);
      const int d = part * nd0 + i;
      if (d < ns) {
        const float* sl = ring + (ld % C::kRing) * slot + part * share;
        const float* qa = p.q_res ? Qs + 64 * d : sl + (2 * BK + BQ) * LDS;
        const int lda = p.q_res ? p.ldq() : LDS;
#pragma unroll 2
        for (int kk = 0; kk < 64; kk += 4) {
          dot4_lda<RPT, NKT, G, LDS>(s, qa + kk, lda, sl + kk, g, c);
          dot4<RPT, NKT, G, LDS>(dp, sl + 2 * BK * LDS + kk, sl + BK * LDS + kk, g, c);
        }
      }
      __syncthreads();  // every reader of this slot is done before a later load lands in it
    }
    // S and dP are the two parts' partial sums added (the same in both,
    // and in every chunk's block).
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        Xmine[(g + G * i) * LDX + c + 16 * u] = s[i][u];
        Xmine[(2 * BQ + g + G * i) * LDX + c + 16 * u] = dp[i][u];
      }
    pair_sync(pair);  // warp w of each part holds the same rows
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        s[i][u] += Xother[(g + G * i) * LDX + c + 16 * u];
        dp[i][u] += Xother[(2 * BQ + g + G * i) * LDX + c + 16 * u];
      }
    if (p.cluster > 1) {
      // S and dP are the cluster's block sums added in rank order: the same
      // in every block. A tile parity's sums are overwritten only after the
      // next K/V tile's cluster barrier, by which every block has read them.
      float* mine = sums + (j & 1) * 2 * BQ * LDX;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < NKT; ++u)
          mine[(part * BQ + g + G * i) * LDX + c + 16 * u] = part == 0 ? s[i][u] : dp[i][u];
      cluster_sync();
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < NKT; ++u) {
          const int at = (g + G * i) * LDX + c + 16 * u;
          float s_sum = peer_ld(mine + at, 0), dp_sum = peer_ld(mine + BQ * LDX + at, 0);
          for (int b = 1; b < p.cluster; ++b) {
            s_sum += peer_ld(mine + at, b);
            dp_sum += peer_ld(mine + BQ * LDX + at, b);
          }
          s[i][u] = s_sum;
          dp[i][u] = dp_sum;
        }
    }

    // p = exp(S scale - lse), 0 where masked, which only the tiles crossing
    // the diagonal or the end of S need; dS = p (dP - delta) to shared.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = g + G * i, qi = q0 + row;
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        float pr = expf(s[i][u] * scale - lse_r[i]);
        if (edge) {
          const int kj = k0 + c + 16 * u;
          if (kj >= S || (causal && kj > qi)) pr = 0.f;
        }
        dSs[row * LDX + c + 16 * u] = pr * (dp[i][u] - dlt[i]);
      }
    }
    __syncwarp();  // a half-warp reads back the dS rows its own half-warp wrote

    // dQ += dS K over the part's steps, two a ring step: dS rows along the
    // keys as float4, the step's K slab one key at a time at columns 4 c.
    // Part 1 may hold one step fewer than part 0.
#pragma unroll
    for (int i = 0; i < (NC + 2) / 2; ++i) {
      if (i < n_out) {
        step_in(ld);
        const float* kb = ring + (ld % C::kRing) * slot + part * share;
#pragma unroll
        for (int x = 0; x < 2; ++x)
          if (2 * i + x < NC) {
#pragma unroll 2
            for (int jj = 0; jj < BK; jj += 4)
              pv4_step<RPT, G, LDX, LDS>(acc[2 * i + x], dSs + jj, kb + (x * BK + jj) * LDS, g, c);
          }
        __syncthreads();  // every reader of this slot (and, at the last, of dS) is done
        ++ld;
      }
    }
  }
  cp_async_wait<0>();  // no copy left in flight when the block exits
  if (p.cluster > 1) cluster_sync();  // no block exits while another may read its sums

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + g + G * i;
    if (qi < S) {
#pragma unroll
      for (int h = 0; h < NC; ++h) {
        const int col = 64 * (b0 + c0 + h) + 4 * c;
        const float* a = acc[h][i];
        if (col < dh)
          *reinterpret_cast<float4*>(dq + base + (size_t)qi * dh + col) =
              make_float4(a[0] * scale, a[1] * scale, a[2] * scale, a[3] * scale);
      }
    }
  }
}

// W: the steps of dQ the widest part of a launch holds; a part holds W or
// W - 1.
template <int W>
__global__ void __launch_bounds__(DqXlCfg::kThreads, 1)
    flash_bwd_dq_xl_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dq, int BH, int S, int dh, int causal,
                               float scale) {
  typedef DqXlCfg C;
  const DqXlPlan p(dh);
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* ring = Qs + p.q_floats();
  float* Xs = ring + C::kRing * 2 * p.share_floats();

  // Block order: chunks of one Q tile together, the last (longest, when
  // causal) Q tile of every head first.
  const int n_tiles = (S + C::BQ - 1) / C::BQ;
  const int chunk = blockIdx.x % p.chunks, rest = blockIdx.x / p.chunks;
  const int bh = rest % BH;
  const int q0 = (n_tiles - 1 - rest / BH) * C::BQ;
  const int b0 = chunk * p.nb / p.chunks, nbc = (chunk + 1) * p.nb / p.chunks - b0;
  const int n0 = (nbc + 1) / 2;  // part 0's steps of the chunk; part 1 the rest
  const int part = threadIdx.x / C::kPartThreads;
  const int steps = part == 0 ? n0 : nbc - n0, c0 = part == 0 ? 0 : n0;
  const int rank = chunk % p.cluster;  // the block's rank in its cluster
  if (steps == W)
    dq_xl_part<W>(p, q, k, v, dout, lse, delta, dq, Qs, ring, Xs, bh, S, dh, q0, causal, scale,
                  part, rank, b0, nbc, c0);
  else
    dq_xl_part<W - 1>(p, q, k, v, dout, lse, delta, dq, Qs, ring, Xs, bh, S, dh, q0, causal,
                      scale, part, rank, b0, nbc, c0);
}

template <int W>
cudaError_t launch_dq_xl_w(const DqXlPlan& p, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dq, int bh,
                           int s, int dh, int causal, float scale, cudaStream_t stream) {
  const size_t bytes = p.bytes();
  cudaError_t e = allow_smem(flash_bwd_dq_xl_f32_kernel<W>, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + DqXlCfg::BQ - 1) / DqXlCfg::BQ) * bh * p.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  e = launch_clustered(flash_bwd_dq_xl_f32_kernel<W>, (unsigned)blocks, DqXlCfg::kThreads, bytes,
                       p.cluster, stream, q, k, v, dout, lse, delta, dq, bh, s, dh, causal, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch_dq_xl(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, int bh, int s, int dh,
                         int causal, float scale, cudaStream_t stream) {
  const DqXlPlan p(dh);
  return by_width<DqXlPlan::kMinWidth, DqXlPlan::kMaxWidth>(p.width, [&](auto w) {
    return launch_dq_xl_w<decltype(w)::value>(p, q, k, v, dout, lse, delta, dq, bh, s, dh, causal,
                                              scale, stream);
  });
}

}  // namespace f32

namespace sm90 {

constexpr int kDqBQ = 128, kDqKeys = 64;

// The bf16 dQ's tiles at head dim DH: BK keys a K/V tile, a ring of
// kStagesK K tiles and one of kStagesV V tiles beside the [kDqBQ, DH] Q and
// dO tiles. Up to Dh 192, 64-key tiles in 2 stages each (130 KB of shared
// memory at Dh 128, 194 KB at 192). At Dh 256 that layout takes 256 KB,
// past the 227 KB a block can use, so V keeps one stage there (224 KB): V
// is read only by dP = dO V^T, so each warpgroup releases it (empty_v) as
// soon as dP is done, and the next tile's V loads while dS and dQ += dS K
// are made and the next S = Q K^T is multiplied.
template <int DH>
struct DqCfg {
  static constexpr int BK = kDqKeys;
  static constexpr int kStagesK = 2;
  static constexpr int kStagesV = DH == 256 ? 1 : 2;
  // V has barriers of its own when its ring is not K's.
  static constexpr bool kSplitV = kStagesV != kStagesK;
  static constexpr uint32_t kQ = kDqBQ * DH * 2;  // the Q or the dO tile: 32 KB at Dh 128
  static constexpr uint32_t kKV = BK * DH * 2;    // a K or V tile: 16 KB at Dh 128
  static constexpr int kBars = 1 + 2 * kStagesK + 2 * kStagesV;
  // Q, dO, the K and V rings, barriers, alignment.
  static constexpr uint32_t kSmem = 2 * kQ + (kStagesK + kStagesV) * kKV + kBars * 8 + 1024;
};

// K/V tiles that the Q tile at q0 reads: up to its diagonal when causal.
template <int DH>
__device__ __forceinline__ int dq_kv_tiles(int q0, int S, int causal) {
  constexpr int kDqBK = DqCfg<DH>::BK;
  return ((causal ? min(q0 + kDqBQ, S) : S) + kDqBK - 1) / kDqBK;
}

// One consumer warpgroup's share of one K/V tile, over the tile's first NK
// keys. S = Q K^T (K's stage already waited for) and, after waiting on
// full_v, dP = dO V^T are wgmma from shared memory in two commit groups, so
// P = exp2(S scale log2(e) - lse log2(e)) is made while dP is multiplied;
// then (V released on empty_v, unless it is null: V shares K's ring) dS =
// P (dP - delta) in place and dQ += dS K with dS as the register A
// operand. Qw and dOw point at the warpgroup's 64 rows of the Q and dO
// tiles; lse2 (times log2(e)) and dlt are the terms of the thread's rows
// qi0 and qi0 + 8. dq holds Dh / 2 floats a thread.
template <int DH, int NK>
__device__ __forceinline__ void dq_tile(OutAcc<DH>& dq, const unsigned char* Qw,
                                        const unsigned char* dOw, const unsigned char* Kt,
                                        const unsigned char* Vt, uint64_t* full_v, uint32_t ph,
                                        uint64_t* empty_v, const float (&lse2)[2],
                                        const float (&dlt)[2], int k0, int qi0, int S, int causal,
                                        bool edge, float scale_log2) {
  constexpr int BK = DqCfg<DH>::BK;  // rows of the K and V tiles
  const int lane = threadIdx.x % 32;
  float sc[NK / 2], dp[NK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t a = (kk / 4) * (kDqBQ * 128) + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * (BK * 128) + (kk % 4) * 32;
    wgmma_ss(sc, desc(Qw + a, 16, 1024), desc(Kt + b, 16, 1024), kk);
  }
  wgmma_commit();
  mbar_wait(full_v, ph);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t a = (kk / 4) * (kDqBQ * 128) + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * (BK * 128) + (kk % 4) * 32;
    wgmma_ss(dp, desc(dOw + a, 16, 1024), desc(Vt + b, 16, 1024), kk);
  }
  wgmma_commit();
  wgmma_wait<1>();
  reg_fence(sc);

  // P, 0 where masked, which only the tiles crossing the diagonal or the
  // end of S need.
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) {
    const int h = (i % 4) / 2;  // row qi0 + 8 h
    float p = exp2f(sc[i] * scale_log2 - lse2[h]);
    if (edge) {
      const int kj = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      if (kj >= S || (causal && kj > qi0 + 8 * h)) p = 0.f;
    }
    sc[i] = p;
  }
  wgmma_wait<0>();
  reg_fence(dp);
  if (empty_v != nullptr) mbar_arrive(empty_v);  // this warpgroup is done with V
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) dp[i] = sc[i] * (dp[i] - dlt[(i % 4) / 2]);
  uint32_t dsa[NK / 16][4];
  to_a_operand(dp, dsa);

  // dQ += dS K: B is [keys, d], d contiguous.
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) dq.mma(dsa[kk], Kt + kk * 16 * 128, BK * 128);
  wgmma_commit();
  wgmma_wait<0>();
  dq.fence();
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int BH, int S, int causal,
                             float scale, float scale_log2) {
  typedef DqCfg<DH> C;
  constexpr int kDqBK = C::BK, SK = C::kStagesK, SV = C::kStagesV;
  constexpr uint32_t kDqQ = C::kQ, kDqKV = C::kKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + kDqQ;
  unsigned char* Ks = smem + 2 * kDqQ;  // stage s at + s * kDqKV
  unsigned char* Vs = Ks + SK * kDqKV;  // stage s at + s * kDqKV
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + SV * kDqKV);
  uint64_t* bar_q = bars;           // Q and dO
  uint64_t* full_k = bars + 1;      // [SK]
  uint64_t* full_v = full_k + SK;   // [SV]
  uint64_t* empty = full_v + SV;    // [SK]: K read (and V, unless kSplitV)
  uint64_t* empty_v = empty + SK;   // [SV]: V read (kSplitV)

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + kDqBQ - 1) / kDqBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * kDqBQ;
  const int n_k = dq_kv_tiles<DH>(q0, S, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < SK; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    for (int s = 0; s < SV; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the rings full.
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_expect(bar_q, 2 * kDqQ);
      tma_load_tile<DH>(Qs, &map_q, bar_q, kDqBQ, q0, bh);
      tma_load_tile<DH>(dOs, &map_do, bar_q, kDqBQ, q0, bh);
      for (int j = 0; j < n_k; ++j) {
        const int sk = j % SK, sv = j % SV;
        mbar_wait(&empty[sk], ((j / SK) & 1) ^ 1);
        mbar_expect(&full_k[sk], kDqKV);
        tma_load_tile<DH>(Ks + sk * kDqKV, &map_k, &full_k[sk], kDqBK, j * kDqBK, bh);
        if (C::kSplitV) mbar_wait(&empty_v[sv], ((j / SV) & 1) ^ 1);
        mbar_expect(&full_v[sv], kDqKV);
        tma_load_tile<DH>(Vs + sv * kDqKV, &map_v, &full_v[sv], kDqBK, j * kDqBK, bh);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows row0 + [0, 64).
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row0 = q0 + 64 * wg;
    const int qi0 = row0 + 16 * (t / 32) + lane / 4;  // and qi0 + 8
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qi0 + 8 * h;
      lse2[h] = qi < S ? lse[(size_t)bh * S + qi] * kLog2e : 0.f;
      dlt[h] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
    }
    const unsigned char* Qw = Qs + 64 * wg * 128;
    const unsigned char* dOw = dOs + 64 * wg * 128;
    OutAcc<DH> acc;
    acc.zero();
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_k; ++j) {
      const int sk = j % SK, sv = j % SV, k0 = j * kDqBK;
      const unsigned char* Kt = Ks + sk * kDqKV;
      const unsigned char* Vt = Vs + sv * kDqKV;
      uint64_t* release_v = C::kSplitV ? &empty_v[sv] : nullptr;
      const bool edge = k0 + kDqBK > S || (causal && k0 + kDqBK - 1 > row0);
      mbar_wait(&full_k[sk], (j / SK) & 1);
      dq_tile<DH, kDqBK>(acc, Qw, dOw, Kt, Vt, &full_v[sv], (j / SV) & 1, release_v, lse2, dlt,
                         k0, qi0, S, causal, edge, scale_log2);
      mbar_arrive(&empty[sk]);
    }
    // This warpgroup's Q rows are read by no one now: stage dQ there.
    acc.store(scale, scale, Qs, kDqBQ, 64 * wg, dq + (size_t)bh * S * DH, row0, S, 1 + wg);
  }
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s, int causal,
                      float scale, cudaStream_t stream) {
  typedef DqCfg<DH> C;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, DH, kDqBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mdo, dout, bh, s, DH, kDqBQ)) != cudaSuccess) return e;
  if ((e = allow_smem(flash_bwd_dq_kernel_sm90<DH>, C::kSmem)) != cudaSuccess) return e;
  const long long blocks = (long long)((s + kDqBQ - 1) / kDqBQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel_sm90<DH><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), bh, s, causal, scale, scale * kLog2e);
  return cudaGetLastError();
}

constexpr int kDqWideBQ = 64;  // query rows a block past Dh 256: both consumer warpgroups hold them all
constexpr int kBarX = 3;       // named barrier: both warpgroups' partial S and dP written

// The bf16 dQ past Dh 256 (320, 384, 448, 512). A [128, DH] Q tile and its
// dO tile take 256 KB at 512, and dQ over all of Dh would be 256 floats a
// thread: no 227 KB block holds the design of Dh 256. So a block holds 64
// query rows, which both consumer warpgroups share, and BK-key K/V tiles
// in rings of kStagesK and kStagesV. Warpgroup 0 owns dQ's first kCols0
// columns (whole 64-column boxes, the larger half at 320 and 448),
// warpgroup 1 the rest: at most 256 columns, 128 floats a thread, one or
// two wgmma accumulators (OutAcc). Each warpgroup makes S = Q K^T and dP =
// dO V^T over half of Dh's k16 steps (kSteps), and the two add each
// other's partials through shared memory (kX a product a warpgroup,
// double-buffered by tile parity, one named barrier a tile); both then
// hold the same S, dP, P and dS (a + b == b + a). Q and dO take 128 KB at
// 512, so past 320 the K/V tiles take 16 keys (16 KB each at 512; the
// partials 32 KB) and V one stage.
template <int DH>
struct DqWideCfg {
  static constexpr int BK = DH == 320 ? 32 : 16;  // keys a K/V tile
  static constexpr int kStagesK = 2;              // K ring depth
  static constexpr int kStagesV = DH == 320 ? 2 : 1;  // V ring depth
  // V has barriers of its own when its ring is not K's.
  static constexpr bool kSplitV = kStagesV != kStagesK;
  static constexpr int kCols0 = 64 * ((DH / 64 + 1) / 2), kCols1 = DH - kCols0;
  static constexpr int kSteps = DH / 32;               // k16 steps of S and dP a warpgroup makes
  static constexpr uint32_t kQ = kDqWideBQ * DH * 2;   // the Q or the dO tile: 64 KB at Dh 512
  static constexpr uint32_t kKV = BK * DH * 2;         // a K or V tile: 16 KB at Dh 512
  static constexpr uint32_t kX = 128 * (BK / 2) * 4;   // one warpgroup's partial S or dP
  static constexpr int kBars = 1 + 2 * kStagesK + 2 * kStagesV;
  // Q, dO, the K and V rings, the partials [parity][warpgroup][S, dP],
  // barriers, alignment.
  static constexpr uint32_t kSmem =
      2 * kQ + (kStagesK + kStagesV) * kKV + 8 * kX + kBars * 8 + 1024;
};

// K/V tiles that the 64-row Q tile at q0 reads: up to its diagonal when causal.
template <int DH>
__device__ __forceinline__ int dq_wide_tiles(int q0, int S, int causal) {
  constexpr int BK = DqWideCfg<DH>::BK;
  return ((causal ? min(q0 + kDqWideBQ, S) : S) + BK - 1) / BK;
}

// Consumer warpgroup wg (0 or 1) of the wide dQ: dQ's columns [C0, C0 + C)
// of query rows q0 + [0, 64).
template <int DH, int C, int C0>
__device__ __forceinline__ void dq_wide_consumer(
    unsigned char* Qs, const unsigned char* dOs, const unsigned char* Ks, const unsigned char* Vs,
    float* X, uint64_t* bars, const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int bh, int S, int q0, int causal, float scale,
    float scale_log2) {
  typedef DqWideCfg<DH> Cfg;
  constexpr int BK = Cfg::BK, SK = Cfg::kStagesK, SV = Cfg::kStagesV, wg = C0 == 0 ? 0 : 1;
  uint64_t* bar_q = bars;
  uint64_t* full_k = bars + 1;    // [SK]
  uint64_t* full_v = full_k + SK;  // [SV]
  uint64_t* empty = full_v + SV;   // [SK]: K read (and V, unless kSplitV)
  uint64_t* empty_v = empty + SK;  // [SV]: V read (kSplitV)
  const int n_k = dq_wide_tiles<DH>(q0, S, causal);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int qi0 = q0 + 16 * (t / 32) + lane / 4;  // and qi0 + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qi0 + 8 * h;
    lse2[h] = qi < S ? lse[(size_t)bh * S + qi] * kLog2e : 0.f;
    dlt[h] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
  }
  const int kk0 = wg * Cfg::kSteps;  // this warpgroup's first k16 step of S and dP
  OutAcc<C> acc;
  acc.zero();
  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_k; ++j) {
    const int sk = j % SK, sv = j % SV, k0 = j * BK;
    const unsigned char* Kt = Ks + sk * Cfg::kKV;
    const unsigned char* Vt = Vs + sv * Cfg::kKV;
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(&full_k[sk], (j / SK) & 1);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < Cfg::kSteps; ++i) {
      const int kk = kk0 + i;
      const uint32_t a = (kk / 4) * (kDqWideBQ * 128) + (kk % 4) * 32;
      const uint32_t b = (kk / 4) * (BK * 128) + (kk % 4) * 32;
      wgmma_ss(sc, desc(Qs + a, 16, 1024), desc(Kt + b, 16, 1024), i);
    }
    wgmma_commit();
    mbar_wait(&full_v[sv], (j / SV) & 1);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < Cfg::kSteps; ++i) {
      const int kk = kk0 + i;
      const uint32_t a = (kk / 4) * (kDqWideBQ * 128) + (kk % 4) * 32;
      const uint32_t b = (kk / 4) * (BK * 128) + (kk % 4) * 32;
      wgmma_ss(dp, desc(dOs + a, 16, 1024), desc(Vt + b, 16, 1024), i);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    if (Cfg::kSplitV) mbar_arrive(&empty_v[sv]);  // this warpgroup is done with V

    // Thread t's partial S at float4 v * 128 + t of this warpgroup's
    // buffer and its partial dP BK / 8 float4 further; the twin thread of
    // the other warpgroup holds the same rows and keys and adds them. The
    // last tile's barrier also follows both warpgroups' last reads of Q,
    // through which the epilogue stages dQ.
    float4* mine = reinterpret_cast<float4*>(X) + ((j & 1) * 2 + wg) * (BK / 4) * 128;
    const float4* theirs =
        reinterpret_cast<const float4*>(X) + ((j & 1) * 2 + 1 - wg) * (BK / 4) * 128;
#pragma unroll
    for (int v = 0; v < BK / 8; ++v) {
      mine[v * 128 + t] = make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
      mine[(BK / 8 + v) * 128 + t] =
          make_float4(dp[4 * v], dp[4 * v + 1], dp[4 * v + 2], dp[4 * v + 3]);
    }
    consumers_wait(kBarX);
#pragma unroll
    for (int v = 0; v < BK / 8; ++v) {
      const float4 x = theirs[v * 128 + t];
      sc[4 * v] += x.x, sc[4 * v + 1] += x.y, sc[4 * v + 2] += x.z, sc[4 * v + 3] += x.w;
      const float4 y = theirs[(BK / 8 + v) * 128 + t];
      dp[4 * v] += y.x, dp[4 * v + 1] += y.y, dp[4 * v + 2] += y.z, dp[4 * v + 3] += y.w;
    }

    // P, 0 where masked (only the tiles crossing the diagonal or the end
    // of S), and dS = P (dP - delta) in place.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i % 4) / 2;  // row qi0 + 8 h
      const int kj = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      const bool masked = edge && (kj >= S || (causal && kj > qi0 + 8 * h));
      dp[i] = masked ? 0.f : exp2f(sc[i] * scale_log2 - lse2[h]) * (dp[i] - dlt[h]);
    }
    uint32_t dsa[BK / 16][4];
    to_a_operand(dp, dsa);

    // dQ[:, C0 + [0, C)) += dS K: K's boxes from C0 / 64 on, MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      acc.mma(dsa[kk], Kt + (C0 / 64) * (BK * 128) + kk * 16 * 128, BK * 128);
    wgmma_commit();
    wgmma_wait<0>();
    acc.fence();
    mbar_arrive(&empty[sk]);
  }
  // Neither warpgroup reads Q now: each stages its columns of dQ there.
  acc.stage(scale, scale, Qs, kDqWideBQ, 0, C0);
  copy_rows<DH, C>(Qs, kDqWideBQ, 0, dq + (size_t)bh * S * DH, q0, S, 1 + wg, C0);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wide_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap map_k,
                                  const __grid_constant__ CUtensorMap map_v,
                                  const __grid_constant__ CUtensorMap map_do,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  __nv_bfloat16* __restrict__ dq, int BH, int S, int causal,
                                  float scale, float scale_log2) {
  typedef DqWideCfg<DH> C;
  constexpr int SK = C::kStagesK, SV = C::kStagesV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + C::kQ;
  unsigned char* Ks = smem + 2 * C::kQ;  // stage s at + s * C::kKV
  unsigned char* Vs = Ks + SK * C::kKV;  // stage s at + s * C::kKV
  float* X = reinterpret_cast<float*>(Vs + SV * C::kKV);
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + SV * C::kKV + 8 * C::kX);
  uint64_t* bar_q = bars;           // Q and dO
  uint64_t* full_k = bars + 1;      // [SK]
  uint64_t* full_v = full_k + SK;   // [SV]
  uint64_t* empty = full_v + SV;    // [SK]
  uint64_t* empty_v = empty + SK;   // [SV]

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + kDqWideBQ - 1) / kDqWideBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * kDqWideBQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < SK; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    for (int s = 0; s < SV; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the rings full.
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      const int n_k = dq_wide_tiles<DH>(q0, S, causal);
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_expect(bar_q, 2 * C::kQ);
      tma_load_tile<DH>(Qs, &map_q, bar_q, kDqWideBQ, q0, bh);
      tma_load_tile<DH>(dOs, &map_do, bar_q, kDqWideBQ, q0, bh);
      for (int j = 0; j < n_k; ++j) {
        const int sk = j % SK, sv = j % SV;
        mbar_wait(&empty[sk], ((j / SK) & 1) ^ 1);
        mbar_expect(&full_k[sk], C::kKV);
        tma_load_tile<DH>(Ks + sk * C::kKV, &map_k, &full_k[sk], C::BK, j * C::BK, bh);
        if (C::kSplitV) mbar_wait(&empty_v[sv], ((j / SV) & 1) ^ 1);
        mbar_expect(&full_v[sv], C::kKV);
        tma_load_tile<DH>(Vs + sv * C::kKV, &map_v, &full_v[sv], C::BK, j * C::BK, bh);
      }
    }
  } else if (wg == 0) {
    regs_alloc<240>();
    dq_wide_consumer<DH, C::kCols0, 0>(Qs, dOs, Ks, Vs, X, bars, lse, delta, dq, bh, S, q0,
                                       causal, scale, scale_log2);
  } else {
    regs_alloc<240>();
    dq_wide_consumer<DH, C::kCols1, C::kCols0>(Qs, dOs, Ks, Vs, X, bars, lse, delta, dq, bh, S,
                                                q0, causal, scale, scale_log2);
  }
}

template <int DH>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int bh, int s,
                           int causal, float scale, cudaStream_t stream) {
  typedef DqWideCfg<DH> C;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, DH, kDqWideBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mdo, dout, bh, s, DH, kDqWideBQ)) != cudaSuccess) return e;
  if ((e = allow_smem(flash_bwd_dq_wide_kernel_sm90<DH>, C::kSmem)) != cudaSuccess) return e;
  const long long blocks = (long long)((s + kDqWideBQ - 1) / kDqWideBQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_wide_kernel_sm90<DH><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), bh, s, causal, scale, scale * kLog2e);
  return cudaGetLastError();
}

constexpr int kBarXlO = 4;  // named barrier: both warpgroups done with the K ring (dQ stages there)

// The bf16 dQ at any other head dim past 256 (every multiple of 8 past 512
// on the public route; flash_bwd_dq_xl_kernel_sm90). A block holds 64
// query rows, which both consumer warpgroups share, and one column chunk
// of dQ: at most 2 kMaxBoxes 64-column boxes, the first half (rounded up)
// to warpgroup 0 and the rest to warpgroup 1 (WideAcc of at most 64
// kMaxBoxes columns). Warpgroup 0 makes S = Q K^T and warpgroup 1 dP = dO
// V^T (m64nBKk16), each walking Dh's 64-column slabs through a TMA ring of
// kSlots slots of its own (a slab of Q or dO and the same of K or V): Q
// and dO come again from L2 for every K/V tile. The two hand each other P
// and dP through shared memory (double-buffered by tile parity, one named
// barrier a tile) and both make dS = P (dP - delta) from the same floats,
// as the register A operand of dQ += dS K over their own boxes of the
// chunk's K columns (kKStages tiles in flight). Every chunk's block makes
// S and dP over all of Dh, in one order, so every chunk holds the same P
// and dS to the bit; with kCluster (a lever, off: slower) the blocks of one
// Q tile's chunks, a power of two of them, form a thread-block cluster
// that splits the slabs between them and adds the blocks' partial S (and
// dP) in rank order (xl_cluster_sum).
struct DqXlCfg {
  static constexpr int BK = 32;            // keys a K/V tile
  static constexpr int kMaxBoxes = 5;      // boxes of dQ a warpgroup holds
  static constexpr int kSlots = 4;         // slabs in flight a warpgroup
  static constexpr int kKStages = 2;       // the chunk's K tiles in flight
  static constexpr bool kCluster = false;  // the chunks' blocks split the scores over Dh
  static constexpr uint32_t kRowBox = kDqWideBQ * 128;  // [64 rows, 64 columns]: Q, dO, staged dQ
  static constexpr uint32_t kKeyBox = BK * 128;         // [BK keys, 64 columns]: K, V
  static constexpr uint32_t kSlot = kRowBox + kKeyBox;  // a slab of Q (dO) and the same of K (V)
  static constexpr uint32_t kX = 4 * 128 * (BK / 2);    // a warpgroup's P, dP or partial
};

// What a head dim gives the bf16 dQ past 256: nb boxes of Dh (the last one
// zero-filled past it), the chunks of dQ (as few as fit; a power of two
// with kCluster), the boxes of
// the widest warpgroup, the blocks of a cluster (1 when each chunk makes
// the scores), and where the shared memory goes: the K ring (also where dQ
// stages at the end), the two slab rings, P and dP by tile parity, a
// cluster's partials, the barriers.
struct DqXlPlan {
  int nb, chunks, width, cluster;
  __host__ __device__ explicit DqXlPlan(int dh)
      : nb((dh + 63) / 64),
        chunks(xl_chunks_of(nb, 2 * DqXlCfg::kMaxBoxes, DqXlCfg::kCluster)),
        width(xl_width(nb, 2 * DqXlCfg::kMaxBoxes, 2, DqXlCfg::kCluster)),
        cluster(DqXlCfg::kCluster ? xl_cluster(chunks) : 1) {}
  static constexpr int kMinWidth = xl_width_bound(2 * DqXlCfg::kMaxBoxes, 2, false, DqXlCfg::kCluster);
  static constexpr int kMaxWidth = xl_width_bound(2 * DqXlCfg::kMaxBoxes, 2, true, DqXlCfg::kCluster);
  static constexpr int kBars = 4 * DqXlCfg::kSlots + 2 * DqXlCfg::kKStages + 8;
  __host__ __device__ uint32_t k_stage() const { return 2 * width * DqXlCfg::kKeyBox; }
  __host__ __device__ uint32_t k_bytes() const {
    const uint32_t ring = DqXlCfg::kKStages * k_stage(), staged = 2 * width * DqXlCfg::kRowBox;
    return ring > staged ? ring : staged;
  }
  __host__ __device__ uint32_t x_bytes() const { return (cluster > 1 ? 8 : 4) * DqXlCfg::kX; }
  __host__ __device__ uint32_t bytes() const {
    return k_bytes() + 2 * DqXlCfg::kSlots * DqXlCfg::kSlot + x_bytes() + kBars * 8 + 1024;
  }
};

// K/V tiles that the 64-row Q tile at q0 reads past 512: up to its diagonal when causal.
__device__ __forceinline__ int dq_xl_tiles(int q0, int S, int causal) {
  const int end = causal ? min(q0 + kDqWideBQ, S) : S;  // one past the last key read
  return (end + DqXlCfg::BK - 1) / DqXlCfg::BK;
}

// Consumer warpgroup wg: S (wg 0) or dP (wg 1) over slabs [s0, s1), and
// dQ's NB boxes from box c0 of the chunk, whose first column is 64 b0, of
// query rows q0 + [0, 64). X: P and dP [parity][wg], then a cluster's
// partials [wg][parity].
template <int NB>
__device__ __forceinline__ void dq_xl_consumer(
    const DqXlPlan& p, unsigned char* Ks, const unsigned char* ring, float4* X, uint64_t* bars,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int bh, int S, int dh, int q0, int causal, float scale, float scale_log2, int wg, int s0,
    int s1, int b0, int c0) {
  typedef DqXlCfg C;
  constexpr int BK = C::BK, N = BK / 2, kSlots = C::kSlots, SK = C::kKStages;
  uint64_t* full = bars + wg * kSlots;
  uint64_t* empty = bars + (2 + wg) * kSlots;
  uint64_t* full_k = bars + 4 * kSlots;
  uint64_t* empty_k = full_k + SK;
  uint64_t* yfull = empty_k + SK + 2 * wg;  // [parity]
  uint64_t* yempty = yfull + 4;             // [parity]
  const unsigned char* my_ring = ring + wg * kSlots * C::kSlot;
  const int n_k = dq_xl_tiles(q0, S, causal);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int qi0 = q0 + 16 * (t / 32) + lane / 4;  // and qi0 + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qi0 + 8 * h;
    lse2[h] = qi < S ? lse[(size_t)bh * S + qi] * kLog2e : 0.f;
    dlt[h] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
  }
  WideAcc<64 * NB> acc;
  acc.zero();
  uint32_t n = 0;  // slabs taken from this warpgroup's ring
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK;
    float sc[N];
    xl_score<kSlots, C::kSlot, C::kRowBox>(sc, my_ring, full, empty, n, s0, s1);
    if (p.cluster > 1) xl_cluster_sum(sc, X + (4 + 2 * wg) * (N / 4) * 128, yfull, yempty, j, p.cluster);
    if (wg == 0) {
      // P, 0 where masked (only the tiles crossing the diagonal or the end
      // of S).
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int h = (i % 4) / 2;  // row qi0 + 8 h
        const int kj = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const bool off = edge && (kj >= S || (causal && kj > qi0 + 8 * h));
        sc[i] = off ? 0.f : exp2f(sc[i] * scale_log2 - lse2[h]);
      }
    }
    // Thread t's P (wg 0) or dP (wg 1) at float4 v * 128 + t of its
    // buffer; the twin thread of the other warpgroup holds the same rows
    // and keys. The last tile's barrier also follows both warpgroups' last
    // reads of P and dP.
    float4* mine = X + ((j & 1) * 2 + wg) * (N / 4) * 128;
    const float4* other = X + ((j & 1) * 2 + 1 - wg) * (N / 4) * 128;
#pragma unroll
    for (int v = 0; v < N / 4; ++v)
      mine[v * 128 + t] = make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
    consumers_wait(kBarX);
    // dS = P (dP - delta), the same floats in both warpgroups.
#pragma unroll
    for (int v = 0; v < N / 4; ++v) {
      const float4 y = other[v * 128 + t];
      const float o[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * v + e;
        const float d = dlt[(i % 4) / 2];
        sc[i] = wg == 0 ? sc[i] * (o[e] - d) : o[e] * (sc[i] - d);
      }
    }
    uint32_t dsa[N / 8][4];
    to_a_operand(sc, dsa);

    // dQ[:, this warpgroup's boxes] += dS K: the chunk's K boxes from c0, MN-major.
    const int sk = j % SK;
    mbar_wait(&full_k[sk], (j / SK) & 1);
    const unsigned char* Kt = Ks + sk * p.k_stage() + c0 * C::kKeyBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc.mma(dsa[kk], Kt + kk * 16 * 128, C::kKeyBox);
    wgmma_commit();
    wgmma_wait<0>();
    acc.fence();
    mbar_arrive(&empty_k[sk]);
  }
  // Both warpgroups are done with the K ring: each stages its boxes of dQ
  // there (box i of the chunk at i * kRowBox) and copies the columns short
  // of dh out.
  consumers_wait(kBarXlO);
  acc.stage(scale, scale, Ks, kDqWideBQ, 0, 64 * c0);
  copy_boxes<NB>(Ks, c0, dq + (size_t)bh * S * dh, dh, q0, S, 64 * b0, 5 + wg);
}

// What a block of the bf16 dQ past 256 works on: its head, its 64 query
// rows, its chunk's boxes and the scores' slabs. Each role makes it after
// setmaxnreg, so that none of it stays live across the split (the
// producer's 24 registers would spill it for the consumers too).
struct DqXlBlock {
  int bh, q0, b0, nbc, s0, s1;
};

__device__ __forceinline__ DqXlBlock dq_xl_block(const DqXlPlan& p, int BH, int S) {
  // Block order: the chunks of one Q tile together (a cluster's blocks),
  // the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + kDqWideBQ - 1) / kDqWideBQ;
  const int chunk = blockIdx.x % p.chunks, rest = blockIdx.x / p.chunks;
  const int bh = rest % BH;
  const int q0 = (n_tiles - 1 - rest / BH) * kDqWideBQ;
  const int b0 = chunk * p.nb / p.chunks, nbc = (chunk + 1) * p.nb / p.chunks - b0;
  // The scores' slabs: all of Dh, or the block's share of its cluster's.
  const int rank = chunk % p.cluster;
  const int s0 = rank * p.nb / p.cluster, s1 = (rank + 1) * p.nb / p.cluster;
  return {bh, q0, b0, nbc, s0, s1};
}

// W: the boxes of dQ the widest warpgroup of a launch holds; a warpgroup
// holds W or W - 1.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_xl_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_do,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dq, int BH, int S, int dh, int causal,
                                float scale, float scale_log2) {
  typedef DqXlCfg C;
  constexpr int kSlots = C::kSlots, SK = C::kKStages;
  const DqXlPlan p(dh);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  // The chunk's K tiles (at the end dQ staged), then warpgroup r's slot s
  // of the slab rings at (r kSlots + s) kSlot, P and dP, a cluster's
  // partials, the barriers: full and empty [wg][kSlots], the K ring's, a
  // cluster's full [wg][parity] and empty.
  const uint32_t ring_at = p.k_bytes(), x_at = ring_at + 2 * kSlots * C::kSlot;
  const uint32_t bars_at = x_at + p.x_bytes();
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + bars_at);
    for (int s = 0; s < 2 * kSlots; ++s) {
      mbar_init(&bars[s], 1);                // full [wg][kSlots]
      mbar_init(&bars[2 * kSlots + s], 128);  // empty [wg][kSlots]
    }
    for (int s = 0; s < SK; ++s) {
      mbar_init(&bars[4 * kSlots + s], 1);                      // the K ring's full
      mbar_init(&bars[4 * kSlots + SK + s], kConsumerThreads);  // and empty
    }
    for (int x = 0; x < 8; ++x) mbar_init(&bars[4 * kSlots + 2 * SK + x], 128 * p.cluster);
    mbar_init_fence();
  }
  __syncthreads();
  if (p.cluster > 1) cluster_sync();  // no block arrives on another's barriers before they exist

  if (wg == 2) {
    // Producer: one thread keeps the rings full, the two slab rings in turn.
    regs_dealloc<24>();
    if (threadIdx.x == kConsumerThreads) {
      const DqXlBlock b = dq_xl_block(p, BH, S);
      unsigned char* Ks = smem;
      unsigned char* ring = smem + ring_at;
      uint64_t* full = reinterpret_cast<uint64_t*>(smem + bars_at);  // [wg][kSlots]
      uint64_t* empty = full + 2 * kSlots;                          // [wg][kSlots]
      uint64_t* full_k = empty + 2 * kSlots;                        // [SK]
      uint64_t* empty_k = full_k + SK;                              // [SK]
      const int n_k = dq_xl_tiles(b.q0, S, causal);
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      uint32_t n[2] = {0, 0};  // slabs put in each warpgroup's ring
      for (int j = 0; j < n_k; ++j) {
        for (int d = b.s0; d < b.s1; ++d) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t s = r * kSlots + n[r] % kSlots;
            mbar_wait(&empty[s], ((n[r] / kSlots) & 1) ^ 1);
            ++n[r];
            mbar_expect(&full[s], C::kSlot);
            tma_load(ring + s * C::kSlot, r ? &map_do : &map_q, &full[s], 64 * d, b.q0, b.bh);
            tma_load(ring + s * C::kSlot + C::kRowBox, r ? &map_v : &map_k, &full[s], 64 * d,
                     j * C::BK, b.bh);
          }
        }
        const int sk = j % SK;
        mbar_wait(&empty_k[sk], ((j / SK) & 1) ^ 1);
        mbar_expect(&full_k[sk], b.nbc * C::kKeyBox);
        for (int i = 0; i < b.nbc; ++i)
          tma_load(Ks + sk * p.k_stage() + i * C::kKeyBox, &map_k, &full_k[sk],
                   64 * (b.b0 + i), j * C::BK, b.bh);
      }
    }
  } else {
    regs_alloc<240>();
    const DqXlBlock b = dq_xl_block(p, BH, S);
    unsigned char* Ks = smem;
    const unsigned char* ring = smem + ring_at;
    float4* X = reinterpret_cast<float4*>(smem + x_at);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + bars_at);
    const int c_half = (b.nbc + 1) / 2;  // dQ's boxes of warpgroup 0
    const int c0 = wg ? c_half : 0, boxes = wg ? b.nbc - c_half : c_half;
    if (boxes == W)
      dq_xl_consumer<W>(p, Ks, ring, X, bars, lse, delta, dq, b.bh, S, dh, b.q0, causal, scale,
                        scale_log2, wg, b.s0, b.s1, b.b0, c0);
    else
      dq_xl_consumer<W - 1>(p, Ks, ring, X, bars, lse, delta, dq, b.bh, S, dh, b.q0, causal,
                            scale, scale_log2, wg, b.s0, b.s1, b.b0, c0);
  }
  if (p.cluster > 1) {
    __syncwarp();
    cluster_sync();  // no block exits while another may still read it or arrive on it
  }
}

template <int W>
cudaError_t launch_dq_xl_w(const DqXlPlan& p, const CUtensorMap& mq, const CUtensorMap& mk,
                           const CUtensorMap& mv, const CUtensorMap& mdo, const void* lse,
                           const void* delta, void* dq, int bh, int s, int dh, int causal,
                           float scale, cudaStream_t stream) {
  const uint32_t bytes = p.bytes();
  cudaError_t e = allow_smem(flash_bwd_dq_xl_kernel_sm90<W>, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + kDqWideBQ - 1) / kDqWideBQ) * bh * p.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  e = launch_clustered(flash_bwd_dq_xl_kernel_sm90<W>, (unsigned)blocks, kThreads, bytes,
                       p.cluster, stream, mq, mk, mv, mdo, static_cast<const float*>(lse),
                       static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), bh, s,
                       dh, causal, scale, scale * kLog2e);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch_dq_xl(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, int bh, int s, int dh,
                         int causal, float scale, cudaStream_t stream) {
  const DqXlPlan p(dh);
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, dh, kDqWideBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, dh, DqXlCfg::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, dh, DqXlCfg::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mdo, dout, bh, s, dh, kDqWideBQ)) != cudaSuccess) return e;
  return by_width<DqXlPlan::kMinWidth, DqXlPlan::kMaxWidth>(p.width, [&](auto w) {
    return launch_dq_xl_w<decltype(w)::value>(p, mq, mk, mv, mdo, lse, delta, dq, bh, s, dh,
                                              causal, scale, stream);
  });
}

}  // namespace sm90

}  // namespace flash

// q, k, v, dout, dq: [bh, s, dh] (float32, or bfloat16 when is_bf16); lse,
// delta: float32 [bh, s]. dh is 64, 128, 192, 256, 320, 384, 448 or 512 in
// both dtypes (the kernels built for them), or any other multiple of 8
// past 256 (the kernels that take the head dim at run time).
// Launches on `stream` and returns the launch's CUDA error code.
extern "C" int dmlc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int bh, int s,
                                 int dh, int causal, float scale, int is_bf16, void* stream) {
  using namespace flash;
  if (bh <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16 && dh == 128)
    return (int)sm90::launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (is_bf16 && dh == 64)
    return (int)sm90::launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (is_bf16 && dh == 192)
    return (int)sm90::launch_dq<192>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (is_bf16 && dh == 256)
    return (int)sm90::launch_dq<256>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (is_bf16 && dh == 320)
    return (int)sm90::launch_dq_wide<320>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (is_bf16 && dh == 384)
    return (int)sm90::launch_dq_wide<384>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (is_bf16 && dh == 448)
    return (int)sm90::launch_dq_wide<448>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (is_bf16 && dh == 512)
    return (int)sm90::launch_dq_wide<512>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 128)
    return (int)f32::launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 64)
    return (int)f32::launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 192)
    return (int)f32::launch_dq<192>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 256)
    return (int)f32::launch_dq<256>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 320)
    return (int)f32::launch_dq<320>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 384)
    return (int)f32::launch_dq<384>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 448)
    return (int)f32::launch_dq<448>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 512)
    return (int)f32::launch_dq<512>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh > 256 && dh % 8 == 0)
    return (int)f32::launch_dq_xl(q, k, v, dout, lse, delta, dq, bh, s, dh, causal, scale, st);
  if (is_bf16 && dh > 256 && dh % 8 == 0)
    return (int)sm90::launch_dq_xl(q, k, v, dout, lse, delta, dq, bh, s, dh, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the kernel for (dh, dtype) takes, in
// bytes; 0 for a pair that has no kernel.
extern "C" int dmlc_flash_bwd_dq_smem_bytes(int dh, int is_bf16) {
  using namespace flash;
  if (dh == 128) return (int)(is_bf16 ? sm90::DqCfg<128>::kSmem : f32::DqCfg<128>::bytes);
  if (dh == 64) return (int)(is_bf16 ? sm90::DqCfg<64>::kSmem : f32::DqCfg<64>::bytes);
  if (dh == 192 && is_bf16) return (int)sm90::DqCfg<192>::kSmem;
  if (dh == 256 && is_bf16) return (int)sm90::DqCfg<256>::kSmem;
  if (dh == 320 && is_bf16) return (int)sm90::DqWideCfg<320>::kSmem;
  if (dh == 384 && is_bf16) return (int)sm90::DqWideCfg<384>::kSmem;
  if (dh == 448 && is_bf16) return (int)sm90::DqWideCfg<448>::kSmem;
  if (dh == 512 && is_bf16) return (int)sm90::DqWideCfg<512>::kSmem;
  if (dh == 192 && !is_bf16) return (int)f32::DqCfg<192>::bytes;
  if (dh == 256 && !is_bf16) return (int)f32::DqCfg<256>::bytes;
  if (dh == 320 && !is_bf16) return (int)f32::DqCfg<320>::bytes;
  if (dh == 384 && !is_bf16) return (int)f32::DqCfg<384>::bytes;
  if (dh == 448 && !is_bf16) return (int)f32::DqCfg<448>::bytes;
  if (dh == 512 && !is_bf16) return (int)f32::DqCfg<512>::bytes;
  if (!is_bf16 && dh > 256 && dh % 8 == 0) return (int)f32::DqXlPlan(dh).bytes();
  if (is_bf16 && dh > 256 && dh % 8 == 0) return (int)sm90::DqXlPlan(dh).bytes();
  return 0;
}

// The instantiation (its template argument W: the widest warpgroup's
// 64-column boxes of dQ in bf16, the widest part's steps in float32) that
// the kernel past 256 runs head dim dh with; 0 where a kernel built for dh
// runs it, or none.
extern "C" int dmlc_flash_bwd_dq_xl_width(int dh, int is_bf16) {
  using namespace flash;
  if (dh <= 256 || dh % 8 != 0 || (dh <= 512 && dh % 64 == 0)) return 0;
  return is_bf16 ? sm90::DqXlPlan(dh).width : f32::DqXlPlan(dh).width;
}
