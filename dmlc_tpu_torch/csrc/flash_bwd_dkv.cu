// flash_bwd_dkv: the key and value gradients of flash attention
// (FlashAttention-2).
//
// Replaces the TPU kernel dmlc_tpu/ops/pallas_kernels.py:_flash_bwd_dkv_kernel
// (pallas_call at :574, via _flash_backward), the dK/dV half of
// flash_attention's custom VJP. There a sequential grid axis walks Q blocks
// and carries dK and dV in VMEM scratch; here a loop inside the block does.
//
// Inputs q, k, v, dO: [BH, S, DH] row-major, float32 or bfloat16, DH 64,
// 128, 192, 256, 320, 384, 448 or 512, and also, at run time, any other
// multiple of 8 past 256 (ops/flash.py zero-pads a head dim up to 512 to
// one of the fixed ones, and a wider one to a multiple of 8); lse and
// delta = rowsum(dO * O): float32 [BH, S]. Outputs dk (k's dtype) and dv
// (v's dtype): dv = sum_q P^T dO and dk = sum_q dS^T (scale q), with
// p = exp(scale q k^T - lse) (0 where masked, which also keeps a row with
// lse = -inf from giving exp(-inf - -inf) = nan, pallas_kernels.py:297)
// and dS = p * (dO v^T - delta).
//
// What bounds it on the H100: operations, four products of the (causally
// halved) [S, S] tile set, 4 * 2 * BH * S^2 * DH / 2 FLOPs: 103 GFLOP at
// the LM train shape (BH 48, S 2048, DH 128), 104 us at the 989 TFLOP/s
// bf16 dense peak (H100 SXM data sheet).
//
// bf16, the Hopper design (flash_sm90.cuh, FlashAttention-3's layout): one
// block per (BH, 128-key tile), 384 threads. Two consumer warpgroups own 64
// keys each; one producer warpgroup gives its registers to them
// (setmaxnreg). TMA loads the K and V tiles once (64 KB) and streams 64-row
// Q and dO tiles through a 2-stage ring with full and empty mbarriers; the
// producer warp brings each tile's lse and delta rows beside them. The
// products are wgmma and run transposed: S^T = K Q^T and dP^T = V dO^T
// from shared memory leave P^T and dS^T = P^T (dP^T - delta) in the
// accumulator layout that the next wgmma takes as its register A operand,
// so dV += P^T dO and dK += dS^T Q (B MN-major, the transpose bit set)
// never stage P or dS in shared memory (m64n128k16 at Dh 128, m64n64k16
// at 64). dK and dV ([64, Dh] float32 each) stay in registers for the
// whole Q loop; scale is applied once, in the epilogue. When causal a block starts at the first Q tile that
// reaches its keys (pallas_kernels.py:362) and only the diagonal tiles are
// masked.
//
// bf16 at Dh 192 and 256, the split layout (DkvCfg::kSplit): dK and dV of
// 64 keys over all Dh in one warpgroup would be Dh floats a thread, past
// the 255 registers a thread has at 256. So a block takes 64 keys and
// warpgroup 0 keeps dV, warpgroup 1 dK, each [64, Dh] float32 (Dh / 2 a
// thread, two wgmma accumulators: OutAcc in flash_sm90.cuh). Per Q tile
// warpgroup 0 makes S^T = K Q^T and P^T, hands P^T (float32, 16 KB) to
// warpgroup 1 through shared memory (two named barriers, full and empty),
// and adds P^T dO to dV; warpgroup 1 makes dP^T = V dO^T, then dS^T from
// the P^T it was handed, and adds dS^T Q to dK. Each product is made once
// (4 of the [64, 64, Dh] ones a tile, two a warpgroup, as at Dh 128), and
// the only wait between the warpgroups is for P^T. Shared memory at Dh
// 256: K, V 64 KB, the Q/dO ring 128 KB, P^T 16 KB. Its bound at [8, 3,
// 2048, 256]: operations, 104 us.
//
// bf16 past Dh 256 (320, 384, 448, 512; DkvWideCfg, dkv_wide_consumer,
// flash_bwd_dkv_wide_kernel_sm90): every bf16 head in (256, 512] pads to
// one of them. The split layout of Dh 256 keeps dK or dV of 64 keys over
// all of Dh, Dh / 2 floats a thread. At 320 that still fits a consumer
// thread's 240 registers (160 floats; WideAcc), and one block a key tile
// runs that layout with 32-row Q/dO tiles. Past it, dK and dV are cut into
// two column chunks of whole 64-column boxes (192 + 192, 256 + 192, 256 +
// 256), one a block, and the two blocks of a key tile form a thread-block
// cluster. Each block keeps the split layout over its chunk (warpgroup 0
// dV and P^T, warpgroup 1 dK and dS^T, P^T handed over through shared
// memory) and loads only its chunk's columns of K, V, Q and dO. S^T = K
// Q^T and dP^T = V dO^T
// are the sums of the two blocks' partial products over their columns:
// each warpgroup pushes its partial into the other block's shared memory
// (st.shared::cluster, double-buffered by Q tile parity), arrives on that
// block's barrier (release at cluster scope), waits on its own and adds
// the two in rank order, so both blocks hold the same P^T and dS^T and
// neither makes the scores again. Q/dO tiles take 32 rows (S^T on
// m64n32k16) in two stages: 170 KB at 512. Bound at [4, 4, 1024, 512]:
// operations, 35 us. On an H100 80GB HBM3 at 700 W (PERF.md, section 6;
// tools/flash_levers.py group wide_bwd_bf16) the cluster ran 2.3x slower
// than one block at 320 (each tile's exchange is a round trip between the
// two SMs; issuing the next tile's scores before it moved the time by
// 2-5% either way); 64-row Q/dO tiles in one stage ran the same and
// spilled at 512, 16-row ones 29-34% slower, three stages 0-3% slower.
//
// float32, the FMA design (flash::f32 below): register-tiled FMA on the
// CUDA cores in full float32 (no TF32), bound by the 67 TFLOP/s float32
// peak (1.54 ms at the train shape). One block of 128 threads per (BH,
// 32-key tile), two blocks an SM; K and V stay in shared memory. The
// threads form 8 key groups of 16 (a half-warp each): group g owns keys g +
// 8 i (i < 4), thread c of it queries c and c + 16 of a tile and dK, dV
// columns 64 h + 4 c. 32-row Q and dO tiles, with their lse and delta rows,
// stream by cp.async: at Dh 128 through a 2-stage ring, so the next tile
// loads while this one is multiplied; at Dh 64 each tile loads after the
// products of the one before. Per tile a thread computes S^T = K Q^T and
// dP^T = V dO^T for its 4 keys x 2 queries in registers (rows read along Dh
// as float4, K's and V's broadcast across the half-warp), makes P^T and
// dS^T = P^T (dP^T - delta) there and writes them to shared memory once, as
// the A operands of dV += P^T dO and dK += dS^T Q; a half-warp reads back
// only its own rows. dK and dV ([4 keys, Dh / 16 columns] a thread each)
// stay in registers for the whole Q loop, scale applied once in the
// epilogue. When causal a block starts at the first Q tile that reaches its
// keys; masks run only on the tiles that cross the diagonal or the end of
// S. Shared memory at Dh 128: K, V 33 KB, the ring 67 KB, P^T and dS^T 9
// KB. Against 64-key blocks (256 threads, one block an SM) the 32-key ones
// ran 5% faster; the ring ran 2% faster than one stage at Dh 128 and 4%
// slower at Dh 64; laying a warp's lanes out as 4 keys x 8 queries for S^T
// (fewer shared-memory wavefronts a load) ran 1% slower at Dh 128 (PERF.md,
// section 6; tools/flash_levers.py).
//
// float32 at Dh 192 and 256 (DkvCfg; heads in (128, 256] pad to them). At
// 256 the same kernel: dK and dV 128 floats a thread (232 registers), the
// 2-stage ring (205 KB), one block of 4 warps an SM. At 192 the FMA form
// of the bf16 split layout (flash_bwd_dkv_f32_parts_kernel): two parts of
// 128 threads share the block's K, V and Q/dO tiles; part 0 makes S^T = K
// Q^T and P^T, writes P^T to shared memory and keeps dV += P^T dO; part 1
// makes dP^T = V dO^T, then dS^T from part 0's P^T, and keeps dK += dS^T
// Q. Each part does two of the four products and holds 48 floats a
// thread, and the only wait is part 1's for P^T: thread (g, c) of part 1
// reads the entries its twin in part 0 wrote, so a warp waits for its
// twin only (a named barrier of 64 threads). One Q/dO stage (107 KB, 128
// registers) lets two blocks, 16 warps, run an SM; two stages (one block)
// ran 20% slower, one part in one stage 3.5% slower. At 256 two parts (8
// warps, 152 registers) ran 2% slower than one, and one stage 3% slower
// than two. Bound at [8, 3, 2048, 256]: operations, 1.54 ms at the float32
// peak (PERF.md, section 6; tools/flash_levers.py group wide_bwd_f32).
//
// float32 past Dh 256 (320, 384, 448, 512; DkvCfg<DH, true>): every
// float32 head in (256, 512] pads to one of them. Blocks of 32 keys and
// two parts of 128 threads; K and V stay in shared memory, and Q/dO tiles
// with their lse and delta rows stream in one stage. Up to 384, 32-row
// Q/dO tiles and the column split (flash_bwd_dkv_f32_split_kernel,
// dkv_split_part): part 0 keeps dK and dV over the first whole 64-column
// steps (192 of 320), part 1 over the rest, 2 x 48 floats a thread at
// most; each makes S^T = K Q^T and dP^T = V dO^T over its half of Dh,
// adds the other's partials behind the named barrier of its twin warp,
// and writes the same P^T and dS^T over them as the A operands of dV +=
// P^T dO and dK += dS^T Q over its columns (185-217 KB, 253-255
// registers). Past 384 a 32-row Q/dO tile does not fit beside 32 keys' K
// and V: 16-row tiles, and the roles of Dh 192
// (flash_bwd_dkv_f32_parts_kernel: part 0 P^T and dV, part 1 dP^T, dS^T
// and dK, each over all of Dh, 128 floats a thread; 179-203 KB, 198-255
// registers). No spill. Bound at [4, 4, 1024, 512]: operations, 0.513 ms
// at the float32 peak. Levers that lost (PERF.md, section 6;
// tools/flash_levers.py group xl_bwd_f32): the roles at 320 (9.5% slower)
// and 384 (1.5%); the column split past 384 (2-7%); 16-key blocks with
// 32-row tiles past 384 (20%); 16-key blocks at every head dim (34-56%).
//
// float32 past Dh 512, at any multiple of 8 past 256 (DkvXlCfg, DkvXlPlan,
// dkv_xl_part, flash_bwd_dkv_xl_f32_kernel<W>): every float32 head past
// 512 pads to a multiple of 8, and a direct call takes any other past 256.
// The head dim is a run-time argument and shared memory does not grow
// with it: dK and dV are cut into column chunks of at most 5 64-column
// steps, one a block, in a power of two of chunks (640 in two, 768 and
// 1024 in four), and the roles of Dh 192 split each chunk's outputs, part
// 0 keeping dV and part 1 dK over all its steps (at most 80 floats a
// thread). The blocks of one key tile's chunks form a thread-block
// cluster, and S^T = K Q^T and dP^T = V dO^T are split over Dh's 64-column
// slabs between its blocks and, within a block, between the two parts;
// each part adds the other's partials behind its twin warp's named
// barrier, and each block the cluster's block sums through distributed
// shared memory in rank order (one cluster barrier a Q tile), so every
// part of every chunk's block holds the same P^T and dS^T to the bit and
// no chunk makes the scores again. A block's slabs of K and V stay
// resident (up to 5, every head dim up to 2560), and the Q and dO slabs
// stream through a 2-slot cp.async ring, both parts' in a slot: the
// scores', then the chunk's for dV += P^T dO and dK += dS^T Q, two steps
// a slot. 226-254 registers, no spill (the score loop is not unrolled:
// unrolled by two it spilled 20 bytes at 5 steps). Bound at [4, 4, 1024,
// 640]: operations, 0.641 ms at the float32 peak. On an H100 80GB HBM3 at
// 700 W (PERF.md, section 6; tools/flash_levers.py group xl_bwd512): the
// column split (each part dK and dV over half the chunk) ran 43% slower at
// 640 and 28% at 768, 3% faster at 1024 (it spills); K and V streamed
// 5-21% slower; chunks of 4 or 3 steps, which give 640 four chunks, 96-97%
// slower there; 16-key blocks with chunks of 10 (640 in one) 25-88%;
// 16-row tiles 30-35%; a 3-slot ring up to 8%. Clusters of three blocks ran about twice as slow
// as two or four, hence the power of two of chunks. Before the clusters,
// each chunk's block made the whole scores (1.5x the FLOPs at 640, 2x at
// 1024).
//
// bf16 past Dh 512, at any multiple of 8 past 256 (DkvXlCfg, DkvXlPlan,
// dkv_xl_consumer, flash_bwd_dkv_xl_kernel_sm90<W>): every bf16 head past
// 512 pads to a multiple of 8, and a direct call takes any other past 256.
// The head dim is a run-time argument. dK and dV of 64 keys are cut into
// column chunks of at most 5 boxes, as few as fit (640 in two, 768 and 712
// in three, 1024 in four), one a block, and the split layout of Dh 256
// runs over the chunk: warpgroup 0 makes S^T = K Q^T and P^T and keeps dV,
// warpgroup 1 makes dP^T = V dO^T, dS^T from the P^T handed to it, and
// keeps dK (WideAcc of at most 320 columns, 160 floats a thread). Each
// makes its score product (m64n32k16) over all of Dh's 64-column slabs,
// streamed through a TMA ring of 4 slots of its own (xl_score; a slab of
// K or V and the same of Q or dO a slot), in one order, so every chunk
// holds the same P^T and dS^T to the bit; dV += P^T dO and dK += dS^T Q
// take the chunk's columns of the 32-row Q/dO tile (two tiles in flight,
// with their lse and delta rows). Making the scores again costs (2 chunks
// + 2) / 4 of the FLOPs: 1.5x at 640, 2x at 768, 2.5x at 1024. 168
// registers at launch, 240 a consumer thread, no spill: the block's
// indices and its shared-memory layout are made by each role after
// setmaxnreg (dkv_xl_block, dkv_xl_smem), since values live across the
// split took the producer's 24-register limit and spilled for the
// consumers too. At most 190176 bytes of shared memory. Bound at [4, 4,
// 1024, 640]: operations, 43 us. On an H100 80GB HBM3 at 700 W (PERF.md,
// section 6; tools/flash_levers.py group xl_bwd_bf16; 0.370, 0.928 and
// 1.076 ms at [4, 4, 1024, 640], 1024 and [8, 1, 2048, 768]): the chunks'
// blocks as a thread-block cluster that splits the slabs and adds the
// blocks' partials in rank order (kCluster, a power of two of chunks) ran
// 40-48% slower at 640 and 1024 and 2.2x at 768 (four chunks there); as
// in the cluster past 320 above, the exchange every tile costs more than
// the FLOPs it saves.
// 16-row tiles ran 63-75% slower, slab rings of 2 53-73%, chunks of 4
// boxes (640 in three) 36% slower at 640, three Q/dO stages within 1%.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {

namespace f32 {

constexpr int kDkvKeys = 32;          // keys a block
constexpr int kDkvKeysPerThread = 4;  // keys a key group (16 threads) owns
constexpr int kDkvRows = 32;          // query rows a Q/dO tile
constexpr int kDkvThreads = 16 * kDkvKeys / kDkvKeysPerThread;

// The float32 dK/dV's tiles at head dim DH. One part of 128 threads keeps
// dK and dV of its keys (NC4 float4 columns each; 128 floats a thread at
// Dh 256, one block of 4 warps an SM). At Dh 192 two parts of 128 threads
// share the block's tiles (flash_bwd_dkv_f32_parts_kernel): part 0 makes
// P^T and keeps dV, part 1 makes dP^T and dS^T and keeps dK, each over all
// of Dh, 48 floats a thread, and with one Q/dO stage (107 KB) two blocks
// run an SM. Two parts ran 3.5% faster than one at 192 and 2% slower at
// 256 (PERF.md, section 6; tools/flash_levers.py group wide_bwd_f32).
template <int DH, bool kWide = (DH > 256)>
struct DkvCfg {
  static constexpr int kParts = DH == 192 ? 2 : 1;
  static constexpr bool kSplit = false;  // no column split below Dh 256
  static constexpr int BK = kDkvKeys, BQ = kDkvRows, KPT = kDkvKeysPerThread;
  static constexpr int kPartThreads = kDkvThreads, kThreads = kParts * kPartThreads;
  static constexpr int G = BK / KPT;   // G key groups a part
  static constexpr int LD = DH + 4;    // K, V, Q, dO rows (floats), padded by 16 bytes
  static constexpr int LDP = BQ + 4;   // P^T, dS^T rows
  static constexpr int NC4 = DH / 64;  // float4 columns a thread owns in dK, dV
  static constexpr int NQT = BQ / 16;  // queries a thread owns in S^T and dP^T
  static constexpr int kStage = 2 * BQ * LD + 2 * BQ;  // Q, dO, lse, delta (floats)
  // Q/dO ring depth: 2 at Dh 128 and 256; at Dh 64 loading each tile after
  // the products of the one before ran 4% faster, and at Dh 192, where it
  // leaves room for two blocks an SM, two stages ran 20% slower (PERF.md,
  // section 6).
  static constexpr int kStages = DH == 64 || DH == 192 ? 1 : 2;
  static constexpr size_t bytes =
      sizeof(float) * (2 * (size_t)BK * LD + kStages * (size_t)kStage + 2 * (size_t)BK * LDP);
  // Blocks an SM (228 KB of shared memory, 1 KB of it reserved a block).
  static constexpr int kMinBlocks = 2 * (bytes + 1024) <= 233472 ? 2 : 1;
};

// Past Dh 256 (320, 384, 448, 512): two parts of 128 threads share the
// block's K, V and Q/dO tiles, in one stage. With kSplit (up to 384), the
// column split (flash_bwd_dkv_f32_split_kernel): part 0 keeps dK and dV
// over the first W0 columns (whole 64-column steps), part 1 over the rest,
// and each makes S^T and dP^T over half of Dh and adds the other's
// partials through shared memory. Without it (past 384), the roles of Dh
// 192 (flash_bwd_dkv_f32_parts_kernel): part 0 makes P^T and keeps dV,
// part 1 makes dP^T and dS^T and keeps dK, each over all of Dh. A padded
// row takes 4 (DH + 4) bytes, 2 KB at 512: 32-key blocks, with 32-row
// Q/dO tiles up to 384 and 16-row ones past it (179-217 KB), KPT keys x
// NQT queries of S^T a thread.
template <int DH>
struct DkvCfg<DH, true> {
  static constexpr int kParts = 2, kStages = 1;
  static constexpr bool kSplit = DH <= 384;  // the column split, else the roles
  static constexpr int BK = 32, BQ = DH <= 384 ? 32 : 16, KPT = BK / 8;
  static constexpr int kPartThreads = kDkvThreads, kThreads = kParts * kPartThreads;
  static constexpr int G = BK / KPT;
  static constexpr int LD = DH + 4, LDP = BQ + 4, NC4 = DH / 64, NQT = BQ / 16;
  static constexpr int W0 = 64 * ((DH / 64 + 1) / 2), W1 = DH - W0;
  static constexpr int kStage = 2 * BQ * LD + 2 * BQ;
  // K, V, the Q/dO stage, and [BK, LDP] tiles: P^T and dS^T, or (kSplit)
  // each part's partial S^T and dP^T, over which P^T and dS^T go.
  static constexpr size_t bytes = sizeof(float) * (2 * (size_t)BK * LD + kStages * (size_t)kStage +
                                                   (kSplit ? 4 : 2) * (size_t)BK * LDP);
  static constexpr int kMinBlocks = 1;
};

// Copies Q tile t and its dO tile, with their lse and delta rows, into
// `st`, one stage of the float32 dK/dV's Q/dO ring (cp.async, by all the
// block's threads; the caller commits).
template <int DH>
__device__ __forceinline__ void dkv_load_q(float* st, const float* q, const float* dout,
                                           const float* lse_g, const float* delta_g, size_t base,
                                           int t, int S) {
  typedef DkvCfg<DH> C;
  constexpr int BQ = C::BQ, LD = C::LD;
  const int q0 = t * BQ;
  cp_tile<BQ, DH, LD, C::kThreads>(st, q + base, q0, S);
  cp_tile<BQ, DH, LD, C::kThreads>(st + BQ * LD, dout + base, q0, S);
  if (threadIdx.x < 2 * BQ) {
    const int r = threadIdx.x % BQ, qi = q0 + r;
    const float* src = threadIdx.x < BQ ? lse_g : delta_g;
    cp_async4(st + 2 * BQ * LD + threadIdx.x, src + (qi < S ? qi : 0), qi < S);
  }
}

// Writes f * acc, a thread's rows of dK or dV (keys k0 + g + G i, columns
// col0 + 64 h + 4 c), to out.
template <int DH, int NC4 = DkvCfg<DH>::NC4>
__device__ __forceinline__ void dkv_store(float* out, const float (&acc)[DkvCfg<DH>::KPT][NC4][4],
                                          float f, size_t base, int k0, int g, int c, int S,
                                          int col0 = 0) {
  typedef DkvCfg<DH> C;
#pragma unroll
  for (int i = 0; i < C::KPT; ++i) {
    const int key = k0 + g + C::G * i;
    if (key < S) {
#pragma unroll
      for (int h = 0; h < NC4; ++h)
        *reinterpret_cast<float4*>(out + base + (size_t)key * DH + col0 + 64 * h + 4 * c) =
            make_float4(acc[i][h][0] * f, acc[i][h][1] * f, acc[i][h][2] * f, acc[i][h][3] * f);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kDkvThreads, DH == 64 ? 2 : 1)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int BH, int S,
                             int causal, float scale) {
  typedef DkvCfg<DH> C;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, LDP = C::LDP, G = C::G, KPT = C::KPT;
  constexpr int NC4 = C::NC4, STAGES = C::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LD;
  float* ring = Vs + BK * LD;  // stage s at ring + s kStage: Q, dO, lse, delta
  float* PT = ring + STAGES * C::kStage;
  float* dST = PT + BK * LDP;

  // Block order: K tile 0 of every head first (the most Q tiles when causal).
  const int bh = blockIdx.x % BH;
  const int k0 = (int)(blockIdx.x / BH) * BK;
  const size_t base = (size_t)bh * S * DH;
  const float* lse_g = lse + (size_t)bh * S;
  const float* delta_g = delta + (size_t)bh * S;
  const int g = threadIdx.x / 16, c = threadIdx.x % 16;
  // S^T and dP^T: a thread's keys g + G i (i < 4), half-warp g's own dK/dV
  // keys, and queries c + 16 u (u < 2).
  static_assert(BK * BQ == 8 * C::kThreads, "S^T is 4 keys x 2 queries a thread");
  // Q tiles [t0, q_tiles): when causal, from the first that reaches these keys.
  const int t0 = causal ? k0 / BQ : 0;
  const int q_tiles = (S + C::BQ - 1) / C::BQ;

  auto load_q = [&](int t, int stage) {
    dkv_load_q<DH>(ring + stage * C::kStage, q, dout, lse_g, delta_g, base, t, S);
  };
  cp_tile<BK, DH, LD, C::kThreads>(Ks, k + base, k0, S);
  cp_tile<BK, DH, LD, C::kThreads>(Vs, v + base, k0, S);
  if (t0 < q_tiles) load_q(t0, 0);
  cp_async_commit();

  float dka[KPT][NC4][4], dva[KPT][NC4][4];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int h = 0; h < NC4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][h][e] = dva[i][h][e] = 0.f;

  for (int t = t0; t < q_tiles; ++t) {
    const int it = t - t0, q0 = t * BQ;
    if (STAGES == 2 && t + 1 < q_tiles) load_q(t + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile t (and K, V) in shared memory for every thread
    const float* Qt = ring + (it % STAGES) * C::kStage;
    const float* dOt = Qt + BQ * LD;
    const float* lse_s = dOt + BQ * LD;
    const float* delta_s = lse_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T.
    float st[4][2], dpt[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) st[i][u] = dpt[i][u] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DH; kk += 4) {
      float4 bq[2], bo[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        bq[u] = ld4(Qt + (c + 16 * u) * LD + kk);
        bo[u] = ld4(dOt + (c + 16 * u) * LD + kk);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = ld4(Ks + (g + G * i) * LD + kk);
        const float4 a2 = ld4(Vs + (g + G * i) * LD + kk);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          st[i][u] = fmaf(a.x, bq[u].x, st[i][u]);
          st[i][u] = fmaf(a.y, bq[u].y, st[i][u]);
          st[i][u] = fmaf(a.z, bq[u].z, st[i][u]);
          st[i][u] = fmaf(a.w, bq[u].w, st[i][u]);
          dpt[i][u] = fmaf(a2.x, bo[u].x, dpt[i][u]);
          dpt[i][u] = fmaf(a2.y, bo[u].y, dpt[i][u]);
          dpt[i][u] = fmaf(a2.z, bo[u].z, dpt[i][u]);
          dpt[i][u] = fmaf(a2.w, bo[u].w, dpt[i][u]);
        }
      }
    }

    // P^T = exp(scale S^T - lse) (0 where masked) and dS^T = P^T (dP^T -
    // delta), to shared memory.
    const bool edge = q0 + BQ > S || k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + G * i, key = k0 + row;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = c + 16 * u, qi = q0 + col;
        float p = expf(st[i][u] * scale - lse_s[col]);
        if (edge && (qi >= S || key >= S || (causal && key > qi))) p = 0.f;
        PT[row * LDP + col] = p;
        dST[row * LDP + col] = p * (dpt[i][u] - delta_s[col]);
      }
    }
    __syncwarp();  // P^T and dS^T rows are written and read by one half-warp

    // dV += P^T dO and dK += dS^T Q, along the tile's queries.
#pragma unroll 2
    for (int qq = 0; qq < BQ; qq += 4) {
      float4 pa[KPT], da[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        pa[i] = ld4(PT + (g + G * i) * LDP + qq);
        da[i] = ld4(dST + (g + G * i) * LDP + qq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 bo[NC4], bq[NC4];
#pragma unroll
        for (int h = 0; h < NC4; ++h) {
          bo[h] = ld4(dOt + (qq + e) * LD + 64 * h + 4 * c);
          bq[h] = ld4(Qt + (qq + e) * LD + 64 * h + 4 * c);
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const float pv = e == 0 ? pa[i].x : e == 1 ? pa[i].y : e == 2 ? pa[i].z : pa[i].w;
          const float dsv = e == 0 ? da[i].x : e == 1 ? da[i].y : e == 2 ? da[i].z : da[i].w;
#pragma unroll
          for (int h = 0; h < NC4; ++h) {
            dva[i][h][0] = fmaf(pv, bo[h].x, dva[i][h][0]);
            dva[i][h][1] = fmaf(pv, bo[h].y, dva[i][h][1]);
            dva[i][h][2] = fmaf(pv, bo[h].z, dva[i][h][2]);
            dva[i][h][3] = fmaf(pv, bo[h].w, dva[i][h][3]);
            dka[i][h][0] = fmaf(dsv, bq[h].x, dka[i][h][0]);
            dka[i][h][1] = fmaf(dsv, bq[h].y, dka[i][h][1]);
            dka[i][h][2] = fmaf(dsv, bq[h].z, dka[i][h][2]);
            dka[i][h][3] = fmaf(dsv, bq[h].w, dka[i][h][3]);
          }
        }
      }
    }
    __syncthreads();  // every reader of this stage, P^T and dS^T is done
    if (STAGES == 1 && t + 1 < q_tiles) load_q(t + 1, 0);
  }
  cp_async_wait<0>();  // no copy left in flight when the block exits

  dkv_store<DH>(dk, dka, scale, base, k0, g, c, S);
  dkv_store<DH>(dv, dva, 1.f, base, k0, g, c, S);
}

// Two parts of 128 threads (DkvCfg::kParts: Dh 192, and past 256 without
// DkvCfg::kSplit), each over all of Dh:
// part 0 makes S^T = K Q^T and P^T, writes P^T to shared memory and keeps
// dV += P^T dO; part 1 makes dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
// from the P^T that part 0 wrote, and keeps dK += dS^T Q. Each does two of
// the four products and holds 4 NC4 floats a thread. Thread (g, c) of part
// 1 reads the P^T entries that thread (g, c) of part 0 wrote, and warp w of
// each part holds key groups 2 w and 2 w + 1, so part 1's warp waits only
// for its twin in part 0 (pair_sync).
template <int DH>
__global__ void __launch_bounds__(DkvCfg<DH>::kThreads, DkvCfg<DH>::kMinBlocks)
    flash_bwd_dkv_f32_parts_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   float* __restrict__ dk, float* __restrict__ dv, int BH, int S,
                                   int causal, float scale) {
  typedef DkvCfg<DH> C;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, LDP = C::LDP, G = C::G, KPT = C::KPT;
  constexpr int NC4 = C::NC4, NQT = C::NQT, STAGES = C::kStages;
  static_assert(C::kParts == 2 && BQ == 16 * NQT, "two parts; NQT queries a thread");
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LD;
  float* ring = Vs + BK * LD;  // stage s at ring + s kStage: Q, dO, lse, delta
  float* PT = ring + STAGES * C::kStage;
  float* dST = PT + BK * LDP;

  // Block order: K tile 0 of every head first (the most Q tiles when causal).
  const int bh = blockIdx.x % BH;
  const int k0 = (int)(blockIdx.x / BH) * BK;
  const size_t base = (size_t)bh * S * DH;
  const float* lse_g = lse + (size_t)bh * S;
  const float* delta_g = delta + (size_t)bh * S;
  const int part = threadIdx.x / C::kPartThreads, tp = threadIdx.x % C::kPartThreads;
  const int g = tp / 16, c = tp % 16;
  const int pair = 1 + tp / 32;  // the barrier of this warp and its twin in the other part
  // Q tiles [t0, q_tiles): when causal, from the first that reaches these keys.
  const int t0 = causal ? k0 / BQ : 0;
  const int q_tiles = (S + BQ - 1) / BQ;

  auto load_q = [&](int t, int stage) {
    dkv_load_q<DH>(ring + stage * C::kStage, q, dout, lse_g, delta_g, base, t, S);
  };
  cp_tile<BK, DH, LD, C::kThreads>(Ks, k + base, k0, S);
  cp_tile<BK, DH, LD, C::kThreads>(Vs, v + base, k0, S);
  if (t0 < q_tiles) load_q(t0, 0);
  cp_async_commit();

  // dV (part 0) or dK (part 1) of keys g + G i, columns 64 h + 4 c.
  float acc[KPT][NC4][4];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int h = 0; h < NC4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.f;
  const float* A = part == 0 ? Ks : Vs;      // the score product's rows
  const float* Ao = part == 0 ? PT : dST;    // the output product's A operand

  for (int t = t0; t < q_tiles; ++t) {
    const int it = t - t0, q0 = t * BQ;
    if (STAGES == 2 && t + 1 < q_tiles) load_q(t + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile t (and K, V) in shared memory for every thread
    const float* Qt = ring + (it % STAGES) * C::kStage;
    const float* dOt = Qt + BQ * LD;
    const float* lse_s = dOt + BQ * LD;
    const float* delta_s = lse_s + BQ;
    const float* B = part == 0 ? Qt : dOt;   // S^T = K Q^T, dP^T = V dO^T
    const float* Bo = part == 0 ? dOt : Qt;  // dV += P^T dO, dK += dS^T Q

    // S^T or dP^T for keys g + G i and queries c + 16 u.
    float sc[KPT][NQT];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int u = 0; u < NQT; ++u) sc[i][u] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DH; kk += 4) {
      float4 b[NQT];
#pragma unroll
      for (int u = 0; u < NQT; ++u) b[u] = ld4(B + (c + 16 * u) * LD + kk);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float4 a = ld4(A + (g + G * i) * LD + kk);
#pragma unroll
        for (int u = 0; u < NQT; ++u) {
          sc[i][u] = fmaf(a.x, b[u].x, sc[i][u]);
          sc[i][u] = fmaf(a.y, b[u].y, sc[i][u]);
          sc[i][u] = fmaf(a.z, b[u].z, sc[i][u]);
          sc[i][u] = fmaf(a.w, b[u].w, sc[i][u]);
        }
      }
    }

    if (part == 0) {
      // P^T = exp(scale S^T - lse), 0 where masked, which only the tiles
      // crossing the diagonal or the end of S need; handed to part 1.
      const bool edge = q0 + BQ > S || k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int kr = g + G * i, key = k0 + kr;
#pragma unroll
        for (int u = 0; u < NQT; ++u) {
          const int qc = c + 16 * u, qi = q0 + qc;
          float p = expf(sc[i][u] * scale - lse_s[qc]);
          if (edge && (qi >= S || key >= S || (causal && key > qi))) p = 0.f;
          PT[kr * LDP + qc] = p;
        }
      }
      pair_arrive(pair);
    } else {
      // dS^T = P^T (dP^T - delta), P^T as the twin thread of part 0 wrote it.
      pair_sync(pair);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int kr = g + G * i;
#pragma unroll
        for (int u = 0; u < NQT; ++u) {
          const int qc = c + 16 * u;
          dST[kr * LDP + qc] = PT[kr * LDP + qc] * (sc[i][u] - delta_s[qc]);
        }
      }
    }
    __syncwarp();  // a half-warp reads back only the P^T or dS^T rows it wrote

    // dV += P^T dO (part 0) or dK += dS^T Q (part 1), along the tile's queries.
#pragma unroll 2
    for (int qq = 0; qq < BQ; qq += 4) {
      float4 pa[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) pa[i] = ld4(Ao + (g + G * i) * LDP + qq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 bo[NC4];
#pragma unroll
        for (int h = 0; h < NC4; ++h) bo[h] = ld4(Bo + (qq + e) * LD + 64 * h + 4 * c);
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const float pv = e == 0 ? pa[i].x : e == 1 ? pa[i].y : e == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int h = 0; h < NC4; ++h) {
            acc[i][h][0] = fmaf(pv, bo[h].x, acc[i][h][0]);
            acc[i][h][1] = fmaf(pv, bo[h].y, acc[i][h][1]);
            acc[i][h][2] = fmaf(pv, bo[h].z, acc[i][h][2]);
            acc[i][h][3] = fmaf(pv, bo[h].w, acc[i][h][3]);
          }
        }
      }
    }
    __syncthreads();  // every reader of this stage, P^T and dS^T is done
    if (STAGES == 1 && t + 1 < q_tiles) load_q(t + 1, 0);
  }
  cp_async_wait<0>();  // no copy left in flight when the block exits

  dkv_store<DH>(part == 0 ? dv : dk, acc, part == 0 ? 1.f : scale, base, k0, g, c, S);
}

// One part of the column split past Dh 256 (DkvCfg::kSplit): dK and dV of
// the block's keys over the 64 NC4 columns from col0. Each part makes S^T =
// K Q^T and dP^T = V dO^T over half of Dh; part p writes its partials to
// tiles p and 2 + p, reads the other's from tiles 1 - p and 3 - p (its
// twin warp, a named barrier of 64 threads) and writes P^T and dS^T over
// them (read back only by the half-warp that wrote them).
template <int DH, int NC4>
__device__ __forceinline__ void dkv_split_part(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, float* Ks,
    float* Vs, float* Qt, float* Xs, int bh, int S, int k0, int causal, float scale, int part,
    int col0) {
  typedef DkvCfg<DH> C;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, LDP = C::LDP, G = C::G, KPT = C::KPT;
  constexpr int NQT = C::NQT, HALF = DH / 2;
  const size_t base = (size_t)bh * S * DH;
  const float* lse_g = lse + (size_t)bh * S;
  const float* delta_g = delta + (size_t)bh * S;
  const int tp = threadIdx.x % C::kPartThreads, g = tp / 16, c = tp % 16;
  const int pair = 1 + tp / 32;  // the barrier of this warp and its twin in the other part
  const int s0 = part * HALF;
  float* Smine = Xs + part * BK * LDP;
  float* PT = Xs + (1 - part) * BK * LDP;  // the other's partial S^T, then P^T
  const float* dOt = Qt + BQ * LD;
  const float* lse_s = dOt + BQ * LD;
  const float* delta_s = lse_s + BQ;
  // Q tiles [t0, t_end): when causal, from the first that reaches these keys.
  const int t0 = causal ? k0 / BQ : 0;
  const int t_end = (S + BQ - 1) / BQ;

  cp_tile<BK, DH, LD, C::kThreads>(Ks, k + base, k0, S);
  cp_tile<BK, DH, LD, C::kThreads>(Vs, v + base, k0, S);
  if (t0 < t_end) dkv_load_q<DH>(Qt, q, dout, lse_g, delta_g, base, t0, S);
  cp_async_commit();

  float dka[KPT][NC4][4], dva[KPT][NC4][4];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int h = 0; h < NC4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][h][e] = dva[i][h][e] = 0.f;

  for (int t = t0; t < t_end; ++t) {
    const int q0 = t * BQ;
    cp_async_wait<0>();
    __syncthreads();  // tile t (and K, V) in shared memory for every thread

    // Partial S^T = K Q^T and dP^T = V dO^T over this part's half of Dh,
    // for keys g + G i and queries c + 16 u.
    float st[KPT][NQT], dpt[KPT][NQT];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int u = 0; u < NQT; ++u) st[i][u] = dpt[i][u] = 0.f;
#pragma unroll 2
    for (int kk = s0; kk < s0 + HALF; kk += 4) {
      float4 qv[NQT], ov[NQT];
#pragma unroll
      for (int u = 0; u < NQT; ++u) {
        qv[u] = ld4(Qt + (c + 16 * u) * LD + kk);
        ov[u] = ld4(dOt + (c + 16 * u) * LD + kk);
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float4 ka = ld4(Ks + (g + G * i) * LD + kk);
        const float4 va = ld4(Vs + (g + G * i) * LD + kk);
#pragma unroll
        for (int u = 0; u < NQT; ++u) {
          st[i][u] = fmaf(ka.x, qv[u].x, st[i][u]);
          st[i][u] = fmaf(ka.y, qv[u].y, st[i][u]);
          st[i][u] = fmaf(ka.z, qv[u].z, st[i][u]);
          st[i][u] = fmaf(ka.w, qv[u].w, st[i][u]);
          dpt[i][u] = fmaf(va.x, ov[u].x, dpt[i][u]);
          dpt[i][u] = fmaf(va.y, ov[u].y, dpt[i][u]);
          dpt[i][u] = fmaf(va.z, ov[u].z, dpt[i][u]);
          dpt[i][u] = fmaf(va.w, ov[u].w, dpt[i][u]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int u = 0; u < NQT; ++u) {
        Smine[(g + G * i) * LDP + c + 16 * u] = st[i][u];
        Smine[(2 * BK + g + G * i) * LDP + c + 16 * u] = dpt[i][u];
      }
    pair_sync(pair);

    // The sums (the same in both parts), P^T = exp(scale S^T - lse) (0
    // where masked) and dS^T = P^T (dP^T - delta), over the other's tiles.
    const bool edge = q0 + BQ > S || k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kr = g + G * i, key = k0 + kr;
#pragma unroll
      for (int u = 0; u < NQT; ++u) {
        const int qc = c + 16 * u, qi = q0 + qc;
        const float s_t = st[i][u] + PT[kr * LDP + qc];
        const float dp_t = dpt[i][u] + PT[(2 * BK + kr) * LDP + qc];
        float p = expf(s_t * scale - lse_s[qc]);
        if (edge && (qi >= S || key >= S || (causal && key > qi))) p = 0.f;
        PT[kr * LDP + qc] = p;
        PT[(2 * BK + kr) * LDP + qc] = p * (dp_t - delta_s[qc]);
      }
    }
    __syncwarp();  // a half-warp reads back only the P^T and dS^T rows it wrote

    // dV += P^T dO and dK += dS^T Q over this part's columns.
    const float* dST = PT + 2 * BK * LDP;
#pragma unroll 2
    for (int qq = 0; qq < BQ; qq += 4) {
      float4 pa[KPT], da[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        pa[i] = ld4(PT + (g + G * i) * LDP + qq);
        da[i] = ld4(dST + (g + G * i) * LDP + qq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 bo[NC4], bq[NC4];
#pragma unroll
        for (int h = 0; h < NC4; ++h) {
          bo[h] = ld4(dOt + (qq + e) * LD + col0 + 64 * h + 4 * c);
          bq[h] = ld4(Qt + (qq + e) * LD + col0 + 64 * h + 4 * c);
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const float pv = e == 0 ? pa[i].x : e == 1 ? pa[i].y : e == 2 ? pa[i].z : pa[i].w;
          const float dsv = e == 0 ? da[i].x : e == 1 ? da[i].y : e == 2 ? da[i].z : da[i].w;
#pragma unroll
          for (int h = 0; h < NC4; ++h) {
            dva[i][h][0] = fmaf(pv, bo[h].x, dva[i][h][0]);
            dva[i][h][1] = fmaf(pv, bo[h].y, dva[i][h][1]);
            dva[i][h][2] = fmaf(pv, bo[h].z, dva[i][h][2]);
            dva[i][h][3] = fmaf(pv, bo[h].w, dva[i][h][3]);
            dka[i][h][0] = fmaf(dsv, bq[h].x, dka[i][h][0]);
            dka[i][h][1] = fmaf(dsv, bq[h].y, dka[i][h][1]);
            dka[i][h][2] = fmaf(dsv, bq[h].z, dka[i][h][2]);
            dka[i][h][3] = fmaf(dsv, bq[h].w, dka[i][h][3]);
          }
        }
      }
    }
    __syncthreads();  // every reader of this stage and of the score tiles is done
    if (t + 1 < t_end) dkv_load_q<DH>(Qt, q, dout, lse_g, delta_g, base, t + 1, S);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy left in flight when the block exits

  dkv_store<DH, NC4>(dk, dka, scale, base, k0, g, c, S, col0);
  dkv_store<DH, NC4>(dv, dva, 1.f, base, k0, g, c, S, col0);
}

template <int DH>
__global__ void __launch_bounds__(DkvCfg<DH>::kThreads, 1)
    flash_bwd_dkv_f32_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   float* __restrict__ dk, float* __restrict__ dv, int BH, int S,
                                   int causal, float scale) {
  typedef DkvCfg<DH> C;
  static_assert(C::kSplit && C::kStages == 1, "the column split, one stage");
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + C::BK * C::LD;
  float* Qt = Vs + C::BK * C::LD;  // Q, dO, lse, delta
  float* Xs = Qt + C::kStage;      // four [BK, LDP] tiles

  // Block order: K tile 0 of every head first (the most Q tiles when causal).
  const int bh = blockIdx.x % BH;
  const int k0 = (int)(blockIdx.x / BH) * C::BK;
  const int part = threadIdx.x / C::kPartThreads;
  if constexpr (C::W0 == C::W1) {
    dkv_split_part<DH, C::W0 / 64>(q, k, v, dout, lse, delta, dk, dv, Ks, Vs, Qt, Xs, bh, S, k0,
                                   causal, scale, part, part * C::W0);
  } else if (part == 0) {
    dkv_split_part<DH, C::W0 / 64>(q, k, v, dout, lse, delta, dk, dv, Ks, Vs, Qt, Xs, bh, S, k0,
                                   causal, scale, 0, 0);
  } else {
    dkv_split_part<DH, C::W1 / 64>(q, k, v, dout, lse, delta, dk, dv, Ks, Vs, Qt, Xs, bh, S, k0,
                                   causal, scale, 1, C::W0);
  }
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                       int causal, float scale, cudaStream_t stream) {
  typedef DkvCfg<DH> C;
  auto run = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, C::bytes);
    if (e != cudaSuccess) return e;
    const long long blocks = (long long)((s + C::BK - 1) / C::BK) * bh;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, C::kThreads, C::bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), bh, s,
        causal, scale);
    return cudaGetLastError();
  };
  if constexpr (C::kSplit)
    return run(flash_bwd_dkv_f32_split_kernel<DH>);
  else if constexpr (C::kParts == 2)
    return run(flash_bwd_dkv_f32_parts_kernel<DH>);
  else
    return run(flash_bwd_dkv_f32_kernel<DH>);
}

// The float32 dK/dV at any other head dim past 256 (every multiple of 8
// past 512 on the public route; flash_bwd_dkv_xl_f32_kernel). Blocks of 32
// keys and Q/dO tiles of 32 rows; two parts of 128 threads, 8 key groups of
// KPT keys each. dK and dV are cut into column chunks, one a block, of at
// most kChunkSteps 64-column steps (a power of two of chunks); part 0
// keeps dV and part 1 dK, each over the whole chunk. The blocks of one key tile's
// chunks form clusters of DkvXlPlan::cluster blocks (all of them up to 8
// chunks), and the cluster splits S^T = K Q^T and dP^T = V dO^T over Dh's
// 64-column slabs: block r of R takes slabs [r nb / R, (r + 1) nb / R),
// part 0 of it the first half of those and part 1 the rest. Each part adds
// the other's partials, then each block the cluster's block sums, read
// through distributed shared memory in rank order, so every part of every
// chunk's block holds the same P^T and dS^T to the bit, and no chunk makes
// another's share of the scores. The block's slabs of K and V stay in
// shared memory (up to kKvResidentSteps of them; past that they stream
// beside Q and dO). Q and dO pass through a cp.async ring of kRing slots,
// both parts' in a slot: the scores' slabs, then the chunk's for dV += P^T
// dO and dK += dS^T Q, one step a share of the slot.
struct DkvXlCfg {
  static constexpr int BK = 32, BQ = 32, KPT = BK / 8;  // keys a block, Q rows a tile, keys a group
  static constexpr int G = 8, kPartThreads = 16 * G, kThreads = 2 * kPartThreads;
  static constexpr int kChunkSteps = 5;  // 64-column steps of dK and dV a block
  static constexpr int kRing = 2;        // slab ring depth
  static constexpr int kKvResidentSteps = 5;  // K and V stay in shared memory up to this many slabs
  static constexpr int LDS = 64 + 4;     // a slab's rows (floats), padded by 16 bytes
  static constexpr int LDX = BQ + 4, NQT = BQ / 16;
};

// What a head dim gives the float32 dK/dV past 256: nb 64-column slabs of
// Dh (the last one zero past it), the chunks and their clusters, the
// widest chunk's steps, whether the blocks' slabs of K and V stay
// resident, and the block's shared memory.
struct DkvXlPlan {
  int nb, chunks, width, cluster;
  bool kv_res;
  __host__ __device__ explicit DkvXlPlan(int dh)
      : nb((dh + 63) / 64),
        chunks(xl_chunks(nb, DkvXlCfg::kChunkSteps)),
        width(xl_width(nb, DkvXlCfg::kChunkSteps, 1)),
        cluster(xl_cluster(chunks)),
        kv_res(most_slabs() <= DkvXlCfg::kKvResidentSteps) {}
  // The least and the most steps a chunk of a head dim past 256 takes: the
  // instantiations built.
  static constexpr int kMinWidth = xl_width_bound(DkvXlCfg::kChunkSteps, 1, false);
  static constexpr int kMaxWidth = xl_width_bound(DkvXlCfg::kChunkSteps, 1, true);
  // The most slabs of the scores a block of a cluster takes.
  __host__ __device__ int most_slabs() const { return (nb + cluster - 1) / cluster; }
  __host__ __device__ int ldkv() const { return 64 * most_slabs() + 4; }
  __host__ __device__ int kv_floats() const { return kv_res ? 2 * DkvXlCfg::BK * ldkv() : 0; }
  // A part's share of a ring slot: its Q and dO slabs, and K's and V's
  // unless resident (one step's Q and dO of the output products fit).
  __host__ __device__ int share_floats() const {
    return (2 * DkvXlCfg::BQ + (kv_res ? 0 : 2 * DkvXlCfg::BK)) * DkvXlCfg::LDS;
  }
  // K and V (resident), the ring, four [BK, LDX] score tiles, and in a
  // cluster two more for each parity of the Q tile: the block's sums of
  // S^T and dP^T.
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)kv_floats() + (size_t)DkvXlCfg::kRing * 2 * share_floats() +
                            (cluster > 1 ? 8 : 4) * DkvXlCfg::BK * DkvXlCfg::LDX);
  }
};

// One part of the float32 dK/dV past 256: the NC 64-column steps of the
// chunk (its first column is 64 b0) of dV (part 0) or dK (part 1).
template <int NC>
__device__ __forceinline__ void dkv_xl_part(const DkvXlPlan& p, const float* __restrict__ q,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            const float* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            float* __restrict__ dk, float* __restrict__ dv,
                                            float* KVs, float* ring, float* Xs, int bh, int S,
                                            int dh, int k0, int causal, float scale, int part,
                                            int rank, int b0) {
  typedef DkvXlCfg C;
  constexpr int BQ = C::BQ, BK = C::BK, KPT = C::KPT, G = C::G, LDS = C::LDS, LDX = C::LDX;
  constexpr int NQT = C::NQT;
  const size_t base = (size_t)bh * S * dh;
  const int tp = threadIdx.x % C::kPartThreads, g = tp / 16, c = tp % 16;
  const int pair = 1 + tp / 32;  // the barrier of this warp and its twin in the other part
  // The block's slabs of S^T and dP^T, from s0 (part 0 the first nd0 of
  // them, part 1 the rest): the same for the block of this rank in every
  // cluster.
  const int s0 = rank * p.nb / p.cluster, ns = (rank + 1) * p.nb / p.cluster - s0;
  const int nd0 = (ns + 1) / 2;
  const int n_out = (NC + 1) / 2;  // output ring steps a Q tile: one step a share
  const int per_tile = nd0 + n_out, share = p.share_floats(), slot = 2 * share;
  // Q tiles [t0, t_end): when causal, from the first that reaches these keys.
  const int t0 = causal ? k0 / BQ : 0, t_end = (S + BQ - 1) / BQ;
  const int n_loads = (t_end - t0) * per_tile;
  const int ldkv = p.ldkv();
  // Part p writes its partial S^T and dP^T to tiles p and 2 + p, reads the
  // other's from 1 - p and 3 - p, and writes P^T and dS^T over them (read
  // back only by the half-warp that wrote them).
  float* Xmine = Xs + part * BK * LDX;
  float* PT = Xs + (1 - part) * BK * LDX;
  const float* dST = PT + 2 * BK * LDX;
  float* sums = Xs + 4 * BK * LDX;  // the block's S^T and dP^T sums, two a Q tile parity

  // Slabs [d, d + nd) (64 columns each) of rows [row0, row0 + rows) of
  // src into a tile of row stride ld: zero past S and past Dh.
  auto span = [&](float* sm, int ld, const float* src, int row0, int rows, int d, int nd) {
    cp_span<C::kThreads>(sm, ld, src + base, dh, row0, rows, S, 64 * d, 64 * nd, dh);
  };
  auto slab = [&](float* sm, const float* src, int row0, int rows, int d) {
    span(sm, LDS, src, row0, rows, d, 1);
  };
  // Load n, step r = n % per_tile of Q tile t0 + n / per_tile: for r < nd0
  // slab r of part 0 and nd0 + r of part 1 (Q, dO, and K, V unless they are
  // resident: a share of the slot holds them in that order), after that
  // the chunk's Q and dO slabs of its next two steps, one a share.
  auto load = [&](int n) {
    const int r = n % per_tile, q0 = (t0 + n / per_tile) * BQ;
    float* dst = ring + (n % C::kRing) * slot;
#pragma unroll
    for (int h = 0; h < 2; ++h, dst += share) {
      if (r < nd0) {
        const int d = h * nd0 + r;
        if (d < ns) {
          slab(dst, q, q0, BQ, s0 + d);
          slab(dst + BQ * LDS, dout, q0, BQ, s0 + d);
          if (!p.kv_res) {
            slab(dst + 2 * BQ * LDS, k, k0, BK, s0 + d);
            slab(dst + (2 * BQ + BK) * LDS, v, k0, BK, s0 + d);
          }
        }
      } else {
        const int st = 2 * (r - nd0) + h;
        if (st < NC) {
          slab(dst, q, q0, BQ, b0 + st);
          slab(dst + BQ * LDS, dout, q0, BQ, b0 + st);
        }
      }
    }
  };
  // Ring step n: load n + kRing - 1 starts and load n is waited for.
  auto step_in = [&](int n) {
    if (n + C::kRing - 1 < n_loads) load(n + C::kRing - 1);
    cp_async_commit();
    cp_async_wait<C::kRing - 1>();
    __syncthreads();  // load n (and K, V with the first) in shared memory for every thread
  };
  if (p.kv_res) {
    span(KVs, ldkv, k, k0, BK, s0, ns);
    span(KVs + BK * ldkv, ldkv, v, k0, BK, s0, ns);
  }
#pragma unroll
  for (int n = 0; n < C::kRing - 1; ++n) {
    if (n < n_loads) load(n);
    cp_async_commit();
  }

  // dV (part 0) or dK (part 1) of keys g + G i over the chunk's steps.
  float acc[NC][KPT][4];
#pragma unroll
  for (int h = 0; h < NC; ++h)
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][i][e] = 0.f;
  // The output product's A operand (P^T or dS^T) and B (dO or Q) in a share.
  const float* oa = part == 0 ? PT : dST;
  const int ob = part == 0 ? BQ * LDS : 0;

  int ld = 0;  // loads consumed
  for (int t = t0; t < t_end; ++t) {
    const int q0 = t * BQ;
    float lse_q[NQT], dlt_q[NQT];
#pragma unroll
    for (int u = 0; u < NQT; ++u) {
      const int qi = q0 + c + 16 * u;
      lse_q[u] = qi < S ? lse[(size_t)bh * S + qi] : 0.f;
      dlt_q[u] = qi < S ? delta[(size_t)bh * S + qi] : 0.f;
    }
    // Partial S^T = K Q^T and dP^T = V dO^T for keys g + G i and queries
    // c + 16 u, over this part's slabs.
    float st[KPT][NQT], dpt[KPT][NQT];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int u = 0; u < NQT; ++u) st[i][u] = dpt[i][u] = 0.f;
    for (int i = 0; i < nd0; ++i, ++ld) {
      step_in(ld);
      const int d = part * nd0 + i;
      if (d < ns) {
        const float* sl = ring + (ld % C::kRing) * slot + part * share;
        const float* ka = p.kv_res ? KVs + 64 * d : sl + 2 * BQ * LDS;
        const float* va = p.kv_res ? KVs + BK * ldkv + 64 * d : sl + (2 * BQ + BK) * LDS;
        const int lda = p.kv_res ? ldkv : LDS;
#pragma unroll 1
        for (int kk = 0; kk < 64; kk += 4) {
          dot4_lda<KPT, NQT, G, LDS>(st, ka + kk, lda, sl + kk, g, c);
          dot4_lda<KPT, NQT, G, LDS>(dpt, va + kk, lda, sl + BQ * LDS + kk, g, c);
        }
      }
      __syncthreads();  // every reader of this slot is done before a later load lands in it
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int u = 0; u < NQT; ++u) {
        Xmine[(g + G * i) * LDX + c + 16 * u] = st[i][u];
        Xmine[(2 * BK + g + G * i) * LDX + c + 16 * u] = dpt[i][u];
      }
    pair_sync(pair);  // warp w of each part holds the same keys
    // The block's sums (the same in both parts).
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int u = 0; u < NQT; ++u) {
        st[i][u] += PT[(g + G * i) * LDX + c + 16 * u];
        dpt[i][u] += PT[(2 * BK + g + G * i) * LDX + c + 16 * u];
      }
    if (p.cluster > 1) {
      // S^T and dP^T are the cluster's block sums added in rank order: the
      // same in every block. A tile parity's sums are overwritten only after
      // the next Q tile's cluster barrier, by which every block has read them.
      float* mine = sums + (t & 1) * 2 * BK * LDX;
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int u = 0; u < NQT; ++u) {
          const int at = (part * BK + g + G * i) * LDX + c + 16 * u;
          mine[at] = part == 0 ? st[i][u] : dpt[i][u];
        }
      cluster_sync();
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int u = 0; u < NQT; ++u) {
          const int at = (g + G * i) * LDX + c + 16 * u;
          float s_sum = peer_ld(mine + at, 0), dp_sum = peer_ld(mine + BK * LDX + at, 0);
          for (int b = 1; b < p.cluster; ++b) {
            s_sum += peer_ld(mine + at, b);
            dp_sum += peer_ld(mine + BK * LDX + at, b);
          }
          st[i][u] = s_sum;
          dpt[i][u] = dp_sum;
        }
    }

    // P^T = exp(scale S^T - lse) (0 where masked) and dS^T = P^T (dP^T -
    // delta), over the other's tiles.
    const bool edge = q0 + BQ > S || k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kr = g + G * i, key = k0 + kr;
#pragma unroll
      for (int u = 0; u < NQT; ++u) {
        const int qc = c + 16 * u, qi = q0 + qc;
        float pr = expf(st[i][u] * scale - lse_q[u]);
        if (edge && (qi >= S || key >= S || (causal && key > qi))) pr = 0.f;
        PT[kr * LDX + qc] = pr;
        PT[(2 * BK + kr) * LDX + qc] = pr * (dpt[i][u] - dlt_q[u]);
      }
    }
    __syncwarp();  // a half-warp reads back only the P^T and dS^T rows it wrote

    // dV += P^T dO (part 0) and dK += dS^T Q (part 1) over the chunk's
    // steps, two a ring step (step 2 i + y in share y): P^T and dS^T rows
    // along the queries as float4, the step's dO or Q slab one query at a
    // time at columns 4 c.
#pragma unroll
    for (int i = 0; i < (NC + 1) / 2; ++i) {
      step_in(ld);
      const float* sl = ring + (ld % C::kRing) * slot + ob;
#pragma unroll
      for (int y = 0; y < 2; ++y)
        if (2 * i + y < NC) {
#pragma unroll 2
          for (int qq = 0; qq < BQ; qq += 4)
            pv4_step<KPT, G, LDX, LDS>(acc[2 * i + y], oa + qq, sl + y * share + qq * LDS, g, c);
        }
      __syncthreads();  // every reader of this slot (and, at the last, of P^T, dS^T) is done
      ++ld;
    }
  }
  cp_async_wait<0>();  // no copy left in flight when the block exits
  if (p.cluster > 1) cluster_sync();  // no block exits while another may read its sums

  float* out = part == 0 ? dv : dk;
  const float f = part == 0 ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int key = k0 + g + G * i;
    if (key < S) {
#pragma unroll
      for (int h = 0; h < NC; ++h) {
        const int col = 64 * (b0 + h) + 4 * c;
        const float* a = acc[h][i];
        if (col < dh)
          *reinterpret_cast<float4*>(out + base + (size_t)key * dh + col) =
              make_float4(a[0] * f, a[1] * f, a[2] * f, a[3] * f);
      }
    }
  }
}

// W: the steps of the widest chunk of a launch; a chunk has W or W - 1.
template <int W>
__global__ void __launch_bounds__(DkvXlCfg::kThreads, 1)
    flash_bwd_dkv_xl_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int BH, int S,
                                int dh, int causal, float scale) {
  typedef DkvXlCfg C;
  const DkvXlPlan p(dh);
  extern __shared__ __align__(128) unsigned char smem[];
  float* KVs = reinterpret_cast<float*>(smem);  // K, then V (resident)
  float* ring = KVs + p.kv_floats();
  float* Xs = ring + C::kRing * 2 * p.share_floats();

  // Block order: chunks of one key block together, key block 0 of every
  // head first (the most Q tiles when causal).
  const int chunk = blockIdx.x % p.chunks, rest = blockIdx.x / p.chunks;
  const int bh = rest % BH;
  const int k0 = rest / BH * C::BK;
  const int b0 = chunk * p.nb / p.chunks, nbc = (chunk + 1) * p.nb / p.chunks - b0;
  const int part = threadIdx.x / C::kPartThreads;
  const int rank = chunk % p.cluster;  // the block's rank in its cluster
  if (nbc == W)
    dkv_xl_part<W>(p, q, k, v, dout, lse, delta, dk, dv, KVs, ring, Xs, bh, S, dh, k0, causal,
                   scale, part, rank, b0);
  else
    dkv_xl_part<W - 1>(p, q, k, v, dout, lse, delta, dk, dv, KVs, ring, Xs, bh, S, dh, k0, causal,
                       scale, part, rank, b0);
}

template <int W>
cudaError_t launch_dkv_xl_w(const DkvXlPlan& p, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, int bh, int s, int dh, int causal, float scale,
                            cudaStream_t stream) {
  const size_t bytes = p.bytes();
  cudaError_t e = allow_smem(flash_bwd_dkv_xl_f32_kernel<W>, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + DkvXlCfg::BK - 1) / DkvXlCfg::BK) * bh * p.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  e = launch_clustered(flash_bwd_dkv_xl_f32_kernel<W>, (unsigned)blocks, DkvXlCfg::kThreads,
                       bytes, p.cluster, stream, q, k, v, dout, lse, delta, dk, dv, bh, s, dh,
                       causal, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch_dkv_xl(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                          int dh, int causal, float scale, cudaStream_t stream) {
  const DkvXlPlan p(dh);
  return by_width<DkvXlPlan::kMinWidth, DkvXlPlan::kMaxWidth>(p.width, [&](auto w) {
    return launch_dkv_xl_w<decltype(w)::value>(p, q, k, v, dout, lse, delta, dk, dv, bh, s, dh,
                                               causal, scale, stream);
  });
}

}  // namespace f32

namespace sm90 {

constexpr int kDkvBQ = 64;     // query rows a Q/dO tile
constexpr int kBarPFull = 3;   // split layout: P^T handed from warpgroup 0 to 1
constexpr int kBarPEmpty = 4;  // split layout: warpgroup 1 has read it

// The bf16 dK/dV's tiles at head dim DH: BK keys a block, a ring of
// kStages Q/dO tiles. Up to Dh 128 a block takes 128 keys, 64 to each
// consumer warpgroup, which keeps dK and dV of its keys ([64, DH] float32
// each, DH floats a thread). Past Dh 128 that is more than the 255
// registers a thread has, so a block takes 64 keys and splits the
// outputs instead (kSplit): warpgroup 0 keeps dV and warpgroup 1 dK, each
// over all DH columns (DH / 2 floats a thread). Warpgroup 0 makes P^T,
// warpgroup 1 dP^T; P^T goes to warpgroup 1 through shared memory (float32,
// 16 KB), which makes dS^T from it. Each score product is made once and
// each warpgroup makes one score and one output product a tile. Shared
// memory at Dh 256: K and V 32 KB each, the Q/dO ring 128 KB, P^T 16 KB.
template <int DH>
struct DkvCfg {
  static constexpr bool kSplit = DH > 128;
  static constexpr int BK = kSplit ? 64 : 128;
  static constexpr int kStages = 2;
  static constexpr uint32_t kKV = BK * DH * 2;      // the K or the V tile: 32 KB at Dh 128
  static constexpr uint32_t kQ = kDkvBQ * DH * 2;   // a Q or dO tile: 16 KB at Dh 128
  static constexpr uint32_t kX = kSplit ? 128 * 32 * 4 : 0;  // P^T handed over, 32 floats a thread
  static constexpr uint32_t kRows = 2 * kKV + 2 * kStages * kQ + kX;  // lse, delta rows start here
  static constexpr uint32_t kSmem = kRows + 2 * kStages * kDkvBQ * 4 + (1 + 2 * kStages) * 8 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int BH,
                              int S, int causal, float scale, float scale_log2) {
  typedef DkvCfg<DH> C;
  constexpr int kDkvBK = C::BK, kStages = C::kStages;
  static_assert(kStages == 1 || kStages == 2, "a ring of one or two stages");
  constexpr uint32_t kDkvKV = C::kKV, kDkvQ = C::kQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + kDkvKV;
  unsigned char* Qs = smem + 2 * kDkvKV;         // stage s at + s * kDkvQ
  unsigned char* dOs = Qs + kStages * kDkvQ;     // stage s at + s * kDkvQ
  float* lse_s = reinterpret_cast<float*>(smem + C::kRows);  // [kStages][64], times log2(e)
  float* delta_s = lse_s + kStages * kDkvBQ;                  // [kStages][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(delta_s + kStages * kDkvBQ);
  uint64_t* bar_kv = bars;
  uint64_t* full = bars + 1;         // [kStages]
  uint64_t* empty = full + kStages;  // [kStages]

  // Block order: K tile 0 of every head first (the most Q tiles when causal).
  const int bh = blockIdx.x % BH;
  const int k0 = (int)(blockIdx.x / BH) * kDkvBK;
  // Q tiles [t0, t_end): when causal, from the first that reaches these keys.
  const int t0 = causal ? k0 / kDkvBQ : 0;
  const int t_end = (S + kDkvBQ - 1) / kDkvBQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: warp 8. Lane 0 issues the copies; every lane brings two
    // entries of each of the lse and delta rows.
    regs_dealloc<24>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        prefetch_map(&map_q);
        prefetch_map(&map_do);
        mbar_expect(bar_kv, 2 * kDkvKV);
        tma_load_tile<DH>(Ks, &map_k, bar_kv, kDkvBK, k0, bh);
        tma_load_tile<DH>(Vs, &map_v, bar_kv, kDkvBK, k0, bh);
      }
      const float* lse_g = lse + (size_t)bh * S;
      const float* delta_g = delta + (size_t)bh * S;
      for (int t = t0; t < t_end; ++t) {
        const int it = t - t0, s = it & (kStages - 1), q0 = t * kDkvBQ;
        mbar_wait(&empty[s], ((it >> (kStages - 1)) & 1) ^ 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h, qi = q0 + r;
          lse_s[s * kDkvBQ + r] = qi < S ? lse_g[qi] * kLog2e : 0.f;
          delta_s[s * kDkvBQ + r] = qi < S ? delta_g[qi] : 0.f;
        }
        if (lane == 0) {
          mbar_expect(&full[s], 2 * kDkvQ);
          tma_load_tile<DH>(Qs + s * kDkvQ, &map_q, &full[s], kDkvBQ, q0, bh);
          tma_load_tile<DH>(dOs + s * kDkvQ, &map_do, &full[s], kDkvBQ, q0, bh);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else if constexpr (!C::kSplit) {
    // Consumer warpgroup wg: keys k0 + 64 wg + [0, 64).
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int key_lo = k0 + 64 * wg + 16 * (t / 32) + lane / 4, key_hi = key_lo + 8;
    float dkr[DH / 2], dvr[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dkr[i] = dvr[i] = 0.f;
    mbar_wait(bar_kv, 0);
    for (int tq = t0; tq < t_end; ++tq) {
      const int it = tq - t0, s = it & (kStages - 1), q0 = tq * kDkvBQ;
      unsigned char* Qt = Qs + s * kDkvQ;
      unsigned char* dOt = dOs + s * kDkvQ;
      mbar_wait(&full[s], (it >> (kStages - 1)) & 1);
      // S^T = K Q^T and dP^T = V dO^T, [64 keys, 64 queries] each.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t a = (kk / 4) * (kDkvBK * 128) + 64 * wg * 128 + (kk % 4) * 32;
        const uint32_t b = (kk / 4) * (kDkvBQ * 128) + (kk % 4) * 32;
        wgmma_ss_n64(st, desc(Ks + a, 16, 1024), desc(Qt + b, 16, 1024), kk);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t a = (kk / 4) * (kDkvBK * 128) + 64 * wg * 128 + (kk % 4) * 32;
        const uint32_t b = (kk / 4) * (kDkvBQ * 128) + (kk % 4) * 32;
        wgmma_ss_n64(dpt, desc(Vs + a, 16, 1024), desc(dOt + b, 16, 1024), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // P^T and dS^T = P^T (dP^T - delta), masked only on the tiles that
      // cross the diagonal or the end of S.
      const bool edge = q0 + kDkvBQ > S || k0 + kDkvBK > S || (causal && k0 + 64 * wg + 63 > q0);
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

      // dV += P^T dO and dK += dS^T Q: B is [queries, d], d contiguous.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dvr, pa[kk], desc(dOt + kk * 16 * 128, kDkvBQ * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dkr, dsa[kk], desc(Qt + kk * 16 * 128, kDkvBQ * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dvr);
      reg_fence(dkr);
      mbar_arrive(&empty[s]);
    }
    // This warpgroup's K and V rows are read by no one now: stage there.
    const size_t base = (size_t)bh * S * DH;
    store_rows(dkr, scale, scale, Ks, kDkvBK, 64 * wg, dk + base, k0 + 64 * wg, S, 1 + wg);
    store_rows(dvr, 1.f, 1.f, Vs, kDkvBK, 64 * wg, dv + base, k0 + 64 * wg, S, 1 + wg);
  } else {
    // Split layout: keys k0 + [0, 64); warpgroup 0 makes P^T and keeps dV,
    // warpgroup 1 makes dP^T and dS^T and keeps dK.
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int key_lo = k0 + 16 * (t / 32) + lane / 4, key_hi = key_lo + 8;
    float4* handed = reinterpret_cast<float4*>(smem + 2 * kDkvKV + 2 * kStages * kDkvQ);
    const unsigned char* A = wg == 0 ? Ks : Vs;  // S^T = K Q^T, dP^T = V dO^T
    OutAcc<DH> acc;                              // dV (warpgroup 0) or dK (1)
    acc.zero();
    mbar_wait(bar_kv, 0);
    for (int tq = t0; tq < t_end; ++tq) {
      const int it = tq - t0, s = it & (kStages - 1), q0 = tq * kDkvBQ;
      unsigned char* Qt = Qs + s * kDkvQ;
      unsigned char* dOt = dOs + s * kDkvQ;
      const unsigned char* Bs = wg == 0 ? Qt : dOt;   // the score product's B
      const unsigned char* Bo = wg == 0 ? dOt : Qt;   // the output product's B
      mbar_wait(&full[s], (it >> (kStages - 1)) & 1);
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t a = (kk / 4) * (kDkvBK * 128) + (kk % 4) * 32;
        const uint32_t b = (kk / 4) * (kDkvBQ * 128) + (kk % 4) * 32;
        wgmma_ss_n64(sc, desc(A + a, 16, 1024), desc(Bs + b, 16, 1024), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      if (wg == 0) {
        // P^T, masked only on the tiles that cross the diagonal or the end
        // of S, handed to warpgroup 1 once it has read the last one.
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
        if (it > 0) consumers_wait(kBarPEmpty);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          handed[128 * j + t] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
        consumers_arrive(kBarPFull);
      } else {
        // dS^T = P^T (dP^T - delta), P^T as warpgroup 0 made it (entry i of
        // thread t holds the same key and query in both warpgroups).
        consumers_wait(kBarPFull);
        float p[32];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 v4 = handed[128 * j + t];
          p[4 * j] = v4.x, p[4 * j + 1] = v4.y, p[4 * j + 2] = v4.z, p[4 * j + 3] = v4.w;
        }
        if (tq + 1 < t_end) consumers_arrive(kBarPEmpty);
        const float* drow = delta_s + s * kDkvBQ;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int qc = 8 * (i / 4) + 2 * (lane % 4);
          const float2 d2 = *reinterpret_cast<const float2*>(drow + qc);
          sc[i] = p[i] * (sc[i] - d2.x);
          sc[i + 1] = p[i + 1] * (sc[i + 1] - d2.y);
        }
      }
      uint32_t a[4][4];
      to_a_operand(sc, a);

      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1): B is [queries, d].
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc.mma(a[kk], Bo + kk * 16 * 128, kDkvBQ * 128);
      wgmma_commit();
      wgmma_wait<0>();
      acc.fence();
      mbar_arrive(&empty[s]);
    }
    // Each warpgroup stages through the tile only it read: dV through K,
    // dK through V.
    const size_t base = (size_t)bh * S * DH;
    if (wg == 0)
      acc.store(1.f, 1.f, Ks, kDkvBK, 0, dv + base, k0, S, 1);
    else
      acc.store(scale, scale, Vs, kDkvBK, 0, dk + base, k0, S, 2);
  }
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                       int causal, float scale, cudaStream_t stream) {
  typedef DkvCfg<DH> C;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, DH, kDkvBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mdo, dout, bh, s, DH, kDkvBQ)) != cudaSuccess) return e;
  if ((e = allow_smem(flash_bwd_dkv_kernel_sm90<DH>, C::kSmem)) != cudaSuccess) return e;
  const long long blocks = (long long)((s + C::BK - 1) / C::BK) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dkv_kernel_sm90<DH><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), bh, s, causal, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

constexpr int kDkvWideBK = 64;  // keys a block past Dh 256: both consumer warpgroups' rows

// The bf16 dK/dV past Dh 256 (320, 384, 448, 512). The split layout of Dh
// 256 keeps dV (warpgroup 0) or dK (warpgroup 1) of 64 keys over all of Dh,
// Dh / 2 floats a thread: past 320 that is more than a consumer thread's
// 240 registers hold. So dK and dV are cut into kChunks column chunks of
// whole 64-column boxes (rank 0 the first kCols0 columns, the larger half
// at 448; rank 1 the rest), one a block, and the blocks of one key tile
// form a thread-block cluster. Each block keeps the split layout
// over its own columns (OutAcc of at most 256 columns, 128 floats a
// thread) and needs only those columns of K, V, Q and dO: S^T = K Q^T
// (warpgroup 0) and dP^T = V dO^T (warpgroup 1) are the sums of the two
// blocks' partial products over their columns. Each warpgroup pushes its
// partial into the other block's shared memory (double-buffered by Q tile
// parity) and arrives on that block's barrier; once its own barrier has
// the other's arrivals it adds the two in rank order, so both blocks hold
// the same S^T, P^T, dP^T and dS^T and neither makes the scores again.
// Q/dO tiles take BQ rows (S^T on m64nBQk16) in a ring of kStages. At 320
// (kChunks 1) one block keeps all of Dh (WideAcc past 256 columns) and no
// partial is exchanged.
template <int DH>
struct DkvWideCfg {
  static constexpr int BQ = 32;          // query rows a Q/dO tile
  static constexpr int kStages = 2;      // Q/dO ring depth
  // Column chunks of dK and dV, one a block of a cluster; at 320 one
  // block keeps all of Dh (160 floats a thread).
  static constexpr int kChunks = DH == 320 ? 1 : 2;
  static constexpr int kCols0 = kChunks == 1 ? DH : 64 * ((DH / 64 + 1) / 2);
  static constexpr int kCols1 = DH - kCols0;
  static constexpr uint32_t kKV = kDkvWideBK * kCols0 * 2;  // rank 0's columns of K or V: 32 KB at 512
  static constexpr uint32_t kQ = BQ * kCols0 * 2;           // of a Q or dO tile: 16 KB at 512
  static constexpr uint32_t kX = 128 * (BQ / 2) * 4;        // P^T, or a warpgroup's partial S^T or dP^T
  // K, V, the Q/dO ring, P^T handed over, the other block's partials
  // [parity][warpgroup]; then the lse and delta rows and the barriers.
  static constexpr uint32_t kRows =
      2 * kKV + 2 * kStages * kQ + kX + (kChunks == 1 ? 0 : 4 * kX);
  static constexpr int kBars = 1 + 2 * kStages + 4;
  static constexpr uint32_t kSmem = kRows + 2 * kStages * BQ * 4 + kBars * 8 + 1024;
};

// The boxes [c0 / 64, c0 / 64 + n) of a [rows, ...] tile of `map` at row
// row0, head bh, into consecutive boxes of `rows` * 128 bytes at dst.
__device__ __forceinline__ void tma_load_cols(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int rows, int row0, int bh, int c0, int n) {
  for (int h = 0; h < n; ++h)
    tma_load(static_cast<char*>(dst) + h * rows * 128, map, bar, c0 + 64 * h, row0, bh);
}

// Consumer warpgroup wg of the block of rank C0 == 0 ? 0 : 1: its C columns
// [C0, C0 + C) of dV (wg 0) or dK (wg 1) of keys k0 + [0, 64).
template <int DH, int C, int C0>
__device__ __forceinline__ void dkv_wide_consumer(
    unsigned char* smem, const float* lse_s, const float* delta_s, uint64_t* bars,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int bh, int S, int k0,
    int t0, int t_end, int causal, float scale, float scale_log2) {
  typedef DkvWideCfg<DH> Cfg;
  constexpr int BQ = Cfg::BQ, kStages = Cfg::kStages, N = BQ / 2;  // N: floats of S^T a thread
  constexpr int rank = C0 == 0 ? 0 : 1;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int key_lo = k0 + 16 * (t / 32) + lane / 4, key_hi = key_lo + 8;
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + Cfg::kKV;
  unsigned char* Qs = smem + 2 * Cfg::kKV;         // stage s at + s * kQ
  unsigned char* dOs = Qs + kStages * Cfg::kQ;      // stage s at + s * kQ
  float4* handed = reinterpret_cast<float4*>(dOs + kStages * Cfg::kQ);
  float4* theirs = handed + Cfg::kX / 16;           // [parity][warpgroup]: the other block's partials
  uint64_t* full = bars + 1;                         // [kStages]
  uint64_t* empty = full + kStages;                  // [kStages]
  uint64_t* xfull = empty + kStages;                 // [parity][warpgroup]: the other's pushed
  const unsigned char* A = wg == 0 ? Ks : Vs;        // S^T = K Q^T, dP^T = V dO^T
  WideAcc<C> acc;                                    // dV (warpgroup 0) or dK (1)
  acc.zero();
  mbar_wait(bars, 0);
  for (int tq = t0; tq < t_end; ++tq) {
    const int it = tq - t0, s = it % kStages, q0 = tq * BQ;
    const unsigned char* Qt = Qs + s * Cfg::kQ;
    const unsigned char* dOt = dOs + s * Cfg::kQ;
    const unsigned char* Bs = wg == 0 ? Qt : dOt;  // the score product's B
    const unsigned char* Bo = wg == 0 ? dOt : Qt;  // the output product's B
    mbar_wait(&full[s], (it / kStages) & 1);
    float sc[N];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const uint32_t a = (kk / 4) * (kDkvWideBK * 128) + (kk % 4) * 32;
      const uint32_t b = (kk / 4) * (BQ * 128) + (kk % 4) * 32;
      wgmma_ss(sc, desc(A + a, 16, 1024), desc(Bs + b, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    if constexpr (Cfg::kChunks == 2) {
      // Push this block's partial into the other block's buffer of this
      // parity and warpgroup, arrive there, wait for the other's, and add
      // the two in rank order. A buffer is written again two tiles later,
      // after the other block has arrived for the tile between, which it
      // does after reading this one.
      const int x = (it & 1) * 2 + wg;
      const uint32_t peer = peer_addr(theirs + x * (N / 4) * 128 + t, 1 - rank);
#pragma unroll
      for (int v = 0; v < N / 4; ++v)
        st_peer(peer + v * 128 * 16,
                make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]));
      mbar_arrive_peer(peer_addr(&xfull[x], 1 - rank));
      mbar_wait_cluster(&xfull[x], (it >> 1) & 1);
#pragma unroll
      for (int v = 0; v < N / 4; ++v) {
        const float4 o = theirs[(x * (N / 4) + v) * 128 + t];
        const float r[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * v + e] = rank == 0 ? sc[4 * v + e] + r[e] : r[e] + sc[4 * v + e];
      }
    }

    const float* lrow = lse_s + s * BQ;
    const float* drow = delta_s + s * BQ;
    if (wg == 0) {
      // P^T, masked only on the tiles that cross the diagonal or the end
      // of S, handed to warpgroup 1 once it has read the last one.
      const bool edge = q0 + BQ > S || k0 + kDkvWideBK > S || (causal && k0 + 63 > q0);
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const int qc = 8 * (i / 4) + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + qc);
        const int key = (i % 4) < 2 ? key_lo : key_hi;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qi = q0 + qc + u;
          const bool masked = edge && (qi >= S || key >= S || (causal && key > qi));
          sc[i + u] = masked ? 0.f : exp2f(sc[i + u] * scale_log2 - (u ? l2.y : l2.x));
        }
      }
      if (it > 0) consumers_wait(kBarPEmpty);
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        handed[128 * j + t] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
      consumers_arrive(kBarPFull);
    } else {
      // dS^T = P^T (dP^T - delta), P^T as warpgroup 0 made it (entry i of
      // thread t holds the same key and query in both warpgroups).
      consumers_wait(kBarPFull);
      float p[N];
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const float4 v4 = handed[128 * j + t];
        p[4 * j] = v4.x, p[4 * j + 1] = v4.y, p[4 * j + 2] = v4.z, p[4 * j + 3] = v4.w;
      }
      if (tq + 1 < t_end) consumers_arrive(kBarPEmpty);
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const int qc = 8 * (i / 4) + 2 * (lane % 4);
        const float2 d2 = *reinterpret_cast<const float2*>(drow + qc);
        sc[i] = p[i] * (sc[i] - d2.x);
        sc[i + 1] = p[i + 1] * (sc[i + 1] - d2.y);
      }
    }
    uint32_t a[BQ / 16][4];
    to_a_operand(sc, a);

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1) over the block's
    // columns: B is [queries, C], MN-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc.mma(a[kk], Bo + kk * 16 * 128, BQ * 128);
    wgmma_commit();
    wgmma_wait<0>();
    acc.fence();
    mbar_arrive(&empty[s]);
  }
  // Each warpgroup stages through the tile only it read: dV through K, dK
  // through V, then copies its columns out.
  const size_t base = (size_t)bh * S * DH + C0;
  unsigned char* tile = wg == 0 ? Ks : Vs;
  acc.stage(wg == 0 ? 1.f : scale, wg == 0 ? 1.f : scale, tile, kDkvWideBK, 0, 0);
  copy_rows<DH, C>(tile, kDkvWideBK, 0, (wg == 0 ? dv : dk) + base, k0, S, 1 + wg);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wide_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                                   const __grid_constant__ CUtensorMap map_k,
                                   const __grid_constant__ CUtensorMap map_v,
                                   const __grid_constant__ CUtensorMap map_do,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                   int BH, int S, int causal, float scale, float scale_log2) {
  typedef DkvWideCfg<DH> C;
  constexpr int BQ = C::BQ, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + C::kKV;
  unsigned char* Qs = smem + 2 * C::kKV;        // stage s at + s * C::kQ
  unsigned char* dOs = Qs + kStages * C::kQ;    // stage s at + s * C::kQ
  float* lse_s = reinterpret_cast<float*>(smem + C::kRows);  // [kStages][BQ], times log2(e)
  float* delta_s = lse_s + kStages * BQ;                      // [kStages][BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(delta_s + kStages * BQ);
  uint64_t* bar_kv = bars;
  uint64_t* full = bars + 1;          // [kStages]
  uint64_t* empty = full + kStages;   // [kStages]
  uint64_t* xfull = empty + kStages;  // [parity][warpgroup]: the other block's partials pushed

  // Block order: key tile 0 of every head first (the most Q tiles when
  // causal); the kChunks blocks of a key tile are one cluster.
  const int rank = C::kChunks == 1 ? 0 : (int)cluster_rank();
  const int tile = (int)(blockIdx.x / C::kChunks);
  const int bh = tile % BH;
  const int k0 = (tile / BH) * kDkvWideBK;
  // Q tiles [t0, t_end): when causal, from the first that reaches these keys.
  const int t0 = causal ? k0 / BQ : 0;
  const int t_end = (S - 1) / BQ + 1;  // S > 0
  const int c0 = rank == 0 ? 0 : C::kCols0, boxes = (rank == 0 ? C::kCols0 : C::kCols1) / 64;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerThreads);
    }
    for (int x = 0; x < 4; ++x) mbar_init(&xfull[x], 128);
    mbar_init_fence();
  }
  __syncthreads();
  if (C::kChunks > 1) cluster_sync();  // no block arrives on the other's barriers before they exist

  if (wg == 2) {
    // Producer: warp 8. Lane 0 issues the copies of the block's columns;
    // the lanes bring the lse and delta rows.
    regs_dealloc<24>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        prefetch_map(&map_q);
        prefetch_map(&map_do);
        mbar_expect(bar_kv, 2 * kDkvWideBK * 128 * boxes);
        tma_load_cols(Ks, &map_k, bar_kv, kDkvWideBK, k0, bh, c0, boxes);
        tma_load_cols(Vs, &map_v, bar_kv, kDkvWideBK, k0, bh, c0, boxes);
      }
      const float* lse_g = lse + (size_t)bh * S;
      const float* delta_g = delta + (size_t)bh * S;
      for (int tq = t0; tq < t_end; ++tq) {
        const int it = tq - t0, s = it % kStages, q0 = tq * BQ;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        for (int r = lane; r < BQ; r += 32) {
          const int qi = q0 + r;
          lse_s[s * BQ + r] = qi < S ? lse_g[qi] * kLog2e : 0.f;
          delta_s[s * BQ + r] = qi < S ? delta_g[qi] : 0.f;
        }
        if (lane == 0) {
          mbar_expect(&full[s], 2 * BQ * 128 * boxes);
          tma_load_cols(Qs + s * C::kQ, &map_q, &full[s], BQ, q0, bh, c0, boxes);
          tma_load_cols(dOs + s * C::kQ, &map_do, &full[s], BQ, q0, bh, c0, boxes);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    regs_alloc<240>();
    if (rank == 0) {
      dkv_wide_consumer<DH, C::kCols0, 0>(smem, lse_s, delta_s, bars, dk, dv, bh, S, k0, t0,
                                          t_end, causal, scale, scale_log2);
    } else if constexpr (C::kChunks == 2) {
      dkv_wide_consumer<DH, C::kCols1, C::kCols0>(smem, lse_s, delta_s, bars, dk, dv, bh, S, k0,
                                                  t0, t_end, causal, scale, scale_log2);
    }
  }
  if (C::kChunks > 1) {
    __syncwarp();
    cluster_sync();  // no block exits while the other may still write to it
  }
}

template <int DH>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                            int causal, float scale, cudaStream_t stream) {
  typedef DkvWideCfg<DH> C;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, DH, C::BQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, DH, kDkvWideBK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, DH, kDkvWideBK)) != cudaSuccess) return e;
  if ((e = encode_map(&mdo, dout, bh, s, DH, C::BQ)) != cudaSuccess) return e;
  if ((e = allow_smem(flash_bwd_dkv_wide_kernel_sm90<DH>, C::kSmem)) != cudaSuccess) return e;
  const long long blocks = (long long)((s + kDkvWideBK - 1) / kDkvWideBK) * bh * C::kChunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  e = launch_clustered(flash_bwd_dkv_wide_kernel_sm90<DH>, (unsigned)blocks, kThreads, C::kSmem,
                       C::kChunks, stream, mq, mk, mv, mdo, static_cast<const float*>(lse),
                       static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
                       static_cast<__nv_bfloat16*>(dv), bh, s, causal, scale, scale * kLog2e);
  return e != cudaSuccess ? e : cudaGetLastError();
}

constexpr int kBarXlO = 5;  // named barrier: both warpgroups done with the Q/dO ring (dK, dV stage there)

// The bf16 dK/dV at any other head dim past 256 (every multiple of 8 past
// 512 on the public route; flash_bwd_dkv_xl_kernel_sm90). A block holds 64
// keys and one column chunk of dK and dV: at most kMaxBoxes 64-column
// boxes, in as few chunks as fit (xl_chunks_of). The split layout of Dh
// 256 over the chunk: warpgroup 0 makes S^T = K Q^T, P^T, and keeps dV,
// warpgroup 1 makes dP^T = V dO^T, dS^T from the P^T handed to it, and
// keeps dK (WideAcc of at most 64 kMaxBoxes columns each). Each walks Dh's
// 64-column slabs for its score product (m64nBQk16) through a TMA ring of
// kSlots slots of its own (a slab of K or V and the same of Q or dO); the
// output products dV += P^T dO and dK += dS^T Q take the chunk's columns of
// the Q/dO tile (kOStages tiles in flight, with their lse and delta rows).
// Every chunk's block makes the scores over all of Dh in one order, so
// every chunk holds the same P^T and dS^T to the bit; with kCluster (a
// lever, off: slower) the blocks of one key tile's chunks, a power of two
// of them, form a thread-block cluster that splits the slabs between them
// and adds the blocks' partial S^T (and dP^T) in rank order
// (xl_cluster_sum).
struct DkvXlCfg {
  static constexpr int BQ = 32, kMaxBoxes = 5;  // query rows a Q/dO tile; boxes of dK, dV a block
  static constexpr int kSlots = 4;        // slabs in flight a warpgroup
  static constexpr int kOStages = 2;      // the chunk's Q/dO tiles in flight
  static constexpr bool kCluster = false;  // the chunks' blocks split the scores over Dh
  static constexpr uint32_t kKeyBox = kDkvWideBK * 128;  // [64 keys, 64 columns]: K, V, staged dK, dV
  static constexpr uint32_t kRowBox = BQ * 128;          // [BQ rows, 64 columns]: Q, dO
  static constexpr uint32_t kSlot = kKeyBox + kRowBox;   // a slab of K (V) and the same of Q (dO)
  static constexpr uint32_t kX = 4 * 128 * (BQ / 2);     // P^T handed over, or a partial
};

// What a head dim gives the bf16 dK/dV past 256: nb boxes of Dh (the last
// one zero-filled past it), the chunks of dK and dV (a power of two with
// kCluster), the boxes of the widest chunk, the blocks of a cluster (1
// when each chunk makes the scores), and where the shared memory goes: the Q/dO ring (also where dK
// and dV stage at the end), the two slab rings, P^T handed over, a
// cluster's partials, the lse and delta rows, the barriers.
struct DkvXlPlan {
  int nb, chunks, width, cluster;
  __host__ __device__ explicit DkvXlPlan(int dh)
      : nb((dh + 63) / 64),
        chunks(xl_chunks_of(nb, DkvXlCfg::kMaxBoxes, DkvXlCfg::kCluster)),
        width(xl_width(nb, DkvXlCfg::kMaxBoxes, 1, DkvXlCfg::kCluster)),
        cluster(DkvXlCfg::kCluster ? xl_cluster(chunks) : 1) {}
  static constexpr int kMinWidth = xl_width_bound(DkvXlCfg::kMaxBoxes, 1, false, DkvXlCfg::kCluster);
  static constexpr int kMaxWidth = xl_width_bound(DkvXlCfg::kMaxBoxes, 1, true, DkvXlCfg::kCluster);
  static constexpr int kBars = 4 * DkvXlCfg::kSlots + 2 * DkvXlCfg::kOStages + 8;
  __host__ __device__ uint32_t o_stage() const { return 2 * width * DkvXlCfg::kRowBox; }
  __host__ __device__ uint32_t o_bytes() const {
    const uint32_t ring = DkvXlCfg::kOStages * o_stage(), staged = 2 * width * DkvXlCfg::kKeyBox;
    return ring > staged ? ring : staged;
  }
  __host__ __device__ uint32_t x_bytes() const { return (cluster > 1 ? 5 : 1) * DkvXlCfg::kX; }
  __host__ __device__ uint32_t bytes() const {
    return o_bytes() + 2 * DkvXlCfg::kSlots * DkvXlCfg::kSlot + x_bytes() +
           2 * DkvXlCfg::kOStages * DkvXlCfg::BQ * 4 + kBars * 8 + 1024;
  }
};

// Consumer warpgroup wg: S^T, P^T and dV (wg 0) or dP^T, dS^T and dK (wg
// 1) over slabs [s0, s1), the chunk's NB boxes from column 64 b0, of keys
// k0 + [0, 64). X: P^T handed over, then a cluster's partials [wg][parity].
template <int NB>
__device__ __forceinline__ void dkv_xl_consumer(
    const DkvXlPlan& p, unsigned char* Os, const unsigned char* ring, float4* X, const float* lse_s,
    const float* delta_s, uint64_t* bars, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int bh, int S, int dh, int k0, int t0, int t_end, int causal,
    float scale, float scale_log2, int wg, int s0, int s1, int b0) {
  typedef DkvXlCfg C;
  constexpr int BQ = C::BQ, N = BQ / 2, kSlots = C::kSlots, kStages = C::kOStages;
  uint64_t* full = bars + wg * kSlots;
  uint64_t* empty = bars + (2 + wg) * kSlots;
  uint64_t* full_o = bars + 4 * kSlots;
  uint64_t* empty_o = full_o + kStages;
  uint64_t* yfull = empty_o + kStages + 2 * wg;  // [parity]
  uint64_t* yempty = yfull + 4;                  // [parity]
  const unsigned char* my_ring = ring + wg * kSlots * C::kSlot;
  float4* handed = X;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int key_lo = k0 + 16 * (t / 32) + lane / 4, key_hi = key_lo + 8;
  WideAcc<64 * NB> acc;  // dV (warpgroup 0) or dK (1)
  acc.zero();
  uint32_t n = 0;  // slabs taken from this warpgroup's ring
  for (int tq = t0; tq < t_end; ++tq) {
    const int it = tq - t0, s = it % kStages, q0 = tq * BQ;
    float sc[N];
    xl_score<kSlots, C::kSlot, C::kKeyBox>(sc, my_ring, full, empty, n, s0, s1);
    if (p.cluster > 1)
      xl_cluster_sum(sc, X + (1 + 2 * wg) * (N / 4) * 128, yfull, yempty, it, p.cluster);
    mbar_wait(&full_o[s], (it / kStages) & 1);
    const float* lrow = lse_s + s * BQ;
    const float* drow = delta_s + s * BQ;
    if (wg == 0) {
      // P^T, masked only on the tiles that cross the diagonal or the end
      // of S, handed to warpgroup 1 once it has read the last one.
      const bool edge = q0 + BQ > S || k0 + kDkvWideBK > S || (causal && k0 + 63 > q0);
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const int qc = 8 * (i / 4) + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + qc);
        const int key = (i % 4) < 2 ? key_lo : key_hi;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qi = q0 + qc + u;
          const bool off = edge && (qi >= S || key >= S || (causal && key > qi));
          sc[i + u] = off ? 0.f : exp2f(sc[i + u] * scale_log2 - (u ? l2.y : l2.x));
        }
      }
      if (it > 0) consumers_wait(kBarPEmpty);
#pragma unroll
      for (int v = 0; v < N / 4; ++v)
        handed[128 * v + t] = make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
      consumers_arrive(kBarPFull);
    } else {
      // dS^T = P^T (dP^T - delta), P^T as warpgroup 0 made it (entry i of
      // thread t holds the same key and query in both warpgroups), read
      // one float4 at a time: entries 4 v .. 4 v + 3 are queries qc, qc + 1
      // of keys key_lo and key_hi.
      consumers_wait(kBarPFull);
#pragma unroll
      for (int v = 0; v < N / 4; ++v) {
        const float4 y = handed[128 * v + t];
        const float2 d2 = *reinterpret_cast<const float2*>(drow + 8 * v + 2 * (lane % 4));
        sc[4 * v] = y.x * (sc[4 * v] - d2.x);
        sc[4 * v + 1] = y.y * (sc[4 * v + 1] - d2.y);
        sc[4 * v + 2] = y.z * (sc[4 * v + 2] - d2.x);
        sc[4 * v + 3] = y.w * (sc[4 * v + 3] - d2.y);
      }
      if (tq + 1 < t_end) consumers_arrive(kBarPEmpty);
    }
    uint32_t a[N / 8][4];
    to_a_operand(sc, a);

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1) over the chunk's
    // columns: B is the tile's [BQ, 64 NB] dO or Q, MN-major.
    const unsigned char* Bo = Os + s * p.o_stage() + (wg == 0 ? p.width * C::kRowBox : 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc.mma(a[kk], Bo + kk * 16 * 128, C::kRowBox);
    wgmma_commit();
    wgmma_wait<0>();
    acc.fence();
    mbar_arrive(&empty_o[s]);
  }
  // Both warpgroups are done with the Q/dO ring: dV stages there from box
  // 0, dK from box `width`, and each copies the columns short of dh out.
  consumers_wait(kBarXlO);
  unsigned char* tile = Os + wg * p.width * C::kKeyBox;
  acc.stage(wg == 0 ? 1.f : scale, wg == 0 ? 1.f : scale, tile, kDkvWideBK, 0, 0);
  copy_boxes<NB>(tile, 0, (wg == 0 ? dv : dk) + (size_t)bh * S * dh, dh, k0, S, 64 * b0, 6 + wg);
}

// Where a block of the bf16 dK/dV past 256 keeps its tiles in shared
// memory: the Q/dO ring (also where dK and dV stage at the end), the two
// slab rings, P^T handed over and a cluster's partials, the lse and delta
// rows, the barriers.
struct DkvXlSmem {
  unsigned char* Os;    // the chunk's Q (then dO) boxes a stage; at the end dV, dK
  unsigned char* ring;  // warpgroup r's slot s at (r kSlots + s) kSlot
  float4* X;
  float* lse_s;         // [kOStages][BQ], times log2(e); delta's rows behind them
  uint64_t* bars;       // full and empty [wg][kSlots], the Q/dO ring's, a cluster's
};

__device__ __forceinline__ DkvXlSmem dkv_xl_smem(const DkvXlPlan& p, unsigned char* smem) {
  typedef DkvXlCfg C;
  unsigned char* ring = smem + p.o_bytes();
  unsigned char* rows = ring + 2 * C::kSlots * C::kSlot + p.x_bytes();
  return {smem, ring, reinterpret_cast<float4*>(ring + 2 * C::kSlots * C::kSlot),
          reinterpret_cast<float*>(rows),
          reinterpret_cast<uint64_t*>(rows + 2 * C::kOStages * C::BQ * 4)};
}

// What a block of the bf16 dK/dV past 256 works on: its head, its 64 keys,
// its Q tiles, its chunk's boxes and the scores' slabs. Each role makes it
// after setmaxnreg, so that none of it stays live across the split (the
// producer's 24 registers would spill it for the consumers too).
struct DkvXlBlock {
  int bh, k0, t0, t_end, b0, nbc, s0, s1;
};

__device__ __forceinline__ DkvXlBlock dkv_xl_block(const DkvXlPlan& p, int BH, int S,
                                                   int causal) {
  constexpr int BQ = DkvXlCfg::BQ;
  // Block order: the chunks of one key tile together (a cluster's blocks),
  // key tile 0 of every head first (the most Q tiles when causal).
  const int chunk = blockIdx.x % p.chunks, tile = blockIdx.x / p.chunks;
  const int bh = tile % BH;
  const int k0 = (tile / BH) * kDkvWideBK;
  // Q tiles [t0, t_end): when causal, from the first that reaches these keys.
  const int t0 = causal ? k0 / BQ : 0;
  const int t_end = 1 + (S - 1) / BQ;  // S > 0
  const int b0 = chunk * p.nb / p.chunks, nbc = (chunk + 1) * p.nb / p.chunks - b0;
  // The scores' slabs: all of Dh, or the block's share of its cluster's.
  const int rank = chunk % p.cluster;
  const int s0 = rank * p.nb / p.cluster, s1 = (rank + 1) * p.nb / p.cluster;
  return {bh, k0, t0, t_end, b0, nbc, s0, s1};
}

// W: the boxes of dK and dV the widest chunk of a launch holds; a chunk
// holds W or W - 1.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_xl_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_do,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                 int BH, int S, int dh, int causal, float scale,
                                 float scale_log2) {
  typedef DkvXlCfg C;
  constexpr int BQ = C::BQ, kSlots = C::kSlots, kStages = C::kOStages;
  const DkvXlPlan p(dh);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    uint64_t* bars = dkv_xl_smem(p, smem).bars;
    for (int s = 0; s < 2 * kSlots; ++s) {
      mbar_init(&bars[s], 1);                // full [wg][kSlots]
      mbar_init(&bars[2 * kSlots + s], 128);  // empty [wg][kSlots]
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars[4 * kSlots + s], 33);                           // the Q/dO ring's full
      mbar_init(&bars[4 * kSlots + kStages + s], kConsumerThreads);  // and empty
    }
    for (int x = 0; x < 8; ++x) mbar_init(&bars[4 * kSlots + 2 * kStages + x], 128 * p.cluster);
    mbar_init_fence();
  }
  __syncthreads();
  if (p.cluster > 1) cluster_sync();  // no block arrives on another's barriers before they exist

  if (wg == 2) {
    // Producer: lane 0 of warp 8 keeps the two slab rings full, in turn;
    // lane 0 of warp 9 brings each tile's Q and dO boxes of the chunk, and
    // warp 10 their lse and delta rows. Each holds little across its loop:
    // the producer warpgroup has 24 registers a thread.
    regs_dealloc<24>();
    const int warp = threadIdx.x / 32 - 8, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      const DkvXlSmem m = dkv_xl_smem(p, smem);
      const DkvXlBlock b = dkv_xl_block(p, BH, S, causal);
      uint64_t* full = m.bars;              // [wg][kSlots]
      uint64_t* empty = full + 2 * kSlots;  // [wg][kSlots]
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      uint32_t n[2] = {0, 0};  // slabs put in each warpgroup's ring
      for (int tq = b.t0; tq < b.t_end; ++tq) {
        for (int d = b.s0; d < b.s1; ++d) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t x = r * kSlots + n[r] % kSlots;
            mbar_wait(&empty[x], ((n[r] / kSlots) & 1) ^ 1);
            ++n[r];
            mbar_expect(&full[x], C::kSlot);
            tma_load(m.ring + x * C::kSlot, r ? &map_v : &map_k, &full[x], 64 * d, b.k0, b.bh);
            tma_load(m.ring + x * C::kSlot + C::kKeyBox, r ? &map_do : &map_q, &full[x], 64 * d,
                     tq * BQ, b.bh);
          }
        }
      }
    } else if (warp == 1 && lane == 0) {
      const DkvXlSmem m = dkv_xl_smem(p, smem);
      const DkvXlBlock b = dkv_xl_block(p, BH, S, causal);
      uint64_t* full_o = m.bars + 4 * kSlots;  // [kStages]
      uint64_t* empty_o = full_o + kStages;    // [kStages]
      prefetch_map(&map_q);
      prefetch_map(&map_do);
      for (int tq = b.t0; tq < b.t_end; ++tq) {
        const int it = tq - b.t0, s = it % kStages;
        unsigned char* st = m.Os + s * p.o_stage();
        mbar_wait(&empty_o[s], ((it / kStages) & 1) ^ 1);
        mbar_expect(&full_o[s], 2 * b.nbc * C::kRowBox);
        for (int i = 0; i < b.nbc; ++i) {
          tma_load(st + i * C::kRowBox, &map_q, &full_o[s], 64 * (b.b0 + i), tq * BQ, b.bh);
          tma_load(st + (p.width + i) * C::kRowBox, &map_do, &full_o[s], 64 * (b.b0 + i),
                   tq * BQ, b.bh);
        }
      }
    } else if (warp == 2) {
      const DkvXlSmem m = dkv_xl_smem(p, smem);
      const DkvXlBlock b = dkv_xl_block(p, BH, S, causal);
      uint64_t* full_o = m.bars + 4 * kSlots;  // [kStages]
      uint64_t* empty_o = full_o + kStages;    // [kStages]
      const float* lse_g = lse + (size_t)b.bh * S;
      const float* delta_g = delta + (size_t)b.bh * S;
      for (int tq = b.t0; tq < b.t_end; ++tq) {
        const int it = tq - b.t0, s = it % kStages;
        mbar_wait(&empty_o[s], ((it / kStages) & 1) ^ 1);
        for (int r = lane; r < BQ; r += 32) {
          const int qi = tq * BQ + r;
          m.lse_s[s * BQ + r] = qi < S ? lse_g[qi] * kLog2e : 0.f;
          m.lse_s[(kStages + s) * BQ + r] = qi < S ? delta_g[qi] : 0.f;  // delta's rows
        }
        mbar_arrive(&full_o[s]);
      }
    }
  } else {
    regs_alloc<240>();
    const DkvXlSmem m = dkv_xl_smem(p, smem);
    const DkvXlBlock b = dkv_xl_block(p, BH, S, causal);
    const float* delta_s = m.lse_s + kStages * BQ;
    if (b.nbc == W)
      dkv_xl_consumer<W>(p, m.Os, m.ring, m.X, m.lse_s, delta_s, m.bars, dk, dv, b.bh, S, dh, b.k0,
                         b.t0, b.t_end, causal, scale, scale_log2, wg, b.s0, b.s1, b.b0);
    else
      dkv_xl_consumer<W - 1>(p, m.Os, m.ring, m.X, m.lse_s, delta_s, m.bars, dk, dv, b.bh, S, dh,
                             b.k0, b.t0, b.t_end, causal, scale, scale_log2, wg, b.s0, b.s1,
                             b.b0);
  }
  if (p.cluster > 1) {
    __syncwarp();
    cluster_sync();  // no block exits while another may still read it or arrive on it
  }
}

template <int W>
cudaError_t launch_dkv_xl_w(const DkvXlPlan& p, const CUtensorMap& mq, const CUtensorMap& mk,
                            const CUtensorMap& mv, const CUtensorMap& mdo, const void* lse,
                            const void* delta, void* dk, void* dv, int bh, int s, int dh,
                            int causal, float scale, cudaStream_t stream) {
  const uint32_t bytes = p.bytes();
  cudaError_t e = allow_smem(flash_bwd_dkv_xl_kernel_sm90<W>, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + kDkvWideBK - 1) / kDkvWideBK) * bh * p.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  e = launch_clustered(flash_bwd_dkv_xl_kernel_sm90<W>, (unsigned)blocks, kThreads, bytes,
                       p.cluster, stream, mq, mk, mv, mdo, static_cast<const float*>(lse),
                       static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
                       static_cast<__nv_bfloat16*>(dv), bh, s, dh, causal, scale, scale * kLog2e);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch_dkv_xl(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                          int dh, int causal, float scale, cudaStream_t stream) {
  const DkvXlPlan p(dh);
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, dh, DkvXlCfg::BQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, dh, kDkvWideBK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, dh, kDkvWideBK)) != cudaSuccess) return e;
  if ((e = encode_map(&mdo, dout, bh, s, dh, DkvXlCfg::BQ)) != cudaSuccess) return e;
  return by_width<DkvXlPlan::kMinWidth, DkvXlPlan::kMaxWidth>(p.width, [&](auto w) {
    return launch_dkv_xl_w<decltype(w)::value>(p, mq, mk, mv, mdo, lse, delta, dk, dv, bh, s, dh,
                                               causal, scale, stream);
  });
}

}  // namespace sm90

}  // namespace flash

// q, k, v, dout, dk, dv: [bh, s, dh] (float32, or bfloat16 when is_bf16);
// lse, delta: float32 [bh, s]. dh is 64, 128, 192, 256, 320, 384, 448 or
// 512 in both dtypes (the kernels built for them), or any other multiple
// of 8 past 256 (the kernels that take the head dim at run time).
// Launches on `stream` and returns the launch's CUDA error code.
extern "C" int dmlc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int bh,
                                  int s, int dh, int causal, float scale, int is_bf16,
                                  void* stream) {
  using namespace flash;
  if (bh <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16 && dh == 128)
    return (int)sm90::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (is_bf16 && dh == 64)
    return (int)sm90::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (is_bf16 && dh == 192)
    return (int)sm90::launch_dkv<192>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (is_bf16 && dh == 256)
    return (int)sm90::launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (is_bf16 && dh == 320)
    return (int)sm90::launch_dkv_wide<320>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale,
                                           st);
  if (is_bf16 && dh == 384)
    return (int)sm90::launch_dkv_wide<384>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale,
                                           st);
  if (is_bf16 && dh == 448)
    return (int)sm90::launch_dkv_wide<448>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale,
                                           st);
  if (is_bf16 && dh == 512)
    return (int)sm90::launch_dkv_wide<512>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale,
                                           st);
  if (!is_bf16 && dh == 128)
    return (int)f32::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 64)
    return (int)f32::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 192)
    return (int)f32::launch_dkv<192>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 256)
    return (int)f32::launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 320)
    return (int)f32::launch_dkv<320>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 384)
    return (int)f32::launch_dkv<384>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 448)
    return (int)f32::launch_dkv<448>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 512)
    return (int)f32::launch_dkv<512>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh > 256 && dh % 8 == 0)
    return (int)f32::launch_dkv_xl(q, k, v, dout, lse, delta, dk, dv, bh, s, dh, causal, scale, st);
  if (is_bf16 && dh > 256 && dh % 8 == 0)
    return (int)sm90::launch_dkv_xl(q, k, v, dout, lse, delta, dk, dv, bh, s, dh, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the kernel for (dh, dtype) takes, in
// bytes; 0 for a pair that has no kernel.
extern "C" int dmlc_flash_bwd_dkv_smem_bytes(int dh, int is_bf16) {
  using namespace flash;
  if (dh == 128) return (int)(is_bf16 ? sm90::DkvCfg<128>::kSmem : f32::DkvCfg<128>::bytes);
  if (dh == 64) return (int)(is_bf16 ? sm90::DkvCfg<64>::kSmem : f32::DkvCfg<64>::bytes);
  if (dh == 192 && is_bf16) return (int)sm90::DkvCfg<192>::kSmem;
  if (dh == 256 && is_bf16) return (int)sm90::DkvCfg<256>::kSmem;
  if (dh == 320 && is_bf16) return (int)sm90::DkvWideCfg<320>::kSmem;
  if (dh == 384 && is_bf16) return (int)sm90::DkvWideCfg<384>::kSmem;
  if (dh == 448 && is_bf16) return (int)sm90::DkvWideCfg<448>::kSmem;
  if (dh == 512 && is_bf16) return (int)sm90::DkvWideCfg<512>::kSmem;
  if (dh == 192 && !is_bf16) return (int)f32::DkvCfg<192>::bytes;
  if (dh == 256 && !is_bf16) return (int)f32::DkvCfg<256>::bytes;
  if (dh == 320 && !is_bf16) return (int)f32::DkvCfg<320>::bytes;
  if (dh == 384 && !is_bf16) return (int)f32::DkvCfg<384>::bytes;
  if (dh == 448 && !is_bf16) return (int)f32::DkvCfg<448>::bytes;
  if (dh == 512 && !is_bf16) return (int)f32::DkvCfg<512>::bytes;
  if (!is_bf16 && dh > 256 && dh % 8 == 0) return (int)f32::DkvXlPlan(dh).bytes();
  if (is_bf16 && dh > 256 && dh % 8 == 0) return (int)sm90::DkvXlPlan(dh).bytes();
  return 0;
}

// The instantiation (its template argument W: the widest chunk's 64-column
// boxes in bf16, the widest part's steps in float32) that the kernel past
// 256 runs head dim dh with; 0 where a kernel built for dh runs it, or
// none.
extern "C" int dmlc_flash_bwd_dkv_xl_width(int dh, int is_bf16) {
  using namespace flash;
  if (dh <= 256 || dh % 8 != 0 || (dh <= 512 && dh % 64 == 0)) return 0;
  return is_bf16 ? sm90::DkvXlPlan(dh).width : f32::DkvXlPlan(dh).width;
}
