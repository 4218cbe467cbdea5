// flash_fwd: blockwise (flash) attention forward, out and per-row lse.
//
// Replaces both TPU forwards of dmlc_tpu/ops/pallas_kernels.py: the
// K/V-resident _flash_kernel (pallas_call at :499) and the K/V-streamed
// _flash_fwd_stream_kernel (:515), public flash_attention. On the TPU the
// resident kernel holds a head's whole K/V in VMEM while it fits (4 MiB)
// and the streamed one walks a sequential grid axis over K/V blocks. A
// Hopper block has 227 KB of shared memory, less than one head's K/V at
// S=2048 bf16 Dh=128 (1 MB), so here every length streams K/V tiles
// through one loop inside the block, and one kernel serves both rows.
//
// Inputs q, k, v: [BH, S, DH] row-major, float32 or bfloat16, DH 64,
// 128, 192, 256, 320, 384, 448 or 512 (ops/flash.py zero-pads a smaller
// head dim up to 64 or 128, one up to 256 to 192 or 256, and one up to 512
// to the next multiple of 64), or any other multiple of 8 past 256, which
// the kernels past 512 below take at run time (ops/flash.py pads a head
// dim past 512 to the next multiple of 8). Outputs out
// (q's dtype) and lse (float32 [BH, S]): out = softmax(scale q k^T) v with
// keys past the query masked when causal, lse = m + log(max(l, 1e-30)). A
// row with no visible key gets out 0 and lse -inf (pallas_kernels.py:210).
//
// What bounds it on the H100: operations. Causal, it does 2 products of
// half the [S, S] scores each, 2 * 2 * BH * S^2 * DH / 2 FLOPs; at the LM
// train shape (BH 48, S 2048, DH 128) 51.5 GFLOP, 52 us at the 989 TFLOP/s
// bf16 dense peak (H100 SXM data sheet), 0.77 ms at the 67 TFLOP/s float32
// peak. Its bytes (q, k, v read once, out and lse written once, 101 MB in
// bf16) take 30 us at 3.35 TB/s.
//
// bf16, the Hopper design (flash_sm90.cuh): one block per (BH, 128-row Q
// tile), 384 threads. Two consumer warpgroups own 64 query rows each; one
// producer warpgroup gives its registers to them (setmaxnreg) and one of
// its threads issues every copy. TMA loads the Q tile once and streams
// 128-row K and V tiles through a 2-stage ring (full and empty mbarriers
// per stage; 160 KB of shared memory at Dh 128, 80 KB at 64), so the next
// tile loads while this one is multiplied. S = Q K^T is wgmma m64n128k16 from shared memory with
// the float32 scores in registers; the online softmax runs on them (row
// max and sum over the 4 threads of a row, scale * log2(e) folded into
// exp2); P is rounded to bf16 in registers and is the register A operand
// of O += P V (V MN-major, the transpose bit set; m64n128k16 at Dh 128,
// m64n64k16 at 64); O stays in registers ([64, Dh] float32, Dh / 2 a
// thread), rescaled there. At Dh 64, S = Q K^T takes 4 k-steps, not 8. Masks run only on the
// tiles that cross the diagonal or the end of S. Causal blocks stop at the
// diagonal; the longest Q tiles of every head launch first. The epilogue
// stages O / l as bf16 through shared memory into 16-byte stores.
//
// bf16 at Dh 192 and 256 (FwdCfg): the same kernel with 64-key K/V tiles
// at 256 and 96-key ones at 192, since a 128-row Q tile and two stages of
// 128-key K and V tiles take 64 KB + 256 KB at Dh 256, past the 227 KB a
// block can use; the tiles take 192 KB at both. S = Q K^T is m64n64k16 at
// 256 and m64n96k16 at 192 (Dh / 16 k-steps); O ([64, Dh] float32, Dh / 2 a consumer thread: 128 registers
// at 256, beside S's 32, under the consumers' 240) is two wgmma
// accumulators (OutAcc in flash_sm90.cuh): columns [0, 128) on m64n128k16
// and [128, Dh) on m64n64k16 at 192 or m64n128k16 at 256. Its bound at
// [8, 3, 2048, 256] (the LM train shape's FLOPs as 3 heads of 256):
// operations, 52 us.
//
// float32, the FMA design (flash::f32 below): Hopper has no full-float32
// tensor-core product, so the products are register-tiled FMA on the CUDA
// cores, in full float32 (no TF32), bound by the 67 TFLOP/s float32 peak
// (0.77 ms at the train shape). One block of 128 threads per (BH, 64-row Q
// tile), two blocks an SM. The threads form 8 row groups of 16 (a
// half-warp each); group g owns query rows g + 8 i (i < 8), so the two
// half-warps of a warp read neighbouring rows. Q stays in shared memory; 32-key K and V tiles stream
// through a 2-stage cp.async ring, so the next tile loads while this one is
// multiplied. Per tile a thread computes S for its 8 rows x 2 keys (keys c,
// c + 16) and keeps it in registers: Q and K rows are read along Dh as
// float4, Q's broadcast across the half-warp. The online softmax runs on
// those registers, the row max and sum over the half-warp by
// __shfl_xor_sync; P goes to shared memory once, as the A operand of O +=
// P V, and O ([8 rows, Dh / 16 columns] a thread, columns 64 h + 4 c) stays
// in registers for the whole loop. The two products' steps (dot4, pv4) live
// in flash_common.cuh; the float32 dq runs the same ones. Masks run only on
// the tiles that cross the diagonal or the end of S. Shared memory at Dh 128: Q 33 KB, the ring
// 66 KB, P 9 KB. Against 128-row tiles (256 threads, one block an SM) the
// 64-row ones ran 6% faster, and the ring 3% faster than loading each
// tile before multiplying it (PERF.md, section 6; tools/flash_levers.py).
//
// float32 at Dh 192 and 256 (FwdCfg): the same design. At Dh 256 the Q
// tile and the ring take 195 KB, so a block of 128 threads would be the
// SM's only one (4 warps), and O 128 floats a thread. So two parts of 128
// threads share the block's Q and K/V tiles (256 threads, 213 KB): each
// owns half of O's columns (64 floats a thread, as at Dh 128) and makes
// S's dot product over its half; the parts add their partial S through
// shared memory and both run the same softmax. Warp w of each part holds
// the same rows, so each such pair of warps waits only for the other
// (a named barrier of 64 threads), 3.5% faster than a block barrier. Dh
// 192 does not halve into whole float4 columns of 16 threads; there one
// part keeps O's 96 floats a thread and K/V tiles take one stage (107 KB,
// two blocks an SM), 13% faster than two stages. At Dh 256 one part ran
// 3-23% slower, one stage 5.5%, and at both head dims 16-key tiles 28-33%
// and 32-row Q tiles 25-27% (PERF.md, section 6; tools/flash_levers.py
// group wide_f32). Its bound at [8, 3, 2048, 256]: operations, 0.77 ms at
// the float32 peak.
//
// bf16 past Dh 256 (320, 384, 448, 512; FwdWideCfg, flash_fwd_wide_kernel_sm90):
// the design above does not fit: a [128, 512] Q tile is 128 KB and a
// 64-key K or V tile 64 KB, and O over all of Dh would be 256 floats a
// thread. So a block holds 64 query rows, which both consumer warpgroups
// share, and 32-key K/V tiles in a 2-stage TMA ring (64 KB + 128 KB at
// 512). Warpgroup 0 owns O's first whole 64-column boxes (192 of 320, 256
// of 448), warpgroup 1 the rest: at most 256 columns, 128 floats a thread,
// OutAcc. S = Q K^T (m64n32k16) is split over Dh's k16 steps: each
// warpgroup makes its half, writes it to shared memory (8 KB, double-
// buffered by tile parity), waits on one named barrier of both
// warpgroups, and adds the other's; a + b == b + a, so both hold the same
// S, softmax and P (bf16, the register A operand of O += P V over the
// warpgroup's V boxes). The epilogue stages each warpgroup's columns of O
// / l through the Q tile after both are done reading it. Its bound at [4,
// 4, 1024, 512]: operations, 17 us.
//
// float32 past Dh 256 (f32::FwdCfg<DH, true>): the FMA design with two
// parts, split as the bf16 one is: part 0 owns O's first whole 64-column
// steps, part 1 the rest, and each makes S's dot product over half of Dh
// and adds the other's partial S. A padded row takes 2 KB at 512, so Q
// keeps 64 rows up to 384 and 32 past it (4 a row group), and K/V tiles
// one stage (184-217 KB). Its bound at [4, 4, 1024, 512]: operations,
// 0.26 ms at the float32 peak.
//
// Past Dh 512 (sm90::FwdXlCfg, f32::FwdXlCfg): the head dim is a run-time
// argument, and shared memory no longer grows with it. A bf16 warpgroup
// holds at most 256 columns of O in registers (4 boxes), and a 64-row Q
// tile is 80 KB at 640 and 128 KB at 1024. So O is cut into column chunks,
// one a block (a grid axis, as csrc/flash_wide.cu cuts it), as evenly as
// whole 64-column boxes allow: at most 8 boxes in bf16 (640 -> 320 + 320,
// 1024 -> 512 + 512; each warpgroup holds W or W - 1 boxes, W a template
// argument picked at launch) and 12 in float32 (two parts of at most 384
// columns: 640 and 768 in one chunk). Each chunk's block recomputes S =
// Q K^T over all of Dh: at 640 bf16 does 1.5x the forward's product
// FLOPs, 2 chunks x S + O once. Every chunk's block must then make
// bit-identical m and l, so that O's columns agree: S's dot product is
// split between the two warpgroups (parts) over Dh's 64-column slabs in
// the same way in every chunk (the first ceil(nb / 2) slabs to warpgroup
// 0), each adds the other's partial through shared memory (a + b == b +
// a), and the block of chunk 0 writes lse. K streams in 64-column slabs
// (a [32, 64] box; bf16 through a TMA ring of 4 slots a warpgroup, float32
// through a 2-slot cp.async ring with rows padded by 16 bytes), and V
// brings only the chunk's boxes. In bf16 Q streams beside each K slab at
// every width (an L2 reload of 64 rows a K/V tile, which read the same as
// keeping Q resident); in float32 Q stays resident up to Dh 704 and past
// that streams the same way (32 rows a K/V tile; streaming it at 576 and
// 640 cost 7-8%, PERF.md section 6). A last box or slab that is partly past Dh
// reads zeros (the TMA maps' zero fill; cp.async's zero fill), which is
// exact, and columns past Dh are not stored. float32 stays full FMA (no
// TF32), 32-row tiles. Bounds at [4, 4, 1024, 640]: bf16 its bytes, 25 us
// at 3.35 TB/s (the operations take 22 us at 989 TFLOP/s); float32
// operations, 0.32 ms at the float32 peak. At 320, 384, 448 and 512 the
// kernels built for the head dim stay: these ran 39-44% (bf16) and 14-48%
// (float32) slower there (PERF.md section 6).

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {

namespace f32 {

constexpr int kFwdRows = 64;          // query rows a block
constexpr int kFwdRowsPerThread = 8;  // rows a row group (16 threads) owns
constexpr int kFwdKeys = 32;          // keys a K/V tile
constexpr int kFwdStages = 2;         // K/V ring depth

// The float32 forward's tiles at head dim DH. A block's threads form
// kParts parts of 16 * BQ / RPT threads; part 0 owns O's columns [0, W0),
// part 1 [W0, W0 + W1), and each computes S's dot product over WS columns
// of Dh; with two parts each adds the other's partial S through shared
// memory. Up to Dh 192 one part (128 threads). Dh 192 keeps one stage of
// K/V tiles (107 KB of shared memory, two blocks an SM); Dh 256 takes two
// parts (256 threads, 213 KB) and the 2-stage ring.
template <int DH, bool kWide = (DH > 256)>
struct FwdCfg {
  static constexpr int kParts = DH == 256 ? 2 : 1;
  static constexpr int kStages = DH == 192 ? 1 : kFwdStages;
  static constexpr int BQ = kFwdRows, BK = kFwdKeys, RPT = kFwdRowsPerThread;
  static constexpr int G = BQ / RPT;                       // row groups a part
  static constexpr int kPartThreads = 16 * G, kThreads = kParts * kPartThreads;
  static constexpr int W0 = DH / kParts, W1 = W0;  // O's columns part 0 and part 1 own
  static constexpr int WS = W0;  // S's columns a part makes the dot product over
  static constexpr int LD = DH + 4;      // Q, K, V rows (floats), padded by 16 bytes
  static constexpr int LDP = BK + 4;     // P rows
  static constexpr int NKT = BK / 16;    // keys a thread owns in S
  // Q, the K/V ring, and a [BQ, LDP] P tile a part.
  static constexpr size_t bytes = sizeof(float) * ((size_t)BQ * LD + 2 * kStages * (size_t)BK * LD +
                                                   kParts * (size_t)BQ * LDP);
};

// Past Dh 256 (320, 384, 448, 512): a padded row takes 4 (DH + 4) bytes,
// 2 KB at 512, so Q keeps 64 rows up to 384 and 32 (4 a row group) past
// it, and K/V tiles one stage (207-217 KB at 384 and 512). Two parts: part
// 0 owns O's first W0 columns (whole 64-column steps, the larger half at
// 320 and 448), part 1 the rest; each makes S's dot product over half of
// Dh (WS columns, kSplitS) and adds the other's partial S, as at 256.
template <int DH>
struct FwdCfg<DH, true> {
  static constexpr int kParts = 2, kStages = 1;
  static constexpr bool kSplitS = true;  // S over half of Dh a part
  static constexpr int BQ = DH <= 384 ? kFwdRows : 32, BK = kFwdKeys, RPT = BQ / 8;
  static constexpr int G = BQ / RPT;
  static constexpr int kPartThreads = 16 * G, kThreads = kParts * kPartThreads;
  static constexpr int W0 = 64 * ((DH / 64 + 1) / 2), W1 = DH - W0;
  static constexpr int WS = kSplitS ? DH / 2 : DH;
  static constexpr int LD = DH + 4, LDP = BK + 4, NKT = BK / 16;
  static constexpr size_t bytes = sizeof(float) * ((size_t)BQ * LD + 2 * kStages * (size_t)BK * LD +
                                                   kParts * (size_t)BQ * LDP);
};

// K/V tiles that the Q tile at q0 reads: up to its diagonal when causal.
template <int DH>
__device__ __forceinline__ int fwd_tiles(int q0, int S, int causal) {
  typedef FwdCfg<DH> C;
  return ((causal ? min(q0 + C::BQ, S) : S) + C::BK - 1) / C::BK;
}

// One part's loop and epilogue: O's 64 NC4 columns from col0 (NC4 float4
// columns a thread), S's dot product over columns [s0, s0 + WS).
template <int DH, int NC4>
__device__ __forceinline__ void fwd_part(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v, float* __restrict__ out,
                                         float* __restrict__ lse, float* Qs, float* KVs, float* Ps,
                                         int bh, int S, int q0, int causal, float scale, int part,
                                         int col0, int s0) {
  typedef FwdCfg<DH> C;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDP = C::LDP, G = C::G, RPT = C::RPT;
  constexpr int NKT = C::NKT, STAGES = C::kStages;
  const size_t base = (size_t)bh * S * DH;
  const int tp = C::kParts == 1 ? threadIdx.x : threadIdx.x % C::kPartThreads;
  const int g = tp / 16, c = tp % 16;
  // Part p writes its partial S to tile p and reads the other part's from
  // tile 1 - p, where its P then goes (read back only by the half-warp
  // that wrote it); one part writes P to its only tile.
  float* Sp = Ps + part * BQ * LDP;
  float* Pp = Ps + (C::WS == DH ? part : C::kParts - 1 - part) * BQ * LDP;
  const int n_k = fwd_tiles<DH>(q0, S, causal);

  auto load_kv = [&](int j, int stage) {
    float* Kt = KVs + stage * 2 * BK * LD;
    cp_tile<BK, DH, LD, C::kThreads>(Kt, k + base, j * BK, S);
    cp_tile<BK, DH, LD, C::kThreads>(Kt + BK * LD, v + base, j * BK, S);
  };
  cp_tile<BQ, DH, LD, C::kThreads>(Qs, q + base, q0, S);
  load_kv(0, 0);
  cp_async_commit();

  float o[RPT][NC4][4], m[RPT], l[RPT];  // l: this thread's keys' part of the row sum
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int h = 0; h < NC4; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][h][e] = 0.f;
  }

  for (int j = 0; j < n_k; ++j) {
    if (STAGES == 2 && j + 1 < n_k) load_kv(j + 1, (j + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile j (and Q) in shared memory for every thread
    const float* Kt = KVs + (j % STAGES) * 2 * BK * LD;
    const float* Vt = Kt + BK * LD;
    const int k0 = j * BK;

    // S = Q K^T for rows g + G i and keys c + 16 u, over this part's columns
    // of Dh.
    float s[RPT][NKT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) s[i][u] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < C::WS; kk += 4)
      dot4<RPT, NKT, G, LD>(s, Qs + s0 + kk, Kt + s0 + kk, g, c);
    static_assert(C::kParts == 1 || C::kParts == 2, "one part or two");
    if constexpr (C::WS != DH) {
      // The two parts' dot products: S is their sum (the same in both).
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < NKT; ++u) Sp[(g + G * i) * LDP + c + 16 * u] = s[i][u];
      // Warp w of each part holds the same rows: the pair waits for each other only.
      pair_sync(1 + tp / 32);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < NKT; ++u) s[i][u] += Pp[(g + G * i) * LDP + c + 16 * u];
    }

    // Online softmax: fold this tile into (m, l), rescale O, P to shared.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = g + G * i, qi = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        float x = s[i][u] * scale;
        if (edge) {
          const int kj = k0 + c + 16 * u;
          if (kj >= S || (causal && kj > qi)) x = -INFINITY;
        }
        s[i][u] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], half_warp_max(mx));
      // A row with nothing visible so far keeps m = -inf: subtract 0 there.
      const float b0 = mn == -INFINITY ? 0.f : mn;
      const float corr = expf(m[i] - b0);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        const float p = expf(s[i][u] - b0);
        Pp[row * LDP + c + 16 * u] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int h = 0; h < NC4; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][h][e] *= corr;
    }
    __syncwarp();  // a row group's P rows are written and read by its own half-warp

    // O += P V: P rows along the keys as float4, V rows at columns col0 + 64 h + 4 c.
#pragma unroll 2
    for (int jj = 0; jj < BK; jj += 4)
      pv4<RPT, NC4, G, LDP, LD>(o, Pp + jj, Vt + jj * LD + col0, g, c);
    __syncthreads();  // every reader of this stage and of P is done
    if (STAGES == 1 && j + 1 < n_k) load_kv(j + 1, 0);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float lt = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int qi = q0 + g + G * i;
    if (qi < S) {
#pragma unroll
      for (int h = 0; h < NC4; ++h)
        *reinterpret_cast<float4*>(out + base + (size_t)qi * DH + col0 + 64 * h + 4 * c) =
            make_float4(o[i][h][0] / lt, o[i][h][1] / lt, o[i][h][2] / lt, o[i][h][3] / lt);
      if (c == 0 && part == 0) lse[(size_t)bh * S + qi] = m[i] + logf(lt);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(FwdCfg<DH>::kThreads, DH == 64 ? 2 : 1)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int BH, int S, int causal, float scale) {
  typedef FwdCfg<DH> C;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* KVs = Qs + C::BQ * C::LD;  // stage s: K at KVs + 2 s BK LD, V BK LD after it
  float* Ps = KVs + 2 * C::kStages * C::BK * C::LD;  // kParts tiles of BQ LDP

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + C::BQ - 1) / C::BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * C::BQ;
  const int part = C::kParts == 1 ? 0 : threadIdx.x / C::kPartThreads;
  const int s0 = C::WS == DH ? 0 : part * C::WS;
  if constexpr (C::W0 == C::W1) {
    fwd_part<DH, C::W0 / 64>(q, k, v, out, lse, Qs, KVs, Ps, bh, S, q0, causal, scale, part,
                             part * C::W0, s0);
  } else if (part == 0) {
    fwd_part<DH, C::W0 / 64>(q, k, v, out, lse, Qs, KVs, Ps, bh, S, q0, causal, scale, 0, 0, s0);
  } else {
    fwd_part<DH, C::W1 / 64>(q, k, v, out, lse, Qs, KVs, Ps, bh, S, q0, causal, scale, 1, C::W0,
                             s0);
  }
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                       int s, int causal, float scale, cudaStream_t stream) {
  typedef FwdCfg<DH> C;
  cudaError_t e = allow_smem(flash_fwd_f32_kernel<DH>, C::bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + C::BQ - 1) / C::BQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_f32_kernel<DH><<<(unsigned)blocks, C::kThreads, C::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), bh, s, causal, scale);
  return cudaGetLastError();
}

// The float32 forward at any other head dim past 256 (every multiple of 8
// past 512 on the public route; flash_fwd_xl_f32_kernel). Tiles of 32
// query rows and 32 keys; two parts of 128 threads, 8 row groups of 4 rows
// each. Part 0 makes S over Dh's first nd0 64-column slabs, part 1 over the
// rest, and each adds the other's partial S. O is cut into column chunks,
// one a block, of at most 2 kMaxSteps 64-column steps; part 0 owns the
// larger half of a chunk's steps, part 1 the rest.
struct FwdXlCfg {
  static constexpr int BQ = 32, BK = 32, RPT = 4;  // query rows, keys, rows a row group
  static constexpr int G = BQ / RPT, kPartThreads = 16 * G, kThreads = 2 * kPartThreads;
  static constexpr int kMaxSteps = 6;         // 64-column steps of O a part holds
  static constexpr int kRing = 2;             // slab ring depth
  static constexpr int kQResidentSteps = 11;  // Q stays in shared memory up to Dh 704
  static constexpr int LDS = 64 + 4;          // a slab's rows (floats), padded by 16 bytes
  static constexpr int LDP = BK + 4, NKT = BK / 16;
};

// What a head dim gives the float32 forward past 256: nb 64-column slabs
// of Dh (the last one zero past it), the chunks of O, the steps of the
// widest part, whether Q stays resident, and the block's shared memory.
struct XlPlan {
  int nb, chunks, width;
  bool q_res;
  int ldq, ldv;  // row strides (floats) of the resident Q tile and of the V tile
  __host__ __device__ explicit XlPlan(int dh)
      : nb((dh + 63) / 64),
        chunks((nb + 2 * FwdXlCfg::kMaxSteps - 1) / (2 * FwdXlCfg::kMaxSteps)),
        width(((nb + chunks - 1) / chunks + 1) / 2),
        q_res(nb <= FwdXlCfg::kQResidentSteps),
        ldq(64 * nb + 4),
        ldv(64 * ((nb + chunks - 1) / chunks) + 4) {}
  // A ring slot: both parts' K slabs, and their Q slabs when Q streams.
  __host__ __device__ int slot_floats() const {
    return (2 * FwdXlCfg::BK + (q_res ? 0 : 2 * FwdXlCfg::BQ)) * FwdXlCfg::LDS;
  }
  __host__ __device__ int q_floats() const { return q_res ? FwdXlCfg::BQ * ldq : 0; }
  // Q (resident), the V tile, the slab ring, and a [BQ, LDP] S/P tile a part.
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)q_floats() + (size_t)FwdXlCfg::BK * ldv +
                            (size_t)FwdXlCfg::kRing * slot_floats() +
                            2 * FwdXlCfg::BQ * FwdXlCfg::LDP);
  }
};

// K/V tiles that the 32-row Q tile at q0 reads: up to its diagonal when causal.
__device__ __forceinline__ int fwd_xl_tiles(int q0, int S, int causal) {
  const int end = causal ? min(q0 + FwdXlCfg::BQ, S) : S;  // one past the last key read
  return (end + FwdXlCfg::BK - 1) / FwdXlCfg::BK;
}

// Starts copying columns [c0, c0 + ncols) of rows [row0, row0 + rows) of a
// row-major float32 [S, dh] matrix into a shared tile of row stride ld, 16
// bytes a copy over the block; a row at or past S and a column at or past
// dh are zero.
__device__ __forceinline__ void cp_cols(float* __restrict__ sm, int ld, const float* __restrict__ g,
                                        int row0, int rows, int S, int dh, int c0, int ncols) {
  const int per_row = ncols / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += FwdXlCfg::kThreads) {
    const int r = i / per_row, cc = (i - r * per_row) * 4;
    const bool ok = row0 + r < S && c0 + cc < dh;
    cp_async16(sm + r * ld + cc, g + (ok ? (size_t)(row0 + r) * dh + c0 + cc : 0), ok);
  }
}

// One part of the float32 forward past 256: NC 64-column steps of O from
// the chunk's step c0 (the chunk's first column is 64 b0), S over slabs
// [part nd0, min(nb, (part + 1) nd0)).
template <int NC>
__device__ __forceinline__ void fwd_xl_part(const XlPlan& p, const float* __restrict__ q,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v, float* __restrict__ out,
                                            float* __restrict__ lse, float* Qs, float* Vs,
                                            float* ring, float* Ps, int bh, int S, int dh, int q0,
                                            int causal, float scale, int part, int chunk, int b0,
                                            int nbc, int c0) {
  typedef FwdXlCfg C;
  constexpr int BQ = C::BQ, BK = C::BK, RPT = C::RPT, G = C::G, LDS = C::LDS, LDP = C::LDP;
  constexpr int NKT = C::NKT;
  const size_t base = (size_t)bh * S * dh;
  const int tp = threadIdx.x % C::kPartThreads, g = tp / 16, c = tp % 16;
  const int nd0 = (p.nb + 1) / 2, slot = p.slot_floats();
  // Part p writes its partial S to tile p and reads the other's from tile
  // 1 - p, where its P then goes (read back only by the half-warp that
  // wrote it).
  float* Sp = Ps + part * BQ * LDP;
  float* Pp = Ps + (1 - part) * BQ * LDP;
  const int n_k = fwd_xl_tiles(q0, S, causal), n_loads = n_k * nd0;

  // Load l, step i = l % nd0 of K/V tile j = l / nd0: K slab i for part 0
  // and nd0 + i for part 1 (and Q's, when Q streams); step 1 also brings
  // tile j's V (the chunk's columns), after the last tile's O += P V.
  auto load = [&](int n) {
    const int j = n / nd0, i = n % nd0;
    float* dst = ring + (n % C::kRing) * slot;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = h * nd0 + i;
      if (d < p.nb) {
        cp_cols(dst + h * BK * LDS, LDS, k + base, j * BK, BK, S, dh, 64 * d, 64);
        if (!p.q_res)
          cp_cols(dst + (2 * BK + h * BQ) * LDS, LDS, q + base, q0, BQ, S, dh, 64 * d, 64);
      }
    }
    if (i == 1) cp_cols(Vs, p.ldv, v + base, j * BK, BK, S, dh, 64 * b0, 64 * nbc);
  };
  if (p.q_res) cp_cols(Qs, p.ldq, q + base, q0, BQ, S, dh, 0, 64 * p.nb);
  load(0);
  cp_async_commit();

  float o[RPT][NC][4], m[RPT], l[RPT];  // l: this thread's keys' part of the row sum
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int h = 0; h < NC; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][h][e] = 0.f;
  }

  int ld = 0;  // loads consumed
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK;
    float s[RPT][NKT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) s[i][u] = 0.f;
    for (int i = 0; i < nd0; ++i, ++ld) {
      if (ld + 1 < n_loads) load(ld + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // load ld (and Q, V when they came with it) in shared memory
      const int d = part * nd0 + i;
      if (d < p.nb) {
        const float* slab = ring + (ld % C::kRing) * slot;
        const float* kb = slab + part * BK * LDS;
        const float* qb = p.q_res ? Qs + 64 * d : slab + (2 * BK + part * BQ) * LDS;
        const int lda = p.q_res ? p.ldq : LDS;
#pragma unroll 4
        for (int kk = 0; kk < 64; kk += 4)
          dot4_lda<RPT, NKT, G, LDS>(s, qb + kk, lda, kb + kk, g, c);
      }
      __syncthreads();  // every reader of this slot is done before load ld + 2 lands in it
    }
    // S is the two parts' partial sums added (the same in both, and in
    // every chunk's block).
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) Sp[(g + G * i) * LDP + c + 16 * u] = s[i][u];
    pair_sync(1 + tp / 32);  // warp w of each part holds the same rows
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < NKT; ++u) s[i][u] = s[i][u] + Pp[(g + G * i) * LDP + c + 16 * u];

    // Online softmax: fold this tile into (m, l), rescale O, P to shared.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = g + G * i, qi = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        float x = s[i][u] * scale;
        if (edge) {
          const int kj = k0 + c + 16 * u;
          if (kj >= S || (causal && kj > qi)) x = -INFINITY;
        }
        s[i][u] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], half_warp_max(mx));
      // A row with nothing visible so far keeps m = -inf: subtract 0 there.
      const float b = mn == -INFINITY ? 0.f : mn;
      const float corr = expf(m[i] - b);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < NKT; ++u) {
        const float pr = expf(s[i][u] - b);
        Pp[row * LDP + c + 16 * u] = pr;
        sum += pr;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][h][e] *= corr;
    }
    __syncwarp();  // a row group's P rows are written and read by its own half-warp

    // O += P V: P rows along the keys as float4, V rows one key at a time
    // at columns 64 (c0 + h) + 4 c of the chunk.
    const float* Vc = Vs + 64 * c0 + 4 * c;
#pragma unroll 2
    for (int jj = 0; jj < BK; jj += 4) {
      float4 pa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pa[i] = ld4(Pp + (g + G * i) * LDP + jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 bv[NC];
#pragma unroll
        for (int h = 0; h < NC; ++h) bv[h] = ld4(Vc + (jj + e) * p.ldv + 64 * h);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float pe = e == 0 ? pa[i].x : e == 1 ? pa[i].y : e == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int h = 0; h < NC; ++h) {
            o[i][h][0] = fmaf(pe, bv[h].x, o[i][h][0]);
            o[i][h][1] = fmaf(pe, bv[h].y, o[i][h][1]);
            o[i][h][2] = fmaf(pe, bv[h].z, o[i][h][2]);
            o[i][h][3] = fmaf(pe, bv[h].w, o[i][h][3]);
          }
        }
      }
    }
    __syncthreads();  // every reader of V and of P is done
  }

  const bool writes_lse = chunk == 0 && part == 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float lt = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int qi = q0 + g + G * i;
    if (qi < S) {
#pragma unroll
      for (int h = 0; h < NC; ++h) {
        const int col = 64 * (b0 + c0 + h) + 4 * c;
        if (col < dh)
          *reinterpret_cast<float4*>(out + base + (size_t)qi * dh + col) =
              make_float4(o[i][h][0] / lt, o[i][h][1] / lt, o[i][h][2] / lt, o[i][h][3] / lt);
      }
      if (c == 0 && writes_lse) lse[(size_t)bh * S + qi] = m[i] + logf(lt);
    }
  }
}

// W: the steps of O the widest part of a launch holds; a part holds W or
// W - 1.
template <int W>
__global__ void __launch_bounds__(FwdXlCfg::kThreads, 1)
    flash_fwd_xl_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out,
                            float* __restrict__ lse, int BH, int S, int dh, int causal,
                            float scale) {
  typedef FwdXlCfg C;
  const XlPlan p(dh);
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Vs = Qs + p.q_floats();
  float* ring = Vs + C::BK * p.ldv;
  float* Ps = ring + C::kRing * p.slot_floats();

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
  if (steps == W)
    fwd_xl_part<W>(p, q, k, v, out, lse, Qs, Vs, ring, Ps, bh, S, dh, q0, causal, scale, part,
                   chunk, b0, nbc, c0);
  else
    fwd_xl_part<W - 1>(p, q, k, v, out, lse, Qs, Vs, ring, Ps, bh, S, dh, q0, causal, scale, part,
                       chunk, b0, nbc, c0);
}

template <int W>
cudaError_t launch_fwd_xl_w(const XlPlan& p, const void* q, const void* k, const void* v,
                            void* out, void* lse, int bh, int s, int dh, int causal, float scale,
                            cudaStream_t stream) {
  const size_t bytes = p.bytes();
  cudaError_t e = allow_smem(flash_fwd_xl_f32_kernel<W>, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + FwdXlCfg::BQ - 1) / FwdXlCfg::BQ) * bh * p.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_xl_f32_kernel<W><<<(unsigned)blocks, FwdXlCfg::kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), bh, s, dh, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_fwd_xl(const void* q, const void* k, const void* v, void* out, void* lse,
                          int bh, int s, int dh, int causal, float scale, cudaStream_t stream) {
  const XlPlan p(dh);
  switch (p.width) {
    case 3: return launch_fwd_xl_w<3>(p, q, k, v, out, lse, bh, s, dh, causal, scale, stream);
    case 4: return launch_fwd_xl_w<4>(p, q, k, v, out, lse, bh, s, dh, causal, scale, stream);
    case 5: return launch_fwd_xl_w<5>(p, q, k, v, out, lse, bh, s, dh, causal, scale, stream);
    case 6: return launch_fwd_xl_w<6>(p, q, k, v, out, lse, bh, s, dh, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32

namespace sm90 {

constexpr int kFwdBQ = 128;  // query rows a block: two consumer warpgroups of 64

// One K/V tile of the online softmax on a warpgroup's scores (the
// m64nNk16 accumulator, N / 2 floats a thread; the thread's rows qi0 and
// qi0 + 8, its keys from k0): the scores to log2 units, -inf where masked
// (which only `edge` tiles, crossing the diagonal or the end of S, need),
// each row's max m and this thread's part of its sum l folded in, and the
// scores turned into P. c0 and c1 are the factors O's rows rescale by.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float& m0, float& m1, float& l0,
                                             float& l1, float& c0, float& c1, bool edge, int k0,
                                             int qi0, int lane, int S, int causal,
                                             float scale_log2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = sc[i] * scale_log2;
    if (edge) {
      const int kj = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      const int qi = (i % 4) < 2 ? qi0 : qi0 + 8;
      if (kj >= S || (causal && kj > qi)) x = -INFINITY;
    }
    sc[i] = x;
    if ((i % 4) < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
  }
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  // A row with nothing visible so far keeps m = -inf: subtract 0 there.
  const float b0 = mn0 == -INFINITY ? 0.f : mn0, b1 = mn1 == -INFINITY ? 0.f : mn1;
  c0 = exp2f(m0 - b0);
  c1 = exp2f(m1 - b1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float p = exp2f(sc[i] - ((i % 4) < 2 ? b0 : b1));
    sc[i] = p;
    if ((i % 4) < 2) sum0 += p; else sum1 += p;
  }
  l0 = l0 * c0 + sum0;
  l1 = l1 * c1 + sum1;
}

// Each row's sum over the 4 threads that hold it, floored at 1e-30.
__device__ __forceinline__ void row_sums(float& l0, float& l1) {
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
}

// The bf16 forward's tiles at head dim DH: BK keys a K/V tile and a ring
// of kStages K/V tiles beside the [kFwdBQ, DH] Q tile. Up to Dh 128, 128
// keys and 2 stages (160 KB of shared memory at Dh 128). Past it 128-key
// tiles no longer fit beside the Q tile in 2 stages (64 KB + 2 x 128 KB at
// Dh 256, of the 227 KB a block can use), so K/V tiles take 64 keys at Dh
// 256 (192 KB) and 96 at 192 (192 KB; S on m64n96k16). At Dh 192 the
// 96-key tiles ran 2-3% faster than 64-key ones and 22% faster than
// 128-key ones in one stage; one stage ran 30-33% slower than two at both
// head dims (PERF.md, section 6; tools/flash_levers.py group wide).
template <int DH>
struct FwdCfg {
  static constexpr int BK = DH <= 128 ? 128 : DH == 192 ? 96 : 64;
  static constexpr int kStages = 2;
  static constexpr uint32_t kQ = kFwdBQ * DH * 2;  // the Q tile: 32 KB at Dh 128
  static constexpr uint32_t kKV = BK * DH * 2;     // a K or V tile: 32 KB at Dh 128
  static constexpr uint32_t kSmem =
      kQ + 2 * kStages * kKV + (1 + 3 * kStages) * 8 + 1024;  // Q, K and V rings, barriers, alignment
};

// K/V tiles that the Q tile at q0 reads: up to its diagonal when causal.
template <int DH>
__device__ __forceinline__ int fwd_kv_tiles(int q0, int S, int causal) {
  constexpr int kFwdBK = FwdCfg<DH>::BK;
  return ((causal ? min(q0 + kFwdBQ, S) : S) + kFwdBK - 1) / kFwdBK;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int BH, int S, int causal, float scale_log2) {
  typedef FwdCfg<DH> C;
  constexpr int kFwdBK = C::BK, kStages = C::kStages;
  static_assert(kStages == 1 || kStages == 2, "a ring of one or two stages");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + C::kQ;             // stage s at + s * C::kKV
  unsigned char* Vs = Ks + kStages * C::kKV;    // stage s at + s * C::kKV
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * C::kKV);
  uint64_t* bar_q = bars;
  uint64_t* full_k = bars + 1;            // [kStages]
  uint64_t* full_v = full_k + kStages;    // [kStages]
  uint64_t* empty = full_v + kStages;     // [kStages]

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + kFwdBQ - 1) / kFwdBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * kFwdBQ;
  const int n_k = fwd_kv_tiles<DH>(q0, S, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_expect(bar_q, C::kQ);
      tma_load_tile<DH>(Qs, &map_q, bar_q, kFwdBQ, q0, bh);
      for (int j = 0; j < n_k; ++j) {
        const int s = j & (kStages - 1);
        mbar_wait(&empty[s], ((j >> (kStages - 1)) & 1) ^ 1);
        mbar_expect(&full_k[s], C::kKV);
        tma_load_tile<DH>(Ks + s * C::kKV, &map_k, &full_k[s], kFwdBK, j * kFwdBK, bh);
        mbar_expect(&full_v[s], C::kKV);
        tma_load_tile<DH>(Vs + s * C::kKV, &map_v, &full_v[s], kFwdBK, j * kFwdBK, bh);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg + [0, 64).
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row_lo = 64 * wg + 16 * (t / 32) + lane / 4;  // and row_lo + 8
    const int qi0 = q0 + row_lo, qi1 = qi0 + 8;
    OutAcc<DH> o;
    o.zero();
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_k; ++j) {
      const int s = j & (kStages - 1), k0 = j * kFwdBK;
      const uint32_t ph = (j >> (kStages - 1)) & 1;
      unsigned char* Kt = Ks + s * C::kKV;
      unsigned char* Vt = Vs + s * C::kKV;
      mbar_wait(&full_k[s], ph);
      float sc[kFwdBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t aq = (kk / 4) * (kFwdBQ * 128) + (kk % 4) * 32;
        const uint32_t ak = (kk / 4) * (kFwdBK * 128) + (kk % 4) * 32;
        wgmma_ss(sc, desc(Qs + aq + 64 * wg * 128, 16, 1024), desc(Kt + ak, 16, 1024), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      const bool edge = k0 + kFwdBK > S || (causal && k0 + kFwdBK - 1 > q0 + 64 * wg);
      float c0, c1;
      softmax_tile(sc, m0, m1, l0, l1, c0, c1, edge, k0, qi0, lane, S, causal, scale_log2);
      o.scale(c0, c1);
      uint32_t pa[kFwdBK / 16][4];
      to_a_operand(sc, pa);

      mbar_wait(&full_v[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdBK / 16; ++kk) o.mma(pa[kk], Vt + kk * 16 * 128, kFwdBK * 128);
      wgmma_commit();
      wgmma_wait<0>();
      o.fence();
      mbar_arrive(&empty[s]);
    }

    row_sums(l0, l1);
    if (lane % 4 == 0) {
      if (qi0 < S) lse[(size_t)bh * S + qi0] = m0 * kLn2 + logf(l0);
      if (qi1 < S) lse[(size_t)bh * S + qi1] = m1 * kLn2 + logf(l1);
    }
    // This warpgroup's Q rows are read by no one now: stage O / l there.
    o.store(1.f / l0, 1.f / l1, Qs, kFwdBQ, 64 * wg, out + (size_t)bh * S * DH, q0 + 64 * wg, S,
            1 + wg);
  }
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                       int s, int causal, float scale, cudaStream_t stream) {
  typedef FwdCfg<DH> C;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, DH, kFwdBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = allow_smem(flash_fwd_kernel_sm90<DH>, C::kSmem)) != cudaSuccess) return e;
  const long long blocks = (long long)((s + kFwdBQ - 1) / kFwdBQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel_sm90<DH><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), bh, s, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

constexpr int kWideBQ = 64;  // query rows a block past Dh 256: both consumer warpgroups hold them all
constexpr int kBarS = 3;     // named barrier: both warpgroups' partial S written
constexpr int kBarO = 4;     // named barrier: every read of Q done (the epilogue stages O there)

// The bf16 forward past Dh 256 (320, 384, 448, 512). A [128, DH] Q tile
// is 128 KB at 512, a 64-key K or V tile 64 KB: no 227 KB block holds the
// design of Dh 256. So a block holds 64 query rows, which both consumer
// warpgroups share, and 32-key K/V tiles in kStages stages (Q 64 KB + the
// ring 128 KB at 512). Warpgroup 0 owns O's first kCols0 columns (whole
// 64-column boxes, the larger half at 320 and 448), warpgroup 1 the rest:
// at most 256 columns, 128 floats a thread, one or two wgmma accumulators
// (OutAcc). With kSplitS each warpgroup makes S = Q K^T over half of Dh's
// k16 steps and the two add each other's partial S through shared memory
// (double-buffered by tile parity, one named barrier a tile); both then
// hold the same S (a + b == b + a), the same softmax and the same P.
template <int DH>
struct FwdWideCfg {
  static constexpr int BK = 32;                 // keys a K/V tile
  static constexpr int kStages = 2;             // K/V ring depth
  static constexpr bool kSplitS = true;         // S over half of Dh a warpgroup
  static constexpr int kCols0 = 64 * ((DH / 64 + 1) / 2), kCols1 = DH - kCols0;
  static constexpr int kSteps = kSplitS ? DH / 32 : DH / 16;  // k16 steps of S a warpgroup makes
  static constexpr uint32_t kQ = kWideBQ * DH * 2;  // the Q tile: 64 KB at Dh 512
  static constexpr uint32_t kKV = BK * DH * 2;      // a K or V tile: 32 KB at Dh 512
  static constexpr uint32_t kX = 128 * (BK / 2) * 4;  // one warpgroup's partial S (BK / 2 a thread)
  static constexpr uint32_t kSmem = kQ + 2 * kStages * kKV + (kSplitS ? 4 * kX : 0) +
                                    (1 + 3 * kStages) * 8 + 1024;
};

// K/V tiles that the 64-row Q tile at q0 reads: up to its diagonal when causal.
template <int DH>
__device__ __forceinline__ int fwd_wide_tiles(int q0, int S, int causal) {
  constexpr int BK = FwdWideCfg<DH>::BK;
  return ((causal ? min(q0 + kWideBQ, S) : S) + BK - 1) / BK;
}

// Consumer warpgroup wg (0 or 1) of the wide forward: O's columns [C0, C0 +
// C) of query rows q0 + [0, 64).
template <int DH, int C, int C0>
__device__ __forceinline__ void fwd_wide_consumer(unsigned char* Qs, unsigned char* Ks,
                                                  unsigned char* Vs, float* X, uint64_t* bars,
                                                  __nv_bfloat16* __restrict__ out,
                                                  float* __restrict__ lse, int bh, int S, int q0,
                                                  int causal, float scale_log2) {
  typedef FwdWideCfg<DH> Cfg;
  constexpr int BK = Cfg::BK, kStages = Cfg::kStages, wg = C0 == 0 ? 0 : 1;
  uint64_t* bar_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;
  const int n_k = fwd_wide_tiles<DH>(q0, S, causal);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row_lo = 16 * (t / 32) + lane / 4;  // and row_lo + 8
  const int qi0 = q0 + row_lo, qi1 = qi0 + 8;
  const int kk0 = Cfg::kSplitS ? wg * Cfg::kSteps : 0;  // this warpgroup's first k16 step of S
  OutAcc<C> o;
  o.zero();
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns
  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_k; ++j) {
    const int s = j & (kStages - 1), k0 = j * BK;
    const uint32_t ph = (j >> (kStages - 1)) & 1;
    unsigned char* Kt = Ks + s * Cfg::kKV;
    unsigned char* Vt = Vs + s * Cfg::kKV;
    mbar_wait(&full_k[s], ph);
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < Cfg::kSteps; ++i) {
      const int kk = kk0 + i;
      const uint32_t aq = (kk / 4) * (kWideBQ * 128) + (kk % 4) * 32;
      const uint32_t ak = (kk / 4) * (BK * 128) + (kk % 4) * 32;
      wgmma_ss(sc, desc(Qs + aq, 16, 1024), desc(Kt + ak, 16, 1024), i);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    if constexpr (Cfg::kSplitS) {
      // Thread t's partial S at float4 v * 128 + t of this warpgroup's
      // buffer; the twin thread of the other warpgroup holds the same rows
      // and keys and adds it.
      float4* mine = reinterpret_cast<float4*>(X) + ((j & 1) * 2 + wg) * (BK / 8) * 128;
      const float4* theirs = reinterpret_cast<const float4*>(X) +
                             ((j & 1) * 2 + 1 - wg) * (BK / 8) * 128;
#pragma unroll
      for (int v = 0; v < BK / 8; ++v)
        mine[v * 128 + t] = make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
      consumers_wait(kBarS);
#pragma unroll
      for (int v = 0; v < BK / 8; ++v) {
        const float4 x = theirs[v * 128 + t];
        sc[4 * v] += x.x, sc[4 * v + 1] += x.y, sc[4 * v + 2] += x.z, sc[4 * v + 3] += x.w;
      }
    }

    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
    float c0, c1;
    softmax_tile(sc, m0, m1, l0, l1, c0, c1, edge, k0, qi0, lane, S, causal, scale_log2);
    o.scale(c0, c1);
    uint32_t pa[BK / 16][4];
    to_a_operand(sc, pa);

    // O[:, C0 + [0, C)) += P V: V's boxes from C0 / 64 on.
    mbar_wait(&full_v[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      o.mma(pa[kk], Vt + (C0 / 64) * (BK * 128) + kk * 16 * 128, BK * 128);
    wgmma_commit();
    wgmma_wait<0>();
    o.fence();
    mbar_arrive(&empty[s]);
  }

  row_sums(l0, l1);
  if (wg == 0 && lane % 4 == 0) {
    if (qi0 < S) lse[(size_t)bh * S + qi0] = m0 * kLn2 + logf(l0);
    if (qi1 < S) lse[(size_t)bh * S + qi1] = m1 * kLn2 + logf(l1);
  }
  // Both warpgroups are done reading Q: each stages its columns of O / l
  // there and copies them out.
  consumers_wait(kBarO);
  o.stage(1.f / l0, 1.f / l1, Qs, kWideBQ, 0, C0);
  copy_rows<DH, C>(Qs, kWideBQ, 0, out + (size_t)bh * S * DH, q0, S, 1 + wg, C0);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int BH,
                               int S, int causal, float scale_log2) {
  typedef FwdWideCfg<DH> C;
  constexpr int kStages = C::kStages;
  static_assert(kStages == 1 || kStages == 2, "a ring of one or two stages");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + C::kQ;             // stage s at + s * C::kKV
  unsigned char* Vs = Ks + kStages * C::kKV;    // stage s at + s * C::kKV
  float* X = reinterpret_cast<float*>(Vs + kStages * C::kKV);  // [parity][warpgroup] partial S
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * C::kKV + (C::kSplitS ? 4 * C::kX : 0));
  uint64_t* bar_q = bars;
  uint64_t* full_k = bars + 1;            // [kStages]
  uint64_t* full_v = full_k + kStages;    // [kStages]
  uint64_t* empty = full_v + kStages;     // [kStages]

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + kWideBQ - 1) / kWideBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * kWideBQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      const int n_k = fwd_wide_tiles<DH>(q0, S, causal);
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_expect(bar_q, C::kQ);
      tma_load_tile<DH>(Qs, &map_q, bar_q, kWideBQ, q0, bh);
      for (int j = 0; j < n_k; ++j) {
        const int s = j & (kStages - 1);
        mbar_wait(&empty[s], ((j >> (kStages - 1)) & 1) ^ 1);
        mbar_expect(&full_k[s], C::kKV);
        tma_load_tile<DH>(Ks + s * C::kKV, &map_k, &full_k[s], C::BK, j * C::BK, bh);
        mbar_expect(&full_v[s], C::kKV);
        tma_load_tile<DH>(Vs + s * C::kKV, &map_v, &full_v[s], C::BK, j * C::BK, bh);
      }
    }
  } else if (wg == 0) {
    regs_alloc<240>();
    fwd_wide_consumer<DH, C::kCols0, 0>(Qs, Ks, Vs, X, bars, out, lse, bh, S, q0, causal,
                                        scale_log2);
  } else {
    regs_alloc<240>();
    fwd_wide_consumer<DH, C::kCols1, C::kCols0>(Qs, Ks, Vs, X, bars, out, lse, bh, S, q0, causal,
                                                 scale_log2);
  }
}

template <int DH>
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v, void* out, void* lse,
                            int bh, int s, int causal, float scale, cudaStream_t stream) {
  typedef FwdWideCfg<DH> C;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, DH, kWideBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, DH, C::BK)) != cudaSuccess) return e;
  if ((e = allow_smem(flash_fwd_wide_kernel_sm90<DH>, C::kSmem)) != cudaSuccess) return e;
  const long long blocks = (long long)((s + kWideBQ - 1) / kWideBQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_wide_kernel_sm90<DH><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), bh, s, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

// The bf16 forward at any other head dim past 256 (every multiple of 8
// past 512 on the public route; flash_fwd_xl_kernel_sm90). A block holds
// 64 query rows, which its two consumer warpgroups share, and one column
// chunk of O: at most 2 kMaxBoxes 64-column boxes, the first half (rounded
// up) to warpgroup 0 and the rest to warpgroup 1 (OutAcc of at most 64
// kMaxBoxes columns). S = Q K^T (m64n32k16) walks Dh in 64-column slabs,
// split between the warpgroups the same way; each slab of K streams with
// the same slab of Q through a ring of kSlots of the warpgroup's own, so Q
// comes again from L2 for every K/V tile (keeping it resident read the
// same, PERF.md section 6). Each warpgroup adds the other's partial S
// through shared memory (a + b == b + a), so both, in every chunk's block,
// hold the same S, softmax and P. V brings only the chunk's boxes,
// kVStages tiles in flight. The producer warpgroup gives its registers to
// the consumers (setmaxnreg, 240 a consumer thread).
struct FwdXlCfg {
  static constexpr int BK = 32, kMaxBoxes = 4;  // keys a K/V tile; boxes of O a warpgroup holds
  static constexpr int kSlots = 4;              // K and Q slabs in flight a warpgroup
  static constexpr int kVStages = 2;            // V tiles in flight
  static constexpr uint32_t kRowBox = kWideBQ * 128;    // [64 rows, 64 columns]: Q, staged O
  static constexpr uint32_t kKeyBox = BK * 128;         // [BK keys, 64 columns]: K, V
  static constexpr uint32_t kSlot = kKeyBox + kRowBox;  // a slab of K and the same of Q
  static constexpr uint32_t kPartialS = 128 * (BK / 2) * sizeof(float);  // one warpgroup's
};

// What a head dim gives the bf16 forward past 256: nb boxes of Dh (the
// last one zero-filled past it), the chunks of O, the boxes of the widest
// warpgroup, and where the shared memory goes: V's ring (also where O
// stages at the end), the two K/Q rings, both warpgroups' partial S by
// tile parity, the barriers.
struct XlPlan {
  int nb, chunks, width;
  __host__ __device__ explicit XlPlan(int dh)
      : nb((dh + 63) / 64),
        chunks((nb + 2 * FwdXlCfg::kMaxBoxes - 1) / (2 * FwdXlCfg::kMaxBoxes)),
        width(((nb + chunks - 1) / chunks + 1) / 2) {}
  __host__ __device__ uint32_t v_stage() const { return 2 * width * FwdXlCfg::kKeyBox; }
  __host__ __device__ uint32_t v_bytes() const {
    const uint32_t ring = FwdXlCfg::kVStages * v_stage(), staged = 2 * width * FwdXlCfg::kRowBox;
    return ring > staged ? ring : staged;
  }
  __host__ __device__ uint32_t bytes() const {
    return v_bytes() + 2 * FwdXlCfg::kSlots * FwdXlCfg::kSlot + 4 * FwdXlCfg::kPartialS +
           (4 * FwdXlCfg::kSlots + 2 * FwdXlCfg::kVStages) * 8 + 1024;
  }
};

// K/V tiles that the 64-row Q tile at q0 reads past 256: up to its diagonal when causal.
__device__ __forceinline__ int fwd_xl_tiles(int q0, int S, int causal) {
  const int end = causal ? min(q0 + kWideBQ, S) : S;  // one past the last key read
  return (end + FwdXlCfg::BK - 1) / FwdXlCfg::BK;
}

// Consumer warpgroup wg (0 or 1): O's NB boxes from box c0 of the chunk,
// whose first column is 64 b0, of query rows q0 + [0, 64); S over slabs
// [d0, d1). bars: each warpgroup's full and then each one's empty K/Q ring
// barriers, V's full and empty barriers.
template <int NB>
__device__ __forceinline__ void fwd_xl_consumer(const XlPlan& p, unsigned char* Vs,
                                                unsigned char* ring, float* X, uint64_t* bars,
                                                __nv_bfloat16* __restrict__ out,
                                                float* __restrict__ lse, int bh, int S, int dh,
                                                int q0, int causal, float scale_log2, int wg,
                                                int d0, int d1, int b0, int c0, bool writes_lse) {
  typedef FwdXlCfg C;
  constexpr int BK = C::BK, kSlots = C::kSlots, kVStages = C::kVStages;
  uint64_t* full = bars + wg * kSlots;
  uint64_t* empty = bars + (2 + wg) * kSlots;
  uint64_t* full_v = bars + 4 * kSlots;
  uint64_t* empty_v = full_v + kVStages;
  unsigned char* my_ring = ring + wg * kSlots * C::kSlot;
  const int n_k = fwd_xl_tiles(q0, S, causal);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int qi0 = q0 + 16 * (t / 32) + lane / 4, qi1 = qi0 + 8;
  OutAcc<64 * NB> o;
  o.zero();
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns
  uint32_t n = 0;  // slabs taken from this warpgroup's ring
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK;
    float sc[BK / 2];
    // This warpgroup's partial S, one slab at a time; a slab's slot goes
    // back to the producer once the slab's products are done.
    wgmma_fence();
    for (int d = d0; d < d1; ++d, ++n) {
      const uint32_t s = n % kSlots;
      mbar_wait(&full[s], (n / kSlots) & 1);
      const unsigned char* kb = my_ring + s * C::kSlot;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sc, desc(kb + C::kKeyBox + kk * 32, 16, 1024), desc(kb + kk * 32, 16, 1024),
                 d > d0 || kk > 0);
      wgmma_commit();
      if (d > d0) {
        wgmma_wait<1>();
        mbar_arrive(&empty[(n - 1) % kSlots]);
      }
    }
    wgmma_wait<0>();
    mbar_arrive(&empty[(n - 1) % kSlots]);
    reg_fence(sc);
    // Thread t's partial S at float4 v * 128 + t of this warpgroup's
    // buffer; the twin thread of the other warpgroup holds the same rows
    // and keys and adds it.
    float4* mine = reinterpret_cast<float4*>(X) + ((j & 1) * 2 + wg) * (BK / 8) * 128;
    const float4* other = reinterpret_cast<const float4*>(X) +
                          ((j & 1) * 2 + 1 - wg) * (BK / 8) * 128;
#pragma unroll
    for (int v = 0; v < BK / 8; ++v)
      mine[v * 128 + t] = make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
    consumers_wait(kBarS);
#pragma unroll
    for (int v = 0; v < BK / 8; ++v) {
      const float4 y = other[v * 128 + t];
      sc[4 * v] += y.x, sc[4 * v + 1] += y.y, sc[4 * v + 2] += y.z, sc[4 * v + 3] += y.w;
    }

    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
    float cr0, cr1;
    softmax_tile(sc, m0, m1, l0, l1, cr0, cr1, edge, k0, qi0, lane, S, causal, scale_log2);
    o.scale(cr0, cr1);
    uint32_t pa[BK / 16][4];
    to_a_operand(sc, pa);

    // O[:, this warpgroup's boxes] += P V.
    const int sv = j % kVStages;
    mbar_wait(&full_v[sv], (j / kVStages) & 1);
    const unsigned char* Vt = Vs + sv * p.v_stage() + c0 * C::kKeyBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) o.mma(pa[kk], Vt + kk * 16 * 128, C::kKeyBox);
    wgmma_commit();
    wgmma_wait<0>();
    o.fence();
    mbar_arrive(&empty_v[sv]);
  }

  row_sums(l0, l1);
  if (writes_lse && lane % 4 == 0) {
    if (qi0 < S) lse[(size_t)bh * S + qi0] = m0 * kLn2 + logf(l0);
    if (qi1 < S) lse[(size_t)bh * S + qi1] = m1 * kLn2 + logf(l1);
  }
  // Both warpgroups are done with V's ring: each stages its boxes of O / l
  // there (box i of the chunk at i * kRowBox) and copies the columns short
  // of dh out in 16-byte stores.
  consumers_wait(kBarO);
  o.stage(1.f / l0, 1.f / l1, Vs, kWideBQ, 0, 64 * c0);
  constexpr int kChunks = 8 * NB;  // 16-byte chunks of a row
  warpgroup_sync(5 + wg);
  __nv_bfloat16* g = out + (size_t)bh * S * dh;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int idx = t + 128 * i, row = idx / kChunks, col = 64 * c0 + (idx % kChunks) * 8;
    const int gcol = 64 * b0 + col;
    if (q0 + row < S && gcol < dh)
      *reinterpret_cast<uint4*>(g + (size_t)(q0 + row) * dh + gcol) =
          *reinterpret_cast<const uint4*>(Vs + tile_offset(row, col, kWideBQ));
  }
}

// W: the boxes of O the widest warpgroup of a launch holds; a warpgroup
// holds W or W - 1.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_xl_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int BH,
                             int S, int dh, int causal, float scale_log2) {
  typedef FwdXlCfg C;
  constexpr int kSlots = C::kSlots, kVStages = C::kVStages;
  const XlPlan p(dh);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Vs = smem;
  unsigned char* ring = Vs + p.v_bytes();  // warpgroup r's slot s at (r kSlots + s) kSlot
  float* X = reinterpret_cast<float*>(ring + 2 * kSlots * C::kSlot);  // [parity][wg] partial S
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(X) +
                                               4 * C::kPartialS);  // [wg][kSlots]
  uint64_t* empty = full + 2 * kSlots;       // [wg][kSlots]
  uint64_t* full_v = empty + 2 * kSlots;     // [kVStages]
  uint64_t* empty_v = full_v + kVStages;     // [kVStages]

  // Block order: chunks of one Q tile together, the last (longest, when
  // causal) Q tile of every head first.
  const int n_tiles = (S + kWideBQ - 1) / kWideBQ;
  const int chunk = blockIdx.x % p.chunks, rest = blockIdx.x / p.chunks;
  const int bh = rest % BH;
  const int q0 = (n_tiles - 1 - rest / BH) * kWideBQ;
  const int b0 = chunk * p.nb / p.chunks, nbc = (chunk + 1) * p.nb / p.chunks - b0;
  const int half = (p.nb + 1) / 2;  // S's slabs of warpgroup 0, [0, half); warpgroup 1's the rest
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], kConsumerThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the rings full, the two K/Q rings in turn.
    regs_dealloc<24>();
    if (threadIdx.x == kConsumerThreads) {
      const int n_k = fwd_xl_tiles(q0, S, causal);
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      uint32_t n[2] = {0, 0};  // slabs put in each warpgroup's ring
      for (int j = 0; j < n_k; ++j) {
        for (int i = 0; i < half; ++i) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int d = r * half + i;
            if (d >= p.nb) continue;
            const uint32_t s = r * kSlots + n[r] % kSlots;
            mbar_wait(&empty[s], ((n[r] / kSlots) & 1) ^ 1);
            ++n[r];
            mbar_expect(&full[s], C::kSlot);
            tma_load(ring + s * C::kSlot, &map_k, &full[s], 64 * d, j * C::BK, bh);
            tma_load(ring + s * C::kSlot + C::kKeyBox, &map_q, &full[s], 64 * d, q0, bh);
          }
        }
        const int sv = j % kVStages;
        mbar_wait(&empty_v[sv], ((j / kVStages) & 1) ^ 1);
        mbar_expect(&full_v[sv], nbc * C::kKeyBox);
        for (int i = 0; i < nbc; ++i)
          tma_load(Vs + sv * p.v_stage() + i * C::kKeyBox, &map_v, &full_v[sv], 64 * (b0 + i),
                   j * C::BK, bh);
      }
    }
  } else {
    regs_alloc<240>();
    const int c_half = (nbc + 1) / 2;  // O's boxes of warpgroup 0
    const int c0 = wg ? c_half : 0, boxes = wg ? nbc - c_half : c_half;
    const int d0 = wg ? half : 0, d1 = wg ? p.nb : half;
    const bool writes_lse = chunk == 0 && wg == 0;
    if (boxes == W)
      fwd_xl_consumer<W>(p, Vs, ring, X, full, out, lse, bh, S, dh, q0, causal, scale_log2, wg,
                         d0, d1, b0, c0, writes_lse);
    else
      fwd_xl_consumer<W - 1>(p, Vs, ring, X, full, out, lse, bh, S, dh, q0, causal, scale_log2,
                             wg, d0, d1, b0, c0, writes_lse);
  }
}

template <int W>
cudaError_t launch_fwd_xl_w(const XlPlan& p, const CUtensorMap& mq, const CUtensorMap& mk,
                            const CUtensorMap& mv, void* out, void* lse, int bh, int s, int dh,
                            int causal, float scale, cudaStream_t stream) {
  const uint32_t bytes = p.bytes();
  cudaError_t e = allow_smem(flash_fwd_xl_kernel_sm90<W>, bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + kWideBQ - 1) / kWideBQ) * bh * p.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_xl_kernel_sm90<W><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), bh, s, dh, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_fwd_xl(const void* q, const void* k, const void* v, void* out, void* lse,
                          int bh, int s, int dh, int causal, float scale, cudaStream_t stream) {
  const XlPlan p(dh);
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, dh, kWideBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, dh, FwdXlCfg::BK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, dh, FwdXlCfg::BK)) != cudaSuccess) return e;
  switch (p.width) {
    case 3: return launch_fwd_xl_w<3>(p, mq, mk, mv, out, lse, bh, s, dh, causal, scale, stream);
    case 4: return launch_fwd_xl_w<4>(p, mq, mk, mv, out, lse, bh, s, dh, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90

}  // namespace flash

// q, k, v, out: [bh, s, dh] (float32, or bfloat16 when is_bf16); lse:
// float32 [bh, s]. dh is 64, 128, 192, 256, 320, 384, 448 or 512 in both
// dtypes (the kernels built for them), or any other multiple of 8 past 256
// (the kernels past 256 that take the head dim at run time). Launches on
// `stream` and returns the launch's CUDA error code.
extern "C" int dmlc_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int bh, int s, int dh, int causal, float scale, int is_bf16,
                              void* stream) {
  using namespace flash;
  if (bh <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16 && dh == 128)
    return (int)sm90::launch_fwd<128>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (is_bf16 && dh == 64)
    return (int)sm90::launch_fwd<64>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (is_bf16 && dh == 192)
    return (int)sm90::launch_fwd<192>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (is_bf16 && dh == 256)
    return (int)sm90::launch_fwd<256>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 128)
    return (int)f32::launch_fwd<128>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 64)
    return (int)f32::launch_fwd<64>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 192)
    return (int)f32::launch_fwd<192>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 256)
    return (int)f32::launch_fwd<256>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (is_bf16 && dh == 320)
    return (int)sm90::launch_fwd_wide<320>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (is_bf16 && dh == 384)
    return (int)sm90::launch_fwd_wide<384>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (is_bf16 && dh == 448)
    return (int)sm90::launch_fwd_wide<448>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (is_bf16 && dh == 512)
    return (int)sm90::launch_fwd_wide<512>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 320)
    return (int)f32::launch_fwd<320>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 384)
    return (int)f32::launch_fwd<384>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 448)
    return (int)f32::launch_fwd<448>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 512)
    return (int)f32::launch_fwd<512>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (dh > 256 && dh % 8 == 0)
    return (int)(is_bf16 ? sm90::launch_fwd_xl(q, k, v, out, lse, bh, s, dh, causal, scale, st)
                         : f32::launch_fwd_xl(q, k, v, out, lse, bh, s, dh, causal, scale, st));
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the kernel for (dh, dtype) takes, in
// bytes; 0 for a pair that has no kernel.
extern "C" int dmlc_flash_fwd_smem_bytes(int dh, int is_bf16) {
  using namespace flash;
  if (dh == 128) return (int)(is_bf16 ? sm90::FwdCfg<128>::kSmem : f32::FwdCfg<128>::bytes);
  if (dh == 64) return (int)(is_bf16 ? sm90::FwdCfg<64>::kSmem : f32::FwdCfg<64>::bytes);
  if (dh == 192 && is_bf16) return (int)sm90::FwdCfg<192>::kSmem;
  if (dh == 256 && is_bf16) return (int)sm90::FwdCfg<256>::kSmem;
  if (dh == 192 && !is_bf16) return (int)f32::FwdCfg<192>::bytes;
  if (dh == 256 && !is_bf16) return (int)f32::FwdCfg<256>::bytes;
  if (dh == 320) return (int)(is_bf16 ? sm90::FwdWideCfg<320>::kSmem : f32::FwdCfg<320>::bytes);
  if (dh == 384) return (int)(is_bf16 ? sm90::FwdWideCfg<384>::kSmem : f32::FwdCfg<384>::bytes);
  if (dh == 448) return (int)(is_bf16 ? sm90::FwdWideCfg<448>::kSmem : f32::FwdCfg<448>::bytes);
  if (dh == 512) return (int)(is_bf16 ? sm90::FwdWideCfg<512>::kSmem : f32::FwdCfg<512>::bytes);
  if (dh > 256 && dh % 8 == 0)
    return (int)(is_bf16 ? sm90::XlPlan(dh).bytes() : f32::XlPlan(dh).bytes());
  return 0;
}

// The instantiation (its template argument W, the widest warpgroup's or
// part's 64-column boxes of O) that the kernel past 256 runs head dim dh
// with, in (dh, dtype); 0 where a kernel built for dh runs it, or none.
extern "C" int dmlc_flash_fwd_xl_width(int dh, int is_bf16) {
  using namespace flash;
  if (dh <= 256 || dh % 8 != 0 || (dh <= 512 && dh % 64 == 0)) return 0;
  return is_bf16 ? sm90::XlPlan(dh).width : f32::XlPlan(dh).width;
}
