// flash_bwd_dq: the query gradient of flash attention (FlashAttention-2).
//
// Replaces the TPU kernel dmlc_tpu/ops/pallas_kernels.py:_flash_bwd_dq_kernel
// (pallas_call at :559, via _flash_backward), the dQ half of
// flash_attention's custom VJP. There a sequential grid axis walks K blocks
// and carries dQ in VMEM scratch; here a loop inside the block does.
//
// Inputs q, k, v, dO: [BH, S, DH] row-major, float32 or bfloat16, DH 64
// or 128 (every head dim of the model registry); lse and
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
// (PERF.md, section 6; tools/flash_dq_levers.py).
//
// float32 keeps the first design: one block of 256 threads per (BH, 64-row
// Q tile), Q, dO, lse and delta in shared memory, K/V tiles of 64 rows
// streaming through, the scores, dP and the dQ accumulator in shared
// memory as float32, the products on FMA in full float32 (gemm()), no
// overlap of loads with products.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {

template <typename T, int DH>
struct DqCfg {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int LDT = Ld<T, DH>::value;
  static constexpr int LDS = BK + 4;
  static constexpr int LDP = Ld<T, BK>::value;
  static constexpr int LDO = DH + 4;
  static constexpr size_t bytes = 2 * round128(BQ * LDT * sizeof(T)) +     // Q, dO
                                  2 * round128(BK * LDT * sizeof(T)) +     // K, V
                                  2 * round128(BQ * LDS * sizeof(float)) + // scores, dP
                                  round128(BQ * LDP * sizeof(T)) +         // dS
                                  round128(BQ * LDO * sizeof(float)) +     // dQ
                                  2 * round128(BQ * sizeof(float));        // lse, delta
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int BH, int S,
                        int causal, float scale) {
  typedef DqCfg<T, DH> C;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* Qs = cur.take<T>(BQ * C::LDT);
  T* dOs = cur.take<T>(BQ * C::LDT);
  T* Ks = cur.take<T>(BK * C::LDT);
  T* Vs = cur.take<T>(BK * C::LDT);
  float* Ss = cur.take<float>(BQ * C::LDS);
  float* dPs = cur.take<float>(BQ * C::LDS);
  T* dSs = cur.take<T>(BQ * C::LDP);
  float* dQs = cur.take<float>(BQ * C::LDO);
  float* lse_s = cur.take<float>(BQ);
  float* delta_s = cur.take<float>(BQ);

  const int n_tiles = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * BQ;
  const size_t base = (size_t)bh * S * DH;
  const int tid = threadIdx.x;

  load_tile<T, BQ, DH, C::LDT>(Qs, q + base, q0, S);
  load_tile<T, BQ, DH, C::LDT>(dOs, dout + base, q0, S);
  load_rows<BQ>(lse_s, lse + (size_t)bh * S, q0, S);
  load_rows<BQ>(delta_s, delta + (size_t)bh * S, q0, S);
  for (int i = tid; i < BQ * C::LDO; i += kThreads) dQs[i] = 0.f;

  const int q_end = min(q0 + BQ, S);
  const int n_k = ((causal ? q_end : S) + BK - 1) / BK;
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<T, BK, DH, C::LDT>(Ks, k + base, k0, S);
    load_tile<T, BK, DH, C::LDT>(Vs, v + base, k0, S);
    __syncthreads();
    gemm<BQ, BK, DH, false, true, false>(Ss, C::LDS, Qs, C::LDT, Ks, C::LDT);
    gemm<BQ, BK, DH, false, true, false>(dPs, C::LDS, dOs, C::LDT, Vs, C::LDT);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i - r * BK;
      const int qi = q0 + r, kj = k0 + c;
      const bool visible = qi < S && kj < S && (!causal || kj <= qi);
      const float p = visible ? expf(Ss[r * C::LDS + c] * scale - lse_s[r]) : 0.f;
      dSs[r * C::LDP + c] = from_f32<T>(p * (dPs[r * C::LDS + c] - delta_s[r]));
    }
    __syncthreads();
    gemm<BQ, DH, BK, false, false, true>(dQs, C::LDO, dSs, C::LDP, Ks, C::LDT);
  }
  __syncthreads();
  for (int i = tid; i < BQ * DH; i += kThreads) {
    const int r = i / DH, c = i - r * DH;
    if (q0 + r < S) dq[base + (size_t)(q0 + r) * DH + c] = from_f32<T>(dQs[r * C::LDO + c] * scale);
  }
}

template <typename T, int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s, int causal,
                      float scale, cudaStream_t stream) {
  typedef DqCfg<T, DH> C;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, DH>, C::bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + C::BQ - 1) / C::BQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<T, DH><<<(unsigned)blocks, kThreads, C::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), bh, s, causal, scale);
  return cudaGetLastError();
}

namespace sm90 {

constexpr int kDqBQ = 128, kDqBK = 64;

template <int DH>
struct DqCfg {
  static constexpr uint32_t kQ = kDqBQ * DH * 2;   // the Q or the dO tile: 32 KB at Dh 128
  static constexpr uint32_t kKV = kDqBK * DH * 2;  // a K or V tile: 16 KB at Dh 128
  // Q, dO, K[2], V[2], barriers, alignment.
  static constexpr uint32_t kSmem = 2 * kQ + 4 * kKV + 7 * 8 + 1024;
};

// K/V tiles that the Q tile at q0 reads: up to its diagonal when causal.
__device__ __forceinline__ int dq_kv_tiles(int q0, int S, int causal) {
  return ((causal ? min(q0 + kDqBQ, S) : S) + kDqBK - 1) / kDqBK;
}

// One consumer warpgroup's share of one K/V tile, over the tile's first NK
// keys. S = Q K^T (K's stage already waited for) and, after waiting on
// full_v, dP = dO V^T are wgmma from shared memory in two commit groups, so
// P = exp2(S scale log2(e) - lse log2(e)) is made while dP is multiplied;
// then dS = P (dP - delta) in place and dQ += dS K with dS as the register
// A operand. Qw and dOw point at the warpgroup's 64 rows of the Q and dO
// tiles; lse2 (times log2(e)) and dlt are the terms of the thread's rows
// qi0 and qi0 + 8. dqr holds Dh / 2 floats a thread.
template <int NK, int N>
__device__ __forceinline__ void dq_tile(float (&dqr)[N], const unsigned char* Qw,
                                        const unsigned char* dOw, const unsigned char* Kt,
                                        const unsigned char* Vt, uint64_t* full_v, uint32_t ph,
                                        const float (&lse2)[2], const float (&dlt)[2], int k0,
                                        int qi0, int S, int causal, bool edge, float scale_log2) {
  constexpr int DH = 2 * N;
  const int lane = threadIdx.x % 32;
  float sc[NK / 2], dp[NK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t a = (kk / 4) * (kDqBQ * 128) + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * (kDqBK * 128) + (kk % 4) * 32;
    wgmma_ss(sc, desc(Qw + a, 16, 1024), desc(Kt + b, 16, 1024), kk);
  }
  wgmma_commit();
  mbar_wait(full_v, ph);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t a = (kk / 4) * (kDqBQ * 128) + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * (kDqBK * 128) + (kk % 4) * 32;
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
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) dp[i] = sc[i] * (dp[i] - dlt[(i % 4) / 2]);
  uint32_t dsa[NK / 16][4];
  to_a_operand(dp, dsa);

  // dQ += dS K: B is [keys, d], d contiguous.
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_rs(dqr, dsa[kk], desc(Kt + kk * 16 * 128, kDqBK * 128, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(dqr);
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
  constexpr uint32_t kDqQ = DqCfg<DH>::kQ, kDqKV = DqCfg<DH>::kKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + kDqQ;
  unsigned char* Ks = smem + 2 * kDqQ;              // stage s at + s * kDqKV
  unsigned char* Vs = smem + 2 * kDqQ + 2 * kDqKV;  // stage s at + s * kDqKV
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * kDqQ + 4 * kDqKV);
  uint64_t* bar_q = bars;       // Q and dO
  uint64_t* full_k = bars + 1;  // [2]
  uint64_t* full_v = bars + 3;  // [2]
  uint64_t* empty = bars + 5;   // [2]

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + kDqBQ - 1) / kDqBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * kDqBQ;
  const int n_k = dq_kv_tiles(q0, S, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
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
      prefetch_map(&map_do);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_expect(bar_q, 2 * kDqQ);
      tma_load_tile<DH>(Qs, &map_q, bar_q, kDqBQ, q0, bh);
      tma_load_tile<DH>(dOs, &map_do, bar_q, kDqBQ, q0, bh);
      for (int j = 0; j < n_k; ++j) {
        const int s = j & 1;
        mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);
        mbar_expect(&full_k[s], kDqKV);
        tma_load_tile<DH>(Ks + s * kDqKV, &map_k, &full_k[s], kDqBK, j * kDqBK, bh);
        mbar_expect(&full_v[s], kDqKV);
        tma_load_tile<DH>(Vs + s * kDqKV, &map_v, &full_v[s], kDqBK, j * kDqBK, bh);
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
    float dqr[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dqr[i] = 0.f;
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_k; ++j) {
      const int s = j & 1, k0 = j * kDqBK;
      const uint32_t ph = (j >> 1) & 1;
      const unsigned char* Kt = Ks + s * kDqKV;
      const unsigned char* Vt = Vs + s * kDqKV;
      const bool edge = k0 + kDqBK > S || (causal && k0 + kDqBK - 1 > row0);
      mbar_wait(&full_k[s], ph);
      dq_tile<kDqBK>(dqr, Qw, dOw, Kt, Vt, &full_v[s], ph, lse2, dlt, k0, qi0, S, causal, edge,
                     scale_log2);
      mbar_arrive(&empty[s]);
    }
    // This warpgroup's Q rows are read by no one now: stage dQ there.
    store_rows(dqr, scale, scale, Qs, kDqBQ, 64 * wg, dq + (size_t)bh * S * DH, row0, S, 1 + wg);
  }
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s, int causal,
                      float scale, cudaStream_t stream) {
  constexpr uint32_t kSmem = DqCfg<DH>::kSmem;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, DH, kDqBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, DH, kDqBK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, DH, kDqBK)) != cudaSuccess) return e;
  if ((e = encode_map(&mdo, dout, bh, s, DH, kDqBQ)) != cudaSuccess) return e;
  if ((e = allow_smem(flash_bwd_dq_kernel_sm90<DH>, kSmem)) != cudaSuccess) return e;
  const long long blocks = (long long)((s + kDqBQ - 1) / kDqBQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel_sm90<DH><<<(unsigned)blocks, kThreads, kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), bh, s, causal, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace sm90

}  // namespace flash

// q, k, v, dout, dq: [bh, s, dh] (float32, or bfloat16 when is_bf16); lse,
// delta: float32 [bh, s]. dh is 64 or 128, in both dtypes. Launches on
// `stream` and returns the launch's CUDA error code.
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
  if (!is_bf16 && dh == 128)
    return (int)launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 64)
    return (int)launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the kernel for (dh, dtype) takes, in
// bytes; 0 for a pair that has no kernel.
extern "C" int dmlc_flash_bwd_dq_smem_bytes(int dh, int is_bf16) {
  using namespace flash;
  if (dh == 128) return (int)(is_bf16 ? sm90::DqCfg<128>::kSmem : DqCfg<float, 128>::bytes);
  if (dh == 64) return (int)(is_bf16 ? sm90::DqCfg<64>::kSmem : DqCfg<float, 64>::bytes);
  return 0;
}
