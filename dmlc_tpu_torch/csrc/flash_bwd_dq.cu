// flash_bwd_dq: the query gradient of flash attention (FlashAttention-2).
//
// Replaces the TPU kernel dmlc_tpu/ops/pallas_kernels.py:_flash_bwd_dq_kernel
// (pallas_call at :559, via _flash_backward), the dQ half of
// flash_attention's custom VJP. There a sequential grid axis walks K blocks
// and carries dQ in VMEM scratch; here a loop inside the block does.
//
// Inputs q, k, v, dO: [BH, S, DH] row-major, float32 or bfloat16; lse and
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
// What the design does about it: one block of 256 threads per (BH, 64-row
// Q tile). Q, dO, lse and delta stay in shared memory; K/V tiles of 64
// rows stream through. Per tile, two products give the scores and dP
// ([64, 64] float32 each, in shared memory), one per-element pass makes
// dS, and a third product adds dS K into the float32 dQ accumulator. The
// products run on the tensor cores in bf16 (wmma, float32 accumulation)
// and on FMA in float32. Causal blocks stop at the diagonal; the longest
// Q tiles are scheduled first. Simple first: no TMA, no wgmma, no overlap
// of loads with products.

#include "flash_common.cuh"

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

}  // namespace flash

// q, k, v, dout, dq: [bh, s, dh] (float32, or bfloat16 when is_bf16); lse,
// delta: float32 [bh, s]. dh is 128. Launches on `stream` and
// returns the launch's CUDA error code.
extern "C" int dmlc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int bh, int s,
                                 int dh, int causal, float scale, int is_bf16, void* stream) {
  using namespace flash;
  if (bh <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16 && dh == 128)
    return (int)launch_dq<bf16, 128>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 128)
    return (int)launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
