// flash_bwd_dkv: the key and value gradients of flash attention
// (FlashAttention-2).
//
// Replaces the TPU kernel dmlc_tpu/ops/pallas_kernels.py:_flash_bwd_dkv_kernel
// (pallas_call at :574, via _flash_backward), the dK/dV half of
// flash_attention's custom VJP. There a sequential grid axis walks Q blocks
// and carries dK and dV in VMEM scratch; here a loop inside the block does.
//
// Inputs q, k, v, dO: [BH, S, DH] row-major, float32 or bfloat16; lse and
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
// What the design does about it: one block of 256 threads per (BH, 64-row
// K tile). K, V and the float32 dK, dV accumulators stay in shared memory;
// Q, dO, lse and delta tiles stream through (64 rows in bf16, 32 in
// float32, whose tiles are twice the bytes). Per Q tile, two products give
// the scores and dP, one per-element pass makes P and dS, and two products
// add P^T dO and dS^T Q. When causal, a block starts at the first Q tile
// that reaches its keys: tiles wholly before the K tile give nothing
// (pallas_kernels.py:362). The products run on the tensor cores in bf16
// (wmma, float32 accumulation) and on FMA in float32. Simple first: no
// TMA, no wgmma, no overlap of loads with products.

#include "flash_common.cuh"

namespace flash {

template <typename T, int DH>
struct DkvCfg {
  static constexpr int BK = 64;
  static constexpr int BQ = sizeof(T) == 4 ? 32 : 64;  // float32 tiles fit at 32 rows
  static constexpr int LDT = Ld<T, DH>::value;
  static constexpr int LDS = BK + 4;
  static constexpr int LDP = Ld<T, BK>::value;
  static constexpr int LDO = DH + 4;
  static constexpr size_t bytes = 2 * round128(BK * LDT * sizeof(T)) +     // K, V
                                  2 * round128(BQ * LDT * sizeof(T)) +     // Q, dO
                                  2 * round128(BQ * LDS * sizeof(float)) + // scores, dP
                                  2 * round128(BQ * LDP * sizeof(T)) +     // P, dS
                                  2 * round128(BK * LDO * sizeof(float)) + // dK, dV
                                  2 * round128(BQ * sizeof(float));        // lse, delta
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int BH, int S, int causal,
                         float scale) {
  typedef DkvCfg<T, DH> C;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* Ks = cur.take<T>(BK * C::LDT);
  T* Vs = cur.take<T>(BK * C::LDT);
  T* Qs = cur.take<T>(BQ * C::LDT);
  T* dOs = cur.take<T>(BQ * C::LDT);
  float* Ss = cur.take<float>(BQ * C::LDS);
  float* dPs = cur.take<float>(BQ * C::LDS);
  T* Ps = cur.take<T>(BQ * C::LDP);
  T* dSs = cur.take<T>(BQ * C::LDP);
  float* dKs = cur.take<float>(BK * C::LDO);
  float* dVs = cur.take<float>(BK * C::LDO);
  float* lse_s = cur.take<float>(BQ);
  float* delta_s = cur.take<float>(BQ);

  // Block order: K tile 0 of every head first (the most Q tiles when causal).
  const int bh = blockIdx.x % BH;
  const int k0 = (int)(blockIdx.x / BH) * BK;
  const size_t base = (size_t)bh * S * DH;
  const int tid = threadIdx.x;

  load_tile<T, BK, DH, C::LDT>(Ks, k + base, k0, S);
  load_tile<T, BK, DH, C::LDT>(Vs, v + base, k0, S);
  for (int i = tid; i < BK * C::LDO; i += kThreads) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }

  const int n_q = (S + BQ - 1) / BQ;
  for (int t = causal ? k0 / BQ : 0; t < n_q; ++t) {
    const int q0 = t * BQ;
    __syncthreads();
    load_tile<T, BQ, DH, C::LDT>(Qs, q + base, q0, S);
    load_tile<T, BQ, DH, C::LDT>(dOs, dout + base, q0, S);
    load_rows<BQ>(lse_s, lse + (size_t)bh * S, q0, S);
    load_rows<BQ>(delta_s, delta + (size_t)bh * S, q0, S);
    __syncthreads();
    gemm<BQ, BK, DH, false, true, false>(Ss, C::LDS, Qs, C::LDT, Ks, C::LDT);
    gemm<BQ, BK, DH, false, true, false>(dPs, C::LDS, dOs, C::LDT, Vs, C::LDT);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i - r * BK;
      const int qi = q0 + r, kj = k0 + c;
      const bool visible = qi < S && kj < S && (!causal || kj <= qi);
      const float p = visible ? expf(Ss[r * C::LDS + c] * scale - lse_s[r]) : 0.f;
      Ps[r * C::LDP + c] = from_f32<T>(p);
      dSs[r * C::LDP + c] = from_f32<T>(p * (dPs[r * C::LDS + c] - delta_s[r]));
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: P and dS read transposed (A_COL).
    gemm<BK, DH, BQ, true, false, true>(dVs, C::LDO, Ps, C::LDP, dOs, C::LDT);
    gemm<BK, DH, BQ, true, false, true>(dKs, C::LDO, dSs, C::LDP, Qs, C::LDT);
  }
  __syncthreads();
  for (int i = tid; i < BK * DH; i += kThreads) {
    const int r = i / DH, c = i - r * DH;
    if (k0 + r < S) {
      const size_t at = base + (size_t)(k0 + r) * DH + c;
      dk[at] = from_f32<T>(dKs[r * C::LDO + c] * scale);
      dv[at] = from_f32<T>(dVs[r * C::LDO + c]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                       int causal, float scale, cudaStream_t stream) {
  typedef DkvCfg<T, DH> C;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, DH>, C::bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + C::BK - 1) / C::BK) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dkv_kernel<T, DH><<<(unsigned)blocks, kThreads, C::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), bh, s, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v, dout, dk, dv: [bh, s, dh] (float32, or bfloat16 when is_bf16);
// lse, delta: float32 [bh, s]. dh is 128. Launches on `stream` and
// returns the launch's CUDA error code.
extern "C" int dmlc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int bh,
                                  int s, int dh, int causal, float scale, int is_bf16,
                                  void* stream) {
  using namespace flash;
  if (bh <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16 && dh == 128)
    return (int)launch_dkv<bf16, 128>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 128)
    return (int)launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
