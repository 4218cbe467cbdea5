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
// Inputs q, k, v: [BH, S, DH] row-major, float32 or bfloat16. Outputs out
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
// What the design does about it: one block of 256 threads per (BH, 64-row
// Q tile). The Q tile stays in shared memory; K/V tiles of 64 rows stream
// through it; the scores of one tile ([64, 64] float32) and the float32
// output accumulator ([64, DH]) live in shared memory, so the [S, S]
// matrix never reaches device memory. The products run on the tensor
// cores in bf16 (wmma, float32 accumulation) and on FMA in float32. The
// online softmax runs one warp per row. Causal blocks stop at the
// diagonal, and the longest Q tiles are scheduled first. Simple first:
// no TMA, no wgmma, no overlap of the next tile's load with this tile's
// products; a later change makes it fast.

#include "flash_common.cuh"

namespace flash {

template <typename T, int DH>
struct FwdCfg {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int LDT = Ld<T, DH>::value;   // Q, K, V tiles
  static constexpr int LDS = BK + 4;             // float32 scores
  static constexpr int LDP = Ld<T, BK>::value;   // probabilities in T
  static constexpr int LDO = DH + 4;             // float32 output accumulator
  static constexpr size_t bytes = round128(BQ * LDT * sizeof(T)) +
                                  2 * round128(BK * LDT * sizeof(T)) +
                                  round128(BQ * LDS * sizeof(float)) +
                                  round128(BQ * LDP * sizeof(T)) +
                                  round128(BQ * LDO * sizeof(float)) +
                                  3 * round128(BQ * sizeof(float));
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, int BH, int S, int causal,
                     float scale) {
  typedef FwdCfg<T, DH> C;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  SmemCursor cur{smem};
  T* Qs = cur.take<T>(BQ * C::LDT);
  T* Ks = cur.take<T>(BK * C::LDT);
  T* Vs = cur.take<T>(BK * C::LDT);
  float* Ss = cur.take<float>(BQ * C::LDS);
  T* Ps = cur.take<T>(BQ * C::LDP);
  float* Os = cur.take<float>(BQ * C::LDO);
  float* m_s = cur.take<float>(BQ);
  float* l_s = cur.take<float>(BQ);
  float* corr_s = cur.take<float>(BQ);

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * BQ;
  const size_t base = (size_t)bh * S * DH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_tile<T, BQ, DH, C::LDT>(Qs, q + base, q0, S);
  for (int i = tid; i < BQ * C::LDO; i += kThreads) Os[i] = 0.f;
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int q_end = min(q0 + BQ, S);
  const int n_k = ((causal ? q_end : S) + BK - 1) / BK;
  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the last tile's readers of Ks, Vs and Ps are done
    load_tile<T, BK, DH, C::LDT>(Ks, k + base, k0, S);
    load_tile<T, BK, DH, C::LDT>(Vs, v + base, k0, S);
    __syncthreads();
    gemm<BQ, BK, DH, false, true, false>(Ss, C::LDS, Qs, C::LDT, Ks, C::LDT);
    __syncthreads();
    // Online softmax, one warp per row: fold this tile into (m, l).
    for (int r = warp; r < BQ; r += kWarps) {
      const int qi = q0 + r;
      float sv[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int kj = k0 + lane + 32 * u;
        const bool visible = kj < S && (!causal || kj <= qi);
        sv[u] = visible ? Ss[r * C::LDS + lane + 32 * u] * scale : -INFINITY;
        mx = fmaxf(mx, sv[u]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // A row with nothing visible so far keeps m = -inf and corr 1.
      const float corr = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = sv[u] == -INFINITY ? 0.f : expf(sv[u] - m_new);
        Ps[r * C::LDP + lane + 32 * u] = from_f32<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < BQ * DH; i += kThreads) {
      const int r = i / DH;
      Os[r * C::LDO + (i - r * DH)] *= corr_s[r];
    }
    __syncthreads();
    gemm<BQ, DH, BK, false, false, true>(Os, C::LDO, Ps, C::LDP, Vs, C::LDT);
  }
  __syncthreads();
  for (int i = tid; i < BQ * DH; i += kThreads) {
    const int r = i / DH, c = i - r * DH;
    if (q0 + r < S)
      out[base + (size_t)(q0 + r) * DH + c] =
          from_f32<T>(Os[r * C::LDO + c] / fmaxf(l_s[r], 1e-30f));
  }
  for (int r = tid; r < BQ; r += kThreads)
    if (q0 + r < S) lse[(size_t)bh * S + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

template <typename T, int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                       int s, int causal, float scale, cudaStream_t stream) {
  typedef FwdCfg<T, DH> C;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, DH>, C::bytes);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((s + C::BQ - 1) / C::BQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, DH><<<(unsigned)blocks, kThreads, C::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), bh, s, causal, scale);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v, out: [bh, s, dh] (float32, or bfloat16 when is_bf16); lse:
// float32 [bh, s]. dh is 128. Launches on `stream` and returns the
// launch's CUDA error code.
extern "C" int dmlc_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int bh, int s, int dh, int causal, float scale, int is_bf16,
                              void* stream) {
  using namespace flash;
  if (bh <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16 && dh == 128) return (int)launch_fwd<bf16, 128>(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 128) return (int)launch_fwd<float, 128>(q, k, v, out, lse, bh, s, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
