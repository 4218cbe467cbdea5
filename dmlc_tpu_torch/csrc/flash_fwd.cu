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
// bf16, the Hopper design (flash_sm90.cuh): one block per (BH, 128-row Q
// tile), 384 threads. Two consumer warpgroups own 64 query rows each; one
// producer warpgroup gives its registers to them (setmaxnreg) and one of
// its threads issues every copy. TMA loads the Q tile once and streams
// 128-row K and V tiles through a 2-stage ring (full and empty mbarriers
// per stage; 160 KB of shared memory), so the next tile loads while this
// one is multiplied. S = Q K^T is wgmma m64n128k16 from shared memory with
// the float32 scores in registers; the online softmax runs on them (row
// max and sum over the 4 threads of a row, scale * log2(e) folded into
// exp2); P is rounded to bf16 in registers and is the register A operand
// of O += P V (V MN-major, the transpose bit set); O stays in registers
// ([64, 128] float32, 64 a thread), rescaled there. Masks run only on the
// tiles that cross the diagonal or the end of S. Causal blocks stop at the
// diagonal; the longest Q tiles of every head launch first. The epilogue
// stages O / l as bf16 through shared memory into 16-byte stores.
//
// float32 keeps the first design: one block of 256 threads per (BH,
// 64-row Q tile), Q, K, V, the scores and the float32 output accumulator
// in shared memory, the products on FMA in full float32 (gemm()), the
// online softmax one warp per row, no overlap of loads with products.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

namespace sm90 {

constexpr int kFwdBQ = 128, kFwdBK = 128;
constexpr uint32_t kFwdTile = kFwdBQ * kDH * 2;  // 32 KB: a Q, K or V tile
constexpr uint32_t kFwdSmem = 5 * kFwdTile + 7 * 8 + 1024;  // Q, K[2], V[2], barriers, alignment

// K/V tiles that the Q tile at q0 reads: up to its diagonal when causal.
__device__ __forceinline__ int fwd_kv_tiles(int q0, int S, int causal) {
  return ((causal ? min(q0 + kFwdBQ, S) : S) + kFwdBK - 1) / kFwdBK;
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int BH, int S, int causal, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + kFwdTile;      // stage s at + s * kFwdTile
  unsigned char* Vs = smem + 3 * kFwdTile;  // stage s at + s * kFwdTile
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 5 * kFwdTile);
  uint64_t* bar_q = bars;
  uint64_t* full_k = bars + 1;  // [2]
  uint64_t* full_v = bars + 3;  // [2]
  uint64_t* empty = bars + 5;   // [2]

  // Block order: the last (longest, when causal) Q tile of every head first.
  const int n_tiles = (S + kFwdBQ - 1) / kFwdBQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)(blockIdx.x / BH)) * kFwdBQ;
  const int n_k = fwd_kv_tiles(q0, S, causal);
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
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_expect(bar_q, kFwdTile);
      tma_load_tile(Qs, &map_q, bar_q, kFwdBQ, q0, bh);
      for (int j = 0; j < n_k; ++j) {
        const int s = j & 1;
        mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);
        mbar_expect(&full_k[s], kFwdTile);
        tma_load_tile(Ks + s * kFwdTile, &map_k, &full_k[s], kFwdBK, j * kFwdBK, bh);
        mbar_expect(&full_v[s], kFwdTile);
        tma_load_tile(Vs + s * kFwdTile, &map_v, &full_v[s], kFwdBK, j * kFwdBK, bh);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg + [0, 64).
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row_lo = 64 * wg + 16 * (t / 32) + lane / 4;  // and row_lo + 8
    const int qi0 = q0 + row_lo, qi1 = qi0 + 8;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_k; ++j) {
      const int s = j & 1, k0 = j * kFwdBK;
      const uint32_t ph = (j >> 1) & 1;
      unsigned char* Kt = Ks + s * kFwdTile;
      unsigned char* Vt = Vs + s * kFwdTile;
      mbar_wait(&full_k[s], ph);
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t at = (kk / 4) * (kFwdTile / 2) + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc(Qs + at + 64 * wg * 128, 16, 1024), desc(Kt + at, 16, 1024),
                         kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      // Scores in log2 units; -inf where masked, which only the tiles
      // crossing the diagonal or the end of S need.
      const bool edge = k0 + kFwdBK > S || (causal && k0 + kFwdBK - 1 > q0 + 64 * wg);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int kj = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int qi = (i % 4) < 2 ? qi0 : qi1;
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
      const float c0 = exp2f(m0 - b0), c1 = exp2f(m1 - b1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float p = exp2f(sc[i] - ((i % 4) < 2 ? b0 : b1));
        sc[i] = p;
        if ((i % 4) < 2) sum0 += p; else sum1 += p;
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= (i % 4) < 2 ? c0 : c1;
      uint32_t pa[8][4];
      to_a_operand(sc, pa);

      mbar_wait(&full_v[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_n128(o, pa[kk], desc(Vt + kk * 16 * 128, kFwdTile / 2, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    if (lane % 4 == 0) {
      if (qi0 < S) lse[(size_t)bh * S + qi0] = m0 * kLn2 + logf(l0);
      if (qi1 < S) lse[(size_t)bh * S + qi1] = m1 * kLn2 + logf(l1);
    }
    // This warpgroup's Q rows are read by no one now: stage O / l there.
    store_rows(o, 1.f / l0, 1.f / l1, Qs, kFwdBQ, 64 * wg, out + (size_t)bh * S * kDH,
               q0 + 64 * wg, S, 1 + wg);
  }
}

inline cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int bh, int s, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, kFwdBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, kFwdBK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, kFwdBK)) != cudaSuccess) return e;
  if ((e = allow_smem(flash_fwd_kernel_sm90, kFwdSmem)) != cudaSuccess) return e;
  const long long blocks = (long long)((s + kFwdBQ - 1) / kFwdBQ) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel_sm90<<<(unsigned)blocks, kThreads, kFwdSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), bh, s, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace sm90

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
  if (is_bf16 && dh == 128) return (int)sm90::launch_fwd(q, k, v, out, lse, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 128) return (int)launch_fwd<float, 128>(q, k, v, out, lse, bh, s, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the bf16 kernel takes, in bytes.
extern "C" int dmlc_flash_fwd_smem_bytes(void) { return (int)flash::sm90::kFwdSmem; }
