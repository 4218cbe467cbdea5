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
// never stage P or dS in shared memory. dK and dV ([64, 128] float32
// each) stay in registers for the whole Q loop; scale is applied once, in
// the epilogue. When causal a block starts at the first Q tile that
// reaches its keys (pallas_kernels.py:362) and only the diagonal tiles are
// masked.
//
// float32 keeps the first design: one block of 256 threads per (BH, 64-row
// K tile), K, V and the float32 dK, dV accumulators in shared memory, Q,
// dO, lse and delta tiles of 32 rows streaming through, the products on FMA
// in full float32 (gemm()), no overlap of loads with products.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

namespace sm90 {

constexpr int kDkvBK = 128, kDkvBQ = 64;
constexpr uint32_t kDkvKV = kDkvBK * kDH * 2;  // 32 KB: the K or the V tile
constexpr uint32_t kDkvQ = kDkvBQ * kDH * 2;   // 16 KB: a Q or dO tile
constexpr uint32_t kDkvRows = 2 * kDkvKV + 4 * kDkvQ;  // lse, delta rows start here
constexpr uint32_t kDkvSmem = kDkvRows + 4 * kDkvBQ * 4 + 5 * 8 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int BH,
                              int S, int causal, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (align1024(smem_u32(smem_raw)) - smem_u32(smem_raw));
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + kDkvKV;
  unsigned char* Qs = smem + 2 * kDkvKV;                // stage s at + s * kDkvQ
  unsigned char* dOs = smem + 2 * kDkvKV + 2 * kDkvQ;   // stage s at + s * kDkvQ
  float* lse_s = reinterpret_cast<float*>(smem + kDkvRows);  // [2][64], times log2(e)
  float* delta_s = lse_s + 2 * kDkvBQ;                       // [2][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(delta_s + 2 * kDkvBQ);
  uint64_t* bar_kv = bars;
  uint64_t* full = bars + 1;   // [2]
  uint64_t* empty = bars + 3;  // [2]

  // Block order: K tile 0 of every head first (the most Q tiles when causal).
  const int bh = blockIdx.x % BH;
  const int k0 = (int)(blockIdx.x / BH) * kDkvBK;
  // Q tiles [t0, t_end): when causal, from the first that reaches these keys.
  const int t0 = causal ? k0 / kDkvBQ : 0;
  const int t_end = (S + kDkvBQ - 1) / kDkvBQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
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
        tma_load_tile(Ks, &map_k, bar_kv, kDkvBK, k0, bh);
        tma_load_tile(Vs, &map_v, bar_kv, kDkvBK, k0, bh);
      }
      const float* lse_g = lse + (size_t)bh * S;
      const float* delta_g = delta + (size_t)bh * S;
      for (int t = t0; t < t_end; ++t) {
        const int it = t - t0, s = it & 1, q0 = t * kDkvBQ;
        mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h, qi = q0 + r;
          lse_s[s * kDkvBQ + r] = qi < S ? lse_g[qi] * kLog2e : 0.f;
          delta_s[s * kDkvBQ + r] = qi < S ? delta_g[qi] : 0.f;
        }
        if (lane == 0) {
          mbar_expect(&full[s], 2 * kDkvQ);
          tma_load_tile(Qs + s * kDkvQ, &map_q, &full[s], kDkvBQ, q0, bh);
          tma_load_tile(dOs + s * kDkvQ, &map_do, &full[s], kDkvBQ, q0, bh);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: keys k0 + 64 wg + [0, 64).
    regs_alloc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int key_lo = k0 + 64 * wg + 16 * (t / 32) + lane / 4, key_hi = key_lo + 8;
    float dkr[64], dvr[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dkr[i] = dvr[i] = 0.f;
    mbar_wait(bar_kv, 0);
    for (int tq = t0; tq < t_end; ++tq) {
      const int it = tq - t0, s = it & 1, q0 = tq * kDkvBQ;
      unsigned char* Qt = Qs + s * kDkvQ;
      unsigned char* dOt = dOs + s * kDkvQ;
      mbar_wait(&full[s], (it >> 1) & 1);
      // S^T = K Q^T and dP^T = V dO^T, [64 keys, 64 queries] each.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t a = (kk / 4) * (kDkvKV / 2) + 64 * wg * 128 + (kk % 4) * 32;
        const uint32_t b = (kk / 4) * (kDkvQ / 2) + (kk % 4) * 32;
        wgmma_ss_n64(st, desc(Ks + a, 16, 1024), desc(Qt + b, 16, 1024), kk);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t a = (kk / 4) * (kDkvKV / 2) + 64 * wg * 128 + (kk % 4) * 32;
        const uint32_t b = (kk / 4) * (kDkvQ / 2) + (kk % 4) * 32;
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
        wgmma_rs_n128(dvr, pa[kk], desc(dOt + kk * 16 * 128, kDkvQ / 2, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n128(dkr, dsa[kk], desc(Qt + kk * 16 * 128, kDkvQ / 2, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dvr);
      reg_fence(dkr);
      mbar_arrive(&empty[s]);
    }
    // This warpgroup's K and V rows are read by no one now: stage there.
    const size_t base = (size_t)bh * S * kDH;
    store_rows(dkr, scale, scale, Ks, kDkvBK, 64 * wg, dk + base, k0 + 64 * wg, S, 1 + wg);
    store_rows(dvr, 1.f, 1.f, Vs, kDkvBK, 64 * wg, dv + base, k0 + 64 * wg, S, 1 + wg);
  }
}

inline cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv, int bh,
                              int s, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = encode_map(&mq, q, bh, s, kDkvBQ)) != cudaSuccess) return e;
  if ((e = encode_map(&mk, k, bh, s, kDkvBK)) != cudaSuccess) return e;
  if ((e = encode_map(&mv, v, bh, s, kDkvBK)) != cudaSuccess) return e;
  if ((e = encode_map(&mdo, dout, bh, s, kDkvBQ)) != cudaSuccess) return e;
  if ((e = allow_smem(flash_bwd_dkv_kernel_sm90, kDkvSmem)) != cudaSuccess) return e;
  const long long blocks = (long long)((s + kDkvBK - 1) / kDkvBK) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dkv_kernel_sm90<<<(unsigned)blocks, kThreads, kDkvSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), bh, s, causal, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace sm90

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
    return (int)sm90::launch_dkv(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  if (!is_bf16 && dh == 128)
    return (int)launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the bf16 kernel takes, in bytes.
extern "C" int dmlc_flash_bwd_dkv_smem_bytes(void) { return (int)flash::sm90::kDkvSmem; }
