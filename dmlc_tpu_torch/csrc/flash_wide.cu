// flash_wide: flash attention forward, dQ and dK/dV at head dims past 128.
//
// Replaces, for the head dims the Hopper designs of flash_fwd.cu,
// flash_bwd_dq.cu and flash_bwd_dkv.cu are not built for, the TPU kernels
// of dmlc_tpu/ops/pallas_kernels.py: _flash_kernel (:157) and
// _flash_fwd_stream_kernel (:215) for the forward, _flash_bwd_dq_kernel
// (:271) and _flash_bwd_dkv_kernel (:320). Those take any head dim; the
// three sources above are instantiated at 64 and 128 only, and
// ops/flash.py zero-pads a smaller head dim up to one of them. Past 128 it
// pads to a multiple of 8 and launches these kernels, up to kWideMaxDh. No
// model of the registry has heads wider than 128, so no main path runs
// them: they keep a head dim that the reference computes from being
// refused on the card.
//
// Contracts, as in the other three sources: q, k, v, dO, out, dq, dk, dv
// are [BH, S, DH] row-major, all float32 or all bfloat16; lse and delta
// float32 [BH, S]. out = softmax(scale q k^T) v with keys past the query
// masked when causal, lse = m + log(max(l, 1e-30)), a row with no visible
// key gets out 0 and lse -inf; dQ = scale dS K, dK = dS^T (scale Q), dV =
// P^T dO, with P = exp(scale q k^T - lse) and dS = P (dP - delta). Every
// product and sum is full float32 FMA (no TF32), q scaled before the
// product; bfloat16 rounds only the outputs.
//
// What bounds them on the H100: as for the other flash kernels,
// operations (2, 3 and 4 products of the [S, S] scores; the float32 peak
// is 67 TFLOP/s). This design does not reach that bound: each 4 FMAs read
// one float4 of each operand from shared memory, so shared-memory
// bandwidth sets the rate. It is built to be simple and right at any head
// dim, not fast.
//
// Design: DH is a run-time argument (a multiple of 8, so that every row
// is whole 16-byte chunks in both dtypes). A block has 128 threads (4
// warps) and owns R rows (query rows for the forward and dQ, key rows for
// dK/dV); the host sizes R from DH (64, 32, 16 or 8) so that the block's
// shared memory fits, two blocks an SM where they can. Operand tiles are
// loaded in 16-byte chunks, converted to float32 into shared memory with
// rows padded by 16 bytes (which spreads a column's float4 reads over the
// banks at any DH that is a multiple of 8), and the float32 accumulators
// of O, dQ, dK and dV stay in shared memory for the whole loop. A score
// tile is [R, 32]: warp w owns rows w + 4 t and lane c column c, a dot
// product along DH (`scores`); the forward's online softmax reduces each
// row over the warp by shuffles. The output products walk DH in float4
// columns, four rows a thread (`accumulate`).

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace flash {

namespace wide {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;      // columns of a score tile: one a lane
constexpr int kRowGroup = 4;   // output rows a thread updates at once
constexpr int kWideMaxDh = 512;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take

__host__ __device__ constexpr int ld_of(int dh) { return dh + 4; }

// Shared memory of each kernel at R rows, in floats.
__host__ __device__ constexpr int fwd_floats(int r, int dh) {
  return ld_of(dh) * (2 * r + 2 * kCols) + r * kCols + 3 * r;
}
__host__ __device__ constexpr int dq_floats(int r, int dh) {
  return ld_of(dh) * (3 * r + 2 * kCols) + r * kCols + 2 * r;
}
__host__ __device__ constexpr int dkv_floats(int r, int dh) {
  return ld_of(dh) * (4 * r + 2 * kCols) + 2 * r * kCols + 2 * kCols;
}

__device__ __forceinline__ void unpack(const uint4& raw, float* dst, float mul, float) {
  float4 f = *reinterpret_cast<const float4*>(&raw);
  f.x *= mul; f.y *= mul; f.z *= mul; f.w *= mul;
  *reinterpret_cast<float4*>(dst) = f;
}

__device__ __forceinline__ void unpack(const uint4& raw, float* dst, float mul, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = __bfloat1622float2(h[2 * i]), b = __bfloat1622float2(h[2 * i + 1]);
    *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(a.x * mul, a.y * mul, b.x * mul,
                                                          b.y * mul);
  }
}

__device__ __forceinline__ uint4 pack(const float* src, float mul, float) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  const float4 g = make_float4(f.x * mul, f.y * mul, f.z * mul, f.w * mul);
  return *reinterpret_cast<const uint4*>(&g);
}

__device__ __forceinline__ uint4 pack(const float* src, float mul, __nv_bfloat16) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(src[2 * i] * mul, src[2 * i + 1] * mul);
  return raw;
}

// Rows [row0, row0 + rows) of a [S, dh] matrix of T into a float32 shared
// tile (leading dimension ld_of(dh)), each element times `mul`, in
// 16-byte chunks; rows at or past S are zero.
template <typename T>
__device__ void load_rows(float* sm, const T* __restrict__ g, int row0, int rows, int S, int dh,
                          float mul) {
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = dh / kPer, ld = ld_of(dh);
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * kPer;
    float* dst = sm + r * ld + c;
    if (row0 + r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * dh + c);
      unpack(raw, dst, mul, T());
    } else {
#pragma unroll
      for (int e = 0; e < kPer; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Rows [row0, row0 + rows) of a [S, dh] matrix of T from a float32 shared
// tile, row r times mul * rowmul[r] (rowmul may be null), in 16-byte
// chunks; rows at or past S are not written.
template <typename T>
__device__ void store_rows(T* __restrict__ g, const float* sm, const float* rowmul, int row0,
                           int rows, int S, int dh, float mul) {
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = dh / kPer, ld = ld_of(dh);
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * kPer;
    if (row0 + r >= S) continue;
    const float m = rowmul ? mul * rowmul[r] : mul;
    *reinterpret_cast<uint4*>(g + (size_t)(row0 + r) * dh + c) = pack(sm + r * ld + c, m, T());
  }
}

// s[t] = A(row warp + 4 t) . B(row lane) over dh, for the RPW rows a warp
// owns: B's row is read as float4 by each lane, A's broadcast to the warp.
template <int RPW>
__device__ __forceinline__ void scores(float (&s)[RPW], const float* A, const float* B, int dh,
                                       int warp, int lane) {
  const int ld = ld_of(dh);
  const float* b = B + lane * ld;
#pragma unroll
  for (int t = 0; t < RPW; ++t) s[t] = 0.f;
  for (int d = 0; d < dh; d += 4) {
    const float4 bv = ld4(b + d);
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const float4 a = ld4(A + (warp + kWarps * t) * ld + d);
      s[t] = fmaf(a.x, bv.x, s[t]);
      s[t] = fmaf(a.y, bv.y, s[t]);
      s[t] = fmaf(a.z, bv.z, s[t]);
      s[t] = fmaf(a.w, bv.w, s[t]);
    }
  }
}

// acc[r][:] = alpha[r] acc[r][:] + sum_c P[r][c] B[c][:] for the R rows of
// acc (alpha may be null: 1). P is [R, kCols], B a [kCols, dh] tile. A
// thread takes a float4 column of kRowGroup rows at a time.
__device__ void accumulate(float* acc, const float* P, const float* alpha, const float* B, int R,
                           int dh) {
  const int ld = ld_of(dh), cols = dh / 4, items = cols * (R / kRowGroup);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int c4 = (it % cols) * 4, r0 = (it / cols) * kRowGroup;
    float4 a[kRowGroup];
#pragma unroll
    for (int k = 0; k < kRowGroup; ++k) {
      a[k] = ld4(acc + (r0 + k) * ld + c4);
      if (alpha) {
        const float f = alpha[r0 + k];
        a[k].x *= f; a[k].y *= f; a[k].z *= f; a[k].w *= f;
      }
    }
    for (int c = 0; c < kCols; ++c) {
      const float4 bv = ld4(B + c * ld + c4);
#pragma unroll
      for (int k = 0; k < kRowGroup; ++k) {
        const float p = P[(r0 + k) * kCols + c];
        a[k].x = fmaf(p, bv.x, a[k].x);
        a[k].y = fmaf(p, bv.y, a[k].y);
        a[k].z = fmaf(p, bv.z, a[k].z);
        a[k].w = fmaf(p, bv.w, a[k].w);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowGroup; ++k) *reinterpret_cast<float4*>(acc + (r0 + k) * ld + c4) = a[k];
  }
}

__device__ void zero(float* sm, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) sm[i] = 0.f;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Forward: one block per (bh, R-row Q tile), the longest causal tiles
// first. K and V tiles of 32 keys stream through shared memory; the online
// softmax keeps each row's max and sum in the registers of its warp.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) flash_wide_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ lse, int S, int dh, int causal, float scale) {
  constexpr int RPW = R / kWarps;
  extern __shared__ float4 smem4[];
  const int ld = ld_of(dh);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + R * ld;
  float* Ks = Os + R * ld;
  float* Vs = Ks + kCols * ld;
  float* Ps = Vs + kCols * ld;
  float* alpha = Ps + R * kCols;
  float* inv_l = alpha + R;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * S * dh;
  load_rows(Qs, q + base, q0, R, S, dh, scale);
  zero(Os, R * ld);
  float m[RPW], l[RPW];
#pragma unroll
  for (int t = 0; t < RPW; ++t) m[t] = -INFINITY, l[t] = 0.f;
  const int k_end = causal ? min(q0 + R, S) : S;
  for (int k0 = 0; k0 < k_end; k0 += kCols) {
    __syncthreads();  // the last tile's K and V are read by no one now
    load_rows(Ks, k + base, k0, kCols, S, dh, 1.f);
    load_rows(Vs, v + base, k0, kCols, S, dh, 1.f);
    __syncthreads();
    float s[RPW];
    scores<RPW>(s, Qs, Ks, dh, warp, lane);
    const int key = k0 + lane;
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int row = warp + kWarps * t;
      const bool visible = key < S && (!causal || key <= q0 + row);
      const float x = visible ? s[t] : -INFINITY;
      const float mn = fmaxf(m[t], warp_max(x));
      // A row with nothing visible so far keeps m = -inf: subtract 0 there.
      const float base_m = mn == -INFINITY ? 0.f : mn;
      const float a = expf(m[t] - base_m);
      const float p = expf(x - base_m);
      l[t] = l[t] * a + warp_sum(p);
      m[t] = mn;
      Ps[row * kCols + lane] = p;
      if (lane == 0) alpha[row] = a;
    }
    __syncthreads();
    accumulate(Os, Ps, alpha, Vs, R, dh);
  }
#pragma unroll
  for (int t = 0; t < RPW; ++t) {
    const int row = warp + kWarps * t;
    const float ls = fmaxf(l[t], 1e-30f);
    if (lane == 0) {
      inv_l[row] = 1.f / ls;
      if (q0 + row < S) lse[(size_t)bh * S + q0 + row] = m[t] + logf(ls);
    }
  }
  __syncthreads();
  store_rows(out + base, Os, inv_l, q0, R, S, dh, 1.f);
}

// dQ: one block per (bh, R-row Q tile), the longest causal tiles first.
// Q (scaled) and dO stay in shared memory; per 32-key tile S and dP are
// recomputed in registers, dS goes to shared memory and dQ += dS K.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) flash_wide_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, int dh, int causal, float scale) {
  constexpr int RPW = R / kWarps;
  extern __shared__ float4 smem4[];
  const int ld = ld_of(dh);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + R * ld;
  float* dQs = dOs + R * ld;
  float* Ks = dQs + R * ld;
  float* Vs = Ks + kCols * ld;
  float* dSs = Vs + kCols * ld;
  float* lse_s = dSs + R * kCols;
  float* delta_s = lse_s + R;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * S * dh;
  load_rows(Qs, q + base, q0, R, S, dh, scale);
  load_rows(dOs, dout + base, q0, R, S, dh, 1.f);
  zero(dQs, R * ld);
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool ok = q0 + r < S;
    lse_s[r] = ok ? lse[(size_t)bh * S + q0 + r] : 0.f;
    delta_s[r] = ok ? delta[(size_t)bh * S + q0 + r] : 0.f;
  }
  const int k_end = causal ? min(q0 + R, S) : S;
  for (int k0 = 0; k0 < k_end; k0 += kCols) {
    __syncthreads();
    load_rows(Ks, k + base, k0, kCols, S, dh, 1.f);
    load_rows(Vs, v + base, k0, kCols, S, dh, 1.f);
    __syncthreads();
    float s[RPW], dp[RPW];
    scores<RPW>(s, Qs, Ks, dh, warp, lane);
    scores<RPW>(dp, dOs, Vs, dh, warp, lane);
    const int key = k0 + lane;
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int row = warp + kWarps * t, qi = q0 + row;
      const bool visible = key < S && qi < S && (!causal || key <= qi);
      const float p = visible ? expf(s[t] - lse_s[row]) : 0.f;
      dSs[row * kCols + lane] = p * (dp[t] - delta_s[row]);
    }
    __syncthreads();
    accumulate(dQs, dSs, nullptr, Ks, R, dh);
  }
  __syncthreads();
  store_rows(dq + base, dQs, nullptr, q0, R, S, dh, scale);
}

// dK and dV: one block per (bh, R-key block), the longest causal blocks
// (the first keys) first. K, V and the dK, dV accumulators stay in shared
// memory; 32-row Q (scaled) and dO tiles stream past them; per tile P^T
// and dS^T are recomputed in registers, go to shared memory, and dV +=
// P^T dO, dK += dS^T (scale Q).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) flash_wide_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int dh, int causal, float scale) {
  constexpr int RPW = R / kWarps;
  extern __shared__ float4 smem4[];
  const int ld = ld_of(dh);
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + R * ld;
  float* dKs = Vs + R * ld;
  float* dVs = dKs + R * ld;
  float* Qs = dVs + R * ld;
  float* dOs = Qs + kCols * ld;
  float* Pt = dOs + kCols * ld;
  float* dSt = Pt + R * kCols;
  float* lse_s = dSt + R * kCols;
  float* delta_s = lse_s + kCols;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * S * dh;
  load_rows(Ks, k + base, k0, R, S, dh, 1.f);
  load_rows(Vs, v + base, k0, R, S, dh, 1.f);
  zero(dKs, 2 * R * ld);  // dK and dV
  const int q_begin = causal ? (k0 / kCols) * kCols : 0;
  for (int q0 = q_begin; q0 < S; q0 += kCols) {
    __syncthreads();
    load_rows(Qs, q + base, q0, kCols, S, dh, scale);
    load_rows(dOs, dout + base, q0, kCols, S, dh, 1.f);
    if (threadIdx.x < kCols) {
      const bool ok = q0 + threadIdx.x < S;
      lse_s[threadIdx.x] = ok ? lse[(size_t)bh * S + q0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = ok ? delta[(size_t)bh * S + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    float st[RPW], dpt[RPW];
    scores<RPW>(st, Ks, Qs, dh, warp, lane);
    scores<RPW>(dpt, Vs, dOs, dh, warp, lane);
    const int qi = q0 + lane;
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int row = warp + kWarps * t, kj = k0 + row;
      const bool visible = qi < S && kj < S && (!causal || kj <= qi);
      const float p = visible ? expf(st[t] - lse_s[lane]) : 0.f;
      Pt[row * kCols + lane] = p;
      dSt[row * kCols + lane] = p * (dpt[t] - delta_s[lane]);
    }
    __syncthreads();
    accumulate(dVs, Pt, nullptr, dOs, R, dh);
    accumulate(dKs, dSt, nullptr, Qs, R, dh);
  }
  __syncthreads();
  store_rows(dk + base, dKs, nullptr, k0, R, S, dh, 1.f);
  store_rows(dv + base, dVs, nullptr, k0, R, S, dh, 1.f);
}

// The rows a block of each kernel owns at head dim dh: the largest of 64,
// 32, 16 and 8 whose shared memory leaves room for two blocks an SM, else
// the largest that fits one; 0 when none fits.
inline int rows_for(int (*floats)(int, int), int dh) {
  const int budgets[2] = {kSmemMax / 2, kSmemMax}, rows[4] = {64, 32, 16, 8};
  for (int b : budgets)
    for (int r : rows)
      if (4 * floats(r, dh) <= b) return r;
  return 0;
}

inline int fwd_f(int r, int dh) { return fwd_floats(r, dh); }
inline int dq_f(int r, int dh) { return dq_floats(r, dh); }
inline int dkv_f(int r, int dh) { return dkv_floats(r, dh); }

inline bool bad_shape(int bh, int s, int dh) {
  return bh <= 0 || s <= 0 || dh <= 128 || dh > kWideMaxDh || dh % 8 != 0;
}

template <typename T, int R>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                       int s, int dh, int causal, float scale, cudaStream_t st) {
  const size_t smem = 4 * (size_t)fwd_floats(R, dh);
  cudaError_t e = allow_smem(flash_wide_fwd_kernel<T, R>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)bh, (unsigned)((s + R - 1) / R));
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  flash_wide_fwd_kernel<T, R><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), s, dh, causal, scale);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s, int dh,
                      int causal, float scale, cudaStream_t st) {
  const size_t smem = 4 * (size_t)dq_floats(R, dh);
  cudaError_t e = allow_smem(flash_wide_bwd_dq_kernel<T, R>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)bh, (unsigned)((s + R - 1) / R));
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  flash_wide_bwd_dq_kernel<T, R><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), s, dh, causal, scale);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                       int dh, int causal, float scale, cudaStream_t st) {
  const size_t smem = 4 * (size_t)dkv_floats(R, dh);
  cudaError_t e = allow_smem(flash_wide_bwd_dkv_kernel<T, R>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)bh, (unsigned)((s + R - 1) / R));
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  flash_wide_bwd_dkv_kernel<T, R><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s, dh, causal,
      scale);
  return cudaGetLastError();
}

// Returns LAUNCH<T, R>(...) for the run-time dtype (is_bf16) and row count R_.
#define WIDE_DISPATCH(LAUNCH, R_, ...)                                                      \
  do {                                                                                      \
    switch (R_) {                                                                           \
      case 64: return (int)(is_bf16 ? LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__)                \
                                    : LAUNCH<float, 64>(__VA_ARGS__));                      \
      case 32: return (int)(is_bf16 ? LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__)                \
                                    : LAUNCH<float, 32>(__VA_ARGS__));                      \
      case 16: return (int)(is_bf16 ? LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__)                \
                                    : LAUNCH<float, 16>(__VA_ARGS__));                      \
      case 8: return (int)(is_bf16 ? LAUNCH<__nv_bfloat16, 8>(__VA_ARGS__)                  \
                                   : LAUNCH<float, 8>(__VA_ARGS__));                        \
      default: return (int)cudaErrorInvalidValue;                                           \
    }                                                                                       \
  } while (0)

}  // namespace wide

}  // namespace flash

// The largest head dim these kernels take.
extern "C" int dmlc_flash_wide_max_head_dim() { return flash::wide::kWideMaxDh; }

// Rows a block owns for kernel `which` (0 forward, 1 dQ, 2 dK/dV) at head
// dim dh; 0 when dh is not taken.
extern "C" int dmlc_flash_wide_rows(int which, int dh) {
  using namespace flash::wide;
  if (bad_shape(1, 1, dh)) return 0;
  return rows_for(which == 0 ? fwd_f : which == 1 ? dq_f : dkv_f, dh);
}

// The three entry points take the arguments of dmlc_flash_fwd,
// dmlc_flash_bwd_dq and dmlc_flash_bwd_dkv: tensors [bh, s, dh] (float32,
// or bfloat16 when is_bf16), lse and delta float32 [bh, s]; dh a multiple
// of 8 in (128, kWideMaxDh]. Each launches on `stream` and returns the
// launch's CUDA error code.
extern "C" int dmlc_flash_wide_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int bh, int s, int dh, int causal, float scale,
                                   int is_bf16, void* stream) {
  using namespace flash::wide;
  if (bad_shape(bh, s, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  WIDE_DISPATCH(launch_fwd, rows_for(fwd_f, dh), q, k, v, out, lse, bh, s, dh, causal, scale,
                st);
}

extern "C" int dmlc_flash_wide_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int bh, int s, int dh, int causal, float scale,
                                      int is_bf16, void* stream) {
  using namespace flash::wide;
  if (bad_shape(bh, s, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  WIDE_DISPATCH(launch_dq, rows_for(dq_f, dh), q, k, v, dout, lse, delta, dq, bh, s, dh, causal,
                scale, st);
}

extern "C" int dmlc_flash_wide_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int s, int dh, int causal,
                                       float scale, int is_bf16, void* stream) {
  using namespace flash::wide;
  if (bad_shape(bh, s, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  WIDE_DISPATCH(launch_dkv, rows_for(dkv_f, dh), q, k, v, dout, lse, delta, dk, dv, bh, s, dh,
                causal, scale, st);
}
