// flash_wide: flash attention forward, dQ and dK/dV at head dims past 128.
//
// Replaces, for the head dims the kernels of flash_fwd.cu,
// flash_bwd_dq.cu and flash_bwd_dkv.cu are not built for, the TPU kernels
// of dmlc_tpu/ops/pallas_kernels.py: _flash_kernel (:157) and
// _flash_fwd_stream_kernel (:215) for the forward, _flash_bwd_dq_kernel
// (:271) and _flash_bwd_dkv_kernel (:320). Those take any head dim; the
// kernels of those sources are instantiated at 64, 128, 192, 256, 320,
// 384, 448 and 512 in both dtypes, and all three take every other
// multiple of 8 past 256 at run time in both dtypes; ops/flash.py
// zero-pads a head dim up to 512 to one of the fixed ones and a wider one
// to a multiple of 8. So the public functions send no head dim here: the
// wrappers reach these kernels only at a multiple of 8 in (128, 256) other
// than 192, through a direct call, and a direct call through their entry
// points takes any multiple of 8 past 128 (chip_smoke.py times them that
// way at 160, 192 and 256, and past 256 at 320, 384, 512, 640, 1024 and
// 768, all three in both dtypes, beside the kernels that replaced them
// there). No model of the registry has heads wider than 128, so no main
// path runs them.
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
// is whole 16-byte chunks in both dtypes), and no DH is refused: a block's
// shared memory depends on min(DH, kChunk) only. The output columns (of
// O, dQ, dK and dV) are cut into chunks of kChunk (256) columns, the last
// one narrower, and each block owns one chunk of one row tile: R rows
// (query rows for the forward and dQ, key rows for dK/dV; the host sizes
// R, 64, 32, 16 or 8, from min(DH, kChunk) so that the block's shared
// memory fits, two blocks an SM where they can) and its chunk's float32
// accumulators in shared memory for the whole loop. The score products
// (S = Q K^T, dP = dO V^T) walk DH in the same chunks: a [R, 32] score tile
// accumulates across them in registers, warp w owning rows w + 4 t and
// lane c column c, a dot product along DH (`scores`); the forward's online
// softmax reduces each row over the warp by shuffles. The output products
// walk the block's chunk in float4 columns, four rows a thread
// (`accumulate`). Operand tiles are loaded in 16-byte chunks, converted to
// float32 into shared memory with rows padded by 16 bytes (which spreads a
// column's float4 reads over the banks at any width that is a multiple of
// 8). Up to DH 256 there is one chunk, and each kernel is also built for
// that case (kOne): the chunk count is 1 at compile time, the operands a
// block keeps (Q, or K and V) load once and every product is as without
// chunks. It is not the code of the kernels before the chunking, though:
// on an H100 80GB HBM3 at 700 W one chunk costs the dK/dV kernel some
// percent against them, the forward and dQ about nothing (PERF.md,
// section 6, measured with tools/flash_levers.py group ab). The cause is
// not found; the column offset and width each tile load now takes, and
// the flattened grid's index arithmetic, are candidates. Past DH 256,
// each chunk's block recomputes the scores, (chunks - 1) x the score
// products more in all, and reloads its kept operands for each tile and
// chunk. Each
// product sums over DH, and over the keys or queries, in one fixed order
// whatever the chunking, so a result does not depend on it. What bounds a
// launch is a grid of at most 2^31 - 1 blocks (row tiles x heads x
// chunks), which a tensor that fits an 80 GB card does not reach.

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace flash {

namespace wide {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;      // columns of a score tile: one a lane
constexpr int kRowGroup = 4;   // output rows a thread updates at once
constexpr int kChunk = 256;    // columns of DH a block holds in shared memory at once
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take

__host__ __device__ constexpr int ld_of(int w) { return w + 4; }

// Width of the widest chunk at head dim dh, and of chunk c.
__host__ __device__ constexpr int widest(int dh) { return dh < kChunk ? dh : kChunk; }
__host__ __device__ constexpr int chunk_width(int dh, int c) { return widest(dh - c * kChunk); }
__host__ __device__ constexpr int chunks(int dh) { return (dh + kChunk - 1) / kChunk; }

// Shared memory of each kernel at R rows and chunks of width w, in floats.
__host__ __device__ constexpr int fwd_floats(int r, int w) {
  return ld_of(w) * (2 * r + 2 * kCols) + r * kCols + 3 * r;
}
__host__ __device__ constexpr int dq_floats(int r, int w) {
  return ld_of(w) * (3 * r + 2 * kCols) + r * kCols + 2 * r;
}
__host__ __device__ constexpr int dkv_floats(int r, int w) {
  return ld_of(w) * (4 * r + 2 * kCols) + 2 * r * kCols + 2 * kCols;
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

// Columns [c0, c0 + w) of rows [row0, row0 + rows) of a [S, dh] matrix of
// T into a float32 shared tile (leading dimension ld_of(w)), each element
// times `mul`, in 16-byte chunks; rows at or past S are zero.
template <typename T>
__device__ void load_rows(float* sm, const T* __restrict__ g, int row0, int rows, int S, int dh,
                          int c0, int w, float mul) {
  constexpr int kPer = 16 / sizeof(T);
  const int per_row = w / kPer, ld = ld_of(w);
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * kPer;
    float* dst = sm + r * ld + c;
    if (row0 + r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * dh + c0 + c);
      unpack(raw, dst, mul, T());
    } else {
#pragma unroll
      for (int e = 0; e < kPer; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Columns [c0, c0 + w) of rows [row0, row0 + rows) of a [S, dh] matrix of
// T from a float32 shared tile (leading dimension ld_of(w)), row r times
// mul * rowmul[r] (rowmul may be null), in 16-byte chunks; rows at or past
// S are not written.
template <typename T>
__device__ void store_rows(T* __restrict__ g, const float* sm, const float* rowmul, int row0,
                           int rows, int S, int dh, int c0, int w, float mul) {
  constexpr int kPer = 16 / sizeof(T);
  const int per_row = w / kPer, ld = ld_of(w);
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * kPer;
    if (row0 + r >= S) continue;
    const float m = rowmul ? mul * rowmul[r] : mul;
    *reinterpret_cast<uint4*>(g + (size_t)(row0 + r) * dh + c0 + c) =
        pack(sm + r * ld + c, m, T());
  }
}

// s[t] += A(row warp + 4 t) . B(row lane) over the w columns of one chunk,
// for the RPW rows a warp owns: B's row is read as float4 by each lane,
// A's broadcast to the warp.
template <int RPW>
__device__ __forceinline__ void scores(float (&s)[RPW], const float* A, const float* B, int w,
                                       int warp, int lane) {
  const int ld = ld_of(w);
  const float* b = B + lane * ld;
  for (int d = 0; d < w; d += 4) {
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
// acc (alpha may be null: 1). P is [R, kCols], B a [kCols, w] tile, acc
// [R, w]. A thread takes a float4 column of kRowGroup rows at a time.
__device__ void accumulate(float* acc, const float* P, const float* alpha, const float* B, int R,
                           int w) {
  const int ld = ld_of(w), cols = w / 4, items = cols * (R / kRowGroup);
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

// A block's place: blockIdx.x runs over (chunk, head, row tile), the chunk
// fastest and the row tile slowest, so that the blocks of one tile launch
// together. Each kernel is built twice: kOne for DH <= kChunk (one chunk,
// so the chunk loops and reloads compile away), and for wider heads.
struct Place {
  int bh, tile, c0, w;  // head, row tile, first column and width of the chunk
};

template <bool kOne>
__device__ __forceinline__ Place place(int BH, int dh) {
  const int n_c = kOne ? 1 : chunks(dh), c = blockIdx.x % n_c, rest = blockIdx.x / n_c;
  return {rest % BH, rest / BH, c * kChunk, kOne ? dh : chunk_width(dh, c)};
}

// Forward: one block per (bh, R-row Q tile, column chunk), the longest
// causal tiles first. K and V tiles of 32 keys stream through shared
// memory; the online softmax keeps each row's max and sum in the
// registers of its warp. The block of chunk 0 writes lse.
template <typename T, int R, bool kOne>
__global__ void __launch_bounds__(kThreads) flash_wide_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ lse, int BH, int S, int dh, int causal, float scale) {
  constexpr int RPW = R / kWarps;
  extern __shared__ float4 smem4[];
  const int W = kOne ? dh : widest(dh), n_d = kOne ? 1 : chunks(dh), ldw = ld_of(W);
  const Place at = place<kOne>(BH, dh);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + R * ldw;
  float* Ks = Os + R * ldw;
  float* Vs = Ks + kCols * ldw;
  float* Ps = Vs + kCols * ldw;
  float* alpha = Ps + R * kCols;
  float* inv_l = alpha + R;
  const int bh = at.bh;
  const int q0 = ((S + R - 1) / R - 1 - at.tile) * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * S * dh;
  if (n_d == 1) load_rows(Qs, q + base, q0, R, S, dh, 0, dh, scale);
  zero(Os, R * ld_of(at.w));
  float m[RPW], l[RPW];
#pragma unroll
  for (int t = 0; t < RPW; ++t) m[t] = -INFINITY, l[t] = 0.f;
  const int k_end = causal ? min(q0 + R, S) : S;
  for (int k0 = 0; k0 < k_end; k0 += kCols) {
    float s[RPW];
#pragma unroll
    for (int t = 0; t < RPW; ++t) s[t] = 0.f;
    for (int d = 0; d < n_d; ++d) {
      const int cd = d * kChunk, wd = chunk_width(dh, d);
      __syncthreads();  // the last tile's readers are done
      if (n_d > 1) load_rows(Qs, q + base, q0, R, S, dh, cd, wd, scale);
      load_rows(Ks, k + base, k0, kCols, S, dh, cd, wd, 1.f);
      if (d == n_d - 1) load_rows(Vs, v + base, k0, kCols, S, dh, at.c0, at.w, 1.f);
      __syncthreads();
      scores<RPW>(s, Qs, Ks, wd, warp, lane);
    }
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
    accumulate(Os, Ps, alpha, Vs, R, at.w);
  }
#pragma unroll
  for (int t = 0; t < RPW; ++t) {
    const int row = warp + kWarps * t;
    const float ls = fmaxf(l[t], 1e-30f);
    if (lane == 0) {
      inv_l[row] = 1.f / ls;
      if (at.c0 == 0 && q0 + row < S) lse[(size_t)bh * S + q0 + row] = m[t] + logf(ls);
    }
  }
  __syncthreads();
  store_rows(out + base, Os, inv_l, q0, R, S, dh, at.c0, at.w, 1.f);
}

// dQ: one block per (bh, R-row Q tile, column chunk), the longest causal
// tiles first. Q (scaled) and dO stay in shared memory at one chunk; per
// 32-key tile S and dP are recomputed in registers, dS goes to shared
// memory and dQ += dS K over the block's chunk.
template <typename T, int R, bool kOne>
__global__ void __launch_bounds__(kThreads) flash_wide_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int BH, int S, int dh, int causal, float scale) {
  constexpr int RPW = R / kWarps;
  extern __shared__ float4 smem4[];
  const int W = kOne ? dh : widest(dh), n_d = kOne ? 1 : chunks(dh), ldw = ld_of(W);
  const Place at = place<kOne>(BH, dh);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + R * ldw;
  float* dQs = dOs + R * ldw;
  float* Ks = dQs + R * ldw;
  float* Vs = Ks + kCols * ldw;
  float* dSs = Vs + kCols * ldw;
  float* lse_s = dSs + R * kCols;
  float* delta_s = lse_s + R;
  const int bh = at.bh;
  const int q0 = ((S + R - 1) / R - 1 - at.tile) * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * S * dh;
  if (n_d == 1) {
    load_rows(Qs, q + base, q0, R, S, dh, 0, dh, scale);
    load_rows(dOs, dout + base, q0, R, S, dh, 0, dh, 1.f);
  }
  zero(dQs, R * ld_of(at.w));
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool ok = q0 + r < S;
    lse_s[r] = ok ? lse[(size_t)bh * S + q0 + r] : 0.f;
    delta_s[r] = ok ? delta[(size_t)bh * S + q0 + r] : 0.f;
  }
  const int k_end = causal ? min(q0 + R, S) : S;
  for (int k0 = 0; k0 < k_end; k0 += kCols) {
    float s[RPW], dp[RPW];
#pragma unroll
    for (int t = 0; t < RPW; ++t) s[t] = dp[t] = 0.f;
    for (int d = 0; d < n_d; ++d) {
      const int cd = d * kChunk, wd = chunk_width(dh, d);
      __syncthreads();
      if (n_d > 1) {
        load_rows(Qs, q + base, q0, R, S, dh, cd, wd, scale);
        load_rows(dOs, dout + base, q0, R, S, dh, cd, wd, 1.f);
      }
      load_rows(Ks, k + base, k0, kCols, S, dh, cd, wd, 1.f);
      load_rows(Vs, v + base, k0, kCols, S, dh, cd, wd, 1.f);
      __syncthreads();
      scores<RPW>(s, Qs, Ks, wd, warp, lane);
      scores<RPW>(dp, dOs, Vs, wd, warp, lane);
    }
    const int key = k0 + lane;
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int row = warp + kWarps * t, qi = q0 + row;
      const bool visible = key < S && qi < S && (!causal || key <= qi);
      const float p = visible ? expf(s[t] - lse_s[row]) : 0.f;
      dSs[row * kCols + lane] = p * (dp[t] - delta_s[row]);
    }
    if (n_d > 1) {  // K at the block's chunk
      __syncthreads();
      load_rows(Ks, k + base, k0, kCols, S, dh, at.c0, at.w, 1.f);
    }
    __syncthreads();
    accumulate(dQs, dSs, nullptr, Ks, R, at.w);
  }
  __syncthreads();
  store_rows(dq + base, dQs, nullptr, q0, R, S, dh, at.c0, at.w, scale);
}

// dK and dV: one block per (bh, R-key block, column chunk), the longest
// causal blocks (the first keys) first. K and V stay in shared memory at
// one chunk, the dK, dV accumulators at the block's chunk; 32-row Q
// (scaled) and dO tiles stream past them; per tile P^T and dS^T are
// recomputed in registers, go to shared memory, and dV += P^T dO, dK +=
// dS^T (scale Q) over the block's chunk.
template <typename T, int R, bool kOne>
__global__ void __launch_bounds__(kThreads) flash_wide_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int BH, int S, int dh, int causal, float scale) {
  constexpr int RPW = R / kWarps;
  extern __shared__ float4 smem4[];
  const int W = kOne ? dh : widest(dh), n_d = kOne ? 1 : chunks(dh), ldw = ld_of(W);
  const Place at = place<kOne>(BH, dh);
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + R * ldw;
  float* dKs = Vs + R * ldw;
  float* dVs = dKs + R * ldw;
  float* Qs = dVs + R * ldw;
  float* dOs = Qs + kCols * ldw;
  float* Pt = dOs + kCols * ldw;
  float* dSt = Pt + R * kCols;
  float* lse_s = dSt + R * kCols;
  float* delta_s = lse_s + kCols;
  const int bh = at.bh;
  const int k0 = at.tile * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * S * dh;
  if (n_d == 1) {
    load_rows(Ks, k + base, k0, R, S, dh, 0, dh, 1.f);
    load_rows(Vs, v + base, k0, R, S, dh, 0, dh, 1.f);
  }
  zero(dKs, R * ldw + R * ld_of(at.w));  // dK and dV
  const int q_begin = causal ? (k0 / kCols) * kCols : 0;
  for (int q0 = q_begin; q0 < S; q0 += kCols) {
    float st[RPW], dpt[RPW];
#pragma unroll
    for (int t = 0; t < RPW; ++t) st[t] = dpt[t] = 0.f;
    for (int d = 0; d < n_d; ++d) {
      const int cd = d * kChunk, wd = chunk_width(dh, d);
      __syncthreads();
      if (n_d > 1) {
        load_rows(Ks, k + base, k0, R, S, dh, cd, wd, 1.f);
        load_rows(Vs, v + base, k0, R, S, dh, cd, wd, 1.f);
      }
      load_rows(Qs, q + base, q0, kCols, S, dh, cd, wd, scale);
      load_rows(dOs, dout + base, q0, kCols, S, dh, cd, wd, 1.f);
      if (d == 0 && threadIdx.x < kCols) {
        const bool ok = q0 + threadIdx.x < S;
        lse_s[threadIdx.x] = ok ? lse[(size_t)bh * S + q0 + threadIdx.x] : 0.f;
        delta_s[threadIdx.x] = ok ? delta[(size_t)bh * S + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      scores<RPW>(st, Ks, Qs, wd, warp, lane);
      scores<RPW>(dpt, Vs, dOs, wd, warp, lane);
    }
    const int qi = q0 + lane;
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int row = warp + kWarps * t, kj = k0 + row;
      const bool visible = qi < S && kj < S && (!causal || kj <= qi);
      const float p = visible ? expf(st[t] - lse_s[lane]) : 0.f;
      Pt[row * kCols + lane] = p;
      dSt[row * kCols + lane] = p * (dpt[t] - delta_s[lane]);
    }
    if (n_d > 1) {  // Q and dO at the block's chunk
      __syncthreads();
      load_rows(Qs, q + base, q0, kCols, S, dh, at.c0, at.w, scale);
      load_rows(dOs, dout + base, q0, kCols, S, dh, at.c0, at.w, 1.f);
    }
    __syncthreads();
    accumulate(dVs, Pt, nullptr, dOs, R, at.w);
    accumulate(dKs, dSt, nullptr, Qs, R, at.w);
  }
  __syncthreads();
  store_rows(dk + base, dKs, nullptr, k0, R, S, dh, at.c0, at.w, 1.f);
  store_rows(dv + base, dVs, nullptr, k0, R, S, dh, at.c0, at.w, 1.f);
}

// The rows a block of each kernel owns at head dim dh: the largest of 64,
// 32, 16 and 8 whose shared memory (chunks of widest(dh) columns) leaves
// room for two blocks an SM, else the largest that fits one. At widest(dh)
// <= kChunk the 8-row blocks fit two an SM, so every dh has one.
inline int rows_for(int (*floats)(int, int), int dh) {
  const int budgets[2] = {kSmemMax / 2, kSmemMax}, rows[4] = {64, 32, 16, 8};
  for (int b : budgets)
    for (int r : rows)
      if (4 * floats(r, widest(dh)) <= b) return r;
  return 0;
}

inline int fwd_f(int r, int w) { return fwd_floats(r, w); }
inline int dq_f(int r, int w) { return dq_floats(r, w); }
inline int dkv_f(int r, int w) { return dkv_floats(r, w); }

inline bool bad_shape(int bh, int s, int dh) {
  return bh <= 0 || s <= 0 || dh <= 128 || dh % 8 != 0;
}

// The grid: one block per (chunk, head, R-row tile); refused past 2^31 - 1
// blocks.
inline bool grid_of(int bh, int s, int dh, int R, unsigned* blocks) {
  const long long n = (long long)chunks(dh) * bh * ((s + R - 1) / R);
  *blocks = (unsigned)n;
  return n <= 0x7fffffffLL;
}

template <typename T, int R, bool kOne>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                       int s, int dh, int causal, float scale, cudaStream_t st) {
  const size_t smem = 4 * (size_t)fwd_floats(R, widest(dh));
  cudaError_t e = allow_smem(flash_wide_fwd_kernel<T, R, kOne>, smem);
  if (e != cudaSuccess) return e;
  unsigned blocks;
  if (!grid_of(bh, s, dh, R, &blocks)) return cudaErrorInvalidValue;
  flash_wide_fwd_kernel<T, R, kOne><<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), bh, s, dh, causal, scale);
  return cudaGetLastError();
}

template <typename T, int R, bool kOne>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int s, int dh,
                      int causal, float scale, cudaStream_t st) {
  const size_t smem = 4 * (size_t)dq_floats(R, widest(dh));
  cudaError_t e = allow_smem(flash_wide_bwd_dq_kernel<T, R, kOne>, smem);
  if (e != cudaSuccess) return e;
  unsigned blocks;
  if (!grid_of(bh, s, dh, R, &blocks)) return cudaErrorInvalidValue;
  flash_wide_bwd_dq_kernel<T, R, kOne><<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), bh, s, dh, causal, scale);
  return cudaGetLastError();
}

template <typename T, int R, bool kOne>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                       int dh, int causal, float scale, cudaStream_t st) {
  const size_t smem = 4 * (size_t)dkv_floats(R, widest(dh));
  cudaError_t e = allow_smem(flash_wide_bwd_dkv_kernel<T, R, kOne>, smem);
  if (e != cudaSuccess) return e;
  unsigned blocks;
  if (!grid_of(bh, s, dh, R, &blocks)) return cudaErrorInvalidValue;
  flash_wide_bwd_dkv_kernel<T, R, kOne><<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), bh, s, dh,
      causal, scale);
  return cudaGetLastError();
}

// LAUNCH<T, R, kOne>(...) for the run-time dtype (is_bf16) and row count R_.
#define WIDE_LAUNCH(LAUNCH, R_, ONE, ...)                                                   \
  switch (R_) {                                                                             \
    case 64: return (int)(is_bf16 ? LAUNCH<__nv_bfloat16, 64, ONE>(__VA_ARGS__)             \
                                  : LAUNCH<float, 64, ONE>(__VA_ARGS__));                   \
    case 32: return (int)(is_bf16 ? LAUNCH<__nv_bfloat16, 32, ONE>(__VA_ARGS__)             \
                                  : LAUNCH<float, 32, ONE>(__VA_ARGS__));                   \
    case 16: return (int)(is_bf16 ? LAUNCH<__nv_bfloat16, 16, ONE>(__VA_ARGS__)             \
                                  : LAUNCH<float, 16, ONE>(__VA_ARGS__));                   \
    case 8: return (int)(is_bf16 ? LAUNCH<__nv_bfloat16, 8, ONE>(__VA_ARGS__)               \
                                 : LAUNCH<float, 8, ONE>(__VA_ARGS__));                     \
    default: return (int)cudaErrorInvalidValue;                                             \
  }

// Returns LAUNCH<T, R, kOne>(...) for the run-time dtype, row count R_ and
// head dim (kOne when dh fits one chunk).
#define WIDE_DISPATCH(LAUNCH, R_, ...)                                                      \
  do {                                                                                      \
    if (dh <= kChunk) {                                                                     \
      WIDE_LAUNCH(LAUNCH, R_, true, __VA_ARGS__)                                            \
    }                                                                                       \
    WIDE_LAUNCH(LAUNCH, R_, false, __VA_ARGS__)                                             \
  } while (0)

}  // namespace wide

}  // namespace flash

// The three entry points take the arguments of dmlc_flash_fwd,
// dmlc_flash_bwd_dq and dmlc_flash_bwd_dkv: tensors [bh, s, dh] (float32,
// or bfloat16 when is_bf16), lse and delta float32 [bh, s]; dh a multiple
// of 8 past 128. Each launches on `stream` and returns the launch's CUDA
// error code.
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
