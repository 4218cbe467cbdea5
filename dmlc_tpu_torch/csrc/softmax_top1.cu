// softmax_top1: [B, C] float32, bfloat16 or float16 logits -> top-1 index
// (int32 [B]) and top-1 softmax probability (float32 [B]), the softmax
// matrix never written.
//
// Replaces the TPU kernel dmlc_tpu/ops/pallas_kernels.py:_softmax_top1_kernel
// (public softmax_top1), which casts the logits to float32 and computes
// m = max_j x_j, idx = first j with x_j == m (jnp.argmax: a NaN counts as
// the maximum) and prob = exp(m - m) / sum_j exp(x_j - m) = 1 / sum_j
// exp(x_j - m).
//
// What bounds it on the H100: bytes and launch latency. At the serving
// shape [256, 1000] float32 it reads 1 MB and writes 2 KB, 0.3 us at the
// card's memory rate, which is less than the few microseconds any launch
// takes; what is left to a design is how many round trips to memory a row
// costs and how much of the card waits on them.
//
// What the design does about it: each row is read from memory once, by a
// group of kRowThreads threads (one block) on its own SM, so [256, 1000]
// spreads over every SM. The row splits into a head of scalars up to the
// first 16-byte boundary, a body of 16-byte vectors (4 float32 or 8
// bfloat16/float16 values), neighbouring threads on neighbouring vectors,
// and a tail of scalars; every thread issues all its loads before it uses
// any, and the values stay in registers, each converted to float32 exactly
// as it is used. The maximum with its first index (beats: NaN above any
// number, the smaller index among equals) and then sum exp(x - m), with the
// precise expf, are reduced from those registers: warp shuffles, then one
// step through shared memory across the group's warps in warp order, so the
// bits are the same from run to run. The result is the plain formula
// 1 / sum exp(x - m), no online rescaling. Subtracting the maximum keeps
// every exp argument <= 0, so extreme logits (1e4 next to -1e4) stay
// finite. Rows too long for the registers (more than kMaxLoads vectors a
// thread) take a chunked loop that reads the row twice and sums each
// thread's share in double (hundreds of terms a thread at 32768 columns).
//
// The launch is programmatic (cudaLaunchKernelEx with programmatic stream
// serialization): the kernel may start while the kernel before it on the
// stream (on the serve path, the logits' cast to float32) ends, and every
// thread waits (griddepcontrol.wait) for that kernel's writes before it
// reads the logits or writes anything.
//
// softmax_top1_warp_kernel, the design this replaced (a warp a row, 4-byte
// loads, the row read a second time for the sum; float32 only), the vector
// kernel launched without the programmatic launch, and an empty kernel (the
// floor a launch pays) stay reachable through their own entry points for
// timing; no wrapper calls them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The layout: threads a row, and rows a block (more than one only with a
// warp a row).
constexpr int kRowThreads = 128;
constexpr int kRowsPerBlock = 1;
// 16-byte loads a thread at most on the register path.
constexpr int kMaxLoads = 8;
constexpr int kWarps = kRowThreads / 32;
static_assert(kRowThreads % 32 == 0 && kRowThreads <= 1024, "whole warps a row");
static_assert(kRowsPerBlock == 1 || kRowThreads == 32, "several rows a block only a warp a row");

// Wait for the grids before this one on the stream to finish and their
// writes to be visible (a no-op without the programmatic launch).
__device__ __forceinline__ void wait_for_prior_grids() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Does (v, i) beat the incumbent (m, mi)? NaN beats any number; among
// equals (and among NaNs) the smaller index wins.
__device__ __forceinline__ bool beats(float v, int i, float m, int mi) {
  const bool vn = isnan(v), mn = isnan(m);
  if (vn || mn) return vn && (!mn || i < mi);
  return v > m || (v == m && i < mi);
}

// Element `e` of a 16-byte vector of T, as float32 (exact for every T).
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int e);

template <>
__device__ __forceinline__ float elem<float>(const uint4& u, int e) {
  const uint32_t w = e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w;
  return __uint_as_float(w);
}

template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int e) {
  const int k = e >> 1;
  const uint32_t w = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <>
__device__ __forceinline__ float elem<__half>(const uint4& u, int e) {
  const int k = e >> 1;
  const uint32_t w = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
  return __half2float(__ushort_as_half((unsigned short)((e & 1) ? (w >> 16) : (w & 0xffffu))));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

struct GroupSmem {
  float m[kWarps];
  int i[kWarps];
  float z[kWarps];
};

// The group's maximum and its first index, in every thread of the group.
__device__ __forceinline__ void group_top(float& m, int& mi, GroupSmem& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const int omi = __shfl_xor_sync(0xffffffffu, mi, off);
    if (beats(om, omi, m, mi)) {
      m = om;
      mi = omi;
    }
  }
  if (kWarps > 1) {
    const int warp = (threadIdx.x % kRowThreads) >> 5;
    if ((threadIdx.x & 31) == 0) {
      s.m[warp] = m;
      s.i[warp] = mi;
    }
    __syncthreads();
    m = s.m[0];
    mi = s.i[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (beats(s.m[w], s.i[w], m, mi)) {
        m = s.m[w];
        mi = s.i[w];
      }
    }
  }
}

// The group's sum of z, in its thread 0.
__device__ __forceinline__ float group_sum(float z, GroupSmem& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
  if (kWarps > 1) {
    const int warp = (threadIdx.x % kRowThreads) >> 5;
    if ((threadIdx.x & 31) == 0) s.z[warp] = z;
    __syncthreads();
    z = s.z[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) z += s.z[w];
  }
  return z;
}

// The register path: each thread holds at most LOADS vectors of its row.
template <typename T, int LOADS>
__global__ void __launch_bounds__(kRowThreads* kRowsPerBlock)
    softmax_top1_vec_kernel(const T* __restrict__ logits, int rows, int cols,
                            int* __restrict__ top_idx, float* __restrict__ top_prob) {
  constexpr int E = 16 / sizeof(T);  // values a vector
  __shared__ GroupSmem smem;
  wait_for_prior_grids();
  const int t = threadIdx.x % kRowThreads;  // the thread's place in its row's group
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kRowThreads;
  if (kRowsPerBlock > 1 && row >= rows) return;  // a whole warp; no barrier follows
  const T* x = logits + (long long)row * cols;
  const int head = min(cols, (int)((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / (int)sizeof(T));
  const int nvec = (cols - head) / E;
  const int tail = cols - head - nvec * E;
  const uint4* body = reinterpret_cast<const uint4*>(x + head);

  uint4 v[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    if (t + k * kRowThreads < nvec) v[k] = __ldg(body + t + k * kRowThreads);
  }
  const float hv = t < head ? to_float(x[t]) : 0.0f;
  const int ti = head + nvec * E + t;
  const float tv = t < tail ? to_float(x[ti]) : 0.0f;

  // From (-inf, INT_MAX) a column equal to -inf still wins on its index, so
  // a row of all -inf reports index 0, as jnp.argmax does.
  float m = -INFINITY;
  int mi = 0x7fffffff;
  if (t < head && beats(hv, t, m, mi)) {
    m = hv;
    mi = t;
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int j = t + k * kRowThreads;
    if (j < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a = elem<T>(v[k], e);
        if (beats(a, head + j * E + e, m, mi)) {
          m = a;
          mi = head + j * E + e;
        }
      }
    }
  }
  if (t < tail && beats(tv, ti, m, mi)) {
    m = tv;
    mi = ti;
  }
  group_top(m, mi, smem);

  float z = t < head ? expf(hv - m) : 0.0f;
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    if (t + k * kRowThreads < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) z += expf(elem<T>(v[k], e) - m);
    }
  }
  if (t < tail) z += expf(tv - m);
  z = group_sum(z, smem);
  if (t == 0) {
    top_idx[row] = mi;
    top_prob[row] = 1.0f / z;
  }
}

// Rows too long for the registers: the same group reads the row in a
// chunked loop, once for the maximum and once more for the sum.
template <typename T>
__global__ void __launch_bounds__(kRowThreads* kRowsPerBlock)
    softmax_top1_long_kernel(const T* __restrict__ logits, int rows, int cols,
                             int* __restrict__ top_idx, float* __restrict__ top_prob) {
  __shared__ GroupSmem smem;
  wait_for_prior_grids();
  const int t = threadIdx.x % kRowThreads;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kRowThreads;
  if (kRowsPerBlock > 1 && row >= rows) return;
  const T* x = logits + (long long)row * cols;
  float m = -INFINITY;
  int mi = 0x7fffffff;
  for (int j = t; j < cols; j += kRowThreads) {
    const float a = to_float(x[j]);
    if (beats(a, j, m, mi)) {
      m = a;
      mi = j;
    }
  }
  group_top(m, mi, smem);
  double z = 0.0;
  for (int j = t; j < cols; j += kRowThreads) z += expf(to_float(x[j]) - m);
  const float total = group_sum((float)z, smem);
  if (t == 0) {
    top_idx[row] = mi;
    top_prob[row] = 1.0f / total;
  }
}

template <typename K, typename... A>
cudaError_t launch(K kernel, unsigned int blocks, cudaStream_t stream, bool programmatic,
                   A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kRowThreads * kRowsPerBlock);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = programmatic ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
int launch_top1(const void* logits, int rows, int cols, void* top_idx, void* top_prob,
                void* stream, bool programmatic = true) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(logits);
  int* idx = static_cast<int*>(top_idx);
  float* prob = static_cast<float*>(top_prob);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned int blocks = (unsigned int)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  // Vectors a thread holds at most, whatever the row's head.
  const int loads = (cols / (16 / (int)sizeof(T)) + kRowThreads - 1) / kRowThreads;
  cudaError_t rc;
  if (loads <= 1)
    rc = launch(softmax_top1_vec_kernel<T, 1>, blocks, s, programmatic, x, rows, cols, idx, prob);
  else if (loads <= 2)
    rc = launch(softmax_top1_vec_kernel<T, 2>, blocks, s, programmatic, x, rows, cols, idx, prob);
  else if (loads <= 4)
    rc = launch(softmax_top1_vec_kernel<T, 4>, blocks, s, programmatic, x, rows, cols, idx, prob);
  else if (loads <= kMaxLoads)
    rc = launch(softmax_top1_vec_kernel<T, kMaxLoads>, blocks, s, programmatic, x, rows, cols, idx, prob);
  else
    rc = launch(softmax_top1_long_kernel<T>, blocks, s, programmatic, x, rows, cols, idx, prob);
  return (int)rc;
}

extern "C" int dmlc_softmax_top1(const void* logits, int rows, int cols, void* top_idx,
                                 void* top_prob, void* stream) {
  return launch_top1<float>(logits, rows, cols, top_idx, top_prob, stream);
}

extern "C" int dmlc_softmax_top1_bf16(const void* logits, int rows, int cols, void* top_idx,
                                      void* top_prob, void* stream) {
  return launch_top1<__nv_bfloat16>(logits, rows, cols, top_idx, top_prob, stream);
}

extern "C" int dmlc_softmax_top1_f16(const void* logits, int rows, int cols, void* top_idx,
                                     void* top_prob, void* stream) {
  return launch_top1<__half>(logits, rows, cols, top_idx, top_prob, stream);
}

// The vector kernel launched without the programmatic launch, kept for
// timing the launch against it.
extern "C" int dmlc_softmax_top1_nopdl(const void* logits, int rows, int cols, void* top_idx,
                                       void* top_prob, void* stream) {
  return launch_top1<float>(logits, rows, cols, top_idx, top_prob, stream, false);
}

// The design the vector kernel replaced, kept for timing: one warp a row,
// 8 rows a block, each lane walking its row at stride 32 in 4-byte loads
// and a second time (from L1/L2) for the sum.
__global__ void softmax_top1_warp_kernel(const float* __restrict__ logits, int rows, int cols,
                                         int* __restrict__ top_idx,
                                         float* __restrict__ top_prob) {
  const int warps_per_block = blockDim.x >> 5;
  const int row = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const float* x = logits + (long long)row * cols;
  float m = -INFINITY;
  int mi = 0x7fffffff;
  for (int j = lane; j < cols; j += 32) {
    const float v = x[j];
    if (beats(v, j, m, mi)) {
      m = v;
      mi = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const int omi = __shfl_xor_sync(0xffffffffu, mi, off);
    if (beats(om, omi, m, mi)) {
      m = om;
      mi = omi;
    }
  }
  float z = 0.0f;
  for (int j = lane; j < cols; j += 32) z += expf(x[j] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
  if (lane == 0) {
    top_idx[row] = mi;
    top_prob[row] = 1.0f / z;
  }
}

extern "C" int dmlc_softmax_top1_warp(const void* logits, int rows, int cols, void* top_idx,
                                      void* top_prob, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;  // 8 warps: 8 rows a block
  softmax_top1_warp_kernel<<<(rows + 7) / 8, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), rows, cols, static_cast<int*>(top_idx),
      static_cast<float*>(top_prob));
  return (int)cudaGetLastError();
}

// An empty kernel of one warp: the device time any launch pays.
__global__ void launch_floor_kernel() {}

extern "C" int dmlc_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
