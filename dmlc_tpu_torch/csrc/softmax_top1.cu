// softmax_top1: [B, C] float32 logits -> top-1 index (int32 [B]) and top-1
// softmax probability (float32 [B]) in one pass over the logits.
//
// Replaces the TPU kernel dmlc_tpu/ops/pallas_kernels.py:_softmax_top1_kernel
// (public softmax_top1): m = max_j x_j, idx = first j with x_j == m,
// prob = exp(m - m) / sum_j exp(x_j - m) = 1 / sum_j exp(x_j - m).
// The full softmax matrix is never written.
//
// What bounds it on the H100: launch latency. At the serving shape
// [256, 1000] it reads 1 MB and writes 2 KB, a fraction of a microsecond
// of memory traffic and of exp throughput; the few microseconds that a
// kernel launch costs dominate.
//
// What the design does about it: one launch, one warp per row, no shared
// memory and no second pass over device memory. Each lane walks the columns
// lane, lane + 32, ... with coalesced loads, keeping the running maximum and
// its first index; a butterfly of warp shuffles combines the lanes, taking
// the smaller index on ties (jnp.argmax's first-occurrence rule; a NaN
// counts as the maximum, as in jnp.argmax). The second loop over the row
// hits L1/L2 and sums exp(x - m) with the precise expf, another butterfly
// combines the partial sums, and lane 0 writes the index and 1 / z.
// Subtracting the maximum keeps every exp argument <= 0, so extreme logits
// (1e4 next to -1e4) stay finite.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Does (v, i) beat the incumbent (m, mi)? NaN beats any number; among
// equals (and among NaNs) the smaller index wins.
__device__ __forceinline__ bool beats(float v, int i, float m, int mi) {
  const bool vn = isnan(v), mn = isnan(m);
  if (vn || mn) return vn && (!mn || i < mi);
  return v > m || (v == m && i < mi);
}

__global__ void softmax_top1_kernel(const float* __restrict__ logits, int rows,
                                    int cols, int* __restrict__ top_idx,
                                    float* __restrict__ top_prob) {
  const int warps_per_block = blockDim.x >> 5;
  const int row = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  const float* x = logits + (long long)row * cols;

  // From (-inf, INT_MAX) a column equal to -inf still wins on its index, so
  // a row of all -inf reports index 0, as jnp.argmax does.
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

extern "C" int dmlc_softmax_top1(const void* logits, int rows, int cols, void* top_idx,
                                 void* top_prob, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;  // 8 warps: 8 rows per block
  const int rows_per_block = kThreads / 32;
  const unsigned int blocks = (unsigned int)((rows + rows_per_block - 1) / rows_per_block);
  softmax_top1_kernel<<<blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), rows, cols, static_cast<int*>(top_idx),
      static_cast<float*>(top_prob));
  return (int)cudaGetLastError();
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
