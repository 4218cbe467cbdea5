// flash_common.cuh: what the flash-attention kernels share outside
// flash_sm90.cuh (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// - cp.async: 16-byte and 4-byte copies from global into shared memory
//   that run beside the products (commit groups, wait_group), with zero
//   fill past the end of S. The float32 forward and dK/dV stream their
//   K/V or Q/dO tiles through a 2-stage ring of them (cp_tile).
// - The float32 dq kernel's first design: one block of kThreads threads per
//   output tile, operand tiles staged in shared memory with synchronous
//   loads (load_tile), float32 accumulators kept there too, and the tile
//   products on register-tiled FMA (gemm(), full float32, no TF32), each
//   thread owning a (M/16) x (N/16) grid of outputs.
//
// Shared-memory rows are padded by 16 bytes, which keeps 16-byte vector
// stores and spreads the rows of a column read over the banks. Regions are
// carved in 128-byte steps.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) & ~size_t(127); }

// Leading dimension (elements) of a shared tile of COLS columns of T.
template <typename T, int COLS>
struct Ld {
  static constexpr int value = COLS + 16 / (int)sizeof(T);
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Hands out consecutive 128-byte-aligned regions of dynamic shared memory.
struct SmemCursor {
  unsigned char* p;
  template <typename T>
  __device__ __forceinline__ T* take(int count) {
    T* out = reinterpret_cast<T*>(p);
    p += round128((size_t)count * sizeof(T));
    return out;
  }
};

// Rows [row0, row0 + R) of a row-major [S, DH] matrix into a shared tile
// with leading dimension LD, 16 bytes a thread; rows at or past S are zero.
template <typename T, int R, int DH, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ sm, const T* __restrict__ g, int row0,
                                          int S) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPerRow = DH / kVec;
  static_assert(DH % kVec == 0, "a row must be whole 16-byte vectors");
#pragma unroll 4
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = __ldg(reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * DH + c));
    *reinterpret_cast<uint4*>(sm + r * LD + c) = val;
  }
}

// Entries [row0, row0 + R) of a float32 row vector; past S they are 0.
template <int R>
__device__ __forceinline__ void load_rows(float* __restrict__ sm, const float* __restrict__ g,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < R; r += kThreads) sm[r] = row0 + r < S ? g[row0 + r] : 0.f;
}

// C[M x N] (float32, leading dim ldc) = or += A[M x K] . B[K x N], all in
// shared memory. A(i, k) is A[i * lda + k], or A[k * lda + i] when A_COL;
// B(k, j) is B[k * ldb + j], or B[j * ldb + k] when B_COL. ACC adds to C.
//
// float32: the 256 threads form a 16 x 16 grid; thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j, and runs the K loop with one FMA per
// (row, column) pair, in full float32.
template <int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
__device__ __forceinline__ void gemm(float* C, int ldc, const float* A, int lda, const float* B,
                                     int ldb) {
  static_assert(kThreads == 256, "the float32 product lays threads out as 16 x 16");
  static_assert(M % 16 == 0 && N % 16 == 0, "M and N are multiples of 16");
  constexpr int RM = M / 16, RN = N / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = ACC ? C[(ty + 16 * i) * ldc + tx + 16 * j] : 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = A_COL ? A[k * lda + ty + 16 * i] : A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = B_COL ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) C[(ty + 16 * i) * ldc + tx + 16 * j] = acc[i][j];
}

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from g to sm; zeros when !valid (g is then not read).
__device__ __forceinline__ void cp_async16(void* sm, const void* g, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_u32(sm)), "l"(g),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from g to sm; zero when !valid.
__device__ __forceinline__ void cp_async4(void* sm, const void* g, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_u32(sm)), "l"(g),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying rows [row0, row0 + R) of a row-major float32 [S, DH]
// matrix into a shared tile with leading dimension LD, 16 bytes a copy
// over NT threads; rows at or past S are zero.
template <int R, int DH, int LD, int NT>
__device__ __forceinline__ void cp_tile(float* __restrict__ sm, const float* __restrict__ g,
                                        int row0, int S) {
  constexpr int kPerRow = DH / 4;
#pragma unroll
  for (int i = threadIdx.x; i < R * kPerRow; i += NT) {
    const int r = i / kPerRow, c = (i - r * kPerRow) * 4;
    const bool ok = row0 + r < S;
    cp_async16(sm + r * LD + c, g + (size_t)(ok ? row0 + r : 0) * DH + c, ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Max and sum over the 16 lanes of a half-warp (the threads of one row
// group in the float32 kernels).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sets the dynamic shared-memory limit of `kernel` (needed above 48 KB).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
