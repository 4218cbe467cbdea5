// flash_common.cuh: what the three flash-attention kernels share
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Every kernel is one block of kThreads threads per output tile, with its
// operand tiles staged in shared memory and its float32 accumulators kept
// there too, so that the online-softmax rescale and the masks are plain
// per-element loops. The tile products go through gemm(), which has two
// bodies chosen by the element type:
//
// - bfloat16: nvcuda::wmma 16x16x16 bf16 products with float32
//   accumulation (the tensor cores' mma.sync path);
// - float32: register-tiled FMA on the CUDA cores, in full float32 (no
//   TF32), each thread owning a (M/16) x (N/16) grid of outputs.
//
// Shared-memory rows are padded by 16 bytes, which keeps 16-byte vector
// stores and wmma's 32-byte fragment alignment and spreads the rows of a
// column read over the banks. Regions are carved in 128-byte steps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) & ~size_t(127); }

// Leading dimension (elements) of a shared tile of COLS columns of T.
template <typename T, int COLS>
struct Ld {
  static constexpr int value = COLS + 16 / (int)sizeof(T);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

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

// C[M x N] (float32, leading dim ldc) = or += A[M x K] . B[K x N], all in
// shared memory. A(i, k) is A[i * lda + k], or A[k * lda + i] when A_COL;
// B(k, j) is B[k * ldb + j], or B[j * ldb + k] when B_COL. ACC adds to C.
//
// bfloat16: each warp takes 16 x 16 output tiles in turn and runs the K
// loop on the tensor cores (wmma, float32 accumulators).
template <int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
__device__ __forceinline__ void gemm(float* C, int ldc, const bf16* A, int lda, const bf16* B,
                                     int ldb) {
  using namespace nvcuda;
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "wmma tiles are 16 x 16 x 16");
  typedef typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type LayoutA;
  typedef typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type LayoutB;
  constexpr int kTilesN = N / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * kTilesN; t += kWarps) {
    const int tm = t / kTilesN, tn = t - (t / kTilesN) * kTilesN;
    float* cp = C + tm * 16 * ldc + tn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (ACC) {
      wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
    } else {
      wmma::fill_fragment(acc, 0.f);
    }
#pragma unroll 4
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b;
      wmma::load_matrix_sync(a, A_COL ? A + k * lda + tm * 16 : A + tm * 16 * lda + k, lda);
      wmma::load_matrix_sync(b, B_COL ? B + tn * 16 * ldb + k : B + k * ldb + tn * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
  }
}

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

// Sets the dynamic shared-memory limit of `kernel` (needed above 48 KB).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
