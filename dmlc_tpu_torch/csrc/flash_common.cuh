// flash_common.cuh: what the flash-attention kernels share outside
// flash_sm90.cuh (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// - cp.async: 16-byte and 4-byte copies from global into shared memory
//   that run beside the products (commit groups, wait_group), with zero
//   fill past the end of S. The float32 kernels stream their K/V or Q/dO
//   tiles through a ring of them (cp_tile).
// - The float32 row-group tiles of the forward and dq (flash::f32): a
//   block's threads form row groups of 16 (a half-warp each); group g owns
//   query rows g + G i, thread c of it keys c + 16 u of a K/V tile and
//   output columns 64 h + 4 c. dot4 is one 4-column step of a score
//   product (S = Q K^T, dP = dO V^T), pv4 one 4-key step of an output
//   product (O += P V, dQ += dS K); both are full float32 FMA (no TF32).
//   The float32 backward past Dh 256 that takes the head dim at run time
//   reads its operands in 64-column slabs (cp_span, dot4_lda, pv4_step).
// - Half-warp reductions, barriers between the warps of two parts, and the
//   dynamic shared-memory limit.
// - That backward's column chunks (xl_chunks, xl_width, by_width) and the
//   thread-block clusters their blocks form (xl_cluster, launch_clustered,
//   cluster_sync, peer_ld).
//
// Shared-memory rows are padded by 16 bytes, which keeps 16-byte vector
// reads and stores and spreads the rows of a column read over the banks.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

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

// Starts copying columns [c0, c0 + ncols) of rows [row0, row0 + rows) of a
// row-major float32 matrix of S rows and row stride ldg into a shared tile
// of row stride ld, 16 bytes a copy over NT threads; a row at or past S and
// a column at or past `end` are zero (the float32 backward past Dh 256,
// which takes Dh at run time and reads its operands in 64-column slabs).
template <int NT>
__device__ __forceinline__ void cp_span(float* __restrict__ sm, int ld, const float* __restrict__ g,
                                        int ldg, int row0, int rows, int S, int c0, int ncols,
                                        int end) {
  const int per_row = ncols / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, cc = (i - r * per_row) * 4;
    const bool ok = row0 + r < S && c0 + cc < end;
    cp_async16(sm + r * ld + cc, g + (ok ? (size_t)(row0 + r) * ldg + c0 + cc : 0), ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------- float32 row-group tiles

namespace f32 {

// One 4-column step of s[i][u] += A(row g + G i) . B(row c + 16 u): A and
// B point at the step's first column of shared tiles of leading dimension
// LD. A's rows are read as float4 broadcast across the half-warp, B's as
// float4 by each thread.
// dot4_lda: the same with A of row stride lda, which may be known only at
// run time (a resident tile whose width is the head dim), and B of LDB.
template <int RPT, int NKT, int G, int LDB>
__device__ __forceinline__ void dot4_lda(float (&s)[RPT][NKT], const float* A, int lda,
                                         const float* B, int g, int c) {
  float4 b[NKT];
#pragma unroll
  for (int u = 0; u < NKT; ++u) b[u] = ld4(B + (c + 16 * u) * LDB);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float4 a = ld4(A + (g + G * i) * lda);
#pragma unroll
    for (int u = 0; u < NKT; ++u) {
      s[i][u] = fmaf(a.x, b[u].x, s[i][u]);
      s[i][u] = fmaf(a.y, b[u].y, s[i][u]);
      s[i][u] = fmaf(a.z, b[u].z, s[i][u]);
      s[i][u] = fmaf(a.w, b[u].w, s[i][u]);
    }
  }
}

template <int RPT, int NKT, int G, int LD>
__device__ __forceinline__ void dot4(float (&s)[RPT][NKT], const float* A, const float* B, int g,
                                     int c) {
  dot4_lda<RPT, NKT, G, LD>(s, A, LD, B, g, c);
}

// One 4-key step of o[i][h][e] += sum_e' P(row g + G i, key e') B(key e',
// column 64 h + 4 c + e): P points at the step's first key column of a
// shared [rows, keys] tile of leading dimension LDP (read as float4,
// broadcast across the half-warp), B at the step's first key row of a
// shared [keys, DH] tile of leading dimension LD.
template <int RPT, int NC4, int G, int LDP, int LD>
__device__ __forceinline__ void pv4(float (&o)[RPT][NC4][4], const float* P, const float* B, int g,
                                    int c) {
  float4 bv[4][NC4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int h = 0; h < NC4; ++h) bv[e][h] = ld4(B + e * LD + 64 * h + 4 * c);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float4 a = ld4(P + (g + G * i) * LDP);
    const float pa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int h = 0; h < NC4; ++h) {
        o[i][h][0] = fmaf(pa[e], bv[e][h].x, o[i][h][0]);
        o[i][h][1] = fmaf(pa[e], bv[e][h].y, o[i][h][1]);
        o[i][h][2] = fmaf(pa[e], bv[e][h].z, o[i][h][2]);
        o[i][h][3] = fmaf(pa[e], bv[e][h].w, o[i][h][3]);
      }
  }
}

// pv4 over one 64-column step: o[i][e] += sum_e' P(row g + G i, key e')
// B(key e', column 4 c + e), B a 64-column slab of row stride LDB.
template <int RPT, int G, int LDP, int LDB>
__device__ __forceinline__ void pv4_step(float (&o)[RPT][4], const float* P, const float* B, int g,
                                         int c) {
  float4 bv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) bv[e] = ld4(B + e * LDB + 4 * c);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float4 a = ld4(P + (g + G * i) * LDP);
    const float pa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[i][0] = fmaf(pa[e], bv[e].x, o[i][0]);
      o[i][1] = fmaf(pa[e], bv[e].y, o[i][1]);
      o[i][2] = fmaf(pa[e], bv[e].z, o[i][2]);
      o[i][3] = fmaf(pa[e], bv[e].w, o[i][3]);
    }
  }
}

}  // namespace f32

// Named barrier `id` (1-15) over one warp of each of two 128-thread parts
// (64 threads): the float32 kernels past Dh 128, whose warp w of each part
// holds the same rows. pair_arrive goes on; pair_sync waits until all 64
// have arrived. Shared-memory writes before the arrival are seen by the
// waiting threads after it.
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// Thread-block clusters (sm_90): the float32 backward past Dh 256 makes
// the blocks of one row tile's column chunks a cluster, each block making
// the scores over its own slabs of Dh, and adds the blocks' partial scores
// through distributed shared memory. cluster_sync is a barrier over every
// thread of the cluster (shared-memory writes before it are seen by every
// block after it); peer_ld reads this block's shared address p as it lies
// in block `rank` of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float peer_ld(const float* p, uint32_t rank) {
  uint32_t addr;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(shared_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// The blocks of a cluster of `chunks` column chunks (a power of two): at
// most 8, the portable cluster size.
__host__ __device__ constexpr int xl_cluster(int chunks) { return chunks < 8 ? chunks : 8; }

// Launches kernel(args...) on `blocks` blocks of `threads` threads with
// `smem` bytes of dynamic shared memory, in clusters of `cluster` blocks.
template <typename... Kernel, typename... Args>
inline cudaError_t launch_clustered(void (*kernel)(Kernel...), unsigned blocks, unsigned threads,
                                    size_t smem, int cluster, cudaStream_t stream,
                                    Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Kernel>(args)...);
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

// The backward past Dh 256 cuts its output into column chunks of at most
// `chunk` 64-column steps, as evenly as whole steps allow, in a power of
// two of chunks where their blocks form clusters (xl_chunks; clusters run
// best in powers of two), else in as few as fit (xl_chunks_of, pow2
// false), and shares a chunk's steps between `parts` parts (1: each part
// holds the chunk's every step). xl_width is the steps the widest part
// holds at nb steps of Dh; xl_width_bound the least (or, with `most`, the
// largest) of it over the head dims past 256 up to 16384 (5 to 256 steps):
// the instantiations a kernel builds.
__host__ __device__ constexpr int xl_chunks(int nb, int chunk) {
  int n = 1;
  while (n * chunk < nb) n *= 2;
  return n;
}

__host__ __device__ constexpr int xl_chunks_of(int nb, int chunk, bool pow2) {
  return pow2 ? xl_chunks(nb, chunk) : (nb + chunk - 1) / chunk;
}

__host__ __device__ constexpr int xl_width(int nb, int chunk, int parts, bool pow2 = true) {
  return ((nb + xl_chunks_of(nb, chunk, pow2) - 1) / xl_chunks_of(nb, chunk, pow2) + parts - 1) /
         parts;
}

__host__ __device__ constexpr int xl_width_bound(int chunk, int parts, bool most,
                                                 bool pow2 = true) {
  int w = xl_width(5, chunk, parts, pow2);
  for (int nb = 6; nb <= 256; ++nb) {
    const int x = xl_width(nb, chunk, parts, pow2);
    w = most ? (x > w ? x : w) : (x < w ? x : w);
  }
  return w;
}

// f(std::integral_constant<int, W>()) for the W of [LO, HI] equal to w;
// cudaErrorInvalidValue where none is.
template <int LO, int HI, typename F>
inline cudaError_t by_width(int w, F&& f) {
  if constexpr (LO > HI)
    return cudaErrorInvalidValue;
  else
    return w == LO ? f(std::integral_constant<int, LO>()) : by_width<LO + 1, HI>(w, f);
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
