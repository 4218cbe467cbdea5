// gather_pages: pool pages gathered by a flat page-id vector into one
// contiguous per-slot view of the paged KV cache.
//
// Replaces the TPU kernel dmlc_tpu/ops/ragged_decode.py:_gather_pages_pallas
// (body copy_kernel, public gather_kv_pages(use_pallas=True)). There the
// page table is brought into SMEM by scalar prefetch and the input
// BlockSpec's index map DMAs pool page table[j] into output slot j, one
// page per grid cell; the body is a straight block copy. Here each block
// reads its own page id and copies (part of) that page.
//
// Layout: the pool is [num_pages, page_bytes] and the output
// [n_out, page_bytes], where page_bytes = page_size * H * Dh * element
// size; output page j is pool page ids[j]. The kernel copies bytes, so it
// serves every dtype.
//
// What bounds it on the H100: memory. Each output byte is one pool byte
// read and one byte written, with no arithmetic; the bound is
// 2 * n_out * page_bytes at 3.35 TB/s. At lm_wide's serving shape (64
// output pages of 16 x 512 f32, 2.1 MB out) that is 1.25 us, below a
// kernel launch; at the bench-decode shape (128 pages of 64 x 768 f32,
// 25.2 MB out) 15.0 us.
//
// What the design does about it: a grid of (output page, chunk of the
// page). Blocks of 256 threads each move 256 * 4 vectors of 16 bytes: a
// thread issues its four 16-byte loads before its four stores, so each
// thread keeps 64 bytes in flight, and neighbouring threads touch
// neighbouring addresses (coalesced 512-byte warp transactions). The page
// id is one 4-byte load per block, served from L1/L2 after the first warp.
// When either pointer or the page's byte length is not a multiple of 16 a
// grid-stride byte loop does the same copy. An id outside [0, num_pages)
// is never read from the pool: its output page is written as zeros. The
// caller validates the table on the host before it reaches the card, so
// that guard only keeps a bad table from reading outside the pool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kVecsPerBlock = (long long)kThreads * kUnroll;
constexpr unsigned int kMaxGridY = 65535u;

__global__ void gather_pages_vec16_kernel(const uint4* __restrict__ pool,
                                          const int* __restrict__ ids,
                                          uint4* __restrict__ out, long long page_vecs,
                                          int num_pages) {
  const long long j = blockIdx.x;
  const int id = ids[j];
  uint4* dst = out + j * page_vecs;
  const long long base = (long long)blockIdx.y * kVecsPerBlock + threadIdx.x;
  if (id < 0 || id >= num_pages) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < page_vecs) dst[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const uint4* src = pool + (long long)id * page_vecs;
  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + (long long)u * kThreads;
    if (i < page_vecs) v[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + (long long)u * kThreads;
    if (i < page_vecs) dst[i] = v[u];
  }
}

__global__ void gather_pages_bytes_kernel(const unsigned char* __restrict__ pool,
                                          const int* __restrict__ ids,
                                          unsigned char* __restrict__ out, long long page_bytes,
                                          int num_pages) {
  const long long j = blockIdx.x;
  const int id = ids[j];
  unsigned char* dst = out + j * page_bytes;
  const bool valid = id >= 0 && id < num_pages;
  const unsigned char* src = pool + (valid ? (long long)id : 0LL) * page_bytes;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x; i < page_bytes;
       i += stride) {
    dst[i] = valid ? src[i] : (unsigned char)0;
  }
}

}  // namespace

// pool: [num_pages, page_bytes] bytes; ids: int32 [n_out]; out: [n_out,
// page_bytes] bytes. Launches on `stream` and returns cudaGetLastError().
extern "C" int dmlc_gather_pages(const void* pool, int num_pages, long long page_bytes,
                                 const void* ids, int n_out, void* out, void* stream) {
  if (num_pages <= 0 || page_bytes <= 0 || n_out <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(pool) | reinterpret_cast<uintptr_t>(out) |
                         (uintptr_t)page_bytes) & 15u) == 0;
  if (aligned) {
    const long long page_vecs = page_bytes / 16;
    const long long chunks = (page_vecs + kVecsPerBlock - 1) / kVecsPerBlock;
    if (chunks > (long long)kMaxGridY) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned int)n_out, (unsigned int)chunks);
    gather_pages_vec16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(pool), static_cast<const int*>(ids), static_cast<uint4*>(out),
        page_vecs, num_pages);
  } else {
    long long chunks = (page_bytes + kThreads - 1) / kThreads;
    if (chunks > (long long)kMaxGridY) chunks = kMaxGridY;  // the loop strides the rest
    const dim3 grid((unsigned int)n_out, (unsigned int)chunks);
    gather_pages_bytes_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(pool), static_cast<const int*>(ids),
        static_cast<unsigned char*>(out), page_bytes, num_pages);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
