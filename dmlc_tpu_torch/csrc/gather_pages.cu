// gather_pages: pool pages gathered by a flat page-id vector into one
// contiguous per-slot view of the paged KV cache.
//
// Replaces the TPU kernel dmlc_tpu/ops/ragged_decode.py:_gather_pages_pallas
// (body copy_kernel, public gather_kv_pages(use_pallas=True)). There the
// page table is brought into SMEM by scalar prefetch and the input
// BlockSpec's index map DMAs pool page table[j] into output slot j, one
// page per grid cell; the body is a straight block copy. Here Hopper's bulk
// copy engine (cp.async.bulk, the TMA's one-dimensional form) takes the
// place of that DMA.
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
// What the design does about it (gather_pages_bulk_kernel): the work items
// are (output page, chunk of kChunkBytes of that page). A persistent grid
// of at most kBlocksPerSm blocks an SM walks them in order, block b taking
// items b, b + grid, ... Each block is one warp. Lane 0 moves the bytes:
// it loads a chunk from the pool into a ring of kStages chunk buffers in
// shared memory (cp.async.bulk global -> shared, completing on the stage's
// mbarrier with its byte count), and once the chunk has landed stores it
// to the output (cp.async.bulk shared -> global, one bulk group a chunk).
// Loads run kStages - 1 items ahead of the stores; a stage is loaded again
// only after cp.async.bulk.wait_group.read has seen its last store read
// it. No thread touches the data, so a block keeps up to kStages chunks in
// flight with one thread. The warp reads the page ids 32 items at a time,
// one lane an item, and hands each to lane 0 by a shuffle: each item's id
// is read once.
//
// An id outside [0, num_pages) is never read from the pool: its chunk is
// stored from a zero chunk in shared memory, which the warp writes once a
// block and fences to the async proxy once. The caller validates the table
// on the host before it reaches the card, so that guard only keeps a bad
// table from reading outside the pool.
//
// The bulk engine needs 16-byte-aligned addresses and sizes that are
// multiples of 16: the kernel runs when both pointers and page_bytes are
// (every chunk then starts and ends on 16 bytes). Otherwise a grid-stride
// byte loop (gather_pages_bytes_kernel) does the same copy.
// gather_pages_vec16_kernel is the design the bulk kernel replaced (a grid
// of (output page, chunk), 256 threads each moving four 16-byte vectors);
// it stays reachable through dmlc_gather_pages_vec16 so that the two can
// be timed side by side.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kVecsPerBlock = (long long)kThreads * kUnroll;
constexpr unsigned int kMaxGridY = 65535u;

// The bulk-copy design.
constexpr int kChunkBytes = 16384;
constexpr int kStages = 4;
constexpr int kBlocksPerSm = 2;
constexpr int kBulkThreads = 32;
// Dynamic shared memory a block takes: the ring and the zero chunk.
constexpr int kBulkSmemBytes = (kStages + 1) * kChunkBytes;
static_assert(kChunkBytes % 16 == 0, "a bulk copy moves a multiple of 16 bytes");
static_assert(kStages >= 2 && kStages <= 32, "the ring's valid bits live in one word");
static_assert(kBulkSmemBytes <= 232448, "the ring must fit a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to expect `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` from global `src` into shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` from shared `src` to global `dst`, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kBulkThreads)
    gather_pages_bulk_kernel(const unsigned char* __restrict__ pool, const int* __restrict__ ids,
                             unsigned char* __restrict__ out, long long page_bytes,
                             long long chunks, long long items, int num_pages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  unsigned char* zero = ring + (size_t)kStages * kChunkBytes;
  const int lane = threadIdx.x;
  const long long first = blockIdx.x, step = gridDim.x;
  const long long mine = (items - first + step - 1) / step;  // this block's items
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // Lane l holds the page id of item 32 * window + l of this block.
  long long window = -1;
  int lane_id = 0;
  uint32_t valid = 0;  // bit s: stage s holds pool bytes (else its item stores zeros)
  auto load = [&](long long k) {  // every lane, the same k
    if ((k >> 5) != window) {
      window = k >> 5;
      const long long kk = (window << 5) + lane;
      lane_id = kk < mine ? ids[(first + kk * step) / chunks] : 0;
    }
    const int id = __shfl_sync(0xffffffffu, lane_id, (int)(k & 31));
    const int s = (int)(k % kStages);
    const long long off = ((first + k * step) % chunks) * kChunkBytes;
    const uint32_t bytes = (uint32_t)min((long long)kChunkBytes, page_bytes - off);
    const bool ok = id >= 0 && id < num_pages;
    if (lane == 0) {
      if (ok) {
        mbar_expect(&full[s], bytes);
        bulk_load(ring + (size_t)s * kChunkBytes, pool + (long long)id * page_bytes + off, bytes,
                  &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    valid = ok ? (valid | (1u << s)) : (valid & ~(1u << s));
  };

  for (long long k = 0; k < mine && k < kStages - 1; ++k) load(k);
  for (int i = lane * 16; i < kChunkBytes; i += kBulkThreads * 16)
    *reinterpret_cast<uint4*>(zero + i) = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();

  for (long long k = 0; k < mine; ++k) {
    const int s = (int)(k % kStages);
    const long long item = first + k * step;
    const long long j = item / chunks;
    const long long off = (item - j * chunks) * kChunkBytes;
    const uint32_t bytes = (uint32_t)min((long long)kChunkBytes, page_bytes - off);
    mbar_wait(&full[s], (uint32_t)((k / kStages) & 1));
    __syncwarp();
    if (lane == 0) {
      bulk_store(out + j * page_bytes + off,
                 ((valid >> s) & 1u) ? ring + (size_t)s * kChunkBytes : zero, bytes);
      // Every store but this one has read its stage: the next load may
      // take the stage of item k - 1.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    __syncwarp();
    if (k + kStages - 1 < mine) load(k + kStages - 1);
  }
  // The ring must outlive the last store's read of it; the writes
  // themselves are complete when the kernel is.
  if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

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

// Blocks of the bulk kernel the current device runs at once (its SMs times
// the blocks an SM holds, at most kBlocksPerSm), found once a device; 0
// and the error where the device refuses.
int bulk_grid_limit(int* limit) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev] > 0) {
    *limit = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(gather_pages_bulk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBulkSmemBytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_pages_bulk_kernel,
                                                        kBulkThreads, kBulkSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  *limit = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  if (dev < 64) cached[dev] = *limit;
  return 0;
}

int launch_gather(const void* pool, int num_pages, long long page_bytes, const void* ids,
                  int n_out, void* out, void* stream, bool bulk) {
  if (num_pages <= 0 || page_bytes <= 0 || n_out <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(pool) | reinterpret_cast<uintptr_t>(out) |
                         (uintptr_t)page_bytes) & 15u) == 0;
  if (aligned && bulk) {
    const long long chunks = (page_bytes + kChunkBytes - 1) / kChunkBytes;
    const long long items = (long long)n_out * chunks;
    int limit = 0;
    const int rc = bulk_grid_limit(&limit);
    if (rc != 0) return rc;
    const unsigned int grid = (unsigned int)(items < limit ? items : limit);
    gather_pages_bulk_kernel<<<grid, kBulkThreads, kBulkSmemBytes, s>>>(
        static_cast<const unsigned char*>(pool), static_cast<const int*>(ids),
        static_cast<unsigned char*>(out), page_bytes, chunks, items, num_pages);
  } else if (aligned) {
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

}  // namespace

// pool: [num_pages, page_bytes] bytes; ids: int32 [n_out]; out: [n_out,
// page_bytes] bytes. The bulk kernel where both pointers and page_bytes
// are multiples of 16, else the byte loop. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int dmlc_gather_pages(const void* pool, int num_pages, long long page_bytes,
                                 const void* ids, int n_out, void* out, void* stream) {
  return launch_gather(pool, num_pages, page_bytes, ids, n_out, out, stream, true);
}

// The same with the design the bulk kernel replaced on the aligned path
// (gather_pages_vec16_kernel): for timing the two side by side.
extern "C" int dmlc_gather_pages_vec16(const void* pool, int num_pages, long long page_bytes,
                                       const void* ids, int n_out, void* out, void* stream) {
  return launch_gather(pool, num_pages, page_bytes, ids, n_out, out, stream, false);
}

// Dynamic shared memory a block of the bulk kernel takes.
extern "C" int dmlc_gather_pages_smem_bytes() { return kBulkSmemBytes; }

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
