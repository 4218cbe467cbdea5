// paged_decode: one decode step of attention, read straight from the paged
// KV cache through the page table.
//
// Replaces the TPU path of dmlc_tpu/ops/ragged_decode.py:
// paged_decode_attention: the page-gather kernel _gather_pages_pallas
// (body copy_kernel, pallas_call at :61), run once for K and once for V,
// together with the XLA attention after it (ragged_decode_attention). On
// the TPU the gather stages each slot's pages into one dense [B, max_pages
// * page_size, H, Dh] view that XLA's fused attention then reads. On this
// card each of those is a launch from an eager host, and the view spans
// the whole max_len of every slot, mostly dead padding, which about ten
// eager ops then read again. So here the gather folds into its consumer:
// the attention reads the pages itself, through the table, only at the
// live positions, and writes no view.
//
// Computes, for slot b and head h: out[b, h] = softmax_p(q[b, h] . k_p) v_p
// over positions p in [0, kv_lengths[b]) (clamped to max_pages *
// page_size), where position p is row p % page_size of pool page
// page_table[b, p / page_size]. q is scaled before the product; scores,
// softmax and the weighted sum are float32 (dense_attention's rule); out
// is [B, H, Dh] in the pools' dtype (float32 or bfloat16).
//
// What bounds it on the H100: memory. It does about 2 FLOPs per element
// it reads, far under the ~20 operations a byte where the float32 CUDA
// cores become the limit. The bytes are the live K and V rows, sum_b
// len_b * H * Dh * 2 * elsize, plus q, the table and the output; at the
// decode bench's one-step state (8 slots at length 193, H 6, Dh 128,
// float32) 9.5 MB a layer, 2.8 us at 3.35 TB/s.
//
// Design:
// - Grid (split, b * H + h). A split is a fixed run of kSplit (32)
//   positions, so that a few dozen (slot, head) pairs still give the
//   card's 132 SMs blocks to run; splits at or past a slot's length exit
//   at once. Against 64- and 128-position splits, 32 took 1.0 and 1.9 us
//   less at the decode bench's state and 2.3 and 2.9 us less at lm_wide's;
//   16 tied at the bench and lost 0.5 us at lm_wide (tools/flash_levers.py
//   group paged; PERF.md, section 6): the split pass is a chain of
//   dependent loads more than a stream of bytes, and more, shorter blocks
//   overlap more of it.
// - A block loads the page ids its positions need into shared memory, then
//   each of its 4 warps walks kSplit / 4 (8) positions. A row of K or V
//   for one head is one contiguous run of Dh elements (rows are strided by
//   H * Dh in the pool), so a warp reads it as 16-byte loads by Dh *
//   elsize / 16 lanes; at Dh 64 and 128 (the registry LMs' head dims,
//   instantiated) several rows share a warp load. A lane keeps its 16-byte chunk of q in
//   registers, issues the loads of all its K and V rows (up to 8 of each)
//   before it uses any (each byte is read once, by one lane, so the loads
//   go to registers and not through a shared-memory ring), and reduces each
//   score over its row's lanes by shuffles. An online softmax keeps each
//   row group's max, sum and output chunk in registers; the groups of a
//   warp, then the 4 warps, merge in a fixed order, and the block writes
//   its split's (max, sum, unnormalised output) to a float32 scratch.
// - Any other head dim takes a scalar path: lane d of a warp takes
//   elements d, d + 32, ... of a row, and the output accumulates in shared
//   memory.
// - A second small kernel merges a slot's splits in order 0, 1, ... and
//   writes out. No atomics: the result is bit-identical from run to run.
// - The order of every sum depends on positions only (which split, warp,
//   load and lane a position falls to), never on the page size or the page
//   ids, so a contiguous cache read as one page a slot (a table [[0], [1],
//   ...]) gives bit-identical results to the same state paged.
// - A page id outside [0, num_pages) is never read: its rows count as
//   zeros. The owner of the table checks it on the host before upload
//   (check_page_table), so that guard only keeps a bad table from reading
//   outside the pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 32;                 // positions a block
constexpr int kPerWarp = kSplit / kWarps;  // positions a warp
constexpr int kMaxIds = kSplit + 1;        // pages a split can touch
constexpr int kUnroll = 8;                 // K and V rows a lane loads ahead
constexpr int kGenericMaxDh = 8192;  // (1 + kWarps) * 4 * dh bytes of shared memory

struct Args {
  const void* q;        // [B, H, Dh]
  const void* k_pages;  // [num_pages, page_size, H, Dh]
  const void* v_pages;
  const int* table;     // [B, max_pages]
  const void* lengths;  // [B], int32 or int64
  float* part;          // [B * H, nsplit, Dh] unnormalised outputs
  float* part_ml;       // [B * H, nsplit, 2] (max, sum)
  void* out;            // [B, H, Dh]
  int num_pages, page_size, max_pages, heads, dh, nsplit, len_is_i64;
  float scale;
};

__device__ __forceinline__ int slot_length(const Args& a, int b) {
  const long long n = a.len_is_i64 ? static_cast<const long long*>(a.lengths)[b]
                                   : (long long)static_cast<const int*>(a.lengths)[b];
  const long long cap = (long long)a.max_pages * a.page_size;
  return (int)(n < 0 ? 0 : n > cap ? cap : n);
}

// The end of the split that starts at position p0, in a slot of length len.
__device__ __forceinline__ int split_end(int p0, int len) { return min(p0 + kSplit, len); }

// Loads the ids of the pages that positions [p0, p_end) of slot b fall
// on into ids (an id outside [0, num_pages) as -1); returns the first
// page's index in the table row.
__device__ int load_ids(const Args& a, int b, int p0, int p_end, int* ids) {
  const int first = p0 / a.page_size, n = (p_end - 1) / a.page_size - first + 1;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int id = a.table[(size_t)b * a.max_pages + first + i];
    ids[i] = (id >= 0 && id < a.num_pages) ? id : -1;
  }
  __syncthreads();
  return first;
}

// The element offset of (position p, head h) in a pool, or -1 for a row on
// a bad page.
__device__ __forceinline__ long long row_offset(const Args& a, const int* ids, int first, int p,
                                                int h) {
  const int page = p / a.page_size;
  const int id = ids[page - first];
  if (id < 0) return -1;
  return (((long long)id * a.page_size + (p - page * a.page_size)) * a.heads + h) * a.dh;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* y) { *y = __float2bfloat16(x); }

__device__ __forceinline__ void to_float(const uint4& raw, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(&raw);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void to_float(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Merges (m2, l2, o2) into (m, l, o): the online softmax's combine.
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float (&o)[N], float m2, float l2,
                                      const float (&o2)[N]) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  const float c1 = expf(m - mn), c2 = expf(m2 - mn);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int e = 0; e < N; ++e) o[e] = o[e] * c1 + o2[e] * c2;
  m = mn;
}

// The block's 4 warp states (max, sum, output of dh) from shared memory,
// merged in warp order, into the split's scratch row.
__device__ void write_split(const Args& a, int bh, int split, const float* wm, const float* wl,
                            const float* wo, int ldo) {
  float m = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w]);
  float c[kWarps], l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    c[w] = m == -INFINITY ? 0.f : expf(wm[w] - m);
    l += wl[w] * c[w];
  }
  const size_t row = (size_t)bh * a.nsplit + split;
  for (int d = threadIdx.x; d < a.dh; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += wo[w * ldo + d] * c[w];
    a.part[row * a.dh + d] = o;
  }
  if (threadIdx.x == 0) {
    a.part_ml[2 * row] = m;
    a.part_ml[2 * row + 1] = l;
  }
}

// Head dims 64 and 128: a row is LPR lanes of 16 bytes, RPL rows a warp
// load; each lane holds its chunk of q, K and V rows and its row group's
// online-softmax state in registers.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  constexpr int kPer = 16 / sizeof(T);          // elements a 16-byte chunk
  constexpr int LPR = DH / kPer;                // lanes a row
  constexpr int RPL = 32 / LPR;                 // rows a warp load
  constexpr int kLoads = kPerWarp / RPL;        // warp loads a warp's positions take
  constexpr int U = kLoads < kUnroll ? kLoads : kUnroll;
  static_assert(LPR <= 32 && 32 % LPR == 0 && kLoads % U == 0, "row layout");
  __shared__ int ids[kMaxIds];
  __shared__ float wm[kWarps], wl[kWarps];
  __shared__ __align__(16) float wo[kWarps * DH];

  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int len = slot_length(a, b);
  const int p0 = split * kSplit;
  if (p0 >= len) return;
  const int p_end = split_end(p0, len);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / LPR, c = lane % LPR;
  // q's chunk is loaded before the page ids, so that the two loads overlap.
  const uint4 q_raw = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.q) +
                                                      (size_t)bh * DH + c * kPer);
  const int first = load_ids(a, b, p0, p_end, ids);

  const T* kp = static_cast<const T*>(a.k_pages);
  const T* vp = static_cast<const T*>(a.v_pages);
  float qf[kPer];
  to_float(q_raw, qf);
#pragma unroll
  for (int e = 0; e < kPer; ++e) qf[e] *= a.scale;
  float m = -INFINITY, l = 0.f, o[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) o[e] = 0.f;

  const int pw = p0 + warp * kPerWarp;  // this warp's first position
  for (int it = 0; it < kLoads; it += U) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = pw + (it + u) * RPL + r;
      const long long off = p < p_end ? row_offset(a, ids, first, p, h) : -1;
      ok[u] = p < p_end;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (off >= 0) {
        kr[u] = *reinterpret_cast<const uint4*>(kp + off + c * kPer);
        vr[u] = *reinterpret_cast<const uint4*>(vp + off + c * kPer);
      }
    }
    float x[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[kPer];
      to_float(kr[u], kf);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) s = fmaf(qf[e], kf[e], s);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      x[u] = ok[u] ? s : -INFINITY;
      mx = fmaxf(mx, x[u]);
    }
    // A row group with nothing visible yet keeps m = -inf: subtract 0 there.
    const float base = mx == -INFINITY ? 0.f : mx;
    const float corr = expf(m - base);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kPer; ++e) o[e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(x[u] - base);
      float vf[kPer];
      to_float(vr[u], vf);
      l += p;
#pragma unroll
      for (int e = 0; e < kPer; ++e) o[e] = fmaf(p, vf[e], o[e]);
    }
    m = mx;
  }
  // The row groups of the warp, then the warps, in a fixed order.
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    float o2[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) o2[e] = __shfl_xor_sync(0xffffffffu, o[e], off);
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, o, m2, l2, o2);
  }
  if (r == 0) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) wo[warp * DH + c * kPer + e] = o[e];
    if (c == 0) {
      wm[warp] = m;
      wl[warp] = l;
    }
  }
  __syncthreads();
  write_split(a, bh, split, wm, wl, wo, DH);
}

// Any head dim: lane d of a warp takes elements d, d + 32, ... of a row;
// q and each warp's output live in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_generic_kernel(Args a) {
  __shared__ int ids[kMaxIds];
  __shared__ float wm[kWarps], wl[kWarps];
  extern __shared__ float smem[];
  float* qs = smem;            // [dh]
  float* wo = smem + a.dh;     // [kWarps, dh]

  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int len = slot_length(a, b);
  const int p0 = split * kSplit;
  if (p0 >= len) return;
  const int p_end = split_end(p0, len);
  const T* q = static_cast<const T*>(a.q) + (size_t)bh * a.dh;
  for (int d = threadIdx.x; d < a.dh; d += kThreads) qs[d] = to_f(q[d]) * a.scale;
  for (int d = threadIdx.x; d < kWarps * a.dh; d += kThreads) wo[d] = 0.f;
  const int first = load_ids(a, b, p0, p_end, ids);  // synchronises

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kp = static_cast<const T*>(a.k_pages);
  const T* vp = static_cast<const T*>(a.v_pages);
  float* o = wo + warp * a.dh;
  float m = -INFINITY, l = 0.f;
  const int pw = p0 + warp * kPerWarp;
  for (int j = 0; j < kPerWarp; ++j) {
    const int p = pw + j;
    if (p >= p_end) break;
    const long long off = row_offset(a, ids, first, p, h);
    float s = 0.f;
    if (off >= 0)
      for (int d = lane; d < a.dh; d += 32) s = fmaf(qs[d], to_f(kp[off + d]), s);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) s += __shfl_xor_sync(0xffffffffu, s, sh);
    const float mn = fmaxf(m, s), corr = expf(m - mn), pr = expf(s - mn);
    l = l * corr + pr;
    for (int d = lane; d < a.dh; d += 32)
      o[d] = fmaf(pr, off >= 0 ? to_f(vp[off + d]) : 0.f, o[d] * corr);
    m = mn;
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  write_split(a, bh, split, wm, wl, wo, a.dh);
}

// One block a (slot, head): its splits merged in order, divided by the
// sum, written in T.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(Args a) {
  const int bh = blockIdx.x, b = bh / a.heads;
  const int n = (slot_length(a, b) + kSplit - 1) / kSplit;
  const float* ml = a.part_ml + (size_t)bh * a.nsplit * 2;
  float m = -INFINITY, l = 0.f;
  for (int s = 0; s < n; ++s) m = fmaxf(m, ml[2 * s]);
  for (int s = 0; s < n; ++s) l += ml[2 * s + 1] * (m == -INFINITY ? 0.f : expf(ml[2 * s] - m));
  const float* part = a.part + (size_t)bh * a.nsplit * a.dh;
  T* out = static_cast<T*>(a.out) + (size_t)bh * a.dh;
  for (int d = threadIdx.x; d < a.dh; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < n; ++s) {
      const float c = m == -INFINITY ? 0.f : expf(ml[2 * s] - m);
      o += part[(size_t)s * a.dh + d] * c;
    }
    from_f(o / l, out + d);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int bh, cudaStream_t st) {
  const dim3 grid((unsigned)a.nsplit, (unsigned)bh);
  if (a.dh == 128) {
    paged_decode_kernel<T, 128><<<grid, kThreads, 0, st>>>(a);
  } else if (a.dh == 64) {
    paged_decode_kernel<T, 64><<<grid, kThreads, 0, st>>>(a);
  } else {
    const size_t smem = sizeof(float) * (size_t)(1 + kWarps) * a.dh;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_decode_generic_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    paged_decode_generic_kernel<T><<<grid, kThreads, smem, st>>>(a);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_combine_kernel<T><<<(unsigned)bh, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Positions a split holds: the wrapper sizes the scratch by it.
extern "C" int dmlc_paged_decode_split() { return kSplit; }

// q: [b, heads, dh]; k_pages, v_pages: [num_pages, page_size, heads, dh],
// all float32, or bfloat16 when is_bf16; table: int32 [b, max_pages];
// lengths: [b], int64 when len_is_i64 else int32; scratch: float32 of
// b * heads * nsplit * (dh + 2) where nsplit = ceil(max_pages * page_size
// / split); out: [b, heads, dh] in the pools' dtype. Launches the split
// pass and the merge on `stream` and returns the CUDA error code.
extern "C" int dmlc_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                 int num_pages, int page_size, int heads, int dh,
                                 const void* table, int b, int max_pages, const void* lengths,
                                 int len_is_i64, float scale, int is_bf16, void* scratch,
                                 void* out, void* stream) {
  if (b <= 0 || heads <= 0 || dh <= 0 || dh > kGenericMaxDh || num_pages <= 0 ||
      page_size <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const long long positions = (long long)max_pages * page_size;
  const long long nsplit = (positions + kSplit - 1) / kSplit;
  const long long bh = (long long)b * heads;
  if (nsplit > 0x7fffffffLL || bh > 65535 || positions > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((dh == 64 || dh == 128) &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
        reinterpret_cast<uintptr_t>(v_pages)) & 15u))
    return (int)cudaErrorMisalignedAddress;
  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.table = static_cast<const int*>(table);
  a.lengths = lengths;
  a.part = static_cast<float*>(scratch);
  a.part_ml = a.part + (size_t)bh * nsplit * dh;
  a.out = out;
  a.num_pages = num_pages;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.heads = heads;
  a.dh = dh;
  a.nsplit = (int)nsplit;
  a.len_is_i64 = len_is_i64;
  a.scale = scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(a, (int)bh, st) : launch<float>(a, (int)bh, st));
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
