// jpeg_idct: quantized DCT coefficients -> uint8 RGB images at size x size.
//
// Replaces no TPU kernel: the JAX package decodes JPEGs on the host
// (native/image_pipeline.cpp:57-200, libjpeg's scaled IDCT, colour
// conversion and a triangle resample). This is the device stage of the
// port's decode; the host stage, the entropy decoder
// (native/jpeg_entropy.cpp), writes the arena this reads: the IDCT basis,
// an image and three component records an image, each component's
// quantization table, and the int16 coefficients of every block. Beside
// the arena it reads the batch's plan, which native/jpeg_plan.cpp builds on
// the host (ops/jpeg.py batch_plan): the IDCT's runs, and for each image
// geometry the colour pass's tiles and its resample tables.
//
// Two launches on the caller's stream:
// 1. jpeg_idct_runs_kernel: the batch's runs only, each up to kRunBlocks
//    blocks of one component's block row (the plan's prefix of runs by
//    component record), so no CTA launches idle and the grid is
//    one-dimensional. A CTA of 4 warps takes kRunsPerCta runs in turn, the
//    next run's loads in flight during this one's arithmetic; a warp takes
//    4 blocks of a run and works alone (the only CTA barrier follows the
//    load of the 8 bases into shared memory). 8 threads a block, a thread a
//    coefficient row: one 16-byte load of its int16 coefficients (L2 only:
//    they are read once), dequantize, the row pass in registers, the
//    block's row-pass output through shared memory (column-major, a
//    __syncwarp), then the column pass for one output row (libjpeg's
//    jpeg_idct_MxM semantics over the first nx (ny) coefficients; see
//    native/jpeg_entropy.cpp), + 128, round to nearest even, clamp to
//    [0, 255]. The passes are compiled for each N = nx = ny and once for
//    nx != ny. A warp stages its blocks' rows and stores each plane row as
//    one run of bytes.
// 2. jpeg_color_tiles_kernel: one CTA a tile of one image's output (the
//    plan's rows x columns: full-width bands of 16 rows unless the
//    geometry's staged extents would pass the plan's budget), four CTAs an
//    SM. In stages through shared memory, each value made once a tile:
//    a. each component's plane box (the plan's) copied in, 4 bytes a
//       thread where aligned (L2 only: L1 keeps the plan's tables); a
//       component on the scaled grid that is not upsampled lands in S;
//    b. the others' fancy samples over the tile's source extent (libjpeg's
//       "fancy" triangle upsampling, jdsample.c h2v1/h1v2/h2v2 with its
//       integer biases; a warp a row, a thread the two samples of a plane
//       column): into S on the scaled grid, else into F;
//    c. each resampled component's horizontal pass (H; a column's taps
//       read once a thread);
//    d. each scaled pixel: the vertical pass of each resampled component
//       (a row's taps read once a warp), round, clamp; then libjpeg's
//       integer YCbCr->RGB (jdcolor.c) into P;
//    e. where the scaled image is not size x size, the triangle resample
//       to it (native/image_pipeline.cpp make_taps): the horizontal pass
//       (T) and the vertical pass, round, clamp (O);
//    f. the output tile stored: a full-width tile is one contiguous run of
//       bytes, staged at the alignment of its first byte and stored 16
//       bytes a thread; a narrower one a row at a time.
//    Twin chroma components (one source grid and upsampling) go through b
//    and c in one pass. Every tap weight is read from the plan's tables,
//    whose float32 weights are make_taps' (resample_taps, without its zero
//    taps).
//
// Every float operation is a separately rounded multiply or add in a fixed
// order (__fmul_rn, __fadd_rn: no contraction into FMA), the order of the
// plain version in ops/jpeg.py, so the two give the same bytes: each
// resample sums a row's taps in order, then a column's.
//
// What bounds it: its bytes bound is the coefficients read once (2 bytes
// a coefficient), the planes written and read back once, and 3 bytes a
// pixel written; but both kernels are bound by instruction issue, not by
// bytes: the IDCT's separately rounded products and sums (no FMA, for
// equal bytes), and in the colour pass byte-wide integer upsampling,
// index arithmetic and short sums of 2-4 taps. The design keeps that work
// to what the function needs: no value is made twice inside a tile (each
// chroma sample and each tap weight once, not once for each output pixel
// that covers it), no CTA launches idle, the planes are read in coalesced
// boxes and writes go out in runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kImgInts = 8;
constexpr int kCompInts = 16;
constexpr int kMaxComps = 3;
// The plan (ops/jpeg.py: PLAN_HDR, GEOM_INTS, TILE_INTS, RUN_BLOCKS and the
// G_* and T_* fields).
constexpr int kPlanHdr = 4;
constexpr int kGeomInts = 28;
constexpr int kTileInts = 32;
constexpr int kRunBlocks = 16;
constexpr int kIdctThreads = kRunBlocks * 8;
// Runs an IDCT CTA takes in turn, each run's loads in flight during the last.
constexpr int kRunsPerCta = 4;
constexpr int kColorThreads = 256;
constexpr int kColorWarps = kColorThreads / 32;
// Four CTAs an SM: the serve geometry's tile stages 50 KB.
constexpr int kColorCtas = 4;
enum Geom { kNTiles = 0, kTiles = 1, kResize = 2, kFY = 3, kFX = 4, kCY = 5, kCX = 8, kS = 11,
            kF = 14, kH = 17, kQ = 20, kP = 23, kT = 24, kO = 25, kSmem = 26, kTwin = 27 };
enum Tile { kOut = 0, kScaled = 4, kSrc = 8, kBox = 20 };
static_assert(kTwin + 1 == kGeomInts, "geometry record");
static_assert(kBox + 4 * kMaxComps == kTileInts, "tile record");

// The largest i in [0, count) with start[i] <= key: the owner of item
// `key` in a prefix `start` (start[0] = 0 <= key < start[count]). Each
// warp narrows the range 32 ways a step, so a few dependent loads find it.
__device__ __forceinline__ int owner(const int* __restrict__ start, int count, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = count;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    const unsigned le = __ballot_sync(0xffffffffu, i < hi && __ldg(start + i) <= key);
    lo += (31 - __clz(le)) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// ---------------------------------------------------------------------------
// 1. The IDCT
// ---------------------------------------------------------------------------

// One run's place and its thread's coefficient row, loaded ahead of use.
struct Run {
  int ci, pw, nx, ny, by, bx0, nb, plane_off;
  bool live;
  int4 raw, q0, q1;
};

// Run `run` of component record ci or a later one (ci <= the run's owner),
// for the thread of block k (of the run), row v.
__device__ __forceinline__ Run fetch_run(const int* __restrict__ comps, const int* __restrict__ qt,
                                         const short* __restrict__ coef,
                                         const int* __restrict__ run_start, int ci, int run,
                                         int k, int v) {
  Run r;
  while (__ldg(run_start + ci + 1) <= run) ++ci;
  const int* c = comps + ci * kCompInts;
  r.ci = ci;
  const int bw = __ldg(c + 1);
  r.pw = __ldg(c + 4);
  r.nx = __ldg(c + 10);
  r.ny = __ldg(c + 11);
  r.plane_off = __ldg(c + 3);
  const int per_row = (bw + kRunBlocks - 1) / kRunBlocks;
  const int local = run - __ldg(run_start + ci);
  r.by = local / per_row;
  r.bx0 = (local - r.by * per_row) * kRunBlocks;
  r.nb = min(kRunBlocks, bw - r.bx0);
  r.live = k < r.nb && v < r.ny;
  if (r.live) {
    const long long blk = (long long)__ldg(c) + (long long)r.by * bw + r.bx0 + k;
    r.raw = __ldcg(reinterpret_cast<const int4*>(coef + blk * 64 + v * 8));  // read once
    r.q0 = __ldg(reinterpret_cast<const int4*>(qt + ci * 64 + v * 8));
    r.q1 = __ldg(reinterpret_cast<const int4*>(qt + ci * 64 + v * 8 + 4));
  }
  return r;
}

// The two passes of a block's IDCT for the thread of row v of a block whose
// row-pass output is T (column-major, T[x * 8 + v]); returns its output row
// v (nx bytes, little-endian in two words). N > 0 fixes nx = ny = N at
// compile time, N = 0 takes them at run time. The 8 threads of a block are
// one aligned eighth of a warp.
template <int N>
__device__ __forceinline__ uint2 idct_passes(int nx, int ny, bool live, const float (&F)[8],
                                             const float* Bx, const float* By, float* T, int v) {
  if (N > 0) nx = ny = N;
  if (live) {  // row pass: T[v][x] = sum_u F[v][u] Bx[x][u]
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      if (x < nx) {
        const float4 b0 = reinterpret_cast<const float4*>(Bx)[2 * x];
        const float4 b1 = reinterpret_cast<const float4*>(Bx)[2 * x + 1];
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < nx) acc = __fadd_rn(acc, __fmul_rn(F[u], b[u]));
        T[x * 8 + v] = acc;
      }
    }
  }
  __syncwarp();
  uint32_t out[2] = {0, 0};
  if (live) {  // column pass, output row y = v: O[y][x] = sum_v T[v][x] By[y][v]
    const float4 y0 = reinterpret_cast<const float4*>(By)[2 * v];
    const float4 y1 = reinterpret_cast<const float4*>(By)[2 * v + 1];
    const float Y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      if (x < nx) {
        const float4 t0 = reinterpret_cast<const float4*>(T)[2 * x];
        const float4 t1 = reinterpret_cast<const float4*>(T)[2 * x + 1];
        const float col[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < ny) acc = __fadd_rn(acc, __fmul_rn(col[u], Y[u]));
        out[x >> 2] |= (uint32_t)clamp255(__float2int_rn(__fadd_rn(acc, 128.f))) << (8 * (x & 3));
      }
    }
  }
  return make_uint2(out[0], out[1]);
}

// Each warp takes 4 blocks of each of the CTA's runs (8 threads a block, a
// thread a coefficient row) and works on its own: the only CTA-wide
// barrier is the one after the bases are loaded.
__global__ void __launch_bounds__(kIdctThreads)
jpeg_idct_runs_kernel(const float* __restrict__ basis, const int* __restrict__ comps,
                      const int* __restrict__ qt, const short* __restrict__ coef,
                      const int* __restrict__ run_start, int ncomps, int runs,
                      uint8_t* __restrict__ planes) {
  __shared__ __align__(16) float B[8 * 64];  // every N-point basis
  // A block's row-pass output, column-major (x * 8 + v); 72 floats a block
  // keep both passes free of bank conflicts.
  __shared__ __align__(16) float T[kRunBlocks][72];
  __shared__ uint8_t O[kIdctThreads / 32][8][32];  // each warp's 4 blocks' plane rows
  const int t = threadIdx.x, k = t >> 3, v = t & 7, warp = t >> 5, lane = t & 31;
  for (int i = t; i < 8 * 64; i += kIdctThreads) B[i] = __ldg(basis + i);
  int run = blockIdx.x * kRunsPerCta;
  const int end = min(run + kRunsPerCta, runs);
  Run cur = fetch_run(comps, qt, coef, run_start, owner(run_start, ncomps, run), run, k, v);
  __syncthreads();
  for (; run < end; ++run) {
    // The next run's loads go out before this run's arithmetic.
    const Run next = run + 1 < end
        ? fetch_run(comps, qt, coef, run_start, cur.ci, run + 1, k, v) : cur;
    float F[8];  // dequantized row v
    const short* row = reinterpret_cast<const short*>(&cur.raw);
    const int q[8] = {cur.q0.x, cur.q0.y, cur.q0.z, cur.q0.w,
                      cur.q1.x, cur.q1.y, cur.q1.z, cur.q1.w};
#pragma unroll
    for (int u = 0; u < 8; ++u) F[u] = __fmul_rn((float)row[u], (float)q[u]);
    const int nx = cur.nx, ny = cur.ny;
    const float* Bx = B + (nx - 1) * 64;
    const float* By = B + (ny - 1) * 64;
    uint2 o;
    switch (nx == ny ? nx : 0) {  // uniform over the CTA
      case 1: o = idct_passes<1>(nx, ny, cur.live, F, Bx, By, T[k], v); break;
      case 2: o = idct_passes<2>(nx, ny, cur.live, F, Bx, By, T[k], v); break;
      case 3: o = idct_passes<3>(nx, ny, cur.live, F, Bx, By, T[k], v); break;
      case 4: o = idct_passes<4>(nx, ny, cur.live, F, Bx, By, T[k], v); break;
      case 5: o = idct_passes<5>(nx, ny, cur.live, F, Bx, By, T[k], v); break;
      case 6: o = idct_passes<6>(nx, ny, cur.live, F, Bx, By, T[k], v); break;
      case 7: o = idct_passes<7>(nx, ny, cur.live, F, Bx, By, T[k], v); break;
      case 8: o = idct_passes<8>(nx, ny, cur.live, F, Bx, By, T[k], v); break;
      default: o = idct_passes<0>(nx, ny, cur.live, F, Bx, By, T[k], v);
    }
    // The warp's 4 blocks' rows, staged so each plane row goes out as one
    // run of (blocks) * nx bytes.
    const int kw = k & 3;
    if (cur.live) {
      const uint32_t w[2] = {o.x, o.y};
#pragma unroll
      for (int x = 0; x < 8; ++x)
        if (x < nx) O[warp][v][kw * nx + x] = (uint8_t)(w[x >> 2] >> (8 * (x & 3)));
    }
    __syncwarp();
    const int k0 = warp * 4;
    const int len = max(0, min(4, cur.nb - k0)) * nx;
    uint8_t* dst = planes + cur.plane_off + (long long)cur.by * ny * cur.pw +
                   (long long)(cur.bx0 + k0) * nx;
    if (lane < len)
      for (int y = 0; y < ny; ++y) dst[(long long)y * cur.pw + lane] = O[warp][y][lane];
    __syncwarp();
    cur = next;
  }
}

// ---------------------------------------------------------------------------
// 2. Colour and resample
// ---------------------------------------------------------------------------

// A component's plane box in shared memory (plane rows [r0, ...) and
// columns [c0, ...), `stride` bytes a row) and its fancy upsampling to the
// source grid (cw x ch valid plane samples).
struct Plane {
  const uint8_t* p;
  int stride, r0, c0, cw, ch, fx, fy;
};

// The plane rows source row j blends (libjpeg's fancy filter: the nearer
// row 3/4, the other 1/4), as pointers into the box at column c0.
__device__ __forceinline__ void fancy_rows(const Plane& q, int j, const uint8_t*& r0,
                                           const uint8_t*& r1) {
  int a = j, b = j;
  if (q.fy == 2) {
    a = j >> 1;
    b = min(max((j & 1) ? a + 1 : a - 1, 0), q.ch - 1);
  }
  r0 = q.p + (a - q.r0) * q.stride - q.c0;
  r1 = q.p + (b - q.r0) * q.stride - q.c0;
}

// Copies rows x cols bytes (source rows `pitch` bytes apart) into shared
// memory (`stride` bytes a row): 4 bytes a thread where both sides allow,
// cached in L2 only (L1 keeps the plan's tables).
__device__ __forceinline__ void copy_box(uint8_t* dst, int stride, const uint8_t* src,
                                         long long pitch, int rows, int cols) {
  const bool words = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                       (uintptr_t)pitch | (uintptr_t)stride | (uintptr_t)cols) & 3) == 0;
  if (words) {
    const int w = cols >> 2;
    for (int i = threadIdx.x; i < rows * w; i += kColorThreads) {
      const int r = i / w, x = i - r * w;
      reinterpret_cast<uint32_t*>(dst + r * stride)[x] =
          __ldcg(reinterpret_cast<const uint32_t*>(src + r * pitch) + x);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += kColorThreads) {
    const int r = i / cols, x = i - r * cols;
    dst[r * stride + x] = __ldcg(src + r * pitch + x);
  }
}

// A resample table of the plan: for each output, its first source index,
// its tap count and its K weights.
struct Taps {
  const int* first;
  const int* count;
  const float* w;
  int k;
};

__device__ __forceinline__ Taps taps_at(const int* g, int field) {
  const int* t = g + g[field];
  const int out = t[0];
  return Taps{t + 2, t + 2 + out, reinterpret_cast<const float*>(t + 2 + 2 * out), t[1]};
}

// One output's taps, its first kRegTaps weights in registers.
constexpr int kRegTaps = 4;
struct Tap {
  int first, count;
  const float* w;
  float r[kRegTaps];
};

__device__ __forceinline__ Tap tap(const Taps& t, int o) {
  Tap a;
  a.first = __ldg(t.first + o);
  a.count = __ldg(t.count + o);
  a.w = t.w + (long long)o * t.k;
#pragma unroll
  for (int k = 0; k < kRegTaps; ++k) a.r[k] = k < a.count ? __ldg(a.w + k) : 0.f;
  return a;
}

// sum_k w[k] * v(k) over the taps in order, each product and sum rounded.
template <class V>
__device__ __forceinline__ float dot(const Tap& a, V v) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kRegTaps; ++k)
    if (k < a.count) acc = __fadd_rn(acc, __fmul_rn(a.r[k], v(k)));
#pragma unroll 1
  for (int k = kRegTaps; k < a.count; ++k) acc = __fadd_rn(acc, __fmul_rn(__ldg(a.w + k), v(k)));
  return acc;
}

// A component's fancy samples over [SY0, SY0 + ssY) x [SX0, SX0 + ssX) of
// its source grid into F (ssX bytes a row), a warp a row; with `twin`, a
// second component's too, from its box `twin_box` into `twin_F` (the same
// geometry: one pass, one set of indices for both). Along a factor-2 axis
// a thread makes the two samples of a plane column from its three
// neighbours.
__device__ __forceinline__ void fancy_extent(const Plane& q, uint8_t* F, int SY0, int ssY,
                                             int SX0, int ssX, const uint8_t* twin_box,
                                             uint8_t* twin_F) {
  const int lane = threadIdx.x & 31;
  const bool twin = twin_box != nullptr;
  const int m0 = SX0 >> 1, pairs = ((SX0 + ssX - 1) >> 1) - m0 + 1;
  const int apart = twin ? (int)(twin_box - q.p) : 0;  // the twin's box from this one's
  for (int j = threadIdx.x >> 5; j < ssY; j += kColorWarps) {
    const uint8_t *r0, *r1;
    fancy_rows(q, SY0 + j, r0, r1);
    uint8_t* f = F + j * ssX;
    uint8_t* tf = twin ? twin_F + j * ssX : nullptr;
    if (q.fx != 2) {  // h1v2
      const int bias = ((SY0 + j) & 1) ? 2 : 1;
      for (int x = lane; x < ssX; x += 32) {
        const int i = SX0 + x;
        f[x] = (uint8_t)((3 * r0[i] + r1[i] + bias) >> 2);
        if (twin) tf[x] = (uint8_t)((3 * r0[i + apart] + r1[i + apart] + bias) >> 2);
      }
      continue;
    }
    for (int mm = lane; mm < pairs; mm += 32) {
      const int m = m0 + mm, ml = max(m - 1, 0), mr = min(m + 1, q.cw - 1);
      const int even = 2 * m - SX0;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t == 1 && !twin) break;
        const uint8_t* a = r0 + t * apart;
        const uint8_t* b = r1 + t * apart;
        int e, o;
        if (q.fy == 2) {  // h2v2: the vertical blend, then the horizontal one
          const int vl = 3 * a[ml] + b[ml];
          const int vm = 3 * a[m] + b[m];
          const int vr = 3 * a[mr] + b[mr];
          e = (3 * vm + vl + 8) >> 4;
          o = (3 * vm + vr + 7) >> 4;
        } else {  // h2v1
          const int vm = 3 * a[m];
          e = (vm + a[ml] + 1) >> 2;
          o = (vm + a[mr] + 2) >> 2;
        }
        uint8_t* out = t ? tf : f;
        if (even >= 0) out[even] = (uint8_t)e;
        if (even + 1 < ssX) out[even + 1] = (uint8_t)o;
      }
    }
  }
}

// Stores len bytes from shared memory to global memory; src and dst agree
// modulo 16, so all but a head and a tail go 16 bytes a thread.
__device__ __forceinline__ void store_run(uint8_t* dst, const uint8_t* src, int len) {
  const int head = min(len, (int)((16 - ((uintptr_t)dst & 15)) & 15));
  const int body = (len - head) >> 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const uint4* s = reinterpret_cast<const uint4*>(src + head);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += blockDim.x) d[i] = s[i];
  for (int i = head + body * 16 + threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ int to_u8(float v) { return clamp255(__float2int_rn(v)); }

// libjpeg's integer YCbCr->RGB (jdcolor.c), packed little-endian.
__device__ __forceinline__ int ycc_rgb(int y, int cb, int cr) {
  cb -= 128;
  cr -= 128;
  return clamp255(y + ((91881 * cr + 32768) >> 16)) |
         (clamp255(y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)) << 8) |
         (clamp255(y + ((116130 * cb + 32768) >> 16)) << 16);
}

__device__ __forceinline__ void put_rgb(uint8_t* p, int rgb) {
  p[0] = (uint8_t)rgb;
  p[1] = (uint8_t)(rgb >> 8);
  p[2] = (uint8_t)(rgb >> 16);
}

__global__ void __launch_bounds__(kColorThreads, kColorCtas)
jpeg_color_tiles_kernel(const int* __restrict__ images, const int* __restrict__ comps,
                        const uint8_t* __restrict__ planes, const int* __restrict__ plan, int n,
                        uint8_t* __restrict__ out, int size) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int* tile_start = plan + kPlanHdr;
  const int* geom_at = tile_start + n + 1;
  const int img = owner(tile_start, n, blockIdx.x);
  const int* g = plan + geom_at[img];
  const int* tile = g + g[kTiles] + (blockIdx.x - tile_start[img]) * kTileInts;
  const int* im = images + img * kImgInts;
  const int ncomp = im[3];
  const int* c0 = comps + im[7] * kCompInts;
  const int oy0 = tile[kOut], oy1 = tile[kOut + 1], ox0 = tile[kOut + 2], ox1 = tile[kOut + 3];
  const int Y0 = tile[kScaled], X0 = tile[kScaled + 2];
  const int sY = tile[kScaled + 1] - Y0, sX = tile[kScaled + 3] - X0;
  const int oY = oy1 - oy0, oX = ox1 - ox0;
  const long long out_at = (((long long)img * size + oy0) * size + ox0) * 3;
  const bool whole = ox0 == 0 && ox1 == size;
  // The staged output starts at its first byte's alignment (store_run).
  const int shift = whole ? (int)((reinterpret_cast<uintptr_t>(out) + out_at) & 15) : 0;
  bool any_resampled = false, any_fancy = false;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // a. Each component's plane box into shared memory: straight into S for
  // a component on the scaled grid that is not upsampled, else into Q.
#pragma unroll 1
  for (int c = 0; c < ncomp; ++c) {
    const int* rec = c0 + c * kCompInts;
    const int* box = tile + kBox + 4 * c;
    const int pw = __ldg(rec + 4);
    const uint8_t* src = planes + __ldg(rec + 3) + (long long)box[0] * pw + box[2];
    const bool fancy = g[kQ + c] >= 0;
    copy_box(smem + (fancy ? g[kQ + c] : g[kS + c]), fancy ? box[3] - box[2] : sX, src, pw,
             box[1] - box[0], box[3] - box[2]);
    any_fancy |= fancy;
  }
  __syncthreads();
  // b. Each upsampled component's fancy samples on its source extent: into
  // S where it is on the scaled grid, else into F. Twin chroma components
  // go through b and c together.
  const bool twins = g[kTwin] != 0;
  if (any_fancy) {
#pragma unroll 1
    for (int c = 0; c < ncomp; ++c) {
      if (g[kQ + c] < 0) continue;
      const int* rec = c0 + c * kCompInts;
      const int* box = tile + kBox + 4 * c;
      const Plane q{smem + g[kQ + c], box[3] - box[2], box[0], box[2], __ldg(rec + 6),
                    __ldg(rec + 7), __ldg(rec + 8), __ldg(rec + 9)};
      const int* src = tile + kSrc + 4 * c;
      const bool resampled = g[kCY + c] >= 0;
      const int out = resampled ? kF : kS;
      const bool pair = twins && c == 1;
      fancy_extent(q, smem + g[out + c], src[0], src[1] - src[0], src[2], src[3] - src[2],
                   pair ? smem + g[kQ + 2] : nullptr, pair ? smem + g[out + 2] : nullptr);
      any_resampled |= resampled;
      if (pair) break;
    }
    __syncthreads();
  }
  if (any_resampled) {
    // c. The horizontal pass of each resampled component (H), a column's
    // taps once a thread.
#pragma unroll 1
    for (int c = 0; c < ncomp; ++c) {
      if (g[kCY + c] < 0) continue;
      const int* src = tile + kSrc + 4 * c;
      const int SX0 = src[2], ssY = src[1] - src[0], ssX = src[3] - src[2];
      const bool pair = twins && c == 1;
      const uint8_t* F = smem + g[kF + c];
      float* H = reinterpret_cast<float*>(smem + g[kH + c]);
      const int f_apart = g[kF + 2] - g[kF + c], h_apart = (g[kH + 2] - g[kH + c]) / 4;
      const Taps cx = taps_at(g, kCX + c);
      const int per = max(1, kColorThreads / sX);  // rows a step, where columns are few
      for (int i = threadIdx.x; i < sX * per; i += kColorThreads) {
        const int x = i % sX;
        const Tap a = tap(cx, X0 + x);
        const uint8_t* f = F + (a.first - SX0);
        for (int j = i / sX; j < ssY; j += per) {
          const uint8_t* fj = f + j * ssX;
          float* h = H + j * sX + x;
          *h = dot(a, [&](int k) { return (float)fj[k]; });
          if (pair) h[h_apart] = dot(a, [&](int k) { return (float)fj[k + f_apart]; });
        }
      }
      if (pair) break;
    }
    __syncthreads();
  }

  // d. Each scaled pixel, a warp a row: the vertical pass of each resampled
  // component, round, clamp; then libjpeg's colour conversion (P, 3 bytes a
  // pixel). Resampled components on one source grid share a table, and a
  // row's taps are then read once; otherwise (components sampled
  // differently) each reads its own.
  uint8_t* P = smem + g[kP] + (g[kResize] ? 0 : shift);
  int at[kMaxComps], from[kMaxComps];
  int table = -1;
  bool shared = true;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    const bool res = c < ncomp && g[kCY + c] >= 0;
    at[c] = c < ncomp ? g[res ? kH + c : kS + c] : g[kS];
    from[c] = res ? tile[kSrc + 4 * c] : -1;
    if (res) {
      shared &= table < 0 || g[table] == g[kCY + c];
      table = kCY + c;
    }
  }
  for (int y = warp; y < sY; y += kColorWarps) {
    Tap a;
    if (table >= 0) a = tap(taps_at(g, table), Y0 + y);
    for (int x = lane; x < sX; x += 32) {
      int v[kMaxComps];
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) {
        if (from[c] < 0) {
          v[c] = smem[at[c] + y * sX + x];
          continue;
        }
        if (!shared) a = tap(taps_at(g, kCY + c), Y0 + y);
        const float* h = reinterpret_cast<const float*>(smem + at[c]) + (a.first - from[c]) * sX + x;
        v[c] = to_u8(dot(a, [&](int k) { return h[k * sX]; }));
      }
      put_rgb(P + 3 * (y * sX + x),
              ncomp == 1 ? v[0] | (v[0] << 8) | (v[0] << 16) : ycc_rgb(v[0], v[1], v[2]));
    }
  }
  __syncthreads();

  // e. The resample to size x size: the horizontal pass (T, a column's
  // taps once a thread), then the vertical pass (a row's taps once a
  // warp), round, clamp (O).
  const uint8_t* staged = P;
  if (g[kResize]) {
    float* T = reinterpret_cast<float*>(smem + g[kT]);
    const Taps fx = taps_at(g, kFX), fy = taps_at(g, kFY);
    const int per = max(1, kColorThreads / oX);  // rows a step, where columns are few
    for (int i = threadIdx.x; i < oX * per; i += kColorThreads) {
      const int x = i % oX;
      const Tap a = tap(fx, ox0 + x);
      for (int y = i / oX; y < sY; y += per) {
        const uint8_t* p = P + 3 * (y * sX + a.first - X0);
        float* t = T + 3 * (y * oX + x);
#pragma unroll 1
        for (int ch = 0; ch < 3; ++ch) t[ch] = dot(a, [&](int k) { return (float)p[3 * k + ch]; });
      }
    }
    __syncthreads();
    uint8_t* O = smem + g[kO] + shift;
    for (int y = warp; y < oY; y += kColorWarps) {
      const Tap a = tap(fy, oy0 + y);
      const float* t = T + 3 * (a.first - Y0) * oX;
      for (int x = lane; x < 3 * oX; x += 32)
        O[3 * y * oX + x] = (uint8_t)to_u8(dot(a, [&](int k) { return t[3 * k * oX + x]; }));
    }
    staged = O;
    __syncthreads();
  }

  // f. The store.
  uint8_t* dst = out + out_at;
  if (whole) {
    store_run(dst, staged, oY * size * 3);
    return;
  }
  const int len = oX * 3;
  for (int y = 0; y < oY; ++y)
    for (int x = threadIdx.x; x < len; x += kColorThreads)
      dst[(long long)y * size * 3 + x] = staged[y * len + x];
}

}  // namespace

// Both launches for a batch of n images on `stream`; every pointer is device
// memory: the arena's regions (basis, images, comps, qtables, coef; qtables
// and coef 16-byte aligned), the batch's plan (native/jpeg_plan.cpp: `runs` IDCT runs,
// `tiles` colour tiles, `smem` bytes of shared memory a tile), the scratch
// planes (plane bytes from the arena's header) and out, uint8
// [n, size, size, 3] (rows of refused images are left as they were).
extern "C" int dmlc_jpeg_idct(const void* basis, const void* images, const void* comps,
                              const void* qt, const void* coef, const void* plan, int n, int runs,
                              int tiles, int smem, void* planes, void* out, int size,
                              void* stream) {
  if (n <= 0 || size <= 0 || runs < 0 || tiles < 0 || smem < 0 ||
      ((reinterpret_cast<uintptr_t>(coef) | reinterpret_cast<uintptr_t>(qt)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(plan);
  if (runs > 0)
    jpeg_idct_runs_kernel<<<(runs + kRunsPerCta - 1) / kRunsPerCta, kIdctThreads, 0, s>>>(
        static_cast<const float*>(basis), static_cast<const int*>(comps),
        static_cast<const int*>(qt), static_cast<const short*>(coef),
        p + kPlanHdr + 2 * n + 1, kMaxComps * n, runs, static_cast<uint8_t*>(planes));
  if (tiles > 0) {
    // The kernel's shared-memory limit is the device's: raised once for
    // each larger plan, not set at every launch.
    static std::mutex lock;
    static int raised[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    {
      std::lock_guard<std::mutex> hold(lock);
      if (smem > raised[dev]) {
        e = cudaFuncSetAttribute(jpeg_color_tiles_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        raised[dev] = smem;
      }
    }
    jpeg_color_tiles_kernel<<<tiles, kColorThreads, smem, s>>>(
        static_cast<const int*>(images), static_cast<const int*>(comps),
        static_cast<const uint8_t*>(planes), p, n, static_cast<uint8_t*>(out), size);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
