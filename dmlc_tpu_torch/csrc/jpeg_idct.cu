// jpeg_idct: quantized DCT coefficients -> uint8 RGB images at size x size.
//
// Replaces no TPU kernel: the JAX package decodes JPEGs on the host
// (native/image_pipeline.cpp:57-200, libjpeg's scaled IDCT, colour
// conversion and a triangle resample). This is the device stage of the
// port's decode; the host stage, the entropy decoder
// (native/jpeg_entropy.cpp), writes the arena this reads: the IDCT basis,
// an image and three component records an image, each component's
// quantization table, and the int16 coefficients of every block.
//
// Two launches on the caller's stream:
// 1. jpeg_idct_blocks_kernel: grid (blocks / 4, components). Four 8x8
//    blocks a CTA of 64 x 4 threads: dequantize into shared memory, then the
//    scaled IDCT over the first nx (ny) coefficients of each row (column)
//    (libjpeg's jpeg_idct_MxM semantics; nx = ny = M for a component at full
//    resolution, see native/jpeg_entropy.cpp) as a row pass and a column
//    pass with the basis, + 128, round to nearest even, clamp to [0, 255],
//    into each component's scratch plane of (bw * nx) x (bh * ny) bytes.
// 2. jpeg_color_resize_kernel: grid (size * size / 256, images). One output
//    pixel a thread: for each tap of the triangle resample to size x size
//    (the taps of native/image_pipeline.cpp make_taps, computed here in
//    double as there), the scaled pixel's components; a component's plane
//    is upsampled by libjpeg's "fancy" triangle filter (jdsample.c
//    h2v1/h1v2/h2v2, its integer biases) to its source grid, and resampled
//    by the same triangle filter from there to the scaled grid where the
//    two differ (a subsampled component decoded at full resolution); then
//    libjpeg's integer YCbCr->RGB (jdcolor.c). Each resample is a
//    horizontal pass of each tap row, then the vertical pass, round, clamp.
//    Where the scaled image already is size x size the last resample is
//    skipped.
//
// Every float operation is a separately rounded multiply or add in a fixed
// order (__fmul_rn, __fadd_rn: no contraction into FMA), the order of the
// plain version in ops/jpeg.py, so the two give the same bytes.
//
// What bounds it: bytes. The coefficients are read once (2 bytes a
// coefficient), the planes written and read back once, and 3 bytes a pixel
// written; a thread of (2) recomputes its taps, which costs a few double
// operations a tap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kImgInts = 8;
constexpr int kCompInts = 16;
constexpr int kBlocksPerCta = 4;

__global__ void jpeg_idct_blocks_kernel(const float* __restrict__ basis,
                                        const int* __restrict__ comps,
                                        const int* __restrict__ qt,
                                        const short* __restrict__ coef,
                                        uint8_t* __restrict__ planes) {
  const int ci = blockIdx.y;
  const int* c = comps + ci * kCompInts;
  const int bw = c[1], bh = c[2];
  const int nblk = bw * bh;
  if (blockIdx.x * kBlocksPerCta >= nblk) return;  // uniform over the CTA
  const int block_off = c[0], plane_off = c[3], pw = c[4], nx = c[10], ny = c[11];
  __shared__ float Bx[64], By[64];
  __shared__ float F[kBlocksPerCta][64];
  __shared__ float T[kBlocksPerCta][64];
  const int t = threadIdx.x, sub = threadIdx.y;
  const int b = blockIdx.x * kBlocksPerCta + sub;
  if (sub == 0) Bx[t] = basis[(nx - 1) * 64 + t];
  if (sub == 1) By[t] = basis[(ny - 1) * 64 + t];
  if (b < nblk) {
    const float q = (float)qt[ci * 64 + t];
    F[sub][t] = __fmul_rn((float)coef[((long long)block_off + b) * 64 + t], q);
  }
  __syncthreads();
  const int r = t >> 3, x = t & 7;
  if (b < nblk && r < ny && x < nx) {  // row pass: T[v][x] = sum_u F[v][u] Bx[x][u]
    float acc = 0.f;
    for (int u = 0; u < nx; ++u) acc = __fadd_rn(acc, __fmul_rn(F[sub][r * 8 + u], Bx[x * 8 + u]));
    T[sub][r * 8 + x] = acc;
  }
  __syncthreads();
  if (b < nblk && r < ny && x < nx) {  // column pass: O[y][x] = sum_v T[v][x] By[y][v]
    float acc = 0.f;
    for (int v = 0; v < ny; ++v) acc = __fadd_rn(acc, __fmul_rn(T[sub][v * 8 + x], By[r * 8 + v]));
    int pix = __float2int_rn(__fadd_rn(acc, 128.f));
    pix = min(max(pix, 0), 255);
    const int by = b / bw, bx = b - by * bw;
    planes[(long long)plane_off + (long long)(by * ny + r) * pw + bx * nx + x] = (uint8_t)pix;
  }
}

// A component's sample at position (j, i) of its source grid, upsampled by
// libjpeg's fancy filter along an axis of factor 2.
__device__ __forceinline__ int fancy(const uint8_t* __restrict__ planes, const int* c, int j,
                                     int i) {
  const uint8_t* p = planes + c[3];
  const int pw = c[4], cw = c[6], ch = c[7], fx = c[8], fy = c[9];
  if (fx == 1 && fy == 1) return p[(long long)j * pw + i];
  int r0 = j, r1 = j, c0 = i, c1 = i;
  if (fy == 2) {
    r0 = j >> 1;
    r1 = min(max((j & 1) ? r0 + 1 : r0 - 1, 0), ch - 1);
  }
  if (fx == 2) {
    c0 = i >> 1;
    c1 = min(max((i & 1) ? c0 + 1 : c0 - 1, 0), cw - 1);
  }
  const uint8_t* row0 = p + (long long)r0 * pw;
  const uint8_t* row1 = p + (long long)r1 * pw;
  if (fx == 2 && fy == 2) {
    const int s0 = 3 * row0[c0] + row1[c0];
    const int s1 = 3 * row0[c1] + row1[c1];
    return (3 * s0 + s1 + ((i & 1) ? 7 : 8)) >> 4;
  }
  if (fx == 2) return (3 * row0[c0] + row0[c1] + ((i & 1) ? 2 : 1)) >> 2;
  return (3 * row0[i] + row1[i] + ((j & 1) ? 2 : 1)) >> 2;
}

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// The triangle taps of output index o over an axis of `in` samples
// (make_taps): [lo, hi) and the sum of the unnormalised weights; a
// degenerate total gives the one tap `nearest`.
struct Taps {
  double center, div, total;
  int lo, hi, nearest;
};

__device__ __forceinline__ Taps make_taps(int in, int out, int o) {
  Taps t;
  const double scale = (double)in / out;
  const double support = fmax(1.0, scale);
  t.center = (o + 0.5) * scale;
  t.lo = max(0, (int)floor(t.center - support));
  t.hi = min(in, (int)ceil(t.center + support));
  t.div = support > 1.0 ? scale : 1.0;
  t.total = 0.0;
  for (int j = t.lo; j < t.hi; ++j) {
    const double d = fabs((j + 0.5 - t.center) / t.div);
    t.total += d < 1.0 ? 1.0 - d : 0.0;
  }
  t.nearest = -1;
  if (t.total <= 0.0) t.nearest = min(max((int)t.center, t.lo), t.hi - 1);
  return t;
}

__device__ __forceinline__ float tap_weight(const Taps& t, int j) {
  if (t.nearest >= 0) return j == t.nearest ? 1.f : 0.f;
  const double d = fabs((j + 0.5 - t.center) / t.div);
  return (float)((d < 1.0 ? 1.0 - d : 0.0) / t.total);
}

// A component's sample at position (j, i) of the scaled grid (ws x hs):
// the fancy-upsampled plane, resampled from its source grid where that is
// another.
__device__ __forceinline__ int sample(const uint8_t* __restrict__ planes, const int* c, int ws,
                                      int hs, int j, int i) {
  const int srcw = c[12], srch = c[13];
  if (srcw == ws && srch == hs) return fancy(planes, c, j, i);
  const Taps ty = make_taps(srch, hs, j), tx = make_taps(srcw, ws, i);
  float acc = 0.f;
  for (int jj = ty.lo; jj < ty.hi; ++jj) {
    float row = 0.f;
    for (int ii = tx.lo; ii < tx.hi; ++ii)
      row = __fadd_rn(row, __fmul_rn(tap_weight(tx, ii), (float)fancy(planes, c, jj, ii)));
    acc = __fadd_rn(acc, __fmul_rn(tap_weight(ty, jj), row));
  }
  return clamp255(__float2int_rn(acc));
}

// The scaled image's RGB at (j, i): libjpeg's integer colour conversion.
__device__ __forceinline__ void rgb_at(const uint8_t* __restrict__ planes, const int* c0,
                                       int ncomp, int ws, int hs, int j, int i, float rgb[3]) {
  const int y = sample(planes, c0, ws, hs, j, i);
  if (ncomp == 1) {
    rgb[0] = rgb[1] = rgb[2] = (float)y;
    return;
  }
  const int cb = sample(planes, c0 + kCompInts, ws, hs, j, i) - 128;
  const int cr = sample(planes, c0 + 2 * kCompInts, ws, hs, j, i) - 128;
  rgb[0] = (float)clamp255(y + ((91881 * cr + 32768) >> 16));
  rgb[1] = (float)clamp255(y + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  rgb[2] = (float)clamp255(y + ((116130 * cb + 32768) >> 16));
}

__global__ void jpeg_color_resize_kernel(const int* __restrict__ images,
                                         const int* __restrict__ comps,
                                         const uint8_t* __restrict__ planes,
                                         uint8_t* __restrict__ out, int size) {
  const int n = blockIdx.y;
  const int* im = images + n * kImgInts;
  if (im[0] != 0) return;  // refused: the caller fills this row
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= size * size) return;
  const int y = idx / size, x = idx - y * size;
  const int ncomp = im[3], ws = im[5], hs = im[6];
  const int* c0 = comps + im[7] * kCompInts;
  uint8_t* dst = out + ((long long)n * size * size + idx) * 3;
  float rgb[3];
  if (ws == size && hs == size) {
    rgb_at(planes, c0, ncomp, ws, hs, y, x, rgb);
    dst[0] = (uint8_t)rgb[0];
    dst[1] = (uint8_t)rgb[1];
    dst[2] = (uint8_t)rgb[2];
    return;
  }
  const Taps ty = make_taps(hs, size, y), tx = make_taps(ws, size, x);
  float acc[3] = {0.f, 0.f, 0.f};
  for (int j = ty.lo; j < ty.hi; ++j) {
    float row[3] = {0.f, 0.f, 0.f};
    for (int i = tx.lo; i < tx.hi; ++i) {
      const float w = tap_weight(tx, i);
      rgb_at(planes, c0, ncomp, ws, hs, j, i, rgb);
#pragma unroll
      for (int k = 0; k < 3; ++k) row[k] = __fadd_rn(row[k], __fmul_rn(w, rgb[k]));
    }
    const float w = tap_weight(ty, j);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, row[k]));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) dst[k] = (uint8_t)clamp255(__float2int_rn(acc[k]));
}

}  // namespace

// Both launches for a batch of n images on `stream`; every pointer is device
// memory: the arena's regions (basis, images, comps, qtables, coef), the
// scratch planes (plane bytes from the arena's header) and out, uint8
// [n, size, size, 3] (rows of refused images are left as they were).
extern "C" int dmlc_jpeg_idct(const void* basis, const void* images, const void* comps,
                              const void* qt, const void* coef, int n, int max_comp_blocks,
                              void* planes, void* out, int size, void* stream) {
  if (n <= 0 || size <= 0 || n * 3 > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (max_comp_blocks > 0) {
    const dim3 grid((max_comp_blocks + kBlocksPerCta - 1) / kBlocksPerCta, n * 3);
    jpeg_idct_blocks_kernel<<<grid, dim3(64, kBlocksPerCta), 0, s>>>(
        static_cast<const float*>(basis), static_cast<const int*>(comps),
        static_cast<const int*>(qt), static_cast<const short*>(coef),
        static_cast<uint8_t*>(planes));
  }
  const dim3 grid((size * size + 255) / 256, n);
  jpeg_color_resize_kernel<<<grid, 256, 0, s>>>(
      static_cast<const int*>(images), static_cast<const int*>(comps),
      static_cast<const uint8_t*>(planes), static_cast<uint8_t*>(out), size);
  return (int)cudaGetLastError();
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
