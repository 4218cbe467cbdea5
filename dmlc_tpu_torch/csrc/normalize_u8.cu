// normalize_u8: uint8 NHWC image batch -> ((x / 255) - mean_c) / std_c.
//
// Replaces the TPU kernel dmlc_tpu/ops/pallas_kernels.py:_normalize_kernel
// (launched by _normalize_call, public normalize_u8), which views the batch
// as [N*H, W*C] rows and computes x * scale + bias with per-column vectors.
//
// What bounds it on the H100: memory. Every input byte is read once and
// becomes one 4-byte (f32) or 2-byte (bf16) output; there are two flops per
// element. At the serving shape [256, 224, 224, 3] that is 38.5 MB read and
// 154 MB (f32) or 77 MB (bf16) written, against about one flop per 3-5
// bytes moved, far below the card's compute-to-bandwidth ratio.
//
// What the design does about it: it moves each byte once, in wide,
// coalesced transactions. The batch is treated as one flat array of
// N*H*W*C bytes. Each thread of a grid-stride loop loads 8 input bytes with
// one 8-byte load and writes their 8 outputs as 16-byte stores (one for
// bf16, two for f32), so a warp reads 256 contiguous bytes and writes 512
// or 1024 contiguous bytes per step. (A first version loaded 16 bytes per
// thread; its f32 stores then lay 64 bytes apart across the warp and the
// f32 kernel ran far below the bandwidth bound: see PERF.md.) The channel
// of flat element i is i % C, so the per-channel constants are picked from
// registers (C <= 4, passed by value) and nothing but the image itself is
// read from device memory. The arithmetic is x * scale + bias with the
// multiply and the add each rounded (__fmul_rn, __fadd_rn: no fused
// multiply-add), so the f32 result is bit-identical to the plain PyTorch
// version; bf16 output is that f32 value rounded once to nearest-even, the
// same single rounding the JAX engine applies when its model casts the
// normalized f32 image to bf16. Unaligned pointers and the ragged tail go
// through a scalar grid-stride loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct NormParams {
  float scale[4];
  float bias[4];
};

template <typename OutT>
__device__ __forceinline__ OutT from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float pick(int ch, float a, float b, float c, float d) {
  return ch == 0 ? a : (ch == 1 ? b : (ch == 2 ? c : d));
}

// kVec input bytes per thread and iteration; in kVec-byte aligned, out
// 16-byte aligned.
constexpr int kVec = 8;

template <typename OutT>
__global__ void normalize_vec_kernel(const uint8_t* __restrict__ in,
                                     OutT* __restrict__ out, long long n_vec,
                                     int channels, NormParams p) {
  const float s0 = p.scale[0], s1 = p.scale[1], s2 = p.scale[2], s3 = p.scale[3];
  const float b0 = p.bias[0], b1 = p.bias[1], b2 = p.bias[2], b3 = p.bias[3];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    const uint2 raw = reinterpret_cast<const uint2*>(in)[v];
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&raw);
    const long long base = v * kVec;
    int ch = (int)(base % channels);
    __align__(16) OutT res[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float x = (float)bytes[k];
      const float y = __fadd_rn(__fmul_rn(x, pick(ch, s0, s1, s2, s3)),
                                pick(ch, b0, b1, b2, b3));
      res[k] = from_float<OutT>(y);
      ch = (ch + 1 == channels) ? 0 : ch + 1;
    }
    constexpr int kStores = kVec * sizeof(OutT) / 16;
    uint4* dst = reinterpret_cast<uint4*>(out + base);
    const uint4* src = reinterpret_cast<const uint4*>(res);
#pragma unroll
    for (int j = 0; j < kStores; ++j) dst[j] = src[j];
  }
}

// Elements [start, n) one at a time: the unaligned case and the tail.
template <typename OutT>
__global__ void normalize_scalar_kernel(const uint8_t* __restrict__ in,
                                        OutT* __restrict__ out, long long start,
                                        long long n, int channels, NormParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int ch = (int)(i % channels);
    const float y = __fadd_rn(__fmul_rn((float)in[i], p.scale[ch]), p.bias[ch]);
    out[i] = from_float<OutT>(y);
  }
}

static unsigned int grid_for(long long items, int threads) {
  long long blocks = (items + threads - 1) / threads;
  const long long cap = 0x7fffffffLL;  // the grid-stride loops cover the rest
  if (blocks > cap) blocks = cap;
  return (unsigned int)(blocks < 1 ? 1 : blocks);
}

template <typename OutT>
static void launch(const uint8_t* in, OutT* out, long long n, int channels,
                   NormParams p, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const bool aligned = ((uintptr_t)in % kVec == 0) && ((uintptr_t)out % 16 == 0);
  const long long n_vec = aligned ? n / kVec : 0;
  if (n_vec > 0) {
    normalize_vec_kernel<OutT>
        <<<grid_for(n_vec, kThreads), kThreads, 0, stream>>>(in, out, n_vec, channels, p);
  }
  const long long done = n_vec * kVec;
  if (done < n) {
    normalize_scalar_kernel<OutT><<<grid_for(n - done, kThreads), kThreads, 0, stream>>>(
        in, out, done, n, channels, p);
  }
}

extern "C" int dmlc_normalize_u8(const void* in, void* out, long long n, int channels,
                                 int out_bf16, NormParams p, void* stream) {
  if (n <= 0 || channels < 1 || channels > 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (out_bf16) {
    launch<__nv_bfloat16>(src, static_cast<__nv_bfloat16*>(out), n, channels, p, s);
  } else {
    launch<float>(src, static_cast<float*>(out), n, channels, p, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dmlc_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
