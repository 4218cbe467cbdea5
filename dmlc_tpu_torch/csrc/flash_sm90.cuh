// flash_sm90.cuh: the Hopper building blocks of the bf16 flash kernels
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// - TMA: tiles of a [BH, S, DH] bf16 tensor (DH 64 or 128, 192 or 256,
//   and 320 to 512; a template parameter of every kernel but those past
//   512) are
//   copied into shared memory by the Tensor
//   Memory Accelerator, one thread issuing each copy. The tensor map is 3-D
//   over (d, s, bh), so rows past S of one head are zero-filled instead of
//   read from the next head. The 128-byte swizzle limits a box to 64
//   columns (128 bytes), so a [R, DH] tile is DH / 64 boxes: column half h
//   lands at h * R * 128 bytes, row r of it at r * 128, its 16-byte chunk c
//   at chunk c ^ (r % 8). At DH 64 a row is one swizzle atom and a tile one
//   box. Tiles start on 1024-byte boundaries, the swizzle's period.
// - mbarriers: each copy reports its bytes to a barrier in shared memory;
//   consumers wait on the barrier's phase parity.
// - wgmma: a warpgroup (4 warps) multiplies a 64-row A by B from shared
//   memory (a 64-bit descriptor per operand) or A from registers, and
//   keeps the float32 product in registers. Accumulator layout of
//   m64nNk16, thread t of the warpgroup (warp w = t / 32, lane l): entry
//   i holds row 16 w + l / 4 + 8 * ((i % 4) / 2), column
//   8 * (i / 4) + 2 * (l % 4) + i % 2. The register A operand of one k16
//   step is the same layout's 16 columns packed to bf16 pairs, so a
//   product's accumulator becomes the next product's A in place.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (no -lcuda), and passed to the kernels
// by value as __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {
namespace sm90 {

constexpr int kConsumerThreads = 256;    // two consumer warpgroups
constexpr int kThreads = 384;            // + one producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr uint32_t align1024(uint32_t n) { return (n + 1023u) & ~1023u; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// --------------------------------------------------------------------- TMA

// Box (64 columns, rows, 1) of the tensor at column c, row s, head bh.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int s, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(s), "r"(bh)
      : "memory");
}

// A [rows, DH] tile: its DH / 64 column halves, `rows` * DH * 2 bytes in all.
template <int DH>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int rows, int row0, int bh) {
#pragma unroll
  for (int h = 0; h < DH / 64; ++h)
    tma_load(static_cast<char*>(dst) + h * rows * 128, map, bar, 64 * h, row0, bh);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------- clusters

// The bf16 dK/dV past Dh 256 splits its score products between the two
// blocks of a thread-block cluster, each pushing its partial sums into the
// other's shared memory. peer_addr maps this block's shared address p to
// block `rank` of the cluster; st_peer writes 16 bytes there;
// mbar_arrive_peer arrives on a barrier of that block (its address from
// peer_addr) after this thread's earlier writes (release at cluster scope),
// and mbar_wait_cluster is mbar_wait that sees them (acquire at cluster
// scope).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 16 bytes at a shared::cluster address (peer_addr).
__device__ __forceinline__ float4 ld_peer(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// --------------------------------------------- warp specialisation, barriers

template <uint32_t N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <uint32_t N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1-15) over the 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Barrier `id` (1-15) between the two consumer warpgroups: one arrives
// (and goes on), the other waits until it has arrived. Shared-memory
// writes before the arrival are seen by the waiting threads after it.
__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ void consumers_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumerThreads) : "memory");
}

// ------------------------------------------------------------------- wgmma

// Shared-memory operand descriptor, 128-byte swizzle. lbo and sbo in bytes:
// K-major (the reduction dim contiguous): sbo = 1024 between 8-row groups,
// lbo unused; MN-major: lbo between 64-column halves (unused when N is 64,
// one half), sbo = 1024 between 8-row (k) groups.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the registers to this point, so that no read of an accumulator moves
// above the wgmma_wait that completes it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A . B, both operands from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A . B, both operands from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 96] (+)= A . B, both operands from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 32] (+)= A . B, both operands from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 16] (+)= A . B, both operands from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// D (+)= A . B from shared memory, both K-major, N by the accumulator's
// size: 64 floats a thread for N = 128, 48 for N = 96, 32 for N = 64, 16
// for N = 32, 8 for N = 16.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  wgmma_ss_n128(d, da, db, acc);
}

__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da, uint64_t db, int acc) {
  wgmma_ss_n96(d, da, db, acc);
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  wgmma_ss_n64(d, da, db, acc);
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  wgmma_ss_n32(d, da, db, acc);
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  wgmma_ss_n16(d, da, db, acc);
}

// D[64 x 128] (+)= A . B, A from registers (four bf16x2 per thread), B from
// shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A . B, A from registers (four bf16x2 per thread), B from
// shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (+)= A . B, A from registers, B MN-major from shared memory, N by the
// accumulator's size: 64 floats a thread for N = 128, 32 for N = 64.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  wgmma_rs_n128(d, a, db, acc);
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  wgmma_rs_n64(d, a, db, acc);
}

// Two floats as one bf16 pair (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k16 step kk from an accumulator of the same rows.
template <int N>
__device__ __forceinline__ void to_a_operand(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// Byte offset of element (row, col) of a [R, DH] bf16 tile in the TMA
// layout above.
__device__ __forceinline__ uint32_t tile_offset(int row, int col, int R) {
  return (uint32_t)((col >> 6) * R * 128 + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
                    (col & 7) * 2);
}

// Writes a warpgroup's [64, 2 N] float32 accumulator (N floats a thread),
// times `mul0` on a thread's upper rows and `mul1` on its lower ones, as
// bf16 into rows [row0, row0 + 64) and columns [col0, col0 + 2 N) of a
// [R, DH] tile in shared memory (the swizzle keeps the eight rows of one
// store on distinct banks).
template <int N>
__device__ __forceinline__ void stage_rows(const float (&d)[N], float mul0, float mul1,
                                           unsigned char* tile, int R, int row0, int col0) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int r_lo = row0 + 16 * w + lane / 4;
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int row = r_lo + 8 * ((i % 4) / 2);
    const int col = col0 + 8 * (i / 4) + 2 * (lane % 4);
    const float m = (i % 4) < 2 ? mul0 : mul1;
    *reinterpret_cast<uint32_t*>(tile + tile_offset(row, col, R)) = pack_bf16(d[i] * m, d[i + 1] * m);
  }
}

// After the warpgroup's barrier `bar_id`, copies columns [c0, c0 + W) of
// rows [row0, row0 + 64) of a [R, DH] bf16 tile to global rows g_row0 + r
// < S of `g` ([S, DH] row-major) in 16-byte stores.
template <int DH, int W = DH>
__device__ __forceinline__ void copy_rows(const unsigned char* tile, int R, int row0,
                                          __nv_bfloat16* g, int g_row0, int S, int bar_id,
                                          int c0 = 0) {
  constexpr int kChunks = W / 8;  // 16-byte chunks a row
  const int t = threadIdx.x % 128;
  warpgroup_sync(bar_id);
#pragma unroll
  for (int k = 0; k < 64 * kChunks / 128; ++k) {
    const int idx = t + 128 * k;  // 64 rows x kChunks chunks
    const int row = idx / kChunks, col = c0 + (idx % kChunks) * 8;
    if (g_row0 + row < S) {
      const uint4 v = *reinterpret_cast<const uint4*>(tile + tile_offset(row0 + row, col, R));
      *reinterpret_cast<uint4*>(g + (size_t)(g_row0 + row) * DH + col) = v;
    }
  }
}

// Writes a warpgroup's [64, DH] float32 accumulator (DH / 2 floats a
// thread) through rows [row0, row0 + 64) of a [R, DH] tile in shared
// memory to global rows g_row0 + r < S of `g` (stage_rows, copy_rows).
template <int N>
__device__ __forceinline__ void store_rows(const float (&d)[N], float mul0, float mul1,
                                           unsigned char* tile, int R, int row0,
                                           __nv_bfloat16* g, int g_row0, int S, int bar_id) {
  stage_rows(d, mul0, mul1, tile, R, row0, 0);
  copy_rows<2 * N>(tile, R, row0, g, g_row0, S, bar_id);
}

// A warpgroup's [64, DH] float32 accumulator of an output product (O +=
// P V, dV += P^T dO, dK += dS^T Q), its A operand from registers and B a
// [rows, DH] tile MN-major in shared memory (box h of 64 columns at h *
// `box` bytes). Up to DH 128 it is one wgmma accumulator (DH / 2 floats a
// thread); past it two (kSplit): columns [0, 128) and [128, DH), m64n128
// and then m64n64 at DH 192 or m64n128 at 256.
template <int DH, bool kSplit = (DH > 128)>
struct OutAcc {
  float r[DH / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) r[i] = 0.f;
  }

  // Rows times c0 (a thread's upper rows) or c1 (its lower ones).
  __device__ __forceinline__ void scale(float c0, float c1) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) r[i] *= (i % 4) < 2 ? c0 : c1;
  }

  // (+)= A . B for one k16 step; b points at the step's first row.
  __device__ __forceinline__ void mma(const uint32_t (&a)[4], const unsigned char* b,
                                      uint32_t box) {
    wgmma_rs(r, a, desc(b, box, 1024), 1);
  }

  __device__ __forceinline__ void fence() { reg_fence(r); }

  // Times mul0 / mul1 as bf16 into columns [col0, col0 + DH) of rows
  // [row0, row0 + 64) of a tile in shared memory (stage_rows).
  __device__ __forceinline__ void stage(float mul0, float mul1, unsigned char* tile, int R,
                                        int row0, int col0) {
    stage_rows(r, mul0, mul1, tile, R, row0, col0);
  }

  __device__ __forceinline__ void store(float mul0, float mul1, unsigned char* tile, int R,
                                        int row0, __nv_bfloat16* g, int g_row0, int S,
                                        int bar_id) {
    store_rows(r, mul0, mul1, tile, R, row0, g, g_row0, S, bar_id);
  }
};

template <int DH>
struct OutAcc<DH, true> {
  static_assert(DH == 192 || DH == 256, "split accumulators are 192 or 256 columns");
  float lo[64], hi[DH / 2 - 64];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 64; ++i) lo[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 2 - 64; ++i) hi[i] = 0.f;
  }

  __device__ __forceinline__ void scale(float c0, float c1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) lo[i] *= (i % 4) < 2 ? c0 : c1;
#pragma unroll
    for (int i = 0; i < DH / 2 - 64; ++i) hi[i] *= (i % 4) < 2 ? c0 : c1;
  }

  __device__ __forceinline__ void mma(const uint32_t (&a)[4], const unsigned char* b,
                                      uint32_t box) {
    wgmma_rs(lo, a, desc(b, box, 1024), 1);
    wgmma_rs(hi, a, desc(b + 2 * box, box, 1024), 1);
  }

  __device__ __forceinline__ void fence() {
    reg_fence(lo);
    reg_fence(hi);
  }

  __device__ __forceinline__ void stage(float mul0, float mul1, unsigned char* tile, int R,
                                        int row0, int col0) {
    stage_rows(lo, mul0, mul1, tile, R, row0, col0);
    stage_rows(hi, mul0, mul1, tile, R, row0, col0 + 128);
  }

  __device__ __forceinline__ void store(float mul0, float mul1, unsigned char* tile, int R,
                                        int row0, __nv_bfloat16* g, int g_row0, int S,
                                        int bar_id) {
    stage(mul0, mul1, tile, R, row0, 0);
    copy_rows<DH>(tile, R, row0, g, g_row0, S, bar_id);
  }
};

// A warpgroup's [64, C] float32 accumulator: OutAcc up to 256 columns;
// past it (the bf16 dK/dV over all of Dh at 320, and the bf16 dQ and dK/dV
// past 512 at 5 boxes) OutAcc<256> and OutAcc<C - 256> side by side.
template <int C, bool kPast256 = (C > 256)>
struct WideAcc : OutAcc<C> {};

template <int C>
struct WideAcc<C, true> {
  OutAcc<256> a;
  OutAcc<C - 256> b;

  __device__ __forceinline__ void zero() {
    a.zero();
    b.zero();
  }

  __device__ __forceinline__ void mma(const uint32_t (&x)[4], const unsigned char* p,
                                      uint32_t box) {
    a.mma(x, p, box);
    b.mma(x, p + 4 * box, box);
  }

  __device__ __forceinline__ void fence() {
    a.fence();
    b.fence();
  }

  __device__ __forceinline__ void stage(float mul0, float mul1, unsigned char* tile, int R,
                                        int row0, int col0) {
    a.stage(mul0, mul1, tile, R, row0, col0);
    b.stage(mul0, mul1, tile, R, row0, col0 + 256);
  }
};

// ------------------------------------------------- the backward past Dh 512

// The bf16 dQ and dK/dV that take the head dim at run time
// (flash_bwd_dq.cu DqXlCfg, flash_bwd_dkv.cu DkvXlCfg) share these.
//
// xl_score: one warpgroup's score product acc[64 x 2N] = the sum over
// Dh's 64-column slabs [d0, d1) of A B^T, both K-major: slot s of the
// warpgroup's ring (kSlots slots of kSlot bytes at `ring`, its own full
// and empty barriers) holds a slab's [64, 64] box of A and, kA bytes
// behind it, its [2N, 64] box of B. n counts the slabs taken from the
// ring; a slot goes back to the producer once its products are done. The
// slabs are summed in one order, so every block that walks the same slabs
// holds the same sums to the bit.
template <int kSlots, uint32_t kSlot, uint32_t kA, int N>
__device__ __forceinline__ void xl_score(float (&acc)[N], const unsigned char* ring,
                                         uint64_t* full, uint64_t* empty, uint32_t& n, int d0,
                                         int d1) {
  wgmma_fence();
  for (int d = d0; d < d1; ++d, ++n) {
    const uint32_t s = n % kSlots;
    mbar_wait(&full[s], (n / kSlots) & 1);
    const unsigned char* a = ring + s * kSlot;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, desc(a + kk * 32, 16, 1024), desc(a + kA + kk * 32, 16, 1024),
               d > d0 || kk > 0);
    wgmma_commit();
    if (d > d0) {
      wgmma_wait<1>();
      mbar_arrive(&empty[(n - 1) % kSlots]);
    }
  }
  wgmma_wait<0>();
  mbar_arrive(&empty[(n - 1) % kSlots]);
  reg_fence(acc);
}

// The sum of one warpgroup's partial product (N floats a thread) over the
// same warpgroup of each of the R blocks of a thread-block cluster, added
// in rank order, so that every block holds the same sum to the bit. Y is
// this warpgroup's two buffers (by tile parity, N / 4 float4 a thread
// each); full[x] completes once all R blocks have written their partials
// of parity x (128 R arrivals, each thread on every block's barrier),
// empty[x] once all R have read them; j is the tile.
template <int N>
__device__ __forceinline__ void xl_cluster_sum(float (&acc)[N], float4* Y, uint64_t* full,
                                               uint64_t* empty, int j, int R) {
  const int x = j & 1;
  float4* mine = Y + x * (N / 4) * 128 + threadIdx.x % 128;
  if (j >= 2) mbar_wait_cluster(&empty[x], ((j >> 1) - 1) & 1);  // every block read it
#pragma unroll
  for (int v = 0; v < N / 4; ++v)
    mine[v * 128] = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
  for (int r = 0; r < R; ++r) mbar_arrive_peer(peer_addr(&full[x], r));
  mbar_wait_cluster(&full[x], (j >> 1) & 1);
#pragma unroll
  for (int v = 0; v < N / 4; ++v) {
    float4 s = ld_peer(peer_addr(mine + v * 128, 0));
    for (int r = 1; r < R; ++r) {
      const float4 o = ld_peer(peer_addr(mine + v * 128, r));
      s.x += o.x, s.y += o.y, s.z += o.z, s.w += o.w;
    }
    acc[4 * v] = s.x, acc[4 * v + 1] = s.y, acc[4 * v + 2] = s.z, acc[4 * v + 3] = s.w;
  }
  for (int r = 0; r < R; ++r) mbar_arrive_peer(peer_addr(&empty[x], r));
}

// After the warpgroup's barrier bar_id, copies the NB 64-column boxes from
// box c0 of rows [0, 64) of a [64, ...] bf16 tile in shared memory to
// global rows g_row0 + r < S and columns gcol0 + 64 (c0 + i) + c < dh of
// g ([S, dh] row-major), in 16-byte stores.
template <int NB>
__device__ __forceinline__ void copy_boxes(const unsigned char* tile, int c0, __nv_bfloat16* g,
                                           int dh, int g_row0, int S, int gcol0, int bar_id) {
  constexpr int kChunks = 8 * NB;  // 16-byte chunks of a row
  const int t = threadIdx.x % 128;
  warpgroup_sync(bar_id);
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int idx = t + 128 * i, row = idx / kChunks, col = 64 * c0 + (idx % kChunks) * 8;
    const int gcol = gcol0 + col;
    if (g_row0 + row < S && gcol < dh)
      *reinterpret_cast<uint4*>(g + (size_t)(g_row0 + row) * dh + gcol) =
          *reinterpret_cast<const uint4*>(tile + tile_offset(row, col, 64));
  }
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a [bh, s, dh] bf16 tensor in boxes of (64 columns, `rows`, 1),
// 128-byte swizzle, zero fill past every edge.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int bh, int s, int dh, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)s * dh * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace flash
