// Hopper's asynchronous building blocks, written as inline PTX: the
// mbarrier, the Tensor Memory Accelerator's 2-, 3- and 4-D tile loads, its
// 4-D im2col load and its 1-D bulk copy, the warpgroup matrix multiply
// (wgmma: bf16 m64n128k16 and m64n64k16 with both operands in shared
// memory, m64n64k16 and m64n128k16 with A in registers; s8 and fp8
// m64n128k32 from shared memory) with its shared-memory descriptors, and
// the host side of TMA tensor maps (2-D memoised, bf16 or 8-bit; 3- to
// 5-D; NHWC im2col).  Compiled for sm_90a only (wgmma exists on no other
// target).
//
// The layout every piece here assumes is the 128-byte swizzle: a TMA box
// is 128 bytes wide (64 bf16, or 128 8-bit elements, whose k32 step is the
// same 32 bytes as bf16's k16) and its rows land in shared memory 128 bytes
// apart, the 16-byte chunks of row r XOR-permuted by r % 8, so that eight
// rows (1024 bytes) form one swizzle atom.  Every tile starts on a
// 1024-byte boundary, so a descriptor's base offset is 0.  A wgmma operand
// is then either
//   K-major  (rows along M or N, the 64 k of a slice across a row): LBO
//            unused (16), SBO = 1024 bytes between groups of 8 rows, and
//            the k16 step of a slice moves the start 32 bytes along the row;
//   MN-major (rows along k, 64 of M or N across a row): SBO = 1024 bytes
//            between groups of 8 k, LBO = the bytes between 64-wide blocks
//            of M or N, and the k16 step moves the start 16 rows (2048
//            bytes).
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace repro {

// bf16 accumulation (the reference's accum_dtype=bfloat16): an fp32 sum
// rounded to bf16 in place at the end of each of the reference's blocks.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Whether a sum is rounded after slice i of `bk` reduction elements (of a
// walk ending before i_end): at each round_k end and at the last slice;
// never for round_k 0.
__device__ __forceinline__ bool round_after(int round_k, int i, int i_end,
                                            int bk) {
  return round_k && ((i + 1) * bk % round_k == 0 || i == i_end - 1);
}

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Synchronises the `count` threads that name barrier `id` (1-15; 0 is
// __syncthreads's), leaving the rest of the block out.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- TMA -------------------------------------------------------------------
// The box of `map` at element coordinates (c0 along the contiguous
// dimension, c1 along the rows) into shared memory at dst, completing on
// bar.  Elements outside the matrix arrive as zeros and still count as
// transferred bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same into a 3-D map (c2: the outer coordinate, a batch entry) and a
// 4-D one.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The im2col box of a 4-D NHWC map (tensor_map_im2col_bf16): the map's
// pixels-per-column pixels from pixel (w, h, n) on, walked along W, then H,
// then N inside the map's bounding box at its traversal strides, each
// moved by the tap (off_w, off_h) before it is read, channels c.. of each
// as one row of the box.  Pixels outside the image read as zeros.
__device__ __forceinline__ void tma_load_im2col_4d(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c,
                                                   int w, int h, int n,
                                                   uint16_t off_w,
                                                   uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(off_w), "h"(off_h)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory at src (16-byte
// aligned) into shared memory at dst (16-byte aligned), completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled operand at p.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulator across an
// asynchronous wgmma that is still writing it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The 64 accumulator registers of an m64n128 wgmma as asm operands, and
// their place holders.
#define REPRO_D64(C, d)                                                     \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),   \
  C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]),       \
  C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]),     \
  C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]),     \
  C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]),     \
  C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]),     \
  C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]),     \
  C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]),     \
  C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])
#define REPRO_F32(x) "+f"(x)
#define REPRO_S32(x) "+r"(x)
#define REPRO_REGS64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                               \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                               \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                               \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                               \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "

// d[64] += A (64 x 32, s8) @ B (32 x 128, s8) in s32, both operands
// K-major in shared memory (PTX has no transpose for 8-bit types); d's
// layout as wgmma_m64n128k16's.  The int32 sum is exact.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " REPRO_REGS64
      "%64, %65, p;\n"
      "}\n"
      : REPRO_D64(REPRO_S32, d)
      : "l"(da), "l"(db), "r"(1));
}

// Two fp8 values (the low byte first; FMT 0 e4m3, 1 e5m2) widened exactly
// to two f16 (the low half first): f16 holds every e4m3 and e5m2 value.
template <int FMT>
__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint32_t v) {
  uint32_t h;
  const uint16_t v16 = static_cast<uint16_t>(v);
  if constexpr (FMT == 0)
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h) : "h"(v16));
  else
    asm("cvt.rn.f16x2.e5m2x2 %0, %1;" : "=r"(h) : "h"(v16));
  return h;
}

// d[64] += A (64 x 16, f16) @ B (16 x 128, f16) in fp32, both K-major in
// shared memory; d's layout as wgmma_m64n128k16's.
__device__ __forceinline__ void wgmma_m64n128k16_f16(float (&d)[64],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " REPRO_REGS64
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_D64(REPRO_F32, d)
      : "l"(da), "l"(db), "r"(1));
}

// Makes this thread's writes to shared memory visible to the async proxy
// (wgmma and TMA read through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d[64] += A (64 x 16, bf16) @ B (16 x 128, bf16) in fp32, on this
// warpgroup.  TA / TB: A M-major / B N-major (1) or K-major (0).  Thread t
// of the warpgroup holds rows (t / 32) * 16 + (t % 32) / 4 (+ 8) and
// columns 8 j + 2 (t % 4) (+ 1): d[4 j + {0, 1}] on the first row, d[4 j +
// {2, 3}] on the row 8 below.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[32] (+)= A (64 x 16, bf16) @ B (16 x 64, bf16) in fp32, both operands
// from shared memory (descriptors da, db); TA / TB as wgmma_m64n128k16's.
// accumulate = 0 overwrites d.  d's layout: as wgmma_m64n128k16's, j < 8.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[32] += A (64 x 16, bf16, in registers) @ B (16 x 64, bf16, shared
// memory, descriptor db) in fp32.  TB as wgmma_m64n128k16's.  a[4]: this
// thread's A fragment, two bf16 a register (the lower column in the low
// half): rows (t / 32) * 16 + (t % 32) / 4 (+ 8), columns 2 (t % 4) (+ 1)
// (+ 8): a[0] row r columns c, c + 1; a[1] row r + 8; a[2] row r columns
// c + 8, c + 9; a[3] row r + 8 columns c + 8, c + 9 -- the accumulator's
// own layout, so a product's fp32 fragment becomes the next one's A by
// packing pairs.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// d[64] += A (64 x 16, bf16, in registers) @ B (16 x 128, bf16, shared
// memory, descriptor db) in fp32.  TB as wgmma_m64n128k16's.  a[4]: this
// thread's A fragment, two bf16 a register (the lower column in the low
// half): rows (t / 32) * 16 + (t % 32) / 4 (+ 8), columns 2 (t % 4) (+ 1)
// (+ 8): a[0] row r columns c, c + 1; a[1] row r + 8; a[2] row r columns
// c + 8, c + 9; a[3] row r + 8 columns c + 8, c + 9 -- the accumulator's
// own layout, so a product's fp32 fragment becomes the next one's A by
// packing pairs.
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// ---- host: tensor maps -----------------------------------------------------
// cuTensorMapEncodeTiled and cuTensorMapEncodeIm2col are driver-API
// functions; the kernels link only the runtime, so each is looked up once
// through the runtime's entry-point query.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaError_t rc =
      cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t rc = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) ? p
                                                                 : nullptr;
}

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

inline EncodeIm2col encode_im2col() {
  static const EncodeIm2col fn = reinterpret_cast<EncodeIm2col>(
      driver_entry("cuTensorMapEncodeIm2col"));
  return fn;
}

// A matrix of `rows` rows of `inner` contiguous elements of `esize` bytes
// (2: bf16; 1: int8 or fp8, read as bytes), rows `ld` elements apart
// (16-byte aligned base, ld * esize a multiple of 16), read in boxes of
// 128 bytes x box_rows with the 128-byte swizzle and zero fill outside.
// Returns false where the driver refuses it.
//
// The map is a function of these six values alone, and a decode step asks
// for the same weights' maps every step, so the last 4096 are remembered
// (direct-mapped on the base address; a hit is always the map the driver
// would encode again).
inline bool tensor_map(CUtensorMap* map, const void* base, uint64_t inner,
                       uint64_t rows, uint64_t ld, uint32_t box_rows,
                       int esize) {
  struct Entry {
    const void* base;
    uint64_t inner, rows, ld;
    uint32_t box_rows;
    int esize;
    CUtensorMap map;
  };
  constexpr int SLOTS = 4096;
  static Entry memo[SLOTS] = {};
  static std::mutex mu;
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  Entry& slot = memo[((a >> 4) ^ (a >> 16) ^ box_rows ^ esize) % SLOTS];
  {
    std::lock_guard<std::mutex> lock(mu);
    if (slot.base == base && slot.inner == inner && slot.rows == rows &&
        slot.ld == ld && slot.box_rows == box_rows && slot.esize == esize) {
      *map = slot.map;
      return true;
    }
  }
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {inner, rows};
  cuuint64_t strides[1] = {ld * esize};
  cuuint32_t box[2] = {128u / esize, box_rows};
  cuuint32_t elem[2] = {1, 1};
  if (enc(map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8,
          2, const_cast<void*>(base), dims, strides, box, elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  std::lock_guard<std::mutex> lock(mu);
  slot = Entry{base, inner, rows, ld, box_rows, esize, *map};
  return true;
}

// tensor_map's bf16 matrix: boxes of 64 elements x box_rows.
inline bool tensor_map_bf16(CUtensorMap* map, const void* base,
                            uint64_t inner, uint64_t rows, uint64_t ld,
                            uint32_t box_rows) {
  return tensor_map(map, base, inner, rows, ld, box_rows, 2);
}

// A contiguous bf16 NHWC tensor (n, h, w, c; c a multiple of 8, 16-byte
// aligned base) in im2col mode for an r x s window at `stride`, padded by
// `pad` on every side: a box is `pixels` output pixels' rows of 64
// channels (128 bytes, the 128-byte swizzle).  The bounding box of window
// corners runs from -pad to pad - (r - 1) past the last row (and alike
// for columns), walked at the conv stride, so that its pixels are the
// output pixels in (n, p, q) order; taps outside the image, channels past
// c and images past n read as zeros.  Returns false where the driver
// refuses it.
inline bool tensor_map_im2col_bf16(CUtensorMap* map, const void* base,
                                   uint64_t n, uint64_t h, uint64_t w,
                                   uint64_t c, int r, int s, int stride,
                                   int pad, uint32_t pixels) {
  EncodeIm2col enc = encode_im2col();
  if (enc == nullptr) return false;
  cuuint64_t dims[4] = {c, w, h, n};
  cuuint64_t strides[3] = {c * 2, w * c * 2, h * w * c * 2};
  int lower[2] = {-pad, -pad};                      // (w, h)
  int upper[2] = {pad - (s - 1), pad - (r - 1)};
  cuuint32_t elem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, lower, upper, 64,
             pixels, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor of `rank` (2-5) dimensions of `esize`-byte elements (2: bf16;
// 1: int8 or fp8, read as bytes), dims[0] contiguous, dimension i > 0
// strides[i - 1] elements apart (each a multiple of 16 bytes, 16-byte
// aligned base), read in boxes of box[] elements (box[0] * esize = 128
// bytes) with the 128-byte swizzle and zero fill outside.  Returns false
// where cuTensorMapEncodeTiled refuses it.  Not memoised: its callers
// launch few times a step.
inline bool tensor_map_nd(CUtensorMap* map, const void* base, int rank,
                          const uint64_t* dims, const uint64_t* strides,
                          const uint32_t* box, int esize) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr || rank < 2 || rank > 5) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t b[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    elem[i] = 1;
    if (i > 0) st[i - 1] = strides[i - 1] * esize;
  }
  return enc(map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             rank, const_cast<void*>(base), d, st, b, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tensor_map_nd of bf16 elements (box[0] = 64).
inline bool tensor_map_bf16_nd(CUtensorMap* map, const void* base, int rank,
                               const uint64_t* dims,
                               const uint64_t* strides,
                               const uint32_t* box) {
  return tensor_map_nd(map, base, rank, dims, strides, box, 2);
}

// tensor_map's matrix, one per batch entry, entries `bstride` elements
// apart: a 3-D map with the entry as its outer coordinate, boxes of 128
// bytes x box_rows x 1, so that the zero fill ends a ragged row inside an
// entry instead of reading the next entry's.
inline bool tensor_map_3d(CUtensorMap* map, const void* base, uint64_t inner,
                          uint64_t rows, uint64_t ld, uint64_t entries,
                          uint64_t bstride, uint32_t box_rows, int esize) {
  const uint64_t dims[3] = {inner, rows, entries};
  const uint64_t strides[2] = {ld, bstride};
  const uint32_t box[3] = {128u / esize, box_rows, 1};
  return tensor_map_nd(map, base, 3, dims, strides, box, esize);
}

// tensor_map_3d of bf16 elements: boxes of 64 x box_rows x 1.
inline bool tensor_map_bf16_3d(CUtensorMap* map, const void* base,
                               uint64_t inner, uint64_t rows, uint64_t ld,
                               uint64_t entries, uint64_t bstride,
                               uint32_t box_rows) {
  return tensor_map_3d(map, base, inner, rows, ld, entries, bstride,
                       box_rows, 2);
}

}  // namespace sm90
}  // namespace repro
