// The quantized batch-reduce GEMMs on Hopper, the dequant fused into the
// epilogue:
//
//   matmul_q:         C   = act(alpha * (Xq @ Wq) * (sx x sw) + bias)
//                     replaces src/repro/kernels/brgemm/quant_kernel.py::
//                     matmul_q_pallas;
//   brgemm_q:         C   = act(alpha * (sum_i Aq_i @ Bq_i) * (sa x sb) + bias)
//                     replaces quant_kernel.py::brgemm_q_pallas;
//   batched_matmul_q: C_i = act(alpha * (Aq_i @ Bq_i) * (sa_i x sb_i) + bias)
//                     replaces quant_kernel.py::batched_matmul_q_pallas.
//
// Each runs one of two mainloops, planned per call by the wrapper
// (kernels/brgemm/quant_kernel.py::plan_q, plan_q_stacked, plan_q_batched)
// from the operands' layouts:
//
//   * wgmma (repro_matmul_q, repro_brgemm_q, repro_batched_matmul_q): the
//     shared wgmma + TMA mainloop of include/repro_gemm_sm90.cuh, its ring
//     filled with 8-bit slices of 128 elements of k (128 bytes, the
//     128-byte swizzle's width), 128 (or 64, for m <= 64) x 128 tiles, the
//     dequant as the shared sink's epilogue (Dequant; DequantEntry for
//     batched_matmul_q's per-entry scales).  s8 runs native 8-bit wgmma
//     (m64n128k32 into int32).  fp8 (e4m3 / e5m2, each operand its own
//     format) is widened exactly to f16 in shared memory, a slice at a
//     time, for f16 wgmma into fp32 on 64-row tiles: Hopper's fp8 wgmma
//     adds its products in fewer bits than fp32 keeps, even when its sums
//     are moved into fp32 registers after every k32 step (PERF.md), and
//     the reference sums in fp32.  TMA reads 8-bit operands K-major only,
//     so X (A) must be row-major and W (B) column-major: the calibrated
//     weights are stored so (core/quantize.py::quantize_weight), the LM
//     head's table.T is so already, and the batched ops' routing
//     quantizes B so (kernels/brgemm/quant.py).  matmul_q walks SPLIT_K;
//     brgemm_q the STACKED walk, the batch folded into the reduction (the
//     nb entries' slices through 3-D maps, each entry's ragged k ended by
//     TMA's zero fill), split as matmul_q's k where the tiles alone leave
//     SMs idle; batched_matmul_q the PER_ENTRY walk, an entry a
//     blockIdx.z, a 2-D map for an operand broadcast over the batch.
//     Split partials (int32 for s8, exact in any order; fp32 for fp8,
//     added in split order) are summed by the shared reduction, which then
//     runs the dequant.
//   * wmma (repro_quant_gemm, the first kernel of this family, kept for
//     operands TMA or wgmma cannot take: an N-major 8-bit W or B, rows
//     that are not 16-byte aligned): one 128-thread block a 64 x 64 tile,
//     s8 on wmma with int32 accumulators (repro_tile.cuh, namespace i8),
//     fp8 converted exactly to bf16 as it is staged (Widen) for tc's bf16
//     wmma with fp32 accumulators.
//
// One kernel serves the three on the wmma mainloop, as the batched
// family's does: matmul_q is the stacked form with one entry, brgemm_q
// walks the k-blocks of every entry in turn into one accumulator and
// dequantizes once (its scales are batch-shared, one per output row and
// channel), batched_matmul_q takes its entry from blockIdx.z with
// per-entry scale rows.  On either mainloop a 2-D operand or scale row
// broadcast over the batch has batch stride 0: it is read again by every
// entry, never copied.  The TPU kernels' lane-broadcast scale layouts
// (SCALE_LANES, _row_scales) are a TPU idiom and are not carried over: a
// scale is read where it lies, through a stride (0 for an expanded view).
//
// Both are exact where the reference is: the int32 sum of s8 products is
// exact (k * 127^2 < 2^31 for every reduction here: k <= 1536 in smollm,
// B * k <= 16,384 in the paper's cases), so before the epilogue the kernel
// equals the plain version bit for bit.  Every e4m3 and e5m2 product is
// exact in fp32: the wmma tiles add them in fp32, so they compute what the
// reference's fp32-upcast dot does up to the order of the sums, on either
// mainloop (both widen fp8 exactly, to bf16 or f16, and sum in fp32).  The
// epilogue keeps the reference's rounding: acc * (sx[r] * sw[c]), then *
// alpha, then + bias, each rounded on its own (__fmul_rn / __fadd_rn: nvcc
// would otherwise contract a multiply and an add into one FMA), then the
// activation, then the cast to the output type.
//
// What bounds it on an H100: serving's decode (m = 8 rows) does 2 * 8 ops
// a weight byte, so the bound is the bytes of W, which 8-bit storage
// halves against bf16; there the plan splits k so that a layer's few
// output tiles still draw W from enough SMs.  Prefill (m = 4096) and the
// batched ops' (8, 4096, 1024, 1024) case are tensor-core work: s8 at the
// 8-bit peak of 1,979 TOP/s, which native 8-bit wgmma reaches for at
// twice bf16's rate; fp8, widened, at f16's (bf16's).  The paper's small
// brgemm cases (m, n <= 128) make one or a few output tiles: a launch,
// a ring fill and an epilogue (and, split, the reduction) are their time.
//
// Ragged m, n and k: TMA's zero fill (wgmma), or masks inside the kernel
// (wmma: zero-filled tiles, guarded stores; 16-byte int8 loads need
// k-runs of 16 aligned bytes and 8-byte fp8 loads 8, otherwise the fetch
// goes element by element).
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include "repro_gemm_sm90.cuh"

using namespace repro;

enum Fmt { S8 = 0, E4M3 = 1, E5M2 = 2 };

// A fp32 scale vector per batch entry: element (i, r) at p + i * bstride +
// r * stride.
struct Scales {
  const float* p;
  long long bstride, stride;
  __device__ __forceinline__ float at(int i, int r) const {
    return p[i * bstride + r * stride];
  }
};

struct QEpilogue {
  void* out;           // rows of n elements, fp32 or bf16
  const void* bias;    // (n,) or null, fp32 or bf16
  Scales rows, cols;
  int m, n;
  float alpha;
  int act, out_f32, bias_f32;
};

// The reference's dequant epilogue for output element (r, c) of entry z.
__device__ __forceinline__ void finish_q(const QEpilogue& e, float acc, int z,
                                         int r, int c) {
  float s = __fmul_rn(e.rows.at(z, r), e.cols.at(z, c));
  float v = __fmul_rn(__fmul_rn(acc, s), e.alpha);
  if (e.bias) v = __fadd_rn(v, load_as_float(e.bias, c, e.bias_f32));
  v = apply_act(e.act, v);
  long long o = ((long long)z * e.m + r) * e.n + c;
  if (e.out_f32) static_cast<float*>(e.out)[o] = v;
  else static_cast<bf16*>(e.out)[o] = __float2bfloat16(v);
}

// 8 fp8 values (in .x, .y) to 8 bf16 values, exactly (fp8 -> half ->
// float -> bf16, each step exact for both formats).
struct Widen {
  int fmt;
  __device__ __forceinline__ uint4 operator()(uint4 v) const {
    const __nv_fp8_interpretation_t kind =
        fmt == E5M2 ? __NV_E5M2 : __NV_E4M3;
    const unsigned int words[2] = {v.x, v.y};
    unsigned int out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_fp8x2_storage_t pair =
          (__nv_fp8x2_storage_t)((words[i / 2] >> (16 * (i % 2))) & 0xffffu);
      __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(pair, kind));
      float2 f = __half22float2(h);
      __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
      out[i] = *reinterpret_cast<const unsigned int*>(&b);
    }
    return make_uint4(out[0], out[1], out[2], out[3]);
  }
};

// The fp8 operand's piece of a tc (bf16) tile: the 8 fp8 bytes of row r,
// columns c.. of the slice, raw in .x and .y; Widen makes them 8 bf16
// values when they are staged.
struct Fp8Fetch {
  Strided<unsigned char> op;
  int r[2], c[2];
  __device__ __forceinline__ void init(int t, int rr, int cc) {
    r[t] = rr;
    c[t] = cc;
  }
  __device__ __forceinline__ uint4 operator()(int sl, int t) const {
    const unsigned char* base;
    int rmax, cmax;
    op.origin(sl, tc::BK, base, rmax, cmax);
    const int rr = r[t], cc = c[t];
    union { uint2 v; unsigned char b[8]; } u;
    if (op.vec && rr < rmax && cc + 8 <= cmax) {
      u.v = *reinterpret_cast<const uint2*>(base + (long long)rr * op.ld + cc);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        u.b[i] = (rr < rmax && cc + i < cmax)
                     ? base[(long long)rr * op.ld + cc + i] : (unsigned char)0;
    }
    return make_uint4(u.v.x, u.v.y, 0u, 0u);   // fp8 zero bytes are +0.0
  }
};

// One block: output tile (blockIdx.y, blockIdx.x) of entry blockIdx.z,
// summed over `entries` batch entries from entry blockIdx.z on (stacked:
// grid.z = 1, entries = B; batched: entries = 1).
template <bool INT8>
__global__ void __launch_bounds__(128)
quant_gemm_kernel(Operand a, Operand b, QEpilogue e, int k, int entries,
                  int fmt_a, int fmt_b) {
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  auto store = [&](int r, int c, float v) {
    if (m0 + r < e.m && n0 + c < e.n) finish_q(e, v, z, m0 + r, n0 + c);
  };
  if constexpr (INT8) {
    __shared__ __align__(128) signed char As[i8::STAGE];
    __shared__ __align__(128) signed char Bs[i8::STAGE];
    __shared__ __align__(128) int Cs[i8::BM * i8::LDC];
    i8::StridedFetch fa{a_op<signed char>(a, m0, e.m, k, i8::BK, z)};
    i8::StridedFetch fb{b_op<signed char>(b, n0, e.n, k, i8::BK, z)};
    i8::Acc acc[2][2];
    i8::mainloop(acc, As, Bs, a.trans, !b.trans,
                 entries * cdiv(k, i8::BK), fa, fb);
    i8::store_tile(acc, Cs, [&](int r, int c, int v) {
      store(r, c, __int2float_rn(v));
    });
  } else {
    __shared__ __align__(128) bf16 As[tc::STAGE];
    __shared__ __align__(128) bf16 Bs[tc::STAGE];
    __shared__ __align__(128) float Cs[tc::BM * tc::LDC];
    Fp8Fetch fa{a_op<unsigned char>(a, m0, e.m, k, tc::BK, z)};
    Fp8Fetch fb{b_op<unsigned char>(b, n0, e.n, k, tc::BK, z)};
    tc::Acc acc[2][2];
    tc::mainloop(acc, As, Bs, a.trans, !b.trans, entries * cdiv(k, tc::BK),
                 fa, fb, Widen{fmt_a}, Widen{fmt_b});
    tc::store_tile(acc, Cs, store);
  }
}

// a: entries (m, k), b: entries (k, n), each an Operand (repro_tile.cuh;
// vec: 16-byte int8 or 8-byte fp8 loads are safe).  fmt_a / fmt_b: S8 for
// both, or E4M3 / E5M2 each.  Row scales sr (m per entry) and column scales
// sc (n per entry), fp32, read through their strides.  stacked: sum over
// the nb entries into one (m, n) output (nb = 1: matmul_q); else nb
// outputs (nb, m, n).  bias may be null.  Returns the launch's
// cudaGetLastError().
extern "C" int repro_quant_gemm(
    const void* a, long long a_bstride, long long lda, int a_trans, int vec_a,
    const void* b, long long b_bstride, long long ldb, int b_trans, int vec_b,
    const float* sr, long long sr_bstride, long long sr_stride,
    const float* sc, long long sc_bstride, long long sc_stride,
    const void* bias, void* out, int nb, int m, int n, int k, int stacked,
    float alpha, int act, int fmt_a, int fmt_b, int out_f32, int bias_f32,
    void* stream) {
  if (act < 0 || act >= N_ACT || nb <= 0) return (int)cudaErrorInvalidValue;
  if ((fmt_a == S8) != (fmt_b == S8)) return (int)cudaErrorInvalidValue;
  Operand oa{a, a_bstride, lda, a_trans, vec_a};
  Operand ob{b, b_bstride, ldb, b_trans, vec_b};
  QEpilogue e{out, bias, Scales{sr, sr_bstride, sr_stride},
              Scales{sc, sc_bstride, sc_stride}, m, n, alpha, act, out_f32,
              bias_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(cdiv(n, 64), cdiv(m, 64), stacked ? 1 : nb);
  const int entries = stacked ? nb : 1;
  if (fmt_a == S8)
    quant_gemm_kernel<true><<<grid, 128, 0, st>>>(oa, ob, e, k, entries,
                                                  fmt_a, fmt_b);
  else
    quant_gemm_kernel<false><<<grid, 128, 0, st>>>(oa, ob, e, k, entries,
                                                   fmt_a, fmt_b);
  return (int)cudaGetLastError();
}

// Runs run(T{}) for the operand types of fmt_a / fmt_b: wg::S8, or
// wg::F8<fa, fb> (0 e4m3, 1 e5m2 each).
template <typename F>
static int by_types(int fmt_a, int fmt_b, F&& run) {
  if (fmt_a == S8) return run(wg::S8{});
  if (fmt_a == E4M3)
    return fmt_b == E4M3 ? run(wg::F8<0, 0>{}) : run(wg::F8<0, 1>{});
  return fmt_b == E4M3 ? run(wg::F8<1, 0>{}) : run(wg::F8<1, 1>{});
}

// matmul_q on the wgmma mainloop: x (m, k) row-major, rows ldx elements
// apart, and w (k, n) column-major, columns ldw apart (both 16-byte
// aligned, ldx and ldw multiples of 16); fmt_a / fmt_b: S8 for both, or
// E4M3 / E5M2 each.  Scales sx (m,) and sw (n,) fp32 through their
// strides; bias (n,) or null.  The plan (quant_kernel.py::plan_q): bm (64
// or 128), splits and chunk (128-element slices a split); ws: a (splits,
// m, n) workspace of int32 (s8) or fp32 (fp8) when splits > 1.  Returns
// the first CUDA error of the launches, or 0.
extern "C" int repro_matmul_q(
    const void* x, long long ldx, const void* w, long long ldw,
    const float* sx, long long sx_stride, const float* sw,
    long long sw_stride, const void* bias, void* out, int m, int n, int k,
    float alpha, int act, int fmt_a, int fmt_b, int out_f32, int bias_f32,
    int bm, int splits, int chunk, void* ws, void* stream) {
  if (act < 0 || act >= N_ACT || splits < 1 || chunk < 1 ||
      (splits > 1 && ws == nullptr) || (fmt_a == S8) != (fmt_b == S8))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!sm90::tensor_map(&tx, x, k, m, ldx, bm, 1) ||
      !sm90::tensor_map(&tw, w, k, n, ldw, wg::BN, 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_types(fmt_a, fmt_b, [&](auto types) {
    using T = decltype(types);
    using A = typename T::Acc;
    const Dequant<A> e{out, bias, sx, sw, sx_stride, sw_stride, n, alpha,
                       act, out_f32, bias_f32};
    const SinkOf<Dequant<A>> sink{e, splits > 1 ? static_cast<A*>(ws)
                                                : nullptr, m, n};
    int rc = wg::launch_8bit<wg::SPLIT_K, T>(bm, tx, tw, 0, 0, sink, k,
                                             splits, chunk, 1, st);
    if (rc == 0 && splits > 1)
      rc = wg::reduce_splits(static_cast<const A*>(ws), e, m, n, splits, st);
    return rc;
  });
}

// The batched ops' wgmma maps: A (m, k) an entry, row-major, rows lda
// apart; B (k, n) an entry, column-major, columns ldb apart; entries
// a_bstride / b_bstride elements apart, each a 3-D map with the entry as
// its outer coordinate, so that the zero fill ends a ragged k inside an
// entry (batch stride 0: one matrix for every entry, a 2-D map).  Bases
// 16-byte aligned, lda, ldb and the batch strides multiples of 16.
static bool batched_maps(CUtensorMap* ta, CUtensorMap* tb, const void* a,
                         long long a_bstride, long long lda, const void* b,
                         long long b_bstride, long long ldb, int nb, int m,
                         int n, int k, int bm) {
  auto map = [&](CUtensorMap* t, const void* p, long long bstride,
                 long long ld, int rows, uint32_t box_rows) {
    return bstride ? sm90::tensor_map_3d(t, p, k, rows, ld, nb, bstride,
                                         box_rows, 1)
                   : sm90::tensor_map(t, p, k, rows, ld, box_rows, 1);
  };
  return map(ta, a, a_bstride, lda, m, bm) &&
         map(tb, b, b_bstride, ldb, n, wg::BN);
}

// brgemm_q on the wgmma mainloop: aq (nb, m, k), each entry row-major, and
// bq (nb, k, n), each entry column-major (maps: batched_maps); scales
// sa (m,) and sb (n,), batch-shared, through their strides.  The plan
// (quant_kernel.py::plan_q_stacked): bm, splits and chunk (slices of the
// nb * ceil(k / 128) stacked slices a split); ws as repro_matmul_q's.
extern "C" int repro_brgemm_q(
    const void* a, long long a_bstride, long long lda, const void* b,
    long long b_bstride, long long ldb, const float* sa, long long sa_stride,
    const float* sb, long long sb_stride, const void* bias, void* out,
    int nb, int m, int n, int k, float alpha, int act, int fmt_a, int fmt_b,
    int out_f32, int bias_f32, int bm, int splits, int chunk, void* ws,
    void* stream) {
  if (act < 0 || act >= N_ACT || nb < 1 || k < 1 || splits < 1 ||
      chunk < 1 || (splits > 1 && ws == nullptr) ||
      (fmt_a == S8) != (fmt_b == S8))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!batched_maps(&ta, &tb, a, a_bstride, lda, b, b_bstride, ldb, nb, m,
                    n, k, bm))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_types(fmt_a, fmt_b, [&](auto types) {
    using T = decltype(types);
    using A = typename T::Acc;
    const Dequant<A> e{out, bias, sa, sb, sa_stride, sb_stride, n, alpha,
                       act, out_f32, bias_f32};
    A* const w = splits > 1 ? static_cast<A*>(ws) : nullptr;
    int rc = wg::launch_8bit<wg::STACKED, T>(
        bm, ta, tb, a_bstride != 0, b_bstride != 0,
        SinkOf<Dequant<A>>{e, w, m, n}, k, splits, chunk, nb, st);
    if (rc == 0 && splits > 1)
      rc = wg::reduce_splits(static_cast<const A*>(w), e, m, n, splits, st);
    return rc;
  });
}

// batched_matmul_q on the wgmma mainloop: aq (nb, m, k) or a 2-D (m, k)
// broadcast (a_bstride 0), each entry row-major; bq (nb, k, n) or a 2-D
// (k, n) (b_bstride 0), each entry column-major; scales per entry through
// their entry and element strides (entry stride 0: one shared row).  The
// plan (quant_kernel.py::plan_q_batched): bm; one split, an entry a block
// column of the grid.  out: (nb * m, n) rows.
extern "C" int repro_batched_matmul_q(
    const void* a, long long a_bstride, long long lda, const void* b,
    long long b_bstride, long long ldb, const float* sa,
    long long sa_bstride, long long sa_stride, const float* sb,
    long long sb_bstride, long long sb_stride, const void* bias, void* out,
    int nb, int m, int n, int k, float alpha, int act, int fmt_a, int fmt_b,
    int out_f32, int bias_f32, int bm, void* stream) {
  if (act < 0 || act >= N_ACT || nb < 1 || nb > 65535 || m < 1 || k < 1 ||
      (long long)nb * m > 0x7fffffffLL || (fmt_a == S8) != (fmt_b == S8))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!batched_maps(&ta, &tb, a, a_bstride, lda, b, b_bstride, ldb, nb, m,
                    n, k, bm))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_types(fmt_a, fmt_b, [&](auto types) {
    using T = decltype(types);
    using A = typename T::Acc;
    const DequantEntry<A> e{out, bias, sa, sb, sa_bstride, sa_stride,
                            sb_bstride, sb_stride, n, m, alpha, act,
                            out_f32, bias_f32};
    return wg::launch_8bit<wg::PER_ENTRY, T>(
        bm, ta, tb, a_bstride != 0, b_bstride != 0,
        SinkOf<DequantEntry<A>>{e, nullptr, m, n}, k, nb, cdiv(k, 128), nb,
        st);
  });
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
