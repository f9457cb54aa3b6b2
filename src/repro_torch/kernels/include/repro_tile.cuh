// Shared device code of the tile GEMMs written after matmul.cu: the
// stacked and the batched batch-reduce GEMMs (kernels/brgemm_batched), the
// implicit-GEMM direct convolution (kernels/conv2d) and the quantized GEMMs
// (kernels/brgemm_quant).
//
// One block owns one 64 x 64 output tile and walks a sequence of
// reduction "slices".  What a slice is belongs to the caller, through two
// fetch functors: a k-block of one batch entry (batched), a k-block of
// each batch entry in turn (stacked), a block of the flattened (r, s, c)
// window of a convolution (conv2d).  The accumulator stays in registers
// (wmma fragments: fp32 for bf16 inputs, int32 for int8 inputs; plain
// registers and FMA for fp32 inputs: no TF32, so fp32 keeps fp32
// accuracy), and the epilogue runs on it before the single store.
// Everything but the input type is a run-time value, so each family
// compiles a handful of instances.
//
// A fetch functor F provides
//   F.init(t, r, c)   once per block: this thread's t-th piece sits at row r,
//                     column c of the staged tile (the orientation below);
//   F(slice, t)       that piece of the given slice, zero outside the
//                     operand: 8 bf16 values as a uint4 (tc), 16 int8
//                     values as a uint4 (i8) or one float (simt).
// Staging orientation: a tile is staged with the operand's memory rows as
// its rows, so each piece is a run of contiguous memory.  For A (m x k)
// that is As[m][k] (row-major A) or As[k][m] (A read column-major, as
// x.T is); for B (k x n) Bs[k][n] or Bs[n][k].  ``red_rows`` says that the
// staged rows run along the reduction.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

#include "repro_sm90.cuh"   // round_bf16

namespace repro {
using bf16 = __nv_bfloat16;

// Kept in the order of repro_torch/core/fusion.py::ACTIVATIONS.
enum Act { NONE = 0, RELU, SIGMOID, TANH, GELU, SILU, EXP, SQUARE, N_ACT };

template <int ACT>
__device__ __forceinline__ float act_fn(float x) {
  if constexpr (ACT == RELU) return fmaxf(x, 0.0f);
  else if constexpr (ACT == SIGMOID) return 1.0f / (1.0f + expf(-x));
  else if constexpr (ACT == TANH) return tanhf(x);
  else if constexpr (ACT == GELU)
    return 0.5f * x * (1.0f + tanhf(0.7978845608028654f *
                                    (x + 0.044715f * x * x * x)));
  else if constexpr (ACT == SILU) return x * (1.0f / (1.0f + expf(-x)));
  else if constexpr (ACT == EXP) return expf(x);
  else if constexpr (ACT == SQUARE) return x * x;
  else return x;
}

// Calls f(std::integral_constant<int, ACT>{}) for the run-time code act:
// a loop inside f then applies one activation with no switch per element.
template <typename F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  switch (act) {
    case RELU: f(std::integral_constant<int, RELU>{}); break;
    case SIGMOID: f(std::integral_constant<int, SIGMOID>{}); break;
    case TANH: f(std::integral_constant<int, TANH>{}); break;
    case GELU: f(std::integral_constant<int, GELU>{}); break;
    case SILU: f(std::integral_constant<int, SILU>{}); break;
    case EXP: f(std::integral_constant<int, EXP>{}); break;
    case SQUARE: f(std::integral_constant<int, SQUARE>{}); break;
    default: f(std::integral_constant<int, NONE>{}); break;
  }
}

__device__ __forceinline__ float apply_act(int act, float x) {
  float y = x;
  with_act(act, [&](auto a) { y = act_fn<decltype(a)::value>(x); });
  return y;
}

struct Epilogue {
  using Acc = float;   // the accumulator it takes
  void* out;           // rows of ld_out elements, fp32 or bf16
  const void* bias;    // (n,) or null, fp32 or the input type
  const void* c0;      // (m, n) with row stride ldc0, or null
  long long ld_out, ldc0;
  float alpha, beta;
  int act, out_f32, bias_f32, c0_f32;
};

__device__ __forceinline__ float load_as_float(const void* p, long long i,
                                               int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// The reference's epilogue order: alpha, beta * c0, bias, activation (ACT,
// chosen by the caller), then the cast as it is stored.
template <int ACT>
__device__ __forceinline__ float epilogue(const Epilogue& e, float acc,
                                          long long row, int col) {
  acc *= e.alpha;
  if (e.c0) acc += e.beta * load_as_float(e.c0, row * e.ldc0 + col, e.c0_f32);
  if (e.bias) acc += load_as_float(e.bias, col, e.bias_f32);
  return act_fn<ACT>(acc);
}

// The epilogue with e.act chosen per element, and the store.
__device__ __forceinline__ void finish(const Epilogue& e, float acc,
                                       long long row, int col) {
  acc = apply_act(e.act, epilogue<NONE>(e, acc, row, col));
  long long o = row * e.ld_out + col;
  if (e.out_f32) static_cast<float*>(e.out)[o] = acc;
  else static_cast<bf16*>(e.out)[o] = __float2bfloat16(acc);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// bf16 accumulation (the reference's accum_dtype=bfloat16): where a walk
// rounds its fp32 sums to bf16 in place, at the ends of the reference's
// reduction blocks.  The walk is cut into segments of `seg` slices (k of
// one batch entry, or one tap's channels), each into blocks of `every`
// slices counted from the segment's start; a block's last slice, and a
// segment's, is a rounding point.  every = 0: fp32 accumulation, never.
// The port's partial sum of a block is not rounded on its own before it is
// added, as the reference's is: the one difference, held to a band.
struct Round {
  int every = 0, seg = 1;
  __host__ __device__ __forceinline__ bool at(int sl) const {
    if (every == 0) return false;
    const int p = sl % seg + 1;
    return p % every == 0 || p == seg;
  }
};

// A strided 2-D operand, one matrix per batch entry: element (row, col) of
// entry i at p + i * bstride + row * ld + col, in memory order (rows are
// the reduction when red_rows).  fixed0 / fixed_n: this block's first index
// and the extent of the dimension that is not reduced; red_n: the
// reduction's extent; kb: slices per batch entry; batch0: the first entry.
// Slice sl reads entry batch0 + sl / kb at k0 = (sl % kb) * bk.
template <typename T>
struct Strided {
  const T* p;
  long long bstride, ld;
  int red_rows, fixed0, fixed_n, red_n, kb, batch0, vec;

  __device__ __forceinline__ void origin(int sl, int bk, const T*& base,
                                         int& rmax, int& cmax) const {
    int i = batch0 + sl / kb, k0 = (sl % kb) * bk;
    if (red_rows) {
      base = p + i * bstride + (long long)k0 * ld + fixed0;
      rmax = red_n - k0;
      cmax = fixed_n - fixed0;
    } else {
      base = p + i * bstride + (long long)fixed0 * ld + k0;
      rmax = fixed_n - fixed0;
      cmax = red_n - k0;
    }
  }
};

// A strided operand as the launchers receive it: element (row, col) of
// entry i at p + i * bstride + row * ld + col (trans = 0) or
// p + i * bstride + col * ld + row (trans = 1); bstride = 0 broadcasts one
// matrix to every entry.  vec: the wide loads of the tile are safe.
struct Operand {
  const void* p;
  long long bstride, ld;
  int trans, vec;
};

// A is (m, k) per entry: row-major, or column-major when trans (staged
// As[k][m]).  B is (k, n): row-major (staged Bs[k][n]) or column-major.
template <typename T>
__device__ __forceinline__ Strided<T> a_op(const Operand& a, int m0, int m,
                                           int k, int bk, int batch0) {
  return Strided<T>{static_cast<const T*>(a.p), a.bstride, a.ld, a.trans, m0,
                    m, k, cdiv(k, bk), batch0, a.vec};
}

template <typename T>
__device__ __forceinline__ Strided<T> b_op(const Operand& b, int n0, int n,
                                           int k, int bk, int batch0) {
  return Strided<T>{static_cast<const T*>(b.p), b.bstride, b.ld, !b.trans,
                    n0, n, k, cdiv(k, bk), batch0, b.vec};
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores through wmma.  128 threads = 4 warps in a 2 x 2
// grid, each warp a 32 x 32 piece of the 64 x 64 tile; BK = 32 per slice.
// ---------------------------------------------------------------------------
namespace tc {
namespace wmma = nvcuda::wmma;
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LD_RED = BM + 8;   // staged rows along the reduction: 32 x 64
constexpr int LD_FIX = BK + 8;   // staged rows along m or n: 64 x 32
constexpr int STAGE = 64 * LD_FIX > 32 * LD_RED ? 64 * LD_FIX : 32 * LD_RED;
constexpr int LDC = BN + 4;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 8 elements from row r, columns c.. of a row-major block at base (row
// stride ld): one 16-byte load where aligned and inside, else element by
// element with zero fill.
__device__ __forceinline__ uint4 load_chunk(const bf16* base, long long ld,
                                            int r, int c, int rmax, int cmax,
                                            int vec) {
  if (vec && r < rmax && c + 8 <= cmax)
    return *reinterpret_cast<const uint4*>(base + (long long)r * ld + c);
  union { uint4 v; unsigned short h[8]; } u;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    u.h[i] = (r < rmax && c + i < cmax)
                 ? __bfloat16_as_ushort(base[(long long)r * ld + c + i])
                 : (unsigned short)0;
  return u.v;
}

// Chunk t of this thread: 256 chunks of 8 cover a 64 x 32 tile.
__device__ __forceinline__ void chunk_at(int t, int red_rows, int& r,
                                         int& c) {
  int idx = threadIdx.x + t * THREADS;
  if (red_rows) { r = idx / 8; c = (idx % 8) * 8; }   // 32 rows of 64
  else          { r = idx / 4; c = (idx % 4) * 8; }   // 64 rows of 32
}

struct StridedFetch {
  Strided<bf16> op;
  int r[2], c[2];
  __device__ __forceinline__ void init(int t, int rr, int cc) {
    r[t] = rr;
    c[t] = cc;
  }
  __device__ __forceinline__ uint4 operator()(int sl, int t) const {
    const bf16* base;
    int rmax, cmax;
    op.origin(sl, BK, base, rmax, cmax);
    return load_chunk(base, op.ld, r[t], c[t], rmax, cmax, op.vec);
  }
};

template <typename LA, typename LB>
__device__ __forceinline__ void mma_slice(Acc (&acc)[2][2], const bf16* As,
                                          const bf16* Bs, int lda, int ldb,
                                          int wm, int wn) {
  constexpr bool A_ROW = std::is_same<LA, wmma::row_major>::value;
  constexpr bool B_ROW = std::is_same<LB, wmma::row_major>::value;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int m = wm * 32 + i * 16;
      wmma::load_matrix_sync(fa[i], A_ROW ? &As[m * lda + kk]
                                          : &As[kk * lda + m], lda);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int n = wn * 32 + j * 16;
      wmma::load_matrix_sync(fb[j], B_ROW ? &Bs[kk * ldb + n]
                                          : &Bs[n * ldb + kk], ldb);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// The staged piece as fetched (bf16 operands).
struct Same {
  __device__ __forceinline__ uint4 operator()(uint4 v) const { return v; }
};

// acc = sum over the slices of A_slice @ B_slice.  a_red_rows: A staged
// As[k][m] (column-major A); b_red_rows: B staged Bs[k][n] (row-major B).
// The next slice is fetched into registers while the current one is
// multiplied.  wa / wb turn a fetched piece into its 8 bf16 values as it
// is stored to shared memory, after the products it overlapped (a fetch
// of narrower storage returns raw bytes and widens there, so that the
// widening does not wait on the load).
// rnd: the slices after which the fp32 sums are rounded to bf16 in place
// (bf16 accumulation; none by default).
template <typename FA, typename FB, typename WA = Same, typename WB = Same>
__device__ __forceinline__ void mainloop(Acc (&acc)[2][2], bf16* As, bf16* Bs,
                                         int a_red_rows, int b_red_rows,
                                         int slices, FA& fa, FB& fb,
                                         WA wa = {}, WB wb = {},
                                         Round rnd = {}) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  const int lda = a_red_rows ? LD_RED : LD_FIX;
  const int ldb = b_red_rows ? LD_RED : LD_FIX;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  int a_off[2], b_off[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    int r, c;
    chunk_at(t, a_red_rows, r, c);
    fa.init(t, r, c);
    a_off[t] = r * lda + c;
    chunk_at(t, b_red_rows, r, c);
    fb.init(t, r, c);
    b_off[t] = r * ldb + c;
  }
  if (slices <= 0) return;
  uint4 ra[2], rb[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) { ra[t] = fa(0, t); rb[t] = fb(0, t); }
  using RM = wmma::row_major;
  using CM = wmma::col_major;
  for (int sl = 0; sl < slices; ++sl) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      *reinterpret_cast<uint4*>(&As[a_off[t]]) = wa(ra[t]);
      *reinterpret_cast<uint4*>(&Bs[b_off[t]]) = wb(rb[t]);
    }
    __syncthreads();
    if (sl + 1 < slices) {
#pragma unroll
      for (int t = 0; t < 2; ++t) { ra[t] = fa(sl + 1, t); rb[t] = fb(sl + 1, t); }
    }
    if (a_red_rows) {
      if (b_red_rows) mma_slice<CM, RM>(acc, As, Bs, lda, ldb, wm, wn);
      else mma_slice<CM, CM>(acc, As, Bs, lda, ldb, wm, wn);
    } else {
      if (b_red_rows) mma_slice<RM, RM>(acc, As, Bs, lda, ldb, wm, wn);
      else mma_slice<RM, CM>(acc, As, Bs, lda, ldb, wm, wn);
    }
    if (rnd.at(sl)) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < acc[i][j].num_elements; ++e)
            acc[i][j].x[e] = round_bf16(acc[i][j].x[e]);
    }
    __syncthreads();
  }
}

// Hands each element of the 64 x 64 accumulator to store(r, c, value),
// neighbouring threads on neighbouring columns.
template <typename Store>
__device__ __forceinline__ void store_tile(Acc (&acc)[2][2], float* Cs,
                                           Store store) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS)
    store(idx / BN, idx % BN, Cs[(idx / BN) * LDC + idx % BN]);
}
}  // namespace tc

// ---------------------------------------------------------------------------
// int8 inputs: tensor cores through wmma (s8 x s8 -> s32), the int32 sum
// exact.  128 threads = 4 warps in a 2 x 2 grid, each warp a 32 x 32 piece
// of the 64 x 64 tile; BK = 64 per slice, so a staged tile is 64 x 64 bytes
// in either orientation and each thread moves two 16-byte pieces of A and
// two of B per slice.  An int8 fragment starts 16 bytes apart along a row,
// and wmma wants 32-byte aligned fragments, so a tile is staged as four
// planes of 16 columns (64 rows x 16 bytes each, the fragment's 16 x 16
// bytes contiguous): element (r, c) at (c / 16) * PLANE + r * 16 + c % 16.
// The 32 bytes between planes spread a warp's staging stores over the
// banks.
// ---------------------------------------------------------------------------
namespace i8 {
namespace wmma = nvcuda::wmma;
constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;
constexpr int PLANE = 64 * 16 + 32;
constexpr int STAGE = 4 * PLANE;
constexpr int LDC = BN + 4;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

__device__ __forceinline__ int at(int r, int c) {
  return (c / 16) * PLANE + r * 16 + c % 16;
}

// 16 elements from row r, columns c.. of a row-major block at base (row
// stride ld): one 16-byte load where aligned and inside, else element by
// element with zero fill.
__device__ __forceinline__ uint4 load_chunk(const signed char* base,
                                            long long ld, int r, int c,
                                            int rmax, int cmax, int vec) {
  if (vec && r < rmax && c + 16 <= cmax)
    return *reinterpret_cast<const uint4*>(base + (long long)r * ld + c);
  union { uint4 v; signed char b[16]; } u;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    u.b[i] = (r < rmax && c + i < cmax) ? base[(long long)r * ld + c + i]
                                        : (signed char)0;
  return u.v;
}

// Chunk t of this thread: 256 chunks of 16 cover a 64 x 64 tile, four
// neighbouring threads on one 64-byte run of memory.
__device__ __forceinline__ void chunk_at(int t, int& r, int& c) {
  int idx = threadIdx.x + t * THREADS;
  r = idx / 4;
  c = (idx % 4) * 16;
}

struct StridedFetch {
  Strided<signed char> op;
  int r[2], c[2];
  __device__ __forceinline__ void init(int t, int rr, int cc) {
    r[t] = rr;
    c[t] = cc;
  }
  __device__ __forceinline__ uint4 operator()(int sl, int t) const {
    const signed char* base;
    int rmax, cmax;
    op.origin(sl, BK, base, rmax, cmax);
    return load_chunk(base, op.ld, r[t], c[t], rmax, cmax, op.vec);
  }
};

template <typename LA, typename LB>
__device__ __forceinline__ void mma_slice(Acc (&acc)[2][2],
                                          const signed char* As,
                                          const signed char* Bs, int wm,
                                          int wn) {
  constexpr bool A_ROW = std::is_same<LA, wmma::row_major>::value;
  constexpr bool B_ROW = std::is_same<LB, wmma::row_major>::value;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, LA> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, LB> fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int m = wm * 32 + i * 16;
      wmma::load_matrix_sync(fa[i], &As[A_ROW ? at(m, kk) : at(kk, m)], 16);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int n = wn * 32 + j * 16;
      wmma::load_matrix_sync(fb[j], &Bs[B_ROW ? at(kk, n) : at(n, kk)], 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// acc = sum over the slices of A_slice @ B_slice, as tc::mainloop.
template <typename FA, typename FB>
__device__ __forceinline__ void mainloop(Acc (&acc)[2][2], signed char* As,
                                         signed char* Bs, int a_red_rows,
                                         int b_red_rows, int slices, FA& fa,
                                         FB& fb) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  int off[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    int r, c;
    chunk_at(t, r, c);
    fa.init(t, r, c);
    fb.init(t, r, c);
    off[t] = at(r, c);
  }
  if (slices <= 0) return;
  uint4 ra[2], rb[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) { ra[t] = fa(0, t); rb[t] = fb(0, t); }
  using RM = wmma::row_major;
  using CM = wmma::col_major;
  for (int sl = 0; sl < slices; ++sl) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      *reinterpret_cast<uint4*>(&As[off[t]]) = ra[t];
      *reinterpret_cast<uint4*>(&Bs[off[t]]) = rb[t];
    }
    __syncthreads();
    if (sl + 1 < slices) {
#pragma unroll
      for (int t = 0; t < 2; ++t) { ra[t] = fa(sl + 1, t); rb[t] = fb(sl + 1, t); }
    }
    if (a_red_rows) {
      if (b_red_rows) mma_slice<CM, RM>(acc, As, Bs, wm, wn);
      else mma_slice<CM, CM>(acc, As, Bs, wm, wn);
    } else {
      if (b_red_rows) mma_slice<RM, RM>(acc, As, Bs, wm, wn);
      else mma_slice<RM, CM>(acc, As, Bs, wm, wn);
    }
    __syncthreads();
  }
}

// Hands each element of the 64 x 64 int32 accumulator to
// store(r, c, value), neighbouring threads on neighbouring columns.
template <typename Store>
__device__ __forceinline__ void store_tile(Acc (&acc)[2][2], int* Cs,
                                           Store store) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS)
    store(idx / BN, idx % BN, Cs[(idx / BN) * LDC + idx % BN]);
}
}  // namespace i8

// ---------------------------------------------------------------------------
// fp32 inputs: FMA on the CUDA cores.  256 threads, each a 4 x 4 piece of
// the 64 x 64 tile (rows ty + 16 i, columns tx + 16 j); BK = 16 per slice.
// ---------------------------------------------------------------------------
namespace simt {
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

// Element t (0..3) of this thread: 1024 elements cover a 64 x 16 tile.
// When the staged rows run along the reduction, neighbouring threads take
// neighbouring m (or n) indices; otherwise neighbouring k indices: either
// way they read neighbouring addresses.  f is the m or n index, kk the
// reduction index inside the slice.
__device__ __forceinline__ void elem_at(int t, int red_rows, int& f,
                                        int& kk) {
  int idx = threadIdx.x + t * THREADS;
  if (red_rows) { f = idx % 64; kk = idx / 64; }
  else          { f = idx / BK; kk = idx % BK; }
}

struct StridedFetch {
  Strided<float> op;
  int f[4], kk[4];
  __device__ __forceinline__ void init(int t, int ff, int k) {
    f[t] = ff;
    kk[t] = k;
  }
  __device__ __forceinline__ float operator()(int sl, int t) const {
    const float* base;
    int rmax, cmax;
    op.origin(sl, BK, base, rmax, cmax);
    int r = op.red_rows ? kk[t] : f[t], c = op.red_rows ? f[t] : kk[t];
    return (r < rmax && c < cmax) ? base[(long long)r * op.ld + c] : 0.0f;
  }
};

template <typename FA, typename FB>
__device__ __forceinline__ void mainloop(float (&acc)[4][4], int a_red_rows,
                                         int b_red_rows, int slices, FA& fa,
                                         FB& fb, Round rnd = {}) {
  __shared__ float As[BK][BM + 4];   // As[kk][m]
  __shared__ float Bs[BK][BN + 4];   // Bs[kk][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int af[4], ak[4], bf[4], bk[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    elem_at(t, a_red_rows, af[t], ak[t]);
    fa.init(t, af[t], ak[t]);
    elem_at(t, b_red_rows, bf[t], bk[t]);
    fb.init(t, bf[t], bk[t]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int sl = 0; sl < slices; ++sl) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      As[ak[t]][af[t]] = fa(sl, t);
      Bs[bk[t]][bf[t]] = fb(sl, t);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (rnd.at(sl)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = round_bf16(acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename Store>
__device__ __forceinline__ void store_tile(float (&acc)[4][4], Store store) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) store(ty + 16 * i, tx + 16 * j, acc[i][j]);
}
}  // namespace simt
}  // namespace repro
