// The batch-reduce GEMM on Hopper: C = act(alpha * X @ W + beta * C0 + bias).
//
// Replaces src/repro/kernels/brgemm/kernel.py::matmul_pallas (body
// _make_body).  On the TPU the K axis was a sequential "arbitrary" grid axis
// carrying an fp32 accumulator in VMEM scratch; here each block owns one
// BM x BN output tile and walks K in a loop of its own, with the fp32
// accumulator in registers (wmma fragments, or plain registers on the fp32
// path).  The epilogue runs on that accumulator before the single store, in
// the reference's order: alpha, then beta * c0, then bias, then the
// activation, then the cast to the output type.
//
// What bounds it on an H100: the main path's GEMMs are of two kinds.
//   * Prefill (m = batch * prompt = 4096, k, n <= 1536): about 290-580
//     FLOP per byte moved, at or above the bf16 ridge (~295), so tensor-core
//     throughput.  The bf16 path uses the tensor cores through nvcuda::wmma
//     (mma.sync underneath) on 64 x 64 tiles staged in shared memory; the
//     next K slice is fetched into registers while the current one is
//     multiplied.  wgmma, TMA and a persistent schedule are later work.
//   * Decode and the LM head (m = batch = 8): a few FLOP per byte, so the
//     bytes of W bound it.  Every W byte is read once per block row (one
//     block row when m <= 64), 16 bytes per thread where aligned.  The LM
//     head reads the tied embedding table in place through W's strides
//     (W = table.T is column-major), so no transposed copy is ever made.
//   * Training's backward (m = 4096 tokens): dX = g W^T reads W^T, and
//     dW = X^T g reads X^T, both in place: X, like W, may be row-major
//     (x_trans = 0) or column-major (x_trans = 1, as x.T is), chosen at run
//     time, not by template, so the library keeps its 64 instances.  dW's
//     reduction runs over the 4096 tokens into a (k, n) output of at most
//     9 x 24 tiles for the layers' weights: too few blocks to fill 132 SMs,
//     so those GEMMs are bound by the tiles in flight, not by the card's
//     rate; a split-K schedule is later work.  The LM head's
//     dW = x^T g is (576 x 4096)(4096 x 49152) and dX = g table is
//     (4096 x 49152)(49152 x 576): both at the tensor-core bound.
//
// Ragged m, n and k are masked inside the kernel (zero-filled tiles, guarded
// stores): there is no padding copy.  The fp32 path runs plain FMA on the
// CUDA cores, not TF32, so fp32 results keep fp32 accuracy.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// Kept in the order of repro_torch/core/fusion.py::ACTIVATIONS.
enum Act { NONE = 0, RELU, SIGMOID, TANH, GELU, SILU, EXP, SQUARE, N_ACT };

template <int ACT>
__device__ __forceinline__ float apply_act(float x) {
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

struct Epilogue {
  const void* bias;    // (n,), fp32 or the input type
  const void* c0;      // (m, n) row stride ldc0, fp32 or the input type
  void* out;           // (m, n) contiguous, fp32 or bf16
  long long ldc0;
  float alpha, beta;
  int bias_f32, c0_f32, out_f32;
};

__device__ __forceinline__ float load_as_float(const void* p, long long i,
                                               int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

template <int ACT, bool HAS_BIAS, bool HAS_C0>
__device__ __forceinline__ void finish(const Epilogue& e, float acc, int row,
                                       int col, int n) {
  acc *= e.alpha;
  if constexpr (HAS_C0)
    acc += e.beta * load_as_float(e.c0, (long long)row * e.ldc0 + col,
                                  e.c0_f32);
  if constexpr (HAS_BIAS) acc += load_as_float(e.bias, col, e.bias_f32);
  acc = apply_act<ACT>(acc);
  long long o = (long long)row * n + col;
  if (e.out_f32) static_cast<float*>(e.out)[o] = acc;
  else static_cast<bf16*>(e.out)[o] = __float2bfloat16(acc);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through wmma.  128 threads = 4 warps in a 2 x 2 grid,
// each warp a 32 x 32 piece of the 64 x 64 tile (2 x 2 fragments).
// ---------------------------------------------------------------------------
namespace tc {
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8;    // As[BM][LDA] when X is row-major (m, k)
constexpr int LDAT = BM + 8;   // As[BK][LDAT] when X is column-major
constexpr int LDB = BN + 8;    // Bs[BK][LDB] when W is row-major (k, n)
constexpr int LDBT = BK + 8;   // Bs[BN][LDBT] when W is column-major
constexpr int LDC = BN + 4;    // Cs[BM][LDC], fp32
constexpr int A_ELEMS = (BM * LDA > BK * LDAT) ? BM * LDA : BK * LDAT;
constexpr int B_ELEMS = (BK * LDB > BN * LDBT) ? BK * LDB : BN * LDBT;

// Each thread moves two 8-element chunks of the A tile and two of the B tile
// per K slice.  A chunk outside the matrix, or one that cannot be loaded as
// 16 aligned bytes, goes element by element with zero fill.
struct Chunk { uint4 v; };

__device__ __forceinline__ Chunk load_chunk(const bf16* base, long long ld,
                                            int r, int c, int rmax, int cmax,
                                            bool vec) {
  Chunk ch;
  if (vec && r < rmax && c + 8 <= cmax) {
    ch.v = *reinterpret_cast<const uint4*>(base + (long long)r * ld + c);
  } else {
    union { uint4 v; unsigned short h[8]; } u;   // bf16 bit patterns
#pragma unroll
    for (int i = 0; i < 8; ++i)
      u.h[i] = (r < rmax && c + i < cmax)
                   ? __bfloat16_as_ushort(base[(long long)r * ld + c + i])
                   : (unsigned short)0;
    ch.v = u.v;
  }
  return ch;
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// One BK slice of this warp's 32 x 32 piece: A from As, B from Bs, each
// stored row-major or column-major as its operand was read.
template <typename LA, typename LB>
__device__ __forceinline__ void mma_slice(Acc (&acc)[2][2], const bf16* As,
                                          const bf16* Bs, int wm, int wn) {
  constexpr bool A_ROW = std::is_same<LA, wmma::row_major>::value;
  constexpr bool B_ROW = std::is_same<LB, wmma::row_major>::value;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int r = wm * 32 + i * 16;
      if constexpr (A_ROW)
        wmma::load_matrix_sync(fa[i], &As[r * LDA + kk], LDA);
      else
        wmma::load_matrix_sync(fa[i], &As[kk * LDAT + r], LDAT);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int c = wn * 32 + j * 16;
      if constexpr (B_ROW)
        wmma::load_matrix_sync(fb[j], &Bs[kk * LDB + c], LDB);
      else
        wmma::load_matrix_sync(fb[j], &Bs[c * LDBT + kk], LDBT);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

template <int ACT, bool HAS_BIAS, bool HAS_C0>
__global__ void __launch_bounds__(THREADS)
matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   Epilogue e, int m, int n, int k, long long ldx,
                   long long ldw, int x_trans, int w_trans, int vec_x,
                   int vec_w) {
  __shared__ __align__(128) bf16 As[A_ELEMS];
  __shared__ __align__(128) bf16 Bs[B_ELEMS];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // Chunk coordinates of this thread inside the A and B tiles.
  int a_r[2], a_c[2], b_r[2], b_c[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    int idx = tid + t * THREADS;            // 256 chunks per tile
    if (x_trans) { a_r[t] = idx / (BM / 8); a_c[t] = (idx % (BM / 8)) * 8; }
    else         { a_r[t] = idx / (BK / 8); a_c[t] = (idx % (BK / 8)) * 8; }
    if (w_trans) { b_r[t] = idx / (BK / 8); b_c[t] = (idx % (BK / 8)) * 8; }
    else         { b_r[t] = idx / (BN / 8); b_c[t] = (idx % (BN / 8)) * 8; }
  }

  auto fetch = [&](int k0, Chunk (&ra)[2], Chunk (&rb)[2]) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (x_trans)  // X[mm][kk] at kk * ldx + mm: rows of the tile are k
        ra[t] = load_chunk(x + (long long)k0 * ldx + m0, ldx, a_r[t], a_c[t],
                           k - k0, m - m0, vec_x);
      else
        ra[t] = load_chunk(x + (long long)m0 * ldx + k0, ldx, a_r[t], a_c[t],
                           m - m0, k - k0, vec_x);
      if (w_trans)  // W[kk][nn] at nn * ldw + kk: rows of the tile are n
        rb[t] = load_chunk(w + (long long)n0 * ldw + k0, ldw, b_r[t], b_c[t],
                           n - n0, k - k0, vec_w);
      else
        rb[t] = load_chunk(w + (long long)k0 * ldw + n0, ldw, b_r[t], b_c[t],
                           k - k0, n - n0, vec_w);
    }
  };

  Chunk ra[2], rb[2];
  fetch(0, ra, rb);
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int lda = x_trans ? LDAT : LDA, ldb = w_trans ? LDBT : LDB;
      *reinterpret_cast<uint4*>(&As[a_r[t] * lda + a_c[t]]) = ra[t].v;
      *reinterpret_cast<uint4*>(&Bs[b_r[t] * ldb + b_c[t]]) = rb[t].v;
    }
    __syncthreads();
    if (k0 + BK < k) fetch(k0 + BK, ra, rb);   // overlaps the products below

    using RM = wmma::row_major;
    using CM = wmma::col_major;
    if (x_trans) {
      if (w_trans) mma_slice<CM, CM>(acc, As, Bs, wm, wn);
      else mma_slice<CM, RM>(acc, As, Bs, wm, wn);
    } else {
      if (w_trans) mma_slice<RM, CM>(acc, As, Bs, wm, wn);
      else mma_slice<RM, RM>(acc, As, Bs, wm, wn);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    int r = idx / BN, c = idx % BN;
    if (m0 + r < m && n0 + c < n)
      finish<ACT, HAS_BIAS, HAS_C0>(e, Cs[r * LDC + c], m0 + r, n0 + c, n);
  }
}
}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores.  256 threads, each a 4 x 4 piece of the
// 64 x 64 tile (rows ty + 16 i, columns tx + 16 j).
// ---------------------------------------------------------------------------
namespace simt {
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

template <int ACT, bool HAS_BIAS, bool HAS_C0>
__global__ void __launch_bounds__(THREADS)
matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  Epilogue e, int m, int n, int k, long long ldx,
                  long long ldw, int x_trans, int w_trans) {
  __shared__ float As[BK][BM + 4];   // transposed: As[kk][row]
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      int idx = tid + t * THREADS;           // 1024 elements per tile
      if (x_trans) {   // neighbouring threads on neighbouring rows
        int r = idx % BM, kk = idx / BM;
        As[kk][r] = (m0 + r < m && k0 + kk < k)
                        ? x[(long long)(k0 + kk) * ldx + m0 + r] : 0.0f;
      } else {
        int r = idx / BK, kk = idx % BK;
        As[kk][r] = (m0 + r < m && k0 + kk < k)
                        ? x[(long long)(m0 + r) * ldx + k0 + kk] : 0.0f;
      }
      if (w_trans) {
        int c = idx / BK, kq = idx % BK;
        Bs[kq][c] = (n0 + c < n && k0 + kq < k)
                        ? w[(long long)(n0 + c) * ldw + k0 + kq] : 0.0f;
      } else {
        int kq = idx / BN, c = idx % BN;
        Bs[kq][c] = (k0 + kq < k && n0 + c < n)
                        ? w[(long long)(k0 + kq) * ldw + n0 + c] : 0.0f;
      }
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
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < m && c < n) finish<ACT, HAS_BIAS, HAS_C0>(e, acc[i][j], r, c, n);
    }
}
}  // namespace simt

template <int ACT, bool HAS_BIAS, bool HAS_C0>
static void launch(const void* x, const void* w, const Epilogue& e, int m,
                   int n, int k, long long ldx, long long ldw, int x_trans,
                   int w_trans, int is_bf16, int vec_x, int vec_w,
                   cudaStream_t stream) {
  if (is_bf16) {
    dim3 grid((n + tc::BN - 1) / tc::BN, (m + tc::BM - 1) / tc::BM);
    tc::matmul_bf16_kernel<ACT, HAS_BIAS, HAS_C0>
        <<<grid, tc::THREADS, 0, stream>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(w), e, m, n,
            k, ldx, ldw, x_trans, w_trans, vec_x, vec_w);
  } else {
    dim3 grid((n + simt::BN - 1) / simt::BN, (m + simt::BM - 1) / simt::BM);
    simt::matmul_f32_kernel<ACT, HAS_BIAS, HAS_C0>
        <<<grid, simt::THREADS, 0, stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), e, m,
            n, k, ldx, ldw, x_trans, w_trans);
  }
}

template <int ACT>
static void launch_act(bool has_bias, bool has_c0, const void* x,
                       const void* w, const Epilogue& e, int m, int n, int k,
                       long long ldx, long long ldw, int x_trans, int w_trans,
                       int is_bf16, int vec_x, int vec_w, cudaStream_t s) {
  auto go = [&](auto launcher) {
    launcher(x, w, e, m, n, k, ldx, ldw, x_trans, w_trans, is_bf16, vec_x,
             vec_w, s);
  };
  if (has_bias && has_c0) go(launch<ACT, true, true>);
  else if (has_bias) go(launch<ACT, true, false>);
  else if (has_c0) go(launch<ACT, false, true>);
  else go(launch<ACT, false, false>);
}

// x: (m, k) either row-major (x_trans = 0, element (mm, kk) at
// mm * ldx + kk) or column-major (x_trans = 1, element at kk * ldx + mm).
// w: (k, n) either row-major (w_trans = 0, element (kk, nn) at
// kk * ldw + nn) or column-major (w_trans = 1, element at nn * ldw + kk).
// bias / c0 may be null.  Returns the launch's cudaGetLastError().
extern "C" int repro_matmul(const void* x, const void* w, const void* bias,
                            const void* c0, void* out, int m, int n, int k,
                            long long ldx, long long ldw, int x_trans,
                            int w_trans, long long ldc0, float alpha,
                            float beta, int act, int is_bf16, int out_f32,
                            int bias_f32, int c0_f32, int vec_x, int vec_w,
                            void* stream) {
  if (act < 0 || act >= N_ACT) return (int)cudaErrorInvalidValue;
  Epilogue e{bias, c0, out, ldc0, alpha, beta, bias_f32, c0_f32, out_f32};
  bool hb = bias != nullptr, hc = c0 != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ACT_CASE(A)                                                  \
  case A:                                                                  \
    launch_act<A>(hb, hc, x, w, e, m, n, k, ldx, ldw, x_trans, w_trans,    \
                  is_bf16, vec_x, vec_w, s);                               \
    break;
  switch (act) {
    REPRO_ACT_CASE(NONE) REPRO_ACT_CASE(RELU) REPRO_ACT_CASE(SIGMOID)
    REPRO_ACT_CASE(TANH) REPRO_ACT_CASE(GELU) REPRO_ACT_CASE(SILU)
    REPRO_ACT_CASE(EXP) REPRO_ACT_CASE(SQUARE)
  }
#undef REPRO_ACT_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
