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
//
// Ragged m, n and k are masked inside the kernel (zero-filled tiles, guarded
// stores): there is no padding copy.  The fp32 path runs plain FMA on the
// CUDA cores, not TF32, so fp32 results keep fp32 accuracy.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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
constexpr int LDA = BK + 8;    // As[BM][LDA]
constexpr int LDB = BN + 8;    // Bs[BK][LDB] when W is row-major (k, n)
constexpr int LDBT = BK + 8;   // Bs[BN][LDBT] when W is column-major
constexpr int LDC = BN + 4;    // Cs[BM][LDC], fp32
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

template <int ACT, bool HAS_BIAS, bool HAS_C0>
__global__ void __launch_bounds__(THREADS)
matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   Epilogue e, int m, int n, int k, long long ldx,
                   long long ldw, int w_trans, int vec_x, int vec_w) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[B_ELEMS];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* xb = x + (long long)m0 * ldx;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // Chunk coordinates of this thread inside the A and B tiles.
  int a_r[2], a_c[2], b_r[2], b_c[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    int idx = tid + t * THREADS;            // 256 chunks per tile
    a_r[t] = idx / (BK / 8); a_c[t] = (idx % (BK / 8)) * 8;
    if (w_trans) { b_r[t] = idx / (BK / 8); b_c[t] = (idx % (BK / 8)) * 8; }
    else         { b_r[t] = idx / (BN / 8); b_c[t] = (idx % (BN / 8)) * 8; }
  }

  auto fetch = [&](int k0, Chunk (&ra)[2], Chunk (&rb)[2]) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      ra[t] = load_chunk(xb + k0, ldx, a_r[t], a_c[t], m - m0, k - k0,
                         vec_x);
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
      *reinterpret_cast<uint4*>(&As[a_r[t] * LDA + a_c[t]]) = ra[t].v;
      int ld = w_trans ? LDBT : LDB;
      *reinterpret_cast<uint4*>(&Bs[b_r[t] * ld + b_c[t]]) = rb[t].v;
    }
    __syncthreads();
    if (k0 + BK < k) fetch(k0 + BK, ra, rb);   // overlaps the products below

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * 32 + i * 16) * LDA + kk],
                               LDA);
      if (w_trans) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
            fb[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &Bs[(wn * 32 + j * 16) * LDBT + kk],
                                 LDBT);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &Bs[kk * LDB + wn * 32 + j * 16],
                                 LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
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
                  long long ldw, int w_trans) {
  __shared__ float As[BK][BM + 4];   // transposed: As[kk][row]
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      int idx = tid + t * THREADS;           // 1024 elements per tile
      int r = idx / BK, kk = idx % BK;
      As[kk][r] = (m0 + r < m && k0 + kk < k)
                      ? x[(long long)(m0 + r) * ldx + k0 + kk] : 0.0f;
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
                   int n, int k, long long ldx, long long ldw, int w_trans,
                   int is_bf16, int vec_x, int vec_w, cudaStream_t stream) {
  if (is_bf16) {
    dim3 grid((n + tc::BN - 1) / tc::BN, (m + tc::BM - 1) / tc::BM);
    tc::matmul_bf16_kernel<ACT, HAS_BIAS, HAS_C0>
        <<<grid, tc::THREADS, 0, stream>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(w), e, m, n,
            k, ldx, ldw, w_trans, vec_x, vec_w);
  } else {
    dim3 grid((n + simt::BN - 1) / simt::BN, (m + simt::BM - 1) / simt::BM);
    simt::matmul_f32_kernel<ACT, HAS_BIAS, HAS_C0>
        <<<grid, simt::THREADS, 0, stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), e, m,
            n, k, ldx, ldw, w_trans);
  }
}

template <int ACT>
static void launch_act(bool has_bias, bool has_c0, const void* x,
                       const void* w, const Epilogue& e, int m, int n, int k,
                       long long ldx, long long ldw, int w_trans, int is_bf16,
                       int vec_x, int vec_w, cudaStream_t s) {
  if (has_bias && has_c0)
    launch<ACT, true, true>(x, w, e, m, n, k, ldx, ldw, w_trans, is_bf16,
                            vec_x, vec_w, s);
  else if (has_bias)
    launch<ACT, true, false>(x, w, e, m, n, k, ldx, ldw, w_trans, is_bf16,
                             vec_x, vec_w, s);
  else if (has_c0)
    launch<ACT, false, true>(x, w, e, m, n, k, ldx, ldw, w_trans, is_bf16,
                             vec_x, vec_w, s);
  else
    launch<ACT, false, false>(x, w, e, m, n, k, ldx, ldw, w_trans, is_bf16,
                              vec_x, vec_w, s);
}

// x: (m, k) with row stride ldx and unit column stride.  w: (k, n) either
// row-major (w_trans = 0, element (kk, nn) at kk * ldw + nn) or column-major
// (w_trans = 1, element at nn * ldw + kk).  bias / c0 may be null.  Returns
// the launch's cudaGetLastError().
extern "C" int repro_matmul(const void* x, const void* w, const void* bias,
                            const void* c0, void* out, int m, int n, int k,
                            long long ldx, long long ldw, int w_trans,
                            long long ldc0, float alpha, float beta, int act,
                            int is_bf16, int out_f32, int bias_f32,
                            int c0_f32, int vec_x, int vec_w, void* stream) {
  if (act < 0 || act >= N_ACT) return (int)cudaErrorInvalidValue;
  Epilogue e{bias, c0, out, ldc0, alpha, beta, bias_f32, c0_f32, out_f32};
  bool hb = bias != nullptr, hc = c0 != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ACT_CASE(A)                                                  \
  case A:                                                                  \
    launch_act<A>(hb, hc, x, w, e, m, n, k, ldx, ldw, w_trans, is_bf16,    \
                  vec_x, vec_w, s);                                        \
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
