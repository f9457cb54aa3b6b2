// Direct convolution on Hopper, NHWC x RSCK -> NPQK, as an implicit GEMM:
// out[(n, p, q), k] = act(sum over (r, s, c) of
//     x[n, p * stride - pad + r, q * stride - pad + s, c] * w[r, s, c, k]
//     + bias[k]).
//
// Replaces src/repro/kernels/conv2d/kernel.py::conv2d_pallas.  On the TPU
// the grid walked (n, k-block, output row, output column block) in
// parallel and (r, s, c-block) as a sequential axis carrying an fp32
// accumulator in VMEM, over a padded copy of x.  Here the paper's
// Algorithm 4 becomes one GEMM per block: M runs over the flattened output
// pixels (n, p, q), not along one output row (a stage-4 row of ResNet-50
// has 7 pixels, and a per-row tile would leave most of a tile empty), N
// over K, and the reduction over the window (r, s, c), the row order of w
// viewed as an (R*S*C, K) matrix.  No padded copy of x and no im2col
// buffer is ever made.
//
// Each call runs one of three mainloops, planned by the wrapper
// (kernel.py::plan_conv) from the shapes, type and alignment:
//   * wgmma (bf16, C and K multiples of 8): the shared wgmma + TMA mainloop
//     of include/repro_gemm_sm90.cuh, 128 x 128 tiles, a slice one tap
//     (r, s) x 64 channels (128 bytes).  A comes from TMA in im2col mode:
//     one box a slice, the tile's 128 output pixels moved by the tap, the
//     map's bounding box giving the padding and its traversal strides the
//     conv stride, TMA's zero fill the padding, the channel tail and the
//     rows past N*P*Q (the IM2COL walk).  B is w's (R*S*C, K) row-major
//     matrix, an N-major operand, its box at row tap * C + the channel
//     block.  A 1x1, stride-1, unpadded conv is a plain GEMM of x viewed
//     as (N*H*W, C): matmul's SPLIT_K walk on a 2-D map (on an H100 a
//     little faster than the im2col walk at each such conv of ResNet-50).  Where the tiles
//     alone leave SMs idle (stage 4: 52 tiles), the window is split and
//     the partials added in split order by the shared reduction, which
//     runs the epilogue.
//   * wmma (other bf16: the stem's C = 3, whose 6-byte pixels TMA cannot
//     step through): the first kernel, 64 x 64 tiles on nvcuda::wmma, each
//     slice of A gathered in place (GatherTc): where C is a multiple of 8,
//     8 channels of one tap in one 16-byte load, else element by element
//     with no channel padding, so the stem's 147-long window takes 5
//     slices of 32, not 49.
//   * simt (fp32): the same tile walk on FMA, no TF32.
// Bias and activation are applied to the accumulator and the result is
// stored once, NHWC.
//
// bf16 accumulation (the reference's accum_dtype=bfloat16, round_c > 0):
// the reference's grid steps are (tap, 128-channel block), so every
// mainloop rounds its fp32 sums to bf16 in place at the end of each
// round_c channels of a tap and at the tap's end, on one split.  The
// wgmma slices are (tap, 64-channel block) already.  The wmma and simt
// walks then take the window tap by tap (Geom::cbs slices a tap, the last
// one's tail zero): the stem's 147-long window takes 49 wmma slices of
// one tap's 3 channels instead of 5 of 32, so that no slice straddles two
// taps.
//
// What bounds it on an H100: ResNet-50's convolutions at N = 32 do 50-1000
// FLOP per byte of x, w and out, so the tensor cores bound them in bf16
// (and the FMA pipes in fp32).  The backward by data runs through this
// same kernel as a dual convolution (kernels/conv2d/ops.py), at stride 1
// over a zero-dilated gradient.
#include "repro_gemm_sm90.cuh"

using namespace repro;

// kernel.py::MAINLOOPS, in order.
enum Mainloop { WGMMA = 0, WMMA = 1, SIMT = 2 };

struct Geom {
  int n, h, w, c, k, r, s, p, q, stride, pad;
  int m;      // n * p * q output pixels
  int red;    // r * s * c reduction length
  int cbs;    // slices a tap of the tap walk; 0: the flattened walk
};

// Window index `col` of slice sl (slices of bk): its tap (r, s), channel
// c and how many indices from it on the slice may read (`left`, counted
// to the window's end, or the tap's on the tap walk).  False past them.
__device__ __forceinline__ bool window_at(const Geom& g, int sl, int bk,
                                          int col, int& r, int& s, int& c,
                                          int& left) {
  int rs;
  if (g.cbs) {
    rs = sl / g.cbs;
    c = (sl - rs * g.cbs) * bk + col;
    left = g.c - c;
  } else {
    const int kidx = sl * bk + col;
    rs = kidx / g.c;
    c = kidx - rs * g.c;
    left = g.red - kidx;
  }
  r = rs / g.s;
  s = rs - r * g.s;
  return left > 0;
}

// Output pixel -> (image, top-left input row and column of its window).
struct Pixel {
  long long img;   // n * h: the image's first input row
  int ih0, iw0;
  bool live;
};

__device__ __forceinline__ Pixel pixel(const Geom& g, int m) {
  Pixel px;
  px.live = m < g.m;
  int mm = px.live ? m : 0;
  int pq = g.p * g.q;
  int nn = mm / pq, rem = mm - nn * pq;
  int pp = rem / g.q, qq = rem - pp * g.q;
  px.img = (long long)nn * g.h;
  px.ih0 = pp * g.stride - g.pad;
  px.iw0 = qq * g.stride - g.pad;
  return px;
}

template <typename T>
__device__ __forceinline__ const T* tap(const T* x, const Geom& g,
                                        const Pixel& px, int r, int s,
                                        int c) {
  int ih = px.ih0 + r, iw = px.iw0 + s;
  if (ih < 0 || ih >= g.h || iw < 0 || iw >= g.w) return nullptr;
  return x + ((px.img + ih) * g.w + iw) * g.c + c;
}

// The gathered A operand, bf16: 8 consecutive window indices of one pixel.
struct GatherTc {
  const bf16* x;
  Geom g;
  int m0, vec;
  Pixel px[2];
  int col[2];
  __device__ __forceinline__ void init(int t, int r, int c) {
    px[t] = pixel(g, m0 + r);
    col[t] = c;
  }
  __device__ __forceinline__ uint4 operator()(int sl, int t) const {
    union { uint4 v; unsigned short h[8]; } u;
    u.v = make_uint4(0u, 0u, 0u, 0u);
    int r, s, c, left;
    if (!px[t].live || !window_at(g, sl, tc::BK, col[t], r, s, c, left))
      return u.v;
    if (vec) {   // c % 8 == 0: the 8 indices are 8 channels of one tap
      const bf16* p = tap(x, g, px[t], r, s, c);
      if (p) u.v = *reinterpret_cast<const uint4*>(p);
      return u.v;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < left) {
        const bf16* p = tap(x, g, px[t], r, s, c);
        if (p) u.h[i] = __bfloat16_as_ushort(*p);
      }
      if (++c == g.c) { c = 0; if (++s == g.s) { s = 0; ++r; } }
    }
    return u.v;
  }
};

// The gathered A operand, fp32: one window index of one pixel.
struct GatherSimt {
  const float* x;
  Geom g;
  int m0;
  Pixel px[4];
  int kk[4];
  __device__ __forceinline__ void init(int t, int f, int k) {
    px[t] = pixel(g, m0 + f);
    kk[t] = k;
  }
  __device__ __forceinline__ float operator()(int sl, int t) const {
    int r, s, c, left;
    if (!px[t].live || !window_at(g, sl, simt::BK, kk[t], r, s, c, left))
      return 0.0f;
    const float* p = tap(x, g, px[t], r, s, c);
    return p ? *p : 0.0f;
  }
};

// w viewed as the row-major (r * s * c, k) matrix B; on the tap walk as
// r * s entries of (c, k), one a tap, cbs slices each.
template <typename T>
__device__ __forceinline__ Strided<T> weights(const T* w, const Geom& g,
                                              int n0, int bk, int vec) {
  if (g.cbs)
    return Strided<T>{w, (long long)g.c * g.k, g.k, /*red_rows=*/1, n0, g.k,
                      g.c, g.cbs, 0, vec};
  return Strided<T>{w, 0, g.k, /*red_rows=*/1, n0, g.k, g.red,
                    cdiv(g.red, bk), 0, vec};
}

// Slices of a walk over slices of bk: the window's, or r * s taps of cbs.
__device__ __forceinline__ int walk_slices(const Geom& g, int bk) {
  return g.cbs ? g.r * g.s * g.cbs : cdiv(g.red, bk);
}

__global__ void __launch_bounds__(tc::THREADS)
conv2d_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   Epilogue e, Geom g, int vec_x, int vec_w, Round rnd) {
  __shared__ __align__(128) bf16 As[tc::STAGE];
  __shared__ __align__(128) bf16 Bs[tc::STAGE];
  __shared__ __align__(128) float Cs[tc::BM * tc::LDC];
  const int m0 = blockIdx.x * tc::BM, n0 = blockIdx.y * tc::BN;
  GatherTc fa{x, g, m0, vec_x};
  tc::StridedFetch fb{weights(w, g, n0, tc::BK, vec_w)};
  tc::Acc acc[2][2];
  tc::mainloop(acc, As, Bs, /*a_red_rows=*/0, /*b_red_rows=*/1,
               walk_slices(g, tc::BK), fa, fb, tc::Same{}, tc::Same{}, rnd);
  tc::store_tile(acc, Cs, [&](int r, int c, float v) {
    if (m0 + r < g.m && n0 + c < g.k) finish(e, v, m0 + r, n0 + c);
  });
}

__global__ void __launch_bounds__(simt::THREADS)
conv2d_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  Epilogue e, Geom g, Round rnd) {
  const int m0 = blockIdx.x * simt::BM, n0 = blockIdx.y * simt::BN;
  GatherSimt fa{x, g, m0};
  simt::StridedFetch fb{weights(w, g, n0, simt::BK, 0)};
  float acc[4][4];
  simt::mainloop(acc, /*a_red_rows=*/0, /*b_red_rows=*/1,
                 walk_slices(g, simt::BK), fa, fb, rnd);
  simt::store_tile(acc, [&](int r, int c, float v) {
    if (m0 + r < g.m && n0 + c < g.k) finish(e, v, m0 + r, n0 + c);
  });
}

// The wgmma mainloop: a 2-D map of x as (n*h*w, c) for a 1x1, stride-1,
// unpadded conv, else its im2col map; w's (r*s*c, k) rows in 64 x 64
// boxes.  round_c: as repro_conv2d's.
static int conv_wgmma(const void* x, const void* w, const Sink& sink,
                      const Geom& g, int splits, int chunk, int round_c,
                      cudaStream_t st) {
  CUtensorMap tx, tw;
  if (!sm90::tensor_map_bf16(&tw, w, g.k, g.red, g.k, 64))
    return (int)cudaErrorInvalidValue;
  if (g.r == 1 && g.s == 1 && g.stride == 1 && g.pad == 0) {
    if (!sm90::tensor_map_bf16(&tx, x, g.c, (uint64_t)g.n * g.h * g.w, g.c,
                               128))
      return (int)cudaErrorInvalidValue;
    return wg::launch_tile<128, 0, 1, wg::SPLIT_K>(
        tx, tw, 0, 0, sink, g.c, splits, chunk, 1, st,
        Round{round_c / wg::BK, cdiv(g.c, wg::BK)});
  }
  if (!sm90::tensor_map_im2col_bf16(&tx, x, g.n, g.h, g.w, g.c, g.r, g.s,
                                    g.stride, g.pad, 128))
    return (int)cudaErrorInvalidValue;
  const wg::Im2col walk{g.c, g.s, cdiv(g.c, 64), g.p, g.q, g.stride, g.pad};
  return wg::launch_im2col(tx, tw, sink, walk, g.r * g.s * walk.cblocks,
                           splits, chunk, st,
                           Round{round_c / wg::BK, walk.cblocks});
}

// x: (n, h, w, c) contiguous; w: (r, s, c, k) contiguous; bias: (k,) or
// null; out: (n, p, q, k) contiguous.  The plan (kernel.py::plan_conv):
// mainloop (0 wgmma, 1 wmma, 2 simt), splits and chunk (wgmma's slices a
// split); ws: a (splits, n*p*q, k) fp32 workspace when splits > 1.
// vec_x / vec_w: the wmma gather's 16-byte loads are safe (aligned base,
// c or k a multiple of 8).  round_c: bf16 accumulation's rounding block in
// channels of a tap (a multiple of 64; one split), or 0 for fp32
// accumulation.  Returns the first CUDA error of the launches, or 0.
extern "C" int repro_conv2d(const void* x, const void* w, const void* bias,
                            void* out, int n, int h, int wi, int c, int k,
                            int r, int s, int p, int q, int stride, int pad,
                            int act, int is_bf16, int out_f32, int bias_f32,
                            int vec_x, int vec_w, int mainloop, int splits,
                            int chunk, int round_c, void* ws, void* stream) {
  if (act < 0 || act >= N_ACT || splits < 1 || chunk < 1 ||
      round_c < 0 || round_c % 64 || (round_c && splits > 1) ||
      (splits > 1 && (ws == nullptr || mainloop != WGMMA)) ||
      (mainloop == SIMT) == (is_bf16 != 0))
    return (int)cudaErrorInvalidValue;
  Geom g{n, h, wi, c, k, r, s, p, q, stride, pad, n * p * q, r * s * c, 0};
  Epilogue e{out, bias, nullptr, k, 0, 1.0f, 0.0f, act, out_f32, bias_f32, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mainloop == WGMMA) {
    const Sink sink{e, splits > 1 ? static_cast<float*>(ws) : nullptr, g.m,
                    k};
    int rc = conv_wgmma(x, w, sink, g, splits, chunk, round_c, st);
    if (rc == 0 && splits > 1)
      rc = wg::reduce_splits(static_cast<const float*>(ws), e, g.m, k,
                             splits, st);
    return rc;
  }
  dim3 grid(cdiv(g.m, 64), cdiv(k, 64));
  const int bk = mainloop == WMMA ? tc::BK : simt::BK;
  if (round_c) g.cbs = cdiv(c, bk);   // the tap walk
  const Round rnd{round_c / bk, g.cbs};
  if (mainloop == WMMA)
    conv2d_bf16_kernel<<<grid, tc::THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), e, g,
        vec_x, vec_w, rnd);
  else
    conv2d_f32_kernel<<<grid, simt::THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), e, g,
        rnd);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
