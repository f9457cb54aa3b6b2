// The batch-reduce GEMM on Hopper: C = act(alpha * X @ W + beta * C0 + bias).
//
// Replaces src/repro/kernels/brgemm/kernel.py::matmul_pallas (body
// _make_body).  On the TPU the K axis was a sequential "arbitrary" grid axis
// carrying an fp32 accumulator in VMEM scratch.  Here a block owns one
// output tile and walks a run of K in a loop of its own, with the fp32
// accumulator in registers; the epilogue runs once on the whole sum, in the
// reference's order: alpha, then beta * c0, then bias, then the activation,
// then the cast to the output type.  X and W are each row- or column-major
// (x.T, W.T and table.T are read in place), chosen at run time.
//
// Each call runs one of three mainloops, planned by the wrapper
// (kernel.py::plan) from the shapes, types and layouts:
//   * wgmma (bf16 operands that TMA can describe: 16-byte aligned base, row
//     stride a multiple of 8 elements): the mainloop and epilogue of
//     include/repro_gemm_sm90.cuh, which batched_matmul shares.  128 (or
//     64, for m <= 64) x 128 x 64 tiles, a 96 KB ring filled by TMA by one
//     producer warp, one or two consumer warpgroups on wgmma m64n128k16,
//     the four layouts carried by the TMA box and the descriptor's
//     major-ness alone (that header says how).
//   * wmma (bf16 operands that TMA cannot describe): the shared tile GEMM of
//     repro_tile.cuh, 64 x 64 x 32 on nvcuda::wmma.  No main path takes it.
//   * simt (fp32): the same tile GEMM on FMA, no TF32, so fp32 keeps fp32
//     accuracy.
//
// Split-K.  The main paths' long reductions (ResNet-50's weight gradients,
// k = N * P * Q up to 401,408 into a few tiles; training's dW, k = 4096;
// decode, m = 8, where W must stream from many SMs) make too few output
// tiles to fill 132 SMs.  The plan then cuts k into `splits` runs of
// `chunk` slices (blockIdx.z), each block writes its fp32 partial tile to
// a workspace the wrapper allocates, and a second kernel adds the partials
// in split order, with no atomics, and runs the epilogue once
// (include/repro_gemm_sm90.cuh's splitk_reduce_kernel): the result does not
// change from run to run.  One split runs the epilogue in the GEMM kernel
// itself.
//
// bf16 accumulation (the reference's accum_dtype=bfloat16, round_k > 0):
// each mainloop rounds its fp32 sums to bf16 in place at the end of every
// round_k elements of k and at k's end, the ends of the reference's
// k-blocks, on one split (a split would add rounded runs in another order).
//
// What bounds it on an H100: prefill and training's token-major GEMMs
// (m = 4096) sit at or above the bf16 ridge (~295 FLOP a byte) and are
// tensor-core bound; decode (m = 8) and the weight gradients with n = 64
// are bound by the bytes of their operands.
#include "repro_gemm_sm90.cuh"

using namespace repro;

// kernel.py::MAINLOOPS, in order.  (Activation codes: repro_tile.cuh's
// enum Act, in the order of repro_torch/core/fusion.py::ACTIVATIONS.)
enum Mainloop { WGMMA = 0, WMMA = 1, SIMT = 2 };

// ---------------------------------------------------------------------------
// wmma (bf16) and simt (fp32): the shared tile GEMM, split z walking slices
// z * chunk .. of the one batch entry.
// ---------------------------------------------------------------------------
template <typename F>
struct FromSlice {
  F f;
  int s0;
  __device__ __forceinline__ void init(int t, int r, int c) {
    f.init(t, r, c);
  }
  __device__ __forceinline__ auto operator()(int sl, int t) const {
    return f(s0 + sl, t);
  }
};

__global__ void __launch_bounds__(tc::THREADS)
matmul_wmma_kernel(Operand x, Operand w, Sink sink, int k, int chunk,
                   Round rnd) {
  __shared__ __align__(128) bf16 As[tc::STAGE];
  __shared__ __align__(128) bf16 Bs[tc::STAGE];
  __shared__ __align__(128) float Cs[tc::BM * tc::LDC];
  const int m0 = blockIdx.y * tc::BM, n0 = blockIdx.x * tc::BN;
  const int s0 = blockIdx.z * chunk;
  FromSlice<tc::StridedFetch> fa{{a_op<bf16>(x, m0, sink.m, k, tc::BK, 0)},
                                 s0};
  FromSlice<tc::StridedFetch> fb{{b_op<bf16>(w, n0, sink.n, k, tc::BK, 0)},
                                 s0};
  tc::Acc acc[2][2];
  tc::mainloop(acc, As, Bs, x.trans, !w.trans,
               min(chunk, cdiv(k, tc::BK) - s0), fa, fb, tc::Same{},
               tc::Same{}, rnd);
  tc::store_tile(acc, Cs, [&](int r, int c, float v) {
    if (m0 + r < sink.m && n0 + c < sink.n) sink(m0 + r, n0 + c, v);
  });
}

__global__ void __launch_bounds__(simt::THREADS)
matmul_simt_kernel(Operand x, Operand w, Sink sink, int k, int chunk,
                   Round rnd) {
  const int m0 = blockIdx.y * simt::BM, n0 = blockIdx.x * simt::BN;
  const int s0 = blockIdx.z * chunk;
  FromSlice<simt::StridedFetch> fa{
      {a_op<float>(x, m0, sink.m, k, simt::BK, 0)}, s0};
  FromSlice<simt::StridedFetch> fb{
      {b_op<float>(w, n0, sink.n, k, simt::BK, 0)}, s0};
  float acc[4][4];
  simt::mainloop(acc, x.trans, !w.trans, min(chunk, cdiv(k, simt::BK) - s0),
                 fa, fb, rnd);
  simt::store_tile(acc, [&](int r, int c, float v) {
    if (m0 + r < sink.m && n0 + c < sink.n) sink(m0 + r, n0 + c, v);
  });
}

// x: (m, k) either row-major (x_trans = 0, element (mm, kk) at
// mm * ldx + kk) or column-major (x_trans = 1, element at kk * ldx + mm).
// w: (k, n) either row-major (w_trans = 0, element (kk, nn) at
// kk * ldw + nn) or column-major (w_trans = 1, element at nn * ldw + kk).
// bias / c0 may be null.  The plan (kernel.py::plan): mainloop (0 wgmma,
// 1 wmma, 2 simt), bm (wgmma's tile rows, 64 or 128), splits and chunk
// (slices of the mainloop's BK per split); ws: a (splits, m, n) fp32
// workspace when splits > 1.  vec_x / vec_w: the wmma path's 16-byte loads
// are safe.  round_k: bf16 accumulation's rounding block in k elements (a
// multiple of 64; one split), or 0 for fp32 accumulation.  Returns the
// first CUDA error of the launches, or 0.
extern "C" int repro_matmul(const void* x, const void* w, const void* bias,
                            const void* c0, void* out, int m, int n, int k,
                            long long ldx, long long ldw, int x_trans,
                            int w_trans, long long ldc0, float alpha,
                            float beta, int act, int is_bf16, int out_f32,
                            int bias_f32, int c0_f32, int vec_x, int vec_w,
                            int mainloop, int bm, int splits, int chunk,
                            int round_k, void* ws, void* stream) {
  if (act < 0 || act >= N_ACT || splits < 1 || chunk < 1 ||
      round_k < 0 || round_k % 64 || (round_k && splits > 1) ||
      (splits > 1 && ws == nullptr) || (mainloop == SIMT) == (is_bf16 != 0) ||
      (mainloop == WGMMA && bm != 64 && bm != 128))
    return (int)cudaErrorInvalidValue;
  Epilogue e{out, bias, c0, n, ldc0, alpha, beta, act, out_f32, bias_f32,
             c0_f32};
  Sink sink{e, splits > 1 ? static_cast<float*>(ws) : nullptr, m, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (mainloop == WGMMA) {
    // X: rows of m (x_trans) or of k; W: rows of k (row-major) or of n.
    CUtensorMap tx, tw;
    bool ok = x_trans ? sm90::tensor_map_bf16(&tx, x, m, k, ldx, 64)
                      : sm90::tensor_map_bf16(&tx, x, k, m, ldx, bm);
    ok = ok && (w_trans ? sm90::tensor_map_bf16(&tw, w, k, n, ldw, wg::BN)
                        : sm90::tensor_map_bf16(&tw, w, n, k, ldw, 64));
    if (!ok) return (int)cudaErrorInvalidValue;
    rc = wg::launch<wg::SPLIT_K>(bm, x_trans, !w_trans, tx, tw, 0, 0, sink,
                                 k, splits, chunk, 1, s,
                                 Round{round_k / wg::BK, cdiv(k, wg::BK)});
  } else {
    Operand ox{x, 0, ldx, x_trans, vec_x}, ow{w, 0, ldw, w_trans, vec_w};
    dim3 grid(cdiv(n, 64), cdiv(m, 64), splits);
    if (mainloop == WMMA)
      matmul_wmma_kernel<<<grid, tc::THREADS, 0, s>>>(
          ox, ow, sink, k, chunk,
          Round{round_k / tc::BK, cdiv(k, tc::BK)});
    else
      matmul_simt_kernel<<<grid, simt::THREADS, 0, s>>>(
          ox, ow, sink, k, chunk,
          Round{round_k / simt::BK, cdiv(k, simt::BK)});
    rc = (int)cudaGetLastError();
  }
  if (rc == 0 && splits > 1)
    rc = wg::reduce_splits(static_cast<const float*>(ws), e, m, n, splits, s);
  return rc;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
