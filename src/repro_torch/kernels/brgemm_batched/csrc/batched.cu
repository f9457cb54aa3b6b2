// The paper's two batched GEMM interfaces on Hopper.
//
//   brgemm_stacked:  C   = act(alpha * sum_i A_i @ B_i + beta * C0 + bias)
//                    replaces src/repro/kernels/brgemm/kernel.py::
//                    brgemm_stacked_pallas;
//   batched_matmul:  C_i = act(alpha * A_i @ B_i + bias)
//                    replaces src/repro/kernels/brgemm/kernel.py::
//                    batched_matmul_pallas.
//
// On the TPU both walked a sequential grid axis with an fp32 accumulator in
// VMEM scratch: (batch x k-block) for the stacked form, k-blocks for the
// batched one.  Here a block owns one output tile and walks that axis in a
// loop of its own, with the accumulator in registers.  Each operand carries
// a batch stride (0 for the 2-D operand the batched form broadcasts, read
// again by every entry, never copied) and may be row- or column-major per
// entry, so brgemm's backward (dA_i = g B_i^T, dB_i = A_i^T g) reads the
// transposed views in place.
//
// batched_matmul runs one of three mainloops, planned by the wrapper
// (kernel.py::plan_batched) from the shapes, types and layouts, as
// matmul's are:
//   * wgmma (bf16 operands that TMA can describe): matmul's own mainloop and
//     epilogue (include/repro_gemm_sm90.cuh), the grid's third axis the
//     batch entry.  A batched operand is a 3-D tensor map with the entry as
//     its outer coordinate, so TMA's zero fill stops at each entry's edge
//     (a 2-D view of (B * k, n) would read the next entry's rows into a
//     ragged k); a broadcast operand is a 2-D map that ignores the entry.
//     Entry z writes rows z * m .. of the (B * m, n) output.
//   * wmma (bf16 operands TMA cannot describe): the 64 x 64 tile of
//     repro_tile.cuh, blockIdx.z the entry.
//   * simt (fp32): the same tile on FMA, no TF32.
// brgemm_stacked runs the same three mainloops, planned by
// kernel.py::plan_stacked:
//   * wgmma: the same mainloop and epilogue with the batch folded into the
//     reduction (the header's STACKED walk): a block's producer walks the
//     flattened (entry, k-slice) axis of nb * ceil(k / 64) slices through
//     3-D boxes, the entry the outer coordinate, so each entry's ragged k
//     ends in TMA's zero fill, and the walk ends in one epilogue (alpha,
//     beta * C0, bias, activation): C is written once, never re-read
//     between entries (the paper's point against a loop of GEMMs).  Where
//     the output has few tiles (the paper's cases: one), the plan splits
//     that axis as matmul's k is split (runs of at least 8 slices, at most
//     one wave of blocks); the fp32 partials are added in split order by
//     the header's reduction.
//   * wmma / simt: the 64 x 64 tile of repro_tile.cuh walking every entry
//     and k-block in one block.
//
// What bounds it on an H100: the paper's shapes (m, n <= 128, k <= 256,
// B <= 64) make few output tiles: their time is the latency of a launch,
// a ring fill and an epilogue (and, split, the partials' reduction), not
// the card's rates.  The (8, 4096, 1024, 1024) case fills the card (256
// stacked tiles of 128 x 128, or 8 x 256 batched ones) and is tensor-core
// bound in bf16, as matmul's token-major shapes are.
#include "repro_gemm_sm90.cuh"

using namespace repro;

// One block: the output tile (blockIdx.y, blockIdx.x) of entry batch0, or,
// when stacked, summed over all nb entries.  Output row `row_base + r`.
__device__ __forceinline__ void tile_bf16(const Operand& a, const Operand& b,
                                          const Epilogue& e, int m, int n,
                                          int k, int batch0, int entries,
                                          long long row_base) {
  __shared__ __align__(128) bf16 As[tc::STAGE];
  __shared__ __align__(128) bf16 Bs[tc::STAGE];
  __shared__ __align__(128) float Cs[tc::BM * tc::LDC];
  const int m0 = blockIdx.y * tc::BM, n0 = blockIdx.x * tc::BN;
  tc::StridedFetch fa{a_op<bf16>(a, m0, m, k, tc::BK, batch0)};
  tc::StridedFetch fb{b_op<bf16>(b, n0, n, k, tc::BK, batch0)};
  tc::Acc acc[2][2];
  tc::mainloop(acc, As, Bs, a.trans, !b.trans, entries * cdiv(k, tc::BK), fa,
               fb);
  tc::store_tile(acc, Cs, [&](int r, int c, float v) {
    if (m0 + r < m && n0 + c < n) finish(e, v, row_base + m0 + r, n0 + c);
  });
}

__device__ __forceinline__ void tile_f32(const Operand& a, const Operand& b,
                                         const Epilogue& e, int m, int n,
                                         int k, int batch0, int entries,
                                         long long row_base) {
  const int m0 = blockIdx.y * simt::BM, n0 = blockIdx.x * simt::BN;
  simt::StridedFetch fa{a_op<float>(a, m0, m, k, simt::BK, batch0)};
  simt::StridedFetch fb{b_op<float>(b, n0, n, k, simt::BK, batch0)};
  float acc[4][4];
  simt::mainloop(acc, a.trans, !b.trans, entries * cdiv(k, simt::BK), fa,
                 fb);
  simt::store_tile(acc, [&](int r, int c, float v) {
    if (m0 + r < m && n0 + c < n) finish(e, v, row_base + m0 + r, n0 + c);
  });
}

__global__ void __launch_bounds__(tc::THREADS)
brgemm_stacked_bf16_kernel(Operand a, Operand b, Epilogue e, int nb, int m,
                           int n, int k) {
  tile_bf16(a, b, e, m, n, k, 0, nb, 0);
}

__global__ void __launch_bounds__(simt::THREADS)
brgemm_stacked_f32_kernel(Operand a, Operand b, Epilogue e, int nb, int m,
                          int n, int k) {
  tile_f32(a, b, e, m, n, k, 0, nb, 0);
}

// Entry blockIdx.z writes rows blockIdx.z * m .. of the (nb * m, n) output.
__global__ void __launch_bounds__(tc::THREADS)
batched_matmul_bf16_kernel(Operand a, Operand b, Epilogue e, int m, int n,
                           int k) {
  tile_bf16(a, b, e, m, n, k, blockIdx.z, 1, (long long)blockIdx.z * m);
}

__global__ void __launch_bounds__(simt::THREADS)
batched_matmul_f32_kernel(Operand a, Operand b, Epilogue e, int m, int n,
                          int k) {
  tile_f32(a, b, e, m, n, k, blockIdx.z, 1, (long long)blockIdx.z * m);
}

// kernel.py::MAINLOOPS, in order.
enum Mainloop { WGMMA = 0, WMMA = 1, SIMT = 2 };

// The tensor map of a batched operand: (rows, inner) per entry, rows `ld`
// apart, entries `bstride` apart (3-D), or one matrix (bstride = 0: 2-D).
static bool operand_map(CUtensorMap* map, const void* p, uint64_t inner,
                        uint64_t rows, long long ld, long long bstride,
                        int nb, uint32_t box_rows) {
  return bstride ? sm90::tensor_map_bf16_3d(map, p, inner, rows, ld, nb,
                                            bstride, box_rows)
                 : sm90::tensor_map_bf16(map, p, inner, rows, ld, box_rows);
}

// The wgmma operands' maps: A rows of m (a_trans) or of k; B rows of k
// (row-major) or of n.
static bool operand_maps(CUtensorMap* ta, CUtensorMap* tb, const void* a,
                         long long sa, long long lda, int a_trans,
                         const void* b, long long sb, long long ldb,
                         int b_trans, int nb, int m, int n, int k, int bm) {
  const bool ok = a_trans ? operand_map(ta, a, m, k, lda, sa, nb, 64)
                          : operand_map(ta, a, k, m, lda, sa, nb, bm);
  return ok && (b_trans ? operand_map(tb, b, k, n, ldb, sb, nb, wg::BN)
                        : operand_map(tb, b, n, k, ldb, sb, nb, 64));
}

// Operand entry i: element (row, col) at p + i * bstride + row * ld + col
// (trans = 0) or p + i * bstride + col * ld + row (trans = 1); bstride = 0
// broadcasts one matrix to every entry.  vec: 16-byte loads are safe
// (bf16 only: aligned base, ld and bstride multiples of 8).  bias / c0 may
// be null; c0 has row stride ldc0.  Each returns the launches' first
// cudaGetLastError(), or 0.
//
// brgemm_stacked's plan (kernel.py::plan_stacked): mainloop (0 wgmma, 1
// wmma, 2 simt); for wgmma bm (64 or 128), splits and chunk (slices of the
// nb * ceil(k / 64) stacked slices a split) and ws, a (splits, m, n) fp32
// workspace when splits > 1.
extern "C" int repro_brgemm_stacked(
    const void* a, long long sa, long long lda, int a_trans, int vec_a,
    const void* b, long long sb, long long ldb, int b_trans, int vec_b,
    const void* bias, const void* c0, long long ldc0, void* out, int nb,
    int m, int n, int k, float alpha, float beta, int act, int is_bf16,
    int out_f32, int bias_f32, int c0_f32, int mainloop, int bm, int splits,
    int chunk, void* ws, void* stream) {
  if (act < 0 || act >= N_ACT || (mainloop == SIMT) == (is_bf16 != 0) ||
      (mainloop == WGMMA &&
       ((bm != 64 && bm != 128) || k < 1 || nb < 1 || splits < 1 ||
        chunk < 1 || (splits > 1 && ws == nullptr))))
    return (int)cudaErrorInvalidValue;
  Epilogue e{out, bias, c0, n, ldc0, alpha, beta, act, out_f32, bias_f32,
             c0_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mainloop == WGMMA) {
    CUtensorMap ta, tb;
    if (!operand_maps(&ta, &tb, a, sa, lda, a_trans, b, sb, ldb, b_trans,
                      nb, m, n, k, bm))
      return (int)cudaErrorInvalidValue;
    float* wsf = splits > 1 ? static_cast<float*>(ws) : nullptr;
    int rc = wg::launch<wg::STACKED>(bm, a_trans, !b_trans, ta, tb, sa != 0,
                                     sb != 0, Sink{e, wsf, m, n}, k, splits,
                                     chunk, nb, st);
    if (rc == 0 && splits > 1) rc = wg::reduce_splits(wsf, e, m, n, splits,
                                                      st);
    return rc;
  }
  Operand oa{a, sa, lda, a_trans, vec_a}, ob{b, sb, ldb, b_trans, vec_b};
  dim3 grid(cdiv(n, 64), cdiv(m, 64));
  if (mainloop == WMMA)
    brgemm_stacked_bf16_kernel<<<grid, tc::THREADS, 0, st>>>(oa, ob, e, nb,
                                                             m, n, k);
  else
    brgemm_stacked_f32_kernel<<<grid, simt::THREADS, 0, st>>>(oa, ob, e, nb,
                                                              m, n, k);
  return (int)cudaGetLastError();
}

// mainloop: 0 wgmma (bm: its tile rows, 64 or 128), 1 wmma, 2 simt.
extern "C" int repro_batched_matmul(
    const void* a, long long sa, long long lda, int a_trans, int vec_a,
    const void* b, long long sb, long long ldb, int b_trans, int vec_b,
    const void* bias, void* out, int nb, int m, int n, int k, float alpha,
    int act, int is_bf16, int out_f32, int bias_f32, int mainloop, int bm,
    void* stream) {
  if (act < 0 || act >= N_ACT || (mainloop == SIMT) == (is_bf16 != 0) ||
      (mainloop == WGMMA && ((bm != 64 && bm != 128) || k < 1)))
    return (int)cudaErrorInvalidValue;
  Epilogue e{out, bias, nullptr, n, 0, alpha, 0.0f, act, out_f32, bias_f32,
             0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mainloop == WGMMA) {
    CUtensorMap ta, tb;
    if (!operand_maps(&ta, &tb, a, sa, lda, a_trans, b, sb, ldb, b_trans,
                      nb, m, n, k, bm))
      return (int)cudaErrorInvalidValue;
    return wg::launch<wg::PER_ENTRY>(bm, a_trans, !b_trans, ta, tb, sa != 0,
                                     sb != 0, Sink{e, nullptr, m, n}, k, nb,
                                     cdiv(k, wg::BK), nb, st);
  }
  Operand oa{a, sa, lda, a_trans, vec_a}, ob{b, sb, ldb, b_trans, vec_b};
  dim3 grid(cdiv(n, 64), cdiv(m, 64), nb);
  if (mainloop == WMMA)
    batched_matmul_bf16_kernel<<<grid, tc::THREADS, 0, st>>>(oa, ob, e, m, n,
                                                             k);
  else
    batched_matmul_f32_kernel<<<grid, simt::THREADS, 0, st>>>(oa, ob, e, m,
                                                              n, k);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
