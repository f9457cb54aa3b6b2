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
//     stride a multiple of 8 elements).  128 (or 64, for m <= 64) x 128 x 64
//     tiles; a 96 KB ring of 3 (or 4) slices of X and W in shared memory,
//     filled by TMA with the 128-byte swizzle by one producer warp, full
//     and empty mbarriers per stage; one or two consumer warpgroups issue
//     wgmma.mma_async m64n128k16 straight from the ring into 64 fp32
//     registers a thread, one slice's products in flight while the next
//     slice is awaited.  Two blocks fit an SM, so one's epilogue overlaps
//     the other's products.  The four layouts are the TMA box and the
//     descriptor's major-ness alone: row-major X is K-major A, column-major
//     X M-major A; row-major W is N-major B, column-major W K-major B.
//     Ragged m, n and k come from TMA's zero fill and guarded stores.  The
//     finished tile is staged through the ring and stored four columns a
//     thread by a loop with the activation chosen once per tile: unrolled
//     over the 64 registers with the activation switched per element, the
//     epilogue outgrew the instruction cache and slowed the whole kernel.
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
// in split order, with no atomics, and runs the epilogue once: the result
// does not change from run to run.  One split runs the epilogue in the
// GEMM kernel itself.
//
// What bounds it on an H100: prefill and training's token-major GEMMs
// (m = 4096) sit at or above the bf16 ridge (~295 FLOP a byte) and are
// tensor-core bound; decode (m = 8) and the weight gradients with n = 64
// are bound by the bytes of their operands.
#include "repro_sm90.cuh"
#include "repro_tile.cuh"

using namespace repro;

// kernel.py::MAINLOOPS, in order.  (Activation codes: repro_tile.cuh's
// enum Act, in the order of repro_torch/core/fusion.py::ACTIVATIONS.)
enum Mainloop { WGMMA = 0, WMMA = 1, SIMT = 2 };

// Where a block's fp32 sums go: the epilogue (one split), or split z's
// slab of the (splits, m, n) workspace.
struct Sink {
  Epilogue e;
  float* ws;
  int m, n;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float v) const {
    if (ws)
      ws[((long long)blockIdx.z * m + row) * n + col] = v;
    else
      finish(e, v, row, col);
  }
  // Columns col .. col + 3 (col a multiple of 4) of a row, each where it
  // exists; one 16-byte (fp32) or 8-byte (bf16) store where n % 4 == 0.
  // ACT: the activation, e.act, chosen once for the tile.
  template <int ACT>
  __device__ __forceinline__ void quad(int row, int col, float4 v) const {
    if (row >= m || col >= n) return;
    if (n % 4 || col + 3 >= n) {
      const float f[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < 4 && col + i < n; ++i) (*this)(row, col + i, f[i]);
      return;
    }
    const long long o = (long long)row * n + col;
    if (ws) {
      *reinterpret_cast<float4*>(ws + (long long)blockIdx.z * m * n + o) = v;
      return;
    }
    v = make_float4(epilogue<ACT>(e, v.x, row, col),
                    epilogue<ACT>(e, v.y, row, col + 1),
                    epilogue<ACT>(e, v.z, row, col + 2),
                    epilogue<ACT>(e, v.w, row, col + 3));
    if (e.out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(e.out) + o) = v;
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(e.out) + o) = u;
    }
  }
};

// ---------------------------------------------------------------------------
// wgmma + TMA
// ---------------------------------------------------------------------------
namespace wg {
constexpr int BN = 128, BK = 64;
constexpr int LDC = BN + 4;           // fp32 staging of the finished tile
constexpr int BLOCK64 = 64 * BK * 2;  // one 64-row (or 64-wide) box, bytes

// Two blocks an SM, so that one's epilogue and ring fill overlap the
// other's products: a ring of 96 KB each.
template <int BM>
struct Shape {
  static constexpr int WGS = BM / 64;             // consumer warpgroups
  static constexpr int THREADS = WGS * 128 + 32;  // and one producer warp
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = 96 * 1024 / STAGE_BYTES;   // 3 or 4
  static constexpr int RING = STAGES * STAGE_BYTES;
  // the ring, its 2 * STAGES barriers, and 1 KB to align the ring
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 1024;
  static_assert(BM * LDC * 4 <= RING, "staging must fit in the ring");
};

// X (m x k) in TMA boxes: row-major (A_MN = 0) as one BM x 64 box per
// slice, rows m, 64 k across; column-major (A_MN = 1) as BM / 64 boxes of
// 64 k rows, 64 m across.  W (k x n): column-major (B_MN = 0) as one
// 128 x 64 box, rows n; row-major (B_MN = 1) as two boxes of 64 k rows.
template <int BM, int A_MN, int B_MN>
__global__ void __launch_bounds__(Shape<BM>::THREADS, 2)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw, Sink sink, int k,
                    int chunk) {
  using S = Shape<BM>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = ring;
  uint8_t* Bs = ring + STAGES * S::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::RING);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int s0 = blockIdx.z * chunk;
  const int slices = min(chunk, cdiv(k, BK) - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], S::WGS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == S::WGS * 4) {  // the producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < slices; ++i) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[stage], S::STAGE_BYTES);
        const int kc = (s0 + i) * BK;
        uint8_t* a = As + stage * S::A_BYTES;
        uint8_t* b = Bs + stage * S::B_BYTES;
        if (A_MN) {
#pragma unroll
          for (int j = 0; j < BM / 64; ++j)
            sm90::tma_load_2d(a + j * BLOCK64, &tx, &full[stage], m0 + 64 * j,
                              kc);
        } else {
          sm90::tma_load_2d(a, &tx, &full[stage], kc, m0);
        }
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            sm90::tma_load_2d(b + j * BLOCK64, &tw, &full[stage], n0 + 64 * j,
                              kc);
        } else {
          sm90::tma_load_2d(b, &tw, &full[stage], kc, n0);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns rows wg * 64 .. of the tile.
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int i = 0; i < slices; ++i) {
    sm90::mbar_wait(&full[stage], phase);
    // Either layout puts this warpgroup's 64 rows in one 8 KB block.
    const uint8_t* a = As + stage * S::A_BYTES + wg * BLOCK64;
    const uint8_t* b = Bs + stage * S::B_BYTES;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = A_MN ? sm90::desc_sw128(a + kk * 2048, BLOCK64, 1024)
                               : sm90::desc_sw128(a + kk * 32, 16, 1024);
      const uint64_t db = B_MN ? sm90::desc_sw128(b + kk * 2048, BLOCK64, 1024)
                               : sm90::desc_sw128(b + kk * 32, 16, 1024);
      sm90::wgmma_m64n128k16<A_MN, B_MN>(acc, da, db);
    }
    sm90::wgmma_commit();
    sm90::fence_regs(acc);
    // The slice before this one is done: give its stage back.
    sm90::wgmma_wait<1>();
    if (i > 0 && threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // Every consumer is done with the ring: stage the tile through it, then
  // store it four columns a thread, neighbouring threads on neighbouring
  // columns, in a loop that keeps the epilogue's code small.
  sm90::named_sync(1, S::WGS * 128);
  float* Cs = reinterpret_cast<float*>(ring);
  const int t = threadIdx.x % 128;
  const int r0 = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (t % 4) * 2;
    *reinterpret_cast<float2*>(&Cs[r0 * LDC + c]) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(&Cs[(r0 + 8) * LDC + c]) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  sm90::named_sync(1, S::WGS * 128);
  with_act(sink.ws ? NONE : sink.e.act, [&](auto act) {
#pragma unroll 1
    for (int idx = threadIdx.x; idx < BM * BN / 4; idx += S::WGS * 128) {
      const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      sink.template quad<decltype(act)::value>(
          m0 + r, n0 + c, *reinterpret_cast<const float4*>(&Cs[r * LDC + c]));
    }
  });
}

template <int BM, int A_MN, int B_MN>
static int launch(const CUtensorMap& tx, const CUtensorMap& tw,
                  const Sink& sink, int k, int splits, int chunk,
                  cudaStream_t stream) {
  using S = Shape<BM>;
  auto kernel = matmul_wgmma_kernel<BM, A_MN, B_MN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(cdiv(sink.m, BM), cdiv(sink.n, BN), splits);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(tx, tw, sink, k, chunk);
  return (int)cudaGetLastError();
}
}  // namespace wg

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
matmul_wmma_kernel(Operand x, Operand w, Sink sink, int k, int chunk) {
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
               min(chunk, cdiv(k, tc::BK) - s0), fa, fb);
  tc::store_tile(acc, Cs, [&](int r, int c, float v) {
    if (m0 + r < sink.m && n0 + c < sink.n) sink(m0 + r, n0 + c, v);
  });
}

__global__ void __launch_bounds__(simt::THREADS)
matmul_simt_kernel(Operand x, Operand w, Sink sink, int k, int chunk) {
  const int m0 = blockIdx.y * simt::BM, n0 = blockIdx.x * simt::BN;
  const int s0 = blockIdx.z * chunk;
  FromSlice<simt::StridedFetch> fa{
      {a_op<float>(x, m0, sink.m, k, simt::BK, 0)}, s0};
  FromSlice<simt::StridedFetch> fb{
      {b_op<float>(w, n0, sink.n, k, simt::BK, 0)}, s0};
  float acc[4][4];
  simt::mainloop(acc, x.trans, !w.trans, min(chunk, cdiv(k, simt::BK) - s0),
                 fa, fb);
  simt::store_tile(acc, [&](int r, int c, float v) {
    if (m0 + r < sink.m && n0 + c < sink.n) sink(m0 + r, n0 + c, v);
  });
}

// ---------------------------------------------------------------------------
// Split-K: the partials of each output element summed in split order, then
// the epilogue, once.  Bytes bound it (splits fp32 reads an element).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, Epilogue e, int m, int n,
                     int splits) {
  const long long mn = (long long)m * n;
  with_act(e.act, [&](auto act) {
    for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
         i += (long long)gridDim.x * 256) {
      float acc = ws[i];
      for (int s = 1; s < splits; ++s) acc += ws[s * mn + i];
      const long long row = i / n;
      const int col = (int)(i % n);
      acc = epilogue<decltype(act)::value>(e, acc, row, col);
      if (e.out_f32) static_cast<float*>(e.out)[i] = acc;
      else static_cast<bf16*>(e.out)[i] = __float2bfloat16(acc);
    }
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
// are safe.  Returns the first CUDA error of the launches, or 0.
extern "C" int repro_matmul(const void* x, const void* w, const void* bias,
                            const void* c0, void* out, int m, int n, int k,
                            long long ldx, long long ldw, int x_trans,
                            int w_trans, long long ldc0, float alpha,
                            float beta, int act, int is_bf16, int out_f32,
                            int bias_f32, int c0_f32, int vec_x, int vec_w,
                            int mainloop, int bm, int splits, int chunk,
                            void* ws, void* stream) {
  if (act < 0 || act >= N_ACT || splits < 1 || chunk < 1 ||
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
    const int a_mn = x_trans, b_mn = !w_trans;
#define REPRO_WGMMA(BM, A, B)                                             \
  if (bm == BM && a_mn == A && b_mn == B)                                 \
    rc = wg::launch<BM, A, B>(tx, tw, sink, k, splits, chunk, s);
    REPRO_WGMMA(128, 0, 0) REPRO_WGMMA(128, 0, 1) REPRO_WGMMA(128, 1, 0)
    REPRO_WGMMA(128, 1, 1) REPRO_WGMMA(64, 0, 0) REPRO_WGMMA(64, 0, 1)
    REPRO_WGMMA(64, 1, 0) REPRO_WGMMA(64, 1, 1)
#undef REPRO_WGMMA
  } else {
    Operand ox{x, 0, ldx, x_trans, vec_x}, ow{w, 0, ldw, w_trans, vec_w};
    dim3 grid(cdiv(n, 64), cdiv(m, 64), splits);
    if (mainloop == WMMA)
      matmul_wmma_kernel<<<grid, tc::THREADS, 0, s>>>(ox, ow, sink, k, chunk);
    else
      matmul_simt_kernel<<<grid, simt::THREADS, 0, s>>>(ox, ow, sink, k,
                                                        chunk);
    rc = (int)cudaGetLastError();
  }
  if (rc == 0 && splits > 1) {
    const long long mn = (long long)m * n;
    const int blocks = (int)(mn < 132 * 16 * 256LL ? (mn + 255) / 256
                                                   : 132 * 16);
    splitk_reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<float*>(ws), e,
                                                 m, n, splits);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
