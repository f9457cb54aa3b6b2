// The wgmma + TMA GEMM mainloop and its epilogue, shared by matmul
// (kernels/brgemm/csrc/matmul.cu), batched_matmul and brgemm_stacked
// (kernels/brgemm_batched/csrc/batched.cu), matmul_q, brgemm_q and
// batched_matmul_q (kernels/brgemm_quant/csrc/quant.cu) and conv2d
// (kernels/conv2d/csrc/conv2d.cu): one building block.
//
// A block owns one output tile of one batch entry and walks a run of k
// slices.  128 (or 64, for m <= 64) x 128 tiles, a slice 128 bytes of k
// (64 bf16 or 128 8-bit elements); a 96 KB ring of 3 (or 4) slices of X
// and W in shared memory, filled by TMA with the 128-byte swizzle by one
// producer warp, full and empty mbarriers per stage; one or two consumer
// warpgroups issue wgmma.mma_async (m64n128k16 on bf16, m64n128k32 on s8)
// straight from the ring into 64 accumulator registers a thread (fp32;
// int32 for s8), one slice's products in flight while the next slice is
// awaited; fp8 slices are widened to f16 first (gemm_wgmma says why and
// how).  Two blocks fit an SM, so one's epilogue overlaps the other's
// products.  The four bf16 layouts are the TMA box and the
// descriptor's major-ness alone: row-major X is K-major A, column-major X
// M-major A; row-major W is N-major B, column-major W K-major B.  8-bit
// operands have no transpose in wgmma: both must be K-major.  Ragged m, n
// and k come from TMA's zero fill and guarded stores.  The finished tile
// is staged through the ring and stored four columns a thread by a loop
// with the activation chosen once per tile: unrolled over the 64
// registers with the activation switched per element, the epilogue
// outgrew the instruction cache and slowed the whole kernel.
//
// The grid is (m tiles, n tiles, z); the template parameter WALK says what
// z and a block's walk are, so that each instantiation carries only its
// own walk's arithmetic:
//   * SPLIT_K (matmul, matmul_q): z is the split of k, slices z * chunk ..;
//     both operands are 2-D maps.
//   * PER_ENTRY (batched_matmul, batched_matmul_q; one split): z is the
//     batch entry; an operand whose tensor map is 3-D (the entry its outer
//     coordinate) is read at the block's entry, so TMA's zero fill stops
//     at each entry's edge, and a 2-D map (a broadcast operand) ignores
//     it; entry z writes rows z * m .. of the (entries * m, n) output.
//   * STACKED (brgemm_stacked, brgemm_q): the reduction is the flattened
//     (entry, k-slice) axis of nb * ceil(k / BK) slices, and z its split, as
//     matmul's k: the producer walks 3-D boxes entry by entry, each
//     entry's ragged k ended by the zero fill, and every block's walk ends
//     in one epilogue (or one fp32 / int32 partial), so C is written once.
//   * IM2COL (conv2d): M is the flattened output pixels (n, p, q), the
//     reduction the window's (tap, 64-channel block) slices, and z its
//     split.  A slice's A is one im2col box of x: the tile's 128 output
//     pixels, each moved by the tap, 64 channels each, padding and ragged
//     edges from TMA's zero fill (the paper's pointer list made hardware:
//     no im2col buffer, no padded copy); its B the 64 rows of the
//     (r * s * c, K) weights at tap * c + the channel block.
// The type parameter T says what the operands are (Bf16; S8 or F8 for
// matmul_q, brgemm_q and batched_matmul_q, which walk SPLIT_K, STACKED
// and PER_ENTRY) and SINK where the sums go: the bf16 GEMMs' Epilogue or
// the quantized GEMMs' Dequant (DequantEntry: batched_matmul_q's scales
// per entry).  Split partials (SPLIT_K, STACKED, IM2COL) are
// added in split order by splitk_reduce_kernel, which then runs the
// epilogue: no atomics, the same bits every run.
#pragma once
#include "repro_sm90.cuh"
#include "repro_tile.cuh"

namespace repro {

// The quantized GEMMs' dequant epilogue (matmul_q), as the reference's
// finish: the int32 sum of s8 operands converted with __int2float_rn (fp8's
// fp32 sum as it is), then acc * (sr[row] * sc[col]), then * alpha, then
// + bias, each rounded on its own (__fmul_rn / __fadd_rn: nvcc would
// otherwise contract a multiply and an add into one FMA), then the
// activation, then the cast.  Scales are read through their strides (0
// for an expanded per-tensor scale).
template <typename A>
struct Dequant {
  using Acc = A;         // int (s8 operands) or float (fp8)
  void* out;             // rows of ld_out elements, fp32 or bf16
  const void* bias;      // (n,) or null, fp32 or bf16
  const float* sr;       // row scales, sr_stride apart
  const float* sc;       // column scales, sc_stride apart
  long long sr_stride, sc_stride, ld_out;
  float alpha;
  int act, out_f32, bias_f32;
};

template <int ACT, typename A>
__device__ __forceinline__ float epilogue(const Dequant<A>& e, A acc,
                                          long long row, int col) {
  float v;
  if constexpr (std::is_same<A, int>::value) v = __int2float_rn(acc);
  else v = acc;
  const float s = __fmul_rn(e.sr[row * e.sr_stride], e.sc[col * e.sc_stride]);
  v = __fmul_rn(__fmul_rn(v, s), e.alpha);
  if (e.bias) v = __fadd_rn(v, load_as_float(e.bias, col, e.bias_f32));
  return act_fn<ACT>(v);
}

// batched_matmul_q's dequant: Dequant's, with a scale vector per batch
// entry, read through entry strides as quant.cu's first kernel reads them
// (Scales): row scale (z, r) at sr[z * sr_bstride + r * sr_stride],
// column scale (z, c) at sc[z * sc_bstride + c * sc_stride]; an entry
// stride of 0 shares one vector with every entry.  Only the PER_ENTRY walk
// (one split) takes it: its block's z is the entry, and it hands the
// epilogue output row z * m + r, m the rows of an entry.  A type of its
// own, so that matmul_q's and the split reduction's code stays as it was.
template <typename A>
struct DequantEntry {
  using Acc = A;
  void* out;
  const void* bias;
  const float* sr;
  const float* sc;
  long long sr_bstride, sr_stride, sc_bstride, sc_stride, ld_out;
  int m;                 // rows an entry
  float alpha;
  int act, out_f32, bias_f32;
};

template <int ACT, typename A>
__device__ __forceinline__ float epilogue(const DequantEntry<A>& e, A acc,
                                          long long row, int col) {
  const int z = blockIdx.z, r = (int)(row - (long long)z * e.m);
  float v;
  if constexpr (std::is_same<A, int>::value) v = __int2float_rn(acc);
  else v = acc;
  const float s = __fmul_rn(e.sr[z * e.sr_bstride + r * e.sr_stride],
                            e.sc[z * e.sc_bstride + col * e.sc_stride]);
  v = __fmul_rn(__fmul_rn(v, s), e.alpha);
  if (e.bias) v = __fadd_rn(v, load_as_float(e.bias, col, e.bias_f32));
  return act_fn<ACT>(v);
}

// One output element of either dequant (D: Dequant or DequantEntry).
template <template <typename> class D, typename A>
__device__ __forceinline__ void finish(const D<A>& e, A acc, long long row,
                                       int col) {
  float v = 0.0f;
  with_act(e.act, [&](auto act) {
    v = epilogue<decltype(act)::value>(e, acc, row, col);
  });
  const long long o = row * e.ld_out + col;
  if (e.out_f32) static_cast<float*>(e.out)[o] = v;
  else static_cast<bf16*>(e.out)[o] = __float2bfloat16(v);
}

// Two and four accumulators as one store.
template <typename A> struct Vec;
template <> struct Vec<float> {
  using two = float2;
  using four = float4;
  static __device__ __forceinline__ float2 pair(float a, float b) {
    return make_float2(a, b);
  }
};
template <> struct Vec<int> {
  using two = int2;
  using four = int4;
  static __device__ __forceinline__ int2 pair(int a, int b) {
    return make_int2(a, b);
  }
};

// Where a block's sums go: the epilogue E (Epilogue, or the quantized
// GEMMs' Dequant) on one split, or split z's slab of the (splits, m, n)
// workspace of E's accumulator type (fp32; int32 for s8 operands, whose
// partials add exactly in any order) where k is split.
template <typename E>
struct SinkOf {
  using Acc = typename E::Acc;
  E e;
  Acc* ws;
  int m, n;
  // Element (row, col) of entry 0; the split is blockIdx.z.  The tile GEMMs
  // of repro_tile.cuh store through this.
  __device__ __forceinline__ void operator()(int row, int col, Acc v) const {
    if (ws)
      ws[((long long)blockIdx.z * m + row) * n + col] = v;
    else
      finish(e, v, row, col);
  }
  // Columns col .. col + 3 (col a multiple of 4) of row `row` of an entry
  // whose rows start at output row `row0` (0 but for batched_matmul), each
  // where it exists; one 16-byte (fp32) or 8-byte (bf16) store where
  // n % 4 == 0.  ACT: the activation, e.act, chosen once for the tile.
  template <int ACT>
  __device__ __forceinline__ void quad(long long row0, int row, int col,
                                       typename Vec<Acc>::four v) const {
    if (row >= m || col >= n) return;
    if (n % 4 || col + 3 >= n) {
      const Acc f[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < 4 && col + i < n; ++i) {
        if (ws) (*this)(row, col + i, f[i]);
        else finish(e, f[i], row0 + row, col + i);
      }
      return;
    }
    const long long o = (row0 + row) * n + col;
    if (ws) {
      *reinterpret_cast<typename Vec<Acc>::four*>(
          ws + (long long)blockIdx.z * m * n + o) = v;
      return;
    }
    const float4 y = make_float4(epilogue<ACT>(e, v.x, row0 + row, col),
                                 epilogue<ACT>(e, v.y, row0 + row, col + 1),
                                 epilogue<ACT>(e, v.z, row0 + row, col + 2),
                                 epilogue<ACT>(e, v.w, row0 + row, col + 3));
    if (e.out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(e.out) + o) = y;
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(e.out) + o) = u;
    }
  }
};
using Sink = SinkOf<Epilogue>;

namespace wg {
// IM2COL (conv2d): the reduction walks the (r, s, channel block) taps of a
// convolution window, A an im2col box of x per tap (see gemm_wgmma).
enum Walk { SPLIT_K = 0, PER_ENTRY = 1, STACKED = 2, IM2COL = 3 };
constexpr int BN = 128, BK = 64;      // BK: bf16's k a slice
constexpr int LDC = BN + 4;           // fp32 staging of the finished tile
constexpr int BLOCK64 = 64 * BK * 2;  // one 64-row (or 64-wide) box, bytes

// The operand types of a mainloop: the wgmma instruction (its k step is
// 32 bytes of A and B either way) and its accumulator.  8-bit operands
// must both be K-major: wgmma has no transpose for them.  WIDEN: the
// operands arrive as 8 bits and are widened to f16 in shared memory for
// f16 wgmma (see gemm_wgmma).
struct Bf16 {                          // bf16 x bf16 -> fp32, m64n128k16
  using Acc = float;
  static constexpr int ESIZE = 2;
  static constexpr bool WIDEN = false;
  template <int A_MN, int B_MN>
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    sm90::wgmma_m64n128k16<A_MN, B_MN>(d, da, db);
  }
};
struct S8 {                            // s8 x s8 -> s32, m64n128k32
  using Acc = int;
  static constexpr int ESIZE = 1;
  static constexpr bool WIDEN = false;
  template <int A_MN, int B_MN>
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    static_assert(A_MN == 0 && B_MN == 0, "8-bit operands are K-major");
    sm90::wgmma_m64n128k32_s8(d, da, db);
  }
};
// fp8 x fp8 -> fp32 (FA, FB: 0 e4m3, 1 e5m2 each), widened exactly to
// f16 for m64n128k16.  Hopper's fp8 wgmma adds its products in fewer
// mantissa bits than fp32 keeps, even one k32 step at a time (on an H100,
// torch._scaled_mm errs 1.5-2.9e-4 of the largest output from float64,
// where fp32 sums err by about 1e-7; PERF.md): f16 wgmma sums the same
// exact products in fp32.
template <int FA_, int FB_>
struct F8 {
  using Acc = float;
  static constexpr int ESIZE = 1;
  static constexpr bool WIDEN = true;
  static constexpr int FA = FA_, FB = FB_;
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    sm90::wgmma_m64n128k16_f16(d, da, db);
  }
};

// Two blocks an SM, so that one's epilogue and ring fill overlap the
// other's products: a ring of 96 KB each.  A slice is 128 bytes of k: 64
// bf16 (ESIZE 2) or 128 8-bit elements (ESIZE 1), which the 128-byte
// swizzle holds either way, so the bytes, the stages and the descriptors
// are the same for both.  WIDEN (fp8, 64-row tiles only): a ring of two
// stages, then a buffer of a slice widened to f16, two 64-k boxes of A
// (64 rows) and of B (BN rows), 128 bytes a row as the ring's, so that
// two blocks still fit an SM.
template <int BM, int ESIZE = 2, bool WIDEN = false>
struct Shape {
  static constexpr int BK = 128 / ESIZE;          // k a slice
  static constexpr int WGS = BM / 64;             // consumer warpgroups
  static constexpr int THREADS = WGS * 128 + 32;  // and one producer warp
  static constexpr int A_BYTES = BM * BK * ESIZE, B_BYTES = BK * BN * ESIZE;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      WIDEN ? 2 : 96 * 1024 / STAGE_BYTES;   // 3 or 4; 2 widened
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int WIDE_A = 2 * BM * 128;
  static constexpr int WIDE_BYTES = WIDEN ? WIDE_A + 2 * BN * 128 : 0;
  static_assert(!WIDEN || BM == 64, "fp8 widens 64-row tiles");
  // the ring, the widened buffers, the ring's 2 * STAGES barriers, and 1
  // KB to align the ring
  static constexpr int SMEM = RING + WIDE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(BM * LDC * 4 <= RING, "staging must fit in the ring");
};

// Widens N chunks of an 8-bit ring box (128-byte rows, the 128-byte
// swizzle: chunk c of row r at c ^ (r % 8)) exactly to f16, into the two
// 64-k boxes of `rows` rows at `wide`, laid out as a bf16 ring box is:
// chunk q = q0 + 128 j (j < N) of the box: row row0 + q / 8, chunk (k 16 c
// .. 16 c + 15) c = q % 8, for this thread's q0.  All N loads are issued
// before the first store.  FMT: 0 e4m3, 1 e5m2.
template <int FMT, int N>
__device__ __forceinline__ void widen_chunks(const uint8_t* box,
                                             uint8_t* wide, int rows,
                                             int row0, int q0) {
  uint4 v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = row0 + (q0 + 128 * j) / 8, c = q0 % 8;
    v[j] = *reinterpret_cast<const uint4*>(box + r * 128 +
                                           ((c ^ (r & 7)) << 4));
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = row0 + (q0 + 128 * j) / 8, c = q0 % 8;
    const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    uint32_t o[8];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      o[2 * h] = sm90::fp8x2_to_f16x2<FMT>(w[h] & 0xffffu);
      o[2 * h + 1] = sm90::fp8x2_to_f16x2<FMT>(w[h] >> 16);
    }
    // The row's second box (c >= 4) stores its odd chunk first, so that
    // the eight threads of a row meet eight bank groups in each store.
    const int f = (c >> 2) & 1, c0 = 2 * (c & 3);
    uint8_t* row = wide + f * rows * 128 + r * 128;
    const uint4 lo = make_uint4(o[0], o[1], o[2], o[3]);
    const uint4 hi = make_uint4(o[4], o[5], o[6], o[7]);
    *reinterpret_cast<uint4*>(row + (((c0 + f) ^ (r & 7)) << 4)) =
        f ? hi : lo;
    *reinterpret_cast<uint4*>(row + (((c0 + 1 - f) ^ (r & 7)) << 4)) =
        f ? lo : hi;
  }
}

// The IM2COL walk's convolution: x (n, h, w, c) and the window r x s at
// `stride`, padded by `pad`; p x q output pixels an image.  The reduction
// is r * s * cblocks slices, tap (rr, ss) and channels cb * 64 .. of
// slice (rr * s + ss) * cblocks + cb.
struct Im2col {
  int c, s, cblocks, p, q, stride, pad;
};

// The box of `map` at (c0, c1), at entry `z` where the map is 3-D.
template <int WALK>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int z, int is3d) {
  if (WALK != SPLIT_K && is3d) sm90::tma_load_3d(dst, map, bar, c0, c1, z);
  else sm90::tma_load_2d(dst, map, bar, c0, c1);
}

// X (m x k) in TMA boxes: row-major (A_MN = 0) as one BM x 64 box per
// slice, rows m, 64 k across; column-major (A_MN = 1) as BM / 64 boxes of
// 64 k rows, 64 m across.  W (k x n): column-major (B_MN = 0) as one
// 128 x 64 box, rows n; row-major (B_MN = 1) as two boxes of 64 k rows.
// x3d / w3d (PER_ENTRY, STACKED): the operand's map is 3-D.  Split z
// walks slices z * chunk .. of k (SPLIT_K, IM2COL) or of the nb entries'
// slices (STACKED); an entry (PER_ENTRY) walks them all.  IM2COL: X is
// the im2col map of x, one BM-pixel box a slice from the tile's first
// output pixel at the slice's tap, and W the (r * s * c, K) row-major
// weights, the slice's 64 rows at (tap) * c + channel block.  T: the
// operand types (Bf16, or S8 / F8 with both operands K-major, a slice of
// 128 8-bit k); SINK: where the sums go.  fp8 (T::WIDEN, 64-row tiles):
// the warpgroup widens each ring slice exactly to f16 into its buffer (the
// rows of A below m only), gives the ring stage back, and runs f16 wgmma
// on the buffer, so that the sums are fp32 as bf16's are; the other block
// on the SM overlaps one's widening with its products.  The body of the
// kernels below:
// each instantiation carries only its own walk's and types' arithmetic,
// so matmul's and batched_matmul's compile as they did before the other
// walks were added.  rnd (bf16 operands only): the slices of the walk,
// counted from its first (s0 + i), after which the fp32 sums are rounded
// to bf16 in place (bf16 accumulation at the reference's block ends: its
// segments are an entry's k slices, or a tap's channel blocks for IM2COL);
// a rounding point waits for its slice's products first.
template <int BM, int A_MN, int B_MN, int WALK, typename T = Bf16,
          typename SINK = Sink>
__device__ __forceinline__ void gemm_wgmma(const CUtensorMap& tx,
                                           const CUtensorMap& tw,
                                           const SINK& sink, int k,
                                           int chunk, int x3d, int w3d,
                                           int nb, const Im2col& g = {},
                                           Round rnd = {}) {
  using S = Shape<BM, T::ESIZE, T::WIDEN>;
  using Acc = typename T::Acc;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = ring;
  uint8_t* Bs = ring + STAGES * S::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::RING +
                                               S::WIDE_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int entry = WALK == PER_ENTRY ? blockIdx.z : 0;
  const int s0 = WALK == PER_ENTRY ? 0 : blockIdx.z * chunk;
  const int kslices = cdiv(k, S::BK);
  const int slices =
      min(chunk, (WALK == STACKED ? nb * kslices : kslices) - s0);
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
      // STACKED: slice s0 + i is k-slice ks of entry e.
      int e = WALK == STACKED ? s0 / kslices : entry;
      int ks = WALK == STACKED ? s0 % kslices : 0;
      // IM2COL: the tile's first output pixel's window corner (w0, h0) in
      // image img; slice s0 + i is channel block cb of tap number tap.
      int w0 = 0, h0 = 0, img = 0, tap = 0, cb = 0;
      if constexpr (WALK == IM2COL) {
        img = m0 / (g.p * g.q);
        const int pq = m0 - img * g.p * g.q;
        h0 = (pq / g.q) * g.stride - g.pad;
        w0 = (pq % g.q) * g.stride - g.pad;
        tap = s0 / g.cblocks;
        cb = s0 % g.cblocks;
      }
      for (int i = 0; i < slices; ++i) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[stage], S::STAGE_BYTES);
        const int kc = (WALK == STACKED ? ks : s0 + i) * S::BK;
        uint8_t* a = As + stage * S::A_BYTES;
        uint8_t* b = Bs + stage * S::B_BYTES;
        if constexpr (WALK == IM2COL) {
          const int rr = tap / g.s, ss = tap - rr * g.s;
          sm90::tma_load_im2col_4d(a, &tx, &full[stage], cb * 64, w0, h0,
                                   img, (uint16_t)ss, (uint16_t)rr);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            sm90::tma_load_2d(b + j * BLOCK64, &tw, &full[stage],
                              n0 + 64 * j, tap * g.c + cb * 64);
          if (++cb == g.cblocks) { cb = 0; ++tap; }
        } else {
          if (A_MN) {
#pragma unroll
            for (int j = 0; j < BM / 64; ++j)
              load_box<WALK>(a + j * BLOCK64, &tx, &full[stage],
                             m0 + 64 * j, kc, e, x3d);
          } else {
            load_box<WALK>(a, &tx, &full[stage], kc, m0, e, x3d);
          }
          if (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              load_box<WALK>(b + j * BLOCK64, &tw, &full[stage],
                             n0 + 64 * j, kc, e, w3d);
          } else {
            load_box<WALK>(b, &tw, &full[stage], kc, n0, e, w3d);
          }
        }
        if (WALK == STACKED && ++ks == kslices) { ks = 0; ++e; }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns rows wg * 64 .. of the tile.
  const int wg = warp / 4;
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = Acc(0);
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  // fp8: the widened rows of A at or past m are zero, once.
  if constexpr (T::WIDEN) {
    uint8_t* const wide = ring + S::RING;
    const int arows = min(BM, sink.m - m0);
    for (int q = threadIdx.x; q < 64 * 8; q += 128)
      if (q / 8 >= arows)
#pragma unroll
        for (int box = 0; box < 2; ++box)
          *reinterpret_cast<uint4*>(wide + box * BM * 128 + q * 16) =
              make_uint4(0, 0, 0, 0);
  }
  for (int i = 0; i < slices; ++i) {
    sm90::mbar_wait(&full[stage], phase);
    // Either layout puts this warpgroup's 64 rows in one 8 KB block.
    const uint8_t* a = As + stage * S::A_BYTES + wg * BLOCK64;
    const uint8_t* b = Bs + stage * S::B_BYTES;
    if constexpr (T::WIDEN) {
      // The buffer was last read by slice i - 1's wgmma, done (below).
      // The 64 rows of A below m and the BN rows of B, eight 16-byte
      // chunks a row, four chunks a thread at a time.
      uint8_t* const wide = ring + S::RING;
      const uint8_t* ra = As + stage * S::A_BYTES;
      const uint8_t* rb = Bs + stage * S::B_BYTES;
      const int t = threadIdx.x, arows = min(BM, sink.m - m0);
      if (arows == BM)
        widen_chunks<T::FA, 4>(ra, wide, BM, 0, t);
      else
        for (int q = t; q < arows * 8; q += 128)
          widen_chunks<T::FA, 1>(ra, wide, BM, 0, q);
#pragma unroll
      for (int q = 0; q < BN * 8; q += 512)
        widen_chunks<T::FB, 4>(rb, wide + S::WIDE_A, BN, 0, q + t);
      sm90::fence_proxy_async();
      sm90::named_sync(1, 128);
      if (t == 0) sm90::mbar_arrive(&empty[stage]);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {   // two 64-k boxes, 32 bytes a step
        const int box = kk / 4, off = (kk % 4) * 32;
        T::mma(acc,
               sm90::desc_sw128(wide + box * BM * 128 + off, 16, 1024),
               sm90::desc_sw128(wide + S::WIDE_A + box * BN * 128 + off,
                                16, 1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    } else {
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {     // 32 bytes of k a step
        const uint64_t da =
            A_MN ? sm90::desc_sw128(a + kk * 2048, BLOCK64, 1024)
                 : sm90::desc_sw128(a + kk * 32, 16, 1024);
        const uint64_t db =
            B_MN ? sm90::desc_sw128(b + kk * 2048, BLOCK64, 1024)
                 : sm90::desc_sw128(b + kk * 32, 16, 1024);
        T::template mma<A_MN, B_MN>(acc, da, db);
      }
      sm90::wgmma_commit();
      sm90::fence_regs(acc);
      // The slice before this one is done: give its stage back.
      sm90::wgmma_wait<1>();
      if (i > 0 && threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[prev]);
      prev = stage;
      if constexpr (std::is_same<T, Bf16>::value) {
        if (rnd.at(s0 + i)) {
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc);
#pragma unroll
          for (int e = 0; e < 64; ++e) acc[e] = round_bf16(acc[e]);
          sm90::fence_regs(acc);
        }
      }
    }
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // Every consumer is done with the ring: stage the tile through it, then
  // store it four columns a thread, neighbouring threads on neighbouring
  // columns, in a loop that keeps the epilogue's code small.
  sm90::named_sync(1, S::WGS * 128);
  Acc* Cs = reinterpret_cast<Acc*>(ring);
  const int t = threadIdx.x % 128;
  const int r0 = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (t % 4) * 2;
    *reinterpret_cast<typename Vec<Acc>::two*>(&Cs[r0 * LDC + c]) =
        Vec<Acc>::pair(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<typename Vec<Acc>::two*>(&Cs[(r0 + 8) * LDC + c]) =
        Vec<Acc>::pair(acc[4 * j + 2], acc[4 * j + 3]);
  }
  sm90::named_sync(1, S::WGS * 128);
  const long long row0 = WALK == PER_ENTRY ? (long long)entry * sink.m : 0;
  with_act(sink.ws ? NONE : sink.e.act, [&](auto act) {
#pragma unroll 1
    for (int idx = threadIdx.x; idx < BM * BN / 4; idx += S::WGS * 128) {
      const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      sink.template quad<decltype(act)::value>(
          row0, m0 + r, n0 + c,
          *reinterpret_cast<const typename Vec<Acc>::four*>(
              &Cs[r * LDC + c]));
    }
  });
}

template <int BM, int A_MN, int B_MN, int WALK>
__global__ void __launch_bounds__(Shape<BM>::THREADS, 2)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, Sink sink, int k,
                  int chunk, int x3d, int w3d, Round rnd) {
  gemm_wgmma<BM, A_MN, B_MN, WALK>(tx, tw, sink, k, chunk, x3d, w3d, 1, {},
                                   rnd);
}

template <int BM, int A_MN, int B_MN>
__global__ void __launch_bounds__(Shape<BM>::THREADS, 2)
gemm_stacked_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw, Sink sink, int k,
                    int chunk, int x3d, int w3d, int nb, Round rnd) {
  gemm_wgmma<BM, A_MN, B_MN, STACKED>(tx, tw, sink, k, chunk, x3d, w3d, nb,
                                      {}, rnd);
}

// The 8-bit GEMM (matmul_q): both operands K-major, split k as SPLIT_K,
// the sums to SINK (the dequant epilogue, or int32 / fp32 partials).
template <int BM, typename T, typename SINK>
__global__ void __launch_bounds__(Shape<BM, 1>::THREADS, 2)
gemm_8bit_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw, SINK sink, int k,
                 int chunk) {
  gemm_wgmma<BM, 0, 0, SPLIT_K, T, SINK>(tx, tw, sink, k, chunk, 0, 0, 1);
}

// The 8-bit stacked GEMM (brgemm_q): both operands K-major, the batch
// folded into the reduction as STACKED, its slices split as SPLIT_K's k,
// the sums to SINK (the dequant, or int32 / fp32 partials).
template <int BM, typename T, typename SINK>
__global__ void __launch_bounds__(Shape<BM, 1>::THREADS, 2)
gemm_8bit_stacked_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw, SINK sink,
                         int k, int chunk, int x3d, int w3d, int nb) {
  gemm_wgmma<BM, 0, 0, STACKED, T, SINK>(tx, tw, sink, k, chunk, x3d, w3d,
                                         nb);
}

// The 8-bit batched GEMM (batched_matmul_q): both operands K-major, entry
// blockIdx.z walking its whole k (PER_ENTRY), the sums to SINK (the
// per-entry dequant).
template <int BM, typename T, typename SINK>
__global__ void __launch_bounds__(Shape<BM, 1>::THREADS, 2)
gemm_8bit_entry_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tw, SINK sink,
                       int k, int x3d, int w3d) {
  gemm_wgmma<BM, 0, 0, PER_ENTRY, T, SINK>(
      tx, tw, sink, k, cdiv(k, Shape<BM, 1>::BK), x3d, w3d, 1);
}

// The convolution (conv2d): X the im2col map of x, W the row-major
// (r * s * c, K) weights, split k as SPLIT_K.
template <int BM>
__global__ void __launch_bounds__(Shape<BM>::THREADS, 2)
gemm_im2col_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw, Sink sink, int k,
                   int chunk, Im2col g, Round rnd) {
  gemm_wgmma<BM, 0, 1, IM2COL>(tx, tw, sink, k, chunk, 0, 0, 1, g, rnd);
}

// Lets `kernel` take `bytes` of dynamic shared memory; its cudaError_t.
template <typename K>
static int with_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BM, int A_MN, int B_MN, int WALK>
static int launch_tile(const CUtensorMap& tx, const CUtensorMap& tw,
                       int x3d, int w3d, const Sink& sink, int k, int z,
                       int chunk, int nb, cudaStream_t stream,
                       Round rnd = {}) {
  using S = Shape<BM>;
  dim3 grid(cdiv(sink.m, BM), cdiv(sink.n, BN), z);
  if constexpr (WALK == STACKED) {
    auto kernel = gemm_stacked_kernel<BM, A_MN, B_MN>;
    static const int attr = with_smem(kernel, S::SMEM);
    if (attr != 0) return attr;
    kernel<<<grid, S::THREADS, S::SMEM, stream>>>(tx, tw, sink, k, chunk,
                                                  x3d, w3d, nb, rnd);
  } else {
    auto kernel = gemm_wgmma_kernel<BM, A_MN, B_MN, WALK>;
    static const int attr = with_smem(kernel, S::SMEM);
    if (attr != 0) return attr;
    kernel<<<grid, S::THREADS, S::SMEM, stream>>>(tx, tw, sink, k, chunk,
                                                  x3d, w3d, rnd);
  }
  return (int)cudaGetLastError();
}

// The launch for tile rows bm (64 or 128) and the operands' major-ness:
// a_mn (X read column-major), b_mn (W read row-major).  z: splits of k
// (SPLIT_K) or of the stacked slices (STACKED), chunk slices each, or
// batch entries (PER_ENTRY, one split); nb: the entries (STACKED); rnd:
// the rounding points of bf16 accumulation (one split only).
template <int WALK>
static int launch(int bm, int a_mn, int b_mn, const CUtensorMap& tx,
                  const CUtensorMap& tw, int x3d, int w3d, const Sink& sink,
                  int k, int z, int chunk, int nb, cudaStream_t stream,
                  Round rnd = {}) {
#define REPRO_WGMMA(BM, A, B)                                              \
  if (bm == BM && a_mn == A && b_mn == B)                                  \
    return launch_tile<BM, A, B, WALK>(tx, tw, x3d, w3d, sink, k, z,       \
                                       chunk, nb, stream, rnd);
  REPRO_WGMMA(128, 0, 0) REPRO_WGMMA(128, 0, 1) REPRO_WGMMA(128, 1, 0)
  REPRO_WGMMA(128, 1, 1) REPRO_WGMMA(64, 0, 0) REPRO_WGMMA(64, 0, 1)
  REPRO_WGMMA(64, 1, 0) REPRO_WGMMA(64, 1, 1)
#undef REPRO_WGMMA
  return (int)cudaErrorInvalidValue;
}

// The 8-bit launches (both operands K-major, operand types T), walk
// WALK: SPLIT_K (matmul_q; z splits of k, `chunk` 128-element slices
// each), STACKED (brgemm_q; z splits of the nb entries' flattened slices)
// or PER_ENTRY (batched_matmul_q; z = nb entries, one split).  x3d / w3d:
// the operand's map is 3-D (0: one matrix that every entry reads).  Tile
// rows bm: 64 or 128 for s8, 64 for fp8.
template <int BM, int WALK, typename T, typename SINK>
static int launch_8bit_tile(const CUtensorMap& tx, const CUtensorMap& tw,
                            int x3d, int w3d, const SINK& sink, int k, int z,
                            int chunk, int nb, cudaStream_t stream) {
  using S = Shape<BM, 1, T::WIDEN>;
  dim3 grid(cdiv(sink.m, BM), cdiv(sink.n, BN), z);
  auto go = [&](auto kernel, auto... walk) {
    static const int attr = with_smem(kernel, S::SMEM);
    if (attr != 0) return attr;
    kernel<<<grid, S::THREADS, S::SMEM, stream>>>(tx, tw, sink, k, walk...);
    return (int)cudaGetLastError();
  };
  if constexpr (WALK == SPLIT_K)
    return go(gemm_8bit_kernel<BM, T, SINK>, chunk);
  else if constexpr (WALK == STACKED)
    return go(gemm_8bit_stacked_kernel<BM, T, SINK>, chunk, x3d, w3d, nb);
  else
    return go(gemm_8bit_entry_kernel<BM, T, SINK>, x3d, w3d);
}

template <int WALK, typename T, typename SINK>
static int launch_8bit(int bm, const CUtensorMap& tx, const CUtensorMap& tw,
                       int x3d, int w3d, const SINK& sink, int k, int z,
                       int chunk, int nb, cudaStream_t stream) {
  if constexpr (!T::WIDEN)
    if (bm == 128)
      return launch_8bit_tile<128, WALK, T>(tx, tw, x3d, w3d, sink, k, z,
                                            chunk, nb, stream);
  if (bm == 64)
    return launch_8bit_tile<64, WALK, T>(tx, tw, x3d, w3d, sink, k, z, chunk,
                                         nb, stream);
  return (int)cudaErrorInvalidValue;
}

// The convolution's launch: BM-row tiles, `splits` runs of `chunk` of
// the window's `slices` (tap, channel block) slices.  A template, so that
// only the sources that launch it compile its kernel.
template <int BM = 128>
static int launch_im2col(const CUtensorMap& tx, const CUtensorMap& tw,
                         const Sink& sink, const Im2col& g, int slices,
                         int splits, int chunk, cudaStream_t stream,
                         Round rnd = {}) {
  using S = Shape<BM>;
  auto kernel = gemm_im2col_kernel<BM>;
  static const int attr = with_smem(kernel, S::SMEM);
  if (attr != 0) return attr;
  dim3 grid(cdiv(sink.m, BM), cdiv(sink.n, BN), splits);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(tx, tw, sink, slices * BK,
                                                chunk, g, rnd);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Split-K: the partials of each output element summed in split order, then
// the epilogue, once.  Bytes bound it (splits partials read an element).
// ---------------------------------------------------------------------------
template <typename E>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const typename E::Acc* __restrict__ ws, E e, int m,
                     int n, int splits) {
  const long long mn = (long long)m * n;
  with_act(e.act, [&](auto act) {
    for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
         i += (long long)gridDim.x * 256) {
      typename E::Acc acc = ws[i];
      for (int s = 1; s < splits; ++s) acc += ws[s * mn + i];
      const long long row = i / n;
      const int col = (int)(i % n);
      const float v = epilogue<decltype(act)::value>(e, acc, row, col);
      if (e.out_f32) static_cast<float*>(e.out)[i] = v;
      else static_cast<bf16*>(e.out)[i] = __float2bfloat16(v);
    }
  });
}

// The reduction of a (splits, m, n) workspace into e's output.
template <typename E>
static int reduce_splits(const typename E::Acc* ws, const E& e, int m, int n,
                         int splits, cudaStream_t stream) {
  const long long mn = (long long)m * n;
  const int blocks = (int)(mn < 132 * 16 * 256LL ? (mn + 255) / 256
                                                 : 132 * 16);
  splitk_reduce_kernel<E><<<blocks, 256, 0, stream>>>(ws, e, m, n, splits);
  return (int)cudaGetLastError();
}
}  // namespace wg
}  // namespace repro
