// The wgmma + TMA GEMM mainloop and its epilogue, shared by matmul
// (kernels/brgemm/csrc/matmul.cu) and batched_matmul
// (kernels/brgemm_batched/csrc/batched.cu): one building block.
//
// A block owns one output tile of one batch entry and walks a run of k
// slices.  128 (or 64, for m <= 64) x 128 x 64 tiles; a 96 KB ring of 3 (or
// 4) slices of X and W in shared memory, filled by TMA with the 128-byte
// swizzle by one producer warp, full and empty mbarriers per stage; one or
// two consumer warpgroups issue wgmma.mma_async m64n128k16 straight from
// the ring into 64 fp32 registers a thread, one slice's products in flight
// while the next slice is awaited.  Two blocks fit an SM, so one's epilogue
// overlaps the other's products.  The four layouts are the TMA box and the
// descriptor's major-ness alone: row-major X is K-major A, column-major X
// M-major A; row-major W is N-major B, column-major W K-major B.  Ragged
// m, n and k come from TMA's zero fill and guarded stores.  The finished
// tile is staged through the ring and stored four columns a thread by a
// loop with the activation chosen once per tile: unrolled over the 64
// registers with the activation switched per element, the epilogue outgrew
// the instruction cache and slowed the whole kernel.
//
// The grid is (m tiles, n tiles, z).  matmul (BATCHED = false): z is the
// split of k, and both operands are 2-D maps.  batched_matmul (BATCHED =
// true, one split): z is the batch entry; an operand whose tensor map is
// 3-D (the entry its outer coordinate) is read at the block's entry, so
// TMA's zero fill stops at each entry's edge, and a 2-D map (a broadcast
// operand) ignores it; entry z writes rows z * m .. of the (entries * m,
// n) output.  BATCHED is a template parameter so that matmul's kernel
// carries none of the entry's arithmetic.
#pragma once
#include "repro_sm90.cuh"
#include "repro_tile.cuh"

namespace repro {

// Where a block's fp32 sums go: the epilogue (one split), or split z's slab
// of the (splits, m, n) workspace (matmul only).
struct Sink {
  Epilogue e;
  float* ws;
  int m, n;
  // Element (row, col) of entry 0; the split is blockIdx.z.  The tile GEMMs
  // of repro_tile.cuh store through this.
  __device__ __forceinline__ void operator()(int row, int col,
                                             float v) const {
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
                                       float4 v) const {
    if (row >= m || col >= n) return;
    if (n % 4 || col + 3 >= n) {
      const float f[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < 4 && col + i < n; ++i) {
        if (ws) (*this)(row, col + i, f[i]);
        else finish(e, f[i], row0 + row, col + i);
      }
      return;
    }
    const long long o = (row0 + row) * n + col;
    if (ws) {
      *reinterpret_cast<float4*>(ws + (long long)blockIdx.z * m * n + o) = v;
      return;
    }
    v = make_float4(epilogue<ACT>(e, v.x, row0 + row, col),
                    epilogue<ACT>(e, v.y, row0 + row, col + 1),
                    epilogue<ACT>(e, v.z, row0 + row, col + 2),
                    epilogue<ACT>(e, v.w, row0 + row, col + 3));
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

// The box of `map` at (c0, c1), at entry `z` where the map is 3-D.
template <bool BATCHED>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int z, int is3d) {
  if (BATCHED && is3d) sm90::tma_load_3d(dst, map, bar, c0, c1, z);
  else sm90::tma_load_2d(dst, map, bar, c0, c1);
}

// X (m x k) in TMA boxes: row-major (A_MN = 0) as one BM x 64 box per
// slice, rows m, 64 k across; column-major (A_MN = 1) as BM / 64 boxes of
// 64 k rows, 64 m across.  W (k x n): column-major (B_MN = 0) as one
// 128 x 64 box, rows n; row-major (B_MN = 1) as two boxes of 64 k rows.
// x3d / w3d (BATCHED): the operand's map is 3-D.  Split z (matmul) walks
// slices z * chunk ...; an entry (batched_matmul) walks them all.
template <int BM, int A_MN, int B_MN, bool BATCHED>
__global__ void __launch_bounds__(Shape<BM>::THREADS, 2)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, Sink sink, int k,
                  int chunk, int x3d, int w3d) {
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
  const int entry = BATCHED ? blockIdx.z : 0;
  const int s0 = BATCHED ? 0 : blockIdx.z * chunk;
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
            load_box<BATCHED>(a + j * BLOCK64, &tx, &full[stage],
                              m0 + 64 * j, kc, entry, x3d);
        } else {
          load_box<BATCHED>(a, &tx, &full[stage], kc, m0, entry, x3d);
        }
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            load_box<BATCHED>(b + j * BLOCK64, &tw, &full[stage],
                              n0 + 64 * j, kc, entry, w3d);
        } else {
          load_box<BATCHED>(b, &tw, &full[stage], kc, n0, entry, w3d);
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
  const long long row0 = BATCHED ? (long long)entry * sink.m : 0;
  with_act(sink.ws ? NONE : sink.e.act, [&](auto act) {
#pragma unroll 1
    for (int idx = threadIdx.x; idx < BM * BN / 4; idx += S::WGS * 128) {
      const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      sink.template quad<decltype(act)::value>(
          row0, m0 + r, n0 + c,
          *reinterpret_cast<const float4*>(&Cs[r * LDC + c]));
    }
  });
}

template <int BM, int A_MN, int B_MN, bool BATCHED>
static int launch_tile(const CUtensorMap& tx, const CUtensorMap& tw,
                       int x3d, int w3d, const Sink& sink, int k, int z,
                       int chunk, cudaStream_t stream) {
  using S = Shape<BM>;
  auto kernel = gemm_wgmma_kernel<BM, A_MN, B_MN, BATCHED>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(cdiv(sink.m, BM), cdiv(sink.n, BN), z);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(tx, tw, sink, k, chunk, x3d,
                                                w3d);
  return (int)cudaGetLastError();
}

// The launch for tile rows bm (64 or 128) and the operands' major-ness:
// a_mn (X read column-major), b_mn (W read row-major).  z: splits of k
// (matmul, chunk slices each) or batch entries (BATCHED, one split).
template <bool BATCHED>
static int launch(int bm, int a_mn, int b_mn, const CUtensorMap& tx,
                  const CUtensorMap& tw, int x3d, int w3d, const Sink& sink,
                  int k, int z, int chunk, cudaStream_t stream) {
#define REPRO_WGMMA(BM, A, B)                                              \
  if (bm == BM && a_mn == A && b_mn == B)                                  \
    return launch_tile<BM, A, B, BATCHED>(tx, tw, x3d, w3d, sink, k, z,    \
                                          chunk, stream);
  REPRO_WGMMA(128, 0, 0) REPRO_WGMMA(128, 0, 1) REPRO_WGMMA(128, 1, 0)
  REPRO_WGMMA(128, 1, 1) REPRO_WGMMA(64, 0, 0) REPRO_WGMMA(64, 0, 1)
  REPRO_WGMMA(64, 1, 0) REPRO_WGMMA(64, 1, 1)
#undef REPRO_WGMMA
  return (int)cudaErrorInvalidValue;
}
}  // namespace wg
}  // namespace repro
