// Flash attention backward on Hopper: dQ with the softmax-Jacobian term
// delta fused in, then dK / dV with the GQA group summed in the kernel; and
// the standalone delta = rowsum(dY * Y) pass.
//
// Replaces src/repro/kernels/flash_attention/bwd.py::
// flash_attention_bwd_pallas (its two pallas_calls, dq_body and dkdv_body)
// and ::delta_rowsum_pallas.  The reference's structure is kept: no online
// softmax, P = exp(S * scale - lse) is rebuilt in one shot from the
// forward's per-row log-sum-exp, dS = P * (dP - delta) * scale, and P and
// dS are cast to the operand type before each product.  What changes is the
// schedule.  On the TPU the reduction axis was a sequential grid axis
// carrying VMEM scratch; here
//   * kernel A owns one (batch, q-head, 64-row q tile) and walks the live KV
//     tiles in a loop of its own: dQ += dS K in fp32 registers.  Before the
//     loop it computes delta for its rows from Y and dY and stores it for
//     every row, masked or not, since dK / dV needs it for all of them;
//   * kernel B owns one (batch, kv-head, 64-row k tile) and walks the
//     group's q-heads and their live q tiles: dV += P^T dY and
//     dK += dS^T Q in fp32 registers.  The GQA group sum happens inside the
//     block, so there is no (B, Hq, Tk, d) fp32 buffer to sum on the host,
//     no atomics, and the result is deterministic.
// Causal and window tiles that hold no live pair are never visited: the
// loop bounds start and end at the live tiles, as in the forward.
//
// Each call runs one of three mainloops, planned by the wrapper
// (flash_attention/bwd.py::plan_call), as the forward's are:
//   * wgmma (bf16 q, k, v, y, dy that TMA can describe; the training
//     path's case).  A producer warp feeds a ring by TMA, from 4-D tensor
//     maps over (d, t, h, b) with the views' own strides, as the forward
//     does; consumer warpgroups run every product on wgmma with the sums in
//     registers.
//     Kernel A (one consumer warpgroup, three blocks an SM for d <= 64):
//     the block's Q, dY and Y tiles arrive once and delta comes from the
//     last two in shared memory; K and V tiles of 64 keys stream through
//     the ring.  S = Q K^T and dP = dY V^T are m64n64k16 with both operands
//     K-major in shared memory; P = 2^(S * scale * log2 e - lse * log2 e)
//     (one MUFU ex2) and dS are computed on the fragments; dS, packed to
//     bf16 in the accumulator's own layout, is the register A operand of
//     dQ += dS K, K the MN-major B operand.  It also writes each row's
//     (lse * log2 e, delta) pair, +inf and 0 past Tq, into a scratch that
//     kernel B reads a tile at a time.
//     Kernel B: K and V of the block's 64 keys stay in shared memory; the
//     group's Q and dY tiles stream through the ring, each with its 64
//     (lse, delta) pairs by one 1-D bulk copy.  S^T = K Q^T and dP^T =
//     V dY^T are SS wgmma, with lse and delta per column; dV += P^T dY and
//     dK += dS^T Q are RS wgmma with dY and Q the MN-major B operands.  For
//     d <= 64 two consumer warpgroups take every other step and add their
//     partial dK, dV in a fixed order at the end, so that the longest
//     blocks run half as many steps in series.
//     P and dS never touch shared memory.  Masks are an exponent of -inf,
//     applied only on the tiles that straddle the diagonal, the window's
//     edge or Tk.  Both grids put the tile index outermost, heaviest first
//     (A: the last q tiles, which see the most keys under the causal mask;
//     B: the first k tiles, which the most q tiles see), so that the long
//     blocks start in the first wave.  d = 32 reads the forward's
//     zero-filled 64-wide box.
//   * wmma (bf16 views TMA cannot describe): the first design below.  Each
//     warp owns 16 rows; the tiles are loaded by the threads between two
//     block barriers; S, dP, P and dS go through shared memory between
//     nvcuda::wmma 16x16x16 products and the elementwise pass.
//   * simt (fp32): the same block on FMA, not TF32, so fp32 parity holds.
//
// Masking happens before the exponential: a pair outside the mask or a key
// past Tk gives p = 0 without evaluating exp.  A row with
// no valid key (lse NEG_INF; it occurs only windowed with Tq >= Tk +
// window) is what mha_ref makes it: every score NEG_INF, so the softmax
// weighs each of the Tk keys 1 / Tk (rounded to V's type, as the forward
// does), the row's output is the mean of V, and autograd gives every key's
// dV that weight times the row's dO and dQ, dK nothing.  Kernel B adds
// those rows' dO, summed over its group, to each key's dV.  Rows past Tq
// and keys past Tk are zero-filled and never stored: nothing is padded in
// device memory.  q, k, v, y and dy are read
// through their (batch, head, time) strides with a unit head_dim stride, so
// the attention layer's transposed views (v, and dy, the gradient of the
// merged heads) are read in place without a copy.
//
// What bounds it on an H100: at the training shape (B = 8, Hq = 9,
// Hkv = 3, T = 512, d = 64, causal) the five products are ~6.1 GFLOP over
// ~25 MB of q, k, v, y, dy, lse, dq, dk, dv: ~240 FLOP per byte, under the
// bf16 ridge of ~295, so bytes bound it on paper (~0.0076 ms).  On the
// wgmma path the products are a small share of a step: the elementwise
// pass between a tile's two pairs of products (an exponential and a few
// FMAs an element, on the SM's issue slots and MUFU) is the largest, and a
// warpgroup does not overlap it with its own products (blocks and
// warpgroups side by side on an SM overlap each other's).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

#include "repro_sm90.cuh"

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BQ = 64, BK = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int ROWS = 16;               // rows of a tile owned by one warp
constexpr float NEG_INF = -1e30f;      // the lse of a row with no valid key
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void *q, *k, *v, *y, *dy;
  const float* lse;    // (B, Hq, Tq)
  float* delta;        // (B, Hq, Tq): written by kernel A, read by kernel B
  void *dq, *dk, *dv;  // contiguous (B, Hq, Tq, D) and (B, Hkv, Tk, D)
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long y_sb, y_sh, y_st, dy_sb, dy_sh, dy_st;
  int hq, hkv, group, tq, tk, causal, window;   // window < 0: none
  float scale;
};

constexpr int align128(int b) { return (b + 127) / 128 * 128; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
struct Layout {
  static constexpr bool TC = std::is_same<T, bf16>::value;
  // bf16 tiles feed wmma (ld a multiple of 8, 32-byte aligned tiles); fp32
  // tiles are read by lanes across rows, so an odd stride avoids conflicts.
  static constexpr int LDQ = TC ? D + 8 : D + 1;
  static constexpr int LDS = BK + 4;    // fp32 score-shaped buffers
  static constexpr int LDP = BK + 8;    // bf16 score-shaped buffers
  static constexpr int LDO = D + 4;     // fp32 accumulator staging
  static constexpr int TILE = align128(BQ * LDQ * (int)sizeof(T));
  // Four operand tiles (Q, dY, K, V), two fp32 score buffers (S and dP on
  // the bf16 path; P or dS on the fp32 path), two bf16 score buffers (P
  // and dS, bf16 path) and the accumulator staging (bf16 path).
  static constexpr int S_OFF = 4 * TILE;
  static constexpr int DP_OFF = S_OFF + align128(BQ * LDS * 4);
  static constexpr int PH_OFF = DP_OFF + align128(BQ * LDS * 4);
  static constexpr int DSH_OFF = PH_OFF + (TC ? align128(BQ * LDP * 2) : 0);
  static constexpr int O_OFF = DSH_OFF + (TC ? align128(BQ * LDP * 2) : 0);
  static constexpr int LSE_OFF = O_OFF + (TC ? align128(BQ * LDO * 4) : 0);
  static constexpr int DEL_OFF = LSE_OFF + BQ * 4;
  static constexpr int EMPTY_OFF = DEL_OFF + BQ * 4;   // kernel B: D floats
  static constexpr int BYTES = EMPTY_OFF + D * 4;
};

// Rows [t0, t0 + rows) of one head into shared memory, zero past tmax, 16
// bytes per thread (the wrapper checks alignment).
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int t0, int rows, int tmax) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += THREADS) {
    int r = idx / CHUNKS, c = (idx % CHUNKS) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t0 + r < tmax)
      val = *reinterpret_cast<const uint4*>(src + (long long)(t0 + r) * st
                                            + c);
    if constexpr (std::is_same<T, bf16>::value) {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    } else {   // odd row stride: no 16-byte stores
      const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[r * LD + c + i] = f[i];
    }
  }
}

// delta of one row, summed by one warp: lane l multiplies columns l,
// l + 32, .. and adds them in that order, and the warp adds the lanes by
// shuffles (row_sum).  Every kernel that computes delta goes through
// row_sum, so the fused and the standalone pass agree bit for bit.
template <int D>
__device__ __forceinline__ float row_sum(const float (&y)[D / 32],
                                         const float (&dy)[D / 32]) {
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < D / 32; ++e) s += y[e] * dy[e];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

template <typename T, int D>
__device__ __forceinline__ float row_delta(const T* y, const T* dy,
                                           int lane) {
  float yv[D / 32], dyv[D / 32];
#pragma unroll
  for (int e = 0; e < D / 32; ++e) {
    yv[e] = to_f(y[lane + 32 * e]);
    dyv[e] = to_f(dy[lane + 32 * e]);
  }
  return row_sum<D>(yv, dyv);
}

// dS of one (q, k) pair; *p_out receives P.  Masked pairs give 0 without
// an exponential.
__device__ __forceinline__ float dscore(const Params& p, int q_pos,
                                        int k_pos, float s, float dp,
                                        float lse, float delta,
                                        float* p_out) {
  bool ok = q_pos < p.tq && k_pos < p.tk;
  if (p.causal) ok = ok && k_pos <= q_pos;
  if (p.window > 0) ok = ok && k_pos > q_pos - p.window;
  float pr = ok ? expf(s * p.scale - lse) : 0.0f;
  *p_out = pr;
  return pr * (dp - delta) * p.scale;
}

using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragBR = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::row_major>;
using FragBC = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::col_major>;

// Sw[16][64] = A[16 rows] B^T and DPw[16][64] = C[16 rows] E^T for one warp,
// A, C rows of a tile at stride LDQ, B, E 64-row tiles: S = Q K^T and
// dP = dY V^T in kernel A, S^T = K Q^T and dP^T = V dY^T in kernel B.
template <int D, int LDQ, int LDS>
__device__ __forceinline__ void scores_tc(const bf16* A, const bf16* B,
                                          const bf16* C, const bf16* E,
                                          float* Sw, float* DPw) {
#pragma unroll
  for (int jt = 0; jt < 64 / 16; ++jt) {
    Frag sacc, dacc;
    wmma::fill_fragment(sacc, 0.0f);
    wmma::fill_fragment(dacc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA fa;
      FragBC fb;
      wmma::load_matrix_sync(fa, A + kk, LDQ);
      wmma::load_matrix_sync(fb, B + jt * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(sacc, fa, fb, sacc);
      wmma::load_matrix_sync(fa, C + kk, LDQ);
      wmma::load_matrix_sync(fb, E + jt * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(dacc, fa, fb, dacc);
    }
    wmma::store_matrix_sync(Sw + jt * 16, sacc, LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(DPw + jt * 16, dacc, LDS, wmma::mem_row_major);
  }
}

// acc[ct] += Pw[16 x 64] X[64 x D] for one warp, X a tile at stride LDQ.
template <int D, int LDQ, int LDP>
__device__ __forceinline__ void accumulate_tc(Frag (&acc)[D / 16],
                                              const bf16* Pw,
                                              const bf16* X) {
#pragma unroll
  for (int ct = 0; ct < D / 16; ++ct) {
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      FragA fa;
      FragBR fb;
      wmma::load_matrix_sync(fa, Pw + kk, LDP);
      wmma::load_matrix_sync(fb, X + kk * LDQ + ct * 16, LDQ);
      wmma::mma_sync(acc[ct], fa, fb, acc[ct]);
    }
  }
}

// Stores this warp's 16 rows of an fp32 accumulator to dst (contiguous rows
// of D), rows at or past `valid` skipped; add[c], where given, is added to
// column c of every row.
template <typename T, int D, int LDO>
__device__ __forceinline__ void store_tc(Frag (&acc)[D / 16], float* Ow,
                                         T* dst, int valid, int lane,
                                         const float* add = nullptr) {
#pragma unroll
  for (int ct = 0; ct < D / 16; ++ct)
    wmma::store_matrix_sync(Ow + ct * 16, acc[ct], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int idx = lane; idx < ROWS * D; idx += 32) {
    int r = idx / D, c = idx % D;
    if (r < valid)
      dst[(long long)r * D + c] =
          from_f<T>(add ? Ow[r * LDO + c] + add[c] : Ow[r * LDO + c]);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Kernel A: dQ (and delta) for one (batch, q-head, q tile).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  using L = Layout<T, D>;
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDP = L::LDP, CPL = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* DYs = reinterpret_cast<T*>(smem + L::TILE);
  T* Ks = reinterpret_cast<T*>(smem + 2 * L::TILE);
  T* Vs = reinterpret_cast<T*>(smem + 3 * L::TILE);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* DPs = reinterpret_cast<float*>(smem + L::DP_OFF);
  bf16* DSh = reinterpret_cast<bf16*>(smem + L::DSH_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* LSEs = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* DELs = reinterpret_cast<float*>(smem + L::DEL_OFF);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group, q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr0 = warp * ROWS;
  const long long row0 = ((long long)b * p.hq + h) * p.tq;  // lse / delta

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const T* yg = static_cast<const T*>(p.y) + b * p.y_sb + h * p.y_sh;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;

  load_tile<T, D, LDQ>(Qs, qg, p.q_st, q0, BQ, p.tq);
  load_tile<T, D, LDQ>(DYs, dyg, p.dy_st, q0, BQ, p.tq);
  for (int r = threadIdx.x; r < BQ; r += THREADS)
    LSEs[r] = q0 + r < p.tq ? p.lse[row0 + q0 + r] : 0.0f;
  // delta for this warp's rows, stored for every row that exists.
  for (int r = 0; r < ROWS; ++r) {
    const int q_pos = q0 + wr0 + r;
    float dl = 0.0f;
    if (q_pos < p.tq)
      dl = row_delta<T, D>(yg + q_pos * p.y_st, dyg + q_pos * p.dy_st, lane);
    if (lane == 0) {
      DELs[wr0 + r] = dl;
      if (q_pos < p.tq) p.delta[row0 + q_pos] = dl;
    }
  }

  int kv_end = p.tk;
  if (p.causal) kv_end = min(kv_end, q0 + BQ);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q0 - p.window + 1);
  const int j_begin = kv_begin / BK, j_end = (kv_end + BK - 1) / BK;

  Frag acc_tc[D / 16];
  float acc[ROWS][CPL];
  if constexpr (L::TC) {
#pragma unroll
    for (int ct = 0; ct < D / 16; ++ct) wmma::fill_fragment(acc_tc[ct], 0.0f);
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[r][i] = 0.0f;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the last tile's readers are done with Ks / Vs
    load_tile<T, D, LDQ>(Ks, kg, p.k_st, k0, BK, p.tk);
    load_tile<T, D, LDQ>(Vs, vg, p.v_st, k0, BK, p.tk);
    __syncthreads();

    if constexpr (L::TC) {
      float* Sw = Ss + wr0 * LDS;
      float* DPw = DPs + wr0 * LDS;
      scores_tc<D, LDQ, LDS>(Qs + wr0 * LDQ, Ks, DYs + wr0 * LDQ, Vs, Sw,
                             DPw);
      __syncwarp();
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = lane + 32 * c;
          float pr;
          float ds = dscore(p, q0 + wr0 + r, k0 + col, Sw[r * LDS + col],
                            DPw[r * LDS + col], LSEs[wr0 + r],
                            DELs[wr0 + r], &pr);
          DSh[(wr0 + r) * LDP + col] = __float2bfloat16(ds);
        }
      }
      __syncwarp();
      accumulate_tc<D, LDQ, LDP>(acc_tc, DSh + wr0 * LDP, Ks);
    } else {
      float s[ROWS][2] = {}, dp[ROWS][2] = {};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float k0v = Ks[lane * LDQ + d], k1v = Ks[(lane + 32) * LDQ + d];
        const float v0v = Vs[lane * LDQ + d], v1v = Vs[(lane + 32) * LDQ + d];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float qv = Qs[(wr0 + r) * LDQ + d];
          const float dyv = DYs[(wr0 + r) * LDQ + d];
          s[r][0] = fmaf(qv, k0v, s[r][0]);
          s[r][1] = fmaf(qv, k1v, s[r][1]);
          dp[r][0] = fmaf(dyv, v0v, dp[r][0]);
          dp[r][1] = fmaf(dyv, v1v, dp[r][1]);
        }
      }
      float* DSw = Ss + wr0 * LDS;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float pr;
          DSw[r * LDS + lane + 32 * c] =
              dscore(p, q0 + wr0 + r, k0 + lane + 32 * c, s[r][c], dp[r][c],
                     LSEs[wr0 + r], DELs[wr0 + r], &pr);
        }
      __syncwarp();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float kv[CPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) kv[i] = Ks[kk * LDQ + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float dsv = DSw[r * LDS + kk];
#pragma unroll
          for (int i = 0; i < CPL; ++i) acc[r][i] = fmaf(dsv, kv[i], acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

  T* dqg = static_cast<T*>(p.dq) + (row0 + q0 + wr0) * D;
  const int valid = p.tq - (q0 + wr0);
  if constexpr (L::TC) {
    store_tc<T, D, L::LDO>(acc_tc, Os + wr0 * L::LDO, dqg, valid, lane);
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < valid)
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          dqg[(long long)r * D + lane + 32 * i] = acc[r][i];
  }
}

// ---------------------------------------------------------------------------
// Kernel B: dK and dV for one (batch, kv-head, k tile), summed over the
// q-heads of its group.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(Params p) {
  using L = Layout<T, D>;
  constexpr int LDQ = L::LDQ, LDS = L::LDS, LDP = L::LDP, CPL = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* DYs = reinterpret_cast<T*>(smem + L::TILE);
  T* Ks = reinterpret_cast<T*>(smem + 2 * L::TILE);
  T* Vs = reinterpret_cast<T*>(smem + 3 * L::TILE);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* DPs = reinterpret_cast<float*>(smem + L::DP_OFF);
  bf16* Ph = reinterpret_cast<bf16*>(smem + L::PH_OFF);
  bf16* DSh = reinterpret_cast<bf16*>(smem + L::DSH_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* LSEs = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* DELs = reinterpret_cast<float*>(smem + L::DEL_OFF);

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr0 = warp * ROWS;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<T, D, LDQ>(Ks, kg, p.k_st, k0, BK, p.tk);
  load_tile<T, D, LDQ>(Vs, vg, p.v_st, k0, BK, p.tk);

  // Live q tiles of this k tile: causal needs q_pos >= k0; the window needs
  // q_pos < k_pos + window <= k0 + BK - 1 + window.
  const int i_begin = p.causal ? k0 / BQ : 0;
  int q_end = p.tq;
  if (p.window > 0) q_end = min(q_end, k0 + BK - 1 + p.window);
  const int i_end = (q_end + BQ - 1) / BQ;

  Frag dk_tc[D / 16], dv_tc[D / 16];
  float dk[ROWS][CPL], dv[ROWS][CPL];
  if constexpr (L::TC) {
#pragma unroll
    for (int ct = 0; ct < D / 16; ++ct) {
      wmma::fill_fragment(dk_tc[ct], 0.0f);
      wmma::fill_fragment(dv_tc[ct], 0.0f);
    }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int i = 0; i < CPL; ++i) dk[r][i] = dv[r][i] = 0.0f;
  }

  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const long long row0 = ((long long)b * p.hq + h) * p.tq;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
    for (int i = i_begin; i < i_end; ++i) {
      const int q0 = i * BQ;
      __syncthreads();   // the last tile's readers are done with Qs / DYs
      load_tile<T, D, LDQ>(Qs, qg, p.q_st, q0, BQ, p.tq);
      load_tile<T, D, LDQ>(DYs, dyg, p.dy_st, q0, BQ, p.tq);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        const bool in = q0 + r < p.tq;
        LSEs[r] = in ? p.lse[row0 + q0 + r] : 0.0f;
        DELs[r] = in ? p.delta[row0 + q0 + r] : 0.0f;
      }
      __syncthreads();

      if constexpr (L::TC) {
        float* Sw = Ss + wr0 * LDS;     // S^T: rows k, columns q
        float* DPw = DPs + wr0 * LDS;
        scores_tc<D, LDQ, LDS>(Ks + wr0 * LDQ, Qs, Vs + wr0 * LDQ, DYs, Sw,
                               DPw);
        __syncwarp();
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = lane + 32 * c;
            float pr;
            float ds = dscore(p, q0 + col, k0 + wr0 + r, Sw[r * LDS + col],
                              DPw[r * LDS + col], LSEs[col], DELs[col], &pr);
            Ph[(wr0 + r) * LDP + col] = __float2bfloat16(pr);
            DSh[(wr0 + r) * LDP + col] = __float2bfloat16(ds);
          }
        }
        __syncwarp();
        accumulate_tc<D, LDQ, LDP>(dv_tc, Ph + wr0 * LDP, DYs);
        accumulate_tc<D, LDQ, LDP>(dk_tc, DSh + wr0 * LDP, Qs);
      } else {
        float s[ROWS][2] = {}, dp[ROWS][2] = {};
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float q0v = Qs[lane * LDQ + d];
          const float q1v = Qs[(lane + 32) * LDQ + d];
          const float y0v = DYs[lane * LDQ + d];
          const float y1v = DYs[(lane + 32) * LDQ + d];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float kv = Ks[(wr0 + r) * LDQ + d];
            const float vv = Vs[(wr0 + r) * LDQ + d];
            s[r][0] = fmaf(kv, q0v, s[r][0]);
            s[r][1] = fmaf(kv, q1v, s[r][1]);
            dp[r][0] = fmaf(vv, y0v, dp[r][0]);
            dp[r][1] = fmaf(vv, y1v, dp[r][1]);
          }
        }
        float* Pw = Ss + wr0 * LDS;
        float* DSw = DPs + wr0 * LDS;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = lane + 32 * c;
            float pr;
            DSw[r * LDS + col] = dscore(p, q0 + col, k0 + wr0 + r, s[r][c],
                                        dp[r][c], LSEs[col], DELs[col], &pr);
            Pw[r * LDS + col] = pr;
          }
        __syncwarp();
#pragma unroll 2
        for (int kk = 0; kk < BQ; ++kk) {
          float yv[CPL], qv[CPL];
#pragma unroll
          for (int i2 = 0; i2 < CPL; ++i2) {
            yv[i2] = DYs[kk * LDQ + lane + 32 * i2];
            qv[i2] = Qs[kk * LDQ + lane + 32 * i2];
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float pr = Pw[r * LDS + kk], ds = DSw[r * LDS + kk];
#pragma unroll
            for (int i2 = 0; i2 < CPL; ++i2) {
              dv[r][i2] = fmaf(pr, yv[i2], dv[r][i2]);
              dk[r][i2] = fmaf(ds, qv[i2], dk[r][i2]);
            }
          }
        }
      }
      __syncwarp();
    }
  }

  // Rows with no valid key, which only rows q_pos >= Tk + window - 1 can
  // be: w * (the sum of their dO over the group) goes to every key's dV.
  float* EMPTY = reinterpret_cast<float*>(smem + L::EMPTY_OFF);
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float sum = 0.0f;
    if (p.window > 0) {
      for (int g = 0; g < p.group; ++g) {
        const int h = hk * p.group + g;
        const long long row0 = ((long long)b * p.hq + h) * p.tq;
        const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb +
                       h * p.dy_sh;
        for (int r = max(0, p.tk + p.window - 1); r < p.tq; ++r)
          if (p.lse[row0 + r] <= 0.5f * NEG_INF)
            sum += to_f(dyg[(long long)r * p.dy_st + c]);
      }
    }
    float w = 1.0f / (float)p.tk;
    if constexpr (L::TC) w = __bfloat162float(__float2bfloat16(w));
    EMPTY[c] = w * sum;
  }
  __syncthreads();

  const long long krow = ((long long)b * p.hkv + hk) * p.tk + k0 + wr0;
  T* dkg = static_cast<T*>(p.dk) + krow * D;
  T* dvg = static_cast<T*>(p.dv) + krow * D;
  const int valid = p.tk - (k0 + wr0);
  if constexpr (L::TC) {
    float* Ow = Os + wr0 * L::LDO;
    store_tc<T, D, L::LDO>(dk_tc, Ow, dkg, valid, lane);
    store_tc<T, D, L::LDO>(dv_tc, Ow, dvg, valid, lane, EMPTY);
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < valid)
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          dkg[(long long)r * D + lane + 32 * i] = dk[r][i];
          dvg[(long long)r * D + lane + 32 * i] =
              dv[r][i] + EMPTY[lane + 32 * i];
        }
  }
}

// ---------------------------------------------------------------------------
// Standalone delta = rowsum(dY * Y): one block per (batch, head, 64 rows),
// each warp 16 rows.  Bytes bound it (two reads of (B, H, T, d), one fp32
// write per row); it is the oracle for the delta kernel A fuses.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) delta_rowsum_kernel(Params p) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* yg = static_cast<const T*>(p.y) + b * p.y_sb + h * p.y_sh;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const long long row0 = ((long long)b * p.hq + h) * p.tq;
  for (int r = 0; r < ROWS; ++r) {
    const int q_pos = qt * BQ + warp * ROWS + r;
    if (q_pos >= p.tq) break;
    float dl = row_delta<T, D>(yg + q_pos * p.y_st, dyg + q_pos * p.dy_st,
                               lane);
    if (lane == 0) p.delta[row0 + q_pos] = dl;
  }
}

template <typename T, int D>
static int launch_bwd(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<T, D>;
  static_assert(L::BYTES <= 227 * 1024, "shared memory over the SM's limit");
  auto ka = flash_bwd_dq_kernel<T, D>;
  auto kb = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kb, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  ka<<<dim3((p.tq + BQ - 1) / BQ, p.hq, batch), THREADS, L::BYTES,
       stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<dim3((p.tk + BK - 1) / BK, p.hkv, batch), THREADS, L::BYTES,
       stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_delta(const Params& p, int batch, cudaStream_t stream) {
  delta_rowsum_kernel<T, D>
      <<<dim3((p.tq + BQ - 1) / BQ, p.hq, batch), THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

#define REPRO_DISPATCH(FN, P, BATCH, D, IS_BF16, S)                      \
  do {                                                                   \
    if (IS_BF16) {                                                       \
      if (D == 32) return FN<bf16, 32>(P, BATCH, S);                     \
      if (D == 64) return FN<bf16, 64>(P, BATCH, S);                     \
      if (D == 128) return FN<bf16, 128>(P, BATCH, S);                   \
    } else {                                                             \
      if (D == 32) return FN<float, 32>(P, BATCH, S);                    \
      if (D == 64) return FN<float, 64>(P, BATCH, S);                    \
      if (D == 128) return FN<float, 128>(P, BATCH, S);                  \
    }                                                                    \
    return (int)cudaErrorInvalidValue;                                   \
  } while (0)

static Params make_params(const void* q, const void* k, const void* v,
                          const void* y, const void* dy, const float* lse,
                          float* delta, void* dq, void* dk, void* dv,
                          int hq, int hkv, int tq, int tk,
                          const long long* st, int causal, int window,
                          float scale) {
  return Params{q, k, v, y, dy, lse, delta, dq, dk, dv,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                hq, hkv, hkv > 0 ? hq / hkv : 0, tq, tk, causal, window,
                scale};
}

// q, y, dy: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D); each read through the
// (batch, head, time) strides in `strides` (q, k, v, y, dy in that order,
// 15 values, in elements) with a unit D stride.  lse: contiguous fp32
// (B, Hq, Tq).  Writes delta (contiguous fp32 (B, Hq, Tq)), dq (contiguous
// (B, Hq, Tq, D)) and dk, dv (contiguous (B, Hkv, Tk, D)), all but delta of
// q's type.  Two launches: kernel A, then kernel B, on `stream`.  Returns
// the first non-zero cudaGetLastError(), or 0.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* y, const void* dy,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int batch, int hq,
                               int hkv, int tq, int tk, int d,
                               const long long* strides, int causal,
                               int window, float scale, int is_bf16,
                               void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, y, dy, lse, delta, dq, dk, dv, hq, hkv, tq,
                         tk, strides, causal, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(launch_bwd, p, batch, d, is_bf16, s);
}

// delta = rowsum(dy * y) in fp32 into a contiguous (B, H, T); y and dy are
// (B, H, T, D) read through the (batch, head, time) strides in `strides`
// (y's three, then dy's) with a unit D stride.
extern "C" int repro_delta_rowsum(const void* y, const void* dy, float* delta,
                                  int batch, int h, int t, int d,
                                  const long long* strides, int is_bf16,
                                  void* stream) {
  long long st[15] = {0, 0, 0, 0, 0, 0, 0, 0, 0, strides[0], strides[1],
                      strides[2], strides[3], strides[4], strides[5]};
  Params p = make_params(nullptr, nullptr, nullptr, y, dy, nullptr, delta,
                         nullptr, nullptr, nullptr, h, h, t, 0, st, 0, -1,
                         1.0f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(launch_delta, p, batch, d, is_bf16, s);
}

// ---------------------------------------------------------------------------
// wgmma + TMA
// ---------------------------------------------------------------------------
namespace fb {
using namespace repro;
constexpr int TILE = 64;                // q rows, or keys, a tile
constexpr int SLICE = 64 * 128;         // 64 rows of one 64-wide d slice
constexpr float LOG2E = 1.4426950408889634f;

// Consumer warpgroups a block.  Kernel A: one.  Kernel B: two for d <= 64,
// each walking every other step of the block's (q-head, q tile) sequence
// into dK and dV partials of its own, added in a fixed order at the end, so
// that the longest blocks (the first k tiles under the causal mask) take
// half as many steps in series; d = 128 keeps one, whose dK, dV, S^T and
// dP^T fit 255 registers but not the 168 that a block of two allows.
template <int D>
constexpr int B_WGS = D <= 64 ? 2 : 1;

// A block's RES resident tiles (kernel A: Q, dY, Y; kernel B: K, V) and
// its ring of 2 + WGS stages, one fewer for d = 128.
template <int D, int WGS, int RES>
struct Shape {
  static constexpr int THREADS = WGS * 128 + 32;  // and a producer warp
  static constexpr int NS = D > 64 ? D / 64 : 1;  // 64-wide slices of d
  static constexpr int DP = NS * 64;              // d, 32 padded to 64
  static constexpr int TILE_BYTES = NS * SLICE;   // one operand tile
  static constexpr int STAGES = 2 + WGS - (D > 64 ? 1 : 0);
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // (K, V) or (Q, dY)
  // The resident tiles, the ring, kernel B's per-stage (lse, delta) rows
  // and its D sums of rows with no valid key, the barriers, 1 KB to align.
  static constexpr int RING_OFF = RES * TILE_BYTES;
  static constexpr int STATS_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int STATS_BYTES = TILE * 8;    // 64 (lse, delta) pairs
  static constexpr int EMPTY_OFF = STATS_OFF + STAGES * STATS_BYTES;
  static constexpr int BAR_OFF = EMPTY_OFF + D * 4;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  static_assert(WGS == 1 || 64 * DP * 4 <= STAGES * STAGE_BYTES,
                "a warpgroup's partial must fit in the ring");
  static_assert(SMEM <= 227 * 1024, "shared memory over the SM's limit");
};

struct WgParams {
  const bf16* dy;      // read by plain loads for the rows with no valid key
  const float* lse;    // (B, Hq, Tq)
  float* delta;        // (B, Hq, Tq)
  // (B, Hq, TQP) pairs (lse * log2 e, delta), TQP = Tq rounded up to 64,
  // +inf and 0 past Tq: written by kernel A, read by kernel B by 1-D TMA.
  float2* stats;
  bf16 *dq, *dk, *dv;  // contiguous (B, Hq, Tq, D) and (B, Hkv, Tk, D)
  long long dy_sb, dy_sh, dy_st;
  int hq, hkv, group, tq, tk, causal, window;   // window < 0: none
  float scale, scale_log2;                      // scale * log2(e)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU instruction (exp2f adds range handling around it):
// -inf gives 0, which is how masked pairs and rows past Tq get P = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

// A 64 x 64 fp32 fragment, as bf16 register A operands of four k16 steps.
__device__ __forceinline__ void pack_a(const float (&f)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    a[kb][0] = pack_bf16(f[8 * kb], f[8 * kb + 1]);
    a[kb][1] = pack_bf16(f[8 * kb + 2], f[8 * kb + 3]);
    a[kb][2] = pack_bf16(f[8 * kb + 4], f[8 * kb + 5]);
    a[kb][3] = pack_bf16(f[8 * kb + 6], f[8 * kb + 7]);
  }
}

// s = X Y^T and dp = Z W^T over d for one warpgroup, every operand a
// 64-row tile of D columns in 64-wide swizzled slices (K-major).
template <int D>
__device__ __forceinline__ void two_scores(float (&s)[32], float (&dp)[32],
                                           const uint8_t* x, const uint8_t* y,
                                           const uint8_t* z,
                                           const uint8_t* w) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int o = (kk / 4) * SLICE + (kk % 4) * 32;
    sm90::wgmma_m64n64k16<0, 0>(s, sm90::desc_sw128(x + o, 16, 1024),
                                sm90::desc_sw128(y + o, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int o = (kk / 4) * SLICE + (kk % 4) * 32;
    sm90::wgmma_m64n64k16<0, 0>(dp, sm90::desc_sw128(z + o, 16, 1024),
                                sm90::desc_sw128(w + o, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
}

// acc += A (64 x 64, registers) X, X a 64-row tile (rows along the
// reduction, d across: the MN-major B operand).  Issued, not awaited.
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 2],
                                           const uint32_t (&a)[4][4],
                                           const uint8_t* x) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint64_t db = sm90::desc_sw128(x + kb * 2048, SLICE, 1024);
    if constexpr (DP == 64) sm90::wgmma_m64n64k16_rs<1>(acc, a[kb], db);
    else sm90::wgmma_m64n128k16_rs<1>(acc, a[kb], db);
  }
}

// Warpgroup 1's fragment added to warpgroup 0's, in that order, through
// shared memory that neither reads any more (`part`, 128 * R floats).
template <int R>
__device__ __forceinline__ void add_partial(float (&acc)[R], float* part,
                                            int wg, int t) {
  sm90::named_sync(1, 256);          // both are done with `part`
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) part[i * 128 + t] = acc[i];
  }
  sm90::named_sync(1, 256);
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += part[i * 128 + t];
  }
}

// Element c of row r of a 64-row bf16 tile as TMA lays it out: 64-wide
// slices of d, 128-byte rows, 16-byte chunks XOR-permuted by r % 8.
__device__ __forceinline__ float tile_at(const uint8_t* tile, int r, int c) {
  const int cs = c % 64;
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      tile + (c / 64) * SLICE + r * 128 + ((cs / 8) ^ (r % 8)) * 16 +
      (cs % 8) * 2));
}

// This thread's rows r (and r + 8) of a 64-row fp32 fragment, as bf16
// pairs into rows of D; rows at or past `valid` skipped; add[c], where
// given, is added to column c.
template <int D, int R>
__device__ __forceinline__ void store_rows(const float (&acc)[R], bf16* dst,
                                           int r, int valid, int quad,
                                           const float* add = nullptr) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= valid) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (add != nullptr) {
        v0 += add[c];
        v1 += add[c + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row * D + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Kernel A: dQ (and delta) for one (batch, q-head, q tile).  Block
// (h, b, the q tile counted from the last).  Consumer thread t holds rows
// (t / 32) * 16 + (t % 32) / 4 (+ 8) of the tile and, of a 64-key tile or
// of dQ, columns 8 j + 2 (t % 4) (+ 1).
template <int D>
__global__ void __launch_bounds__(Shape<D, 1, 3>::THREADS, D <= 64 ? 3 : 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const __grid_constant__ CUtensorMap tmdy,
                const __grid_constant__ CUtensorMap tmy, WgParams p) {
  using S = Shape<D, 1, 3>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* DYs = Qs + S::TILE_BYTES;
  uint8_t* Ys = DYs + S::TILE_BYTES;
  uint8_t* ring = Qs + S::RING_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(Qs + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  uint64_t* qbar = empty + S::STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int hk = h / p.group, q0 = qt * TILE;
  int kv_end = p.tk;
  if (p.causal) kv_end = min(kv_end, q0 + TILE);
  const int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int j_begin = kv_begin / TILE, j_end = (kv_end + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::mbar_init(qbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(qbar, 3 * S::TILE_BYTES);
#pragma unroll
      for (int s = 0; s < S::NS; ++s) {
        sm90::tma_load_4d(Qs + s * SLICE, &tmq, qbar, 64 * s, q0, h, b);
        sm90::tma_load_4d(DYs + s * SLICE, &tmdy, qbar, 64 * s, q0, h, b);
        sm90::tma_load_4d(Ys + s * SLICE, &tmy, qbar, 64 * s, q0, h, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = j_begin; j < j_end; ++j) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[stage], S::STAGE_BYTES);
        uint8_t* ks = ring + stage * S::STAGE_BYTES;
#pragma unroll
        for (int s = 0; s < S::NS; ++s) {
          sm90::tma_load_4d(ks + s * SLICE, &tmk, &full[stage], 64 * s,
                            j * TILE, hk, b);
          sm90::tma_load_4d(ks + S::TILE_BYTES + s * SLICE, &tmv,
                            &full[stage], 64 * s, j * TILE, hk, b);
        }
        if (++stage == S::STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // The consumer warpgroup.  lse of its two rows in the log2 domain
  // (+inf past Tq makes P = 0 there), fetched while the tiles arrive.
  const int t = threadIdx.x, quad = t % 4;
  const int r_lo = warp * 16 + lane / 4;         // row in the tile
  const long long row0 = ((long long)b * p.hq + h) * p.tq;
  const int row_lo = q0 + r_lo, row_hi = row_lo + 8;
  const float ls_lo = row_lo < p.tq ? p.lse[row0 + row_lo] * LOG2E
                                    : __int_as_float(0x7f800000);
  const float ls_hi = row_hi < p.tq ? p.lse[row0 + row_hi] * LOG2E
                                    : __int_as_float(0x7f800000);
  float dq[S::DP / 2];
#pragma unroll
  for (int i = 0; i < S::DP / 2; ++i) dq[i] = 0.0f;
  sm90::mbar_wait(qbar, 0);

  // delta of this warp's 16 rows from the Y and dY tiles (zero past Tq),
  // by the standalone pass's reduction, so the two agree bit for bit; each
  // thread keeps its own two rows' values.  Kernel B's (lse, delta) rows,
  // for every row of the tile.
  float dl_lo = 0.0f, dl_hi = 0.0f;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    float yv[D / 32], dyv[D / 32];
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      yv[e] = tile_at(Ys, row, lane + 32 * e);
      dyv[e] = tile_at(DYs, row, lane + 32 * e);
    }
    const float dl = row_sum<D>(yv, dyv);
    if (lane == 0 && q0 + row < p.tq) p.delta[row0 + q0 + row] = dl;
    if (r == lane / 4) dl_lo = dl;
    if (r == lane / 4 + 8) dl_hi = dl;
  }
  if (quad == 0) {
    float2* st = p.stats + ((long long)b * p.hq + h) * gridDim.z * TILE;
    st[row_lo] = make_float2(ls_lo, dl_lo);
    st[row_hi] = make_float2(ls_hi, dl_hi);
  }

  int stage = 0;
  uint32_t phase = 0;
  for (int j = j_begin; j < j_end; ++j) {
    sm90::mbar_wait(&full[stage], phase);
    const int k0 = j * TILE;
    const uint8_t* ks = ring + stage * S::STAGE_BYTES;
    float s[32], dp[32];
    two_scores<D>(s, dp, Qs, ks, DYs, ks + S::TILE_BYTES);

    // P = 2^(S * scale * log2 e - lse * log2 e) and dS on the fragments;
    // masks (an exponent of -inf) only on the tiles that straddle the
    // diagonal, the window's edge or Tk.
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = fmaf(s[i], p.scale_log2, (i & 2) ? -ls_hi : -ls_lo);
    if (k0 + TILE > p.tk || (p.causal && k0 + TILE - 1 > q0) ||
        (p.window > 0 && k0 <= q0 + TILE - 1 - p.window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? row_hi : row_lo;
        const int col = k0 + (i / 4) * 8 + quad * 2 + (i & 1);
        if (col >= p.tk || (p.causal && col > row) ||
            (p.window > 0 && col <= row - p.window))
          s[i] = minus_inf();
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = ex2(s[i]) * (dp[i] - ((i & 2) ? dl_hi : dl_lo)) * p.scale;
    uint32_t a[4][4];
    pack_a(s, a);
    sm90::fence_regs(dq);
    sm90::wgmma_fence();
    accumulate<S::DP>(dq, a, ks);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    if (t == 0) sm90::mbar_arrive(&empty[stage]);
    if (++stage == S::STAGES) { stage = 0; phase ^= 1; }
  }
  store_rows<D>(dq, p.dq + (row0 + q0) * D, r_lo, p.tq - q0, quad);
}

// Kernel B: dK and dV for one (batch, kv-head, k tile), summed over the
// q-heads of its group.  Block (hk, b, the k tile).  Thread t of a
// consumer warpgroup holds keys (t / 32) * 16 + (t % 32) / 4 (+ 8) of the
// tile and, of a 64-row q tile, columns 8 j + 2 (t % 4) (+ 1).
template <int D>
__global__ void __launch_bounds__(Shape<D, B_WGS<D>, 2>::THREADS)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  const __grid_constant__ CUtensorMap tmdy, WgParams p) {
  constexpr int WGS = B_WGS<D>;
  using S = Shape<D, WGS, 2>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Vs = Ks + S::TILE_BYTES;
  uint8_t* ring = Ks + S::RING_OFF;
  uint8_t* stats = Ks + S::STATS_OFF;
  float* EMPTY = reinterpret_cast<float*>(Ks + S::EMPTY_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(Ks + S::BAR_OFF);
  uint64_t* empty = full + S::STAGES;
  uint64_t* kvbar = empty + S::STAGES;

  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * TILE;
  const int tqp = (p.tq + TILE - 1) / TILE * TILE;
  // Live q tiles of this k tile: causal needs q_pos >= k0; the window
  // needs q_pos < k_pos + window <= k0 + TILE - 1 + window.
  const int i_begin = p.causal ? k0 / TILE : 0;
  int q_end = p.tq;
  if (p.window > 0) q_end = min(q_end, k0 + TILE - 1 + p.window);
  const int n_i = max(0, (q_end + TILE - 1) / TILE - i_begin);
  const int steps = p.group * n_i;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::mbar_init(kvbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == WGS * 4) {  // the producer
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(kvbar, 2 * S::TILE_BYTES);
#pragma unroll
      for (int s = 0; s < S::NS; ++s) {
        sm90::tma_load_4d(Ks + s * SLICE, &tmk, kvbar, 64 * s, k0, hk, b);
        sm90::tma_load_4d(Vs + s * SLICE, &tmv, kvbar, 64 * s, k0, hk, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int step = 0; step < steps; ++step) {
        const int h = hk * p.group + step / n_i;
        const int q0 = (i_begin + step % n_i) * TILE;
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[stage],
                                    S::STAGE_BYTES + S::STATS_BYTES);
        uint8_t* qs = ring + stage * S::STAGE_BYTES;
#pragma unroll
        for (int s = 0; s < S::NS; ++s) {
          sm90::tma_load_4d(qs + s * SLICE, &tmq, &full[stage], 64 * s, q0,
                            h, b);
          sm90::tma_load_4d(qs + S::TILE_BYTES + s * SLICE, &tmdy,
                            &full[stage], 64 * s, q0, h, b);
        }
        sm90::bulk_load(stats + stage * S::STATS_BYTES,
                        p.stats + ((long long)b * p.hq + h) * tqp + q0,
                        S::STATS_BYTES, &full[stage]);
        if (++stage == S::STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // The consumer warpgroups: wg takes steps wg, wg + WGS, ..
  const int wg = warp / 4, t = threadIdx.x % 128, quad = t % 4;
  const int r_lo = (warp % 4) * 16 + lane / 4;   // key in the tile
  const int key_lo = k0 + r_lo, key_hi = key_lo + 8;
  float dk[S::DP / 2], dv[S::DP / 2];
#pragma unroll
  for (int i = 0; i < S::DP / 2; ++i) dk[i] = dv[i] = 0.0f;
  sm90::mbar_wait(kvbar, 0);

  for (int step = wg; step < steps; step += WGS) {
    const int q0 = (i_begin + step % n_i) * TILE;
    const int stage = step % S::STAGES;
    sm90::mbar_wait(&full[stage], (step / S::STAGES) & 1);
    const uint8_t* qs = ring + stage * S::STAGE_BYTES;
    const uint8_t* dys = qs + S::TILE_BYTES;
    const float2* st =
        reinterpret_cast<const float2*>(stats + stage * S::STATS_BYTES);
    float s[32], dp[32];                           // S^T, dP^T
    two_scores<D>(s, dp, Ks, qs, Vs, dys);

    // P^T and dS^T on the fragments, with (lse, delta) per column; masks
    // only on the tiles that straddle the diagonal, the window's edge or
    // Tk.  Rows past Tq have lse +inf, so P = 0 there without a mask.
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = fmaf(s[i], p.scale_log2, -st[(i / 4) * 8 + quad * 2 + (i & 1)].x);
    if (k0 + TILE > p.tk || (p.causal && k0 + TILE - 1 > q0) ||
        (p.window > 0 && k0 <= q0 + TILE - 1 - p.window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = (i & 2) ? key_hi : key_lo;
        const int col = q0 + (i / 4) * 8 + quad * 2 + (i & 1);
        if (key >= p.tk || (p.causal && key > col) ||
            (p.window > 0 && key <= col - p.window))
          s[i] = minus_inf();
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(s[i]);
      dp[i] = s[i] * (dp[i] - st[(i / 4) * 8 + quad * 2 + (i & 1)].y) *
              p.scale;
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(s, pa);
    pack_a(dp, da);
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::wgmma_fence();
    accumulate<S::DP>(dv, pa, dys);
    accumulate<S::DP>(dk, da, qs);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    if (t == 0) sm90::mbar_arrive(&empty[stage]);
  }
  if constexpr (WGS == 2) {            // every step is consumed: the ring
    float* part = reinterpret_cast<float*>(ring);   // is free
    add_partial(dk, part, wg, t);
    add_partial(dv, part, wg, t);
  }

  // Rows with no valid key, which only rows q_pos >= Tk + window - 1 can
  // be: w * (the sum of their dO over the group) goes to every key's dV.
  const bool any_empty = p.window > 0 && p.tq > p.tk + p.window - 1;
  if (any_empty) {
    for (int c = threadIdx.x; c < D; c += WGS * 128) {
      float sum = 0.0f;
      for (int g = 0; g < p.group; ++g) {
        const int h = hk * p.group + g;
        const long long row0 = ((long long)b * p.hq + h) * p.tq;
        const bf16* dyg = p.dy + b * p.dy_sb + h * p.dy_sh;
        for (int r = max(0, p.tk + p.window - 1); r < p.tq; ++r)
          if (p.lse[row0 + r] <= 0.5f * NEG_INF)
            sum += __bfloat162float(dyg[(long long)r * p.dy_st + c]);
      }
      EMPTY[c] = __bfloat162float(__float2bfloat16(1.0f / (float)p.tk)) * sum;
    }
    sm90::named_sync(1, WGS * 128);
  }
  if (wg != 0) return;
  const long long krow = ((long long)b * p.hkv + hk) * p.tk + k0;
  store_rows<D>(dk, p.dk + krow * D, r_lo, p.tk - k0, quad);
  store_rows<D>(dv, p.dv + krow * D, r_lo, p.tk - k0, quad,
                any_empty ? EMPTY : nullptr);
}

template <int D>
static int launch(const CUtensorMap* maps, const WgParams& p, int batch,
                  cudaStream_t stream) {
  using SA = Shape<D, 1, 3>;
  using SB = Shape<D, B_WGS<D>, 2>;
  auto ka = dq_wgmma_kernel<D>;
  auto kb = dkdv_wgmma_kernel<D>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        ka, cudaFuncAttributeMaxDynamicSharedMemorySize, SA::SMEM);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        kb, cudaFuncAttributeMaxDynamicSharedMemorySize, SB::SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  ka<<<dim3(p.hq, batch, (p.tq + TILE - 1) / TILE), SA::THREADS, SA::SMEM,
       stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kb<<<dim3(p.hkv, batch, (p.tk + TILE - 1) / TILE), SB::THREADS, SB::SMEM,
       stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// A (B, H, T, D) operand as a 4-D map over (d, t, h, b), box 64 x 64.
static bool map4d(CUtensorMap* map, const void* base, int d, int t, int h,
                  int batch, const long long* st) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)t, (uint64_t)h,
                            (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)st[2], (uint64_t)st[1],
                               (uint64_t)st[0]};
  const uint32_t box[4] = {64, TILE, 1, 1};
  return sm90::tensor_map_bf16_nd(map, base, 4, dims, strides, box);
}
}  // namespace fb

// The wgmma mainloop, bf16 only: as repro_flash_bwd, with every (batch,
// head, time) stride in `strides` a multiple of 8 elements (TMA's 16
// bytes; the wrapper gives a size-1 dimension a legal stand-in) and
// 16-byte aligned bases.  stats: a (B, Hq, Tq rounded up to 64, 2) fp32
// scratch, 16-byte aligned, that kernel A fills and kernel B reads.
extern "C" int repro_flash_bwd_wgmma(const void* q, const void* k,
                                     const void* v, const void* y,
                                     const void* dy, const float* lse,
                                     float* delta, void* dq, void* dk,
                                     void* dv, int batch, int hq, int hkv,
                                     int tq, int tk, int d,
                                     const long long* strides, int causal,
                                     int window, float scale, void* stats,
                                     void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || tq < 1 || tk < 1 || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;   // q, k, v, y, dy: (b, h, t) each
  CUtensorMap maps[5];             // q, k, v, dy, y
  if (!fb::map4d(&maps[0], q, d, tq, hq, batch, st) ||
      !fb::map4d(&maps[1], k, d, tk, hkv, batch, st + 3) ||
      !fb::map4d(&maps[2], v, d, tk, hkv, batch, st + 6) ||
      !fb::map4d(&maps[3], dy, d, tq, hq, batch, st + 12) ||
      !fb::map4d(&maps[4], y, d, tq, hq, batch, st + 9))
    return (int)cudaErrorInvalidValue;
  fb::WgParams p{static_cast<const bf16*>(dy), lse, delta,
                 static_cast<float2*>(stats), static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk), static_cast<bf16*>(dv), st[12],
                 st[13], st[14], hq, hkv, hq / hkv, tq, tk, causal, window,
                 scale, scale * fb::LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) return fb::launch<32>(maps, p, batch, s);
  if (d == 64) return fb::launch<64>(maps, p, batch, s);
  if (d == 128) return fb::launch<128>(maps, p, batch, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
