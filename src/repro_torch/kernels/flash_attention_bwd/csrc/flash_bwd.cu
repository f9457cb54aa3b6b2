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
// Masking happens before the exponential: a pair outside the mask, a row
// past Tq, or a key past Tk gives p = 0 without evaluating exp.  A row with
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
// bf16 ridge of ~295, so bytes bound it on paper, but like the forward this
// kernel is far from either bound: each warp stages S, dP, P and dS through
// shared memory between wmma products and the elementwise pass.  The bf16
// path runs all five products on the tensor cores (nvcuda::wmma 16x16x16,
// fp32 accumulate); the fp32 path runs plain FMA, not TF32, so fp32 parity
// holds.  Each warp owns 16 rows end to end, so only the tile loads need a
// block barrier.  wgmma, TMA and a persistent schedule are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

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

// delta of one row, summed by one warp: the fused and the standalone pass
// both call this, so their results agree bit for bit.
template <typename T, int D>
__device__ __forceinline__ float row_delta(const T* y, const T* dy,
                                           int lane) {
  float s = 0.0f;
#pragma unroll
  for (int c = lane; c < D; c += 32) s += to_f(y[c]) * to_f(dy[c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(FULL, s, off);
  return s;
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

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
