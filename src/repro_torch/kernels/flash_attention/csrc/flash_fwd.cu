// Flash attention forward on Hopper: causal / windowed GQA with an online
// softmax, optional per-row log-sum-exp.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas.  On the TPU the KV blocks were a sequential
// "arbitrary" grid axis carrying the output accumulator and the running
// (m, l) statistics in VMEM scratch.  Here one block owns one
// (batch, q-head, q tile) and walks the KV tiles in a loop of its own, so
// the statistics never leave the SM.  Causal blocks above the diagonal are
// not skipped by a predicate but never visited: the loop ends at the
// diagonal tile (and, with a window, starts at the first tile the window
// reaches).  GQA reads kv head h / group in place: no repeated K or V.
// q, k and v are read through their (batch, head, time) strides with a
// unit head_dim stride, so the transposed views that the attention layer's
// head split produces are read without a copy.  q and k share one head size
// DQ and v has its own, DV: (32, 32), (64, 64), (128, 128), MLA's (192, 128)
// (128 nope + 64 rope dimensions against values of 128), and RecurrentGemma's
// (256, 256); the wrapper pads another pair with zeros up to the next one.  Nothing else is
// padded: rows past Tq are zero-filled and never stored, and KV positions
// past Tk are masked like any other (k_pos < Tk).
//
// Each call runs one of three mainloops, planned by the wrapper
// (kernel.py::plan):
//   * wgmma (bf16 q, k, v that TMA can describe; the main paths' case).
//     One producer warp loads the block's Q tile once and streams K and V
//     tiles of 64 keys into a 3-stage ring under full and empty mbarriers,
//     all by TMA from 4-D tensor maps over (d, t, h, b) with the views' own
//     strides, in 64-wide slices of d with the 128-byte swizzle.  One
//     consumer warpgroup owns the block's 64 q rows (two warpgroups of 64
//     rows each, sharing each K / V tile, ran slower at the prefill shape
//     on an H100; blocks side by side on an SM overlap instead):
//     S = Q K^T is a wgmma
//     m64n64k16 with both operands K-major in shared memory, into 32 fp32
//     registers a thread; the online softmax runs on those fragments (a
//     row's max by shuffles across its quad of threads; masks only on the
//     tiles that straddle the diagonal, the window's edge or Tk, each
//     element's (row, col) from the fragment layout); P is packed to bf16
//     in registers, and in the accumulator's own layout it is the A
//     operand of O += P V, a wgmma with A from registers and V the
//     MN-major B operand from the ring; O stays in registers over every KV
//     tile, and the epilogue divides by l and writes o and lse once.  The
//     scores run in the log2 domain (exp2 with the scale folded in).
//     d = 32 reads 64-wide boxes whose upper half TMA fills with zeros, so
//     every d runs the n = 64 (or, DV = 128, n = 128) products.  DQ = 192 is
//     three 64-wide slices of Q and K, 12 k-steps of QK^T; its ring holds
//     two stages (Q 24 KB, a stage 40 KB), so that two blocks share an SM.
//     DQ = DV = 256 is four slices of each (16 k-steps of QK^T), two stages
//     (Q 32 KB, a stage 64 KB: one block an SM), and O's 64 x 256 fp32
//     accumulator is 128 registers a thread, summed by two m64n128k16
//     products a k-step, one for each half of V's columns.
//   * wmma (bf16 views whose strides TMA cannot describe): the first
//     design below.  One block of 4 warps owns a 64-row q tile; K and V are
//     loaded by the threads between two block barriers; both products run
//     on nvcuda::wmma 16x16x16, S staged through shared memory in fp32, P
//     in bf16, and O kept in shared memory across tiles.
//   * simt (fp32): the same block on FMA (no TF32), so fp32 parity holds.
//     At DV = 256 its tiles of 64 q rows (Q, K, V, S and O in fp32) would
//     take ~281 KB of shared memory, past the SM's 227 KB: there the block
//     owns 32 q rows, 8 a warp (~202 KB).
//
// What bounds it on an H100: at the prefill shape of the main path
// (B = 8, Hq = 9, Hkv = 3, T = 512, d = 64) the causal work is ~2.4 GFLOP
// over ~19 MB of q, k, v and o, ~130 FLOP per byte: below the bf16 ridge of
// ~295, so the bound is bytes (~0.004 ms).  The wgmma kernel keeps the
// products on the tensor cores and nothing but K and V tiles in shared
// memory; its time goes to the softmax between the two products, which
// one warpgroup does not overlap with its own products (blocks side by
// side on an SM overlap each other's).
//
// bf16 accumulation (the reference's accum_dtype=bfloat16, round_k > 0):
// every mainloop rounds O to bf16 in place after each round_k keys counted
// from key 0 (two 64-key tiles; the reference's block_k) and after its last
// tile, the reference's block ends: a tile the loop bounds leave out adds
// nothing to O, and rounding twice at a point changes nothing, so causal
// and windowed starts, Tq != Tk and a ragged Tk need no case of their own.
// The rescale by corr and the running statistics stay fp32.
//
// Masked scores take p = 0 explicitly.  A row with no valid key (l = 0; it
// occurs only non-causal and windowed with Tq > Tk) stores what the plain
// mha_ref and the reference's give it: every score is NEG_INF there, so the
// softmax weighs each of the Tk keys 1 / Tk (rounded to V's type, as
// p.to(v.dtype)), and the row is the mean of V, read from device memory by
// the finish; with residuals its lse is NEG_INF.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

#include "repro_sm90.cuh"

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64, WARPS = 4, THREADS = WARPS * 32;

using repro::round_after;   // O rounded after key tile j of BK
using repro::round_bf16;

// q rows a block of the wmma / simt design: 64 (16 a warp, wmma's tile),
// but 32 for fp32 at DV = 256, whose 64-row tiles overflow shared memory.
template <typename T, int DV>
constexpr int tile_q() {
  return (!std::is_same<T, bf16>::value && DV >= 256) ? 32 : 64;
}

struct Params {
  const void *q, *k, *v;
  void* o;             // (B, Hq, Tq, DV) contiguous
  float* lse;          // (B, Hq, Tq) or null
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  int hq, group, tq, tk, causal, window;   // window < 0: none
  float scale;
  int round_k;         // bf16 accumulation's block of keys; 0: fp32
};

constexpr int align128(int b) { return (b + 127) / 128 * 128; }

template <typename T, int DQ, int DV>
struct Layout {
  static constexpr bool TC = std::is_same<T, bf16>::value;
  static constexpr int BQ = tile_q<T, DV>();
  static constexpr int ROWS_PER_WARP = BQ / WARPS;
  static_assert(!TC || ROWS_PER_WARP == 16, "wmma tiles are 16 rows a warp");
  // Row strides in elements.  The bf16 tiles feed wmma (ld a multiple of 8,
  // 32-byte aligned tiles); the fp32 tiles are read by lanes across rows,
  // so an odd stride keeps them free of bank conflicts.
  static constexpr int LDQ = TC ? DQ + 8 : DQ + 1;   // Q and K
  static constexpr int LDV = TC ? DV + 8 : DV + 1;
  static constexpr int LDS = BK + 4;        // scores, fp32
  static constexpr int LDP = BK + 8;        // probabilities, bf16 path
  static constexpr int LDO = DV + 4;        // output accumulator, fp32
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = align128(Q_OFF + BQ * LDQ * (int)sizeof(T));
  static constexpr int V_OFF = align128(K_OFF + BK * LDQ * (int)sizeof(T));
  static constexpr int S_OFF = align128(V_OFF + BK * LDV * (int)sizeof(T));
  static constexpr int P_OFF = align128(S_OFF + BQ * LDS * 4);
  static constexpr int O_OFF = align128(P_OFF + (TC ? BQ * LDP * 2 : 0));
  static constexpr int M_OFF = align128(O_OFF + BQ * LDO * 4);
  static constexpr int L_OFF = M_OFF + BQ * 4;
  static constexpr int BYTES = L_OFF + BQ * 4;
};

// Copy rows [t0, t0 + rows) of one head into shared memory (zero past tmax),
// 16 bytes per thread where the layout allows (checked by the wrapper).
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

// Column c of a row with no valid key: sum_t w * V[t][c] with the plain
// version's weight w = 1 / Tk in V's type.
template <typename T>
__device__ float mean_of_v(const T* vg, long long st, int tk, int c) {
  float w = 1.0f / (float)tk;
  if constexpr (std::is_same<T, bf16>::value)
    w = __bfloat162float(__float2bfloat16(w));
  float sum = 0.0f;
  for (int t = 0; t < tk; ++t) {
    if constexpr (std::is_same<T, bf16>::value)
      sum += w * __bfloat162float(vg[(long long)t * st + c]);
    else
      sum += w * vg[(long long)t * st + c];
  }
  return sum;
}

template <typename T, int DQ, int DV>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  using L = Layout<T, DQ, DV>;
  constexpr int BQ = L::BQ, ROWS_PER_WARP = L::ROWS_PER_WARP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q_OFF);
  T* Ks = reinterpret_cast<T*>(smem + L::K_OFF);
  T* Vs = reinterpret_cast<T*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* Ms = reinterpret_cast<float*>(smem + L::M_OFF);
  float* Ls = reinterpret_cast<float*>(smem + L::L_OFF);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr0 = warp * ROWS_PER_WARP;        // this warp's first q row

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<T, DQ, L::LDQ>(Qs, qg, p.q_st, q0, BQ, p.tq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) Os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    Ms[i] = NEG_INF;
    Ls[i] = 0.0f;
  }

  // KV tiles this q tile can see.
  int kv_end = p.tk;
  if (p.causal) kv_end = min(kv_end, q0 + BQ);          // last row's k_pos <= q_pos
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q0 - p.window + 1);  // first row's reach
  const int j_begin = kv_begin / BK, j_end = (kv_end + BK - 1) / BK;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // previous tile's readers are done with Ks / Vs
    load_tile<T, DQ, L::LDQ>(Ks, kg, p.k_st, k0, BK, p.tk);
    load_tile<T, DV, L::LDV>(Vs, vg, p.v_st, k0, BK, p.tk);
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows ----
    float* Sw = Ss + wr0 * L::LDS;
    if constexpr (L::TC) {
#pragma unroll
      for (int jt = 0; jt < BK / 16; ++jt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
        wmma::fill_fragment(sacc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < DQ; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qs + wr0 * L::LDQ + kk, L::LDQ);
          wmma::load_matrix_sync(fb, Ks + jt * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(sacc, fa, fb, sacc);
        }
        wmma::store_matrix_sync(Sw + jt * 16, sacc, L::LDS,
                                wmma::mem_row_major);
      }
    } else {
      float s[ROWS_PER_WARP][2] = {};
#pragma unroll 4
      for (int d = 0; d < DQ; ++d) {
        float k0v = Ks[lane * L::LDQ + d], k1v = Ks[(lane + 32) * L::LDQ + d];
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          float qv = Qs[(wr0 + r) * L::LDQ + d];
          s[r][0] = fmaf(qv, k0v, s[r][0]);
          s[r][1] = fmaf(qv, k1v, s[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        Sw[r * L::LDS + lane] = s[r][0];
        Sw[r * L::LDS + lane + 32] = s[r][1];
      }
    }
    __syncwarp();

    // ---- online softmax, one row at a time; lane owns keys lane, lane+32 ----
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = wr0 + r, q_pos = q0 + row;
      float sv[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int k_pos = k0 + lane + 32 * c;
        ok[c] = k_pos < p.tk;
        if (p.causal) ok[c] = ok[c] && k_pos <= q_pos;
        if (p.window > 0) ok[c] = ok[c] && k_pos > q_pos - p.window;
        sv[c] = ok[c] ? Sw[r * L::LDS + lane + 32 * c] * p.scale : NEG_INF;
      }
      float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[row];
      const float m_new = fmaxf(m_prev, mx);
      float pv[2], sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        pv[c] = ok[c] ? expf(sv[c] - m_new) : 0.0f;
        sum += pv[c];
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_prev - m_new);
      if constexpr (L::TC) {
        Ps[row * L::LDP + lane] = __float2bfloat16(pv[0]);
        Ps[row * L::LDP + lane + 32] = __float2bfloat16(pv[1]);
      } else {
        Sw[r * L::LDS + lane] = pv[0];
        Sw[r * L::LDS + lane + 32] = pv[1];
      }
      for (int c = lane; c < DV; c += 32) Os[row * L::LDO + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        Ms[row] = m_new;
        Ls[row] = corr * Ls[row] + sum;
      }
    }
    __syncwarp();

    // ---- O += P V for this warp's 16 rows ----
    float* Ow = Os + wr0 * L::LDO;
    if constexpr (L::TC) {
#pragma unroll
      for (int ct = 0; ct < DV / 16; ++ct) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
        wmma::load_matrix_sync(oacc, Ow + ct * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Ps + wr0 * L::LDP + kk, L::LDP);
          wmma::load_matrix_sync(fb, Vs + kk * L::LDV + ct * 16, L::LDV);
          wmma::mma_sync(oacc, fa, fb, oacc);
        }
        wmma::store_matrix_sync(Ow + ct * 16, oacc, L::LDO,
                                wmma::mem_row_major);
      }
    } else {
      constexpr int CPL = DV / 32;              // columns per lane
      float acc[ROWS_PER_WARP][CPL];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
        for (int i = 0; i < CPL; ++i) acc[r][i] = Ow[r * L::LDO + lane + 32 * i];
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float vv[CPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) vv[i] = Vs[kk * L::LDV + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          float pr = Sw[r * L::LDS + kk];
#pragma unroll
          for (int i = 0; i < CPL; ++i) acc[r][i] = fmaf(pr, vv[i], acc[r][i]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
        for (int i = 0; i < CPL; ++i) Ow[r * L::LDO + lane + 32 * i] = acc[r][i];
    }
    __syncwarp();
    if (round_after(p.round_k, j, j_end, BK)) {   // this warp's rows of O
      for (int i = lane; i < ROWS_PER_WARP * DV; i += 32) {
        float* o = Ow + (i / DV) * L::LDO + i % DV;
        *o = round_bf16(*o);
      }
      __syncwarp();
    }
  }

  // ---- finish: O / l, lse = m + log l; empty rows give the mean of V
  // and NEG_INF ----
  __syncthreads();
  T* og = static_cast<T*>(p.o) + ((long long)(b * p.hq + h) * p.tq) * DV;
  for (int idx = threadIdx.x; idx < BQ * DV; idx += THREADS) {
    int r = idx / DV, c = idx % DV;
    if (q0 + r >= p.tq) continue;
    float l = Ls[r];
    float val = l > 0.0f ? Os[r * L::LDO + c] / l
                         : mean_of_v(vg, p.v_st, p.tk, c);
    if constexpr (L::TC) og[(long long)(q0 + r) * DV + c] = __float2bfloat16(val);
    else og[(long long)(q0 + r) * DV + c] = val;
  }
  if (p.lse != nullptr) {
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      if (q0 + r >= p.tq) continue;
      float l = Ls[r];
      p.lse[(long long)(b * p.hq + h) * p.tq + q0 + r] =
          l > 0.0f ? Ms[r] + logf(l) : NEG_INF;
    }
  }
}

template <typename T, int DQ, int DV>
static int launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<T, DQ, DV>;
  static_assert(L::BYTES <= 227 * 1024, "shared memory over the SM's limit");
  auto kernel = flash_fwd_kernel<T, DQ, DV>;
  static bool smem_set = false;   // once per instantiation (one device)
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((p.tq + L::BQ - 1) / L::BQ, p.hq, batch);
  kernel<<<grid, THREADS, L::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

// q: (B, Hq, Tq, d), k: (B, Hkv, Tk, d), v: (B, Hkv, Tk, dv), each with the
// given (batch, head, time) strides in elements and a unit head stride;
// (d, dv) one of the instantiated pairs.  o is a contiguous (B, Hq, Tq, dv)
// of q's type; lse, when not null, a contiguous fp32 (B, Hq, Tq).  is_bf16
// selects bf16 (else fp32) for q, k, v and o.  round_k: bf16
// accumulation's block of keys (a multiple of 64), or 0 for fp32.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int batch, int hq,
                               int hkv, int tq, int tk, int d, int dv,
                               long long q_sb, long long q_sh, long long q_st,
                               long long k_sb, long long k_sh, long long k_st,
                               long long v_sb, long long v_sh, long long v_st,
                               int causal, int window, float scale,
                               int is_bf16, int round_k, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || round_k < 0 || round_k % BK)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, q_sb, q_sh, q_st, k_sb, k_sh, k_st,
           v_sb, v_sh, v_st, hq, hq / hkv, tq, tk, causal, window, scale,
           round_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 32 && dv == 32) return launch<bf16, 32, 32>(p, batch, s);
    if (d == 64 && dv == 64) return launch<bf16, 64, 64>(p, batch, s);
    if (d == 128 && dv == 128) return launch<bf16, 128, 128>(p, batch, s);
    if (d == 192 && dv == 128) return launch<bf16, 192, 128>(p, batch, s);
    if (d == 256 && dv == 256) return launch<bf16, 256, 256>(p, batch, s);
  } else {
    if (d == 32 && dv == 32) return launch<float, 32, 32>(p, batch, s);
    if (d == 64 && dv == 64) return launch<float, 64, 64>(p, batch, s);
    if (d == 128 && dv == 128) return launch<float, 128, 128>(p, batch, s);
    if (d == 192 && dv == 128) return launch<float, 192, 128>(p, batch, s);
    if (d == 256 && dv == 256) return launch<float, 256, 256>(p, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma + TMA
// ---------------------------------------------------------------------------
namespace fa {
using namespace repro;
constexpr int KV = 64;                  // keys a tile
constexpr int SLICE = 64 * 128;         // 64 rows of one 64-wide d slice
constexpr float LN2 = 0.6931471805599453f;

// A masked score: exp2 of it less any running max (>= NEG_INF) is 0.
__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

constexpr int BQ = 64;                  // q rows a block
constexpr int THREADS = 128 + 32;       // one consumer warpgroup, a producer

template <int DQ, int DV>
struct Shape {
  static constexpr int NSQ = DQ > 64 ? DQ / 64 : 1;  // 64-wide slices of q, k
  static constexpr int NSV = DV > 64 ? DV / 64 : 1;  // and of v
  static constexpr int DP = NSV * 64;                // dv, 32 padded to 64
  static constexpr int Q_BYTES = NSQ * SLICE;
  static constexpr int K_BYTES = NSQ * SLICE;        // K of one tile
  static constexpr int V_BYTES = NSV * SLICE;        // V of one tile
  static constexpr int STAGES = DQ > 128 ? 2 : 3;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // Q, the ring, 2 * STAGES + 1 barriers, and 1 KB to align the tiles
  static constexpr int SMEM =
      Q_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8 + 1024;
};

struct WgParams {
  const bf16* v;       // for the mean of V of a row with no valid key
  bf16* o;             // (B, Hq, Tq, DV) contiguous
  float* lse;          // (B, Hq, Tq) or null
  long long v_sb, v_sh, v_st;
  int hq, group, tq, tk, causal, window;   // window < 0: none
  float scale_log2;                        // scale * log2(e)
  int round_k;                             // as Params'
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Block (blockIdx.x from the last q tile: the longest causal rows start
// first, h, b).  Consumer thread t holds rows (t / 32) * 16 + (t % 32) / 4
// (+ 8) of the tile, and, of a 64-key S tile or of O, columns
// 8 j + 2 (t % 4) (+ 1): s[4 j + {0, 1}] on the first row, s[4 j + {2, 3}]
// on the row 8 below.
template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv, WgParams p) {
  using S = Shape<DQ, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = Qs + S::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::STAGES *
                                               S::STAGE_BYTES);
  uint64_t* empty = full + S::STAGES;
  uint64_t* qbar = empty + S::STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group, q0 = qt * BQ;
  // KV tiles this q tile can see.
  int kv_end = p.tk;
  if (p.causal) kv_end = min(kv_end, q0 + BQ);
  const int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int j_begin = kv_begin / KV, j_end = (kv_end + KV - 1) / KV;
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
      sm90::mbar_arrive_expect_tx(qbar, S::Q_BYTES);
#pragma unroll
      for (int s = 0; s < S::NSQ; ++s)
        sm90::tma_load_4d(Qs + s * SLICE, &tmq, qbar, 64 * s, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = j_begin; j < j_end; ++j) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[stage], S::STAGE_BYTES);
        uint8_t* ks = ring + stage * S::STAGE_BYTES;
#pragma unroll
        for (int s = 0; s < S::NSQ; ++s)
          sm90::tma_load_4d(ks + s * SLICE, &tmk, &full[stage], 64 * s,
                            j * KV, hk, b);
#pragma unroll
        for (int s = 0; s < S::NSV; ++s)
          sm90::tma_load_4d(ks + S::K_BYTES + s * SLICE, &tmv, &full[stage],
                            64 * s, j * KV, hk, b);
        if (++stage == S::STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // The consumer warpgroup.
  const int t = threadIdx.x, quad = t % 4;
  const int row_lo = q0 + (t / 32) * 16 + (t % 32) / 4;
  const int row_hi = row_lo + 8;
  float o[S::DP / 2];
#pragma unroll
  for (int i = 0; i < S::DP / 2; ++i) o[i] = 0.0f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.0f, l_hi = 0.0f;
  sm90::mbar_wait(qbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int j = j_begin; j < j_end; ++j) {
    sm90::mbar_wait(&full[stage], phase);
    // The loop bounds leave out the tiles wholly above the diagonal or
    // wholly before the first row's window.
    const int k0 = j * KV;
    const uint8_t* ks = ring + stage * S::STAGE_BYTES;
    const uint8_t* vs = ks + S::K_BYTES;
    // ---- S = Q K^T ----
    float s[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) {
      const int sl = kk / 4, off = (kk % 4) * 32;
      sm90::wgmma_m64n64k16<0, 0>(
          s, sm90::desc_sw128(Qs + sl * SLICE + off, 16, 1024),
          sm90::desc_sw128(ks + sl * SLICE + off, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // ---- the online softmax on the fragments ----
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= p.scale_log2;
    const bool edge = k0 + KV > p.tk || (p.causal && k0 + KV - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + BQ - 1 - p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i / 4) * 8 + quad * 2 + (i & 1);
        const int row = (i & 2) ? row_hi : row_lo;
        const bool ok = col < p.tk && (!p.causal || col <= row) &&
                        (p.window <= 0 || col > row - p.window);
        if (!ok) s[i] = minus_inf();
      }
    }
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx_hi = fmaxf(mx_hi, s[i]);
      else mx_lo = fmaxf(mx_lo, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // Masked scores are -inf and m stays >= NEG_INF, so they give p = 0.
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f(m_lo - mn_lo), corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - ((i & 2) ? mn_hi : mn_lo));
      if (i & 2) sum_hi += s[i];
      else sum_lo += s[i];
    }
    // l stays a per-thread partial sum until the finish: corr is the
    // same for the quad.
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < S::DP / 2; ++i) o[i] *= (i & 2) ? corr_hi : corr_lo;

    // ---- O += P V, P from registers ----
    uint32_t pa[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      pa[kb][0] = pack_bf16(s[8 * kb], s[8 * kb + 1]);
      pa[kb][1] = pack_bf16(s[8 * kb + 2], s[8 * kb + 3]);
      pa[kb][2] = pack_bf16(s[8 * kb + 4], s[8 * kb + 5]);
      pa[kb][3] = pack_bf16(s[8 * kb + 6], s[8 * kb + 7]);
    }
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint64_t db = sm90::desc_sw128(vs + kb * 2048, SLICE, 1024);
      if constexpr (S::DP == 64) {
        sm90::wgmma_m64n64k16_rs<1>(o, pa[kb], db);
      } else if constexpr (S::DP == 128) {
        sm90::wgmma_m64n128k16_rs<1>(o, pa[kb], db);
      } else {   // 256 columns: V's slices 0-1 into o[0, 64), 2-3 into the rest
        sm90::wgmma_m64n128k16_rs<1>(*reinterpret_cast<float(*)[64]>(o),
                                     pa[kb], db);
        sm90::wgmma_m64n128k16_rs<1>(
            *reinterpret_cast<float(*)[64]>(o + 64), pa[kb],
            sm90::desc_sw128(vs + 2 * SLICE + kb * 2048, SLICE, 1024));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    if (t == 0) sm90::mbar_arrive(&empty[stage]);
    if (++stage == S::STAGES) { stage = 0; phase ^= 1; }
    if (round_after(p.round_k, j, j_end, BK)) {
#pragma unroll
      for (int i = 0; i < S::DP / 2; ++i) o[i] = round_bf16(o[i]);
      sm90::fence_regs(o);
    }
  }

  // ---- finish: O / l, lse = m + log l; empty rows give the mean of V and
  // NEG_INF ----
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  bf16* og = p.o + (long long)(b * p.hq + h) * p.tq * DV;
  const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_hi : row_lo;
    const float l = half ? l_hi : l_lo, m = half ? m_hi : m_lo;
    if (row >= p.tq) continue;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      float v0, v1;
      if (l > 0.0f) {
        v0 = o[4 * j + 2 * half] / l;
        v1 = o[4 * j + 2 * half + 1] / l;
      } else {
        v0 = mean_of_v(vg, p.v_st, p.tk, c);
        v1 = mean_of_v(vg, p.v_st, p.tk, c + 1);
      }
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row * DV + c) =
          __floats2bfloat162_rn(v0, v1);
    }
    if (p.lse != nullptr && quad == 0)
      p.lse[(long long)(b * p.hq + h) * p.tq + row] =
          l > 0.0f ? (m + log2f(l)) * LN2 : NEG_INF;
  }
}

template <int DQ, int DV>
static int launch(const CUtensorMap& tq, const CUtensorMap& tk,
                  const CUtensorMap& tv, const WgParams& p, int batch,
                  cudaStream_t stream) {
  using S = Shape<DQ, DV>;
  static_assert(S::SMEM <= 227 * 1024, "shared memory over the SM's limit");
  auto kernel = flash_fwd_wgmma_kernel<DQ, DV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((p.tq + BQ - 1) / BQ, p.hq, batch);
  kernel<<<grid, THREADS, S::SMEM, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// A (B, H, T, D) operand as a 4-D map over (d, t, h, b), box 64 x rows.
static bool map4d(CUtensorMap* map, const void* base, int d, int t, int h,
                  int batch, long long st, long long sh, long long sb,
                  uint32_t rows) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)t, (uint64_t)h,
                            (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)st, (uint64_t)sh, (uint64_t)sb};
  const uint32_t box[4] = {64, rows, 1, 1};
  return sm90::tensor_map_bf16_nd(map, base, 4, dims, strides, box);
}
}  // namespace fa

// The wgmma mainloop, bf16 only: q, k, v as repro_flash_fwd's, every
// (batch, head, time) stride a multiple of 8 elements (TMA's 16 bytes; the
// wrapper gives a size-1 dimension a legal stand-in), 16-byte aligned
// bases.
extern "C" int repro_flash_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int hq, int hkv, int tq, int tk, int d, int dv,
    long long q_sb,
    long long q_sh, long long q_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    int causal, int window, float scale, int round_k, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || tk < 1 || round_k < 0 || round_k % BK)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmq, tmk, tmv;
  if (!fa::map4d(&tmq, q, d, tq, hq, batch, q_st, q_sh, q_sb, fa::BQ) ||
      !fa::map4d(&tmk, k, d, tk, hkv, batch, k_st, k_sh, k_sb, fa::KV) ||
      !fa::map4d(&tmv, v, dv, tk, hkv, batch, v_st, v_sh, v_sb, fa::KV))
    return (int)cudaErrorInvalidValue;
  fa::WgParams p{static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
                 v_sb, v_sh, v_st, hq, hq / hkv, tq, tk, causal, window,
                 (float)(scale * 1.4426950408889634), round_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32 && dv == 32) return fa::launch<32, 32>(tmq, tmk, tmv, p, batch, s);
  if (d == 64 && dv == 64) return fa::launch<64, 64>(tmq, tmk, tmv, p, batch, s);
  if (d == 128 && dv == 128)
    return fa::launch<128, 128>(tmq, tmk, tmv, p, batch, s);
  if (d == 192 && dv == 128)
    return fa::launch<192, 128>(tmq, tmk, tmv, p, batch, s);
  if (d == 256 && dv == 256)
    return fa::launch<256, 256>(tmq, tmk, tmv, p, batch, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
