// Flash attention forward on Hopper: causal / windowed GQA with an online
// softmax, optional per-row log-sum-exp.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas.  On the TPU the KV blocks were a sequential
// "arbitrary" grid axis carrying the output accumulator and the running
// (m, l) statistics in VMEM scratch.  Here one block owns one
// (batch, q-head, 64-row q tile) and walks the KV tiles in a loop of its
// own, so the statistics never leave the SM.  Causal blocks above the
// diagonal are not skipped by a predicate but never visited: the loop ends
// at the diagonal tile (and, with a window, starts at the first tile the
// window reaches).  GQA reads kv head h / group in place: no repeated K or
// V.  q, k and v are read through their (batch, head, time) strides with a
// unit head_dim stride, so the transposed views that the attention layer's
// head split produces are read without a copy.  Nothing is padded: rows
// past Tq are zero-filled and never stored, and KV positions past Tk are
// masked like any other (k_pos < Tk).
//
// What bounds it on an H100: at the prefill shape of the main path
// (B = 8, Hq = 9, Hkv = 3, T = 512, d = 64) the causal work is ~2.4 GFLOP
// over ~19 MB of q, k, v and o, ~130 FLOP per byte: below the bf16 ridge of
// ~295, so the bound is bytes, but the kernel is far from either: its time
// goes to the softmax and to staging every product through shared memory.
// The bf16 path runs both products, S = Q K^T and O += P V, on the tensor
// cores (nvcuda::wmma 16x16x16, fp32 accumulate); the fp32 path runs plain
// FMA (no TF32) so fp32 parity holds.  Each warp owns 16 q rows end to end,
// so only the K / V tile loads need a block barrier.  Registers holding O
// across tiles, warp-specialised TMA loads and wgmma are later work.
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

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BK = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;   // 16

struct Params {
  const void *q, *k, *v;
  void* o;             // (B, Hq, Tq, D) contiguous
  float* lse;          // (B, Hq, Tq) or null
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  int hq, group, tq, tk, causal, window;   // window < 0: none
  float scale;
};

constexpr int align128(int b) { return (b + 127) / 128 * 128; }

template <typename T, int D>
struct Layout {
  static constexpr bool TC = std::is_same<T, bf16>::value;
  // Row strides in elements.  The bf16 tiles feed wmma (ld a multiple of 8,
  // 32-byte aligned tiles); the fp32 tiles are read by lanes across rows,
  // so an odd stride keeps them free of bank conflicts.
  static constexpr int LDQ = TC ? D + 8 : D + 1;
  static constexpr int LDS = BK + 4;        // scores, fp32
  static constexpr int LDP = BK + 8;        // probabilities, bf16 path
  static constexpr int LDO = D + 4;         // output accumulator, fp32
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = align128(Q_OFF + BQ * LDQ * (int)sizeof(T));
  static constexpr int V_OFF = align128(K_OFF + BK * LDQ * (int)sizeof(T));
  static constexpr int S_OFF = align128(V_OFF + BK * LDQ * (int)sizeof(T));
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  using L = Layout<T, D>;
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

  load_tile<T, D, L::LDQ>(Qs, qg, p.q_st, q0, BQ, p.tq);
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
    load_tile<T, D, L::LDQ>(Ks, kg, p.k_st, k0, BK, p.tk);
    load_tile<T, D, L::LDQ>(Vs, vg, p.v_st, k0, BK, p.tk);
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows ----
    float* Sw = Ss + wr0 * L::LDS;
    if constexpr (L::TC) {
#pragma unroll
      for (int jt = 0; jt < BK / 16; ++jt) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
        wmma::fill_fragment(sacc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
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
      for (int d = 0; d < D; ++d) {
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
      for (int c = lane; c < D; c += 32) Os[row * L::LDO + c] *= corr;
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
      for (int ct = 0; ct < D / 16; ++ct) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
        wmma::load_matrix_sync(oacc, Ow + ct * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Ps + wr0 * L::LDP + kk, L::LDP);
          wmma::load_matrix_sync(fb, Vs + kk * L::LDQ + ct * 16, L::LDQ);
          wmma::mma_sync(oacc, fa, fb, oacc);
        }
        wmma::store_matrix_sync(Ow + ct * 16, oacc, L::LDO,
                                wmma::mem_row_major);
      }
    } else {
      constexpr int CPL = D / 32;               // columns per lane
      float acc[ROWS_PER_WARP][CPL];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
        for (int i = 0; i < CPL; ++i) acc[r][i] = Ow[r * L::LDO + lane + 32 * i];
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float vv[CPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) vv[i] = Vs[kk * L::LDQ + lane + 32 * i];
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
  }

  // ---- finish: O / l, lse = m + log l; empty rows give the mean of V
  // and NEG_INF ----
  __syncthreads();
  T* og = static_cast<T*>(p.o) + ((long long)(b * p.hq + h) * p.tq) * D;
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    int r = idx / D, c = idx % D;
    if (q0 + r >= p.tq) continue;
    float l = Ls[r];
    float val = l > 0.0f ? Os[r * L::LDO + c] / l
                         : mean_of_v(vg, p.v_st, p.tk, c);
    if constexpr (L::TC) og[(long long)(q0 + r) * D + c] = __float2bfloat16(val);
    else og[(long long)(q0 + r) * D + c] = val;
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

template <typename T, int D>
static int launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<T, D>;
  static_assert(L::BYTES <= 227 * 1024, "shared memory over the SM's limit");
  auto kernel = flash_fwd_kernel<T, D>;
  static bool smem_set = false;   // once per instantiation (one device)
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((p.tq + BQ - 1) / BQ, p.hq, batch);
  kernel<<<grid, THREADS, L::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

// q: (B, Hq, Tq, D), k / v: (B, Hkv, Tk, D), each with the given (batch,
// head, time) strides in elements and a unit D stride.  o is a contiguous
// (B, Hq, Tq, D) of q's type; lse, when not null, a contiguous fp32
// (B, Hq, Tq).  is_bf16 selects bf16 (else fp32) for q, k, v and o.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int batch, int hq,
                               int hkv, int tq, int tk, int d,
                               long long q_sb, long long q_sh, long long q_st,
                               long long k_sb, long long k_sh, long long k_st,
                               long long v_sb, long long v_sh, long long v_st,
                               int causal, int window, float scale,
                               int is_bf16, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, q_sb, q_sh, q_st, k_sb, k_sh, k_st,
           v_sb, v_sh, v_st, hq, hq / hkv, tq, tk, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 32) return launch<bf16, 32>(p, batch, s);
    if (d == 64) return launch<bf16, 64>(p, batch, s);
    if (d == 128) return launch<bf16, 128>(p, batch, s);
  } else {
    if (d == 32) return launch<float, 32>(p, batch, s);
    if (d == 64) return launch<float, 64>(p, batch, s);
    if (d == 128) return launch<float, 128>(p, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
