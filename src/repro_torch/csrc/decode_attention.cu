// Single-query decode attention for Hopper, over a paged or a contiguous
// (strip) KV cache, with the softmax run in the paper's (m, n) form.
//
// Replaces the TPU kernels in src/repro/kernels/decode_attention.py:
//   decode_attention_paged  <- decode_attention_paged_pallas
//                              (_paged_kernel + _mn_fold_tile)
//   decode_attention_contig <- decode_attention_pallas
//                              (_contig_kernel + _mn_fold_tile)
//
// Bound on this card: bytes.  Each (slot, KV head) reads its K and V rows
// once, about G = 5 multiply-adds per byte read, far below the ~295
// operations per byte where an H100 stops being memory-bound.  So:
//   * one thread block per (slot, KV head, group of up to 8 query heads):
//     the G query heads that share a KV head read its rows once;
//   * the block loops over the slot's KV in tiles of `tile` positions: the
//     TPU's sequential grid axis becomes this loop, and the (o, m, n)
//     accumulators stay in registers across it;
//   * the loop STOPS AT THE SLOT'S LENGTH (and starts at the window's first
//     tile).  The Pallas kernel sweeps every tile of the table; a tile past
//     the length contributes m = 0, n = -1e38, to which the fold adds
//     exactly zero, so skipping it changes no bit and saves its bytes.
//     Within the last tile, rows past the length are not read either;
//   * the paged kernel reads each page id from the table itself; int8
//     arenas widen their codes in registers and apply the scales inside the
//     fold: no dequantised copy is ever written.
// Both kernels call the same tile fold, so with equal tiles (block_t of
// the strip == pages_per_tile * page size) they give equal bits.
// Known weakness: S * Hkv blocks (64 at 8 slots, 8 KV heads) underfill 132
// SMs.  Split-KV with the exact (m, n) combine is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "extexp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;       // query heads per block (grid.y covers more)
constexpr int kMaxTile = 256;  // KV positions per tile
constexpr int kMaxD = 256;     // head dim (<= 2 per thread for the output)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Common {
  const void* q;         // [S, Hkv, G, D] contiguous
  void* o;               // [S, Hkv, G, Dv] contiguous, q's dtype
  const int* lengths;    // [S]
  int hkv, g, d, dv, tile, window;  // window < 0: none
  float scale;
};

// Strip cache: k/v [S, Hkv, T, D] with arbitrary strides (elements) over
// the first three axes and a contiguous last axis.
template <typename KT>
struct StripSrc {
  const KT* k;
  const KT* v;
  int64_t ks_s, ks_h, ks_t, vs_s, vs_h, vs_t;
  int s, h;
  __device__ const KT* krow(int t) const {
    return k + s * ks_s + h * ks_h + t * ks_t;
  }
  __device__ const KT* vrow(int t) const {
    return v + s * vs_s + h * vs_h + t * vs_t;
  }
  __device__ float kscale(int) const { return 1.0f; }
  __device__ float vscale(int) const { return 1.0f; }
  static constexpr bool kQuant = false;
};

// Paged cache: arenas [P, ps, Hkv, D] (strides in elements, last axis
// contiguous) gathered through the slot's row of table [S, Pmax]; optional
// f32 scales [P, ps] or [P, ps, Hkv] (sc_h = 0 for the former).
template <typename KT, bool Q>
struct PagedSrc {
  const KT* k;
  const KT* v;
  const int* table;
  const float* ksc;
  const float* vsc;
  int64_t ks_p, ks_t, ks_h, vs_p, vs_t, vs_h, sc_p, sc_t, sc_h;
  int pmax, ps, s, h;
  __device__ int page(int t) const { return table[s * pmax + t / ps]; }
  __device__ const KT* krow(int t) const {
    return k + page(t) * ks_p + (t % ps) * ks_t + h * ks_h;
  }
  __device__ const KT* vrow(int t) const {
    return v + page(t) * vs_p + (t % ps) * vs_t + h * vs_h;
  }
  __device__ float kscale(int t) const {
    return ksc[page(t) * sc_p + (t % ps) * sc_t + h * sc_h];
  }
  __device__ float vscale(int t) const {
    return vsc[page(t) * sc_p + (t % ps) * sc_t + h * sc_h];
  }
  static constexpr bool kQuant = Q;
};

// The shared body of both kernels: fold the tiles [first, len) of one
// (slot, KV head) into (o, m, n), normalise, write.
template <typename QT, typename KT, typename Src>
__device__ void decode_block(const Common& c, const Src& src, int s, int h,
                             int g0, int gn) {
  __shared__ float q_s[kMaxG * kMaxD];
  __shared__ float w_s[kMaxG * kMaxTile];  // scores, then m, then weights
  __shared__ float n_s[kMaxG * kMaxTile];
  __shared__ float mloc_s[kMaxG], nloc_s[kMaxG];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int len = c.lengths[s];
  const int tile = c.tile;

  const QT* q = static_cast<const QT*>(c.q) +
                ((static_cast<int64_t>(s) * c.hkv + h) * c.g + g0) * c.d;
  for (int i = tid; i < gn * c.d; i += kThreads) q_s[i] = to_f32(q[i]);

  float o_acc[kMaxG][2], m_acc[kMaxG], n_acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    o_acc[g][0] = o_acc[g][1] = 0.0f;
    m_acc[g] = 0.0f;
    n_acc[g] = repro::kMinusInfN;
  }
  int first = 0;
  if (c.window >= 0) first = max(0, len - c.window) / tile * tile;
  __syncthreads();

  for (int base = first; base < len; base += tile) {
    const int n_valid = min(tile, len - base);
    // 1. scores: one warp per position, lanes split the head dim.
    for (int i = warp; i < tile; i += nwarps) {
      const int t = base + i;
      if (i < n_valid) {
        const KT* kr = src.krow(t);
        float acc[kMaxG];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) acc[g] = 0.0f;
#pragma unroll 4
        for (int dd = lane; dd < c.d; dd += 32) {
          const float kv = to_f32(kr[dd]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < gn) acc[g] = fmaf(q_s[g * c.d + dd], kv, acc[g]);
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          for (int off = 16; off > 0; off >>= 1)
            acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
        if (lane == 0) {
          const float ks = Src::kQuant ? src.kscale(t) : 1.0f;
          const bool vis = c.window < 0 || t > len - 1 - c.window;
          for (int g = 0; g < gn; ++g) {
            float sc = __fmul_rn(acc[g], c.scale);
            if (Src::kQuant) sc = __fmul_rn(sc, ks);
            w_s[g * tile + i] = vis ? sc : -INFINITY;
          }
        }
      } else if (lane == 0) {
        for (int g = 0; g < gn; ++g) w_s[g * tile + i] = -INFINITY;
      }
    }
    __syncthreads();
    // 2. ExtExp, n_loc = max n, w = m * 2^(n - n_loc), m_loc = sum w:
    //    one warp per query head; the sum order is fixed.
    for (int g = warp; g < gn; g += nwarps) {
      float nmax = repro::kMinusInfN;
      for (int i = lane; i < tile; i += 32) {
        float m, n;
        repro::ext_exp(w_s[g * tile + i], m, n);
        w_s[g * tile + i] = m;
        n_s[g * tile + i] = n;
        nmax = fmaxf(nmax, n);
      }
      for (int off = 16; off > 0; off >>= 1)
        nmax = fmaxf(nmax, __shfl_xor_sync(0xffffffffu, nmax, off));
      float msum = 0.0f;
      for (int i = lane; i < tile; i += 32) {
        float w = __fmul_rn(w_s[g * tile + i],
                            repro::exp2_int(__fsub_rn(n_s[g * tile + i],
                                                      nmax)));
        msum = __fadd_rn(msum, w);
        // v_scale goes into the numerator AFTER m_loc (the denominator
        // must not see it); rows past the length are never read.
        if (Src::kQuant && i < n_valid)
          w = __fmul_rn(w, src.vscale(base + i));
        w_s[g * tile + i] = w;
      }
      for (int off = 16; off > 0; off >>= 1)
        msum = __fadd_rn(msum, __shfl_xor_sync(0xffffffffu, msum, off));
      if (lane == 0) { mloc_s[g] = msum; nloc_s[g] = nmax; }
    }
    __syncthreads();
    // 3. o_loc = w . V (one output column per thread, positions in order)
    //    and the exact fold into the running (o, m, n).
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int dd = tid + j * kThreads;
      if (dd >= c.dv) continue;
      float ol[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) ol[g] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < n_valid; ++i) {
        const float vv = to_f32(src.vrow(base + i)[dd]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < gn) ol[g] = fmaf(w_s[g * tile + i], vv, ol[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= gn) continue;
        const float nn = fmaxf(n_acc[g], nloc_s[g]);
        const float a_acc = repro::exp2_int(__fsub_rn(n_acc[g], nn));
        const float a_loc = repro::exp2_int(__fsub_rn(nloc_s[g], nn));
        o_acc[g][j] = __fadd_rn(__fmul_rn(o_acc[g][j], a_acc),
                                __fmul_rn(ol[g], a_loc));
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= gn) continue;
      const float nn = fmaxf(n_acc[g], nloc_s[g]);
      m_acc[g] = __fadd_rn(
          __fmul_rn(m_acc[g], repro::exp2_int(__fsub_rn(n_acc[g], nn))),
          __fmul_rn(mloc_s[g], repro::exp2_int(__fsub_rn(nloc_s[g], nn))));
      n_acc[g] = nn;
    }
    __syncthreads();  // w_s / mloc_s are rewritten by the next tile
  }

  // Normalise.  A free slot (length 0) has m = 0: the max() guard gives
  // exact zeros, never NaN.
  QT* o = static_cast<QT*>(c.o) +
          ((static_cast<int64_t>(s) * c.hkv + h) * c.g + g0) * c.dv;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int dd = tid + j * kThreads;
    if (dd >= c.dv) continue;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < gn)
        store(o + g * c.dv + dd,
              __fdiv_rn(o_acc[g][j], fmaxf(m_acc[g], 1e-37f)));
  }
}

__device__ __forceinline__ void block_coords(const Common& c, int& s, int& h,
                                             int& g0, int& gn) {
  s = blockIdx.x / c.hkv;
  h = blockIdx.x % c.hkv;
  g0 = blockIdx.y * kMaxG;
  gn = min(kMaxG, c.g - g0);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
    contig_kernel(Common c, StripSrc<KT> src) {
  int s, h, g0, gn;
  block_coords(c, s, h, g0, gn);
  src.s = s;
  src.h = h;
  decode_block<QT, KT>(c, src, s, h, g0, gn);
}

template <typename QT, typename KT, bool Q>
__global__ void __launch_bounds__(kThreads)
    paged_kernel(Common c, PagedSrc<KT, Q> src) {
  int s, h, g0, gn;
  block_coords(c, s, h, g0, gn);
  src.s = s;
  src.h = h;
  decode_block<QT, KT>(c, src, s, h, g0, gn);
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8.
template <typename QT, typename KT>
void launch_contig(const Common& c, dim3 grid, cudaStream_t st,
                   const void* k, const void* v, int64_t ks_s, int64_t ks_h,
                   int64_t ks_t, int64_t vs_s, int64_t vs_h, int64_t vs_t) {
  StripSrc<KT> src{static_cast<const KT*>(k), static_cast<const KT*>(v),
                   ks_s, ks_h, ks_t, vs_s, vs_h, vs_t, 0, 0};
  contig_kernel<QT, KT><<<grid, kThreads, 0, st>>>(c, src);
}

template <typename QT, typename KT, bool Q>
void launch_paged(const Common& c, dim3 grid, cudaStream_t st,
                  const void* k, const void* v, const int* table,
                  const float* ksc, const float* vsc, const int64_t* str,
                  int pmax, int ps) {
  PagedSrc<KT, Q> src{static_cast<const KT*>(k), static_cast<const KT*>(v),
                      table, ksc, vsc,
                      str[0], str[1], str[2], str[3], str[4], str[5],
                      str[6], str[7], str[8], pmax, ps, 0, 0};
  paged_kernel<QT, KT, Q><<<grid, kThreads, 0, st>>>(c, src);
}

bool shape_ok(const Common& c) {
  return c.d > 0 && c.d <= kMaxD && c.dv > 0 && c.dv <= 2 * kThreads &&
         c.tile > 0 && c.tile <= kMaxTile && c.g > 0;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// k/v strides in elements for the (slot, head, position) axes.
int decode_attention_contig(const void* q, const void* k, const void* v,
                            const int* lengths, void* o, int slots, int hkv,
                            int g, int d, int dv, int tile, int window,
                            float scale, int q_dtype, int kv_dtype,
                            int64_t ks_s, int64_t ks_h, int64_t ks_t,
                            int64_t vs_s, int64_t vs_h, int64_t vs_t,
                            void* stream) {
  Common c{q, o, lengths, hkv, g, d, dv, tile, window, scale};
  if (!shape_ok(c)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(slots * hkv, (g + kMaxG - 1) / kMaxG);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && kv_dtype == 1)
    launch_contig<__nv_bfloat16, __nv_bfloat16>(c, grid, st, k, v, ks_s,
                                                ks_h, ks_t, vs_s, vs_h, vs_t);
  else if (q_dtype == 0 && kv_dtype == 0)
    launch_contig<float, float>(c, grid, st, k, v, ks_s, ks_h, ks_t, vs_s,
                                vs_h, vs_t);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Strides in elements: k (page, pos, head), v (page, pos, head), scales
// (page, pos, head; head = 0 for per-position scales, all 0 without).
int decode_attention_paged(const void* q, const void* k_pages,
                           const void* v_pages, const int* table,
                           const int* lengths, const float* k_scale,
                           const float* v_scale, void* o, int slots,
                           int hkv, int g, int d, int dv, int pmax, int ps,
                           int tile, int window, float scale, int q_dtype,
                           int kv_dtype, int64_t ks_p, int64_t ks_t,
                           int64_t ks_h, int64_t vs_p, int64_t vs_t,
                           int64_t vs_h, int64_t sc_p, int64_t sc_t,
                           int64_t sc_h, void* stream) {
  const int64_t strides[9] = {ks_p, ks_t, ks_h, vs_p, vs_t,
                              vs_h, sc_p, sc_t, sc_h};
  Common c{q, o, lengths, hkv, g, d, dv, tile, window, scale};
  if (!shape_ok(c) || ps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(slots * hkv, (g + kMaxG - 1) / kMaxG);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (kv_dtype == 2 && !quant) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == 1 && kv_dtype == 1)
    launch_paged<__nv_bfloat16, __nv_bfloat16, false>(
        c, grid, st, k_pages, v_pages, table, k_scale, v_scale, strides,
        pmax, ps);
  else if (q_dtype == 0 && kv_dtype == 0)
    launch_paged<float, float, false>(c, grid, st, k_pages, v_pages, table,
                                      k_scale, v_scale, strides, pmax, ps);
  else if (q_dtype == 1 && kv_dtype == 2)
    launch_paged<__nv_bfloat16, int8_t, true>(c, grid, st, k_pages, v_pages,
                                              table, k_scale, v_scale,
                                              strides, pmax, ps);
  else if (q_dtype == 0 && kv_dtype == 2)
    launch_paged<float, int8_t, true>(c, grid, st, k_pages, v_pages, table,
                                      k_scale, v_scale, strides, pmax, ps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
