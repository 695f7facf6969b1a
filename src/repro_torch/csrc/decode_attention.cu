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
// once, ~2.5 multiply-adds per byte read (G = 5 query heads share a KV
// head), far below the ~295 operations per byte where an H100 stops being
// memory-bound.  At 8 slots and 8 KV heads there are only 64 (slot, KV
// head) pairs for 132 SMs, so the work is split along the cache (split-KV):
//   * grid (slots * Hkv, ceil(T_max / tile), query-head groups): one block
//     folds ONE tile of `tile` positions of one (slot, KV head) for its
//     query heads (they read the KV head's rows once) and writes the tile's
//     partial (o_loc[Dv], m_loc, n_loc) to a float32 scratch
//     [S, Hkv, G, n_split, Dv + 2].  A block whose tile lies past the
//     slot's length, or before the window's first tile, returns at once:
//     the TPU kernel sweeps every tile of the table, but a tile past the
//     length adds exactly zero to the fold, so skipping it changes no bit
//     and saves its bytes.  Rows past the length are never read;
//   * a second kernel, launched by the same C entry on the same stream,
//     folds each (slot, KV head, query head)'s live tiles IN TILE ORDER with
//     the exact (m, n) rescales (powers of two), then normalises; it keeps
//     16 tiles' partials in flight ahead of the fold.  The general body's
//     partials are those of a sequential loop over the tiles, and the
//     combine is that loop's fold, so its outputs do not depend on the
//     split (chip_smoke.py pins their bits: DECODE_DIGEST).
// Two tile bodies:
//   * tile_bf16 (bf16 q and K/V, D and Dv multiples of 8, 16-byte aligned
//     rows): a group of LPR >= 8 lanes covers one row, each lane 8 columns
//     with one 16-byte load, so a warp reads 32 / LPR rows a load.  Each
//     warp issues 4 rows' K and V loads before using any, keeps q and
//     o[G][8] in float32 registers (float32 FMA keeps up with the memory
//     rate: no tensor cores needed) and runs an online (m, n) fold of its
//     own positions with no barrier.  The group's partial dot products are
//     reduce-scattered so that one lane owns each query head's score: that
//     lane alone runs ExtExp and the head's (m, n) state, and hands its
//     weight to the group by a shuffle.  The four warps' (o, m, n) are
//     folded once, in warp order, through shared memory.  What bounds it
//     now is latency, not bytes: a block's warps wait out 4 round trips to
//     memory each, at 3 blocks an SM (~150 registers);
//   * tile_general (float32, int8 pages with scales, and what tile_bf16
//     does not take): one warp per position scores through shared memory,
//     ExtExp and the fold by query head, then w . V one column a thread;
//     int8 arenas widen their codes in registers and apply the scales
//     inside the fold: no dequantised copy is ever written.
// The wrapper chooses the body (kernels/decode_attention.py:kernel_body);
// this file refuses a bf16-body launch whose operands do not meet its
// conditions.  Strip and paged run the same body on the same tiles, so with
// equal tiles (block_t of the strip == pages_per_tile * page size) they give
// equal bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "extexp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;       // query heads per block (grid.z covers more)
constexpr int kMaxTile = 256;  // KV positions per tile
constexpr int kMaxD = 256;     // head dim (<= 2 per thread for the output)
constexpr int kBatch = 4;      // bf16 body: row loads in flight per lane
constexpr int kAhead = 16;     // combine: tiles' partials in flight

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
  float* part;           // [S, Hkv, G, n_split, Dv + 2] float32 scratch
  int hkv, g, d, dv, tile, window;  // window < 0: none
  int n_split, gm, lpr;  // tiles a slot; query heads a block; lanes a row
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
  __device__ void rows(int t, const KT*& kr, const KT*& vr) const {
    kr = krow(t);
    vr = vrow(t);
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
  // both rows of position t from one table read
  __device__ void rows(int t, const KT*& kr, const KT*& vr) const {
    const int64_t p = table[s * pmax + t / ps], r = t % ps;
    kr = k + p * ks_p + r * ks_t + h * ks_h;
    vr = v + p * vs_p + r * vs_t + h * vs_h;
  }
  __device__ float kscale(int t) const {
    return ksc[page(t) * sc_p + (t % ps) * sc_t + h * sc_h];
  }
  __device__ float vscale(int t) const {
    return vsc[page(t) * sc_p + (t % ps) * sc_t + h * sc_h];
  }
  static constexpr bool kQuant = Q;
};

// The window's first tile: tiles before it hold no visible position.
__device__ __forceinline__ int first_tile_base(const Common& c, int len) {
  return c.window >= 0 ? max(0, len - c.window) / c.tile * c.tile : 0;
}

// This block's (slot, KV head, query heads, tile); false when its tile
// holds nothing to fold.
__device__ __forceinline__ bool tile_coords(const Common& c, int& s, int& h,
                                            int& g0, int& gn, int& base) {
  s = blockIdx.x / c.hkv;
  h = blockIdx.x % c.hkv;
  g0 = blockIdx.z * c.gm;
  gn = min(c.gm, c.g - g0);
  base = blockIdx.y * c.tile;
  const int len = c.lengths[s];
  return gn > 0 && base < len && base >= first_tile_base(c, len);
}

// The tile's partial for query head g0 + g: o_loc at [0, Dv), m_loc at Dv,
// n_loc at Dv + 1.
__device__ __forceinline__ float* part_row(const Common& c, int s, int h,
                                           int gq) {
  return c.part +
         ((static_cast<int64_t>(s * c.hkv + h) * c.g + gq) * c.n_split +
          blockIdx.y) * (c.dv + 2);
}

// ---------------------------------------------------------------------------
// The general body: one tile of positions [base, base + tile) of one
// (slot, KV head) into (o_loc, m_loc, n_loc) for query heads g0 .. g0+gn.
// ---------------------------------------------------------------------------
template <typename QT, typename KT, typename Src>
__device__ void tile_general(const Common& c, const Src& src, int s, int h,
                             int g0, int gn, int base) {
  __shared__ float q_s[kMaxG * kMaxD];
  __shared__ float w_s[kMaxG * kMaxTile];  // scores, then m, then weights
  __shared__ float n_s[kMaxG * kMaxTile];
  __shared__ float mloc_s[kMaxG], nloc_s[kMaxG];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = c.lengths[s];
  const int tile = c.tile;

  const QT* q = static_cast<const QT*>(c.q) +
                ((static_cast<int64_t>(s) * c.hkv + h) * c.g + g0) * c.d;
  for (int i = tid; i < gn * c.d; i += kThreads) q_s[i] = to_f32(q[i]);
  __syncthreads();

  const int n_valid = min(tile, len - base);
  // 1. scores: one warp per position, lanes split the head dim.
  for (int i = warp; i < tile; i += kWarps) {
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
  for (int g = warp; g < gn; g += kWarps) {
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
  // 3. o_loc = w . V (one output column per thread, positions in order).
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
    for (int g = 0; g < kMaxG; ++g)
      if (g < gn) part_row(c, s, h, g0 + g)[dd] = ol[g];
  }
  if (tid < gn) {
    float* p = part_row(c, s, h, g0 + tid);
    p[c.dv] = mloc_s[tid];
    p[c.dv + 1] = nloc_s[tid];
  }
}

// ---------------------------------------------------------------------------
// The bf16 body: the same tile's partial, with 16-byte row loads and the
// accumulators in registers.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The lane of a group that ends up with query head g's score: the
// identity for GM <= 2 (a butterfly a head), else 3-bit reversal (the
// reduce-scatter of group_score).
template <int GM>
__device__ __forceinline__ int owner(int g) {
  if constexpr (GM <= 2) return g;
  else return ((g >> 2) & 1) | (g & 2) | ((g & 1) << 2);
}

// One row's scores for query heads [0, GM): the group's LPR partial dot
// products summed across the group.  Lane gl returns the score of the
// head it owns (owner(head) == gl % 8); every lane owning a head gets the
// same bits.  GM > 2 pads to 8 heads and reduce-scatters them over lane
// bits 0-2 (7 shuffles), then sums over the higher bits.
template <int GM, int LPR>
__device__ __forceinline__ float group_score(const float (&qr)[GM][8],
                                             const float (&kf)[8], int gl) {
  constexpr int NV = GM <= 2 ? GM : 8;
  float v[NV];
#pragma unroll
  for (int g = 0; g < NV; ++g) {
    v[g] = 0.0f;
    if (g < GM) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[g] = fmaf(qr[g][j], kf[j], v[g]);
    }
  }
  if constexpr (GM <= 2) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        v[g] += __shfl_xor_sync(0xffffffffu, v[g], off);
    return (GM == 2 && gl == 1) ? v[GM - 1] : v[0];
  } else {
    const bool b0 = gl & 1, b1 = gl & 2, b2 = gl & 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float keep = b0 ? v[4 + i] : v[i], send = b0 ? v[i] : v[4 + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float keep = b1 ? v[2 + i] : v[i], send = b1 ? v[i] : v[2 + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
    const float keep = b2 ? v[1] : v[0], send = b2 ? v[0] : v[1];
    v[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
#pragma unroll
    for (int off = 8; off < LPR; off <<= 1)
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    return v[0];
  }
}

template <int GM, int LPR, typename Src>
__device__ void tile_bf16(const Common& c, const Src& src, int s, int h,
                          int g0, int gn, int base) {
  constexpr int kRows = 32 / LPR;        // rows a warp load covers
  constexpr int kStep = kWarps * kRows;  // positions one load of all warps
  __shared__ float o_s[kWarps][GM][kMaxD];
  __shared__ float m_s[kWarps][GM], n_s[kWarps][GM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = c.lengths[s];
  const int gl = lane % LPR, grp = lane / LPR, col = gl * 8;
  const int lead = grp * LPR;            // the lane group's first lane
  const bool kcol = col < c.d, vcol = col < c.dv;
  const int n_valid = min(c.tile, len - base);

  // this lane's 8 columns of each query head, in float32
  float qr[GM][8];
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(c.q) +
                           ((static_cast<int64_t>(s) * c.hkv + h) * c.g +
                            g0) * c.d + col;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      qr[g][j] = (g < gn && kcol) ? __bfloat162float(q[g * c.d + j]) : 0.0f;

  // Online (m, n) fold of this warp's positions.  The lane that owns a
  // query head's score runs that head's softmax: ExtExp once a score, not
  // once a lane.  n_run is the same in every group (a butterfly max);
  // m_run and o sum the group's own positions until the end.
  float o[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[g][j] = 0.0f;
  float m_run = 0.0f, n_run = repro::kMinusInfN;
  for (int i0 = warp * kRows; i0 < n_valid; i0 += kBatch * kStep) {
    // every K and V load of the batch is issued before any is used; rows
    // past the length or outside the window are not read (zeros, w = 0)
    uint4 kr[kBatch], vr[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kStep + grp, t = base + i;
      live[b] = i < n_valid && (c.window < 0 || t > len - 1 - c.window);
      kr[b] = vr[b] = make_uint4(0, 0, 0, 0);
      if (live[b]) {
        const __nv_bfloat16 *krp, *vrp;
        src.rows(t, krp, vrp);
        if (kcol) kr[b] = __ldg(reinterpret_cast<const uint4*>(krp + col));
        if (vcol) vr[b] = __ldg(reinterpret_cast<const uint4*>(vrp + col));
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (i0 + b * kStep >= n_valid) break;  // warp-uniform
      float kf[8], vf[8];
      bf16x8(kr[b], kf);
      bf16x8(vr[b], vf);
      const float mine = group_score<GM, LPR>(qr, kf, gl);
      const float sc = live[b] ? __fmul_rn(mine, c.scale) : -INFINITY;
      float m, n;
      repro::ext_exp(sc, m, n);
      float nb = n;
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        nb = fmaxf(nb, __shfl_xor_sync(0xffffffffu, nb, off));
      float a = 1.0f;                        // exact rescale of the state
      if (nb > n_run) {
        a = repro::exp2_int(__fsub_rn(n_run, nb));
        m_run = __fmul_rn(m_run, a);
        n_run = nb;
      }
      const float w = __fmul_rn(m, repro::exp2_int(__fsub_rn(n, n_run)));
      m_run = __fadd_rn(m_run, w);
      // w . V: each query head's rescale (rare) and weight from its lane
      if (__any_sync(0xffffffffu, a != 1.0f)) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float ag = __shfl_sync(0xffffffffu, a, lead + owner<GM>(g));
#pragma unroll
          for (int j = 0; j < 8; ++j) o[g][j] = __fmul_rn(o[g][j], ag);
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float wg = __shfl_sync(0xffffffffu, w, lead + owner<GM>(g));
#pragma unroll
        for (int j = 0; j < 8; ++j) o[g][j] = fmaf(wg, vf[j], o[g][j]);
      }
    }
  }
  // the lane groups of a warp share n_run: their sums add as they are
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    m_run = __fadd_rn(m_run, __shfl_xor_sync(0xffffffffu, m_run, off));
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[g][j] = __fadd_rn(o[g][j],
                            __shfl_xor_sync(0xffffffffu, o[g][j], off));
  }
  if (grp == 0) {
    if (vcol) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j) o_s[warp][g][col + j] = o[g][j];
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (gl == owner<GM>(g)) {
        m_s[warp][g] = m_run;
        n_s[warp][g] = n_run;
      }
  }
  __syncthreads();
  // the warps' partials, folded in warp order with exact rescales
  for (int idx = tid; idx < gn * (c.dv + 1); idx += kThreads) {
    const int g = idx / (c.dv + 1), dd = idx % (c.dv + 1);
    float nt = n_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) nt = fmaxf(nt, n_s[w][g]);
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc = __fadd_rn(acc, __fmul_rn(dd < c.dv ? o_s[w][g][dd] : m_s[w][g],
                                     repro::exp2_int(
                                         __fsub_rn(n_s[w][g], nt))));
    float* p = part_row(c, s, h, g0 + g);
    p[dd] = acc;                         // o_loc, then m_loc at Dv
    if (dd == c.dv) p[c.dv + 1] = nt;
  }
}

// ---------------------------------------------------------------------------
// Kernels.
// ---------------------------------------------------------------------------
template <typename QT, typename KT, typename Src>
__global__ void __launch_bounds__(kThreads)
    decode_tile(Common c, Src src) {
  int s, h, g0, gn, base;
  if (!tile_coords(c, s, h, g0, gn, base)) return;
  src.s = s;
  src.h = h;
  tile_general<QT, KT>(c, src, s, h, g0, gn, base);
}

template <int GM, int LPR, typename Src>
__global__ void __launch_bounds__(kThreads)
    decode_tile_bf16(Common c, Src src) {
  int s, h, g0, gn, base;
  if (!tile_coords(c, s, h, g0, gn, base)) return;
  src.s = s;
  src.h = h;
  tile_bf16<GM, LPR>(c, src, s, h, g0, gn, base);
}

// Fold the live tiles of one (slot, KV head, query head) in tile order --
// the former per-slot loop's arithmetic, operation by operation -- and
// normalise.  A free slot (length 0) has m = 0: the max() guard gives
// exact zeros, never NaN.
template <typename QT>
__global__ void __launch_bounds__(kThreads) decode_combine(Common c) {
  const int s = blockIdx.x / c.hkv, h = blockIdx.x % c.hkv, gq = blockIdx.y;
  const int len = c.lengths[s];
  const int j0 = first_tile_base(c, len) / c.tile;
  const int j1 = (len + c.tile - 1) / c.tile;
  const int64_t row = static_cast<int64_t>(s * c.hkv + h) * c.g + gq;
  const float* part = c.part + row * c.n_split * (c.dv + 2);
  QT* o = static_cast<QT*>(c.o) + row * c.dv;
  for (int dd = threadIdx.x; dd < c.dv; dd += kThreads) {
    // kAhead tiles' partials in flight while the previous kAhead fold
    float ol[kAhead], ml[kAhead], nl[kAhead];
    auto fetch = [&](int j, float* o_, float* m_, float* n_) {
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (j + k >= j1) break;
        const float* p = part + static_cast<int64_t>(j + k) * (c.dv + 2);
        o_[k] = p[dd];
        m_[k] = p[c.dv];
        n_[k] = p[c.dv + 1];
      }
    };
    fetch(j0, ol, ml, nl);
    float o_acc = 0.0f, m_acc = 0.0f, n_acc = repro::kMinusInfN;
    for (int j = j0; j < j1; j += kAhead) {
      float ol2[kAhead] = {}, ml2[kAhead] = {}, nl2[kAhead] = {};
      if (j + kAhead < j1) fetch(j + kAhead, ol2, ml2, nl2);
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (j + k >= j1) break;
        const float nn = fmaxf(n_acc, nl[k]);
        const float a_acc = repro::exp2_int(__fsub_rn(n_acc, nn));
        const float a_loc = repro::exp2_int(__fsub_rn(nl[k], nn));
        o_acc = __fadd_rn(__fmul_rn(o_acc, a_acc), __fmul_rn(ol[k], a_loc));
        m_acc = __fadd_rn(__fmul_rn(m_acc, a_acc), __fmul_rn(ml[k], a_loc));
        n_acc = nn;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        ol[k] = ol2[k];
        ml[k] = ml2[k];
        nl[k] = nl2[k];
      }
    }
    store(o + dd, __fdiv_rn(o_acc, fmaxf(m_acc, 1e-37f)));
  }
}

// The bf16 body: GM the smallest of 1, 2, 4, 5, 8 that holds the block's
// query heads, LPR its lanes a row.
template <int GM, typename Src>
void launch_bf16_gm(const Common& c, dim3 grid, cudaStream_t st,
                    const Src& src) {
  if (c.lpr == 8)
    decode_tile_bf16<GM, 8, Src><<<grid, kThreads, 0, st>>>(c, src);
  else if (c.lpr == 16)
    decode_tile_bf16<GM, 16, Src><<<grid, kThreads, 0, st>>>(c, src);
  else
    decode_tile_bf16<GM, 32, Src><<<grid, kThreads, 0, st>>>(c, src);
}

template <typename Src>
void launch_bf16(const Common& c, dim3 grid, cudaStream_t st,
                 const Src& src) {
  if (c.gm <= 1) return launch_bf16_gm<1>(c, grid, st, src);
  if (c.gm <= 2) return launch_bf16_gm<2>(c, grid, st, src);
  if (c.gm <= 4) return launch_bf16_gm<4>(c, grid, st, src);
  if (c.gm <= 5) return launch_bf16_gm<5>(c, grid, st, src);
  launch_bf16_gm<8>(c, grid, st, src);
}

// The bf16 body spreads the query heads evenly over ceil(G / 8) blocks
// (G 10: two of 5), so its registers hold no idle head.
template <typename QT, typename KT, typename Src>
int launch(Common c, int slots, int body, cudaStream_t st, const Src& src) {
  const int groups = (c.g + kMaxG - 1) / kMaxG;
  c.gm = body == 1 ? (c.g + groups - 1) / groups : kMaxG;
  // the bf16 body's lanes a row: 8 columns each, at least 8 lanes so that
  // each of up to 8 query heads has a lane of its own
  c.lpr = 8;
  while (c.lpr * 8 < max(c.d, c.dv)) c.lpr <<= 1;
  dim3 grid(slots * c.hkv, c.n_split, (c.g + c.gm - 1) / c.gm);
  if constexpr (std::is_same_v<KT, __nv_bfloat16> && !Src::kQuant) {
    if (body == 1)
      launch_bf16(c, grid, st, src);
    else
      decode_tile<QT, KT, Src><<<grid, kThreads, 0, st>>>(c, src);
  } else {
    decode_tile<QT, KT, Src><<<grid, kThreads, 0, st>>>(c, src);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine<QT><<<dim3(slots * c.hkv, c.g), kThreads, 0, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(const Common& c) {
  return c.d > 0 && c.d <= kMaxD && c.dv > 0 && c.dv <= 2 * kThreads &&
         c.tile > 0 && c.tile <= kMaxTile && c.g > 0 && c.n_split > 0 &&
         c.n_split <= 65535 && c.part != nullptr;
}

// The bf16 body's conditions (its dtypes are checked by the caller): D and
// Dv multiples of 8 and every K / V row 16-byte aligned.
bool bf16_rows_ok(const Common& c, const void* k, const void* v,
                  const int64_t* strides, int n) {
  if (c.d % 8 != 0 || c.dv % 8 != 0) return false;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// k/v strides in elements for the (slot, head, position) axes.  part: the
// float32 scratch [S, Hkv, G, n_split, Dv + 2]; body 1 = tile_bf16 (bf16
// only), 0 = tile_general.
int decode_attention_contig(const void* q, const void* k, const void* v,
                            const int* lengths, void* o, void* part,
                            int slots, int hkv, int g, int d, int dv,
                            int tile, int n_split, int window, float scale,
                            int q_dtype, int kv_dtype, int body,
                            int64_t ks_s, int64_t ks_h, int64_t ks_t,
                            int64_t vs_s, int64_t vs_h, int64_t vs_t,
                            void* stream) {
  Common c{q, o, lengths, static_cast<float*>(part), hkv, g, d, dv, tile,
           window, n_split, 0, 0, scale};
  if (!shape_ok(c)) return kBad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t strides[6] = {ks_s, ks_h, ks_t, vs_s, vs_h, vs_t};
  if (q_dtype == 1 && kv_dtype == 1) {
    if (body == 1 && !bf16_rows_ok(c, k, v, strides, 6)) return kBad;
    using T = __nv_bfloat16;
    StripSrc<T> src{static_cast<const T*>(k), static_cast<const T*>(v),
                    ks_s, ks_h, ks_t, vs_s, vs_h, vs_t, 0, 0};
    return launch<T, T>(c, slots, body, st, src);
  }
  if (q_dtype == 0 && kv_dtype == 0 && body == 0) {
    StripSrc<float> src{static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        ks_s, ks_h, ks_t, vs_s, vs_h, vs_t, 0, 0};
    return launch<float, float>(c, slots, body, st, src);
  }
  return kBad;
}

// Strides in elements: k (page, pos, head), v (page, pos, head), scales
// (page, pos, head; head = 0 for per-position scales, all 0 without).
int decode_attention_paged(const void* q, const void* k_pages,
                           const void* v_pages, const int* table,
                           const int* lengths, const float* k_scale,
                           const float* v_scale, void* o, void* part,
                           int slots, int hkv, int g, int d, int dv,
                           int pmax, int ps, int tile, int n_split,
                           int window, float scale, int q_dtype,
                           int kv_dtype, int body, int64_t ks_p,
                           int64_t ks_t, int64_t ks_h, int64_t vs_p,
                           int64_t vs_t, int64_t vs_h, int64_t sc_p,
                           int64_t sc_t, int64_t sc_h, void* stream) {
  const int64_t str[9] = {ks_p, ks_t, ks_h, vs_p, vs_t,
                          vs_h, sc_p, sc_t, sc_h};
  Common c{q, o, lengths, static_cast<float*>(part), hkv, g, d, dv, tile,
           window, n_split, 0, 0, scale};
  if (!shape_ok(c) || ps <= 0) return kBad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (kv_dtype == 2 && !quant) return kBad;
  if (body == 1 && (q_dtype != 1 || kv_dtype != 1 || quant ||
                    !bf16_rows_ok(c, k_pages, v_pages, str, 6)))
    return kBad;
  if (q_dtype == 1 && kv_dtype == 1) {
    using T = __nv_bfloat16;
    PagedSrc<T, false> src{static_cast<const T*>(k_pages),
                           static_cast<const T*>(v_pages), table, k_scale,
                           v_scale, str[0], str[1], str[2], str[3], str[4],
                           str[5], str[6], str[7], str[8], pmax, ps, 0, 0};
    return launch<T, T>(c, slots, body, st, src);
  }
  if (q_dtype == 0 && kv_dtype == 0) {
    PagedSrc<float, false> src{static_cast<const float*>(k_pages),
                               static_cast<const float*>(v_pages), table,
                               k_scale, v_scale, str[0], str[1], str[2],
                               str[3], str[4], str[5], str[6], str[7],
                               str[8], pmax, ps, 0, 0};
    return launch<float, float>(c, slots, body, st, src);
  }
  if (kv_dtype == 2) {
    PagedSrc<int8_t, true> src{static_cast<const int8_t*>(k_pages),
                               static_cast<const int8_t*>(v_pages), table,
                               k_scale, v_scale, str[0], str[1], str[2],
                               str[3], str[4], str[5], str[6], str[7],
                               str[8], pmax, ps, 0, 0};
    if (q_dtype == 1) return launch<__nv_bfloat16, int8_t>(c, slots, body,
                                                          st, src);
    if (q_dtype == 0) return launch<float, int8_t>(c, slots, body, st, src);
  }
  return kBad;
}

}  // extern "C"
