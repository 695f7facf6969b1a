// Row folds in one fixed order, shared by the row-wise kernels (two-pass
// and three-pass softmax, their stats, cross-entropy).  The order is
// defined below for one thread block per row (row_stats, which
// xent_fwd_2d still runs); the softmax kernels take it apart into the two
// layouts at the end of this comment and keep its bits.
//
// Every fold here visits a row [0, cols) the same way:
//   * chunk j is columns [256 j, 256 j + 256); lane l of the warp that
//     takes it folds columns 256 j + l + 32 e, e = 0..7, in order (loads
//     coalesced), and a butterfly gives the chunk's value;
//   * slot j % 32 folds chunks j, j + 32, j + 64, ... in order;
//   * a butterfly over the 32 slots gives the row's value.
// Warp w takes chunks w, w + W, ... (W warps, a power of two <= 32), so
// every chunk of slot s falls to warp s % W, in increasing order, and lane
// s / W of that warp holds the slot.  The order of every sum therefore
// depends on neither the threads per row nor trailing -inf columns, which
// add an exact identity: (m = 0, n = -1e38) to an (m, n) fold, +0 to a
// float sum.
//
// row_stats ends with __syncthreads() and writes its own __shared__ slots.
//
// The same order, taken apart for the two layouts of the row-wise
// softmax and stats kernels (twopass_softmax.cu, threepass_softmax.cu):
//   * registers (rows of at most kRegsMaxCols = 32 chunks: one chunk a
//     slot): a warp loads K chunks at once and keeps them; butterfly_scatter
//     folds the K chunks over the warp in the butterfly's own pairs, and the
//     slot butterfly either continues in the warp (slots_in_warp, when one
//     warp holds the row) or runs over __shared__ slots;
//   * split (longer rows): one warp a (row, slot) folds the slot's chunks
//     in order (slot_fold) and writes the slot's value; a later launch runs
//     the slot butterfly from those 32 values.
// Both give the bits of row_stats, and of the one-block float sum in the
// same order (a -inf or missing column adds the exact identity, and so does
// an empty slot).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "extexp.cuh"

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kLanes = 32;
constexpr int kPerLane = 8;                  // columns per lane per chunk
constexpr int kChunk = kLanes * kPerLane;

constexpr int kRegsMaxCols = kLanes * kChunk;  // 32 chunks, one a slot

// (m, n) butterfly over a warp; every lane gets the same bits, because
// ext_add is commutative bit for bit.
__device__ __forceinline__ void warp_fold(float& m, float& n) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float n2 = __shfl_xor_sync(0xffffffffu, n, off);
    repro::ext_add(m, n, m2, n2);
  }
}

// One lane's (m, n) fold of its kPerLane columns of a chunk, max-first as
// the TPU kernel folds a tile (src/repro/kernels/twopass_softmax.py,
// _pass1_kernel): n is the largest n_e, taken in column order, and m =
// sum_e m_e 2^(n_e - n) in column order.  These are the bits of ext_add
// over the columns in order from the identity: every rescale of that fold
// is by a power of two, exact in the normal range, so it repeats each
// rounded addition at one scale; a term that the scales push below the
// normal range is under half an ulp of a sum that holds some m_e >= 0.7 at
// scale 0, in either fold.  A -inf column, ExtExp's (0, -1e38), adds +0.
__device__ __forceinline__ void lane_fold(const float (&m)[kPerLane],
                                          const float (&n)[kPerLane],
                                          float& ms, float& ns) {
  ns = n[0];
#pragma unroll
  for (int e = 1; e < kPerLane; ++e) ns = fmaxf(ns, n[e]);
  ms = 0.0f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e)
    ms = __fadd_rn(ms,
                   __fmul_rn(m[e], exp2_int_nonpos(__fsub_rn(n[e], ns))));
}

// The values the folds run on: an (m, n) pair, or a float sum.
struct Ext {
  float m, n;
};

__device__ __forceinline__ Ext ext_identity() { return {0.0f, kMinusInfN}; }
__device__ __forceinline__ Ext combine(Ext a, Ext b) {
  ext_add(a.m, a.n, b.m, b.n);
  return a;
}
__device__ __forceinline__ float combine(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ Ext shfl_xor(Ext v, int off) {
  return {__shfl_xor_sync(0xffffffffu, v.m, off),
          __shfl_xor_sync(0xffffffffu, v.n, off)};
}
__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ Ext shfl(Ext v, int src) {
  return {__shfl_sync(0xffffffffu, v.m, src),
          __shfl_sync(0xffffffffu, v.n, src)};
}
__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

// The butterfly of warp_fold / warp_sum on K values at once (K a power of
// two, at most 32): each value is folded over the warp in the same pairs
// and the same order as alone, so it gets the same bits.  The first log2 K
// rounds reduce-scatter: at the round of offset o a lane keeps the half of
// its values whose index bit matches its own bit o, and adds its partner's
// copy of that half, so each of those rounds costs half the one before.
// Afterwards lane l holds value l / (32 / K), whole; the 32 / K lanes of a
// value hold the same bits.
__host__ __device__ constexpr int log2_of(int k) {
  return k > 1 ? 1 + log2_of(k / 2) : 0;
}

template <int K, typename V>
__device__ __forceinline__ V butterfly_scatter(V (&v)[K]) {
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0, "K: 2^q <= 32");
  constexpr int kQ = log2_of(K);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kQ; ++r) {
    const int h = K >> (r + 1), off = 16 >> r;
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const V keep = upper ? v[i + h] : v[i];
      const V send = upper ? v[i] : v[i + h];
      v[i] = combine(keep, shfl_xor(send, off));
    }
  }
  V x = v[0];
#pragma unroll
  for (int off = 16 >> kQ; off > 0; off >>= 1)
    x = combine(x, shfl_xor(x, off));
  return x;
}

// The 32-slot butterfly of a row whose K chunks (slots 0 .. K-1) one warp
// folded with butterfly_scatter.  The other slots hold the identity, so
// the butterfly's rounds of offset >= K leave slots < K as they are; its
// round of offset 2^b pairs the chunks that differ in index bit b, which
// butterfly_scatter put in lane bit 5 - log2 K + b.
template <int K, typename V>
__device__ __forceinline__ V slots_in_warp(V x) {
#pragma unroll
  for (int off = 16; off >= 32 / K; off >>= 1)
    x = combine(x, shfl_xor(x, off));
  return x;
}

// Slot `slot` of a row of `cols` columns: acc folded with the slot's chunks
// slot, slot + 32, ... in order, for one warp.  The chunks come kBatch at a
// time: each lane loads its columns of the batch at once (a missing column
// as -inf), lane_value(x, j) gives the lane's value of chunk j from its
// columns x of it (256 j + 32 e + lane), and butterfly_scatter the batch's
// chunk values.  Every lane returns the slot.
constexpr int kBatch = 4;

template <typename V, typename T, typename F>
__device__ __forceinline__ V slot_fold(const T* row, int cols, int slot,
                                       V acc, F lane_value) {
  const int lane = threadIdx.x & 31;
  const int chunks = (cols + kChunk - 1) / kChunk;
  for (int j0 = slot; j0 < chunks; j0 += kLanes * kBatch) {
    float x[kBatch][kPerLane];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const long c = static_cast<long>(j0 + kLanes * b) * kChunk
                       + e * kLanes + lane;
        x[b][e] = c < cols ? to_f32(row[c]) : -INFINITY;
      }
    V v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) v[b] = lane_value(x[b], j0 + kLanes * b);
    const V w = butterfly_scatter<kBatch>(v);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      acc = combine(acc, shfl(w, b * (kLanes / kBatch)));
  }
  return acc;
}

// The register layout's launch for `rows` rows of `cols` <= kRegsMaxCols
// columns: K chunks a warp (1, 2 or 4), W warps a row (blockDim.x = 32 W)
// and rows a block (blockDim.y: four when one warp holds a row, so that no
// barrier is needed).  launch(std::integral_constant<int, K>, grid, block)
// launches the kernel for K.
template <typename Launch>
void launch_regs(int rows, int cols, Launch launch) {
  const int chunks = cols > 0 ? (cols + kChunk - 1) / kChunk : 1;
  const int k = chunks <= 1 ? 1 : chunks <= 2 ? 2 : 4;
  const int warps = (chunks + k - 1) / k, per_block = warps == 1 ? 4 : 1;
  const dim3 block(kLanes * warps, per_block);
  const unsigned grid = (rows + per_block - 1) / per_block;
  if (k == 1) launch(std::integral_constant<int, 1>{}, grid, block);
  else if (k == 2) launch(std::integral_constant<int, 2>{}, grid, block);
  else launch(std::integral_constant<int, 4>{}, grid, block);
}

// The split layout's last launch writes y over kScaleCols columns a block
// of kScaleThreads: scale_cols stores f(x) for those columns of one row,
// every load issued before the first store, so yrow may be row itself.
constexpr int kScaleThreads = 256;
constexpr int kScaleCols = kScaleThreads * 16;

template <typename Tx, typename Ty, typename F>
__device__ __forceinline__ void scale_cols(const Tx* row, Ty* yrow, int cols,
                                           int base, F f) {
  constexpr int kE = kScaleCols / kScaleThreads;
  float v[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int c = base + e * kScaleThreads + threadIdx.x;
    v[e] = c < cols ? to_f32(row[c]) : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int c = base + e * kScaleThreads + threadIdx.x;
    if (c < cols) store(yrow + c, f(v[e]));
  }
}

// Pass 1 of the two-pass softmax: (m_sum, n_sum) of the row, for every
// thread, in the fixed order above.
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int cols,
                                          float& m_sum, float& n_sum) {
  __shared__ float sm[kLanes], sn[kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int slot = warp + lane * nwarps;       // this lane's slot, if < 32
  float ms = 0.0f, ns = repro::kMinusInfN;
  const int chunks = (cols + kChunk - 1) / kChunk;
  for (int j = warp; j < chunks; j += nwarps) {
    float me[kPerLane], ne[kPerLane], m, n;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = j * kChunk + e * kLanes + lane;
      repro::ext_exp(c < cols ? to_f32(row[c]) : -INFINITY, me[e], ne[e]);
    }
    lane_fold(me, ne, m, n);
    warp_fold(m, n);
    if (slot == (j & (kLanes - 1))) repro::ext_add(ms, ns, m, n);
  }
  if (slot < kLanes) { sm[slot] = ms; sn[slot] = ns; }
  __syncthreads();
  m_sum = sm[lane];
  n_sum = sn[lane];
  warp_fold(m_sum, n_sum);
}

// Float sum butterfly over a warp; every lane gets the same bits (a + b ==
// b + a in IEEE arithmetic).
__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

}  // namespace repro
