// Row folds in one fixed order, shared by the row-wise kernels (two-pass
// and three-pass softmax, cross-entropy), for one thread block per row.
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
// Each fold ends with __syncthreads() and writes its own __shared__ slots,
// so two different folds may follow each other in one kernel; the same
// fold twice needs a __syncthreads() between the calls.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// (m, n) butterfly over a warp; every lane gets the same bits, because
// ext_add is commutative bit for bit.
__device__ __forceinline__ void warp_fold(float& m, float& n) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float n2 = __shfl_xor_sync(0xffffffffu, n, off);
    repro::ext_add(m, n, m2, n2);
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
    float m = 0.0f, n = repro::kMinusInfN;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = j * kChunk + e * kLanes + lane;
      if (c < cols) {
        float me, ne;
        repro::ext_exp(to_f32(row[c]), me, ne);
        repro::ext_add(m, n, me, ne);
      }
    }
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

// Sum over the row of term(c), c in [0, cols), for every thread, in the
// fixed order above (rounded adds, never contracted).  term is called
// once for each column, by the lane that adds it.
template <typename F>
__device__ __forceinline__ float row_sum(int cols, F term) {
  __shared__ float ss[kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int slot = warp + lane * nwarps;
  float acc = 0.0f;
  const int chunks = (cols + kChunk - 1) / kChunk;
  for (int j = warp; j < chunks; j += nwarps) {
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = j * kChunk + e * kLanes + lane;
      if (c < cols) s = __fadd_rn(s, term(c));
    }
    s = warp_sum(s);
    if (slot == (j & (kLanes - 1))) acc = __fadd_rn(acc, s);
  }
  if (slot < kLanes) ss[slot] = acc;
  __syncthreads();
  return warp_sum(ss[lane]);
}

// Row max, for every thread.  A max does not depend on its order; -inf
// columns leave it as it is, and an all -inf row gives -inf.
template <typename T>
__device__ __forceinline__ float row_max(const T* row, int cols) {
  __shared__ float sx[kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    mx = fmaxf(mx, to_f32(row[c]));
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) sx[warp] = mx;
  __syncthreads();
  mx = lane < (blockDim.x >> 5) ? sx[lane] : -INFINITY;
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  return mx;
}

}  // namespace repro
