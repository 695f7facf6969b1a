// The Two-Pass softmax (paper Alg 3) for Hopper, rowwise over x[R, C].
//
// Replaces the TPU kernels src/repro/kernels/twopass_softmax.py
// (twopass_softmax_2d: _pass1_kernel + _pass2_kernel; twopass_stats_2d:
// _pass1_kernel alone).
//
// Bound on this card: bytes, once the arithmetic is cut to what the TPU
// kernel does.  ExtExp is ~24 float instructions an element and issues at
// the unfused rate (33.5e12 a second on an H100 at 700 W: no add or
// multiply fuses, so that the bits equal PyTorch's, see extexp.cuh).  A
// fold of every element by ext_add (~16 more) and a second ExtExp in pass
// 2 made the kernel issue-bound; the design keeps ~40 an element:
//   * pass 1 folds a lane's 8 columns of a chunk max-first (lane_fold in
//     rowfold.cuh, as the TPU kernel folds a tile), with the same bits as
//     the element-wise ext_add fold; only chunk and slot values go through
//     ext_add;
//   * exp2_int writes the exponent field through a float add, with no
//     float-to-int conversion.
// Two layouts, one fold order (rowfold.cuh), so a row padded with -inf
// columns across the boundary between them keeps its bits:
//   * registers, rows of at most 8192 columns (every prefill score
//     bucket): each lane loads its columns once in the fold's layout (4-byte
//     loads, coalesced), keeps ExtExp's (m, n) of each, and pass 2 writes
//     y = m * (1 / m_sum) * 2^(n - n_sum) from them: one read and one write
//     of the row (2N), no second ExtExp.  One warp a row up to 1024
//     columns, four rows a block, no barrier and no shared memory; longer
//     rows take one warp per 4 chunks and meet in 32 __shared__ slots.
//   * split, longer rows (the sampler's vocabulary, the paper's long
//     rows): launch A takes one warp per (row, fold slot) and writes the
//     slot's (m, n) to a float32 scratch [rows, 32, 2]; launch B runs the
//     slot butterfly from those 32 pairs in every block and writes y over
//     4096-column ranges, many blocks a row: the paper's 3N, over
//     rows x 32 warps and rows x cols / 4096 blocks instead of `rows` blocks.
// The stats kernel (pass 1 alone) takes the same two layouts and writes
// (m_sum, n_sum): registers, pass 1 of the register kernel (regs_pass1)
// with no pass 2, so it keeps no (m, n) of its columns; split, launch A,
// then one warp a row folds the 32 slot pairs (stats_fold_kernel).
//
// An all -inf row gives m_sum = 0, so y = 0 * inf = NaN, as in the TPU
// kernel and the plain version.  No row on the serving path is all -inf:
// key 0 is always visible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "extexp.cuh"
#include "rowfold.cuh"

namespace {

using repro::Ext;
using repro::kChunk;
using repro::kLanes;
using repro::kPerLane;
using repro::kScaleCols;
using repro::kScaleThreads;
using repro::store;
using repro::to_f32;

// Pass 1 in the register layout, rows of at most 32 chunks, K chunks a
// warp, blockDim = (32 W, rows a block): loads the warp's columns of row
// as ExtExp's (m, n) and returns the row's (m_sum, n_sum) in every lane.
// The caller returns the warps of rows >= rows first (whole warps, W = 1);
// W > 1 holds one row a block, so the __syncthreads() is reached by all.
template <typename T, int K>
__device__ __forceinline__ Ext regs_pass1(const T* row, int cols,
                                          float (&m)[K][kPerLane],
                                          float (&n)[K][kPerLane]) {
  constexpr int kSpan = kLanes / K;               // lanes a chunk after
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = (warp * K + k) * kChunk + e * kLanes + lane;
      m[k][e] = c < cols ? to_f32(row[c]) : -INFINITY;
    }
  Ext v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      repro::ext_exp(m[k][e], m[k][e], n[k][e]);
    repro::lane_fold(m[k], n[k], v[k].m, v[k].n);
  }
  Ext s = repro::butterfly_scatter<K>(v);
  if (nwarps == 1) {
    s = repro::slots_in_warp<K>(s);
  } else {                                        // one row a block
    __shared__ Ext slots[kLanes];
    if (lane % kSpan == 0) slots[warp * K + lane / kSpan] = s;
    __syncthreads();
    s = lane < nwarps * K ? slots[lane] : repro::ext_identity();
    repro::warp_fold(s.m, s.n);
  }
  return s;
}

// Rows of at most 32 chunks: pass 1 and pass 2 from registers.
template <typename T, int K>
__global__ void __launch_bounds__(256)
    twopass_regs_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                        int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= static_cast<size_t>(rows)) return;     // whole warps (W = 1)
  float m[K][kPerLane], n[K][kPerLane];
  const Ext s = regs_pass1<T, K>(x + r * cols, cols, m, n);
  const float lam = __frcp_rn(s.m);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = (warp * K + k) * kChunk + e * kLanes + lane;
      if (c < cols)
        store(y + r * cols + c,
              __fmul_rn(__fmul_rn(m[k][e], lam),
                        repro::exp2_int_nonpos(__fsub_rn(n[k][e], s.n))));
    }
}

// Launch A of the split path: warp (row, slot) writes the slot's (m, n).
template <typename T>
__global__ void __launch_bounds__(128)
    twopass_slots_kernel(const T* __restrict__ x, float* __restrict__ slots,
                         int rows, int cols) {
  const size_t g = (static_cast<size_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x) >> 5;
  const size_t r = g / kLanes;
  const int slot = static_cast<int>(g % kLanes);
  if (r >= static_cast<size_t>(rows)) return;
  const Ext acc = repro::slot_fold(
      x + r * cols, cols, slot, repro::ext_identity(),
      [](const float (&xs)[kPerLane], int) {
        float m[kPerLane], n[kPerLane];
        Ext v;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) repro::ext_exp(xs[e], m[e], n[e]);
        repro::lane_fold(m, n, v.m, v.n);
        return v;
      });
  if ((threadIdx.x & 31) == 0) {
    slots[g * 2] = acc.m;
    slots[g * 2 + 1] = acc.n;
  }
}

// Launch B of the split path: (m_sum, n_sum) from the row's 32 slots, then
// y over kScaleCols columns.
template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
    twopass_scale_kernel(const T* __restrict__ x,
                         const float* __restrict__ slots, T* __restrict__ y,
                         int cols, int blocks_per_row) {
  const size_t r = blockIdx.x / blocks_per_row;
  const int base = (blockIdx.x % blocks_per_row) * kScaleCols;
  const int lane = threadIdx.x & 31;
  float m_sum = slots[(r * kLanes + lane) * 2];
  float n_sum = slots[(r * kLanes + lane) * 2 + 1];
  repro::warp_fold(m_sum, n_sum);
  const float lam = __frcp_rn(m_sum);
  repro::scale_cols(x + r * cols, y + r * cols, cols, base, [&](float v) {
    float me, ne;
    repro::ext_exp(v, me, ne);
    return __fmul_rn(__fmul_rn(me, lam),
                     repro::exp2_int_nonpos(__fsub_rn(ne, n_sum)));
  });
}

// The stats in the register layout: pass 1 alone.
template <typename T, int K>
__global__ void __launch_bounds__(256)
    stats_regs_kernel(const T* __restrict__ x, float* __restrict__ m_out,
                      float* __restrict__ n_out, int rows, int cols) {
  const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= static_cast<size_t>(rows)) return;     // whole warps (W = 1)
  float m[K][kPerLane], n[K][kPerLane];
  const Ext s = regs_pass1<T, K>(x + r * cols, cols, m, n);
  if (threadIdx.x == 0) { m_out[r] = s.m; n_out[r] = s.n; }
}

// The stats in the split layout, after launch A: one warp a row folds its
// 32 slot pairs as twopass_scale_kernel does.
__global__ void __launch_bounds__(128)
    stats_fold_kernel(const float* __restrict__ slots,
                      float* __restrict__ m_out, float* __restrict__ n_out,
                      int rows) {
  const size_t r = (static_cast<size_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= static_cast<size_t>(rows)) return;
  float m_sum = slots[(r * kLanes + lane) * 2];
  float n_sum = slots[(r * kLanes + lane) * 2 + 1];
  repro::warp_fold(m_sum, n_sum);
  if (lane == 0) { m_out[r] = m_sum; n_out[r] = n_sum; }
}

template <typename T>
void launch_slots(const T* x, float* slots, int rows, int cols,
                  cudaStream_t s) {
  const unsigned warps_a = static_cast<unsigned>(rows) * kLanes;
  twopass_slots_kernel<T><<<(warps_a + 3) / 4, 128, 0, s>>>(x, slots, rows,
                                                             cols);
}

template <typename T>
void launch_split(const T* x, T* y, float* slots, int rows, int cols,
                  cudaStream_t s) {
  launch_slots<T>(x, slots, rows, cols, s);
  const int bpr = (cols + kScaleCols - 1) / kScaleCols;
  twopass_scale_kernel<T><<<static_cast<unsigned>(rows) * bpr, kScaleThreads,
                            0, s>>>(x, slots, y, cols, bpr);
}

template <typename T>
int softmax(const void* x, void* y, void* slots, int rows, int cols,
            cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (slots == nullptr) {
    if (cols > repro::kRegsMaxCols)
      return static_cast<int>(cudaErrorInvalidValue);
    repro::launch_regs(rows, cols, [&](auto k, unsigned grid, dim3 block) {
      twopass_regs_kernel<T, decltype(k)::value>
          <<<grid, block, 0, s>>>(xt, yt, rows, cols);
    });
  } else {
    launch_split<T>(xt, yt, static_cast<float*>(slots), rows, cols, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stats(const void* x, float* m, float* n, void* slots, int rows, int cols,
          cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (slots == nullptr) {
    if (cols > repro::kRegsMaxCols)
      return static_cast<int>(cudaErrorInvalidValue);
    repro::launch_regs(rows, cols, [&](auto k, unsigned grid, dim3 block) {
      stats_regs_kernel<T, decltype(k)::value>
          <<<grid, block, 0, s>>>(xt, m, n, rows, cols);
    });
  } else {
    launch_slots<T>(xt, static_cast<float*>(slots), rows, cols, s);
    stats_fold_kernel<<<(static_cast<unsigned>(rows) + 3) / 4, 128, 0, s>>>(
        static_cast<const float*>(slots), m, n, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 = float32, 1 = bfloat16.  x and y are contiguous [rows, cols].
// slots: null for the register path (cols <= 8192); else the split path's
// float32 scratch [rows, 32, 2].
int twopass_softmax_2d(const void* x, void* y, void* slots, int rows,
                       int cols, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? softmax<float>(x, y, slots, rows, cols, s)
                    : softmax<__nv_bfloat16>(x, y, slots, rows, cols, s);
}

// m_sum, n_sum: float32 [rows]; slots as for twopass_softmax_2d.
int twopass_stats_2d(const void* x, void* m_sum, void* n_sum, void* slots,
                     int rows, int cols, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(m_sum);
  float* n = static_cast<float*>(n_sum);
  return dtype == 0
             ? stats<float>(x, m, n, slots, rows, cols, s)
             : stats<__nv_bfloat16>(x, m, n, slots, rows, cols, s);
}

}  // extern "C"
