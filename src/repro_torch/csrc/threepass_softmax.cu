// The paper's three-pass softmax baselines (Alg 1 and Alg 2) for Hopper,
// rowwise over x[R, C].
//
// Replaces the TPU kernels src/repro/kernels/threepass_softmax.py
// (threepass_recompute_2d: _max_kernel + _sumexp_kernel +
// _recompute_scale_kernel; threepass_reload_2d: _max_kernel +
// _exp_store_kernel + _inplace_scale_kernel).
//
// These exist to be compared with the two-pass kernel
// (twopass_softmax.cu): the same ExtExp arithmetic and the same fixed
// fold order (rowfold.cuh), and they differ in their passes over memory:
// sigma is summed in the fixed fold order of rowfold.cuh (its float sum),
// so both algorithms give the bits of one block a row summing it, under
// both of the two-pass kernel's layouts:
//   * Alg 1 (recompute): mu = max x; sigma = sum e(x - mu); y = e(x - mu) *
//     (1 / sigma), the exponential computed again.
//       - registers (rows of at most 8192 columns): each lane loads its
//         columns once and keeps x; the max by butterfly, sigma in the
//         fold order, and pass 3 computes e(x - mu) again from the
//         registers.  What keeps this Alg 1 and not Alg 2 is that the
//         exponentials are never kept.  One read and one write (2N).
//       - split (longer rows): launch 1 writes each fold slot's max to a
//         float32 scratch [rows, 32, 2]; launch 2 reduces the 32 maxima to
//         mu and writes each slot's part of sigma; launch 3 runs the
//         32-part butterfly that ends the fold and writes y over
//         4096-column ranges.  3 reads + 1 write: 4N.
//   * Alg 2 (reload): mu = max x; e = e(x - mu) stored to a float32 buffer
//     while sigma sums it; y = e * (1 / sigma) with e read back from memory.
//     With float32 x the buffer is y itself and the last pass scales it in
//     place; with bfloat16 x it is a float32 scratch [rows, cols], and only
//     the final scale rounds to bfloat16.
//       - registers: x loaded once as Alg 1 loads it, e computed from the
//         registers, stored and summed; after __syncwarp, pass 3 reads e
//         back with another mapping than the one that stored it (16-byte
//         loads of 4 columns where cols % 4 == 0, else each lane the column
//         of its neighbour), so the loads cannot be served from registers.
//         x is read once (as Alg 1's register layout reads it), e written,
//         read and y written.
//       - split: Alg 1's max launch; launch 2 stores e of each slot's
//         chunks at their columns and writes the slot's part of sigma;
//         launch 3 reads e and writes y over 4096-column ranges, in place
//         for float32.  2 reads + 1 write, then 1 read + 1 write: 5N.
// e(t) is the paper's Alg 4, as the TPU kernel computes it: ExtExp's
// (m, n) rebuilt as m * 2^n with the exponent-field exp2_int, which
// flushes to 0 for n <= -127 (t below about -88) where expf would give
// denormals.
//
// Bound on this card: bytes, for Alg 1 once each element costs two ExtExp
// (~60 float instructions, at the unfused 33.5e12 a second) and no more;
// Alg 2 does 32.  Rows that fit in the 50 MB L2 with all the rows in
// flight are re-read from L2 (reload's e is re-read by the warp that just
// stored it), so 4N/5N only show for long rows.
//
// An all -inf row gives mu = -inf, x - mu = NaN, sigma = 0 and y = 0 * inf
// = NaN, as in the TPU kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "extexp.cuh"
#include "rowfold.cuh"

namespace {

using repro::store;
using repro::to_f32;

// Paper Alg 4 for t <= 0 (or NaN): m * 2^n from ExtExp, rebuilt exactly,
// op for op as ext_exp and exp2_int but for the steps that cannot change
// the result at such t: the upper clamps (t <= 0 and n <= 0) and the
// +-inf cases (t = +inf does not occur, t = x - mu; t = -inf gives n <=
// -127, which flushes to the +0 that ext_exp's (0, -1e38) gives).
__device__ __forceinline__ float exp_nonpos(float t) {
  const float xc = fmaxf(t, -repro::kXClamp);     // NaN -> -1e37, as there
  const float n = rintf(__fmul_rn(xc, repro::kLog2e));
  float r = __fsub_rn(xc, __fmul_rn(n, repro::kLn2Hi));
  r = __fsub_rn(r, __fmul_rn(n, repro::kLn2Lo));
  r = fminf(fmaxf(r, -repro::kTClamp), repro::kTClamp);
  float p = __fadd_rn(__fmul_rn(r, repro::kC5), repro::kC4);
  p = __fadd_rn(__fmul_rn(p, r), repro::kC3);
  p = __fadd_rn(__fmul_rn(p, r), repro::kC2);
  p = __fadd_rn(__fmul_rn(p, r), repro::kC1);
  const float m = __fadd_rn(__fmul_rn(p, r), 1.0f);
  return __fmul_rn(m, repro::exp2_int_nonpos(n));
}

using repro::kChunk;
using repro::kLanes;
using repro::kPerLane;
using repro::kScaleCols;
using repro::kScaleThreads;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One lane's part of sigma over its kPerLane columns of a chunk, in
// column order (a missing or -inf column adds +0).
__device__ __forceinline__ float lane_sum(const float (&x)[kPerLane],
                                          float mu) {
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e)
    s = __fadd_rn(s, exp_nonpos(__fsub_rn(x[e], mu)));
  return s;
}

// Alg 1 for rows of at most 32 chunks, K chunks a warp, blockDim = (32 W,
// rows a block): x in registers, read once.
template <typename T, int K>
__global__ void __launch_bounds__(256)
    recompute_regs_kernel(const T* __restrict__ x, T* __restrict__ y,
                          int rows, int cols) {
  constexpr int kSpan = kLanes / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= static_cast<size_t>(rows)) return;     // whole warps (W = 1)
  const T* row = x + r * cols;
  float v[K][kPerLane];
  float mu = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = (warp * K + k) * kChunk + e * kLanes + lane;
      v[k][e] = c < cols ? to_f32(row[c]) : -INFINITY;
      mu = fmaxf(mu, v[k][e]);
    }
  mu = warp_max(mu);                                           // pass 1
  __shared__ float smax[8], ssum[kLanes];       // W <= 8 warps a row
  if (nwarps > 1) {
    if (lane == 0) smax[warp] = mu;
    __syncthreads();
    mu = warp_max(lane < nwarps ? smax[lane] : -INFINITY);
  }
  float part[K];                                               // pass 2
#pragma unroll
  for (int k = 0; k < K; ++k) part[k] = lane_sum(v[k], mu);
  float sigma = repro::butterfly_scatter<K>(part);
  if (nwarps == 1) {
    sigma = repro::slots_in_warp<K>(sigma);
  } else {
    if (lane % kSpan == 0) ssum[warp * K + lane / kSpan] = sigma;
    __syncthreads();
    sigma = repro::warp_sum(lane < nwarps * K ? ssum[lane] : 0.0f);
  }
  const float inv = __frcp_rn(sigma);
  // Pass 3 computes e(x - mu) again: without this the compiler would keep
  // pass 2's exponentials in registers instead of x, which is Alg 2.
  asm volatile("" : "+f"(mu));
#pragma unroll
  for (int k = 0; k < K; ++k)                                  // pass 3
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = (warp * K + k) * kChunk + e * kLanes + lane;
      if (c < cols)
        store(y + r * cols + c,
              __fmul_rn(exp_nonpos(__fsub_rn(v[k][e], mu)), inv));
    }
}

// Launch 1 of the split path: warp (row, slot) writes the max of the
// slot's chunks to slots[row, slot, 0].
template <typename T>
__global__ void __launch_bounds__(128)
    recompute_max_kernel(const T* __restrict__ x, float* __restrict__ slots,
                         int rows, int cols) {
  const size_t g = (static_cast<size_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x) >> 5;
  const size_t r = g / kLanes;
  const int slot = static_cast<int>(g % kLanes), lane = threadIdx.x & 31;
  if (r >= static_cast<size_t>(rows)) return;
  const T* row = x + r * cols;
  float mx = -INFINITY;
  for (long c0 = static_cast<long>(slot) * kChunk; c0 < cols;
       c0 += static_cast<long>(kLanes) * kChunk * repro::kBatch) {
    float v[repro::kBatch][kPerLane];
#pragma unroll
    for (int b = 0; b < repro::kBatch; ++b)
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const long c = c0 + static_cast<long>(b) * kLanes * kChunk
                       + e * kLanes + lane;
        v[b][e] = c < cols ? to_f32(row[c]) : -INFINITY;
      }
#pragma unroll
    for (int b = 0; b < repro::kBatch; ++b)
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) mx = fmaxf(mx, v[b][e]);
  }
  mx = warp_max(mx);
  if (lane == 0) slots[g * 2] = mx;
}

// Launch 2: mu from the row's 32 maxima; warp (row, slot) writes the
// slot's part of sigma (the fold's slot sum) to slots[row, slot, 1].
template <typename T>
__global__ void __launch_bounds__(128)
    recompute_sum_kernel(const T* __restrict__ x, float* __restrict__ slots,
                         int rows, int cols) {
  const size_t g = (static_cast<size_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x) >> 5;
  const size_t r = g / kLanes;
  const int slot = static_cast<int>(g % kLanes), lane = threadIdx.x & 31;
  if (r >= static_cast<size_t>(rows)) return;
  const float mu = warp_max(slots[(r * kLanes + lane) * 2]);
  const float acc = repro::slot_fold(
      x + r * cols, cols, slot, 0.0f,
      [mu](const float (&xs)[kPerLane], int) { return lane_sum(xs, mu); });
  if (lane == 0) slots[g * 2 + 1] = acc;
}

// Launch 3: mu and sigma from the row's 32 slots, then y over kScaleCols
// columns.
template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
    recompute_scale_kernel(const T* __restrict__ x,
                           const float* __restrict__ slots,
                           T* __restrict__ y, int cols, int blocks_per_row) {
  const size_t r = blockIdx.x / blocks_per_row;
  const int base = (blockIdx.x % blocks_per_row) * kScaleCols;
  const int lane = threadIdx.x & 31;
  const float mu = warp_max(slots[(r * kLanes + lane) * 2]);
  const float inv =
      __frcp_rn(repro::warp_sum(slots[(r * kLanes + lane) * 2 + 1]));
  repro::scale_cols(x + r * cols, y + r * cols, cols, base, [&](float v) {
    return __fmul_rn(exp_nonpos(__fsub_rn(v, mu)), inv);
  });
}

template <typename T>
void launch_split(const T* x, T* y, float* slots, int rows, int cols,
                  cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(rows) * kLanes / 4;
  recompute_max_kernel<T><<<blocks, 128, 0, s>>>(x, slots, rows, cols);
  recompute_sum_kernel<T><<<blocks, 128, 0, s>>>(x, slots, rows, cols);
  const int bpr = (cols + kScaleCols - 1) / kScaleCols;
  recompute_scale_kernel<T><<<static_cast<unsigned>(rows) * bpr,
                              kScaleThreads, 0, s>>>(x, slots, y, cols, bpr);
}

template <typename T>
int recompute(const void* x, void* y, void* slots, int rows, int cols,
              cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (slots == nullptr) {
    if (cols > repro::kRegsMaxCols)
      return static_cast<int>(cudaErrorInvalidValue);
    repro::launch_regs(rows, cols, [&](auto k, unsigned grid, dim3 block) {
      recompute_regs_kernel<T, decltype(k)::value>
          <<<grid, block, 0, s>>>(xt, yt, rows, cols);
    });
  } else {
    launch_split<T>(xt, yt, static_cast<float*>(slots), rows, cols, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Four contiguous columns of y from float32 values, in one store (16
// bytes of float32, 8 of bfloat16; p aligned to that).
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a)))
         | static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
               << 16;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
}

// Alg 2 for rows of at most 32 chunks, K chunks a warp, blockDim = (32 W,
// rows a block).  e may be y itself (float32 x), so neither is
// __restrict__.  Each warp reads back only the columns it stored, so
// __syncwarp orders pass 2's stores before pass 3's loads.
template <typename T, int K>
__global__ void __launch_bounds__(256)
    reload_regs_kernel(const T* __restrict__ x, float* e, T* y, int rows,
                       int cols) {
  constexpr int kSpan = kLanes / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= static_cast<size_t>(rows)) return;     // whole warps (W = 1)
  const T* row = x + r * cols;
  float* erow = e + r * cols;
  T* yrow = y + r * cols;
  float v[K][kPerLane];
  float mu = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = (warp * K + k) * kChunk + i * kLanes + lane;
      v[k][i] = c < cols ? to_f32(row[c]) : -INFINITY;
      mu = fmaxf(mu, v[k][i]);
    }
  mu = warp_max(mu);                                           // pass 1
  __shared__ float smax[8], ssum[kLanes];       // W <= 8 warps a row
  if (nwarps > 1) {
    if (lane == 0) smax[warp] = mu;
    __syncthreads();
    mu = warp_max(lane < nwarps ? smax[lane] : -INFINITY);
  }
  float part[K];                                               // pass 2
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = (warp * K + k) * kChunk + i * kLanes + lane;
      const float ev = exp_nonpos(__fsub_rn(v[k][i], mu));
      if (c < cols) erow[c] = ev;
      s = __fadd_rn(s, ev);                 // a missing column adds +0
    }
    part[k] = s;
  }
  float sigma = repro::butterfly_scatter<K>(part);
  if (nwarps == 1) {
    sigma = repro::slots_in_warp<K>(sigma);
  } else {
    if (lane % kSpan == 0) ssum[warp * K + lane / kSpan] = sigma;
    __syncthreads();
    sigma = repro::warp_sum(lane < nwarps * K ? ssum[lane] : 0.0f);
  }
  const float inv = __frcp_rn(sigma);
  __syncwarp();
  const int c0 = warp * K * kChunk;                            // pass 3
  if ((cols & 3) == 0) {
    constexpr int kV = K * kChunk / (4 * kLanes);  // 16-byte loads a lane
    float4 ev[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = c0 + 4 * (i * kLanes + lane);
      if (c < cols) ev[i] = *reinterpret_cast<const float4*>(erow + c);
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int c = c0 + 4 * (i * kLanes + lane);
      if (c < cols)
        store4(yrow + c, make_float4(__fmul_rn(ev[i].x, inv),
                                     __fmul_rn(ev[i].y, inv),
                                     __fmul_rn(ev[i].z, inv),
                                     __fmul_rn(ev[i].w, inv)));
    }
  } else {
    const int nb = (lane + 1) & 31;
    float ev[K][kPerLane];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int c = c0 + k * kChunk + i * kLanes + nb;
        ev[k][i] = c < cols ? erow[c] : 0.0f;
      }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int c = c0 + k * kChunk + i * kLanes + nb;
        if (c < cols) store(yrow + c, __fmul_rn(ev[k][i], inv));
      }
  }
}

// Launch 2 of reload's split path (after recompute_max_kernel): mu from
// the row's 32 maxima; warp (row, slot) stores e of the slot's chunks at
// their columns and writes the slot's part of sigma to slots[row, slot,
// 1], summed as recompute_sum_kernel sums it.
template <typename T>
__global__ void __launch_bounds__(128)
    reload_sum_kernel(const T* __restrict__ x, float* __restrict__ e,
                      float* __restrict__ slots, int rows, int cols) {
  const size_t g = (static_cast<size_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x) >> 5;
  const size_t r = g / kLanes;
  const int slot = static_cast<int>(g % kLanes), lane = threadIdx.x & 31;
  if (r >= static_cast<size_t>(rows)) return;
  const float mu = warp_max(slots[(r * kLanes + lane) * 2]);
  float* erow = e + r * cols;
  const float acc = repro::slot_fold(
      x + r * cols, cols, slot, 0.0f,
      [=](const float (&xs)[kPerLane], int j) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const long c = static_cast<long>(j) * kChunk + i * kLanes + lane;
          const float ev = exp_nonpos(__fsub_rn(xs[i], mu));
          if (c < cols) erow[c] = ev;
          s = __fadd_rn(s, ev);
        }
        return s;
      });
  if (lane == 0) slots[g * 2 + 1] = acc;
}

// Launch 3: sigma from the row's 32 parts, then y = e * (1 / sigma) over
// kScaleCols columns, e read as float32 (y itself for float32 x).
template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
    reload_scale_kernel(const float* e, const float* __restrict__ slots,
                        T* y, int cols, int blocks_per_row) {
  const size_t r = blockIdx.x / blocks_per_row;
  const int base = (blockIdx.x % blocks_per_row) * kScaleCols;
  const int lane = threadIdx.x & 31;
  const float inv =
      __frcp_rn(repro::warp_sum(slots[(r * kLanes + lane) * 2 + 1]));
  repro::scale_cols(e + r * cols, y + r * cols, cols, base,
                    [inv](float v) { return __fmul_rn(v, inv); });
}

template <typename T>
int reload(const void* x, void* y, void* scratch, void* slots, int rows,
           int cols, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  float* e = static_cast<float*>(std::is_same<T, float>::value ? y
                                                               : scratch);
  if (slots == nullptr) {
    if (cols > repro::kRegsMaxCols)
      return static_cast<int>(cudaErrorInvalidValue);
    repro::launch_regs(rows, cols, [&](auto k, unsigned grid, dim3 block) {
      reload_regs_kernel<T, decltype(k)::value>
          <<<grid, block, 0, s>>>(xt, e, yt, rows, cols);
    });
  } else {
    float* sl = static_cast<float*>(slots);
    const unsigned blocks = static_cast<unsigned>(rows) * kLanes / 4;
    recompute_max_kernel<T><<<blocks, 128, 0, s>>>(xt, sl, rows, cols);
    reload_sum_kernel<T><<<blocks, 128, 0, s>>>(xt, e, sl, rows, cols);
    const int bpr = (cols + kScaleCols - 1) / kScaleCols;
    reload_scale_kernel<T><<<static_cast<unsigned>(rows) * bpr,
                             kScaleThreads, 0, s>>>(e, sl, yt, cols, bpr);
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
int threepass_recompute_2d(const void* x, void* y, void* slots, int rows,
                           int cols, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? recompute<float>(x, y, slots, rows, cols, s)
                    : recompute<__nv_bfloat16>(x, y, slots, rows, cols, s);
}

// scratch: the float32 e buffer [rows, cols] for bfloat16 x; ignored (y
// is the buffer) for float32 x.  slots as for threepass_recompute_2d.
int threepass_reload_2d(const void* x, void* y, void* scratch, void* slots,
                        int rows, int cols, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? reload<float>(x, y, scratch, slots, rows, cols, s)
             : reload<__nv_bfloat16>(x, y, scratch, slots, rows, cols, s);
}

}  // extern "C"
