// The paper's three-pass softmax baselines (Alg 1 and Alg 2) for Hopper,
// rowwise over x[R, C].
//
// Replaces the TPU kernels src/repro/kernels/threepass_softmax.py
// (threepass_recompute_2d: _max_kernel + _sumexp_kernel +
// _recompute_scale_kernel; threepass_reload_2d: _max_kernel +
// _exp_store_kernel + _inplace_scale_kernel).
//
// These exist to be compared with the two-pass kernel
// (twopass_softmax.cu), so they are built the same way and differ only in
// their passes over memory: one thread block per row, the same threads per
// row, every pass a sweep of the row in device memory, nothing kept on
// chip between passes but the row's scalars (mu, sigma), the same ExtExp
// arithmetic and the same fixed fold order (rowfold.cuh):
//   * Alg 1 (recompute): mu = max x; sigma = sum e(x - mu); y = e(x - mu) *
//     (1 / sigma), the exponential computed again.  3 reads + 1 write: 4N.
//   * Alg 2 (reload): mu = max x; e = e(x - mu) stored to a float32 buffer
//     while sigma sums it; y = e * (1 / sigma) read back.  2 reads + 1
//     write, then 1 read + 1 write: 5N.  With float32 x the buffer is y
//     itself and the last pass scales it in place; with bfloat16 x it is a
//     float32 scratch row, and only the final scale rounds to bfloat16.
// e(t) is the paper's Alg 4, as the TPU kernel computes it: ExtExp's
// (m, n) rebuilt as m * 2^n with the exponent-field exp2_int, which
// flushes to 0 for n <= -127 (t below about -88) where expf would give
// denormals.
//
// Bound on this card: bytes (about 61 float operations per element for
// Alg 1, 32 for Alg 2, against 4 or 5 float32 accesses).  Rows that fit
// in the 50 MB L2 with all the rows in flight are re-read from L2, so
// 4N/5N only show for long rows.
//
// An all -inf row gives mu = -inf, x - mu = NaN, sigma = 0 and y = 0 * inf
// = NaN, as in the TPU kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "extexp.cuh"
#include "rowfold.cuh"

namespace {

using repro::store;
using repro::to_f32;

// Paper Alg 4 for t <= 0: m * 2^n from ExtExp, rebuilt exactly.
__device__ __forceinline__ float exp_nonpos(float t) {
  float m, n;
  repro::ext_exp(t, m, n);
  return __fmul_rn(m, repro::exp2_int(n));
}

template <typename T>
__global__ void threepass_recompute_kernel(const T* __restrict__ x,
                                           T* __restrict__ y, int cols) {
  const size_t r = blockIdx.x;
  const T* row = x + r * cols;
  const float mu = repro::row_max(row, cols);                   // pass 1
  const float sigma = repro::row_sum(cols, [&](int c) {         // pass 2
    return exp_nonpos(__fsub_rn(to_f32(row[c]), mu));
  });
  const float inv = __frcp_rn(sigma);
  for (int c = threadIdx.x; c < cols; c += blockDim.x)          // pass 3
    store(y + r * cols + c,
          __fmul_rn(exp_nonpos(__fsub_rn(to_f32(row[c]), mu)), inv));
}

// e may be y itself (float32 x): then pass 3 scales y in place.  The
// barrier that ends row_sum makes pass 2's stores visible to pass 3.
template <typename T>
__global__ void threepass_reload_kernel(const T* __restrict__ x, float* e,
                                        T* y, int cols) {
  const size_t r = blockIdx.x;
  const T* row = x + r * cols;
  float* erow = e + r * cols;
  const float mu = repro::row_max(row, cols);                   // pass 1
  const float sigma = repro::row_sum(cols, [&](int c) {         // pass 2
    const float v = exp_nonpos(__fsub_rn(to_f32(row[c]), mu));
    erow[c] = v;
    return v;
  });
  const float inv = __frcp_rn(sigma);
  for (int c = threadIdx.x; c < cols; c += blockDim.x)          // pass 3
    store(y + r * cols + c, __fmul_rn(erow[c], inv));
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 = float32, 1 = bfloat16.  x and y are contiguous [rows, cols].
int threepass_recompute_2d(const void* x, void* y, int rows, int cols,
                           int dtype, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    threepass_recompute_kernel<float><<<rows, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), cols);
  else
    threepass_recompute_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        cols);
  return static_cast<int>(cudaGetLastError());
}

// scratch: float32 [rows, cols] for bfloat16 x; ignored (y is the buffer)
// for float32 x.
int threepass_reload_2d(const void* x, void* y, void* scratch, int rows,
                        int cols, int dtype, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    threepass_reload_kernel<float><<<rows, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y),
        static_cast<float*>(y), cols);
  else
    threepass_reload_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(scratch),
        static_cast<__nv_bfloat16*>(y), cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
