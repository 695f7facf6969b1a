// The Two-Pass softmax (paper Alg 3) for Hopper, rowwise over x[R, C].
//
// Replaces the TPU kernels src/repro/kernels/twopass_softmax.py
// (twopass_softmax_2d: _pass1_kernel + _pass2_kernel; twopass_stats_2d:
// _pass1_kernel alone).
//
// Bound on this card: bytes.  The work is ~74 float operations per element
// (46 in pass 1, 28 in pass 2) against 4 bytes read twice and 4 written
// (f32): ~6 per byte, below the ~20 operations per byte at which an H100's
// float32 units, and not its 3.35 TB/s of memory, would limit.  So the
// design moves the paper's 3N:
//   * one thread block per row; pass 1 reads the row once and folds every
//     element into (m, n) pairs, exactly as ext_add does, in the fixed
//     order of row_stats (rowfold.cuh).  No exponential is stored.
//   * pass 2 re-reads the row (mostly from L2 for rows that fit) and
//     writes y = m / m_sum * 2^(n - n_sum).
//   * the ragged edge is masked in the loop: nothing is padded, where the
//     TPU wrapper copied the scores into a -inf padded tile.
// Threads per block follow the row length (about 8 elements a thread, one
// warp for short rows, at most 1024), so a row of 48 scores takes one warp
// and the sampler's 152064 logits take 1024 threads.  The ORDER of the
// pass-1 fold depends on neither: see rowfold.cuh.  A -inf column adds the
// exact identity (m = 0, n = -1e38), so a row padded with -inf columns (a
// longer cache, a page-rounded prefill) gives the same bits as the row
// alone, whatever threads either launch takes.
// Known weakness: the sampler's [slots, 152064] launches only `slots`
// blocks on 132 SMs.  A split-row pass 1 with an exact (m, n) combine is
// later work.
//
// An all -inf row gives m_sum = 0, so y = 0 * inf = NaN, as in the TPU
// kernel and the plain version.  No row on the serving path is all -inf:
// key 0 is always visible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "extexp.cuh"
#include "rowfold.cuh"

namespace {

using repro::row_stats;
using repro::store;
using repro::to_f32;

template <typename T>
__global__ void twopass_softmax_kernel(const T* __restrict__ x,
                                       T* __restrict__ y, int cols) {
  const size_t r = blockIdx.x;
  const T* row = x + r * cols;
  float m_sum, n_sum;
  row_stats(row, cols, m_sum, n_sum);                     // pass 1
  const float lam = __frcp_rn(m_sum);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {  // pass 2
    float me, ne;
    repro::ext_exp(to_f32(row[c]), me, ne);
    store(y + r * cols + c,
          __fmul_rn(__fmul_rn(me, lam),
                    repro::exp2_int(__fsub_rn(ne, n_sum))));
  }
}

template <typename T>
__global__ void twopass_stats_kernel(const T* __restrict__ x,
                                     float* __restrict__ m_out,
                                     float* __restrict__ n_out, int cols) {
  const size_t r = blockIdx.x;
  float m_sum, n_sum;
  row_stats(x + r * cols, cols, m_sum, n_sum);
  if (threadIdx.x == 0) { m_out[r] = m_sum; n_out[r] = n_sum; }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 = float32, 1 = bfloat16.  x and y are contiguous [rows, cols].
int twopass_softmax_2d(const void* x, void* y, int rows, int cols, int dtype,
                       int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    twopass_softmax_kernel<float><<<rows, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), cols);
  else
    twopass_softmax_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        cols);
  return static_cast<int>(cudaGetLastError());
}

int twopass_stats_2d(const void* x, void* m_sum, void* n_sum, int rows,
                     int cols, int dtype, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    twopass_stats_kernel<float><<<rows, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(m_sum),
        static_cast<float*>(n_sum), cols);
  else
    twopass_stats_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(m_sum),
        static_cast<float*>(n_sum), cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
