// Cross-entropy over materialised logits by the two-pass softmax, for
// Hopper, rowwise over logits[T, V].
//
// Replaces the TPU kernels src/repro/kernels/twopass_xent.py (xent_fwd_2d:
// _fwd_kernel; xent_bwd_2d: _bwd_kernel).  The forward is pass 1 of the
// two-pass softmax plus the label logit; the backward is pass 2:
//   * forward: one read of the row folds (m_sum, n_sum) in the fixed order
//     of rowfold.cuh, and loss = log(m_sum) + n_sum * ln2 - x[label].  The
//     TPU kernel gathers the label logit as sum(where(col == label, x, 0));
//     at most one term of that sum is not zero, so reading x[label] (0 for
//     a label outside [0, V)) gives the same value.  No probability is
//     written.
//   * backward: one read of the row, one write of
//     dlogits = (m * (1 / m_sum) * 2^(n - n_sum) - onehot) * dloss, the
//     exponential recomputed from the saved (m_sum, n_sum).
// 2 reads + 1 write of [T, V] in all: the paper's 3N.
//
// Bound on this card: bytes for float32 logits (46 float operations per
// element in the forward, 31 in the backward, against 4 bytes read);
// operations for the bfloat16 forward (2 bytes read).  One thread block
// per row, threads as the softmax kernels take them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "extexp.cuh"
#include "rowfold.cuh"

namespace {

using repro::store;
using repro::to_f32;

// ln2 as the TPU kernel rounds LN2_HI + LN2_LO to float32.
constexpr float kLn2 = 0x1.62E430p-1f;

template <typename T>
__global__ void xent_fwd_kernel(const T* __restrict__ x,
                                const int* __restrict__ labels,
                                float* __restrict__ loss,
                                float* __restrict__ m_out,
                                float* __restrict__ n_out, int cols) {
  const size_t r = blockIdx.x;
  const T* row = x + r * cols;
  float m_sum, n_sum;
  repro::row_stats(row, cols, m_sum, n_sum);
  if (threadIdx.x == 0) {
    const int lab = labels[r];
    const float ll = (lab >= 0 && lab < cols) ? to_f32(row[lab]) : 0.0f;
    const float lse = __fadd_rn(logf(m_sum), __fmul_rn(n_sum, kLn2));
    loss[r] = __fsub_rn(lse, ll);
    m_out[r] = m_sum;
    n_out[r] = n_sum;
  }
}

template <typename T>
__global__ void xent_bwd_kernel(const T* __restrict__ x,
                                const int* __restrict__ labels,
                                const float* __restrict__ m_sum,
                                const float* __restrict__ n_sum,
                                const float* __restrict__ dloss,
                                T* __restrict__ dx, int cols) {
  const size_t r = blockIdx.x;
  const T* row = x + r * cols;
  const float lam = __frcp_rn(m_sum[r]);
  const float ns = n_sum[r], dl = dloss[r];
  const int lab = labels[r];
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float me, ne;
    repro::ext_exp(to_f32(row[c]), me, ne);
    const float p = __fmul_rn(__fmul_rn(me, lam),
                              repro::exp2_int(__fsub_rn(ne, ns)));
    store(dx + r * cols + c,
          __fmul_rn(__fsub_rn(p, c == lab ? 1.0f : 0.0f), dl));
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 = float32, 1 = bfloat16.  logits contiguous [rows, cols],
// labels int32 [rows]; loss, m_sum, n_sum float32 [rows].
int xent_fwd_2d(const void* x, const void* labels, void* loss, void* m_sum,
                void* n_sum, int rows, int cols, int dtype, int threads,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* m = static_cast<float*>(m_sum);
  float* n = static_cast<float*>(n_sum);
  if (dtype == 0)
    xent_fwd_kernel<float><<<rows, threads, 0, s>>>(
        static_cast<const float*>(x), lab, lo, m, n, cols);
  else
    xent_fwd_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lab, lo, m, n, cols);
  return static_cast<int>(cudaGetLastError());
}

// m_sum, n_sum, dloss float32 [rows]; dlogits [rows, cols] in the dtype of
// the logits.
int xent_bwd_2d(const void* x, const void* labels, const void* m_sum,
                const void* n_sum, const void* dloss, void* dx, int rows,
                int cols, int dtype, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* m = static_cast<const float*>(m_sum);
  const float* n = static_cast<const float*>(n_sum);
  const float* dl = static_cast<const float*>(dloss);
  if (dtype == 0)
    xent_bwd_kernel<float><<<rows, threads, 0, s>>>(
        static_cast<const float*>(x), lab, m, n, dl,
        static_cast<float*>(dx), cols);
  else
    xent_bwd_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lab, m, n, dl,
        static_cast<__nv_bfloat16*>(dx), cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
