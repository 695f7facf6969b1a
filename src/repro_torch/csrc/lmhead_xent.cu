// Fused LM-head cross-entropy by the two-pass softmax, for Hopper: the
// logits h @ w are recomputed tile by tile in the forward and in both
// backward products, so the [T, V] logits are never stored whole.
//
// Replaces the TPU kernels of src/repro/kernels/twopass_xent.py:
//   * lmhead_xent_fwd_2d (_lmhead_fwd_kernel, _lmhead_tile): per vocab
//     tile x = h @ w_j, fold (m, n) and the label logit; loss = lse - ll;
//   * lmhead_xent_dh_2d (_lmhead_dh_kernel, _lmhead_dlogits):
//     dh = sum_j ((p - onehot) * dl) @ w_j^T, x recomputed;
//   * lmhead_xent_dw_2d (_lmhead_dw_kernel): dw[:, j] = h^T @ ((p - onehot)
//     * dl), x recomputed.
//
// What it computes, as the TPU kernels do: vocab columns >= V count as
// -inf (ExtExp gives m = 0 exactly); a label outside [0, V) gathers 0;
// p = m * (1 / max(m_sum, 1e-37)) * 2^(n - n_sum);
// lse = log(max(m_sum, 1e-37)) + n_sum * ln2.  ExtExp and every rescale
// use __fmul_rn / __fadd_rn and rintf (extexp.cuh).
//
// Design.  Every product is computed in 128 x 128 output tiles (8 warps,
// 64 x 32 each) over the full reduction:
//   * bf16 h and w: bf16 tensor cores (nvcuda::wmma 16x16x16) with float32
//     accumulation, the k tiles of both operands copied by cp.async into a
//     ring in shared memory (tc_tile).  bf16 x bf16 products are exact in
//     float32, so the logits are the float32 product of the upcast values
//     up to sum order.
//   * float32 h and w: FFMA, 8 x 8 outputs a thread (ffma_tile).
// The forward folds each logit tile's 128 columns per row into one
// (m, n, ll) partial ([V/128, T] float32 scratch) and a second kernel
// folds the partials of a row in vocab order: no atomics.
//
// The backward cannot keep a whole (T_tile, D) dh tile or (D, V_tile) dw
// tile on chip at D = 5120 (a 128-column dw tile is 2.6 MB of float32), and
// each recomputed logit needs the full D reduction.  So it takes a vocab
// slab at a time (block_v columns, 8192 at full width): one kernel writes
// the slab's dlogits to scratch, then a product adds dlogits @ w_slab^T
// into dh (dh kernel) or writes h^T @ dlogits into dw[:, slab] (dw kernel).
// The dlogits are float32 and these products keep float32 accuracy, never
// TF32 or a bf16 rounding of the dlogits: with bf16 h and w each dlogit is
// written as three bf16 parts that sum to it exactly (split3) and the
// products run on the tensor cores, one per part, all summed in float32;
// with float32 h and w the dlogits stay float32 and the products are FFMA.
// dh [T, D] has only 160 tiles at full width, so its slab product is split
// along the slab's columns into partial products that a small kernel adds
// in split order.  Each output element is written by one thread in a fixed
// order: the same bits on every run.
//
// Bound on this card: operations.  At T = 512, D = 5120, V = 152064 each
// call does 2 T D V = 0.80 TFLOP of logit products (0.81 ms on the bf16
// tensor cores at 989 TFLOP/s); dh and dw each add three such products of
// the split dlogits (2.4 TFLOP, 2.4 ms).  Bytes: w is 1.56 GB (bf16), dw
// is 3.1 GB (float32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "extexp.cuh"
#include "rowfold.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::to_f32;
using nvcuda::wmma::accumulator;
using nvcuda::wmma::col_major;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::row_major;
using Acc = fragment<accumulator, 16, 16, 16, float>;

// ln2 as the TPU kernel rounds LN2_HI + LN2_LO to float32.
constexpr float kLn2 = 0x1.62E430p-1f;

constexpr int kThreads = 256;  // 8 warps: 2 x 4, 64 x 32 outputs each
constexpr int kTile = 128;     // output tile: 128 x 128
constexpr int kCsLd = kTile + 4;
constexpr int kBk = 32;        // tensor-core k tile
constexpr int kNarrowLd = kBk + 8;    // smem rows of 32 k values
constexpr int kWideLd = kTile + 8;    // smem rows of 128 m or n values
constexpr int kRectElems = kTile * kNarrowLd;  // >= kBk * kWideLd
constexpr int kFk = 8;         // FFMA k tile
constexpr int kFLd = kTile + 4;

constexpr int kLogitSmemBytes = kTile * kCsLd * 4;  // the f32 logit tile
constexpr int kFfmaSmemBytes = 2 * kFk * kFLd * 4;
// ring of a split product: 2 slots of 4 rectangles (3 parts + 1)
constexpr int kSplitSmemBytes = 2 * 4 * kRectElems * 2;
static_assert(kBk * kWideLd <= kRectElems, "smem");
static_assert(3 * 2 * kRectElems * 2 <= kLogitSmemBytes, "smem");
static_assert(kFfmaSmemBytes <= kLogitSmemBytes, "smem");
static_assert(8 * 256 * 4 <= kSplitSmemBytes, "smem");

// 8 consecutive bf16 of row r, columns [c, c + 8), of a [rows, cols] matrix
// with leading dimension ld into dst (16-byte aligned); zeros outside.  A
// whole aligned group is one asynchronous 16-byte copy (cp.async, waited
// for by the caller); the ragged edge is stored element by element.
__device__ __forceinline__ void load8(const bf16* __restrict__ src,
                                      long long r, long long c, long long rows,
                                      long long cols, long long ld, bool vec,
                                      bf16* dst) {
  if (vec && r < rows && c + 8 <= cols) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + r * ld + c));
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = (r < rows && c + e < cols) ? src[r * ld + c + e]
                                        : __float2bfloat16_rn(0.0f);
}

// A row-major bf16 matrix in device memory: rows x cols, leading dimension
// ld; vec: rows start 16-byte aligned (cp.async of 8-element groups).
struct Mat {
  const bf16* p;
  long long rows, cols, ld;
  bool vec;
};

__host__ __device__ inline bool aligned16(const void* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 8 == 0;
}

// The ROWS x COLS block at (r0, c0) of m into dst (row stride dst_ld).
template <int ROWS, int COLS>
__device__ __forceinline__ void load_rect(const Mat& m, long long r0,
                                          long long c0, bf16* dst,
                                          int dst_ld) {
  for (int i = threadIdx.x; i < ROWS * COLS / 8; i += kThreads) {
    const int r = i / (COLS / 8), c = (i % (COLS / 8)) * 8;
    load8(m.p, r0 + r, c0 + c, m.rows, m.cols, m.ld, m.vec,
          dst + r * dst_ld + c);
  }
}

// acc += sum over parts of A_pa @ B_pb, k in [0, K), on the bf16 tensor
// cores; A is NA matrices (parts), B is NB.  A_KM: A's tile is stored k by m
// (the matrix in memory is A^T, row-major [K, M]), else m by k (A row-major
// [M, K]).  B_NK: B's tile is stored n by k (B^T row-major [N, K]), else k
// by n (B row-major [K, N]).  The output tile's rows start at m0 of A, its
// columns at n0 of B.  k tiles of kBk pass through a ring of STAGES slots
// filled by cp.async, one commit group per tile.
template <int NA, int NB, bool A_KM, bool B_NK, int STAGES>
__device__ void tc_tile(const Mat (&a)[NA], const Mat (&b)[NB], long long m0,
                        long long n0, long long K, Acc (&acc)[4][2],
                        unsigned char* smem) {
  constexpr int kSlot = (NA + NB) * kRectElems;
  auto* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  auto rect = [&](int kt, int j) {
    return ring + (kt % STAGES) * kSlot + j * kRectElems;
  };
  auto load_tile = [&](int kt) {
    const long long k0 = static_cast<long long>(kt) * kBk;
#pragma unroll
    for (int p = 0; p < NA; ++p) {
      if (A_KM) load_rect<kBk, kTile>(a[p], k0, m0, rect(kt, p), kWideLd);
      else load_rect<kTile, kBk>(a[p], m0, k0, rect(kt, p), kNarrowLd);
    }
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      if (B_NK) load_rect<kTile, kBk>(b[p], n0, k0, rect(kt, NA + p),
                                      kNarrowLd);
      else load_rect<kBk, kTile>(b[p], k0, n0, rect(kt, NA + p), kWideLd);
    }
  };
  using LayA = std::conditional_t<A_KM, col_major, row_major>;
  using LayB = std::conditional_t<B_NK, col_major, row_major>;
  const int nk = static_cast<int>((K + kBk - 1) / kBk);
  // wait_group(STAGES - 1) leaves tile kt complete at step kt: one group
  // per tile, empty past the end
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < nk) load_tile(kt);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < nk; ++kt) {
    // the slot refilled here was read at step kt - 1, before its barrier
    if (kt + STAGES - 1 < nk) load_tile(kt + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
#pragma unroll
      for (int pa = 0; pa < NA; ++pa) {
        const bf16* as = rect(kt, pa);
        fragment<matrix_a, 16, 16, 16, bf16, LayA> fa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          nvcuda::wmma::load_matrix_sync(
              fa[i],
              A_KM ? as + kk * kWideLd + wr * 64 + i * 16
                   : as + (wr * 64 + i * 16) * kNarrowLd + kk,
              A_KM ? kWideLd : kNarrowLd);
#pragma unroll
        for (int pb = 0; pb < NB; ++pb) {
          const bf16* bs = rect(kt, NA + pb);
          fragment<matrix_b, 16, 16, 16, bf16, LayB> fb[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            nvcuda::wmma::load_matrix_sync(
                fb[j],
                B_NK ? bs + (wc * 32 + j * 16) * kNarrowLd + kk
                     : bs + kk * kWideLd + wc * 32 + j * 16,
                B_NK ? kNarrowLd : kWideLd);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // callers reuse the ring
}

__device__ __forceinline__ void zero(Acc (&acc)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
}

// The warp's 64 x 32 accumulator, element by element through a 16 x 16
// staging buffer of its own in smem: out(r, c, v) at tile-local (r, c).
template <typename F>
__device__ __forceinline__ void store_acc(Acc (&acc)[4][2],
                                          unsigned char* smem, F out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;
  float* buf = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      nvcuda::wmma::store_matrix_sync(buf, acc[i][j], 16,
                                      nvcuda::wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        out(wr * 64 + i * 16 + e / 16, wc * 32 + j * 16 + e % 16, buf[e]);
      __syncwarp();
    }
}

// Logit tile x[t0:t0+128, v0:v0+128] = h @ w into cs (float32, ld kCsLd),
// bf16 tensor cores.  h [T, D], w [D, V] row-major.
__device__ void logits_tile(const bf16* __restrict__ h,
                            const bf16* __restrict__ w, int T, int D, int V,
                            int t0, int v0, unsigned char* smem) {
  const Mat a[1] = {{h, T, D, D, aligned16(h, D)}};
  const Mat b[1] = {{w, D, V, V, aligned16(w, V)}};
  Acc acc[4][2];
  zero(acc);
  tc_tile<1, 1, false, false, 3>(a, b, t0, v0, D, acc, smem);
  float* cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(
          cs + (wr * 64 + i * 16) * kCsLd + wc * 32 + j * 16, acc[i][j],
          kCsLd, nvcuda::wmma::mem_row_major);
  __syncthreads();
}

// One 128 x 128 FFMA product tile: acc[i][j] += sum_k a(m0 + ty + 16 i, k)
// * b(k, n0 + tx + 16 j) over k in [0, K), in increasing k.  a and b return
// 0 outside their matrices.  A_K / B_K: the k index is the contiguous one in
// memory (threads load along it), else m or n is.
template <bool A_K, bool B_K, typename FA, typename FB>
__device__ __forceinline__ void ffma_tile(FA a, FB b, int m0, int n0, int K,
                                          float (&acc)[8][8],
                                          unsigned char* smem) {
  float* as = reinterpret_cast<float*>(smem);  // [kFk][kFLd]
  float* bs = as + kFk * kFLd;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k0 = 0; k0 < K; k0 += kFk) {
#pragma unroll
    for (int e = 0; e < kTile * kFk / kThreads; ++e) {
      const int i = threadIdx.x + e * kThreads;
      int m, k;
      if (A_K) { k = i % kFk; m = i / kFk; } else { m = i % kTile; k = i / kTile; }
      as[k * kFLd + m] = a(m0 + m, k0 + k);
      int n, kb;
      if (B_K) { kb = i % kFk; n = i / kFk; } else { n = i % kTile; kb = i / kTile; }
      bs[kb * kFLd + n] = b(k0 + kb, n0 + n);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFk; ++k) {
      float ra[8], rb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ra[i] = as[k * kFLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) rb[j] = bs[k * kFLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Element (r, c) of a row-major [rows, cols] matrix with leading dimension
// ld, as float32; 0 outside.
template <typename T>
struct RowMajor {
  const T* p;
  long long rows, cols, ld;
  __device__ __forceinline__ float operator()(long long r, long long c) const {
    return (r < rows && c < cols) ? to_f32(p[r * ld + c]) : 0.0f;
  }
};

// Element (r, c) of the transpose of a row-major matrix: p[c * ld + r].
template <typename T>
struct Transposed {
  const T* p;
  long long rows, cols, ld;  // of the transpose
  __device__ __forceinline__ float operator()(long long r, long long c) const {
    return (r < rows && c < cols) ? to_f32(p[c * ld + r]) : 0.0f;
  }
};

// The logit tile for float32 h and w: FFMA into cs.
__device__ void logits_tile(const float* __restrict__ h,
                            const float* __restrict__ w, int T, int D, int V,
                            int t0, int v0, unsigned char* smem) {
  float acc[8][8] = {};
  ffma_tile<true, false>(RowMajor<float>{h, T, D, D},
                         RowMajor<float>{w, D, V, V}, t0, v0, D, acc, smem);
  float* cs = reinterpret_cast<float*>(smem);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      cs[(ty + 16 * i) * kCsLd + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

// Forward, step 1: grid (ceil(V / 128), ceil(T / 128)).  Each block folds
// its tile's 128 columns per row into (m, n) and the label logit: two
// threads a row, 64 columns each in order, then one (m, n) add.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lmhead_fwd_tiles(const T* __restrict__ h, const T* __restrict__ w,
                     const int* __restrict__ labels, float* __restrict__ pm,
                     float* __restrict__ pn, float* __restrict__ pll, int Tn,
                     int D, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int v0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  logits_tile(h, w, Tn, D, V, t0, v0, smem);
  const float* cs = reinterpret_cast<const float*>(smem);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int t = t0 + r;
  const int lab = t < Tn ? labels[t] : -1;
  float m = 0.0f, n = repro::kMinusInfN, ll = 0.0f;
  for (int c = half * 64; c < half * 64 + 64; ++c) {
    const int v = v0 + c;
    const float x = v < V ? cs[r * kCsLd + c] : -INFINITY;
    float me, ne;
    repro::ext_exp(x, me, ne);
    repro::ext_add(m, n, me, ne);
    if (v == lab && v < V) ll = x;
  }
  const float m2 = __shfl_xor_sync(0xffffffffu, m, 1);
  const float n2 = __shfl_xor_sync(0xffffffffu, n, 1);
  const float l2 = __shfl_xor_sync(0xffffffffu, ll, 1);
  if (half == 0 && t < Tn) {
    repro::ext_add(m, n, m2, n2);
    const size_t o = static_cast<size_t>(blockIdx.x) * Tn + t;
    pm[o] = m;
    pn[o] = n;
    pll[o] = __fadd_rn(ll, l2);  // at most one of the two is not 0
  }
}

// Forward, step 2: one thread a row folds the partials in vocab order.
__global__ void lmhead_fwd_combine(const float* __restrict__ pm,
                                   const float* __restrict__ pn,
                                   const float* __restrict__ pll,
                                   float* __restrict__ loss,
                                   float* __restrict__ m_out,
                                   float* __restrict__ n_out, int Tn,
                                   int tiles) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Tn) return;
  float m = 0.0f, n = repro::kMinusInfN, ll = 0.0f;
  for (int j = 0; j < tiles; ++j) {
    const size_t o = static_cast<size_t>(j) * Tn + t;
    repro::ext_add(m, n, pm[o], pn[o]);
    ll = __fadd_rn(ll, pll[o]);
  }
  const float lse = __fadd_rn(logf(fmaxf(m, 1e-37f)), __fmul_rn(n, kLn2));
  loss[t] = __fsub_rn(lse, ll);
  m_out[t] = m;
  n_out[t] = n;
}

// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): the two
// subtractions are exact and what is left after two 8-bit parts fits in the
// third, so hi + mid + lo == x and each part x bf16 product is exact in
// float32.  Parts are `stride` elements apart.
__device__ __forceinline__ void split3(float x, bf16* p, size_t stride) {
  const bf16 hi = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(hi));
  const bf16 mid = __float2bfloat16_rn(r1);
  p[0] = hi;
  p[stride] = mid;
  p[2 * stride] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
}

__device__ __forceinline__ void put_dlogit(float* dlog, size_t i, size_t,
                                           float d) {
  dlog[i] = d;
}
__device__ __forceinline__ void put_dlogit(bf16* dlog, size_t i,
                                           size_t plane, float d) {
  split3(d, dlog + i, plane);
}

// Backward, dlogits of one vocab slab [vs0, vs0 + ws): grid (ceil(ws /
// 128), ceil(T / 128)); writes dlog[t, v - vs0] = (p - onehot) * dl for
// t < T, v < vs0 + ws (the slab ends at or before V), row stride ld: as
// float32 for float32 h and w, as three bf16 planes of T x ld for bf16.
template <typename T, typename D_T>
__global__ void __launch_bounds__(kThreads)
    lmhead_dlogits(const T* __restrict__ h, const T* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ m_sum,
                   const float* __restrict__ n_sum,
                   const float* __restrict__ dloss, D_T* __restrict__ dlog,
                   int Tn, int D, int V, int vs0, int ws, int ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  logits_tile(h, w, Tn, D, V, t0, vs0 + c0, smem);
  const float* cs = reinterpret_cast<const float*>(smem);
  const size_t plane = static_cast<size_t>(Tn) * ld;
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    const int t = t0 + r, cc = c0 + c;
    if (t >= Tn || cc >= ws) continue;
    float me, ne;
    repro::ext_exp(cs[r * kCsLd + c], me, ne);
    const float lam = __frcp_rn(fmaxf(m_sum[t], 1e-37f));
    const float p = __fmul_rn(__fmul_rn(me, lam),
                              repro::exp2_int(__fsub_rn(ne, n_sum[t])));
    const float hot = (vs0 + cc == labels[t]) ? 1.0f : 0.0f;
    put_dlogit(dlog, static_cast<size_t>(t) * ld + cc, plane,
               __fmul_rn(__fsub_rn(p, hot), dloss[t]));
  }
}

// Split z of dlog[T, ws] @ w[:, vs0:vs0+ws]^T into part[z] ([T, D]) over
// slab columns [z kc, (z + 1) kc); grid (ceil(D / 128), ceil(T / 128),
// splits).  dh [T, D] alone has too few tiles to fill the card, so the
// slab's k range is split and lmhead_dh_add folds the parts in order.
// bf16: three tensor-core products of the split dlogits (planes of T x
// ld) with w^T; float32: FFMA.
template <typename T, typename D_T>
__global__ void __launch_bounds__(kThreads)
    lmhead_dh_slab(const D_T* __restrict__ dlog, const T* __restrict__ w,
                   float* __restrict__ part, int Tn, int D, int V, int vs0,
                   int ws, int ld, int kc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int k0 = blockIdx.z * kc;
  const int kn = ws - k0 < kc ? ws - k0 : kc;
  float* out = part + static_cast<size_t>(blockIdx.z) * Tn * D;
  auto put = [&](int r, int c, float v) {
    if (m0 + r < Tn && n0 + c < D)
      out[static_cast<size_t>(m0 + r) * D + n0 + c] = v;
  };
  if constexpr (std::is_same_v<T, bf16>) {
    const size_t plane = static_cast<size_t>(Tn) * ld;
    const bf16* d0 = dlog + k0;
    const bool vd = aligned16(d0, ld);
    const Mat a[3] = {{d0, Tn, kn, ld, vd}, {d0 + plane, Tn, kn, ld, vd},
                      {d0 + 2 * plane, Tn, kn, ld, vd}};
    // B^T = w[:, vs0 + k0 :] row-major [D, kn]
    const bf16* wk = w + vs0 + k0;
    const Mat b[1] = {{wk, D, kn, V, aligned16(wk, V)}};
    Acc acc[4][2];
    zero(acc);
    tc_tile<3, 1, false, true, 2>(a, b, m0, n0, kn, acc, smem);
    store_acc(acc, smem, put);
  } else {
    float acc[8][8] = {};
    // b(k, n) = w[n, vs0 + k]: the transpose of the slab, k contiguous
    ffma_tile<true, true>(RowMajor<float>{dlog + k0, Tn, kn, ld},
                          Transposed<T>{w + vs0 + k0, kn, D, V}, m0, n0, kn,
                          acc, smem);
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) put(ty + 16 * i, tx + 16 * j, acc[i][j]);
  }
}

// dh (+)= part[0] + part[1] + ... in split order; the first slab writes.
__global__ void lmhead_dh_add(const float* __restrict__ part,
                              float* __restrict__ dh, size_t n, int splits,
                              bool first) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s = __fadd_rn(s, part[z * n + i]);
  dh[i] = first ? s : __fadd_rn(dh[i], s);
}

// dw[:, vs0:vs0+ws] = h^T @ dlog over the T tokens; grid (ceil(ws / 128),
// ceil(D / 128)).  dw is [D, V] float32.  bf16: three tensor-core products
// of h^T with the split dlogits; float32: FFMA.
template <typename T, typename D_T>
__global__ void __launch_bounds__(kThreads)
    lmhead_dw_slab(const T* __restrict__ h, const D_T* __restrict__ dlog,
                   float* __restrict__ dw, int Tn, int D, int V, int vs0,
                   int ws, int ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  auto put = [&](int r, int c, float v) {
    if (m0 + r < D && n0 + c < ws)
      dw[static_cast<size_t>(m0 + r) * V + vs0 + n0 + c] = v;
  };
  if constexpr (std::is_same_v<T, bf16>) {
    const size_t plane = static_cast<size_t>(Tn) * ld;
    const bool vd = aligned16(dlog, ld);
    const Mat a[1] = {{h, Tn, D, D, aligned16(h, D)}};  // A^T = h
    const Mat b[3] = {{dlog, Tn, ws, ld, vd}, {dlog + plane, Tn, ws, ld, vd},
                      {dlog + 2 * plane, Tn, ws, ld, vd}};
    Acc acc[4][2];
    zero(acc);
    tc_tile<1, 3, true, false, 2>(a, b, m0, n0, Tn, acc, smem);
    store_acc(acc, smem, put);
  } else {
    float acc[8][8] = {};
    // a(d, t) = h[t, d]: the transpose of h, d contiguous
    ffma_tile<false, false>(Transposed<T>{h, D, Tn, D},
                            RowMajor<float>{dlog, Tn, ws, ld}, m0, n0, Tn,
                            acc, smem);
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) put(ty + 16 * i, tx + 16 * j, acc[i][j]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

constexpr int kMaxDhSplits = 8;

// k splits of a dh slab product: at least 4 blocks for each SM's worth of
// tiles, each split a whole number of k tiles.
int dh_splits(int tiles, int ws) {
  int sms = 132;
  int dev;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int z = (4 * sms + tiles - 1) / tiles;
  z = z < 1 ? 1 : (z > kMaxDhSplits ? kMaxDhSplits : z);
  const int steps = (ws + kBk - 1) / kBk;
  return z < steps ? z : steps;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int fwd(const void* h, const void* w, const int* lab, float* scratch,
        float* loss, float* m, float* n, int Tn, int D, int V,
        cudaStream_t s) {
  const T* hp = static_cast<const T*>(h);
  const T* wp = static_cast<const T*>(w);
  const int tiles = cdiv(V, kTile);
  float* pm = scratch;
  float* pn = pm + static_cast<size_t>(tiles) * Tn;
  float* pll = pn + static_cast<size_t>(tiles) * Tn;
  cudaError_t e = allow_smem(lmhead_fwd_tiles<T>, kLogitSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  lmhead_fwd_tiles<T><<<dim3(tiles, cdiv(Tn, kTile)), kThreads,
                        kLogitSmemBytes, s>>>(hp, wp, lab, pm, pn, pll, Tn, D,
                                              V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lmhead_fwd_combine<<<cdiv(Tn, 128), 128, 0, s>>>(pm, pn, pll, loss, m, n,
                                                   Tn, tiles);
  return static_cast<int>(cudaGetLastError());
}

// scratch: the slab's dlogits (float32 [T, slab] for float32 h and w,
// three bf16 planes [3, T, slab] for bf16: either fits in 2 T slab
// floats), then, for dh, kMaxDhSplits float32 [T, D] partial products.
template <typename T>
int bwd(const void* h, const void* w, const int* lab, const float* m,
        const float* n, const float* dl, float* scratch, float* out, int Tn,
        int D, int V, int slab, bool want_dh, cudaStream_t s) {
  using D_T = std::conditional_t<std::is_same_v<T, bf16>, bf16, float>;
  const T* hp = static_cast<const T*>(h);
  const T* wp = static_cast<const T*>(w);
  auto* dlog = reinterpret_cast<D_T*>(scratch);
  float* parts = scratch + 2 * static_cast<size_t>(Tn) * slab;
  const size_t td = static_cast<size_t>(Tn) * D;
  const int prod_smem =
      std::is_same_v<T, bf16> ? kSplitSmemBytes : kFfmaSmemBytes;
  cudaError_t e = allow_smem(lmhead_dlogits<T, D_T>, kLogitSmemBytes);
  if (e == cudaSuccess)
    e = want_dh ? allow_smem(lmhead_dh_slab<T, D_T>, prod_smem)
                : allow_smem(lmhead_dw_slab<T, D_T>, prod_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int dh_tiles = cdiv(D, kTile) * cdiv(Tn, kTile);
  for (int vs0 = 0; vs0 < V; vs0 += slab) {
    const int ws = V - vs0 < slab ? V - vs0 : slab;
    lmhead_dlogits<T, D_T><<<dim3(cdiv(ws, kTile), cdiv(Tn, kTile)),
                             kThreads, kLogitSmemBytes, s>>>(
        hp, wp, lab, m, n, dl, dlog, Tn, D, V, vs0, ws, slab);
    if (want_dh) {
      const int z = dh_splits(dh_tiles, ws);
      const int kc = cdiv(cdiv(ws, z), kBk) * kBk;
      const int zz = cdiv(ws, kc);  // splits that hold columns
      lmhead_dh_slab<T, D_T><<<dim3(cdiv(D, kTile), cdiv(Tn, kTile), zz),
                               kThreads, prod_smem, s>>>(
          dlog, wp, parts, Tn, D, V, vs0, ws, slab, kc);
      lmhead_dh_add<<<static_cast<unsigned>((td + 255) / 256), 256, 0, s>>>(
          parts, out, td, zz, vs0 == 0);
    } else {
      lmhead_dw_slab<T, D_T><<<dim3(cdiv(ws, kTile), cdiv(D, kTile)),
                               kThreads, prod_smem, s>>>(
          hp, dlog, out, Tn, D, V, vs0, ws, slab);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 = float32, 1 = bfloat16 (h and w alike).  h [T, D], w [D, V]
// contiguous; labels int32 [T]; loss, m_sum, n_sum float32 [T]; scratch
// float32 [3, ceil(V / 128), T].
int lmhead_xent_fwd_2d(const void* h, const void* w, const void* labels,
                       void* scratch, void* loss, void* m_sum, void* n_sum,
                       int T, int D, int V, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* sc = static_cast<float*>(scratch);
  float* lo = static_cast<float*>(loss);
  float* m = static_cast<float*>(m_sum);
  float* n = static_cast<float*>(n_sum);
  if (dtype == 0) return fwd<float>(h, w, lab, sc, lo, m, n, T, D, V, s);
  return fwd<bf16>(h, w, lab, sc, lo, m, n, T, D, V, s);
}

// want_dh 1: out = dh float32 [T, D]; 0: out = dw float32 [D, V].
// scratch: float32, 2 T slab values (+ 8 T D for dh).  m_sum, n_sum, dloss
// float32 [T].
int lmhead_xent_bwd_2d(const void* h, const void* w, const void* labels,
                       const void* m_sum, const void* n_sum,
                       const void* dloss, void* scratch, void* out, int T,
                       int D, int V, int slab, int want_dh, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* m = static_cast<const float*>(m_sum);
  const float* n = static_cast<const float*>(n_sum);
  const float* dl = static_cast<const float*>(dloss);
  float* sc = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return bwd<float>(h, w, lab, m, n, dl, sc, o, T, D, V, slab, want_dh != 0,
                      s);
  return bwd<bf16>(h, w, lab, m, n, dl, sc, o, T, D, V, slab, want_dh != 0,
                   s);
}

}  // extern "C"
