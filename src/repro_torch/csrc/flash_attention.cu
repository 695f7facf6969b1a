// Flash attention with the paper's (m, n) extended-exponent accumulator,
// forward and backward, for Hopper.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   * flash_attention_fwd_gqa (_fwd_kernel): per KV tile, scores
//     s = q k^T * scale with the end-aligned causal / window / key-length
//     mask, (m, n) = ExtExp(s), n_loc = max n, w = m 2^(n - n_loc),
//     folded into (o, m_sum, n_sum) with exact power-of-two rescales;
//     o / max(m_sum, 1e-37) at the end;
//   * flash_attention_bwd_gqa (_bwd_dq_kernel, _bwd_dkv_kernel): per tile,
//     p = m 2^(n - n_sum) / max(m_sum, 1e-37) recomputed from the forward's
//     stats, dp = do v^T, ds = p (dp - delta) scale; dq = sum ds k,
//     dk = sum ds^T q, dv = sum p^T do.
// ExtExp and every rescale use __fmul_rn / __fadd_rn and rintf
// (extexp.cuh), so kernel and plain version share their (m, n) bits.
//
// Layouts: q, o, do [B, H, Sq, D]; k, v [B, Hkv, Skv, D], H a multiple of
// Hkv (GQA: q-head h reads KV head h / (H / Hkv), K/V are never repeated);
// stats and delta [B, H, Sq] float32; all contiguous.  D is a multiple of 8
// up to 256; tiles are zero-filled to Dp (D rounded up to 16) in shared
// memory, and ragged Sq / Skv edges are masked here, so nothing is padded
// in device memory.  Query row i sits at position i + Skv - Sq (the ends
// of the two sequences align), so a causal call with Sq > Skv has rows that
// see no key: their o, dq and stats are exact zeros (m_sum = 0,
// n_sum = -1e38).
//
// Design.  One block of 4 warps owns one tile of BQ query rows (forward,
// dq) or BK key rows (dk/dv) and loops over the other axis inside the
// block: the loop replaces the TPU's sequential grid axis.  Every output
// element has one writer and every sum runs in a fixed order, so two runs
// give the same bits (no atomics).  dk/dv of a KV head sum over the H/Hkv
// q-heads of its group inside the block.  KV tiles wholly past the causal
// diagonal or wholly outside the window are skipped: a masked tile folds in
// as the monoid's identity, so the skip changes no bit.
//
// Products.  bf16 inputs: q k^T and do v^T are bf16 x bf16 products, exact
// in float32, on the tensor cores (nvcuda::wmma 16x16x16, float32
// accumulation).  w, p and ds are float32: rounding them to bf16 or TF32
// would change the function, so each is written to shared memory as three
// bf16 parts that sum to it exactly (hi + mid + lo) and its product runs as
// three tensor-core products.  Cost: the forward does 1 + 3 products where
// the function needs 2; the backward 2 + 3 (dq) and 2 + 3 + 3 (dk/dv)
// where it needs 5.  float32 inputs take FFMA throughout (the kernel
// check's path).
//
// Bound on this card (B 1, H 40, Hkv 8, S 4096, D 128, bf16, causal):
// operations.  The forward's 2 products over the causal half are 1.7e11
// operations (0.17 ms at 989 TFLOP/s), the backward's 5 are 4.3e11
// (0.43 ms); bytes are ~0.1 GB (0.03 ms).  The tiles are plain shared-
// memory wmma with one cp.async stage: wgmma / TMA pipelines are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "extexp.cuh"
#include "rowfold.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;

// The problem, shared by the three kernels.
struct Attn {
  int H, Hkv, Sq, Skv, D, Dp;
  float scale;
  int causal, window;  // window <= 0: none
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Key kj is visible to query row qi: end-aligned causal and window masks,
// keys past Skv invisible.
__device__ __forceinline__ bool visible(const Attn& a, int qi, int kj) {
  const int qpos = qi + a.Skv - a.Sq;
  return kj < a.Skv && (!a.causal || kj <= qpos) &&
         (a.window <= 0 || kj > qpos - a.window);
}

// The KV tiles [lo, hi) that hold a key visible to some row of
// [q0, q0 + BQ).
template <int BQ, int BK>
__device__ __forceinline__ void kv_tiles(const Attn& a, int q0, int& lo,
                                         int& hi) {
  const int off = a.Skv - a.Sq;
  const int qlast = min(q0 + BQ, a.Sq) - 1;
  int end = a.Skv;
  if (a.causal) end = min(end, qlast + off + 1);
  int begin = 0;
  if (a.window > 0) begin = max(0, q0 + off - a.window + 1);
  lo = begin / BK;
  hi = end > begin ? cdiv(end, BK) : lo;
}

// The Q tiles [lo, hi) that hold a row seeing some key of [k0, k0 + BK).
template <int BQ, int BK>
__device__ __forceinline__ void q_tiles(const Attn& a, int k0, int& lo,
                                        int& hi) {
  const int off = a.Skv - a.Sq;
  const int klast = min(k0 + BK, a.Skv) - 1;
  int begin = 0;
  if (a.causal) begin = max(0, k0 - off);
  int end = a.Sq;
  if (a.window > 0) end = min(end, klast + a.window - off);
  lo = begin / BQ;
  hi = end > begin ? cdiv(end, BQ) : lo;
}

// Leading dimensions in shared memory (elements): 16-byte rows, padded
// against bank conflicts; wmma needs a multiple of 8 (bf16) / 4 (float).
template <typename T>
__host__ __device__ constexpr int ld_in(int Dp) {
  return Dp + (std::is_same_v<T, bf16> ? 8 : 4);
}
// w / p / ds: three bf16 planes for bf16 inputs, one float32 plane else.
template <typename T>
struct Parts {
  using type = std::conditional_t<std::is_same_v<T, bf16>, bf16, float>;
  static constexpr int n = std::is_same_v<T, bf16> ? 3 : 1;
  static constexpr int pad = std::is_same_v<T, bf16> ? 8 : 4;
};

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same_v<T, bf16>) return __float2bfloat16_rn(0.0f);
  else return 0.0f;
}

// Shared-memory regions, each 128-byte aligned; the same arithmetic on the
// host (sizes) and the device (offsets).
struct Carve {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = off;
    off += (bytes + 127) / 128 * 128;
    return o;
  }
};

// Rows [r0, r0 + nrows) of a row-major [rows, D] matrix into dst (leading
// dimension ld), columns zero-filled to Dp and rows past `rows` zero.
// Aligned 16-byte groups go by cp.async (waited for by the caller).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int nrows, int rows, int D, int Dp,
                                          T* dst, int ld, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int groups = Dp / kVec;
  for (int i = threadIdx.x; i < nrows * groups; i += kThreads) {
    const int r = i / groups, c = (i % groups) * kVec;
    const int gr = r0 + r;
    T* d = dst + r * ld + c;
    const T* s = src + static_cast<size_t>(gr) * D + c;
    if (vec && gr < rows && c + kVec <= D) {
      const unsigned sd = static_cast<unsigned>(__cvta_generic_to_shared(d));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd),
                   "l"(s));
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        d[e] = (gr < rows && c + e < D) ? s[e] : zero_of<T>();
    }
  }
}

__device__ __forceinline__ void wait_loads() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// hi + mid + lo == x exactly, each bf16 (see csrc/lmhead_xent.cu split3).
__device__ __forceinline__ void put_parts(bf16* p, size_t plane, float x) {
  const bf16 hi = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(hi));
  const bf16 mid = __float2bfloat16_rn(r1);
  p[0] = hi;
  p[plane] = mid;
  p[2 * plane] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
}
__device__ __forceinline__ void put_parts(float* p, size_t, float x) {
  *p = x;
}

// ---------------------------------------------------------------------------
// Tile products.  M, N, K multiples of 16.  An operand is "row" (element
// (i, j) at p[i * ld + j]) or "col" (at p[j * ld + i]).
//
// bf16: each warp takes 16 x 64 output blocks (4 fragments) in turn; out(acc,
// m0, n0) receives each 16 x 16 accumulator.  A has NP parts, `plane`
// elements apart, summed into one accumulator.
// ---------------------------------------------------------------------------
template <int NP, bool A_COL, bool B_COL, typename Out>
__device__ __forceinline__ void tc_prod(const bf16* A, int lda, size_t plane,
                                        const bf16* B, int ldb, int M, int N,
                                        int K, Out out) {
  using LayA = std::conditional_t<A_COL, wmma::col_major, wmma::row_major>;
  using LayB = std::conditional_t<B_COL, wmma::col_major, wmma::row_major>;
  const int warp = threadIdx.x >> 5;
  const int mt = M / 16, nt = N / 16, ng = (nt + 3) / 4;
  for (int it = warp; it < mt * ng; it += kWarps) {
    const int m0 = (it / ng) * 16, cg = it % ng;
    const int nf = min(4, nt - cg * 4);
    Acc acc[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB> fb[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if (f < nf) {
          const int n0 = cg * 64 + f * 16;
          wmma::load_matrix_sync(
              fb[f], B_COL ? B + n0 * ldb + k0 : B + k0 * ldb + n0, ldb);
        }
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA> fa;
        const bf16* ap = A + p * plane;
        wmma::load_matrix_sync(
            fa, A_COL ? ap + k0 * lda + m0 : ap + m0 * lda + k0, lda);
#pragma unroll
        for (int f = 0; f < 4; ++f)
          if (f < nf) wmma::mma_sync(acc[f], fa, fb[f], acc[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f)
      if (f < nf) out(acc[f], m0, cg * 64 + f * 16);
  }
}

// float32: one thread per output element in turn, FFMA over k in order.
template <bool A_COL, bool B_COL, typename Epi>
__device__ __forceinline__ void ffma_prod(const float* A, int lda,
                                          const float* B, int ldb, int M,
                                          int N, int K, Epi epi) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int r = i / N, c = i % N;
    float s = 0.0f;
    for (int k = 0; k < K; ++k)
      s = fmaf(A_COL ? A[k * lda + r] : A[r * lda + k],
               B_COL ? B[c * ldb + k] : B[k * ldb + c], s);
    epi(r, c, s);
  }
}

// C = A B^T into float32 shared memory (ldc), A [M][K], B [N][K].
__device__ __forceinline__ void prod_nt(const bf16* A, int lda,
                                        const bf16* B, int ldb, int M, int N,
                                        int K, float* C, int ldc) {
  tc_prod<1, false, true>(A, lda, 0, B, ldb, M, N, K,
                          [&](Acc& acc, int m0, int n0) {
                            wmma::store_matrix_sync(C + m0 * ldc + n0, acc,
                                                    ldc, wmma::mem_row_major);
                          });
}
__device__ __forceinline__ void prod_nt(const float* A, int lda,
                                        const float* B, int ldb, int M, int N,
                                        int K, float* C, int ldc) {
  ffma_prod<false, true>(A, lda, B, ldb, M, N, K,
                         [&](int r, int c, float v) { C[r * ldc + c] = v; });
}

// epi(r, c, sum_p A_p B) for every output, A_p [M][K] (A_COL: stored
// [K][M]), B [K][N]; bf16 through a 16 x 16 staging buffer per warp.
template <bool A_COL, typename Epi>
__device__ __forceinline__ void prod_parts(const bf16* A, int lda,
                                           size_t plane, const bf16* B,
                                           int ldb, int M, int N, int K,
                                           float* stage, Epi epi) {
  const int lane = threadIdx.x & 31;
  float* st = stage + (threadIdx.x >> 5) * 256;
  tc_prod<3, A_COL, false>(
      A, lda, plane, B, ldb, M, N, K, [&](Acc& acc, int m0, int n0) {
        wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          epi(m0 + e / 16, n0 + e % 16, st[e]);
        __syncwarp();
      });
}
template <bool A_COL, typename Epi>
__device__ __forceinline__ void prod_parts(const float* A, int lda, size_t,
                                           const float* B, int ldb, int M,
                                           int N, int K, float*, Epi epi) {
  ffma_prod<A_COL, false>(A, lda, B, ldb, M, N, K, epi);
}

// n of ExtExp(x) for the row's largest x: rintf and multiplication by
// log2(e) are monotone, so this equals the largest n of the row bit for
// bit, with -inf (masked) mapping to the identity exponent.
__device__ __forceinline__ float n_of_max(float x) {
  if (x == -INFINITY) return repro::kMinusInfN;
  if (x == INFINITY) return repro::kPlusInfN;
  const float xc = fminf(fmaxf(x, -repro::kXClamp), repro::kXClamp);
  return rintf(__fmul_rn(xc, repro::kLog2e));
}

// ---------------------------------------------------------------------------
// Forward.  grid (H, B, ceil(Sq / BQ)); z runs the Q tiles from the last
// (under causal masking the busiest) to the first.
// ---------------------------------------------------------------------------
template <typename T, int BQ, int BK>
struct FwdLayout {
  size_t qs, ks, vs, sw, os, rows, total;
  __host__ __device__ explicit FwdLayout(int Dp) {
    using P = Parts<T>;
    Carve c;
    const int ld = ld_in<T>(Dp);
    qs = c.take(sizeof(T) * BQ * ld);
    // ks also holds the per-warp staging buffers while w v runs
    const size_t kb = sizeof(T) * BK * ld;
    ks = c.take(kb > 4 * kWarps * 256 ? kb : 4 * kWarps * 256);
    vs = c.take(sizeof(T) * BK * ld);
    // the scores, then (in the same bytes) the parts of w
    const size_t sb = 4 * BQ * (BK + 4);
    const size_t wb = sizeof(typename P::type) * P::n * BQ * (BK + P::pad);
    sw = c.take(sb > wb ? sb : wb);
    os = c.take(4 * BQ * (Dp + 4));
    rows = c.take(4 * 4 * BQ);
    total = c.off;
  }
};

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ m_out, float* __restrict__ n_out, Attn a) {
  using P = Parts<T>;
  using PT = typename P::type;
  constexpr int TPR = kThreads / BQ;  // threads per row
  constexpr int CPT = BK / TPR;       // columns per thread
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout<T, BQ, BK> L(a.Dp);
  const int ld = ld_in<T>(a.Dp), lds = BK + 4, ldw = BK + P::pad,
            ldo = a.Dp + 4;
  T* Qs = reinterpret_cast<T*>(smem + L.qs);
  T* Ks = reinterpret_cast<T*>(smem + L.ks);
  float* stage = reinterpret_cast<float*>(smem + L.ks);
  T* Vs = reinterpret_cast<T*>(smem + L.vs);
  float* Ss = reinterpret_cast<float*>(smem + L.sw);
  PT* Wp = reinterpret_cast<PT*>(smem + L.sw);
  float* Os = reinterpret_cast<float*>(smem + L.os);
  float* m_acc = reinterpret_cast<float*>(smem + L.rows);
  float* n_acc = m_acc + BQ;
  float* a_old = n_acc + BQ;
  float* a_loc = a_old + BQ;
  const size_t plane = static_cast<size_t>(BQ) * ldw;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (a.H / a.Hkv);
  const size_t qrow = (static_cast<size_t>(b) * a.H + h) * a.Sq;
  const size_t krow = (static_cast<size_t>(b) * a.Hkv + hk) * a.Skv;
  const T* qp = q + qrow * a.D;
  const T* kp = k + krow * a.D;
  const T* vp = v + krow * a.D;
  const bool vq = aligned16(qp), vk = aligned16(kp), vv = aligned16(vp);

  load_tile(qp, q0, BQ, a.Sq, a.D, a.Dp, Qs, ld, vq);
  for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) Os[i] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_acc[r] = 0.0f;
    n_acc[r] = repro::kMinusInfN;
  }
  int jlo, jhi;
  kv_tiles<BQ, BK>(a, q0, jlo, jhi);
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = q0 + r;
  for (int jt = jlo; jt < jhi; ++jt) {
    const int k0 = jt * BK;
    load_tile(kp, k0, BK, a.Skv, a.D, a.Dp, Ks, ld, vk);
    load_tile(vp, k0, BK, a.Skv, a.D, a.Dp, Vs, ld, vv);
    wait_loads();
    prod_nt(Qs, ld, Ks, ld, BQ, BK, a.Dp, Ss, lds);
    __syncthreads();
    // scores of this thread's columns, masked; the row's largest
    float x[CPT];
    float xmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = part * CPT + j;
      x[j] = visible(a, qi, k0 + c) ? __fmul_rn(Ss[r * lds + c], a.scale)
                                    : -INFINITY;
      xmax = fmaxf(xmax, x[j]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, off));
    const float n_loc = n_of_max(xmax);
    __syncthreads();  // the parts of w overwrite the scores
    float msum = 0.0f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float me, ne;
      repro::ext_exp(x[j], me, ne);
      const float w = __fmul_rn(me, repro::exp2_int(__fsub_rn(ne, n_loc)));
      msum = __fadd_rn(msum, w);
      put_parts(Wp + r * ldw + part * CPT + j, plane, w);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      msum = __fadd_rn(msum, __shfl_xor_sync(0xffffffffu, msum, off));
    if (part == 0) {
      const float n_old = n_acc[r];
      const float n_new = fmaxf(n_old, n_loc);
      const float ao = repro::exp2_int(__fsub_rn(n_old, n_new));
      const float al = repro::exp2_int(__fsub_rn(n_loc, n_new));
      m_acc[r] = __fadd_rn(__fmul_rn(m_acc[r], ao), __fmul_rn(msum, al));
      n_acc[r] = n_new;
      a_old[r] = ao;
      a_loc[r] = al;
    }
    __syncthreads();
    // o = o * a_old + (w v) * a_loc
    prod_parts<false>(Wp, ldw, plane, Vs, ld, BQ, a.Dp, BK, stage,
                      [&](int rr, int c, float val) {
                        float* p = Os + rr * ldo + c;
                        *p = __fadd_rn(__fmul_rn(*p, a_old[rr]),
                                       __fmul_rn(val, a_loc[rr]));
                      });
    __syncthreads();
  }
  wait_loads();  // also when no KV tile was visible
  for (int i = threadIdx.x; i < BQ * a.D; i += kThreads) {
    const int rr = i / a.D, c = i % a.D;
    if (q0 + rr < a.Sq)
      repro::store(o + (qrow + q0 + rr) * a.D + c,
                   __fdiv_rn(Os[rr * ldo + c], fmaxf(m_acc[rr], 1e-37f)));
  }
  for (int rr = threadIdx.x; rr < BQ; rr += kThreads) {
    if (q0 + rr < a.Sq) {
      m_out[qrow + q0 + rr] = m_acc[rr];
      n_out[qrow + q0 + rr] = n_acc[rr];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, shared: for this thread's columns of one (Q tile, KV tile),
// (p, ds) from the scores Ss and dp = do v^T in Ps; 0 where masked.
// ---------------------------------------------------------------------------
template <int BQ, int BK, typename F>
__device__ __forceinline__ void p_ds(const Attn& a, int q0, int k0,
                                     const float* Ss, const float* Ps,
                                     int lds, const float* n_sum,
                                     const float* inv, const float* delta,
                                     F put) {
  constexpr int TPR = kThreads / BQ;
  constexpr int CPT = BK / TPR;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = q0 + r;
  const bool row_ok = qi < a.Sq;
#pragma unroll 4
  for (int j = 0; j < CPT; ++j) {
    const int c = part * CPT + j;
    float p = 0.0f, ds = 0.0f;
    if (row_ok && visible(a, qi, k0 + c)) {
      float me, ne;
      repro::ext_exp(__fmul_rn(Ss[r * lds + c], a.scale), me, ne);
      p = __fmul_rn(__fmul_rn(me, repro::exp2_int(__fsub_rn(ne, n_sum[r]))),
                    inv[r]);
      ds = __fmul_rn(__fmul_rn(p, __fsub_rn(Ps[r * lds + c], delta[r])),
                     a.scale);
    }
    put(r, c, p, ds);
  }
}

// The per-row stats of Q tile q0 into shared memory: n_sum,
// 1 / max(m_sum, 1e-37) and delta (zeros past Sq).
template <int BQ>
__device__ __forceinline__ void load_rows(const float* m_sum,
                                          const float* n_sum,
                                          const float* delta, size_t qrow,
                                          int q0, int Sq, float* ns,
                                          float* inv, float* dl) {
  for (int rr = threadIdx.x; rr < BQ; rr += kThreads) {
    const bool ok = q0 + rr < Sq;
    const size_t i = qrow + q0 + rr;
    ns[rr] = ok ? n_sum[i] : 0.0f;
    inv[rr] = ok ? __frcp_rn(fmaxf(m_sum[i], 1e-37f)) : 0.0f;
    dl[rr] = ok ? delta[i] : 0.0f;
  }
}

template <typename T, int BQ, int BK>
struct BwdLayout {
  // dq: a = Q, b = dO (BQ rows), c = K, d = V (BK rows), acc0 = dQ;
  // dk/dv: a = K, b = V (BK rows), c = Q, d = dO (BQ rows), acc0 = dK,
  // acc1 = dV.
  size_t a, b, c, d, ss, ps, parts, acc0, acc1, stage, rows, total;
  __host__ __device__ BwdLayout(int Dp, bool dkv) {
    using P = Parts<T>;
    Carve cv;
    const int ld = ld_in<T>(Dp);
    const int ra = dkv ? BK : BQ, rc = dkv ? BQ : BK;
    a = cv.take(sizeof(T) * ra * ld);
    b = cv.take(sizeof(T) * ra * ld);
    c = cv.take(sizeof(T) * rc * ld);
    d = cv.take(sizeof(T) * rc * ld);
    ss = cv.take(4 * BQ * (BK + 4));
    ps = cv.take(4 * BQ * (BK + 4));
    parts = cv.take(sizeof(typename P::type) * P::n * BQ * (BK + P::pad));
    acc0 = cv.take(4 * ra * (Dp + 4));
    acc1 = dkv ? cv.take(4 * BK * (Dp + 4)) : acc0;
    stage = cv.take(4 * kWarps * 256);
    rows = cv.take(4 * 3 * BQ);
    total = cv.off;
  }
};

// dq.  grid (H, B, ceil(Sq / BQ)), Q tiles from the last.
template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ m_sum, const float* __restrict__ n_sum,
             const float* __restrict__ delta, T* __restrict__ dq, Attn a) {
  using P = Parts<T>;
  using PT = typename P::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout<T, BQ, BK> L(a.Dp, false);
  const int ld = ld_in<T>(a.Dp), lds = BK + 4, ldw = BK + P::pad,
            ldo = a.Dp + 4;
  T* Qs = reinterpret_cast<T*>(smem + L.a);
  T* dOs = reinterpret_cast<T*>(smem + L.b);
  T* Ks = reinterpret_cast<T*>(smem + L.c);
  T* Vs = reinterpret_cast<T*>(smem + L.d);
  float* Ss = reinterpret_cast<float*>(smem + L.ss);
  float* Ps = reinterpret_cast<float*>(smem + L.ps);
  PT* DSp = reinterpret_cast<PT*>(smem + L.parts);
  float* dQs = reinterpret_cast<float*>(smem + L.acc0);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* ns = reinterpret_cast<float*>(smem + L.rows);
  float* inv = ns + BQ;
  float* dl = inv + BQ;
  const size_t plane = static_cast<size_t>(BQ) * ldw;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (a.H / a.Hkv);
  const size_t qrow = (static_cast<size_t>(b) * a.H + h) * a.Sq;
  const size_t krow = (static_cast<size_t>(b) * a.Hkv + hk) * a.Skv;
  const T* qp = q + qrow * a.D;
  const T* dop = dout + qrow * a.D;
  const T* kp = k + krow * a.D;
  const T* vp = v + krow * a.D;
  const bool vk = aligned16(kp), vv = aligned16(vp);

  load_tile(qp, q0, BQ, a.Sq, a.D, a.Dp, Qs, ld, aligned16(qp));
  load_tile(dop, q0, BQ, a.Sq, a.D, a.Dp, dOs, ld, aligned16(dop));
  load_rows<BQ>(m_sum, n_sum, delta, qrow, q0, a.Sq, ns, inv, dl);
  for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) dQs[i] = 0.0f;
  int jlo, jhi;
  kv_tiles<BQ, BK>(a, q0, jlo, jhi);
  for (int jt = jlo; jt < jhi; ++jt) {
    const int k0 = jt * BK;
    load_tile(kp, k0, BK, a.Skv, a.D, a.Dp, Ks, ld, vk);
    load_tile(vp, k0, BK, a.Skv, a.D, a.Dp, Vs, ld, vv);
    wait_loads();
    prod_nt(Qs, ld, Ks, ld, BQ, BK, a.Dp, Ss, lds);
    prod_nt(dOs, ld, Vs, ld, BQ, BK, a.Dp, Ps, lds);
    __syncthreads();
    p_ds<BQ, BK>(a, q0, k0, Ss, Ps, lds, ns, inv, dl,
                 [&](int rr, int c, float, float ds) {
                   put_parts(DSp + rr * ldw + c, plane, ds);
                 });
    __syncthreads();
    prod_parts<false>(DSp, ldw, plane, Ks, ld, BQ, a.Dp, BK, stage,
                      [&](int rr, int c, float val) {
                        float* p = dQs + rr * ldo + c;
                        *p = __fadd_rn(*p, val);
                      });
    __syncthreads();
  }
  wait_loads();
  for (int i = threadIdx.x; i < BQ * a.D; i += kThreads) {
    const int rr = i / a.D, c = i % a.D;
    if (q0 + rr < a.Sq)
      repro::store(dq + (qrow + q0 + rr) * a.D + c, dQs[rr * ldo + c]);
  }
}

// dk, dv.  grid (Hkv, B, ceil(Skv / BK)); each block sums over the H / Hkv
// q-heads of its KV head, then over their Q tiles, in order.
template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ m_sum,
              const float* __restrict__ n_sum,
              const float* __restrict__ delta, T* __restrict__ dk,
              T* __restrict__ dv, Attn a) {
  using P = Parts<T>;
  using PT = typename P::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout<T, BQ, BK> L(a.Dp, true);
  const int ld = ld_in<T>(a.Dp), lds = BK + 4, ldw = BK + P::pad,
            ldo = a.Dp + 4;
  T* Ks = reinterpret_cast<T*>(smem + L.a);
  T* Vs = reinterpret_cast<T*>(smem + L.b);
  T* Qs = reinterpret_cast<T*>(smem + L.c);
  T* dOs = reinterpret_cast<T*>(smem + L.d);
  float* Ss = reinterpret_cast<float*>(smem + L.ss);
  float* Ps = reinterpret_cast<float*>(smem + L.ps);
  PT* Pp = reinterpret_cast<PT*>(smem + L.parts);
  float* dKs = reinterpret_cast<float*>(smem + L.acc0);
  float* dVs = reinterpret_cast<float*>(smem + L.acc1);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* ns = reinterpret_cast<float*>(smem + L.rows);
  float* inv = ns + BQ;
  float* dl = inv + BQ;
  const size_t plane = static_cast<size_t>(BQ) * ldw;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;
  const int G = a.H / a.Hkv;
  const size_t krow = (static_cast<size_t>(b) * a.Hkv + hk) * a.Skv;
  const T* kp = k + krow * a.D;
  const T* vp = v + krow * a.D;
  load_tile(kp, k0, BK, a.Skv, a.D, a.Dp, Ks, ld, aligned16(kp));
  load_tile(vp, k0, BK, a.Skv, a.D, a.Dp, Vs, ld, aligned16(vp));
  for (int i = threadIdx.x; i < BK * ldo; i += kThreads) {
    dKs[i] = 0.0f;
    dVs[i] = 0.0f;
  }
  int ilo, ihi;
  q_tiles<BQ, BK>(a, k0, ilo, ihi);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qrow = (static_cast<size_t>(b) * a.H + h) * a.Sq;
    const T* qp = q + qrow * a.D;
    const T* dop = dout + qrow * a.D;
    const bool vq = aligned16(qp), vd = aligned16(dop);
    for (int it = ilo; it < ihi; ++it) {
      const int q0 = it * BQ;
      load_tile(qp, q0, BQ, a.Sq, a.D, a.Dp, Qs, ld, vq);
      load_tile(dop, q0, BQ, a.Sq, a.D, a.Dp, dOs, ld, vd);
      load_rows<BQ>(m_sum, n_sum, delta, qrow, q0, a.Sq, ns, inv, dl);
      wait_loads();
      prod_nt(Qs, ld, Ks, ld, BQ, BK, a.Dp, Ss, lds);
      prod_nt(dOs, ld, Vs, ld, BQ, BK, a.Dp, Ps, lds);
      __syncthreads();
      // p's parts for dv; ds kept in place of dp (one thread per element)
      p_ds<BQ, BK>(a, q0, k0, Ss, Ps, lds, ns, inv, dl,
                   [&](int rr, int c, float p, float ds) {
                     put_parts(Pp + rr * ldw + c, plane, p);
                     Ps[rr * lds + c] = ds;
                   });
      __syncthreads();
      // dv += p^T do
      prod_parts<true>(Pp, ldw, plane, dOs, ld, BK, a.Dp, BQ, stage,
                       [&](int rr, int c, float val) {
                         float* p = dVs + rr * ldo + c;
                         *p = __fadd_rn(*p, val);
                       });
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
        const int rr = i / BK, c = i % BK;
        put_parts(Pp + rr * ldw + c, plane, Ps[rr * lds + c]);
      }
      __syncthreads();
      // dk += ds^T q
      prod_parts<true>(Pp, ldw, plane, Qs, ld, BK, a.Dp, BQ, stage,
                       [&](int rr, int c, float val) {
                         float* p = dKs + rr * ldo + c;
                         *p = __fadd_rn(*p, val);
                       });
      __syncthreads();
    }
  }
  wait_loads();
  for (int i = threadIdx.x; i < BK * a.D; i += kThreads) {
    const int rr = i / a.D, c = i % a.D;
    if (k0 + rr < a.Skv) {
      repro::store(dk + (krow + k0 + rr) * a.D + c, dKs[rr * ldo + c]);
      repro::store(dv + (krow + k0 + rr) * a.D + c, dVs[rr * ldo + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the tile shape is the first of (64, 64), (64, 32), (32, 32)
// whose shared memory fits the card at this D and dtype; it depends on
// nothing else, so the sum order (and the bits) depend on D only.
// ---------------------------------------------------------------------------
int max_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

template <typename T, int BQ, int BK>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       float* m, float* n, int B, const Attn& a,
                       cudaStream_t s) {
  const size_t bytes = FwdLayout<T, BQ, BK>(a.Dp).total;
  cudaError_t e = allow_smem(flash_fwd<T, BQ, BK>, bytes);
  if (e != cudaSuccess) return e;
  flash_fwd<T, BQ, BK><<<dim3(a.H, B, cdiv(a.Sq, BQ)), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, n, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_any(const void* q, const void* k, const void* v, void* o,
                    float* m, float* n, int B, const Attn& a, cudaStream_t s) {
  const size_t cap = static_cast<size_t>(max_smem());
  if (FwdLayout<T, 64, 64>(a.Dp).total <= cap)
    return fwd_launch<T, 64, 64>(q, k, v, o, m, n, B, a, s);
  if (FwdLayout<T, 64, 32>(a.Dp).total <= cap)
    return fwd_launch<T, 64, 32>(q, k, v, o, m, n, B, a, s);
  return fwd_launch<T, 32, 32>(q, k, v, o, m, n, B, a, s);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *m, *n, *delta;
  void *dq, *dk, *dv;
};

template <typename T, int BQ, int BK>
cudaError_t bwd_launch(const BwdArgs& g, int B, const Attn& a, bool dkv,
                       cudaStream_t s) {
  const size_t bytes = BwdLayout<T, BQ, BK>(a.Dp, dkv).total;
  const T* q = static_cast<const T*>(g.q);
  const T* k = static_cast<const T*>(g.k);
  const T* v = static_cast<const T*>(g.v);
  const T* d = static_cast<const T*>(g.dout);
  cudaError_t e;
  if (dkv) {
    e = allow_smem(flash_dkv<T, BQ, BK>, bytes);
    if (e != cudaSuccess) return e;
    flash_dkv<T, BQ, BK>
        <<<dim3(a.Hkv, B, cdiv(a.Skv, BK)), kThreads, bytes, s>>>(
            q, k, v, d, g.m, g.n, g.delta, static_cast<T*>(g.dk),
            static_cast<T*>(g.dv), a);
  } else {
    e = allow_smem(flash_dq<T, BQ, BK>, bytes);
    if (e != cudaSuccess) return e;
    flash_dq<T, BQ, BK><<<dim3(a.H, B, cdiv(a.Sq, BQ)), kThreads, bytes, s>>>(
        q, k, v, d, g.m, g.n, g.delta, static_cast<T*>(g.dq), a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_any(const BwdArgs& g, int B, const Attn& a, bool dkv,
                    cudaStream_t s) {
  const size_t cap = static_cast<size_t>(max_smem());
  if (BwdLayout<T, 64, 64>(a.Dp, dkv).total <= cap)
    return bwd_launch<T, 64, 64>(g, B, a, dkv, s);
  if (BwdLayout<T, 64, 32>(a.Dp, dkv).total <= cap)
    return bwd_launch<T, 64, 32>(g, B, a, dkv, s);
  return bwd_launch<T, 32, 32>(g, B, a, dkv, s);
}

bool make_attn(int H, int Hkv, int Sq, int Skv, int D, float scale,
               int causal, int window, Attn& a) {
  if (H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv < 0 || D < 8 ||
      D > kMaxD || D % 8)
    return false;
  a = Attn{H, Hkv, Sq, Skv, D, round16(D), scale, causal, window};
  return true;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o alike).  m_sum, n_sum
// float32 [B, H, Sq].
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* m_sum, void* n_sum, int B, int H, int Hkv,
                        int Sq, int Skv, int D, float scale, int causal,
                        int window, int dtype, void* stream) {
  Attn a;
  if (!make_attn(H, Hkv, Sq, Skv, D, scale, causal, window, a))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(m_sum);
  float* n = static_cast<float*>(n_sum);
  const cudaError_t e =
      dtype == 0 ? fwd_any<float>(q, k, v, o, m, n, B, a, s)
                 : fwd_any<bf16>(q, k, v, o, m, n, B, a, s);
  return static_cast<int>(e);
}

// which: 0 = dq [B, H, Sq, D]; 1 = dk, dv [B, Hkv, Skv, D].  delta =
// rowsum(do * o) float32 [B, H, Sq].
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* m_sum,
                        const void* n_sum, const void* delta, void* dq,
                        void* dk, void* dv, int B, int H, int Hkv, int Sq,
                        int Skv, int D, float scale, int causal, int window,
                        int which, int dtype, void* stream) {
  Attn a;
  if (!make_attn(H, Hkv, Sq, Skv, D, scale, causal, window, a) || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs g{q,
                  k,
                  v,
                  dout,
                  static_cast<const float*>(m_sum),
                  static_cast<const float*>(n_sum),
                  static_cast<const float*>(delta),
                  dq,
                  dk,
                  dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? bwd_any<float>(g, B, a, which == 1, s)
                                   : bwd_any<bf16>(g, B, a, which == 1, s);
  return static_cast<int>(e);
}

}  // extern "C"
