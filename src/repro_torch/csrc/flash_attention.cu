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
// Layouts: q, dq [B, H, Sq, D]; o, do [B, H, Sq, Dv]; k, dk [B, Hkv, Skv,
// D]; v, dv [B, Hkv, Skv, Dv], H a multiple of Hkv (GQA: q-head h reads KV
// head h / (H / Hkv), K/V are never repeated); stats and delta [B, H, Sq]
// float32; all contiguous.  D and Dv (v's head dim, which multi-head latent
// attention sets apart from D: 192 / 128 for deepseek-v2-lite) are each at
// most 256, any width; tiles are zero-filled to Dp / Dvp (D / Dv rounded
// up to 16) in shared memory, with scalar loads where a row is not a
// whole number of 16-byte groups, and ragged Sq / Skv edges are masked
// here, so nothing is padded in device memory.  Query row i sits at
// position i + Skv - Sq (the ends of the two sequences align), so a causal
// call with Sq > Skv has rows that see no key: their o, dq and stats are
// exact zeros (m_sum = 0, n_sum = -1e38).
//
// Design.  One block of 4 warps owns one tile of query rows (forward, dq)
// or key rows (dk/dv) and loops over the other axis inside the block: the
// loop replaces the TPU's sequential grid axis.  Every output element has
// one writer and every sum runs in a fixed order, so two runs give the same
// bits (no atomics).  dk/dv of a KV head sum over the H/Hkv q-heads of its
// group inside the block.  Tiles wholly past the causal diagonal or wholly
// outside the window are skipped: a masked tile folds in as the monoid's
// identity, so the skip changes no bit.
//
// Products.  q k^T and do v^T are bf16 x bf16 products, exact in float32,
// on the tensor cores with float32 accumulation.  w, p and ds are float32:
// rounding them to bf16 or TF32 would change the function, so each enters
// its product as three bf16 parts that sum to it exactly (hi + mid + lo),
// three tensor-core products.  Cost: the forward runs 1 + 3 products where
// the function needs 2; the backward 2 + 3 (dq) and 2 + 3 + 3 (dk/dv), 13
// where it needs 5.
//
// Which kernel runs, by dtype, D and Dv alone (never on a failure):
//   * forward, bf16 with Dv == D, D a multiple of 8 and rounded up to 16
//     at most 128 (every config the port trains): flash_fwd_mma.  64-row
//     Q tile, each warp 16 of its rows; s = q k^T in mma.sync accumulator
//     registers, scaled, masked and folded there (each row's (m, n) in
//     registers, the row's max and sum over the quad of lanes that holds
//     it), w's parts packed in place into
//     the A operand of o += w v, V read by ldmatrix.trans, o accumulated in
//     registers and written once; the K / V tiles double-buffered with
//     cp.async.  ~87 KB of shared memory: two blocks an SM;
//   * forward, float32, D in (128, 256], Dv != D or D not a multiple of 8:
//     flash_fwd, nvcuda::wmma 16x16x16 through shared memory, one cp.async
//     stage, with V, o and the P.V product in Dvp columns;
//   * backward, bf16 under the forward's mma condition: flash_dq_mma and
//     flash_dkv_mma.  64-row tiles on both axes, each warp 16 rows of the
//     block's own tile;
//     mma.sync.m16n8k16 with ldmatrix (.trans for the operands read along
//     their rows), so s^T = k q^T and dp^T = v do^T (dk/dv; s and dp for dq)
//     land in accumulator registers, p and ds are formed there, and their
//     parts are packed in place into the A operand of dv += p^T do,
//     dk += ds^T q (dq += ds k): two adjacent n8 accumulator tiles are one
//     k16 A fragment.  dk, dv and dq accumulate in registers and are written
//     once.  The block's own K / V (Q / dO) tiles are loaded once; the other
//     axis's tiles (with the Q tile's row stats) are double-buffered with
//     cp.async, the (q-head, Q tile) pairs of dk/dv as one sequence, so the
//     next tile's loads overlap this tile's math.  ~104 KB of shared memory
//     and at most 255 registers a thread (no spills): two blocks an SM;
//   * backward otherwise (float32 with FFMA, the kernel check's path):
//     flash_dq and flash_dkv, wmma through shared memory as the forward,
//     dO / V in Dvp columns, dv written in Dv.
//
// Bound on this card (B 1, H 40, Hkv 8, S 4096, D 128, bf16, causal):
// operations.  The forward's 2 products over the causal half are 1.7e11
// operations (0.174 ms at 989 TFLOP/s), and the 4 split products it runs
// 3.4e11 (0.348 ms); the backward's 5 are 4.3e11 (0.434 ms), and the 13
// split products it runs 1.1e12 (1.129 ms); bytes are ~0.1 GB (0.03 ms).
// The mma kernels run ExtExp and the part splitting (~25 CUDA-core
// operations a score in the forward) beside their tensor instructions.
// wgmma / TMA pipelines are later work.
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

// The problem, shared by every kernel.
struct Attn {
  int H, Hkv, Sq, Skv, D, Dp;
  float scale;
  int causal, window;  // window <= 0: none
  int Dv, Dvp;         // v's head dim; the mma kernels take Dv == D only
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
// Aligned 16-byte groups go by cp.async (waited for by the caller): `vec`
// says the matrix starts 16-byte aligned, and rows of a D that is no
// multiple of 16 bytes go element by element.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int nrows, int rows, int D, int Dp,
                                          T* dst, int ld, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int groups = Dp / kVec;
  vec = vec && D % kVec == 0;
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
  __host__ __device__ FwdLayout(int Dp, int Dvp) {
    using P = Parts<T>;
    Carve c;
    const int ld = ld_in<T>(Dp);
    qs = c.take(sizeof(T) * BQ * ld);
    // ks also holds the per-warp staging buffers while w v runs
    const size_t kb = sizeof(T) * BK * ld;
    ks = c.take(kb > 4 * kWarps * 256 ? kb : 4 * kWarps * 256);
    vs = c.take(sizeof(T) * BK * ld_in<T>(Dvp));
    // the scores, then (in the same bytes) the parts of w
    const size_t sb = 4 * BQ * (BK + 4);
    const size_t wb = sizeof(typename P::type) * P::n * BQ * (BK + P::pad);
    sw = c.take(sb > wb ? sb : wb);
    os = c.take(4 * BQ * (Dvp + 4));
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
  const FwdLayout<T, BQ, BK> L(a.Dp, a.Dvp);
  const int ld = ld_in<T>(a.Dp), ldv = ld_in<T>(a.Dvp), lds = BK + 4,
            ldw = BK + P::pad, ldo = a.Dvp + 4;
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
  const T* vp = v + krow * a.Dv;
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
    load_tile(vp, k0, BK, a.Skv, a.Dv, a.Dvp, Vs, ldv, vv);
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
    prod_parts<false>(Wp, ldw, plane, Vs, ldv, BQ, a.Dvp, BK, stage,
                      [&](int rr, int c, float val) {
                        float* p = Os + rr * ldo + c;
                        *p = __fadd_rn(__fmul_rn(*p, a_old[rr]),
                                       __fmul_rn(val, a_loc[rr]));
                      });
    __syncthreads();
  }
  wait_loads();  // also when no KV tile was visible
  for (int i = threadIdx.x; i < BQ * a.Dv; i += kThreads) {
    const int rr = i / a.Dv, c = i % a.Dv;
    if (q0 + rr < a.Sq)
      repro::store(o + (qrow + q0 + rr) * a.Dv + c,
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
// Backward, shared: p of one score from its row's n_sum and
// 1 / max(m_sum, 1e-37), and ds from p, dp and the row's delta.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float p_of(float s, float ns, float inv,
                                      float scale) {
  float me, ne;
  repro::ext_exp(__fmul_rn(s, scale), me, ne);
  return __fmul_rn(__fmul_rn(me, repro::exp2_int(__fsub_rn(ne, ns))), inv);
}
__device__ __forceinline__ float ds_of(float p, float dp, float dl,
                                       float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dl)), scale);
}

// For this thread's columns of one (Q tile, KV tile), (p, ds) from the
// scores Ss and dp = do v^T in Ps; 0 where masked.
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
      p = p_of(Ss[r * lds + c], n_sum[r], inv[r], a.scale);
      ds = ds_of(p, Ps[r * lds + c], delta[r], a.scale);
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
  // acc1 = dV.  a, c and acc0 are Dp wide; b, d and acc1 Dvp.
  size_t a, b, c, d, ss, ps, parts, acc0, acc1, stage, rows, total;
  __host__ __device__ BwdLayout(int Dp, int Dvp, bool dkv) {
    using P = Parts<T>;
    Carve cv;
    const int ld = ld_in<T>(Dp), ldv = ld_in<T>(Dvp);
    const int ra = dkv ? BK : BQ, rc = dkv ? BQ : BK;
    a = cv.take(sizeof(T) * ra * ld);
    b = cv.take(sizeof(T) * ra * ldv);
    c = cv.take(sizeof(T) * rc * ld);
    d = cv.take(sizeof(T) * rc * ldv);
    ss = cv.take(4 * BQ * (BK + 4));
    ps = cv.take(4 * BQ * (BK + 4));
    parts = cv.take(sizeof(typename P::type) * P::n * BQ * (BK + P::pad));
    acc0 = cv.take(4 * ra * (Dp + 4));
    acc1 = dkv ? cv.take(4 * BK * (Dvp + 4)) : acc0;
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
  const BwdLayout<T, BQ, BK> L(a.Dp, a.Dvp, false);
  const int ld = ld_in<T>(a.Dp), ldv = ld_in<T>(a.Dvp), lds = BK + 4,
            ldw = BK + P::pad, ldo = a.Dp + 4;
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
  const T* dop = dout + qrow * a.Dv;
  const T* kp = k + krow * a.D;
  const T* vp = v + krow * a.Dv;
  const bool vk = aligned16(kp), vv = aligned16(vp);

  load_tile(qp, q0, BQ, a.Sq, a.D, a.Dp, Qs, ld, aligned16(qp));
  load_tile(dop, q0, BQ, a.Sq, a.Dv, a.Dvp, dOs, ldv, aligned16(dop));
  load_rows<BQ>(m_sum, n_sum, delta, qrow, q0, a.Sq, ns, inv, dl);
  for (int i = threadIdx.x; i < BQ * ldo; i += kThreads) dQs[i] = 0.0f;
  int jlo, jhi;
  kv_tiles<BQ, BK>(a, q0, jlo, jhi);
  for (int jt = jlo; jt < jhi; ++jt) {
    const int k0 = jt * BK;
    load_tile(kp, k0, BK, a.Skv, a.D, a.Dp, Ks, ld, vk);
    load_tile(vp, k0, BK, a.Skv, a.Dv, a.Dvp, Vs, ldv, vv);
    wait_loads();
    prod_nt(Qs, ld, Ks, ld, BQ, BK, a.Dp, Ss, lds);
    prod_nt(dOs, ldv, Vs, ldv, BQ, BK, a.Dvp, Ps, lds);
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
  const BwdLayout<T, BQ, BK> L(a.Dp, a.Dvp, true);
  const int ld = ld_in<T>(a.Dp), ldv = ld_in<T>(a.Dvp), lds = BK + 4,
            ldw = BK + P::pad, ldo = a.Dp + 4, ldov = a.Dvp + 4;
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
  const T* vp = v + krow * a.Dv;
  load_tile(kp, k0, BK, a.Skv, a.D, a.Dp, Ks, ld, aligned16(kp));
  load_tile(vp, k0, BK, a.Skv, a.Dv, a.Dvp, Vs, ldv, aligned16(vp));
  for (int i = threadIdx.x; i < BK * ldo; i += kThreads) dKs[i] = 0.0f;
  for (int i = threadIdx.x; i < BK * ldov; i += kThreads) dVs[i] = 0.0f;
  int ilo, ihi;
  q_tiles<BQ, BK>(a, k0, ilo, ihi);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qrow = (static_cast<size_t>(b) * a.H + h) * a.Sq;
    const T* qp = q + qrow * a.D;
    const T* dop = dout + qrow * a.Dv;
    const bool vq = aligned16(qp), vd = aligned16(dop);
    for (int it = ilo; it < ihi; ++it) {
      const int q0 = it * BQ;
      load_tile(qp, q0, BQ, a.Sq, a.D, a.Dp, Qs, ld, vq);
      load_tile(dop, q0, BQ, a.Sq, a.Dv, a.Dvp, dOs, ldv, vd);
      load_rows<BQ>(m_sum, n_sum, delta, qrow, q0, a.Sq, ns, inv, dl);
      wait_loads();
      prod_nt(Qs, ld, Ks, ld, BQ, BK, a.Dp, Ss, lds);
      prod_nt(dOs, ldv, Vs, ldv, BQ, BK, a.Dvp, Ps, lds);
      __syncthreads();
      // p's parts for dv; ds kept in place of dp (one thread per element)
      p_ds<BQ, BK>(a, q0, k0, Ss, Ps, lds, ns, inv, dl,
                   [&](int rr, int c, float p, float ds) {
                     put_parts(Pp + rr * ldw + c, plane, p);
                     Ps[rr * lds + c] = ds;
                   });
      __syncthreads();
      // dv += p^T do
      prod_parts<true>(Pp, ldw, plane, dOs, ldv, BK, a.Dvp, BQ, stage,
                       [&](int rr, int c, float val) {
                         float* p = dVs + rr * ldov + c;
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
    if (k0 + rr < a.Skv)
      repro::store(dk + (krow + k0 + rr) * a.D + c, dKs[rr * ldo + c]);
  }
  for (int i = threadIdx.x; i < BK * a.Dv; i += kThreads) {
    const int rr = i / a.Dv, c = i % a.Dv;
    if (k0 + rr < a.Skv)
      repro::store(dv + (krow + k0 + rr) * a.Dv + c, dVs[rr * ldov + c]);
  }
}

// ---------------------------------------------------------------------------
// Forward and backward for bf16 inputs with Dp <= 128 (the header's
// design): mma.sync.m16n8k16 from registers, cp.async double buffering.
// ---------------------------------------------------------------------------
constexpr int kTile = 64;  // rows of every tile of the mma kernels

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of the
// i-th.  .trans hands each thread a column pair instead of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: A 16x16 row-major, B 16x8 column-major, bf16; c float32.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The hi, mid and lo bf16 parts of (x0, x1), each part a packed pair (x0 in
// the low half), into slot i of p[part][.]: hi + mid + lo == x exactly, as
// put_parts.
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&p)[3][4], int i) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float2 fh = __bfloat1622float2(hi);
  const float r0 = __fsub_rn(x0, fh.x), r1 = __fsub_rn(x1, fh.y);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const float2 fm = __bfloat1622float2(mid);
  p[0][i] = as_u32(hi);
  p[1][i] = as_u32(mid);
  p[2][i] = as_u32(__floats2bfloat162_rn(__fsub_rn(r0, fm.x),
                                         __fsub_rn(r1, fm.y)));
}

// c[NT] += A B^T for one warp: A the 16 rows at `a` (KS k16 steps), B the
// 8 NT rows at `b`, both row-major bf16 with leading dimension LD.
template <int KS, int NT, int LD>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const bf16* a,
                                       const bf16* b, int lane) {
  const unsigned pa = smem_u32(a + (lane & 15) * LD + (lane >> 4) * 8);
  const unsigned pb = smem_u32(b + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                               ((lane >> 3) & 1) * 8);
  // kk only moves the addresses: kept rolled, so that the compiler does not
  // hoist the loads of later steps into registers (spills in flash_dkv_mma)
#pragma unroll 1
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, pa + kk * 32);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, pb + (j * 8 * LD) * 2 + kk * 32);
      mma16816(c[j], af, bf[0], bf[1]);
      mma16816(c[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[ND] += X B for one warp: X 16 x (16 KS) float32 in the accumulator
// layout of 2 KS n8 tiles, entering as three bf16 parts; B the 16 KS rows
// at `b` (row-major bf16, leading dimension LD), read with ldmatrix.trans.
// Each element sums k16 steps in order, hi then mid then lo within a step.
template <int KS, int ND, int LD>
__device__ __forceinline__ void mma_parts(float (&acc)[ND][4],
                                          const float (&x)[2 * KS][4],
                                          const bf16* b, int lane) {
  const unsigned pb = smem_u32(b + (lane & 15) * LD + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[3][4];
    split_pair(x[2 * kk][0], x[2 * kk][1], af, 0);
    split_pair(x[2 * kk][2], x[2 * kk][3], af, 1);
    split_pair(x[2 * kk + 1][0], x[2 * kk + 1][1], af, 2);
    split_pair(x[2 * kk + 1][2], x[2 * kk + 1][3], af, 3);
#pragma unroll
    for (int j = 0; j < ND; j += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, pb + (kk * 16 * LD + j * 8) * 2);
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        mma16816(acc[j], af[part], bf[0], bf[1]);
        mma16816(acc[j + 1], af[part], bf[2], bf[3]);
      }
    }
  }
}

// The rows of one warp's output in accumulator layout into dst [rows, D]
// (rows from r0, this warp's 16 at r0 + 16 warp), bf16 pairs.
template <int ND>
__device__ __forceinline__ void store_acc(const float (&acc)[ND][4],
                                          bf16* dst, int r0, int rows,
                                          int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + warp * 16 + (lane >> 2) + half * 8;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(r) * D +
                                           c) =
            __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// The mma kernels, as the C interface's `which` names them.
enum MmaKernel { kDq = 0, kDkv = 1, kFwd = 2 };

// Shared memory of the mma kernels: 64-row bf16 tiles (the block's own --
// Q and dO for dq, K and V for dk/dv, Q for the forward -- then two stages
// of the other axis's two) and, for dk/dv, two stages of the Q tile's row
// stats.
template <int DP>
struct MmaLayout {
  static constexpr int ld = DP + 8;  // 16-byte pad: ldmatrix conflict-free
  static constexpr int tile = kTile * ld;  // elements
  static constexpr size_t bytes(int which) {
    return (which == kFwd ? 5 : 6) * sizeof(bf16) * tile +
           (which == kDkv ? 2 * 3 * kTile * sizeof(float) : 0);
  }
};

// dk, dv.  grid (Hkv, B, ceil(Skv / 64)), KV tile 0 first (under causal
// masking the busiest).  Warp w owns KV rows k0 + 16 w ..: s^T = k q^T and
// dp^T = v do^T in registers, then dv += p^T do and dk += ds^T q.  The
// (q-head g, Q tile) pairs of the group run as one sequence, double-
// buffered across head boundaries too.
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ m_sum,
                  const float* __restrict__ n_sum,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, Attn a) {
  using L = MmaLayout<DP>;
  constexpr int BQ = kTile, BK = kTile, LD = L::ld, TILE = L::tile;
  constexpr int NT = BQ / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE;
  bf16* stages = Vs + TILE;  // stage s: Q at 2 s TILE, dO after it
  // stage s: n_sum, m_sum (then 1 / max(m_sum, 1e-37)), delta
  float* rows = reinterpret_cast<float*>(stages + 4 * TILE);

  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BK;
  const int G = a.H / a.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t krow = (static_cast<size_t>(b) * a.Hkv + hk) * a.Skv;
  int ilo, ihi;
  q_tiles<BQ, BK>(a, k0, ilo, ihi);
  const int nq = ihi - ilo, n = G * nq;

  // Q, dO and row stats of step i into stage i & 1; thread r < BQ copies
  // row r's stats, so after its own wait it may rewrite them.
  auto prefetch = [&](int i) {
    const int q0 = (ilo + i % nq) * BQ;
    const size_t qrow = (static_cast<size_t>(b) * a.H + hk * G + i / nq) *
                        a.Sq;
    bf16* Qs = stages + (i & 1) * 2 * TILE;
    const bf16* qp = q + qrow * a.D;
    const bf16* dop = dout + qrow * a.D;
    load_tile(qp, q0, BQ, a.Sq, a.D, DP, Qs, LD, aligned16(qp));
    load_tile(dop, q0, BQ, a.Sq, a.D, DP, Qs + TILE, LD, aligned16(dop));
    float* st = rows + (i & 1) * 3 * BQ;
    const int r = threadIdx.x;
    if (r < BQ) {
      if (q0 + r < a.Sq) {
        cp_async4(st + r, n_sum + qrow + q0 + r);
        cp_async4(st + BQ + r, m_sum + qrow + q0 + r);
        cp_async4(st + 2 * BQ + r, delta + qrow + q0 + r);
      } else {
        st[r] = st[BQ + r] = st[2 * BQ + r] = 0.0f;
      }
    }
  };

  float dK[ND][4] = {}, dV[ND][4] = {};
  if (n > 0) {
    const bf16* kp = k + krow * a.D;
    const bf16* vp = v + krow * a.D;
    load_tile(kp, k0, BK, a.Skv, a.D, DP, Ks, LD, aligned16(kp));
    load_tile(vp, k0, BK, a.Skv, a.D, DP, Vs, LD, aligned16(vp));
    prefetch(0);
  }
  cp_async_commit();
  const int kr = k0 + warp * 16 + (lane >> 2);  // this thread's KV rows
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    const int q0 = (ilo + i % nq) * BQ;
    float* st = rows + (i & 1) * 3 * BQ;
    if (threadIdx.x < BQ) {
      const int r = threadIdx.x;
      st[BQ + r] =
          q0 + r < a.Sq ? __frcp_rn(fmaxf(st[BQ + r], 1e-37f)) : 0.0f;
    }
    __syncthreads();
    const bf16* Qs = stages + (i & 1) * 2 * TILE;
    const bf16* dOs = Qs + TILE;
    // p^T in place of s^T (0 where masked), then dv += p^T do; dp^T only
    // after that, so that s^T, dp^T and the parts are never live together
    float s[NT][4] = {};
    mma_nt<DP / 16, NT, LD>(s, Ks + warp * 16 * LD, Qs, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + (lane & 3) * 2 + (e & 1);
        const int qi = q0 + c;
        s[j][e] = qi < a.Sq && visible(a, qi, kr + (e >> 1) * 8)
                      ? p_of(s[j][e], st[c], st[BQ + c], a.scale)
                      : 0.0f;
      }
    }
    mma_parts<BQ / 16, ND, LD>(dV, s, dOs, lane);
    // ds^T = p^T (dp^T - delta) scale in place of dp^T: zero where p^T
    // is masked
    float dp[NT][4] = {};
    mma_nt<DP / 16, NT, LD>(dp, Vs + warp * 16 * LD, dOs, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + (lane & 3) * 2 + (e & 1);
        dp[j][e] = ds_of(s[j][e], dp[j][e], st[2 * BQ + c], a.scale);
      }
    }
    mma_parts<BQ / 16, ND, LD>(dK, dp, Qs, lane);
    __syncthreads();
  }
  cp_async_wait<0>();
  store_acc(dK, dk + krow * a.D, k0, a.Skv, a.D);
  store_acc(dV, dv + krow * a.D, k0, a.Skv, a.D);
}

// dq.  grid (H, B, ceil(Sq / 64)), Q tiles from the last.  Warp w owns Q
// rows q0 + 16 w ..: s = q k^T and dp = do v^T in registers, then
// dq += ds k; the K / V tiles are double-buffered.
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ m_sum,
                 const float* __restrict__ n_sum,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 Attn a) {
  using L = MmaLayout<DP>;
  constexpr int BQ = kTile, BK = kTile, LD = L::ld, TILE = L::tile;
  constexpr int NT = BK / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE;
  bf16* stages = dOs + TILE;  // stage s: K at 2 s TILE, V after it

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / (a.H / a.Hkv);
  const size_t qrow = (static_cast<size_t>(b) * a.H + h) * a.Sq;
  const size_t krow = (static_cast<size_t>(b) * a.Hkv + hk) * a.Skv;
  const bf16* kp = k + krow * a.D;
  const bf16* vp = v + krow * a.D;
  const bool vk = aligned16(kp), vv = aligned16(vp);
  int jlo, jhi;
  kv_tiles<BQ, BK>(a, q0, jlo, jhi);
  const int n = jhi - jlo;

  // this thread's two rows: n_sum, 1 / max(m_sum, 1e-37), delta
  const int qr = q0 + warp * 16 + (lane >> 2);
  float ns[2], inv[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qi = qr + e * 8;
    const bool ok = qi < a.Sq;
    ns[e] = ok ? n_sum[qrow + qi] : 0.0f;
    inv[e] = ok ? __frcp_rn(fmaxf(m_sum[qrow + qi], 1e-37f)) : 0.0f;
    dl[e] = ok ? delta[qrow + qi] : 0.0f;
  }

  auto prefetch = [&](int i) {
    const int k0 = (jlo + i) * BK;
    bf16* Ks = stages + (i & 1) * 2 * TILE;
    load_tile(kp, k0, BK, a.Skv, a.D, DP, Ks, LD, vk);
    load_tile(vp, k0, BK, a.Skv, a.D, DP, Ks + TILE, LD, vv);
  };

  float dQ[ND][4] = {};
  if (n > 0) {
    const bf16* qp = q + qrow * a.D;
    const bf16* dop = dout + qrow * a.D;
    load_tile(qp, q0, BQ, a.Sq, a.D, DP, Qs, LD, aligned16(qp));
    load_tile(dop, q0, BQ, a.Sq, a.D, DP, dOs, LD, aligned16(dop));
    prefetch(0);
  }
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = (jlo + i) * BK;
    const bf16* Ks = stages + (i & 1) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    float s[NT][4] = {}, dp[NT][4] = {};
    mma_nt<DP / 16, NT, LD>(s, Qs + warp * 16 * LD, Ks, lane);
    mma_nt<DP / 16, NT, LD>(dp, dOs + warp * 16 * LD, Vs, lane);
    // ds in place of s; 0 where masked
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qi = qr + r * 8;
        s[j][e] = qi < a.Sq && visible(a, qi, k0 + j * 8 + (lane & 3) * 2 +
                                                  (e & 1))
                      ? ds_of(p_of(s[j][e], ns[r], inv[r], a.scale),
                              dp[j][e], dl[r], a.scale)
                      : 0.0f;
      }
    }
    mma_parts<BK / 16, ND, LD>(dQ, s, Ks, lane);
    __syncthreads();
  }
  cp_async_wait<0>();
  store_acc(dQ, dq + qrow * a.D, q0, a.Sq, a.D);
}

// Forward.  grid (H, B, ceil(Sq / 64)), Q tiles from the last.  Warp w owns
// Q rows q0 + 16 w ..; each thread holds two of them (the quad of lanes
// 4 r .. 4 r + 3 shares rows r and r + 8) with their (m_acc, n_acc).  Per
// KV tile: s = q k^T in registers, scaled and masked; n_new = max(n_acc,
// n of the row's largest score); w = m 2^(n - n_new) in place of s; o =
// o 2^(n_acc - n_new) + w v.  flash_fwd weighs w against the tile's own
// n_loc and rescales w v by 2^(n_loc - n_new) afterwards: a power-of-two
// rescale is exact in the normal range, so the two differ only where a
// term lies more than 2^126 below its row's largest (subnormal or flushed
// here), far inside the kernel checks' limits.  The K / V tiles are
// double-buffered.
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ n_out,
                  Attn a) {
  using L = MmaLayout<DP>;
  constexpr int BQ = kTile, BK = kTile, LD = L::ld, TILE = L::tile;
  constexpr int NT = BK / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* stages = Qs + TILE;  // stage s: K at 2 s TILE, V after it

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / (a.H / a.Hkv);
  const size_t qrow = (static_cast<size_t>(b) * a.H + h) * a.Sq;
  const size_t krow = (static_cast<size_t>(b) * a.Hkv + hk) * a.Skv;
  const bf16* kp = k + krow * a.D;
  const bf16* vp = v + krow * a.D;
  const bool vk = aligned16(kp), vv = aligned16(vp);
  int jlo, jhi;
  kv_tiles<BQ, BK>(a, q0, jlo, jhi);
  const int n = jhi - jlo;

  auto prefetch = [&](int i) {
    const int k0 = (jlo + i) * BK;
    bf16* Ks = stages + (i & 1) * 2 * TILE;
    load_tile(kp, k0, BK, a.Skv, a.D, DP, Ks, LD, vk);
    load_tile(vp, k0, BK, a.Skv, a.D, DP, Ks + TILE, LD, vv);
  };

  float oacc[ND][4] = {};
  float m_acc[2] = {0.0f, 0.0f};
  float n_acc[2] = {repro::kMinusInfN, repro::kMinusInfN};
  if (n > 0) {
    const bf16* qp = q + qrow * a.D;
    load_tile(qp, q0, BQ, a.Sq, a.D, DP, Qs, LD, aligned16(qp));
    prefetch(0);
  }
  cp_async_commit();
  const int qr = q0 + warp * 16 + (lane >> 2);  // this thread's rows qr, +8
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = (jlo + i) * BK;
    const bf16* Ks = stages + (i & 1) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    float s[NT][4] = {};
    mma_nt<DP / 16, NT, LD>(s, Qs + warp * 16 * LD, Ks, lane);
    // scaled, -inf where masked; each row's largest over its quad
    float xmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kj = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
        s[j][e] = visible(a, qr + r * 8, kj) ? __fmul_rn(s[j][e], a.scale)
                                             : -INFINITY;
        xmax[r] = fmaxf(xmax[r], s[j][e]);
      }
    }
    float n_new[2], a_old[2], msum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        xmax[r] = fmaxf(xmax[r], __shfl_xor_sync(0xffffffffu, xmax[r], off));
      n_new[r] = fmaxf(n_acc[r], n_of_max(xmax[r]));
      a_old[r] = repro::exp2_int(__fsub_rn(n_acc[r], n_new[r]));
    }
    // w in place of s (0 where masked), summed over the thread's columns
    // in order, then over the quad: addition commutes, so the four lanes
    // get the same bits
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float me, ne;
        repro::ext_exp(s[j][e], me, ne);
        s[j][e] = __fmul_rn(me, repro::exp2_int(__fsub_rn(ne, n_new[r])));
        msum[r] = __fadd_rn(msum[r], s[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        msum[r] =
            __fadd_rn(msum[r], __shfl_xor_sync(0xffffffffu, msum[r], off));
      m_acc[r] = __fadd_rn(__fmul_rn(m_acc[r], a_old[r]), msum[r]);
      n_acc[r] = n_new[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oacc[j][e] = __fmul_rn(oacc[j][e], a_old[e >> 1]);
    }
    mma_parts<BK / 16, ND, LD>(oacc, s, Vs, lane);
    __syncthreads();
  }
  cp_async_wait<0>();  // also when no KV tile was visible
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      oacc[j][e] = __fdiv_rn(oacc[j][e], fmaxf(m_acc[e >> 1], 1e-37f));
  }
  store_acc(oacc, o + qrow * a.D, q0, a.Sq, a.D);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qr + r * 8;
      if (qi < a.Sq) {
        m_out[qrow + qi] = m_acc[r];
        n_out[qrow + qi] = n_acc[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: bf16 with Dp <= 128 takes the mma kernels, forward and
// backward (64-row tiles).  Else the tile shape of flash_fwd, flash_dq and
// flash_dkv is the first of (64, 64), (64, 32), (32, 32) whose shared
// memory fits the card at this D and dtype.  Either choice depends on
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

// The mma kernel `which` at DP, its shared memory set (and the carveout at
// its largest, so that two blocks fit an SM).
template <int DP>
cudaError_t mma_prepare(int which, const void*& f, size_t& bytes) {
  f = which == kFwd   ? reinterpret_cast<const void*>(&flash_fwd_mma<DP>)
      : which == kDkv ? reinterpret_cast<const void*>(&flash_dkv_mma<DP>)
                      : reinterpret_cast<const void*>(&flash_dq_mma<DP>);
  bytes = MmaLayout<DP>::bytes(which);
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

template <typename T, int BQ, int BK>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       float* m, float* n, int B, const Attn& a,
                       cudaStream_t s) {
  const size_t bytes = FwdLayout<T, BQ, BK>(a.Dp, a.Dvp).total;
  cudaError_t e = allow_smem(flash_fwd<T, BQ, BK>, bytes);
  if (e != cudaSuccess) return e;
  flash_fwd<T, BQ, BK><<<dim3(a.H, B, cdiv(a.Sq, BQ)), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, n, a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t fwd_mma_launch(const void* q, const void* k, const void* v,
                           void* o, float* m, float* n, int B, const Attn& a,
                           cudaStream_t s) {
  const void* f;
  size_t bytes;
  cudaError_t e = mma_prepare<DP>(kFwd, f, bytes);
  if (e != cudaSuccess) return e;
  flash_fwd_mma<DP><<<dim3(a.H, B, cdiv(a.Sq, kTile)), kThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), m, n, a);
  return cudaGetLastError();
}

// The mma kernels take bf16 with Dv == D, D a multiple of 8 and Dp <= 128.
bool mma_ok(const Attn& a) {
  return a.Dv == a.D && a.D % 8 == 0 && a.Dp <= 128;
}

// bf16 under mma_ok takes the mma forward; everything else flash_fwd, its
// tile the largest whose shared memory (D and Dv both) fits.  The choice
// reads the dtype, D and Dv only.
template <typename T>
cudaError_t fwd_any(const void* q, const void* k, const void* v, void* o,
                    float* m, float* n, int B, const Attn& a, cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (mma_ok(a) && a.Dp <= 64)
      return fwd_mma_launch<64>(q, k, v, o, m, n, B, a, s);
    if (mma_ok(a)) return fwd_mma_launch<128>(q, k, v, o, m, n, B, a, s);
  }
  const size_t cap = static_cast<size_t>(max_smem());
  if (FwdLayout<T, 64, 64>(a.Dp, a.Dvp).total <= cap)
    return fwd_launch<T, 64, 64>(q, k, v, o, m, n, B, a, s);
  if (FwdLayout<T, 64, 32>(a.Dp, a.Dvp).total <= cap)
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
  const size_t bytes = BwdLayout<T, BQ, BK>(a.Dp, a.Dvp, dkv).total;
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

template <int DP>
cudaError_t mma_launch(const BwdArgs& g, int B, const Attn& a, bool dkv,
                       cudaStream_t s) {
  const void* f;
  size_t bytes;
  cudaError_t e = mma_prepare<DP>(dkv ? kDkv : kDq, f, bytes);
  if (e != cudaSuccess) return e;
  const bf16* q = static_cast<const bf16*>(g.q);
  const bf16* k = static_cast<const bf16*>(g.k);
  const bf16* v = static_cast<const bf16*>(g.v);
  const bf16* d = static_cast<const bf16*>(g.dout);
  if (dkv)
    flash_dkv_mma<DP><<<dim3(a.Hkv, B, cdiv(a.Skv, kTile)), kThreads, bytes,
                        s>>>(q, k, v, d, g.m, g.n, g.delta,
                             static_cast<bf16*>(g.dk),
                             static_cast<bf16*>(g.dv), a);
  else
    flash_dq_mma<DP><<<dim3(a.H, B, cdiv(a.Sq, kTile)), kThreads, bytes, s>>>(
        q, k, v, d, g.m, g.n, g.delta, static_cast<bf16*>(g.dq), a);
  return cudaGetLastError();
}

// bf16 under mma_ok takes the mma backward; everything else the wmma /
// FFMA kernels above, as the forward chooses.
template <typename T>
cudaError_t bwd_any(const BwdArgs& g, int B, const Attn& a, bool dkv,
                    cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (mma_ok(a) && a.Dp <= 64) return mma_launch<64>(g, B, a, dkv, s);
    if (mma_ok(a)) return mma_launch<128>(g, B, a, dkv, s);
  }
  const size_t cap = static_cast<size_t>(max_smem());
  if (BwdLayout<T, 64, 64>(a.Dp, a.Dvp, dkv).total <= cap)
    return bwd_launch<T, 64, 64>(g, B, a, dkv, s);
  if (BwdLayout<T, 64, 32>(a.Dp, a.Dvp, dkv).total <= cap)
    return bwd_launch<T, 64, 32>(g, B, a, dkv, s);
  return bwd_launch<T, 32, 32>(g, B, a, dkv, s);
}

bool make_attn(int H, int Hkv, int Sq, int Skv, int D, int Dv, float scale,
               int causal, int window, Attn& a) {
  if (H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv < 0 || D < 1 ||
      D > kMaxD || Dv < 1 || Dv > kMaxD)
    return false;
  a = Attn{H, Hkv, Sq, Skv, D, round16(D), scale, causal, window, Dv,
           round16(Dv)};
  return true;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o alike).  o [B, H, Sq, Dv];
// m_sum, n_sum float32 [B, H, Sq].
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* m_sum, void* n_sum, int B, int H, int Hkv,
                        int Sq, int Skv, int D, int Dv, float scale,
                        int causal, int window, int dtype, void* stream) {
  Attn a;
  if (!make_attn(H, Hkv, Sq, Skv, D, Dv, scale, causal, window, a))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(m_sum);
  float* n = static_cast<float*>(n_sum);
  const cudaError_t e =
      dtype == 0 ? fwd_any<float>(q, k, v, o, m, n, B, a, s)
                 : fwd_any<bf16>(q, k, v, o, m, n, B, a, s);
  return static_cast<int>(e);
}

// which: 0 = dq [B, H, Sq, D]; 1 = dk [B, Hkv, Skv, D], dv [B, Hkv, Skv,
// Dv].  dout [B, H, Sq, Dv]; delta = rowsum(do * o) float32 [B, H, Sq].
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* m_sum,
                        const void* n_sum, const void* delta, void* dq,
                        void* dk, void* dv, int B, int H, int Hkv, int Sq,
                        int Skv, int D, int Dv, float scale, int causal,
                        int window, int which, int dtype, void* stream) {
  Attn a;
  if (!make_attn(H, Hkv, Sq, Skv, D, Dv, scale, causal, window, a) ||
      Skv <= 0)
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

// Blocks an SM of the mma kernel for bf16 at head dim D (which: 0 = dq,
// 1 = dk/dv, 2 = forward), or -1 where that dtype and D take the other
// kernels or the query fails.
int flash_attention_blocks_per_sm(int D, int which) {
  const void* f;
  size_t bytes;
  cudaError_t e;
  if (D < 8 || D % 8 || round16(D) > 128 || which < kDq || which > kFwd)
    return -1;
  e = round16(D) <= 64 ? mma_prepare<64>(which, f, bytes)
                       : mma_prepare<128>(which, f, bytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, kThreads,
                                                      bytes);
  return e == cudaSuccess ? blocks : -1;
}

}  // extern "C"
