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
// Design.  With bf16 h and w the forward computes its logits in 128 x 256
// tiles on the backward's wgmma core (below: the dlogits kernel's
// instantiation, boxes and k order, so each logit is the same float32 sum
// in the forward and in the backward), in a persistent kernel
// (lmhead_fwd_bf16: one block an SM, the token tiles of a w tile
// adjacent).  Each tile is folded where wgmma leaves it, in registers:
// each lane's 64 columns of a row max-first, then the row's four lanes by
// shuffles, into one (m, n, ll) partial a row ([V/256, T] float32
// scratch).  With float32 h and w: FFMA, 8 x 8 outputs a thread of 128 x
// 128 tiles (ffma_tile), folded from shared memory into 128-column
// partials.  A second kernel folds the partials of a row in vocab order:
// no atomics.
//
// The backward cannot keep a whole (T_tile, D) dh tile or (D, V_tile) dw
// tile on chip at D = 5120 (a 128-column dw tile is 2.6 MB of float32), and
// each recomputed logit needs the full D reduction.  So it takes a vocab
// slab at a time (block_v columns, 8192 at full width): one kernel writes
// the slab's dlogits to scratch, once for both products, then one product
// adds dlogits @ w_slab^T into dh and another writes h^T @ dlogits into
// dw[:, slab].  The dlogits are float32 and these products keep float32
// accuracy, never TF32 or a bf16 rounding of the dlogits: with bf16 h and
// w each dlogit is written as three bf16 parts that sum to it exactly
// (split3) and the products run on the tensor cores, one per part, all
// summed in float32; with float32 h and w the dlogits stay float32 and the
// products are FFMA.  dh [T, D] has only 80 tiles of 128 x 256 at full
// width, so its slab product is split along the slab's columns into
// partial products that a small kernel adds in split order.  Each output
// element is written by one thread in a fixed order: the same bits on
// every run.
//
// With bf16 h and w the backward's three products (the logit tile of the
// dlogits kernel, dh's and dw's) and the forward's logit tile run on one
// core for Hopper, wg_tile:
// wgmma.mma_async from swizzled shared memory, a ring of k tiles filled by
// a producer warp (TMA, or cp.async where rows are not 16-byte aligned)
// for two consumer warpgroups, float32 accumulators in registers written
// out in rows of four (quads).  Its grids put the token tiles that share a
// w tile next to each other, so a call reads each w tile from memory about
// once.
//
// Bound on this card: operations.  At T = 512, D = 5120, V = 152064 each
// logit product is 2 T D V = 0.80 TFLOP (0.81 ms on the bf16 tensor cores
// at 989 TFLOP/s); dh and dw each add three such products of the split
// dlogits (2.4 TFLOP, 2.4 ms), so dh alone or dw alone is 3.2 ms and both
// from one dlogits pass 5.7 ms.  Bytes: w is 1.56 GB (bf16), dw is 3.1 GB
// (float32).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "extexp.cuh"
#include "rowfold.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::to_f32;

// ln2 as the TPU kernel rounds LN2_HI + LN2_LO to float32.
constexpr float kLn2 = 0x1.62E430p-1f;

// The float32 kernels (FFMA)
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kTile = 128;     // output tile: 128 x 128
constexpr int kCsLd = kTile + 4;
constexpr int kBk = 32;        // the k-split step of dh's slab product
constexpr int kFk = 8;         // FFMA k tile
constexpr int kFLd = kTile + 4;

constexpr int kLogitSmemBytes = kTile * kCsLd * 4;  // the f32 logit tile
constexpr int kFfmaSmemBytes = 2 * kFk * kFLd * 4;
static_assert(kFfmaSmemBytes <= kLogitSmemBytes, "smem");

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

// Forward, float32 h and w, step 1: grid (ceil(V / 128), ceil(T / 128)).
// Each block folds its tile's 128 columns per row into (m, n) and the
// label logit: two threads a row, 64 columns each in order, then one
// (m, n) add.
__global__ void __launch_bounds__(kThreads)
    lmhead_fwd_tiles(const float* __restrict__ h, const float* __restrict__ w,
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

// Forward, step 2: one thread a row folds the partials in vocab order
// (unrolled, so that the loads of later tiles are in flight while the
// fold runs).
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
#pragma unroll 8
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
// float32.
__device__ __forceinline__ void split3(float x, bf16& hi, bf16& mid,
                                       bf16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(hi));
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
}

// ---------------------------------------------------------------------------
// The bf16 product core of the backward and the forward, on Hopper's
// warpgroup MMA:
// acc[128 x 256] += sum over parts of A_p B_p over a k range, float32.
//
// Two consumer warpgroups a block, 64 output rows each, issue
// wgmma.mma_async m64n256k16 with both operands in shared memory.  Each
// k tile (BK deep) of every operand is one tile in a swizzled layout that
// the wgmma descriptors name:
//   * K-major (k contiguous in memory), BK = 64: row r (an m or n index)
//     of 128 bytes at r * 128, its 16-byte chunk c (k in [8c, 8c + 8)) at
//     chunk c ^ (r % 8) (128-byte swizzle, 8-row groups 1024 bytes apart);
//     BK = 32: rows of 64 bytes, chunk c at c ^ ((r / 2) % 4) (64-byte
//     swizzle, 8-row groups 512 bytes apart);
//   * MN-major (m or n contiguous), 128-byte swizzle: 64-column atoms of
//     BK k rows, BK * 128 bytes apart (LBO); k row at (k / 8) * 1024 +
//     (k % 8) * 128 (SBO 1024), chunk (mn % 64) / 8 ^ (k % 8).
// A ring of STAGES such k tiles is filled by a producer warp and read by
// two consumer warpgroups, handed back and forth by mbarriers (wg_tile).
// The producer fills a slot with TMA (one thread; the tensor maps name the
// same swizzle) where every operand's rows are 16-byte aligned, else with
// cp.async (TileLoader).  A split operand's parts share the other
// operand's tile: it is loaded once a k step.  Each output element is the
// sum of its products in one fixed order: the same bits on every run, by
// either loader.
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 256;  // two consumer warpgroups of 64 rows
constexpr int kProducers = 32;   // one warp that fills the ring
constexpr int kBlockThreads = kWgThreads + kProducers;
constexpr int kWgBm = 128;
constexpr int kBn = 256;         // output columns: one m64n256k16 a k step

template <int NA, int NB, int STAGES, int BK>
struct WgCore {
  static_assert(BK == 32 || BK == 64, "k tiles of 64 or 128 bytes");
  static constexpr int kATile = kWgBm * BK * 2;  // bytes of a k tile
  static constexpr int kBTile = kBn * BK * 2;
  static constexpr int kStage = NA * kATile + NB * kBTile;
  // + 1024 for alignment and 128 for the ring's mbarriers
  static constexpr int kSmem = STAGES * kStage + 1024 + 128;
  static_assert(STAGES >= 2, "a slot filled while another is read");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BK>
__device__ __forceinline__ uint32_t kmajor_off(int r, int c) {
  if constexpr (BK == 64) return r * 128 + ((c ^ (r & 7)) << 4);
  else return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

template <int BK>
__device__ __forceinline__ uint32_t mnmajor_off(int k, int cm) {
  return (cm >> 3) * (BK * 128) + (k >> 3) * 1024 + (k & 7) * 128 +
         (((cm & 7) ^ (k & 7)) << 4);
}

// Elements [c, c + 8) of row r of m into the 16 bytes at dst (shared),
// element by element (rows not 16-byte aligned), zeros outside m.
__device__ __forceinline__ void chunk16(const Mat& m, long long r,
                                        long long c, unsigned char* dst) {
  const bool in = r < m.rows;
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long c0 = c + 2 * e;
    const uint32_t lo =
        in && c0 < m.cols ? __bfloat16_as_ushort(m.p[r * m.ld + c0]) : 0u;
    const uint32_t hi =
        in && c0 + 1 < m.cols ? __bfloat16_as_ushort(m.p[r * m.ld + c0 + 1])
                              : 0u;
    v[e] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// One producer lane's 16-byte chunks of an operand's BK-deep k tiles,
// EXTENT rows (m or n) each.  Chunk j of tile kt is the 8 elements at
// (row + j kDr, col) of the matrix in memory, k tile kt adding BK to row
// (MN-major) or to col (K-major), stored at off(j) of the tile.  One
// cp.async each, zero-filled past the matrix, where m's rows are 16-byte
// aligned; element by element where they are not.
template <int EXTENT, bool MN, int BK>
struct TileLoader {
  static constexpr int kPerRow = MN ? EXTENT / 8 : BK / 8;  // chunks a row
  static constexpr int kJ = EXTENT * BK / 8 / kProducers;  // chunks a thread
  static constexpr int kDr = kProducers / kPerRow;   // rows from j to j + 1
  long long row, col;
  int tr, tc;

  __device__ __forceinline__ TileLoader(long long mn0, int tid) {
    tr = tid / kPerRow;
    tc = tid % kPerRow;
    row = MN ? tr : mn0 + tr;
    col = MN ? mn0 + 8 * tc : 8 * tc;
  }

  __device__ __forceinline__ uint32_t off(int j) const {
    return MN ? mnmajor_off<BK>(tr + j * kDr, tc)
              : kmajor_off<BK>(tr + j * kDr, tc);
  }

  __device__ __forceinline__ void load(const Mat& m, int kt,
                                       unsigned char* tile) const {
    const long long k0 = static_cast<long long>(kt) * BK;
    const long long r = MN ? row + k0 : row, c = MN ? col : col + k0;
    if (!m.vec) {
#pragma unroll 4
      for (int j = 0; j < kJ; ++j) chunk16(m, r + j * kDr, c, tile + off(j));
      return;
    }
    const long long left = m.cols - c;
    const int bytes = left >= 8 ? 16 : (left > 0 ? static_cast<int>(left) * 2
                                                 : 0);
    const bf16* src = m.p + r * m.ld + c;
    const uint32_t dst = smem_u32(tile);
#pragma unroll 8
    for (int j = 0; j < kJ; ++j) {
      const bool in = bytes > 0 && r + j * kDr < m.rows;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst + off(j)),
                   "l"(in ? src + j * kDr * m.ld : m.p), "r"(in ? bytes : 0));
    }
  }
};

// mbarriers of the ring (shared addresses): a phase completes after
// `count` arrivals.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of the given parity to complete.  A phase that does
// not complete within ~10 s of the SM clock (a lost arrival) traps: the
// launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// TMA: a box of a tensor map (a __grid_constant__ kernel parameter) into
// shared memory at dst, its bytes counted on the mbarrier bar.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle (1: 128 bytes, 2: 64 bytes).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

// The descriptor of k step s (16 deep) of a tile at addr: MN-major, atoms
// BK * 128 bytes apart and the step two 8-k groups on; K-major, the step 32
// bytes along each row.
template <bool MN, int BK>
__device__ __forceinline__ uint64_t step_desc(uint32_t addr, int s) {
  if constexpr (MN) return wg_desc(addr + s * 2048, BK * 128, 1024, 1);
  else return wg_desc(addr + s * 32, 16, 16 * BK, BK == 64 ? 1 : 2);
}

// wgmma.mma_async m64n256k16, float32 += bf16 x bf16, D accumulated
// (scale-d 1); TA / TB: A / B MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %132, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %130, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}


// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs (which it cannot see write the registers).
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// acc = sum over parts of A_pa @ B_pb over k in [0, K): the output tile's
// rows start at m0 of A, its columns at n0 of B.  A_MN: A is MN-major, the
// matrix in memory is [K, M] (else [M, K]); B_MN: B is [K, N] in memory
// (else [N, K]).  Every thread of the block calls it.  Warp-specialised:
// the producer warp (threads 256-287) fills the ring's slots and returns
// false; the two consumer warpgroups wait for each slot, run its MMAs and
// hand the slot back, and return true with the tile in acc.  full[s]
// completes when slot s holds its k tile: with TMA (use_tma: every
// operand's rows are 16-byte aligned; tma(kt, slot, bar) issues the tile's
// boxes) when the bytes of the stage have landed, else when the 32
// producer lanes' copies and stores have.  empty[s] completes when the 8
// consumer warps' MMAs on it are done (one step later: the MMAs of step kt
// run while step kt + 1's are issued).  No block-wide barrier after the
// set-up, which the block's first tile (g0 == 0) does.
template <int NA, int NB, bool A_MN, bool B_MN, int STAGES, int BK,
          typename Tma>
__device__ __forceinline__ bool wg_tile(const Mat (&a)[NA],
                                        const Mat (&b)[NB], long long m0,
                                        long long n0, long long K, int g0,
                                        bool use_tma, const Tma& tma,
                                        float (&acc)[kBn / 2],
                                        unsigned char* smem) {
  using C = WgCore<NA, NB, STAGES, BK>;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* ring = smem + (base - raw);
  const uint32_t bars = base + STAGES * C::kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  // slots by ring step g = g0 + kt (g0: the steps of the block's earlier
  // tiles), so a block can run several tiles on one ring
  auto a_off = [](int g, int p) {
    return (g % STAGES) * C::kStage + p * C::kATile;
  };
  auto b_off = [](int g, int p) {
    return (g % STAGES) * C::kStage + NA * C::kATile + p * C::kBTile;
  };
  if (g0 == 0) {  // the block's first tile: the ring's barriers
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(s), use_tma ? 1 : kProducers);
        mbar_init(empty(s), kWgThreads / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  const int nk = static_cast<int>((K + BK - 1) / BK);
  if (threadIdx.x >= kWgThreads && use_tma) {  // one thread, TMA
    if (threadIdx.x == kWgThreads) {
      for (int g = g0; g < g0 + nk; ++g) {
        const int s = g % STAGES;
        if (g >= STAGES) mbar_wait(empty(s), ((g / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), C::kStage);
        tma(g - g0, base + s * C::kStage, full(s));
      }
    }
    return false;
  }
  if (threadIdx.x >= kWgThreads) {  // the producer warp, cp.async
    const int tid = threadIdx.x - kWgThreads;
    const TileLoader<kWgBm, A_MN, BK> la(m0, tid);
    const TileLoader<kBn, B_MN, BK> lb(n0, tid);
    for (int kt = 0; kt < nk; ++kt) {
      const int g = g0 + kt, s = g % STAGES;
      if (g >= STAGES) mbar_wait(empty(s), ((g / STAGES) - 1) & 1);
#pragma unroll
      for (int p = 0; p < NA; ++p) la.load(a[p], kt, ring + a_off(g, p));
#pragma unroll
      for (int p = 0; p < NB; ++p) lb.load(b[p], kt, ring + b_off(g, p));
      // the lane's copies have landed and its element stores are fenced
      // for the MMAs' proxy before it arrives
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full(s));
    }
    return false;
  }
  // this warpgroup's 64 rows of A: 64 K-major rows or one MN-major atom
  const uint32_t wg_a = (threadIdx.x >> 7) * (A_MN ? BK * 128 : 64 * BK * 2);
#pragma unroll
  for (int i = 0; i < kBn / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  for (int g = g0; g < g0 + nk; ++g) {
    mbar_wait(full(g % STAGES), (g / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
#pragma unroll
      for (int pa = 0; pa < NA; ++pa) {
        const uint64_t da =
            step_desc<A_MN, BK>(base + a_off(g, pa) + wg_a, s);
#pragma unroll
        for (int pb = 0; pb < NB; ++pb) {
          const uint64_t db = step_desc<B_MN, BK>(base + b_off(g, pb), s);
          wgmma_n256<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    // step g - 1's MMAs are done: its slot goes back to the producer
    if (g > g0 && (threadIdx.x & 31) == 0)
      mbar_arrive(empty((g - 1) % STAGES));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  // and the last step's: the producer may fill it for the block's next
  // tile while this one's epilogue runs
  if (nk > 0 && (threadIdx.x & 31) == 0)
    mbar_arrive(empty((g0 + nk - 1) % STAGES));
  return true;
}

// The thread's output row of the block's 128 x 256 tile after quads().
__device__ __forceinline__ int quad_row() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2) + (lane & 1) * 8;
}

// Walks the accumulator as 4 consecutive columns of one row a thread.
// wgmma leaves thread (warp w, lane l) of a warpgroup rows 16w + l/4 and
// + 8, columns 8j + 2(l%4) + {0, 1} (acc[4j + 2h + e]); lanes l and l^1
// trade one row's pair, so each then holds row quad_row()'s columns
// 8j + 4((l%4)/2) .. + 3.  f(col, float4), col tile-local.  Every lane of
// the warp calls it (the trades are shuffles).
template <typename F>
__device__ __forceinline__ void quads(const float (&acc)[kBn / 2], F f) {
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  const int c = 4 * ((lane & 3) >> 1);
#pragma unroll
  for (int j = 0; j < kBn / 8; ++j) {
    const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    f(8 * j + c, odd ? make_float4(r0, r1, acc[4 * j + 2], acc[4 * j + 3])
                     : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1));
  }
}

// v's first n (<= 4) values to out[0, n): one 16-byte store when all four
// land on an aligned address, else one at a time.
__device__ __forceinline__ void put4(float* out, int n, bool vec, float4 v) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(out) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) out[i] = e[i];
}

// The three products' tiles, 128 x 256.  dlogits: 64-deep k tiles in 4
// stages.  dh and dw: the three dlogit planes on the 128-row side (each k
// tile then carries 3 x 128 + 256 rows, not 128 + 3 x 256), 32-deep k
// tiles in 5 stages (40 KB each).
constexpr int kProdBk = 32;
using DlogCore = WgCore<1, 1, 4, 64>;
using ProdCore = WgCore<3, 1, 5, kProdBk>;

// Backward, dlogits of one vocab slab [vs0, vs0 + ws), bf16 h and w: grid
// (ceil(T / 128), ceil(ws / 256)), the token tiles that share a w tile
// adjacent.  The logit tile h @ w (h K-major, w MN-major) on the wgmma
// core, then for t < T, v < vs0 + ws: dlog = (p - onehot) * dl as three
// bf16 planes of T x ld (split3).
__global__ void __launch_bounds__(kBlockThreads, 1)
    lmhead_dlogits_bf16(const bf16* __restrict__ h, const bf16* __restrict__ w,
                        const int* __restrict__ labels,
                        const float* __restrict__ m_sum,
                        const float* __restrict__ n_sum,
                        const float* __restrict__ dloss,
                        bf16* __restrict__ dlog, int Tn, int D, int V,
                        int vs0, int ws, int ld,
                        const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        int use_tma) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t0 = blockIdx.x * kWgBm, c0 = blockIdx.y * kBn;
  const Mat a[1] = {{h, Tn, D, D, aligned16(h, D)}};
  const Mat b[1] = {{w, D, V, V, aligned16(w, V)}};
  // TMA: h [T, D] in boxes of 128 x 64 (K-major), w [D, V] in 64 x 64
  // atoms (MN-major), four a k tile
  auto tma = [&](int kt, uint32_t slot, uint32_t bar) {
    tma_2d(slot, &ta, kt * 64, t0, bar);
#pragma unroll
    for (int q = 0; q < kBn / 64; ++q)
      tma_2d(slot + DlogCore::kATile + q * 64 * 128, &tb, vs0 + c0 + 64 * q,
             kt * 64, bar);
  };
  float acc[kBn / 2];
  if (!wg_tile<1, 1, false, true, 4, 64>(
          a, b, t0, vs0 + c0, D, 0, use_tma != 0, tma, acc, smem))
    return;
  // every lane takes part in quads' shuffles; rows past T store nothing
  const int t = t0 + quad_row();
  const int tr = t < Tn ? t : Tn - 1;
  const float lam = __frcp_rn(fmaxf(m_sum[tr], 1e-37f));
  const float ns = n_sum[tr], dl = dloss[tr];
  const int lab = labels[tr];
  const size_t plane = static_cast<size_t>(Tn) * ld;
  bf16* row = dlog + static_cast<size_t>(tr) * ld;
  quads(acc, [&](int c, float4 x4) {
    const int cc = c0 + c;
    if (t >= Tn || cc >= ws) return;
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    bf16 part[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float me, ne;
      repro::ext_exp(x[e], me, ne);
      const float p = __fmul_rn(__fmul_rn(me, lam),
                                repro::exp2_int(__fsub_rn(ne, ns)));
      const float hot = (vs0 + cc + e == lab) ? 1.0f : 0.0f;
      split3(__fmul_rn(__fsub_rn(p, hot), dl), part[0][e], part[1][e],
             part[2][e]);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      bf16* out = row + q * plane + cc;
      if (cc + 4 <= ws) {  // ld % 8 == 0 and cc % 4 == 0: 8-byte aligned
        *reinterpret_cast<uint2*>(out) =
            make_uint2(__bfloat16_as_ushort(part[q][0]) |
                           (uint32_t(__bfloat16_as_ushort(part[q][1])) << 16),
                       __bfloat16_as_ushort(part[q][2]) |
                           (uint32_t(__bfloat16_as_ushort(part[q][3])) << 16));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < ws - cc) out[e] = part[q][e];
      }
    }
  });
}

// n of ext_exp(x) alone.  It does not decrease as x grows (clamp, a
// product by log2 e and rintf each keep order; -inf and +inf map to the
// ends), so the largest n of a row is n of its largest logit.
__device__ __forceinline__ float ext_exp_n(float x) {
  const float xc = fminf(fmaxf(x, -repro::kXClamp), repro::kXClamp);
  float n = rintf(__fmul_rn(xc, repro::kLog2e));
  if (x == -INFINITY) n = repro::kMinusInfN;
  if (x == INFINITY) n = repro::kPlusInfN;
  return n;
}

// Folds a 128 x 256 logit tile (rows t0.., columns v0..) in registers into
// one (m, n, ll) partial a row, at [tile v0 / 256][t] of pm, pn, pll.
// wgmma leaves thread (warp w, lane l) of a warpgroup rows 16 w + l / 4
// (half 0) and + 8 (half 1), columns c = 8 j + 2 (l % 4) + e at
// acc[4 j + 2 half + e], j < 32, e < 2: 64 columns of each of its rows,
// the quad's four lanes the row's 256.  Columns v >= V are set to -inf
// first (TMA and the cp.async loader fill them with zeros, and exp(0) = 1
// would join every denominator).  Each lane folds its 64 values of a row
// in the TPU kernel's max-first form: n_loc = max n (ext_exp_n of the
// largest value); m_loc = sum over j, then e, of m 2^(n - n_loc), from 0
// in that order.  Then the quad's lanes by ext_add with lane l ^ 1, then
// l ^ 2 (ext_add is symmetric: all four end with the same pair), and the
// label logit from the lane that holds its column (0 where the label lies
// outside the tile or outside [0, V)).  Every lane of the warp calls it
// (the shuffles); rows past T store nothing.
__device__ __forceinline__ void fold_tile(float (&acc)[kBn / 2],
                                          const int* __restrict__ labels,
                                          float* __restrict__ pm,
                                          float* __restrict__ pn,
                                          float* __restrict__ pll, int Tn,
                                          int V, int t0, int v0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);  // the lane's first column
  if (v0 + kBn > V) {  // the tile crosses V
    const int left = V - v0 - c0;  // 8 j + e < left: inside
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + e >= left)
          acc[4 * j + e] = acc[4 * j + 2 + e] = -INFINITY;
  }
  const size_t tile = static_cast<size_t>(v0 / kBn) * Tn;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2) +
                  8 * half;
    const int lab = t < Tn ? labels[t] : -1;
    const int lc = lab >= 0 && lab < V ? lab - v0 : -1;  // tile-local
    const int key = lc - c0;  // 8 j + e where this lane holds the label
    float xmax = -INFINITY, ll = 0.0f;
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = acc[4 * j + 2 * half + e];
        xmax = fmaxf(xmax, x);
        if (key == 8 * j + e) ll = x;
      }
    float n = ext_exp_n(xmax), m = 0.0f;
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float me, ne;
        repro::ext_exp(acc[4 * j + 2 * half + e], me, ne);
        m = __fadd_rn(m, __fmul_rn(me, repro::exp2_int_nonpos(
                                           __fsub_rn(ne, n))));
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float n2 = __shfl_xor_sync(0xffffffffu, n, o);
      repro::ext_add(m, n, m2, n2);
    }
    ll = __shfl_sync(0xffffffffu, ll, (lane & ~3) | ((lc >> 1) & 3));
    if ((lane & 3) == half && t < Tn) {
      pm[tile + t] = m;
      pn[tile + t] = n;
      pll[tile + t] = ll;
    }
  }
}

// Forward, bf16 h and w: the logit tiles x = h @ w of lmhead_dlogits_bf16
// (the same wg_tile instantiation, TMA boxes, cp.async fallback and k
// order, so each logit is the same float32 sum as in the backward), each
// folded in registers by fold_tile into [3, ceil(V / 256), T] partials.
// Persistent, one block an SM: the ceil(V / 256) ceil(T / 128) tiles go
// round-robin to the blocks, the token tiles of a w tile adjacent so that
// blocks in flight together share it in L2, and g0 carries the ring
// across tiles, so the producer loads the next tile while the consumers
// fold this one.
__global__ void __launch_bounds__(kBlockThreads, 1)
    lmhead_fwd_bf16(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ pm,
                    float* __restrict__ pn, float* __restrict__ pll, int Tn,
                    int D, int V, const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb, int use_tma) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Mat a[1] = {{h, Tn, D, D, aligned16(h, D)}};
  const Mat b[1] = {{w, D, V, V, aligned16(w, V)}};
  const int tt = (Tn + kWgBm - 1) / kWgBm;
  const int tiles = (V + kBn - 1) / kBn * tt;
  const int nk = (D + 63) / 64;
  int g0 = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, g0 += nk) {
    const int t0 = tile % tt * kWgBm, v0 = tile / tt * kBn;
    // TMA: h [T, D] in boxes of 128 x 64 (K-major), w [D, V] in 64 x 64
    // atoms (MN-major), four a k tile, as lmhead_dlogits_bf16
    auto tma = [&](int kt, uint32_t slot, uint32_t bar) {
      tma_2d(slot, &ta, kt * 64, t0, bar);
#pragma unroll
      for (int q = 0; q < kBn / 64; ++q)
        tma_2d(slot + DlogCore::kATile + q * 64 * 128, &tb, v0 + 64 * q,
               kt * 64, bar);
    };
    float acc[kBn / 2];
    if (!wg_tile<1, 1, false, true, 4, 64>(a, b, t0, v0, D, g0, use_tma != 0,
                                           tma, acc, smem))
      continue;
    fold_tile(acc, labels, pm, pn, pll, Tn, V, t0, v0);
  }
}

// Split z of dlog[T, ws] @ w[:, vs0:vs0+ws]^T into part[z] ([T, D]) over
// slab columns [z kc, (z + 1) kc), bf16: grid (ceil(T / 128), ceil(D /
// 256), splits), the token tiles that share a w tile adjacent.  The three
// dlogit planes (K-major) against one w tile (w[d, v] is K-major for
// dh[t, d]) on the wgmma core.
__global__ void __launch_bounds__(kBlockThreads, 1)
    lmhead_dh_slab_bf16(const bf16* __restrict__ dlog,
                        const bf16* __restrict__ w, float* __restrict__ part,
                        int Tn, int D, int V, int vs0, int ws, int ld,
                        int kc, const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        int use_tma) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * kWgBm, n0 = blockIdx.y * kBn;
  const int k0 = blockIdx.z * kc;
  // TMA: the three planes [3, T, ws] in boxes of 128 x 32 (K-major), w
  // [D, V] in boxes of 256 x 32 (K-major); kc is a multiple of 32, so no
  // box crosses into the next split
  auto tma = [&](int kt, uint32_t slot, uint32_t bar) {
    const int k = k0 + kt * kProdBk;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      tma_3d(slot + p * ProdCore::kATile, &ta, k, m0, p, bar);
    tma_2d(slot + 3 * ProdCore::kATile, &tb, vs0 + k, n0, bar);
  };
  const int kn = ws - k0 < kc ? ws - k0 : kc;
  const size_t plane = static_cast<size_t>(Tn) * ld;
  const bf16* d0 = dlog + k0;
  const bool vd = aligned16(d0, ld);
  const Mat a[3] = {{d0, Tn, kn, ld, vd}, {d0 + plane, Tn, kn, ld, vd},
                    {d0 + 2 * plane, Tn, kn, ld, vd}};
  const bf16* wk = w + vs0 + k0;  // [D, kn], leading dimension V
  const Mat b[1] = {{wk, D, kn, V, aligned16(wk, V)}};
  float acc[kBn / 2];
  if (!wg_tile<3, 1, false, false, 5, kProdBk>(
          a, b, m0, n0, kn, 0, use_tma != 0, tma, acc, smem))
    return;
  const int t = m0 + quad_row();
  float* out = part + static_cast<size_t>(blockIdx.z) * Tn * D +
               static_cast<size_t>(t) * D;
  const bool vec = D % 4 == 0;
  quads(acc, [&](int c, float4 v) {
    const int d = n0 + c;
    if (t < Tn && d < D) put4(out + d, D - d, vec, v);
  });
}

// dw[:, vs0:vs0+ws] = h^T @ dlog over the T tokens, bf16 h.  Computed
// transposed, dw^T = dlog^T @ h, so that the three dlogit planes
// (MN-major) sit on the 128-row side against one h tile (MN-major).  The
// ceil(ws / 128) x ceil(D / 256) tiles (vocab tiles adjacent) are shared
// round-robin by the blocks of the grid, one an SM: K = T is short, so the
// producer loads a block's next tile while its last one is written out.
// Each thread writes its rows of four d as 4-byte stores, 64 contiguous
// bytes of dw ([D, V] float32) per d row and warp.
__global__ void __launch_bounds__(kBlockThreads, 1)
    lmhead_dw_slab_bf16(const bf16* __restrict__ h,
                        const bf16* __restrict__ dlog, float* __restrict__ dw,
                        int Tn, int D, int V, int vs0, int ws, int ld,
                        const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        int use_tma) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t plane = static_cast<size_t>(Tn) * ld;
  const bool vd = aligned16(dlog, ld);
  const Mat a[3] = {{dlog, Tn, ws, ld, vd}, {dlog + plane, Tn, ws, ld, vd},
                    {dlog + 2 * plane, Tn, ws, ld, vd}};
  const Mat b[1] = {{h, Tn, D, D, aligned16(h, D)}};
  const int vt = (ws + kWgBm - 1) / kWgBm;
  const int tiles = vt * ((D + kBn - 1) / kBn);
  const int nk = (Tn + kProdBk - 1) / kProdBk;
  int g0 = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, g0 += nk) {
    const int m0 = tile % vt * kWgBm, n0 = tile / vt * kBn;
    // TMA: the three planes [3, T, ws] and h [T, D] in 64 x 32 atoms
    // (MN-major)
    auto tma = [&](int kt, uint32_t slot, uint32_t bar) {
      const int k = kt * kProdBk;
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < kWgBm / 64; ++q)
          tma_3d(slot + p * ProdCore::kATile + q * kProdBk * 128, &ta,
                 m0 + 64 * q, k, p, bar);
#pragma unroll
      for (int q = 0; q < kBn / 64; ++q)
        tma_2d(slot + 3 * ProdCore::kATile + q * kProdBk * 128, &tb,
               n0 + 64 * q, k, bar);
    };
    float acc[kBn / 2];
    if (!wg_tile<3, 1, true, true, 5, kProdBk>(
            a, b, m0, n0, Tn, g0, use_tma != 0, tma, acc, smem))
      continue;
    const int v = m0 + quad_row();
    float* out = dw + vs0 + v;
    quads(acc, [&](int c, float4 x) {
      const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = n0 + c + q;
        if (v < ws && d < D) out[static_cast<size_t>(d) * V] = e[q];
      }
    });
  }
}

// Backward, dlogits of one vocab slab for float32 h and w: grid (ceil(ws /
// 128), ceil(T / 128)); writes dlog[t, v - vs0] = (p - onehot) * dl for
// t < T, v < vs0 + ws (the slab ends at or before V), row stride ld.
__global__ void __launch_bounds__(kThreads)
    lmhead_dlogits(const float* __restrict__ h, const float* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ m_sum,
                   const float* __restrict__ n_sum,
                   const float* __restrict__ dloss, float* __restrict__ dlog,
                   int Tn, int D, int V, int vs0, int ws, int ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  logits_tile(h, w, Tn, D, V, t0, vs0 + c0, smem);
  const float* cs = reinterpret_cast<const float*>(smem);
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
    dlog[static_cast<size_t>(t) * ld + cc] =
        __fmul_rn(__fsub_rn(p, hot), dloss[t]);
  }
}

// Split z of dlog[T, ws] @ w[:, vs0:vs0+ws]^T into part[z] ([T, D]) over
// slab columns [z kc, (z + 1) kc), float32: FFMA; grid (ceil(D / 128),
// ceil(T / 128), splits).
__global__ void __launch_bounds__(kThreads)
    lmhead_dh_slab(const float* __restrict__ dlog, const float* __restrict__ w,
                   float* __restrict__ part, int Tn, int D, int V, int vs0,
                   int ws, int ld, int kc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int k0 = blockIdx.z * kc;
  const int kn = ws - k0 < kc ? ws - k0 : kc;
  float* out = part + static_cast<size_t>(blockIdx.z) * Tn * D;
  float acc[8][8] = {};
  // b(k, n) = w[n, vs0 + k]: the transpose of the slab, k contiguous
  ffma_tile<true, true>(RowMajor<float>{dlog + k0, Tn, kn, ld},
                        Transposed<float>{w + vs0 + k0, kn, D, V}, m0, n0, kn,
                        acc, smem);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (m0 + r < Tn && n0 + c < D)
        out[static_cast<size_t>(m0 + r) * D + n0 + c] = acc[i][j];
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

// dw[:, vs0:vs0+ws] = h^T @ dlog over the T tokens, float32: FFMA; grid
// (ceil(ws / 128), ceil(D / 128)).
__global__ void __launch_bounds__(kThreads)
    lmhead_dw_slab(const float* __restrict__ h, const float* __restrict__ dlog,
                   float* __restrict__ dw, int Tn, int D, int V, int vs0,
                   int ws, int ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  float acc[8][8] = {};
  // a(d, t) = h[t, d]: the transpose of h, d contiguous
  ffma_tile<false, false>(Transposed<float>{h, D, Tn, D},
                          RowMajor<float>{dlog, Tn, ws, ld}, m0, n0, Tn, acc,
                          smem);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (m0 + r < D && n0 + c < ws)
        dw[static_cast<size_t>(m0 + r) * V + vs0 + n0 + c] = acc[i][j];
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

constexpr int kMaxDhSplits = 8;

int sm_count() {
  int sms = 132;
  int dev;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// k splits of a dh slab product over `tiles` output tiles, each split a
// whole number of `step`-deep k tiles.  float32 (FFMA, several blocks an
// SM): at least 4 blocks for each SM.  bf16 (one wgmma block an SM): the
// fewest splits whose last wave fills at least 85 % of the SMs, else the
// fullest last wave.
int dh_splits(int tiles, int ws, bool bf16_core) {
  const int sms = sm_count();
  const int step = bf16_core ? kProdBk : kBk;
  const int steps = (ws + step - 1) / step;
  const int most = steps < kMaxDhSplits ? steps : kMaxDhSplits;
  if (!bf16_core) {
    int z = (4 * sms + tiles - 1) / tiles;
    z = z < 1 ? 1 : (z > kMaxDhSplits ? kMaxDhSplits : z);
    return z < steps ? z : steps;
  }
  int best = 1;
  double best_fill = 0.0;
  for (int z = 1; z <= most; ++z) {
    const int blocks = tiles * z;
    const double fill =
        static_cast<double>(blocks) / (((blocks + sms - 1) / sms) * sms);
    if (fill >= 0.85) return z;
    if (fill > best_fill) best_fill = fill, best = z;
  }
  return best;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The float32 forward: 128 x 128 FFMA tiles, one block each, grid
// (ceil(V / 128), ceil(T / 128)), then the vocab-order combine.
int fwd_f32(const float* h, const float* w, const int* lab, float* scratch,
            float* loss, float* m, float* n, int Tn, int D, int V,
            cudaStream_t s) {
  const int tiles = cdiv(V, kTile);
  float* pm = scratch;
  float* pn = pm + static_cast<size_t>(tiles) * Tn;
  float* pll = pn + static_cast<size_t>(tiles) * Tn;
  cudaError_t e = allow_smem(lmhead_fwd_tiles, kLogitSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  lmhead_fwd_tiles<<<dim3(tiles, cdiv(Tn, kTile)), kThreads,
                     kLogitSmemBytes, s>>>(h, w, lab, pm, pn, pll, Tn, D, V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lmhead_fwd_combine<<<cdiv(Tn, 64), 64, 0, s>>>(pm, pn, pll, loss, m, n, Tn,
                                                 tiles);
  return static_cast<int>(cudaGetLastError());
}

// The backward, one vocab slab at a time: the slab's dlogits once, then
// dh's product (k-split parts, added in split order) and dw's, each where
// its output is given (not null).  scratch: the slab's dlogits (float32
// [T, slab] for float32 h and w, three bf16 planes [3, T, slab] for bf16:
// either fits in 2 T slab floats), then, for dh, kMaxDhSplits float32
// [T, D] partial products.
int bwd_f32(const float* h, const float* w, const int* lab, const float* m,
            const float* n, const float* dl, float* scratch, float* dh,
            float* dw, int Tn, int D, int V, int slab, cudaStream_t s) {
  float* dlog = scratch;
  float* parts = scratch + 2 * static_cast<size_t>(Tn) * slab;
  const size_t td = static_cast<size_t>(Tn) * D;
  cudaError_t e = allow_smem(lmhead_dlogits, kLogitSmemBytes);
  if (e == cudaSuccess) e = allow_smem(lmhead_dh_slab, kFfmaSmemBytes);
  if (e == cudaSuccess) e = allow_smem(lmhead_dw_slab, kFfmaSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int dh_tiles = cdiv(D, kTile) * cdiv(Tn, kTile);
  for (int vs0 = 0; vs0 < V; vs0 += slab) {
    const int ws = V - vs0 < slab ? V - vs0 : slab;
    lmhead_dlogits<<<dim3(cdiv(ws, kTile), cdiv(Tn, kTile)), kThreads,
                     kLogitSmemBytes, s>>>(h, w, lab, m, n, dl, dlog, Tn, D,
                                           V, vs0, ws, slab);
    if (dh) {
      const int z = dh_splits(dh_tiles, ws, false);
      const int kc = cdiv(cdiv(ws, z), kBk) * kBk;
      const int zz = cdiv(ws, kc);  // splits that hold columns
      lmhead_dh_slab<<<dim3(cdiv(D, kTile), cdiv(Tn, kTile), zz), kThreads,
                       kFfmaSmemBytes, s>>>(dlog, w, parts, Tn, D, V, vs0, ws,
                                            slab, kc);
      lmhead_dh_add<<<static_cast<unsigned>((td + 255) / 256), 256, 0, s>>>(
          parts, dh, td, zz, vs0 == 0);
    }
    if (dw)
      lmhead_dw_slab<<<dim3(cdiv(ws, kTile), cdiv(D, kTile)), kThreads,
                       kFfmaSmemBytes, s>>>(h, dlog, dw, Tn, D, V, vs0, ws,
                                            slab);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// cuTensorMapEncodeTiled of the driver, found through the runtime (no link
// against libcuda); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, byte strides of the
// outer ones) read in boxes of `box`, 128- or 64-byte swizzled as the
// wgmma tiles are; zeros outside the dims.
bool tensor_map(CUtensorMap* m, const void* p, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box, bool sw128) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 forward: lmhead_fwd_bf16 into [3, ceil(V / 256), T] partials
// (TMA where h's and w's rows are 16-byte aligned, else cp.async), then
// the vocab-order combine.
int fwd_bf16(const bf16* h, const bf16* w, const int* lab, float* scratch,
             float* loss, float* m, float* n, int Tn, int D, int V,
             cudaStream_t s) {
  const int vt = cdiv(V, kBn);
  float* pm = scratch;
  float* pn = pm + static_cast<size_t>(vt) * Tn;
  float* pll = pn + static_cast<size_t>(vt) * Tn;
  cudaError_t e = allow_smem(lmhead_fwd_bf16, DlogCore::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int use_tma = aligned16(h, D) && aligned16(w, V);
  CUtensorMap h_k{}, w_mn{};
  const cuuint64_t hd[2] = {cuuint64_t(D), cuuint64_t(Tn)};
  const cuuint64_t wd[2] = {cuuint64_t(V), cuuint64_t(D)};
  const cuuint64_t hs[1] = {cuuint64_t(D) * 2}, wst[1] = {cuuint64_t(V) * 2};
  const cuuint32_t b_hk[2] = {64, kWgBm}, b_wmn[2] = {64, 64};
  if (use_tma && !(tensor_map(&h_k, h, 2, hd, hs, b_hk, true) &&
                   tensor_map(&w_mn, w, 2, wd, wst, b_wmn, true)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = vt * cdiv(Tn, kWgBm), sms = sm_count();
  lmhead_fwd_bf16<<<tiles < sms ? tiles : sms, kBlockThreads,
                    DlogCore::kSmem, s>>>(h, w, lab, pm, pn, pll, Tn, D, V,
                                          h_k, w_mn, use_tma);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lmhead_fwd_combine<<<cdiv(Tn, 64), 64, 0, s>>>(pm, pn, pll, loss, m, n, Tn,
                                                 vt);
  return static_cast<int>(cudaGetLastError());
}

int bwd_bf16(const bf16* h, const bf16* w, const int* lab, const float* m,
             const float* n, const float* dl, float* scratch, float* dh,
             float* dw, int Tn, int D, int V, int slab, cudaStream_t s) {
  auto* dlog = reinterpret_cast<bf16*>(scratch);
  float* parts = scratch + 2 * static_cast<size_t>(Tn) * slab;
  const size_t td = static_cast<size_t>(Tn) * D;
  cudaError_t e = allow_smem(lmhead_dlogits_bf16, DlogCore::kSmem);
  if (e == cudaSuccess) e = allow_smem(lmhead_dh_slab_bf16, ProdCore::kSmem);
  if (e == cudaSuccess) e = allow_smem(lmhead_dw_slab_bf16, ProdCore::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // each kernel loads by TMA where all its operands' rows are 16-byte
  // aligned (the dlogit planes' always are), by cp.async otherwise
  const int tma_h = aligned16(h, D), tma_w = aligned16(w, V);
  CUtensorMap h_k{}, w_mn{}, w_k{}, h_mn{}, dl_k{}, dl_mn{};
  const cuuint64_t hd[2] = {cuuint64_t(D), cuuint64_t(Tn)};
  const cuuint64_t wd[2] = {cuuint64_t(V), cuuint64_t(D)};
  const cuuint64_t hs[1] = {cuuint64_t(D) * 2}, wst[1] = {cuuint64_t(V) * 2};
  const cuuint32_t b_hk[2] = {64, kWgBm}, b_wmn[2] = {64, 64};
  const cuuint32_t b_wk[2] = {kProdBk, kBn}, b_hmn[2] = {64, kProdBk};
  if ((tma_h && !(tensor_map(&h_k, h, 2, hd, hs, b_hk, true) &&
                  tensor_map(&h_mn, h, 2, hd, hs, b_hmn, true))) ||
      (tma_w && !(tensor_map(&w_mn, w, 2, wd, wst, b_wmn, true) &&
                  tensor_map(&w_k, w, 2, wd, wst, b_wk, false))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dh_tiles = cdiv(Tn, kWgBm) * cdiv(D, kBn);
  const int sms = sm_count();
  for (int vs0 = 0; vs0 < V; vs0 += slab) {
    const int ws = V - vs0 < slab ? V - vs0 : slab;
    // the slab's three dlogit planes [3, T, ws], row stride slab
    const cuuint64_t pd[3] = {cuuint64_t(ws), cuuint64_t(Tn), 3};
    const cuuint64_t ps[2] = {cuuint64_t(slab) * 2, cuuint64_t(slab) * 2 * Tn};
    const cuuint32_t b_k[3] = {kProdBk, kWgBm, 1};
    const cuuint32_t b_mn[3] = {64, kProdBk, 1};
    if (!(tensor_map(&dl_k, dlog, 3, pd, ps, b_k, false) &&
          tensor_map(&dl_mn, dlog, 3, pd, ps, b_mn, true)))
      return static_cast<int>(cudaErrorInvalidValue);
    lmhead_dlogits_bf16<<<dim3(cdiv(Tn, kWgBm), cdiv(ws, kBn)),
                          kBlockThreads, DlogCore::kSmem, s>>>(
        h, w, lab, m, n, dl, dlog, Tn, D, V, vs0, ws, slab, h_k, w_mn,
        tma_h && tma_w);
    if (dh) {
      const int z = dh_splits(dh_tiles, ws, true);
      const int kc = cdiv(cdiv(ws, z), kProdBk) * kProdBk;
      const int zz = cdiv(ws, kc);  // splits that hold columns
      lmhead_dh_slab_bf16<<<dim3(cdiv(Tn, kWgBm), cdiv(D, kBn), zz),
                            kBlockThreads, ProdCore::kSmem, s>>>(
          dlog, w, parts, Tn, D, V, vs0, ws, slab, kc, dl_k, w_k, tma_w);
      lmhead_dh_add<<<static_cast<unsigned>((td + 255) / 256), 256, 0, s>>>(
          parts, dh, td, zz, vs0 == 0);
    }
    if (dw) {
      const int tiles = cdiv(ws, kWgBm) * cdiv(D, kBn);
      lmhead_dw_slab_bf16<<<tiles < sms ? tiles : sms, kBlockThreads,
                            ProdCore::kSmem, s>>>(h, dlog, dw, Tn, D, V, vs0,
                                                ws, slab, dl_mn, h_mn,
                                                tma_h);
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
// float32 [3, ceil(V / 128), T] (float32 folds 128-column tiles, bf16
// 256-column ones).
int lmhead_xent_fwd_2d(const void* h, const void* w, const void* labels,
                       void* scratch, void* loss, void* m_sum, void* n_sum,
                       int T, int D, int V, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* sc = static_cast<float*>(scratch);
  float* lo = static_cast<float*>(loss);
  float* m = static_cast<float*>(m_sum);
  float* n = static_cast<float*>(n_sum);
  if (dtype == 0)
    return fwd_f32(static_cast<const float*>(h), static_cast<const float*>(w),
                   lab, sc, lo, m, n, T, D, V, s);
  return fwd_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                  lab, sc, lo, m, n, T, D, V, s);
}

// dh float32 [T, D] and dw float32 [D, V], either null to skip it; the
// slab's dlogits are computed once for both.  scratch: float32, 2 T slab
// values (+ 8 T D with dh).  m_sum, n_sum, dloss float32 [T].
int lmhead_xent_bwd_2d(const void* h, const void* w, const void* labels,
                       const void* m_sum, const void* n_sum,
                       const void* dloss, void* scratch, void* dh, void* dw,
                       int T, int D, int V, int slab, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* m = static_cast<const float*>(m_sum);
  const float* n = static_cast<const float*>(n_sum);
  const float* dl = static_cast<const float*>(dloss);
  float* sc = static_cast<float*>(scratch);
  float* gh = static_cast<float*>(dh);
  float* gw = static_cast<float*>(dw);
  if (dtype == 0)
    return bwd_f32(static_cast<const float*>(h), static_cast<const float*>(w),
                   lab, m, n, dl, sc, gh, gw, T, D, V, slab, s);
  return bwd_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                  lab, m, n, dl, sc, gh, gw, T, D, V, slab, s);
}

}  // extern "C"
