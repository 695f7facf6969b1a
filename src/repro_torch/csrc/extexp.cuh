// ExtExp and the (m, n) monoid on the device (paper Alg 3 and 4).
//
// The arithmetic repeats repro_torch/core/numerics.py operation by
// operation, with explicit round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fsub_rn): nvcc would otherwise contract `p * t + c` into a
// fused multiply-add, which PyTorch's elementwise ops do not do.  So the
// kernels' (m, n) pairs equal the plain version's bit for bit; only the
// order of the sums differs.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace repro {

constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kLn2Hi = 0x1.62E430p-1f;
constexpr float kLn2Lo = -0x1.05C610p-29f;
constexpr float kC5 = 0x1.0F9F9Cp-7f;
constexpr float kC4 = 0x1.573A1Ap-5f;
constexpr float kC3 = 0x1.555A80p-3f;
constexpr float kC2 = 0x1.FFFDC6p-2f;
constexpr float kC1 = 0x1.FFFFF6p-1f;
constexpr float kMinusInfN = -1.0e38f;  // finite identity exponent
constexpr float kPlusInfN = 1.0e38f;
constexpr float kXClamp = 1.0e37f;
constexpr float kTClamp = 0.35f;

// Exact 2^n for integral n by writing n + 127 into the exponent field;
// n <= -127 flushes to zero.  Never exp2f: it is not exact.  The add of
// 2^23 + 127 leaves n + 127 in the low mantissa bits of a float in
// [2^23, 2^24), so no float-to-int conversion is issued: the shift keeps
// those 8 bits and drops the float's own exponent.
__device__ __forceinline__ float exp2_int_field(float n) {
  return __uint_as_float(__float_as_uint(__fadd_rn(n, 8388735.0f)) << 23);
}

__device__ __forceinline__ float exp2_int(float n) {
  return exp2_int_field(fminf(fmaxf(n, -127.0f), 127.0f));
}

// exp2_int for n <= 0 (a difference to a maximum): its upper clamp is then
// a no-op and is left out.
__device__ __forceinline__ float exp2_int_nonpos(float n) {
  return exp2_int_field(fmaxf(n, -127.0f));
}

// e^x = m * 2^n with the reconstruction step left out.  rintf rounds half
// to even, as torch.round does (roundf would round half away from zero).
__device__ __forceinline__ void ext_exp(float x, float& m, float& n) {
  const float xc = fminf(fmaxf(x, -kXClamp), kXClamp);
  n = rintf(__fmul_rn(xc, kLog2e));
  float t = __fsub_rn(xc, __fmul_rn(n, kLn2Hi));
  t = __fsub_rn(t, __fmul_rn(n, kLn2Lo));
  t = fminf(fmaxf(t, -kTClamp), kTClamp);
  float p = __fadd_rn(__fmul_rn(t, kC5), kC4);
  p = __fadd_rn(__fmul_rn(p, t), kC3);
  p = __fadd_rn(__fmul_rn(p, t), kC2);
  p = __fadd_rn(__fmul_rn(p, t), kC1);
  m = __fadd_rn(__fmul_rn(p, t), 1.0f);
  // +-inf map to exact monoid elements (the masking value is -inf).
  if (x == -INFINITY) { m = 0.0f; n = kMinusInfN; }
  if (x == INFINITY) { m = 1.0f; n = kPlusInfN; }
}

// (m, n) += (m2, n2): overflow-free scaled addition, exact rescales.
__device__ __forceinline__ void ext_add(float& m, float& n, float m2,
                                        float n2) {
  const float nn = fmaxf(n, n2);
  m = __fadd_rn(__fmul_rn(m, exp2_int(__fsub_rn(n, nn))),
                __fmul_rn(m2, exp2_int(__fsub_rn(n2, nn))));
  n = nn;
}

}  // namespace repro
