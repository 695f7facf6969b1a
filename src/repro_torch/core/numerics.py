"""Core numerics for the Two-Pass Softmax algorithm (Dukhan & Ablavatski, 2020).

``ExtExp(x)`` returns a pair of float32 tensors ``(m, n)`` with

    e^x == m * 2^n,   m = e^t in [sqrt(2)/2, sqrt(2)],   n integral (as f32)

i.e. the classic exp (range reduction -> polynomial -> reconstruction) with
the reconstruction step removed (paper SS4).  Keeping ``n`` as a float extends
the dynamic range far beyond a single f32, which is what makes the Two-Pass
softmax possible.

Pairs form a commutative monoid under scaled addition (paper Alg 3):

    (m1, n1) + (m2, n2) -> (m1*2^(n1-n') + m2*2^(n2-n'), n'),  n' = max(n1, n2)

The scale factors are exact powers of two with non-positive exponents, so a
combine neither overflows nor loses accuracy to the scaling itself.

Every function here is written op by op so that its float32 rounding is the
same as the reference arithmetic: no fused multiply-add, round half to even
(``torch.round``), ``2^n`` built from exponent bits.  The CUDA kernels in
``repro_torch/csrc`` repeat this arithmetic with ``__fmul_rn``/``__fadd_rn``
so that kernel and plain version agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Polynomial / range-reduction constants (paper Alg 4, XNNPACK rr2-p5).
# Cody-Waite: ln(2) is split into a high part with trailing zeros and a low
# correction so that ``x - n*ln2_hi`` is exact for all relevant |n|.
LOG2E = float.fromhex("0x1.715476p+0")        # log2(e)
LN2_HI = float.fromhex("0x1.62E430p-1")       # ln(2) high (Cody-Waite)
LN2_LO = float.fromhex("-0x1.05C610p-29")     # ln(2) low  (Cody-Waite)
EXP_C5 = float.fromhex("0x1.0F9F9Cp-7")       # ~1/120
EXP_C4 = float.fromhex("0x1.573A1Ap-5")       # ~1/24
EXP_C3 = float.fromhex("0x1.555A80p-3")       # ~1/6
EXP_C2 = float.fromhex("0x1.FFFDC6p-2")       # ~1/2
EXP_C1 = float.fromhex("0x1.FFFFF6p-1")       # ~1

# Finite identity exponent of the monoid: 0 * 2^MINUS_INF_N == 0, and any
# real element dominates the max.  -inf would give 0*inf -> NaN in rescales.
MINUS_INF_N = -1.0e38
PLUS_INF_N = 1.0e38

# Finite-input clamp: beyond ~2.36e38, n = x*log2e itself overflows f32.
_X_CLAMP = 1.0e37

# Cody-Waite breaks down once |n*ln2_hi| cancellation exceeds the f32
# mantissa; the reduced argument t is clamped to the (slightly widened)
# reduced range.  Within the practical logit domain the clamp never engages;
# for adversarially huge |x| the exponent n still tracks x, so no NaN/inf is
# produced.  (A deviation from the paper, which assumes bounded inputs.)
_T_CLAMP = 0.35


class ExtFloat(NamedTuple):
    """A number ``mantissa * 2**exponent`` (both f32 tensors)."""

    mantissa: torch.Tensor
    exponent: torch.Tensor


def ext_exp(x: torch.Tensor) -> ExtFloat:
    """``ExtExp``: e^x as an (m, n) pair, reconstruction omitted.

      n = round(x * log2e)                       (round half to even)
      t = x - n*ln2_hi - n*ln2_lo                (Cody-Waite reduction)
      m = 1 + t(c1 + t(c2 + t(c3 + t(c4 + t c5))))   (Horner, unfused)

    ``-inf -> (0, MINUS_INF_N)`` (an exact monoid zero, the masking value);
    ``+inf -> (1, PLUS_INF_N)``.
    """
    x = x.to(torch.float32)
    xc = x.clamp(-_X_CLAMP, _X_CLAMP)          # keep n = x*log2e finite
    n = torch.round(xc * LOG2E)
    t = xc - n * LN2_HI
    t = t - n * LN2_LO
    t = t.clamp(-_T_CLAMP, _T_CLAMP)           # Cody-Waite breakdown guard
    p = t * EXP_C5 + EXP_C4
    p = p * t + EXP_C3
    p = p * t + EXP_C2
    p = p * t + EXP_C1
    m = p * t + 1.0
    # clamp() of NaN would poison t for x = +-inf: pin those explicitly.
    neg_inf = x == -torch.inf
    pos_inf = x == torch.inf
    m = torch.where(neg_inf, 0.0, torch.where(pos_inf, 1.0, m))
    n = torch.where(neg_inf, MINUS_INF_N, torch.where(pos_inf, PLUS_INF_N, n))
    return ExtFloat(m, n)


def exp2_int(n: torch.Tensor) -> torch.Tensor:
    """Exact ``2^n`` for integral-valued float ``n`` via exponent-field bits
    (paper SS6.3).  ``n <= -127`` flushes to zero; ``n`` is clamped to 127.
    Never ``torch.exp2``: it may carry ~1 ULP error, which would break the
    error-free power-of-two scaling the (m, n) algebra relies on."""
    n = n.clamp(-127.0, 127.0)
    return ((n + 127.0).to(torch.int32) << 23).view(torch.float32)


def ext_exp_reconstruct(e: ExtFloat) -> torch.Tensor:
    """The reconstruction ``m * 2^n`` that the Two-Pass algorithm leaves out
    of its intermediates (it overflows and underflows as plain exp does);
    for tests and the three-pass baselines.  ``2^n`` by ``torch.exp2``, as
    the reference's ``jnp.exp2``."""
    return e.mantissa * torch.exp2(e.exponent)


def exp_via_extexp(x: torch.Tensor) -> torch.Tensor:
    """exp built from ExtExp and the reconstruction (paper Alg 4)."""
    return ext_exp_reconstruct(ext_exp(x))


def ext_zero(shape=(), device=None) -> ExtFloat:
    """Identity element of the (m, n) addition monoid."""
    return ExtFloat(torch.zeros(shape, dtype=torch.float32, device=device),
                    torch.full(shape, MINUS_INF_N, dtype=torch.float32,
                               device=device))


def ext_add(a: ExtFloat, b: ExtFloat) -> ExtFloat:
    """Overflow-free scaled addition (paper Alg 3 inner loop)."""
    n_max = torch.maximum(a.exponent, b.exponent)
    m = (a.mantissa * exp2_int(a.exponent - n_max)
         + b.mantissa * exp2_int(b.exponent - n_max))
    return ExtFloat(m, n_max)


def ext_scale_add(acc: ExtFloat, elt: ExtFloat) -> ExtFloat:
    """:func:`ext_add` with (accumulator, element) argument order."""
    return ext_add(acc, elt)


def ext_sum(e: ExtFloat, axis: int = -1, keepdims: bool = False) -> ExtFloat:
    """Monoid reduction along ``axis``, evaluated as max + rescale + sum."""
    n_max = e.exponent.amax(dim=axis, keepdim=True)
    m = (e.mantissa * exp2_int(e.exponent - n_max)).sum(dim=axis,
                                                         keepdim=True)
    if not keepdims:
        m = m.squeeze(axis)
        n_max = n_max.squeeze(axis)
    return ExtFloat(m, n_max)


def ext_log(e: ExtFloat) -> torch.Tensor:
    """Natural log of an ExtFloat: ``log(m) + n*ln2`` (f32, wide range)."""
    ln2 = torch.tensor(LN2_HI, dtype=torch.float32) + torch.tensor(
        LN2_LO, dtype=torch.float32)
    return torch.log(e.mantissa) + e.exponent * ln2.to(e.exponent.device)


def ext_ratio_scale(num: ExtFloat, den: ExtFloat) -> torch.Tensor:
    """``num/den`` reconstructed to a plain float: ``m * (1/m_den) *
    2^(n - n_den)`` (pass 2 of the Two-Pass softmax)."""
    return num.mantissa * (1.0 / den.mantissa) * exp2_int(
        num.exponent - den.exponent)
