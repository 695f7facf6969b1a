"""Two-Pass softmax / logsumexp (paper Alg 3) as plain tensor code, plus the
exact (m, n) combine of partial attention results.

These are the algorithmic forms; ``repro_torch.kernels.twopass_softmax``
runs the same arithmetic in a CUDA kernel and is held against them.
"""

from __future__ import annotations

import torch

from repro_torch.core import numerics
from repro_torch.core.numerics import ExtFloat, ext_exp, ext_log, ext_sum


def twopass_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pass 1: ExtExp every element and monoid-reduce to ``(m_sum, n_sum)``.
    Pass 2: recompute ExtExp and scale: ``y = m * (1/m_sum) * 2^(n - n_sum)``.
    """
    s = ext_sum(ext_exp(x), axis=axis, keepdims=True)      # pass 1
    y = numerics.ext_ratio_scale(ext_exp(x), s)             # pass 2
    return y.to(x.dtype)


def twopass_logsumexp(x: torch.Tensor, axis: int = -1,
                      keepdims: bool = False) -> torch.Tensor:
    """``lse = log(m_sum) + n_sum * ln2`` from one data pass."""
    s = ext_sum(ext_exp(x), axis=axis, keepdims=keepdims)
    return ext_log(s).to(x.dtype)


def twopass_softmax_stats(x: torch.Tensor, axis: int = -1) -> ExtFloat:
    """Pass 1 only: the per-row ``(m_sum, n_sum)`` statistics (keepdims)."""
    return ext_sum(ext_exp(x), axis=axis, keepdims=True)


def ext_combine_partials(m: torch.Tensor, n: torch.Tensor, o: torch.Tensor,
                         axis: int = 0):
    """Combine partial attention results carried as ``(o, m_sum, n_sum)``,
    stacked along ``axis``: ``o_k`` is chunk k's numerator-weighted value sum
    scaled by ``2^-n_k``.  The global result is ``sum_k o_k * 2^(n_k - n*)``
    over ``m*``; the scale factors are exact powers of two.  Returns
    ``(m_star, n_star, o_star)`` with ``o_star`` still unnormalised."""
    n_star = n.amax(dim=axis, keepdim=True)
    scale = numerics.exp2_int(n - n_star)
    m_star = (m * scale).sum(dim=axis)
    o_scale = scale.reshape(scale.shape + (1,) * (o.ndim - scale.ndim))
    o_star = (o * o_scale).sum(dim=axis)
    return m_star, n_star.squeeze(axis), o_star
