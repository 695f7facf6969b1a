"""Algorithm-selectable softmax: the framework-wide entry point.

Every softmax site (attention, sampler) calls :func:`softmax` /
:func:`logsumexp` so the paper's algorithms are swappable via config:

  * ``THREE_PASS_RECOMPUTE``  -- paper Alg 1 (max, sum-of-exp, recompute+scale)
  * ``THREE_PASS_RELOAD``     -- paper Alg 2 (max, exp+store, in-place scale)
  * ``TWO_PASS``              -- paper Alg 3 (ExtExp (m, n) monoid)

These are the plain tensor forms; the hand-written kernels live in
``repro_torch.kernels`` and are reached through
:class:`repro_torch.core.policy.SoftmaxPolicy` with ``use_kernels=True``.
"""

from __future__ import annotations

import enum

import torch

from repro_torch.core import twopass


class SoftmaxAlgorithm(str, enum.Enum):
    THREE_PASS_RECOMPUTE = "three_pass_recompute"
    THREE_PASS_RELOAD = "three_pass_reload"
    TWO_PASS = "two_pass"


def _threepass_recompute(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Paper Alg 1.  Pass 1: mu = max x.  Pass 2: sigma = sum e^(x-mu).
    Pass 3: y = e^(x-mu) / sigma (exp recomputed)."""
    mu = x.amax(dim=axis, keepdim=True)
    sigma = torch.exp(x - mu).sum(dim=axis, keepdim=True)
    return (torch.exp(x - mu) * (1.0 / sigma)).to(x.dtype)


def _threepass_reload(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Paper Alg 2.  Stores e^(x-mu) then rescales it."""
    mu = x.amax(dim=axis, keepdim=True)
    y = torch.exp(x - mu)
    sigma = y.sum(dim=axis, keepdim=True)
    return (y * (1.0 / sigma)).to(x.dtype)


_ALGOS = {
    SoftmaxAlgorithm.THREE_PASS_RECOMPUTE: _threepass_recompute,
    SoftmaxAlgorithm.THREE_PASS_RELOAD: _threepass_reload,
    SoftmaxAlgorithm.TWO_PASS: twopass.twopass_softmax,
}


def softmax(x: torch.Tensor, axis: int = -1,
            algorithm: SoftmaxAlgorithm | str = SoftmaxAlgorithm.TWO_PASS,
            use_kernel: bool = False) -> torch.Tensor:
    """Softmax along ``axis`` with a selectable memory-pass algorithm (shim
    over :class:`repro_torch.core.policy.SoftmaxPolicy`)."""
    from repro_torch.core.policy import SoftmaxPolicy  # avoid import cycle

    return SoftmaxPolicy(algorithm=SoftmaxAlgorithm(algorithm),
                         use_kernels=use_kernel).softmax(x, axis=axis)


def logsumexp(x: torch.Tensor, axis: int = -1, keepdims: bool = False,
              algorithm: SoftmaxAlgorithm | str = SoftmaxAlgorithm.TWO_PASS,
              ) -> torch.Tensor:
    """logsumexp with the selected algorithm's pass structure."""
    from repro_torch.core.policy import SoftmaxPolicy  # avoid import cycle

    return SoftmaxPolicy(algorithm=SoftmaxAlgorithm(algorithm)).logsumexp(
        x, axis=axis, keepdims=keepdims)
