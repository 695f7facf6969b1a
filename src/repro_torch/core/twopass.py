"""Two-Pass softmax / logsumexp (paper Alg 3) as plain tensor code, their
forms over a process group (one collective of the (m, n) pairs), and the
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


# ---------------------------------------------------------------------------
# Distributed combines (the paper's monoid promoted to a process group).
# ---------------------------------------------------------------------------
def _model_group(group):
    """``group``, or the active mesh's model axis (None: no mesh)."""
    if group is not None:
        return group
    from repro_torch.distributed import autoshard

    mesh = autoshard.active_mesh()
    if mesh is None or mesh.size("model") == 1:
        return None
    return mesh.group("model")


def ext_sum_sharded(x_local: torch.Tensor, group=None,
                    reduce_axis: int = -1, stats=None) -> ExtFloat:
    """Pass 1 on this rank's slice of the reduced axis (e.g. a vocabulary
    shard), then ONE collective of the 2-float-per-row ``(m, n)`` payload
    and the fold.  Three-pass would need two collectives (a max, then a
    sum); the (m, n) monoid carries both in one.

    ``group`` is a process group whose ranks each hold a slice (None: the
    active mesh's model axis; with neither, the local sum).  ``stats``
    computes the local pass 1, ``(m_sum, n_sum)`` with the reduced axis
    kept (default: the plain form; the engine passes its policy's, kernel
    2 on the card).  The pairs are gathered as the ``all_reduce`` of a
    zero-filled ``[ranks, 2, ...]`` buffer that each rank fills in its own
    row: adding zeros is exact."""
    local = (stats(x_local) if stats is not None
             else ext_sum(ext_exp(x_local), axis=reduce_axis, keepdims=True))
    group = _model_group(group)
    if group is None:
        return local
    import torch.distributed as dist

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    buf = local.mantissa.new_zeros((world, 2, *local.mantissa.shape))
    buf[rank, 0] = local.mantissa
    buf[rank, 1] = local.exponent
    dist.all_reduce(buf, group=group)
    return ext_sum(ExtFloat(buf[:, 0], buf[:, 1]), axis=0)


def twopass_softmax_sharded(x_local: torch.Tensor, group=None,
                            reduce_axis: int = -1,
                            stats=None) -> torch.Tensor:
    """The slice of the global softmax that this rank's slice ``x_local``
    of the reduced axis owns: :func:`ext_sum_sharded`, then pass 2 scales
    the local slice by the global ``(m, n)``."""
    s = ext_sum_sharded(x_local, group, reduce_axis, stats)
    return numerics.ext_ratio_scale(ext_exp(x_local), s).to(x_local.dtype)


def twopass_logsumexp_sharded(x_local: torch.Tensor, group=None,
                              reduce_axis: int = -1,
                              stats=None) -> torch.Tensor:
    """The global logsumexp (reduced axis kept) with one collective."""
    s = ext_sum_sharded(x_local, group, reduce_axis, stats)
    return ext_log(s).to(x_local.dtype)


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
