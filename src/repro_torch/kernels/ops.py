"""Public ops over the kernels: softmax under each of the paper's three
algorithms and cross-entropy (both differentiable), logsumexp stats and the
two decode-attention ops, with their dispatch.

Dispatch: the kernel wrappers launch their CUDA kernel for a tensor on the
card and run their plain version for a tensor on the CPU.  An op takes the
kernel wrapper when its :class:`SoftmaxPolicy` says ``use_kernels`` (or an
explicit ``use_kernel=`` says so) and the plain (m, n) chunked forms
otherwise, on any device.  Block shapes resolve through
``repro_torch.kernels.registry``.

float32 matrix products on the card must not run in TF32: this package
turns it off where it is imported (``repro_torch/__init__.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.softmax_api import SoftmaxAlgorithm
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import registry
from repro_torch.kernels import threepass_softmax as _tp3
from repro_torch.kernels import twopass_softmax as _tp2
from repro_torch.kernels import twopass_xent as _xent

# Chunk-count guards of the plain chunked forms, which live beside the
# kernels they are held against (kernels/decode_attention.py).
MAX_SLOT_CHUNKS = 8
MAX_T_CHUNKS = 16


def _blocks(op: str, rows: int, cols: int, block_rows, block_cols,
            policy=None) -> tuple[int, int]:
    """Explicit args win, then the policy's overrides, then the registry."""
    if policy is not None:
        return policy.resolve_blocks(op, rows, cols, block_rows=block_rows,
                                     block_cols=block_cols)
    return registry.block_shapes(op, rows, cols, block_rows=block_rows,
                                 block_cols=block_cols)


_SOFTMAX_2D = {
    SoftmaxAlgorithm.TWO_PASS: _tp2.twopass_softmax_2d,
    SoftmaxAlgorithm.THREE_PASS_RECOMPUTE: _tp3.threepass_recompute_2d,
    SoftmaxAlgorithm.THREE_PASS_RELOAD: _tp3.threepass_reload_2d,
}


class _Softmax(torch.autograd.Function):
    """Softmax kernel of the chosen algorithm with the analytic VJP
    ``dx = y * (dy - sum(dy * y))``, which needs only ``y``."""

    @staticmethod
    def forward(ctx, x, algorithm):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = _SOFTMAX_2D[algorithm](x2).reshape(x.shape)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        yf, dyf = y.to(torch.float32), dy.to(torch.float32)
        dx = yf * (dyf - (dyf * yf).sum(dim=-1, keepdim=True))
        return dx.to(y.dtype), None


def softmax(x: torch.Tensor,
            algorithm: SoftmaxAlgorithm | str = SoftmaxAlgorithm.TWO_PASS
            ) -> torch.Tensor:
    """Last-axis softmax through the kernel of ``algorithm`` (any leading
    dims); differentiable."""
    return _Softmax.apply(x, SoftmaxAlgorithm(algorithm))


class _CrossEntropy(torch.autograd.Function):
    """Fused cross-entropy: the forward is pass 1 (no probability is
    stored), the backward pass 2 from the saved ``(m_sum, n_sum)``."""

    @staticmethod
    def forward(ctx, logits, labels):
        logits = logits.contiguous()
        loss, m_sum, n_sum = _xent.xent_fwd_2d(logits, labels)
        ctx.save_for_backward(logits, labels, m_sum, n_sum)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, m_sum, n_sum = ctx.saved_tensors
        return _xent.xent_bwd_2d(logits, labels, m_sum, n_sum,
                                 dloss.contiguous()), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Per-token CE loss ``[T, V], [T] -> [T]`` float32, probabilities never
    materialised; differentiable in ``logits``.  The kernel sweeps whole
    rows, so nothing is padded."""
    return _CrossEntropy.apply(logits, labels)


def logsumexp_stats(x: torch.Tensor):
    """Pass-1 stats ``(m_sum, n_sum)``, each ``[R, 1]`` f32, of 2-D x."""
    return _tp2.twopass_stats_2d(x.contiguous())


def _kernel_path(policy, use_kernel) -> bool:
    """Explicit ``use_kernel`` wins; otherwise the policy's switch."""
    if use_kernel is not None:
        return bool(use_kernel)
    return policy is not None and policy.use_kernels


def decode_attention(q, k, v, lengths, *, scale: float | None = None,
                     window: int | None = None, block_s: int | None = None,
                     block_t: int | None = None, policy=None,
                     use_kernel: bool | None = None) -> torch.Tensor:
    """Single-query attention against a length-masked KV cache.

    q: [S, Hkv, G, D]; k: [S, Hkv, T, D]; v: [S, Hkv, T, Dv]; lengths: [S]
    valid prefix per slot (0 = free slot, exact zeros).  Returns
    [S, Hkv, G, Dv].  Registry: rows = S, cols = T; the kernel folds
    ``block_t`` positions per tile, the plain form uses the blocks as chunk
    lengths."""
    s, _, _, d = q.shape
    t = k.shape[2]
    bs, bt = _blocks("decode_attention", s, t, block_s, block_t, policy)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if _kernel_path(policy, use_kernel):
        return _da.decode_attention(q, k, v, lengths, scale=scale,
                                    window=window, block_t=bt)
    return _da.decode_attention_plain(
        q, k, v, lengths, scale=scale, window=window,
        n_s_chunks=min(MAX_SLOT_CHUNKS, -(-s // bs)),
        n_t_chunks=min(MAX_T_CHUNKS, -(-t // bt)))


def decode_attention_paged(q, k_pages, v_pages, page_table, lengths, *,
                           scale: float | None = None,
                           window: int | None = None,
                           k_scale=None, v_scale=None,
                           block_s: int | None = None,
                           block_t: int | None = None, policy=None,
                           use_kernel: bool | None = None) -> torch.Tensor:
    """Single-query attention against a PAGED KV cache (arenas
    ``[P, ps, Hkv, D]``, ``page_table [S, Pmax]``), identical up to sum
    order to :func:`decode_attention` over the contiguous cache the table
    describes.  Registry: rows = S, cols = Pmax * ps; the col block is
    rounded down to whole pages (``pages_per_tile``)."""
    s, _, _, d = q.shape
    ps = k_pages.shape[1]
    pmax = page_table.shape[1]
    bs, bt = _blocks("decode_attention_paged", s, pmax * ps, block_s,
                     block_t, policy)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    pages_per_chunk = max(1, bt // ps)
    if _kernel_path(policy, use_kernel):
        return _da.decode_attention_paged(
            q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
            scale=scale, window=window, pages_per_tile=pages_per_chunk)
    return _da.decode_attention_paged_plain(
        q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
        scale=scale, window=window,
        n_s_chunks=min(MAX_SLOT_CHUNKS, -(-s // bs)),
        n_t_chunks=min(MAX_T_CHUNKS, -(-pmax // pages_per_chunk)))
