"""Public ops over the kernels: softmax under each of the paper's three
algorithms, cross-entropy and the fused LM-head cross-entropy (all
differentiable), logsumexp stats and the two decode-attention ops, with
their dispatch.

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
from repro_torch.kernels import ref as _ref
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


# ---------------------------------------------------------------------------
# Fused LM-head CE: loss(h @ w, labels) with the logits recomputed per vocab
# tile in the forward and in both backward products -- neither the [T, V]
# logits nor their gradient is stored whole.  Three implementations,
# dispatched by ``train_bwd_impl``: "cuda" (the kernel wrappers of
# kernels/twopass_xent.py; their plain versions for tensors on the CPU),
# "twopass" (the plain chunked (m, n) forms on any device) and "ref"
# (autograd over the materialised-logits oracle).  The ``lmhead_xent``
# registry op.
# ---------------------------------------------------------------------------
TRAIN_IMPLS = ("cuda", "twopass", "ref")


def train_bwd_impl(policy=None, impl: str | None = None,
                   device=None) -> str:
    """Implementation of :func:`lmhead_cross_entropy`: an explicit ``impl``
    wins; ``policy.use_kernels`` takes the kernels ("cuda") for tensors on
    the card and the plain (m, n) forms ("twopass") elsewhere; otherwise
    the materialised reference ("ref")."""
    if impl is not None:
        if impl not in TRAIN_IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        return impl
    if policy is not None and policy.use_kernels:
        return ("cuda" if device is not None
                and torch.device(device).type == "cuda" else "twopass")
    return "ref"


def _lmhead_blocks(h, w, block_v, policy) -> int:
    """The vocab block: the backward kernels' dlogits slab and the plain
    forms' chunk width (the kernels' token tile is fixed at 128)."""
    return _blocks("lmhead_xent", h.shape[0], w.shape[1], None, block_v,
                   policy)[1]


class _LmheadCrossEntropy(torch.autograd.Function):
    """Forward saves ``h, w, labels`` and the ``(m_sum, n_sum)`` stats; the
    backward recomputes the logits for dh and for dw.  Nothing is padded:
    the kernels mask the ragged token and vocab edges themselves, so no
    padded token row ever reaches dw."""

    @staticmethod
    def forward(ctx, h, w, labels, block_v, impl):
        h, w = h.contiguous(), w.contiguous()
        if impl == "cuda":
            loss, m_sum, n_sum = _xent.lmhead_xent_fwd_2d(h, w, labels,
                                                          block_v=block_v)
        else:
            loss, m_sum, n_sum = _xent.lmhead_xent_fwd_2d_plain(
                h, w, labels, _xent.lmhead_v_chunks(w.shape[1], block_v))
        ctx.save_for_backward(h, w, labels, m_sum, n_sum)
        ctx.block_v, ctx.impl = block_v, impl
        return loss

    @staticmethod
    def backward(ctx, dloss):
        h, w, labels, m_sum, n_sum = ctx.saved_tensors
        args = (h, w, labels, m_sum, n_sum, dloss.contiguous())
        if ctx.impl == "cuda":
            dh = _xent.lmhead_xent_dh_2d(*args, block_v=ctx.block_v)
            dw = _xent.lmhead_xent_dw_2d(*args, block_v=ctx.block_v)
        else:
            n = _xent.lmhead_v_chunks(w.shape[1], ctx.block_v)
            dh = _xent.lmhead_xent_dh_2d_plain(*args, n)
            dw = _xent.lmhead_xent_dw_2d_plain(*args, n)
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


def lmhead_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                         labels: torch.Tensor, block_v: int | None = None,
                         policy=None, impl: str | None = None
                         ) -> torch.Tensor:
    """Per-token CE of ``h @ w`` against ``labels`` without materialising
    the logits.  h: [T, D]; w: [D, V]; labels: [T] int -> loss [T] float32.
    Differentiable in h and w (gradients in their dtypes); labels get
    none.  ``impl`` pins "cuda" | "twopass" | "ref" (None: the policy's)."""
    impl = train_bwd_impl(policy, impl, h.device)
    if impl == "ref":
        return _ref.lmhead_ref_loss(h, w, labels)
    return _LmheadCrossEntropy.apply(
        h, w, labels, _lmhead_blocks(h, w, block_v, policy), impl)


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
