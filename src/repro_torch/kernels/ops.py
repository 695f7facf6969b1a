"""Public ops over the kernels: softmax under each of the paper's three
algorithms, cross-entropy, the fused LM-head cross-entropy and flash
attention (all differentiable), logsumexp stats and the two
decode-attention ops, with their dispatch.

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
from repro_torch.kernels import flash_attention as _fa
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
# The training ops, fused LM-head CE and flash attention.  Three
# implementations each, dispatched by ``train_bwd_impl``: "cuda" (the
# kernel wrappers; their plain versions for tensors on the CPU), "twopass"
# (the plain chunked (m, n) forms on any device) and "ref" (autograd over
# the materialised oracle of kernels/ref.py).
#
# Fused LM-head CE: loss(h @ w, labels) with the logits recomputed per vocab
# tile in the forward and in both backward products -- neither the [T, V]
# logits nor their gradient is stored whole (kernels/twopass_xent.py; the
# ``lmhead_xent`` registry op).
# ---------------------------------------------------------------------------
TRAIN_IMPLS = ("cuda", "twopass", "ref")


def _train_backend_impl(device) -> str:
    """The kernels ("cuda") for tensors on the card, the plain (m, n) forms
    ("twopass") elsewhere."""
    return ("cuda" if device is not None
            and torch.device(device).type == "cuda" else "twopass")


def train_bwd_impl(policy=None, impl: str | None = None,
                   device=None) -> str:
    """Implementation of :func:`lmhead_cross_entropy` and
    :func:`flash_attention`: an explicit ``impl`` wins;
    ``policy.use_kernels`` takes the kernels ("cuda") for tensors on the
    card and the plain (m, n) forms ("twopass") elsewhere; otherwise the
    materialised reference ("ref")."""
    if impl is not None:
        if impl not in TRAIN_IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        return impl
    if policy is not None and policy.use_kernels:
        return _train_backend_impl(device)
    return "ref"


def _lmhead_blocks(h, w, block_v, policy) -> int:
    """The vocab block: the backward kernels' dlogits slab and the plain
    forms' chunk width (the kernels' token tile is fixed at 128)."""
    return _blocks("lmhead_xent", h.shape[0], w.shape[1], None, block_v,
                   policy)[1]


class _LmheadCrossEntropy(torch.autograd.Function):
    """Forward saves ``h, w, labels`` and the ``(m_sum, n_sum)`` stats; the
    backward recomputes each vocab slab's logits once for both dh and dw.
    Nothing is padded: the kernels mask the ragged token and vocab edges
    themselves, so no padded token row ever reaches dw."""

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
            dh, dw = _xent.lmhead_xent_bwd_2d(*args, block_v=ctx.block_v)
        else:
            dh, dw = _xent.lmhead_xent_bwd_2d_plain(
                *args, _xent.lmhead_v_chunks(w.shape[1], ctx.block_v))
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


# ---------------------------------------------------------------------------
# Flash attention (kernels/flash_attention.py; the ``flash_attention`` and
# ``flash_attention_bwd`` registry ops): the forward saves o and the
# per-row (m_sum, n_sum); the backward recomputes the probabilities from
# them.  q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D], Hkv dividing H (GQA
# indexes KV head h // (H // Hkv); Hkv == H is the reference's pre-expanded
# layout).  Nothing is padded: the kernels mask ragged Sq / Skv edges
# themselves.
# ---------------------------------------------------------------------------
def _flash_fwd(q, k, v, causal, scale, window, blocks, impl):
    if impl == "cuda":
        return _fa.flash_attention_fwd_gqa(
            q, k, v, causal=causal, scale=scale, window=window,
            block_q=blocks[0], block_k=blocks[1])
    nq, nkv = _fa.chunk_counts(q.shape[2], k.shape[2], *blocks)
    return _fa.flash_attention_fwd_gqa_plain(
        q, k, v, causal=causal, scale=scale, window=window, n_q_chunks=nq,
        n_kv_chunks=nkv)


def _flash_bwd(q, k, v, o, m_sum, n_sum, do, causal, scale, window, blocks,
               impl):
    if impl == "cuda":
        return _fa.flash_attention_bwd_gqa(
            q, k, v, o, m_sum, n_sum, do, causal=causal, scale=scale,
            window=window, block_q=blocks[0], block_k=blocks[1])
    nq, nkv = _fa.chunk_counts(q.shape[2], k.shape[2], *blocks)
    return _fa.flash_attention_bwd_gqa_plain(
        q, k, v, o, m_sum, n_sum, do, causal=causal, scale=scale,
        window=window, n_q_chunks=nq, n_kv_chunks=nkv)


class _FlashAttention(torch.autograd.Function):
    """Forward saves ``q, k, v, o`` and the ``(m_sum, n_sum)`` stats; the
    backward recomputes ``p`` from them per tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, fwd_blocks, bwd_blocks,
                impl):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, m_sum, n_sum = _flash_fwd(q, k, v, causal, scale, window,
                                     fwd_blocks, impl)
        ctx.save_for_backward(q, k, v, o, m_sum, n_sum)
        ctx.args = (causal, scale, window, bwd_blocks, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m_sum, n_sum = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, m_sum, n_sum, do.contiguous(),
                                *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def _expand_kv(q, x):
    """K or V repeated to q's heads (the reference's layout)."""
    return x.repeat_interleave(q.shape[1] // x.shape[1], dim=1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: float | None = None,
                    window: int | None = None, block_q: int | None = None,
                    block_k: int | None = None, policy=None,
                    impl: str | None = None) -> torch.Tensor:
    """Attention ``[B, H, Sq, Dv]`` (v's head dim, which may differ from
    q's and k's D) through the stats-saving forward and the
    recompute-from-stats backward; differentiable in q, k and v (gradients
    in their shapes and dtypes).  Masks are end-aligned (query ``i`` at position
    ``i + Skv - Sq``).  ``block_q`` / ``block_k`` override the plain forms'
    chunk lengths; ``impl`` pins "cuda" | "twopass" | "ref" (None: the
    policy's; "ref" is autograd over ``ref.attention_ref`` with K/V
    repeated to the q-heads)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    impl = train_bwd_impl(policy, impl, q.device)
    if impl == "ref":
        return _ref.attention_ref(q, _expand_kv(q, k), _expand_kv(q, v),
                                  causal=causal, scale=scale, window=window)
    # the blocks are the plain forms' chunk lengths (the kernels' tile is
    # fixed)
    sq, skv = q.shape[2], k.shape[2]
    return _FlashAttention.apply(
        q, k, v, causal, scale, window,
        _blocks("flash_attention", sq, skv, block_q, block_k, policy),
        _blocks("flash_attention_bwd", sq, skv, block_q, block_k, policy),
        impl)


def _stats_impl(q, impl):
    impl = impl or _train_backend_impl(q.device)
    if impl not in ("cuda", "twopass"):
        raise ValueError(f"impl {impl!r}: the stats-saving forms are "
                         "'cuda' or 'twopass'")
    return impl


def flash_attention_fwd_stats(q, k, v, *, causal: bool = False,
                              scale: float | None = None,
                              window: int | None = None,
                              block_q: int | None = None,
                              block_k: int | None = None, policy=None,
                              impl: str | None = None):
    """``(o, m_sum, n_sum)`` of the stats-saving forward, the residuals
    :func:`flash_attention_bwd` takes.  ``impl`` is "cuda" or "twopass"
    (None: the kernels on the card, the plain forms elsewhere)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    impl = _stats_impl(q, impl)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _flash_fwd(q, k, v, causal, scale, window,
                      _blocks("flash_attention", q.shape[2], k.shape[2],
                              block_q, block_k, policy), impl)


def flash_attention_bwd(q, k, v, o, m_sum, n_sum, do, *,
                        causal: bool = False, scale: float | None = None,
                        window: int | None = None,
                        block_q: int | None = None,
                        block_k: int | None = None, policy=None,
                        impl: str | None = None):
    """``(dq, dk, dv)`` from the forward's saved ``(m_sum, n_sum)`` at the
    same mask and scale; ``impl`` as in :func:`flash_attention_fwd_stats`.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    impl = _stats_impl(q, impl)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    return _flash_bwd(q, k, v, o, m_sum, n_sum, do, causal, scale, window,
                      _blocks("flash_attention_bwd", q.shape[2], k.shape[2],
                              block_q, block_k, policy), impl)


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
