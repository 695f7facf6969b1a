"""Plain oracles for the kernels in this package.

These use the max-subtraction formulation (not ExtExp), so a kernel and its
oracle share no code.
"""

from __future__ import annotations

import torch


def softmax_ref(x: torch.Tensor) -> torch.Tensor:
    """Rowwise softmax oracle (last axis), f32 accumulation."""
    xf = x.to(torch.float32)
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def logsumexp_ref(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.amax(dim=-1, keepdim=True)
    return (torch.log(torch.exp(xf - mu).sum(dim=-1))
            + mu[..., 0]).to(x.dtype)


def cross_entropy_ref(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE oracle: ``lse(logits) - logits[label]``, float32."""
    lf = logits.to(torch.float32)
    ll = torch.gather(lf, -1, labels.to(torch.int64)[:, None])[:, 0]
    return logsumexp_ref(lf) - ll


def lmhead_ref_loss(h: torch.Tensor, w: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """The fused LM-head CE's oracle: materialised float32 logits
    ``h @ w`` through :func:`cross_entropy_ref`; differentiable in h and w
    by autograd."""
    return cross_entropy_ref(h.to(torch.float32) @ w.to(torch.float32),
                             labels)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, scale: float | None = None,
                  window: int | None = None) -> torch.Tensor:
    """Multi-head attention oracle.  q, k, v: [B, H, S, D] (H already GQA-
    expanded).  ``window`` = sliding-window size (inclusive of self)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    sq, skv = q.shape[2], k.shape[2]
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
