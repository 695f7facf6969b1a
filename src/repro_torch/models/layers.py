"""Shared model layers: norms, MLPs, embeddings, RoPE and M-RoPE.

Functional style, as in the reference: ``init_*(gen, ...) -> params`` (a
nested dict of tensors) plus apply functions.  Weights keep the reference's
layout: a dense weight is ``[in, out]`` and is used as ``x @ w``.

Every use casts a weight to the activation dtype first, so weights stored in
the compute dtype (bf16 on the card) give the same results as float32
weights cast at each use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Params = dict


class MetaDraws:
    """Stands in for a generator on the ``meta`` device, which has none:
    the ``init_*`` functions then give shapes and dtypes with no storage
    and nothing drawn."""
    device = torch.device("meta")


def _randn(gen: torch.Generator | MetaDraws, shape, dtype, scale: float):
    if isinstance(gen, MetaDraws):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    # scaled in place: no second copy of a stacked leaf (granite-20b's
    # [52, 6144, 24576] is 15.7 GB in bf16); the same bits as ``* scale``
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(scale)


def init_dense(gen, in_dim, out_dim, dtype, bias: bool = False,
               scale: float | None = None, lead: tuple = ()) -> Params:
    """``lead`` prepends stacked axes (the layer axis ``[L]``)."""
    scale = scale if scale is not None else in_dim ** -0.5
    p = {"w": _randn(gen, (*lead, in_dim, out_dim), dtype, scale)}
    if bias:
        p["b"] = torch.zeros((*lead, out_dim), dtype=dtype,
                             device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_rmsnorm(dim, dtype, device, lead: tuple = ()) -> Params:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) \
        * p["scale"].to(x.dtype)


def init_mlp(gen, d_model, d_ff, dtype, act: str = "silu",
             lead: tuple = ()) -> Params:
    p = {"up": init_dense(gen, d_model, d_ff, dtype, lead=lead),
         "down": init_dense(gen, d_ff, d_model, dtype, lead=lead)}
    if act == "silu":                      # SwiGLU needs the gate branch
        p["gate"] = init_dense(gen, d_model, d_ff, dtype, lead=lead)
    return p


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = dense(p["up"], x)
    if act == "silu":
        h = F.silu(dense(p["gate"], x)) * up
    else:
        # the tanh form, as the reference's ``jax.nn.gelu`` (its default
        # ``approximate=True``); the erf form differs by up to 4.7e-4
        h = F.gelu(up, approximate="tanh")
    return dense(p["down"], h)


def init_embedding(gen, vocab, d_model, dtype) -> Params:
    return {"table": _randn(gen, (vocab, d_model), dtype, d_model ** -0.5)}


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather first, then cast: the same values as casting the whole table
    return p["table"][tokens.long()].to(dtype)


# ---------------------------------------------------------------------------
# RoPE (rotate-half convention), and M-RoPE for qwen2-vl.
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, ...] | None = None):
    """positions: [..., S] int -> cos, sin of shape [..., S, head_dim//2]
    (f32).  With ``sections`` (qwen2-vl's M-RoPE: the half-dim split per
    stream, summing to ``head_dim // 2``) positions are [3, ..., S], the
    temporal / height / width streams, and each frequency band takes its
    angle from the stream its section belongs to."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * inv
    if sections is not None:
        if positions.ndim < 2 or positions.shape[0] != len(sections):
            raise ValueError(f"M-RoPE positions {tuple(positions.shape)} "
                             f"for {len(sections)} sections")
        parts, lo = [], 0
        for i, width in enumerate(sections):
            parts.append(ang[i, ..., lo:lo + width])
            lo += width
        ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D/2] or [S, D/2].  Rotates the pairs
    (x[..., :D/2], x[..., D/2:])."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
