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


class CutDraws:
    """A generator (or :class:`MetaDraws`) whose every draw goes through
    ``cut`` as soon as it is made: a rank keeps its shard of each drawn
    leaf (``model_zoo.Model.init_shard``) and never holds the whole tree;
    the draws, and so the values, are the generator's own."""

    def __init__(self, inner, cut):
        self.inner, self.cut = inner, cut
        self.device = inner.device


def _randn(gen, shape, dtype, scale: float, zero=None):
    """``shape`` standard normals times ``scale`` from ``gen`` (a
    ``torch.Generator``, :class:`MetaDraws` or :class:`CutDraws`);
    ``zero(t)`` zeroes parts of the draw in place before any cut."""
    inner = gen.inner if isinstance(gen, CutDraws) else gen
    if isinstance(inner, MetaDraws):
        t = torch.empty(shape, dtype=dtype, device=inner.device)
    else:
        # scaled in place: no second copy of a stacked leaf (granite-20b's
        # [52, 6144, 24576] is 15.7 GB in bf16); the same bits as
        # ``* scale``
        t = torch.randn(shape, generator=inner, device=inner.device,
                        dtype=dtype).mul_(scale)
        if zero is not None:
            zero(t)
    return gen.cut(t) if isinstance(gen, CutDraws) else t


def init_dense(gen, in_dim, out_dim, dtype, bias: bool = False,
               scale: float | None = None, lead: tuple = (),
               zero=None) -> Params:
    """``lead`` prepends stacked axes (the layer axis ``[L]``); ``zero``
    as :func:`_randn`'s, on ``w``."""
    scale = scale if scale is not None else in_dim ** -0.5
    p = {"w": _randn(gen, (*lead, in_dim, out_dim), dtype, scale, zero)}
    if bias:
        p["b"] = torch.zeros((*lead, out_dim), dtype=dtype,
                             device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def dense_row(p: Params, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product (an out-projection whose input dim is split
    over the model axis): each rank's partial ``x @ w`` summed over the
    ranks (``collectives.all_reduce``; the identity on one rank), then
    the bias, once.  The partials sum in another order than one product
    does, so a sharded result differs from the single-rank one by
    rounding."""
    from repro_torch.distributed import collectives

    y = collectives.all_reduce(x @ p["w"].to(x.dtype))
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
    """Column-parallel gate / up (their input through
    ``collectives.copy_to_model``), row-parallel down."""
    from repro_torch.distributed import collectives

    x = collectives.copy_to_model(x)
    up = dense(p["up"], x)
    if act == "silu":
        h = F.silu(dense(p["gate"], x)) * up
    else:
        # the tanh form, as the reference's ``jax.nn.gelu`` (its default
        # ``approximate=True``); the erf form differs by up to 4.7e-4
        h = F.gelu(up, approximate="tanh")
    return dense_row(p["down"], h)


def init_embedding(gen, vocab, d_model, dtype) -> Params:
    return {"table": _randn(gen, (vocab, d_model), dtype, d_model ** -0.5)}


def embed(p: Params, tokens: torch.Tensor, dtype,
          rows: int | None = None) -> torch.Tensor:
    """The tokens' rows of the table (gathered, then cast: the same values
    as casting the whole table).  Under a mesh whose model axis splits the
    vocabulary, ``rows`` is the full table's length and the lookup is
    vocab-parallel (``collectives.vocab_embed``)."""
    if rows is not None:
        from repro_torch.distributed import collectives

        return collectives.vocab_embed(p["table"], tokens, rows, dtype)
    return p["table"][tokens.long()].to(dtype)


def softmax_fn(cfg):
    """The softmax entry point bound to a model config, resolved once
    through the config's SoftmaxPolicy: ``f(scores, axis=-1)``."""
    policy = cfg.softmax_policy()

    def f(scores, axis=-1):
        return policy.softmax(scores, axis=axis)
    return f


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
