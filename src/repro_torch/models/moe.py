"""Mixture-of-Experts layer (granite-moe).

The router is a softmax over experts, a paper-technique site: it resolves
through the config's ``SoftmaxPolicy`` (the algorithm and the kernel
switch), so with ``use_kernels`` its ``[tokens, E]`` float32 rows run
through the softmax kernels.

Three implementations, as the reference's (``moe_impl``):

  * ``dense``    -- every expert computes every token, the combine masked
                    to the top-k.  Exactly dropless, E/k x the compute.
  * ``dispatch`` -- GShard capacity dispatch: one-hot dispatch / combine
                    products, ``cap = max(1, int(s k capacity_factor /
                    E))`` queue slots an expert; a (token, k) past its
                    expert's capacity is dropped.
  * ``gather``   -- the same capacity and drops, the dispatch an integer
                    scatter into an ``E cap``-slot token table and a
                    gather, the combine a gather of each token's k outputs.

Experts are stacked on a leading E axis and run as batched products over
it.  Every op of ``dispatch`` and ``gather`` has a static shape and reads
nothing back to the host, so a decode step through them can be captured
in a CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

Params = dict


def init_moe(gen, cfg: ModelConfig, dtype, lead: tuple = ()) -> Params:
    """The reference's tree: ``router.w`` [d, E] (float32 whatever
    ``dtype``), ``wg`` / ``wu`` [E, d, d_expert], ``wd`` [E, d_expert, d],
    and ``shared`` (a SwiGLU MLP) with shared experts; ``lead`` prepends
    the layer axis."""
    m, d = cfg.moe, cfg.d_model
    e, f = m.n_experts, m.d_expert
    p = {"router": layers.init_dense(gen, d, e, torch.float32, lead=lead),
         "wg": layers.init_dense(gen, d, f, dtype, lead=(*lead, e))["w"],
         "wu": layers.init_dense(gen, d, f, dtype, lead=(*lead, e))["w"],
         "wd": layers.init_dense(gen, f, d, dtype, lead=(*lead, e))["w"]}
    if m.n_shared:
        p["shared"] = layers.init_mlp(gen, d, m.n_shared * f, dtype,
                                      act="silu", lead=lead)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``[..., n]``: a comparison with ``arange(n)``, which reads nothing
    back (``F.one_hot`` checks its indices on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _router(p, x, cfg: ModelConfig):
    """Top-k routing.  x: [B, S, d] -> (weights [B, S, k] in ``x.dtype``,
    expert ids [B, S, k], probabilities [B, S, E] float32).

    The top k are taken by a stable descending sort, so equal
    probabilities give the lower expert id first, as ``jax.lax.top_k``
    does (``torch.topk`` does not): the order decides the experts and,
    through the queue order, which tokens drop."""
    m = cfg.moe
    logits = x.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs = cfg.softmax_policy().softmax(logits, axis=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :m.top_k], idx[..., :m.top_k]
    w = w / w.sum(dim=-1, keepdim=True)               # renormalise the top k
    return w.to(x.dtype), idx, probs


def _experts(p, xe):
    """Each expert's SwiGLU FFN on its own rows: xe [E, ..., d] -> [E, ...,
    d], one batched product a weight over the stacked E axis."""
    e, d = xe.shape[0], xe.shape[-1]
    flat = xe.reshape(e, -1, d)
    h = F.silu(torch.bmm(flat, p["wg"].to(xe.dtype))) \
        * torch.bmm(flat, p["wu"].to(xe.dtype))
    return torch.bmm(h, p["wd"].to(xe.dtype)).reshape(xe.shape)


def moe_dense(p, x, cfg: ModelConfig):
    """Dropless: every expert on every token, the combine masked to the
    top k."""
    m = cfg.moe
    w, idx, _ = _router(p, x, cfg)
    y_all = _experts(p, x.expand(m.n_experts, *x.shape))   # [E, B, S, d]
    onehot = _one_hot(idx, m.n_experts, x.dtype)            # [B, S, k, E]
    combine = torch.einsum("bske,bsk->ebs", onehot, w)
    return torch.einsum("ebs,ebsd->bsd", combine, y_all)


def _groups(x, group_size: int):
    """Batch rows x ``group_size`` sequence slices, as the reference: only
    a length that is a multiple of the group and longer than it is
    reshaped."""
    b0, s0, d = x.shape
    g = min(group_size, s0)
    if s0 % g == 0 and s0 > g:
        x = x.reshape(b0 * (s0 // g), g, d)
    return x


def _capacity(s: int, cfg: ModelConfig, capacity_factor: float) -> int:
    m = cfg.moe
    return max(1, int(s * m.top_k * capacity_factor / m.n_experts))


def _queue_slots(idx, n_experts: int):
    """(one-hot [B, S, k, E] int32, each (token, k)'s slot in its expert's
    queue [B, S, k]): the queue fills in flattened (token, k) order."""
    b, s, k = idx.shape
    onehot = _one_hot(idx, n_experts, torch.int32)
    flat = onehot.reshape(b, s * k, n_experts)
    pos = ((torch.cumsum(flat, dim=1) - 1) * flat).sum(-1)
    return onehot, pos.reshape(b, s, k)


def moe_dispatch(p, x, cfg: ModelConfig, capacity_factor: float = 1.25,
                 group_size: int = 2048):
    """GShard capacity dispatch: one-hot dispatch / combine products over
    groups of ``group_size`` tokens, ``cap`` queue slots an expert."""
    m = cfg.moe
    b0, s0, d = x.shape
    x = _groups(x, group_size)
    b, s, _ = x.shape
    cap = _capacity(s, cfg, capacity_factor)
    w, idx, _ = _router(p, x, cfg)                    # [B, S, k]
    onehot, pos = _queue_slots(idx, m.n_experts)
    # a slot past the capacity matches no column: the (token, k) drops
    slot_oh = _one_hot(pos, cap, x.dtype)             # [B, S, k, C]
    onehot = onehot.to(x.dtype)
    # disp[b, s, e, c] = 1 iff token s takes slot c of expert e
    disp = torch.einsum("bske,bskc->bsec", onehot, slot_oh)
    xe = torch.einsum("bsec,bsd->ebcd", disp, x)      # [E, B, C, d]
    ye = _experts(p, xe)
    # the reference's "bsec,bsk,bske->bsec" without its [B, S, k, E, C]
    # operand: a token's top-k experts are distinct, so the k-sum has one
    # term an expert and is exact
    comb = disp * (w[..., None] * onehot).sum(2)[..., None]
    y = torch.einsum("bsec,ebcd->bsd", comb, ye)
    return y.reshape(b0, s0, d)


def moe_gather(p, x, cfg: ModelConfig, capacity_factor: float = 1.25,
               group_size: int = 2048):
    """The capacity and drops of :func:`moe_dispatch`, the dispatch an
    integer scatter into an ``E cap``-slot token table (``+1`` so 0 is
    empty; dropped (token, k) land in one extra slot, stripped after)
    and a gather, the combine a gather of each token's k outputs."""
    m = cfg.moe
    e = m.n_experts
    b0, s0, d = x.shape
    x = _groups(x, group_size)
    b, s, _ = x.shape
    cap = _capacity(s, cfg, capacity_factor)
    w, idx, _ = _router(p, x, cfg)                    # [B, S, k]
    _, pos = _queue_slots(idx, e)
    within = pos < cap
    slot = torch.where(within, idx * cap + pos, e * cap)   # drop slot E cap
    tok_ids = (torch.arange(s, device=x.device) + 1)[:, None].expand(
        s, m.top_k).reshape(-1)
    table = torch.zeros((b, e * cap + 1), dtype=torch.int64, device=x.device)
    table.scatter_(1, slot.reshape(b, -1), tok_ids.expand(b, -1))
    table = table[:, :-1]                             # strip the drop slot

    xe = torch.gather(x, 1, (table - 1).clamp(min=0)[..., None].expand(
        -1, -1, d))
    xe = xe * (table > 0)[..., None].to(x.dtype)      # zero empty slots
    ye = _experts(p, xe.reshape(b, e, cap, d).transpose(0, 1))
    ye_flat = ye.transpose(0, 1).reshape(b, e * cap, d)

    safe = torch.where(within, slot, 0).reshape(b, -1)
    yk = torch.gather(ye_flat, 1, safe[..., None].expand(-1, -1, d))
    yk = yk.reshape(b, s, m.top_k, d)
    yk = yk * within[..., None].to(x.dtype) * w[..., None]
    return yk.sum(dim=2).reshape(b0, s0, d)


_MOE_IMPLS = {"dense": moe_dense, "dispatch": moe_dispatch,
              "gather": moe_gather}


def moe_apply(p, x, cfg: ModelConfig, impl: str = "dispatch"):
    """The routed experts by ``impl``, plus the shared experts' MLP."""
    y = _MOE_IMPLS[impl](p, x, cfg)
    if cfg.moe.n_shared:
        y = y + layers.mlp(p["shared"], x, act="silu")
    return y


def aux_load_balance_loss(p, x, cfg: ModelConfig):
    """Switch-style load-balance loss: E times the sum over experts of the
    share of tokens whose first choice it is and its mean probability."""
    m = cfg.moe
    _, idx, probs = _router(p, x, cfg)
    frac_tokens = _one_hot(idx[..., 0], m.n_experts,
                           torch.float32).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return m.n_experts * (frac_tokens * frac_probs).sum()
