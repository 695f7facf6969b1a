"""AdamW over a parameter tree (nested dicts of tensors), with global-norm
clipping.  Moments are float32 whatever the parameter dtype.

The update runs IN PLACE (the reference is functional): at full width a
second copy of the parameters and both moments would not fit on the card.
Its arithmetic is the reference's, operation for operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: dict
    v: dict


def leaves(tree) -> list:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return AdamWState(step, zeros, tree_map(torch.clone, zeros))


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """The norm of all of ``tree``'s values.  Under a ``mesh``, ``tree``
    holds this rank's shards (cut by ``specs``): each rank sums the
    squares of the leaves it is the first holder of
    (``sharding.first_holder``: a leaf replicated along an axis counts
    once, not once a rank), and one ``all_reduce`` over the world adds
    them, so every rank takes the same norm."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in leaves(tree)))
    import torch.distributed as dist

    from repro_torch.distributed.sharding import first_holder, flatten

    # specs read by path: their insertion order may differ from tree's
    spec_of = dict(flatten(specs))
    sq = torch.zeros((), dtype=torch.float32, device=leaves(tree)[0].device)
    for path, x in flatten(tree):
        if first_holder(spec_of[path], mesh):
            sq = sq + torch.sum(torch.square(x.to(torch.float32)))
    dist.all_reduce(sq)
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """``(clipped grads, norm)``; the scale is ``min(1, max_norm /
    max(norm, 1e-9))``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


@torch.no_grad()
def update(grads, state: AdamWState, params, lr, *, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, max_grad_norm: float | None = 1.0,
           mesh=None, specs=None):
    """One AdamW step: ``params`` and the moments change in place.  Returns
    ``(params, new_state, metrics)``.  ``grads`` is a tree like ``params``;
    its tensors are clipped in place.  Under a ``mesh`` the trees hold this
    rank's shards by ``specs``: the norm is global (:func:`global_norm`),
    so every rank clips by the same scale, and the update, elementwise,
    runs on the shards as they are."""
    gnorm = global_norm(grads, mesh, specs)
    scale = (_clip_scale(gnorm, max_grad_norm)
             if max_grad_norm is not None else None)
    step = state.step + 1
    b1c = 1.0 - b1 ** step.to(torch.float32)
    b2c = 1.0 - b2 ** step.to(torch.float32)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        if scale is not None:
            g = g.mul_(scale.to(g.dtype))
        gf = g.to(torch.float32)
        t = gf * (1 - b1)
        m.mul_(b1).add_(t)                        # b1 m + (1 - b1) g
        torch.mul(gf, 1 - b2, out=t)
        v.mul_(b2).add_(t.mul_(gf))               # b2 v + (1 - b2) g g
        torch.div(m, b1c, out=t)                  # mhat
        u = torch.div(v, b2c)                     # vhat
        t.div_(u.sqrt_().add_(eps))
        pf = p.to(torch.float32)
        t.add_(torch.mul(pf, weight_decay, out=u))   # delta
        t.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(t)
        else:
            p.copy_(pf - t)
        del t, u, gf, g
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
