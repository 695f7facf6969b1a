"""The train step: loss -> gradients -> clip -> (compress) -> AdamW.

Gradients come from ``loss.backward()`` on the parameters, which are made
leaves that require grad for the step and are released after it, so no
autograd graph outlives a step.  Microbatches accumulate float32 gradients
in an unrolled loop, as in the reference.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.distributed import compression
from repro_torch.models.model_zoo import Model
from repro_torch.optim import adamw, schedules
from repro_torch.training.train_state import TrainState


def _to_device(batch: dict, device) -> dict:
    return {k: (torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v)
                else v).to(device) for k, v in batch.items()}


def loss_and_grads(model: Model, params, batch: dict, policy=None):
    """``(loss, grads)`` of ``model.loss`` at ``params``: ``grads`` has the
    tree of ``params`` and their dtypes.  ``params`` are unchanged and hold
    no gradient afterwards."""
    ps = adamw.leaves(params)
    for p in ps:
        p.requires_grad_(True)
        p.grad = None
    try:
        loss = model.loss(params, batch, policy=policy)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in ps]
    finally:
        for p in ps:
            p.grad = None
            p.requires_grad_(False)
    it = iter(grads)
    return loss.detach(), adamw.tree_map(lambda _: next(it), params)


def make_train_step(model: Model, *, lr_schedule: Callable | None = None,
                    microbatches: int = 1, grad_compression: str = "none",
                    max_grad_norm: float | None = 1.0,
                    softmax_policy=None):
    """``train_step(state, batch) -> (state, metrics)``; ``metrics`` holds
    ``loss``, ``lr`` and ``grad_norm`` (0-d float32 tensors).  The state's
    parameters and moments are updated in place.  ``softmax_policy``
    overrides the model config's policy for the loss only: the
    training-side switch for the fused LM-head CE kernels."""
    lr_fn = lr_schedule or functools.partial(schedules.warmup_cosine)
    policy = softmax_policy or model.cfg.softmax_policy()
    if grad_compression not in ("none", "bf16"):
        raise NotImplementedError(
            f"grad_compression={grad_compression!r} is not ported yet "
            "(ROADMAP queue A item 23)")

    def train_step(state: TrainState, batch: dict):
        batch = _to_device(batch, model.device)
        if microbatches > 1:
            def slice_mb(i):
                return {k: x.reshape(microbatches, -1, *x.shape[1:])[i]
                        for k, x in batch.items()}

            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state.params)
            for i in range(microbatches):
                li, gi = loss_and_grads(model, state.params, slice_mb(i),
                                        policy)
                loss = loss + li / microbatches
                for a, g in zip(adamw.leaves(grads), adamw.leaves(gi)):
                    a.add_(g.to(torch.float32) / microbatches)
                del gi
        else:
            loss, grads = loss_and_grads(model, state.params, batch, policy)

        if grad_compression == "bf16":
            grads = compression.decompress_bf16(
                compression.compress_bf16(grads))

        lr = lr_fn(state.opt.step)
        params, opt, metrics = adamw.update(
            grads, state.opt, state.params, lr, max_grad_norm=max_grad_norm)
        return TrainState(params, opt), dict(metrics, loss=loss, lr=lr)

    return train_step
