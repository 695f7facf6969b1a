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


def loss_and_grads(model: Model, params, batch: dict, policy=None,
                   moe_impl: str = "dispatch"):
    """``(loss, grads)`` of ``model.loss`` at ``params``: ``grads`` has the
    tree of ``params`` and their dtypes.  ``params`` are unchanged and hold
    no gradient afterwards."""
    ps = adamw.leaves(params)
    for p in ps:
        p.requires_grad_(True)
        p.grad = None
    try:
        loss = model.loss(params, batch, moe_impl=moe_impl, policy=policy)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in ps]
    finally:
        for p in ps:
            p.grad = None
            p.requires_grad_(False)
    it = iter(grads)
    return loss.detach(), adamw.tree_map(lambda _: next(it), params)


def sum_replicated_grads(grads, specs, mesh) -> None:
    """Sum over the data axes, in place, the gradients of the leaves that
    are whole along them (norm scales, biases): each data rank holds its
    own tokens' part.  The leaves cut along them had theirs summed by the
    FSDP gather's backward (a reduce-scatter); along ``model`` every
    gradient is already whole or this rank's own columns."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding

    data = tuple(a for a in mesh.axis_names if a != "model")
    if not data or all(mesh.size(a) == 1 for a in data):
        return
    if len(data) > 1:
        raise NotImplementedError(f"data axes {data}: one is ported")
    group = mesh.group(data[0])
    spec_of = dict(sharding.flatten(specs))
    for path, g in sharding.flatten(grads):
        if data[0] not in sharding.named_axes(spec_of[path]):
            dist.all_reduce(g, group=group)


def make_train_step(model: Model, *, lr_schedule: Callable | None = None,
                    microbatches: int = 1, grad_compression: str = "none",
                    moe_impl: str = "dispatch",
                    max_grad_norm: float | None = 1.0,
                    softmax_policy=None, mesh=None, plan=None):
    """``train_step(state, batch) -> (state, metrics)``; ``metrics`` holds
    ``loss``, ``lr`` and ``grad_norm`` (0-d float32 tensors).  The state's
    parameters and moments are updated in place.  A moe model's experts
    run by ``moe_impl``.  ``softmax_policy`` overrides the model config's
    policy for the loss only: the training-side switch for the fused
    LM-head CE kernels.

    Under a ``mesh`` (``('data', 'model')``) the state holds this rank's
    shards by ``plan`` (``sharding.fsdp_plan`` of the parameters'
    ``param_specs``, FSDP on), the step takes the global batch and keeps
    this rank's rows (``pipeline.shard_batch``), runs the model under
    ``autoshard.hints(mesh, plan)``, sums the data-replicated leaves'
    gradients over the data axes, and clips by the global norm.  The loss
    and the norm in ``metrics`` are global, the same on every rank."""
    lr_fn = lr_schedule or functools.partial(schedules.warmup_cosine)
    policy = softmax_policy or model.cfg.softmax_policy()
    if grad_compression not in ("none", "bf16"):
        raise NotImplementedError(
            f"grad_compression={grad_compression!r}: the reference's step "
            "applies no compression but 'bf16' (it passes every other "
            "value through uncompressed); the port refuses the setting "
            "rather than ignore it")

    specs = (adamw.tree_map(lambda e: e[0], plan) if plan is not None
             else None)

    def train_step(state: TrainState, batch: dict):
        if mesh is None:
            return _step(state, batch)
        from repro_torch.data.pipeline import shard_batch
        from repro_torch.distributed import autoshard, sharding

        batch = shard_batch(batch, mesh, sharding.batch_specs(batch, mesh))
        with autoshard.hints(mesh, plan):
            return _step(state, batch)

    def _step(state: TrainState, batch: dict):
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
                                        policy, moe_impl)
                loss = loss + li / microbatches
                for a, g in zip(adamw.leaves(grads), adamw.leaves(gi)):
                    a.add_(g.to(torch.float32) / microbatches)
                del gi
        else:
            loss, grads = loss_and_grads(model, state.params, batch, policy,
                                         moe_impl)

        if mesh is not None:
            sum_replicated_grads(grads, specs, mesh)
        if grad_compression == "bf16":
            grads = compression.decompress_bf16(
                compression.compress_bf16(grads))

        lr = lr_fn(state.opt.step)
        params, opt, metrics = adamw.update(
            grads, state.opt, state.params, lr, max_grad_norm=max_grad_norm,
            mesh=mesh, specs=specs)
        return TrainState(params, opt), dict(metrics, loss=loss, lr=lr)

    return train_step
