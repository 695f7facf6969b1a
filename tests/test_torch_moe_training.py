"""Training of granite-moe-3b-a800m (family moe: capacity dispatch, a
float32 router) against the JAX package on the CPU: the shared cases of
``tests/_moe_training.py`` (batches, the layer's gradients, the loss and
every gradient leaf under each ``moe_impl`` with kernels off and on, drops
at capacity, activation checkpoints, three AdamW steps, the CLI) on the
reduced config (2 layers, d_model 64, 4 experts top 2, d_expert 32,
float32), and this model's own: the layer's gradients past the capacity
and in groups, tied router probabilities, the router's float32 gradient
under bf16 weights and ``Model.loss``'s argument order.  Tolerances as
that module states."""

import numpy as np
import pytest
import torch

from _moe_training import (  # noqa: F401 -- the shared cases
    IMPLS, _batches, _models, _to_torch, assert_layer_gradients_match,
    layer_grads, test_batches_equal_the_reference,
    test_layer_gradients_match_reference,
    test_loss_and_grads_match_reference,
    test_remat_changes_no_number, test_the_batch_drops_pairs_at_capacity,
    test_train_cli_trains_the_family, test_train_steps_match_reference)
from repro_torch.models import build_model, transformer
from repro_torch.training import step_fn

ARCH = "granite-moe-3b-a800m"


@pytest.fixture
def arch():
    return ARCH


@pytest.mark.parametrize("impl,kw", [
    ("dispatch", dict(capacity_factor=0.5)),
    ("gather", dict(capacity_factor=0.5)),
    ("dispatch", dict(capacity_factor=0.5, group_size=4)),
    ("gather", dict(capacity_factor=0.5, group_size=4))],
    ids=["dispatch-drops", "gather-drops", "dispatch-groups-drops",
         "gather-groups-drops"])
def test_layer_gradients_past_the_capacity_match_reference(impl, kw):
    # capacity 0.5 drops (token, k) pairs, so the gradient of the drop
    # path (nothing back to a dropped pair's x or weight) is held, in one
    # group of 12 tokens and in groups of 4
    got, want, gx, wx = layer_grads(ARCH, impl, kw)
    assert_layer_gradients_match(got, want, gx, wx)


@pytest.mark.parametrize("impl", IMPLS)
def test_tied_router_gradient_reaches_the_reference_experts(impl):
    """Experts 1 and 2 share a router column, so their probabilities tie
    for every token: where only one of them makes a token's top 2 the
    stable descending sort takes expert 1, as ``jax.lax.top_k``, and the
    sort's backward sends the gradient to the chosen probabilities only,
    as top_k's."""
    got, want, gx, wx = layer_grads(ARCH, impl, None, tie=(1, 2))
    assert_layer_gradients_match(got, want, gx, wx)


def test_router_gradient_stays_float32_under_bf16_weights():
    tm = build_model(ARCH, reduced=True, device="cpu")
    tp = tm.init(seed=0, dtype=torch.bfloat16)
    tb, _ = _batches(ARCH, seq=16, batch=2)
    _, grads = step_fn.loss_and_grads(tm, tp, _to_torch(tb))
    mlp = grads["blocks"]["mlp"]
    assert mlp["router"]["w"].dtype == torch.float32
    assert float(mlp["router"]["w"].abs().sum()) > 0
    assert mlp["wg"].dtype == torch.bfloat16
    assert all(np.isfinite(g.float().numpy()).all()
               for g in (mlp["wg"], mlp["wu"], mlp["wd"]))


def test_model_loss_takes_the_reference_argument_order():
    # Model.loss(params, batch, moe_impl, policy), as the reference's
    _, _, tm, tp = _models(ARCH, False)
    tb = _to_torch(_batches(ARCH)[0])
    with torch.no_grad():
        by_pos = tm.loss(tp, tb, "gather", None)
        by_kw = transformer.train_loss(tp, tb, cfg=tm.cfg, moe_impl="gather")
        dense = tm.loss(tp, tb, moe_impl="dense")
    assert torch.equal(by_pos, by_kw)
    assert not torch.equal(by_pos, dense)      # the impl reached the layer
