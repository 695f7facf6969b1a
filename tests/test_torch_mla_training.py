"""Training of deepseek-v2-lite-16b (family moe: routed experts and a
shared one, multi-head latent attention) against the JAX package on the
CPU: the shared cases of ``tests/_moe_training.py`` (batches, the layer's
gradients with the shared expert, the loss and every gradient leaf under
each ``moe_impl`` with kernels off and on -- the latent's gradient through
``wkv_b`` and the head-shared rope key's summed over the heads, through
the flash route with kernels --, drops at capacity, activation
checkpoints, three AdamW steps, the CLI) on the reduced config (2 layers,
d_model 64, 4 experts top 2 and 1 shared, kv_lora_rank 32, float32), and
a resumed ``Trainer.run``.  Tolerances as that module states."""

import pytest
import torch

from _moe_training import (  # noqa: F401 -- the shared cases
    test_batches_equal_the_reference, test_layer_gradients_match_reference,
    test_loss_and_grads_match_reference, test_remat_changes_no_number,
    test_the_batch_drops_pairs_at_capacity,
    test_train_cli_trains_the_family, test_train_steps_match_reference)
from repro_torch.configs.base import ShapeCell
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture
def arch():
    return ARCH


def test_trainer_resume_matches_straight_run(tmp_path):
    """4 steps straight against 2 + resume to 4 through the checkpointer
    (MLA, routed and shared experts, the float32 router); the resumed
    losses and the final state are bit-equal."""
    cell = ShapeCell("t", 16, 2, "train")

    def run(steps, ckdir):
        m = build_model(ARCH, reduced=True, device="cpu", use_kernels=True)
        t = Trainer(m, cell, TrainerConfig(
            steps=steps, checkpoint_every=2, checkpoint_dir=str(ckdir),
            log_every=100, peak_lr=1e-3, warmup=2))
        return t, t.run()

    ta, sa = run(4, tmp_path / "a")
    run(2, tmp_path / "b")
    tb, sb = run(4, tmp_path / "b")
    assert [m["step"] for m in tb.metrics_history] == [2, 3]
    la = {m["step"]: m["loss"] for m in ta.metrics_history}
    assert [la[m["step"]] for m in tb.metrics_history] == \
        [m["loss"] for m in tb.metrics_history]
    for a, b in zip(adamw.leaves(sa.params), adamw.leaves(sb.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sa.params["blocks"]["mlp"]["router"]["w"].dtype == torch.float32
