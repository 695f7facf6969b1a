"""Training over the data axis of a ``('data', 'model')`` mesh (FSDP by
``param_specs(..., fsdp=True)``) of ``gloo`` ranks on the CPU, and elastic
restore (ROADMAP item 22, its training half), against the JAX package.

Reduced qwen2.5-14b, float32, over meshes 2x1 (FSDP over data) and 2x2
(FSDP and tensor parallelism), held as tests/test_torch_tp_training.py
holds its meshes (same tolerances, same checks): 3 steps of losses, grad
norms and final parameters against the reference's single-device jitted
``make_train_step``, each rank's gradients against the single process's
cut to its shard, each leaf's local shape, and the loss's collectives
(the data ranks' loss sums and label counts summed before the
division: a global mean on every rank).  Elastic restore: checkpoints
saved on 2x1 hold the global arrays; resumed on 2x1 they give the
uninterrupted run's losses (rtol 1e-5, as
``test_resume_reproduces_uninterrupted_run``), and they resume on 1x2,
through the training CLI under 1x2, and with no mesh."""

import numpy as np
import pytest

from _torch_ranks import run_ranks, train_worker
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ShapeCell
from repro_torch.models import build_model
from repro_torch.training.trainer import Trainer, TrainerConfig
from test_torch_tp_training import (CELL, LR, STEPS, check_grads,
                                    check_shards, check_steps, jax_run,
                                    plan_for, single_grads)

MESHES = {"2x1": (2, 1), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run, the port's single-process gradients and each
    mesh's ranks.  The 2x1 ranks also save the checkpoints, resume them on
    2x1 and on 1x2 (the same two ranks), and run the CLI under 1x2."""
    ref = jax_run(1)
    single = {k: single_grads(1, ref["init"], k) for k in (False, True)}
    base = tmp_path_factory.mktemp("fsdp")
    ck = {n: str(base / n) for n in ("straight", "cut", "cut_2x1",
                                     "cut_1x2", "cut_cli", "cut_none")}
    cli = ["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu",
           "--kernels", "--mesh", "1x2", "--backend", "gloo", "--steps",
           "6", "--checkpoint-dir", ck["cut_cli"], "--checkpoint-every",
           "3"]
    jobs = {"2x1": ["init", "embed",
                    ("save", ck["straight"], ck["cut"],
                     [ck[n] for n in ("cut_2x1", "cut_1x2", "cut_cli",
                                      "cut_none")]),
                    ("resume", ck["cut_2x1"], (2, 1)),
                    ("resume", ck["cut_1x2"], (1, 2)), ("cli", cli)],
            "2x2": ["init", "embed", "ce"]}
    out = {"ref": ref, "single": single, "ckpt": ck}
    for name, shape in MESHES.items():
        d = base / f"mesh{name}"
        d.mkdir()
        out[name] = run_ranks(train_worker, shape[0] * shape[1], d, shape,
                              ref["init"], CELL, STEPS, LR, jobs[name])
    return out


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_steps_equal_the_reference_single_device(runs, name, kernels):
    check_steps(runs[name], runs["ref"], MESHES[name], kernels)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", list(MESHES))
def test_rank_gradients_are_the_single_process_cut(runs, name, kernels):
    check_grads(runs[name], runs["single"][kernels], MESHES[name], kernels,
                plan_for(MESHES[name]))


@pytest.mark.parametrize("name", list(MESHES))
def test_each_rank_holds_its_cut_of_the_state(runs, name):
    check_shards(runs[name], plan_for(MESHES[name]), MESHES[name])


@pytest.mark.parametrize("kernels", [True, False], ids=["fused", "logits"])
def test_loss_sums_over_the_data_ranks_once(runs, kernels):
    """2x2: a chunk's fold (2 ranks x 2 floats x 6 rows) and label-logit
    sum over the model axis, then the loss sum and the label count over
    the data axis, once each."""
    for res in runs["2x2"]:
        calls, folds = res["ce"][f"calls_{kernels}"]
        assert folds == 3
        assert calls == [2 * 2 * 6, 6] * 3 + [1, 1]


@pytest.mark.parametrize("name", list(MESHES))
def test_the_embedding_table_is_never_gathered(runs, name):
    """Under FSDP the embedding moves activations, not the table: forward,
    the data ranks' tokens and one buffer of their rows (2 data ranks x
    tokens x d); backward, every data rank's output gradient, the same
    size.  None depends on the vocabulary.  The rank's gradient is its
    own block of the table."""
    d = 64
    for res in runs[name]:
        e = res["embed"]
        assert e["fwd"] == [2 * e["tokens"], 2 * e["tokens"] * d]
        assert e["bwd"] == [2 * e["tokens"] * d]
        assert e["grad_shape"] == e["local_shape"]
        assert e["local_shape"][1] == d // 2


def _losses(hist):
    return {s: loss for s, loss in hist}


def test_resume_on_the_same_mesh_equals_the_uninterrupted_run(runs):
    straight = runs["2x1"][0]["straight"]
    for res in runs["2x1"]:
        got = _losses(res["resumed"][(2, 1)])
        assert sorted(got) == [3, 4, 5]
        np.testing.assert_allclose([got[s] for s in (3, 4, 5)],
                                   straight[3:], rtol=1e-5)
    assert Checkpointer(runs["ckpt"]["straight"]).steps() == [3, 6]


def test_checkpoint_saved_on_2x1_resumes_on_1x2_and_without_a_mesh(runs):
    """The global arrays restore onto another mesh (each rank cuts its
    shard) and onto none; the losses go on as the uninterrupted 2x1 run's,
    to the rounding of another mesh's sums."""
    straight = runs["2x1"][0]["straight"]
    for res in runs["2x1"]:
        got = _losses(res["resumed"][(1, 2)])
        assert sorted(got) == [3, 4, 5]
        np.testing.assert_allclose([got[s] for s in (3, 4, 5)],
                                   straight[3:], rtol=1e-5)
    m = build_model("qwen2.5-14b", reduced=True, device="cpu",
                    use_kernels=True)
    t = Trainer(m, ShapeCell("t", *CELL, "train"), TrainerConfig(
        steps=6, peak_lr=LR, warmup=3, log_every=100, checkpoint_every=3,
        checkpoint_dir=runs["ckpt"]["cut_none"]))
    t.run()
    assert [h["step"] for h in t.metrics_history] == [3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in t.metrics_history],
                               straight[3:], rtol=1e-5)


def test_the_cli_resumes_under_another_mesh(runs):
    """``launch.train --mesh 1x2 --backend gloo`` from the 2x1 checkpoint:
    rank 0 prints the final line once, at step 5; the others print
    nothing; the checkpoint it saves holds the global arrays."""
    out0, out1 = (r["cli"] for r in runs["2x1"])
    final = [ln for ln in out0.splitlines() if ln.startswith("final:")]
    assert len(final) == 1 and "'step': 5," in final[0]
    assert out1 == ""
    assert Checkpointer(runs["ckpt"]["cut_cli"]).steps() == [3, 6]
    arr = np.load(f"{runs['ckpt']['cut_cli']}/step_0000000006/"
                  ".params__lm_head__w.npy")
    assert arr.shape == (64, 256)
