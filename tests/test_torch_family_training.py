"""Training of the families without experts -- rwkv6-1.6b (ssm),
whisper-base (encdec), qwen2-vl-7b (vlm) and hymba-1.5b (hybrid) --
against the JAX package on the CPU, reduced configs (2 layers, d_model
64, float32) with the same weights carried across through numpy
(``params_from_jax``): the synthetic batches, the loss and every
gradient leaf (kernels off and on), three AdamW steps with the model's
kernels, the flash-route decisions, the encoder's activation
checkpoints, microbatches, a resumed ``Trainer.run`` and the training
CLI.  The port runs its plain versions here (tensors on
the CPU); the reference's model kernels take their jnp forms on the CPU
as ``tests/test_torch_training.py`` runs them.

Tolerances (float32 throughout, so only the summation order differs):
  * the loss at rtol 1e-5 and each gradient leaf within a relative norm
    of 1e-4 (the WKV6 and SSD chunk sums, the cross-attention's and the
    fused CE's are all float32 sums of a few hundred terms);
  * three AdamW steps at lr 5e-3: the loss at rtol 1e-4 and the gradient
    norm at 1e-3, as ``test_train_steps_match_reference`` (the first
    update is lr * sign(g), which amplifies the order's last bits);
  * the batches and the resumed run: bit-equal.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import ShapeCell as JShapeCell
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import transformer as jtr
from repro.optim import schedules as jsched
from repro.training import step_fn as jstep
from repro.training import train_state as jstate
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.optim import adamw, schedules
from repro_torch.training import step_fn, train_state
from repro_torch.training.trainer import Trainer, TrainerConfig

FAMILIES = ["rwkv6-1.6b", "whisper-base", "qwen2-vl-7b", "hymba-1.5b"]
CELL = (16, 4)                # seq_len, global batch
LR = 5e-3
KERNELS = [False, True]       # the model's use_kernels
KERNEL_IDS = ["plain", "model_kernels"]


def _cell(cls, seq=CELL[0], batch=CELL[1]):
    return cls("t", seq, batch, "train")


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's float32 weights (seed 0) as numpy."""
    jm = jbuild(arch, reduced=True)
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _models(arch, kernels):
    """(JAX model, the weights as numpy, the port's model, its weights):
    the same numbers on both sides."""
    jm = jbuild(arch, reduced=True, use_kernels=kernels)
    npp = _weights(arch)
    tm = build_model(arch, reduced=True, device="cpu", use_kernels=kernels)
    return jm, npp, tm, params_from_jax(npp, tm.cfg, device="cpu")


def _batches(arch, step=0, **cell):
    jd = JSyntheticLM(jbuild(arch, reduced=True).cfg,
                      _cell(JShapeCell, **cell), seed=0)
    td = SyntheticLM(get_config(arch).reduced(), _cell(ShapeCell, **cell),
                     seed=0)
    return td.batch_at(step), jd.batch_at(step)


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# Batches: the same arrays, bit for bit, reduced and at full width.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_batches_equal_the_reference(arch, reduced):
    jc = jget(arch).reduced() if reduced else jget(arch)
    tc = get_config(arch).reduced() if reduced else get_config(arch)
    cell = (300, 2)           # past qwen2-vl's 256 patches at full width
    jd = JSyntheticLM(jc, JShapeCell("t", *cell, "train"), seed=7)
    td = SyntheticLM(tc, ShapeCell("t", *cell, "train"), seed=7)
    want_keys = {"encdec": {"frames", "dec_tokens"},
                 "vlm": {"tokens", "patches"}}.get(tc.family, {"tokens"})
    for step in (0, 1, 12):
        a, b = td.batch_at(step), jd.batch_at(step)
        assert a.keys() == b.keys() == want_keys
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    if tc.family == "encdec":
        assert a["frames"].shape == (2, 300, tc.d_model)
        assert a["dec_tokens"].shape == (2, tc.dec_len)
    if tc.family == "vlm":
        assert a["tokens"].shape == (2, 300 - tc.n_patches)
        assert a["patches"].shape == (2, tc.n_patches, tc.d_model)


# ---------------------------------------------------------------------------
# The loss and every gradient leaf against jax.value_and_grad.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, kernels):
    jm, npp, _, _ = _models(arch, kernels)
    _, jb = _batches(arch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.train_loss(p, b, cfg=jm.cfg)))(npp, jb)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("kernels", KERNELS, ids=KERNEL_IDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch, kernels):
    _, _, tm, tp = _models(arch, kernels)
    want_loss, jgrads = _jax_loss_and_grads(arch, kernels)
    tb, _ = _batches(arch)
    loss, grads = step_fn.loss_and_grads(tm, tp, _to_torch(tb))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    # the reference's gradients in the port's layout (the conversion is a
    # relabelling and transposition, linear in the leaves)
    want = dict(_flat(params_from_jax(jgrads, tm.cfg, device="cpu")))
    got = dict(_flat(grads))
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        den = float(w.norm())
        rel = float((g - w).norm()) / max(den, 1e-30)
        assert rel <= 1e-4 or float((g - w).norm()) <= 1e-9, (name, rel)


def test_hybrid_float32_leaves_get_float32_gradients():
    # hymba's a_log / dt_bias stay float32 under bf16 weights, and so do
    # their gradients; the bf16 leaves' gradients are bf16
    tm = build_model("hymba-1.5b", reduced=True, device="cpu")
    tp = tm.init(seed=0, dtype=torch.bfloat16)
    tb, _ = _batches("hymba-1.5b", seq=16, batch=2)
    _, grads = step_fn.loss_and_grads(tm, tp, _to_torch(tb))
    flat = dict(_flat(grads))
    for name in ("blocks/mamba/a_log", "blocks/mamba/dt_bias"):
        assert flat[name].dtype == torch.float32, name
        assert float(flat[name].abs().sum()) > 0, name
    assert flat["blocks/attn/wq/w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Three AdamW steps against the reference's make_train_step.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_run(arch, steps=3):
    """The reference's jitted make_train_step with the model's kernels,
    ``steps`` steps from the weights of :func:`_weights`; (loss, grad
    norm) a step."""
    jm, npp, _, _ = _models(arch, True)
    state = jstate.init_state(npp)
    ds = JSyntheticLM(jm.cfg, _cell(JShapeCell), seed=0)
    step = jax.jit(jstep.make_train_step(
        jm, lr_schedule=functools.partial(jsched.constant, peak_lr=LR)))
    out = []
    for i in range(steps):
        state, met = step(state, ds.batch_at(i))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


def _torch_run(arch, steps=3, microbatches=1):
    """The port's make_train_step as :func:`_jax_run`."""
    _, npp, tm, _ = _models(arch, True)
    state = train_state.init_state(params_from_jax(npp, tm.cfg,
                                                   device="cpu"))
    ds = SyntheticLM(tm.cfg, _cell(ShapeCell), seed=0)
    step = step_fn.make_train_step(
        tm, lr_schedule=functools.partial(schedules.constant, peak_lr=LR),
        microbatches=microbatches)
    out = []
    for i in range(steps):
        state, met = step(state, ds.batch_at(i))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch):
    # the model's own kernels: the flash route and the fused LM-head CE
    # (the plain route's loss and gradients are held above)
    want = _jax_run(arch)
    got = _torch_run(arch)
    assert all(np.isfinite(g).all() for g in got)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-3)


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-7b"])
def test_microbatching_matches_full_batch(arch):
    """Two microbatches split every batch key along dim 0 (frames and
    decoder tokens; patches and text tokens) and give the full batch's
    trajectory: each half's mean CE has as many label positions."""
    want = _jax_run(arch)
    full = _torch_run(arch)
    got = _torch_run(arch, microbatches=2)
    np.testing.assert_allclose([g[0] for g in got], [f[0] for f in full],
                               rtol=2e-3)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=2e-3)


# ---------------------------------------------------------------------------
# The flash route: taken where the reference takes it, and nowhere else.
# ---------------------------------------------------------------------------
def _route_log(monkeypatch, module):
    log = []
    orig = module._flash_route

    def spy(q, k, v, policy, **kw):
        o = orig(q, k, v, policy, **kw)
        log.append((tuple(int(x) for x in q.shape[2:]), int(k.shape[2]),
                    bool(kw["causal"]), kw["window"], o is not None))
        return o

    monkeypatch.setattr(module, "_flash_route", spy)
    return log


# each family's attention calls in one loss, layer by layer: (G, Sq, hd),
# Skv, causal, window, the flash route taken
ENC = ((2, 16, 16), 16, False, None, True)
EXPECTED_ROUTES = {
    "rwkv6-1.6b": [],                                   # no attention
    # the encoder's layers (non-causal), then each decoder block's causal
    # self-attention and its cross-attention (non-causal, Sq 15 != Skv 16)
    "whisper-base": [ENC] * 2 + [((2, 15, 16), 15, True, None, True),
                                 ((2, 15, 16), 16, False, None, True)] * 2,
    # 8 patches and 7 text tokens in one causal sequence
    "qwen2-vl-7b": [((2, 15, 16), 15, True, None, True)] * 2,
    # the attention half under the window of 8
    "hymba-1.5b": [((2, 15, 16), 15, True, 8, True)] * 2,
}


@pytest.mark.parametrize("arch", FAMILIES)
def test_flash_route_decisions_match_reference(arch, monkeypatch):
    """The port's attention calls, each with its flash-route decision,
    equal the reference's (its layer loop unrolled, so that every layer
    traces its own call)."""
    jm, npp, tm, tp = _models(arch, True)
    jcfg = dataclasses.replace(jm.cfg, scan_layers=False)
    tb, jb = _batches(arch)
    jlog = _route_log(monkeypatch, jattn)
    jax.eval_shape(lambda p, b: jtr.train_loss(p, b, cfg=jcfg), npp, jb)
    tlog = _route_log(monkeypatch, tattn)
    with torch.no_grad():
        tm.loss(tp, _to_torch(tb))
    assert tlog == jlog == EXPECTED_ROUTES[arch]


# ---------------------------------------------------------------------------
# The encoder's activation checkpoints (that they change no number:
# tests/test_torch_training.py::test_remat_changes_no_number[whisper-base]).
# ---------------------------------------------------------------------------
def test_encoder_layers_are_checkpointed(monkeypatch):
    # under remat with gradients on, every encoder and decoder layer runs
    # inside an activation checkpoint, as the reference's jax.checkpoint
    from repro_torch.models import transformer as ttr

    calls = []
    orig = ttr.checkpoint

    def spy(fn, *a, **kw):
        if isinstance(a[1], dict):          # a layer (not a loss chunk)
            calls.append(a[0].shape[1])
        return orig(fn, *a, **kw)

    monkeypatch.setattr(ttr, "checkpoint", spy)
    tm = build_model("whisper-base", reduced=True, device="cpu", remat=True)
    tp = tm.init(seed=0)
    tb, _ = _batches("whisper-base")
    step_fn.loss_and_grads(tm, tp, _to_torch(tb))
    cfg = tm.cfg
    assert calls == [CELL[0]] * cfg.n_enc_layers + [cfg.dec_len - 1] * \
        cfg.n_layers


# ---------------------------------------------------------------------------
# Trainer.run: a resumed run equals the straight one; the CLI.
# ---------------------------------------------------------------------------
def test_trainer_resume_matches_straight_run(tmp_path):
    """hymba (attention, mamba heads with float32 leaves): 4 steps
    straight against 2 + resume to 4 through the checkpointer; the
    resumed losses and the final state are bit-equal."""
    cell = ShapeCell("t", 16, 2, "train")

    def run(steps, ckdir):
        m = build_model("hymba-1.5b", reduced=True, device="cpu",
                        use_kernels=True)
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
    assert sa.params["blocks"]["mamba"]["a_log"].dtype == torch.float32


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cli_trains_the_family(arch, capsys):
    train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--steps", "2", "--seq", "24", "--batch", "2",
                    "--kernels"])
    out = capsys.readouterr().out
    assert "kernel launches: {}" in out      # plain versions on the CPU
    final = [ln for ln in out.splitlines() if ln.startswith("final: ")]
    assert len(final) == 1 and "'step': 1," in final[0]
    loss = float(final[0].split("'loss': ")[1].split(",")[0])
    assert np.isfinite(loss) and abs(loss - np.log(256)) < 1.5
