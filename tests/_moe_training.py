"""The cases that hold the moe family's training against the JAX package
on the CPU, shared by ``tests/test_torch_moe_training.py``
(granite-moe-3b-a800m) and ``tests/test_torch_mla_training.py``
(deepseek-v2-lite-16b): each of those files imports the cases it runs and
binds the ``arch`` fixture to its model, so that each model's cases run as
a file of their own.  Reduced configs (2 layers, d_model 64, 4 experts
top 2, float32), the weights carried across through numpy
(``params_from_jax``), batches from a numpy seed.  The port runs its
plain versions here (tensors on the CPU); the reference's model kernels
take their jnp forms on the CPU.

Tolerances (float32 throughout, so only the summation order differs):
  * the layer's output and gradients within 1e-5 of the reference's
    (absolute, on values of order 1);
  * the loss at rtol 1e-5 and each gradient leaf within a relative norm
    of 1e-4, as ``tests/test_torch_family_training.py``;
  * three AdamW steps at lr 5e-3: the loss at rtol 1e-4 and the gradient
    norm at 1e-3 (the first update is lr * sign(g), which amplifies the
    order's last bits);
  * the batches, the checkpointed loss and the resumed run: bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import ShapeCell as JShapeCell
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.optim import schedules as jsched
from repro.training import step_fn as jstep
from repro.training import train_state as jstate
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, moe
from repro_torch.optim import adamw, schedules
from repro_torch.training import step_fn, train_state

IMPLS = ["dense", "dispatch", "gather"]
CELL = (16, 4)                # seq_len, global batch: 4 groups of 15 tokens
LR = 5e-3
KERNELS = [False, True]       # the model's use_kernels
KERNEL_IDS = ["plain", "model_kernels"]
LAYER_ATOL = 1e-5


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


def _assert_leaves_close(got, want, rel_tol):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        err = float((g - w).norm())
        rel = err / max(float(w.norm()), 1e-30)
        assert rel <= rel_tol or err <= 1e-9, (name, rel)


# ---------------------------------------------------------------------------
# Batches: plain tokens, the same arrays bit for bit, reduced and full.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_batches_equal_the_reference(arch, reduced):
    jc = jget(arch).reduced() if reduced else jget(arch)
    tc = get_config(arch).reduced() if reduced else get_config(arch)
    jd = JSyntheticLM(jc, JShapeCell("t", 300, 2, "train"), seed=7)
    td = SyntheticLM(tc, ShapeCell("t", 300, 2, "train"), seed=7)
    for step in (0, 1, 12):
        a, b = td.batch_at(step), jd.batch_at(step)
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype
        assert a["tokens"].shape == (2, 300)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# The layer's gradients: each impl against jax.vjp of the reference's.
# ---------------------------------------------------------------------------
def layer_grads(arch, impl, kw, seed=0, tie=None):
    """Gradients of <layer(x), cot> with respect to x and every leaf of
    layer 0's moe parameters, both packages, as numpy.  ``kw`` goes to
    the impl (capacity_factor, group_size); with no ``kw`` the call is
    ``moe_apply`` (the shared expert included).  ``tie`` copies router
    column tie[0] onto tie[1]."""
    jm, npp, tm, tp = _models(arch, False)
    jl = jax.tree.map(lambda a: a[0], npp["blocks"]["mlp"])
    if tie is not None:
        w = np.array(jl["router"]["w"])
        w[:, tie[1]] = w[:, tie[0]]
        jl = dict(jl, router={"w": w})
    tl = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jl)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    cot = rng.standard_normal((2, 12, 64)).astype(np.float32)

    if kw is None:
        def jf(p, xx):
            return jmoe.moe_apply(p, xx, jm.cfg, impl=impl)

        def tf(p, xx):
            return moe.moe_apply(p, xx, tm.cfg, impl=impl)
    else:
        def jf(p, xx):
            return jmoe._MOE_IMPLS[impl](p, xx, jm.cfg, **kw)

        def tf(p, xx):
            return moe._MOE_IMPLS[impl](p, xx, tm.cfg, **kw)

    y, vjp = jax.vjp(jf, jl, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = dict(_flat(tl))
    for t in leaves.values():
        t.requires_grad_(True)
    ty = tf(tl, tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               atol=LAYER_ATOL, rtol=0)
    (ty * torch.from_numpy(cot)).sum().backward()
    want = dict(_flat(jax.tree.map(np.asarray, jgp)))
    # a leaf the impl does not read (the shared expert, called without
    # moe_apply) has no gradient in the port and zeros in the reference
    got = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
           .numpy() for k, t in leaves.items()}
    return got, want, tx.grad.numpy(), np.asarray(jgx)


def assert_layer_gradients_match(got, want, gx, wx):
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], atol=LAYER_ATOL,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(gx, wx, atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_layer_gradients_match_reference(arch, impl):
    # moe_apply at the default capacity (deepseek's layer adds its shared
    # expert's MLP)
    got, want, gx, wx = layer_grads(arch, impl, None)
    assert_layer_gradients_match(got, want, gx, wx)
    assert np.abs(got["router/w"]).sum() > 0


# ---------------------------------------------------------------------------
# The loss and every gradient leaf against jax.value_and_grad.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, kernels, impl):
    jm, npp, _, _ = _models(arch, kernels)
    _, jb = _batches(arch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.train_loss(p, b, cfg=jm.cfg, moe_impl=impl)))(
            npp, jb)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kernels", KERNELS, ids=KERNEL_IDS)
def test_loss_and_grads_match_reference(arch, kernels, impl):
    _, _, tm, tp = _models(arch, kernels)
    want_loss, jgrads = _jax_loss_and_grads(arch, kernels, impl)
    tb, _ = _batches(arch)
    loss, grads = step_fn.loss_and_grads(tm, tp, _to_torch(tb),
                                         moe_impl=impl)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    # the reference's gradients in the port's layout (the conversion is a
    # relabelling, linear in the leaves); the router's is float32
    _assert_leaves_close(grads, params_from_jax(jgrads, tm.cfg,
                                                device="cpu"), 1e-4)
    assert grads["blocks"]["mlp"]["router"]["w"].dtype == torch.float32


@pytest.mark.parametrize("impl", ["dispatch", "gather"])
def test_the_batch_drops_pairs_at_capacity(arch, impl, monkeypatch):
    """The loss's batch overflows some expert's queue in some layer, so
    the gradients held above run through the drop path: each group of 15
    tokens has a capacity of int(15 * 2 * 1.25 / 4) = 9 slots an expert."""
    _, _, tm, tp = _models(arch, False)
    seen = []
    orig = moe._queue_slots

    def spy(idx, n_experts):
        onehot, pos = orig(idx, n_experts)
        cap = moe._capacity(idx.shape[1], tm.cfg, 1.25)
        seen.append((idx.shape[1], cap, int((pos >= cap).sum())))
        return onehot, pos

    monkeypatch.setattr(moe, "_queue_slots", spy)
    tb, _ = _batches(arch)
    with torch.no_grad():
        tm.loss(tp, _to_torch(tb), moe_impl=impl)
    assert [(s, c) for s, c, _ in seen] == [(15, 9)] * tm.cfg.n_layers
    assert sum(d for _, _, d in seen) >= 1, seen


def test_remat_changes_no_number(arch):
    # each layer an activation checkpoint: the recompute of the router,
    # the queue and the dispatch / combine products repeats the forward's
    # bits, so the loss and gradients equal the saved route's
    tb, _ = _batches(arch)
    out = []
    for remat in (False, True):
        tm = build_model(arch, reduced=True, device="cpu", remat=remat)
        tp = params_from_jax(_weights(arch), tm.cfg, device="cpu")
        out.append(step_fn.loss_and_grads(tm, tp, _to_torch(tb)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(adamw.leaves(out[0][1]), adamw.leaves(out[1][1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Three AdamW steps against the reference's make_train_step.
# ---------------------------------------------------------------------------
def _jax_run(arch, steps=3):
    """The reference's jitted make_train_step (moe_impl "dispatch") with
    the model's kernels, ``steps`` steps from the weights of
    :func:`_weights`; (loss, grad norm) a step."""
    jm, npp, _, _ = _models(arch, True)
    state = jstate.init_state(npp)
    ds = JSyntheticLM(jm.cfg, _cell(JShapeCell), seed=0)
    step = jax.jit(jstep.make_train_step(
        jm, lr_schedule=functools.partial(jsched.constant, peak_lr=LR),
        moe_impl="dispatch"))
    out = []
    for i in range(steps):
        state, met = step(state, ds.batch_at(i))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


def _torch_run(arch, steps=3):
    _, npp, tm, _ = _models(arch, True)
    state = train_state.init_state(params_from_jax(npp, tm.cfg,
                                                   device="cpu"))
    ds = SyntheticLM(tm.cfg, _cell(ShapeCell), seed=0)
    step = step_fn.make_train_step(
        tm, lr_schedule=functools.partial(schedules.constant, peak_lr=LR),
        moe_impl="dispatch")
    out = []
    for i in range(steps):
        state, met = step(state, ds.batch_at(i))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


def test_train_steps_match_reference(arch):
    want = _jax_run(arch)
    got = _torch_run(arch)
    assert all(np.isfinite(g).all() for g in got)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# Trainer.run: a resumed run equals the straight one; the CLI.
# ---------------------------------------------------------------------------
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
