"""The port's training slice against the JAX package on the CPU: the fused
LM-head cross-entropy (forward, dh, dw), the policy's LM-head method, AdamW
and the schedules, the synthetic batches, and whole train steps of reduced
dense models with the same weights and batches.  The port's side runs its
plain versions here (tensors on the CPU); the reference's Pallas kernels
run in interpret mode."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCell as JShapeCell
from repro.core.policy import SoftmaxPolicy as JPolicy
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.distributed import compression as jcomp
from repro.kernels import ops as jops
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.training import step_fn as jstep
from repro.training import train_state as jstate
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import compression
from repro_torch.kernels import ops, registry
from repro_torch.kernels import twopass_xent as txe
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.optim import adamw, schedules
from repro_torch.training import step_fn, train_state


# ---------------------------------------------------------------------------
# Fused LM-head CE (kernels 9-11): the port's plain forms against the
# reference's Pallas kernels (interpret mode) and its jnp chunked forms.
# ---------------------------------------------------------------------------
def _lmhead_inputs(t=40, d=32, v=300, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    dl = rng.standard_normal(t).astype(np.float32)
    return h, w, labels, dl


def _jax_lmhead(h, w, labels, dl, impl, dtype=jnp.float32):
    def f(h_, w_):
        return jops.lmhead_cross_entropy(h_, w_, jnp.asarray(labels), None,
                                         None, None, impl)
    loss, vjp = jax.vjp(f, jnp.asarray(h, dtype), jnp.asarray(w, dtype))
    dh, dw = vjp(jnp.asarray(dl))
    return [np.asarray(x, np.float32) for x in (loss, dh, dw)]


def _torch_lmhead(h, w, labels, dl, impl, dtype=torch.float32, **kw):
    ht = torch.from_numpy(h).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    loss = ops.lmhead_cross_entropy(ht, wt, torch.from_numpy(labels),
                                    impl=impl, **kw)
    loss.backward(torch.from_numpy(dl))
    assert ht.grad.dtype == dtype and wt.grad.dtype == dtype
    return [x.detach().float().numpy() for x in (loss, ht.grad, wt.grad)]


@pytest.mark.parametrize("jimpl", ["pallas", "twopass"])
@pytest.mark.parametrize("impl", ["cuda", "twopass"])
@pytest.mark.parametrize("t,v", [(40, 257), (40, 300), (37, 1000),
                                 (300, 300)])
def test_lmhead_matches_reference(jimpl, impl, t, v):
    # odd vocab widths and token counts the reference pads to its tiles;
    # the port's "cuda" wrappers run their plain versions on the CPU
    h, w, labels, dl = _lmhead_inputs(t=t, v=v)
    want = _jax_lmhead(h, w, labels, dl, jimpl)
    got = _torch_lmhead(h, w, labels, dl, impl)
    for name, a, b in zip(("loss", "dh", "dw"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("block_v", [128, 256, 2048])
def test_lmhead_vocab_chunks_change_only_sum_order(block_v):
    h, w, labels, dl = _lmhead_inputs(t=48, v=1000)
    want = _jax_lmhead(h, w, labels, dl, "ref")
    got = _torch_lmhead(h, w, labels, dl, "twopass", block_v=block_v)
    for name, a, b in zip(("loss", "dh", "dw"), got, want):
        np.testing.assert_allclose(a, b, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("jimpl", ["pallas", "twopass"])
def test_lmhead_bf16(jimpl):
    # bf16 h and w: gradients come back in bf16, within a few bf16 steps
    h, w, labels, dl = _lmhead_inputs()
    want = _jax_lmhead(h, w, labels, dl, jimpl, jnp.bfloat16)
    got = _torch_lmhead(h, w, labels, dl, "twopass", torch.bfloat16)
    for name, a, b in zip(("loss", "dh", "dw"), got, want):
        np.testing.assert_allclose(a, b, atol=5e-2, err_msg=name)


def test_lmhead_ref_impl_matches_reference_ref():
    h, w, labels, dl = _lmhead_inputs(v=257)
    want = _jax_lmhead(h, w, labels, dl, "ref")
    got = _torch_lmhead(h, w, labels, dl, "ref")
    for name, a, b in zip(("loss", "dh", "dw"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-5, err_msg=name)


def test_lmhead_labels_get_no_gradient():
    h, w, labels, _ = _lmhead_inputs()
    ht = torch.from_numpy(h).requires_grad_(True)
    lab = torch.from_numpy(labels)
    ops.lmhead_cross_entropy(ht, torch.from_numpy(w), lab,
                             impl="twopass").sum().backward()
    assert ht.grad.shape == ht.shape and lab.grad is None


def test_lmhead_plain_twins_agree_with_the_op():
    # the three kernel wrappers' plain versions, called as the op calls them
    h, w, labels, dl = _lmhead_inputs(t=77, v=1000)
    ht, wt, lab, dlt = map(torch.from_numpy, (h, w, labels, dl))
    loss, m, n = txe.lmhead_xent_fwd_2d(ht, wt, lab, block_v=256)
    dh = txe.lmhead_xent_dh_2d(ht, wt, lab, m, n, dlt, block_v=256)
    dw = txe.lmhead_xent_dw_2d(ht, wt, lab, m, n, dlt, block_v=256)
    got = [x.numpy() for x in (loss, dh, dw)]
    want = _jax_lmhead(h, w, labels, dl, "pallas")
    for name, a, b in zip(("loss", "dh", "dw"), got, want):
        np.testing.assert_allclose(a, b, atol=5e-5, err_msg=name)
    # the stats give the same lse as the reference's kernel
    _, jm, jn = jops._lmhead_fwd_stats(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), None, None,
        None, "pallas")
    lse = np.log(m.numpy()) + n.numpy() * np.log(2.0)
    np.testing.assert_allclose(
        lse, np.log(np.asarray(jm)) + np.asarray(jn) * np.log(2.0),
        atol=1e-5)


def test_lmhead_label_outside_the_vocab_gathers_zero():
    h, w, labels, _ = _lmhead_inputs(v=300)
    labels[:2] = (-1, 300)
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    loss, m, n = txe.lmhead_xent_fwd_2d_plain(ht, wt,
                                              torch.from_numpy(labels), 3)
    lse = torch.logsumexp(ht @ wt, dim=-1)
    np.testing.assert_allclose(loss[:2].numpy(), lse[:2].numpy(), atol=1e-5)


class TestDispatch:
    def test_explicit_impl_wins(self):
        kern = SoftmaxPolicy(use_kernels=True)
        assert ops.train_bwd_impl(kern, "ref", "cuda") == "ref"
        assert ops.train_bwd_impl(None, "cuda") == "cuda"

    def test_policy_takes_the_kernels_on_the_card_only(self):
        kern = SoftmaxPolicy(use_kernels=True)
        assert ops.train_bwd_impl(kern, None, "cuda") == "cuda"
        assert ops.train_bwd_impl(kern, None, torch.device("cpu")) \
            == "twopass"

    def test_no_policy_is_the_reference(self):
        assert ops.train_bwd_impl(None, None, "cuda") == "ref"
        assert ops.train_bwd_impl(SoftmaxPolicy(), None, "cuda") == "ref"

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match="unknown impl"):
            ops.train_bwd_impl(None, "pallas")

    def test_registry_lmhead_spec(self):
        spec = registry.get_spec("lmhead_xent")
        assert spec.row_align == spec.row_cap == 128
        assert registry.block_shapes("lmhead_xent", 512, 152064) \
            == (128, 8192)
        assert registry.block_shapes("lmhead_xent", 40, 300) == (128, 384)

    @pytest.mark.parametrize("use_kernels", [False, True])
    def test_policy_lmhead_method_parity(self, use_kernels):
        h, w, labels, _ = _lmhead_inputs()
        got = SoftmaxPolicy(use_kernels=use_kernels).lmhead_cross_entropy(
            *map(torch.from_numpy, (h, w, labels)))
        want = JPolicy(use_kernels=use_kernels).lmhead_cross_entropy(
            *map(jnp.asarray, (h, w, labels)))
        plain = SoftmaxPolicy().lmhead_cross_entropy(
            *map(torch.from_numpy, (h, w, labels)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=5e-5)


# ---------------------------------------------------------------------------
# AdamW, schedules, compression, batches.
# ---------------------------------------------------------------------------
def _tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((5, 7)).astype(dtype),
            "b": {"c": rng.standard_normal(11).astype(dtype)}}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree if not torch.is_tensor(tree) else tree.numpy())


@pytest.mark.parametrize("max_grad_norm", [1.0, None, 100.0])
def test_adamw_matches_reference(max_grad_norm):
    rng = np.random.default_rng(3)
    params, m, v = _tree(rng), _tree(rng), _tree(rng)
    v = jax.tree.map(np.abs, v)
    grads = jax.tree.map(lambda x: x * 3, _tree(rng))
    jst = jadamw.AdamWState(jnp.int32(4), m, v)
    jp, js, jm = jadamw.update(grads, jst, params, jnp.float32(1e-2),
                               max_grad_norm=max_grad_norm)
    tt = functools.partial(adamw.tree_map, lambda x: torch.tensor(x))
    tst = adamw.AdamWState(torch.tensor(4, dtype=torch.int32), tt(m), tt(v))
    tp, ts, tm = adamw.update(tt(grads), tst, tt(params),
                              torch.tensor(1e-2), max_grad_norm=max_grad_norm)
    assert int(ts.step) == int(js.step) == 5
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(adamw.leaves(_np_tree(got)),
                        jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(6)
    g = jax.tree.map(lambda x: x * 3, _tree(rng))
    jg, jn = jadamw.clip_by_global_norm(g, 1.0)
    tg, tn = adamw.clip_by_global_norm(
        adamw.tree_map(torch.from_numpy, g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(adamw.leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_adamw_moments_are_float32_and_bf16_params_stay_bf16():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw.init(params)
    assert st.m["w"].dtype == st.v["w"].dtype == torch.float32
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    p, st2, _ = adamw.update({"w": torch.ones(4, dtype=torch.bfloat16)},
                             st, params, torch.tensor(1e-3))
    assert p["w"].dtype == torch.bfloat16 and int(st2.step) == 1


@pytest.mark.parametrize("fn,kw", [
    ("warmup_cosine", {}),
    ("warmup_cosine", dict(peak_lr=1e-3, warmup=10, total=50, floor=0.2)),
    ("constant", dict(peak_lr=5e-3))])
def test_schedules_match_reference(fn, kw):
    steps = np.array([0, 1, 5, 9, 10, 11, 49, 50, 99, 100, 101, 5000,
                      9999, 10000, 20000], np.int32)
    want = np.asarray(getattr(jsched, fn)(jnp.asarray(steps), **kw))
    got = getattr(schedules, fn)(torch.from_numpy(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_bf16_compression_matches_reference():
    rng = np.random.default_rng(4)
    g = _tree(rng)
    want = jcomp.decompress_bf16(jcomp.compress_bf16(g))
    got = compression.decompress_bf16(compression.compress_bf16(
        adamw.tree_map(torch.from_numpy, g)))
    for a, b in zip(adamw.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("arch,reduced", [("qwen2.5-14b", True),
                                          ("qwen2.5-14b", False),
                                          ("granite-20b", True),
                                          ("granite-moe-3b-a800m", True)])
def test_synthetic_batches_equal_the_reference(arch, reduced):
    from repro.configs import get_config as jget

    jc = jget(arch).reduced() if reduced else jget(arch)
    tc = get_config(arch).reduced() if reduced else get_config(arch)
    jd = JSyntheticLM(jc, JShapeCell("t", 64, 3, "train"), seed=7)
    td = SyntheticLM(tc, ShapeCell("t", 64, 3, "train"), seed=7)
    for step in (0, 1, 12):
        a, b = td.batch_at(step), jd.batch_at(step)
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    step, batch = next(td.iterate(5))
    assert step == 5 and np.array_equal(batch["tokens"],
                                        jd.batch_at(5)["tokens"])


# ---------------------------------------------------------------------------
# Whole train steps against the reference's, same weights and batches.
# Both sides start from zero moments and step 0, so only the parameters
# are carried across (params_from_jax).
# ---------------------------------------------------------------------------
CELL = (32, 8)                # seq_len, global batch
LR = 5e-3


def _jax_run(arch, steps, kernels, microbatches=1, remat=None):
    # kernels "model": the model's own use_kernels (flash attention and the
    # fused LM-head CE); True / False: the loss policy's only
    jm = jbuild(arch, reduced=True, use_kernels=kernels == "model")
    if remat is not None:
        jm.cfg = dataclasses.replace(jm.cfg, remat=remat)
    params = jm.init(jax.random.PRNGKey(0))
    state = jstate.init_state(params)
    ds = JSyntheticLM(jm.cfg, JShapeCell("t", *CELL, "train"), seed=0)
    step = jax.jit(jstep.make_train_step(
        jm, lr_schedule=functools.partial(jsched.constant, peak_lr=LR),
        microbatches=microbatches,
        softmax_policy=(None if kernels == "model"
                        else JPolicy(use_kernels=kernels))))
    out = []
    for i in range(steps):
        state, met = step(state, ds.batch_at(i))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return jax.tree.map(np.asarray, params), out


def _torch_run(arch, np_params, steps, kernels, microbatches=1, **over):
    tm = build_model(arch, reduced=True, device="cpu",
                     use_kernels=kernels == "model", **over)
    state = train_state.init_state(params_from_jax(np_params, tm.cfg,
                                                   device="cpu"))
    ds = SyntheticLM(tm.cfg, ShapeCell("t", *CELL, "train"), seed=0)
    step = step_fn.make_train_step(
        tm, lr_schedule=functools.partial(schedules.constant, peak_lr=LR),
        microbatches=microbatches,
        softmax_policy=(None if kernels == "model"
                        else SoftmaxPolicy(use_kernels=kernels)))
    out = []
    for i in range(steps):
        state, met = step(state, ds.batch_at(i))
        out.append((float(met["loss"]), float(met["grad_norm"])))
        assert float(met["lr"]) == pytest.approx(LR)
    return state, out


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _cached_jax(cache, *key):
    if key not in cache:
        cache[key] = _jax_run(*key)
    return cache[key]


# Three AdamW steps at lr 5e-3 from the same float32 weights: the first
# update is lr * sign(g) wherever |g| >> eps, so the trajectories separate
# only by float32 summation order (~1e-6 relative per step, amplified by
# the sign-like first steps); rtol 1e-4 on the loss and 1e-3 on the
# gradient norm.  "model_kernels" runs the model with its own use_kernels:
# attention through the flash route (both sides' (m, n) chunked forms) and
# the loss through the fused LM-head CE.
@pytest.mark.parametrize("kernels", [False, True, "model"],
                         ids=["plain_loss", "fused_lmhead_loss",
                              "model_kernels"])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-20b"])
def test_train_steps_match_reference(jax_runs, arch, kernels):
    params, want = _cached_jax(jax_runs, arch, 3, kernels)
    _, got = _torch_run(arch, params, 3, kernels)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-4)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-3)


def test_microbatching_matches_full_batch(jax_runs):
    """Gradient accumulation must not change the trajectory (linearity);
    the port's two-microbatch run is also held against the reference's."""
    params, full = _cached_jax(jax_runs, "granite-20b", 3, False)
    _, jmb = _jax_run("granite-20b", 3, False, microbatches=2)
    _, got = _torch_run("granite-20b", params, 3, False, microbatches=2)
    np.testing.assert_allclose([g[0] for g in got], [f[0] for f in full],
                               rtol=2e-3)
    np.testing.assert_allclose([g[0] for g in got], [f[0] for f in jmb],
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "whisper-base"])
def test_remat_changes_no_number(arch):
    # whisper-base: the encoder's and the decoder's layers (with the
    # cross-attention) are checkpointed as the decoder-only stack's
    params = jax.tree.map(np.asarray, jbuild(arch, reduced=True).init(
        jax.random.PRNGKey(0)))
    st_a, a = _torch_run(arch, params, 2, True, remat=False)
    st_b, b = _torch_run(arch, params, 2, True, remat=True)
    assert a == b
    for x, y in zip(adamw.leaves(st_a.params), adamw.leaves(st_b.params)):
        assert torch.equal(x, y)


def test_step_leaves_no_graph_or_grad(jax_runs):
    params, _ = _cached_jax(jax_runs, "qwen2.5-14b", 3, True)
    state, _ = _torch_run("qwen2.5-14b", params, 1, True)
    for p in adamw.leaves(state.params):
        assert p.grad is None and not p.requires_grad and p.grad_fn is None
    assert int(state.opt.step) == 1


def test_unported_grad_compression_is_refused():
    tm = build_model("qwen2.5-14b", reduced=True, device="cpu")
    with pytest.raises(NotImplementedError, match="applies no compression but 'bf16'"):
        step_fn.make_train_step(tm, grad_compression="int8")


def test_lm_loss_with_mask_matches_reference():
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr

    jm = jbuild("qwen2.5-14b", reduced=True)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model("qwen2.5-14b", reduced=True, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 256, (2, 21)).astype(np.int32)
    mask = (rng.random((2, 20)) < 0.7).astype(np.float32)
    for kern in (False, True):
        want = jtr.train_loss(jp, {"tokens": jnp.asarray(tok),
                                   "mask": jnp.asarray(mask)}, cfg=jm.cfg,
                              policy=JPolicy(use_kernels=kern))
        got = tm.loss(tp, {"tokens": torch.from_numpy(tok),
                           "mask": torch.from_numpy(mask)},
                      policy=SoftmaxPolicy(use_kernels=kern))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# The flash route: attention_core takes it under exactly the reference's
# conditions, and gives the reference's attention_core there.
# ---------------------------------------------------------------------------
def _qkv(sq=8, skv=8):
    q = torch.randn(1, 2, 2, sq, 16)
    k = torch.randn(1, 2, skv, 16)
    return q, k, torch.randn(1, 2, skv, 16)


@pytest.mark.parametrize("case", ["causal", "non_causal", "window",
                                  "unmasked_ragged", "model_loss"])
def test_attention_core_flash_route_matches_reference(case):
    from repro.models import attention as jattn
    from repro.models import transformer as jtr

    from repro_torch import kernels as tk

    if case == "model_loss":
        # Model.loss with the model's kernels on: every layer's attention
        # takes the route, and the loss the fused LM-head CE
        jm = jbuild("qwen2.5-14b", reduced=True, use_kernels=True)
        jp = jm.init(jax.random.PRNGKey(3))
        tm = build_model("qwen2.5-14b", reduced=True, device="cpu",
                         use_kernels=True)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                             device="cpu")
        tok = np.random.default_rng(4).integers(0, 256, (2, 33)).astype(
            np.int32)
        want = jtr.train_loss(jp, {"tokens": jnp.asarray(tok)}, cfg=jm.cfg)
        got = tm.loss(tp, {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        return
    jcfg = dataclasses.replace(jbuild("qwen2.5-14b", reduced=True).cfg,
                               use_kernels=True)
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              use_kernels=True)
    sq, skv = (24, 40) if case == "unmasked_ragged" else (40, 40)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 2, 3, sq, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, skv, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, skv, 16)).astype(np.float32)
    kw = dict(causal=case in ("causal", "window"),
              window=7 if case == "window" else None, scale=0.25)
    assert tattn._flash_route(
        *(torch.from_numpy(x) for x in (q, k, v)), cfg.softmax_policy(),
        q_offset=0, kv_len=None, qpos=None, **kw) is not None
    before = tk.launch_counts()
    got = tattn.attention_core(*(torch.from_numpy(x) for x in (q, k, v)),
                               cfg=cfg, **kw)
    assert tk.launch_counts() == before   # plain versions on the CPU
    want = jattn.attention_core(*(jnp.asarray(x) for x in (q, k, v)),
                                cfg=jcfg, **kw)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("case", ["qpos", "kv_len", "q_offset",
                                  "three_pass", "causal_ragged",
                                  "no_kernels"])
def test_attention_core_keeps_the_other_routes(case):
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              use_kernels=case != "no_kernels")
    q, k, v = _qkv(8, 12 if case == "causal_ragged" else 8)
    kw = dict(causal=True, window=None, scale=0.25)
    if case == "qpos":
        kw["qpos"] = torch.arange(8)
    elif case == "kv_len":
        kw["kv_len"] = 8
    elif case == "q_offset":
        kw["q_offset"] = 2
    elif case == "three_pass":
        cfg = dataclasses.replace(cfg,
                                  softmax_algorithm="three_pass_reload")
    out = tattn.attention_core(q, k, v, cfg=cfg, **kw)
    assert out.shape == q.shape and torch.isfinite(out).all()
