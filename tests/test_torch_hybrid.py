"""The port's hybrid family (hymba-1.5b) against the JAX package on the
CPU: the mamba heads, the parallel attention ‖ mamba block, the model, its
caches and its serving, with the same weights carried across through numpy
(reduced hymba-1.5b: 2 layers, 4 query heads over 2 KV heads of 16, SWA
window 8, 4 mamba heads of 16 with state size 8, chunk 8, float32).

Tolerances: the mixers and the block 1e-5 (both packages sum a chunk's log
decays and the products in their own float32 order); the model's logits
and caches ``ATOL`` 1e-4, as test_torch_models; the port's ring against
its position-addressed cache 2e-3, as test_torch_swa (the ring's scores
come in slot order); greedy tokens ``==``; cache bytes ``==``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import hybrid as jhyb
from repro.models import transformer as jtr
from repro.serving import engine as jeng
from repro.serving import kv_cache as jkv
from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.models import build_model as tbuild
from repro_torch.models import hybrid as thyb
from repro_torch.models import transformer as ttr
from repro_torch.serving import fused, scheduler
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "hymba-1.5b"
MIX_TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4
RING_ATOL = 2e-3
MAX_LEN = 48


@pytest.fixture(scope="module")
def weights():
    jm = jbuild(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(ARCH, reduced=True, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _kernels(cfg, use_kernels):
    return dataclasses.replace(cfg, use_kernels=use_kernels)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _x(cfg, *shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def _layer0(jp, tp):
    return (jax.tree.map(lambda t: t[0], jp["blocks"]),
            ttr.layer(tp["blocks"], 0))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or MIX_TOL))


# ---------------------------------------------------------------------------
# The mamba heads and the block.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 13, 40])
def test_mamba_mixer_and_its_state_match_reference(weights, s):
    jm, jp, tm, tp = weights
    jb, tb = _layer0(jp, tp)
    x = _x(tm.cfg, 2, s)
    st = np.random.default_rng(2).standard_normal((2, 4, 8, 16)).astype(
        np.float32)
    want, jst = jhyb.mamba_mixer(jb["mamba"], jnp.asarray(x), cfg=jm.cfg,
                                 state=jnp.asarray(st), return_state=True)
    got, tst = thyb.mamba_mixer(tb["mamba"], torch.from_numpy(x),
                                cfg=tm.cfg, state=torch.from_numpy(st),
                                return_state=True)
    _close(got, want)
    _close(tst, jst)
    assert tst.dtype == torch.float32
    no_state = thyb.mamba_mixer(tb["mamba"], torch.from_numpy(x),
                                cfg=tm.cfg)
    _close(no_state, jhyb.mamba_mixer(jb["mamba"], jnp.asarray(x),
                                      cfg=jm.cfg))


def test_mamba_mixer_step_matches_reference(weights):
    jm, jp, tm, tp = weights
    jb, tb = _layer0(jp, tp)
    x = _x(tm.cfg, 3, seed=3)
    st = np.random.default_rng(4).standard_normal((3, 4, 8, 16)).astype(
        np.float32)
    want, jst = jhyb.mamba_mixer_step(jb["mamba"], jnp.asarray(x),
                                      cfg=jm.cfg, state=jnp.asarray(st))
    got, tst = thyb.mamba_mixer_step(tb["mamba"], torch.from_numpy(x),
                                     cfg=tm.cfg, state=torch.from_numpy(st))
    _close(got, want)
    _close(tst, jst)


def test_bf16_activations_keep_dt_and_the_decay_in_float32(weights):
    _, _, tm, tp = weights
    tb = ttr.layer(tp["blocks"], 0)
    x = torch.from_numpy(_x(tm.cfg, 2, 5)).to(torch.bfloat16)
    xv, z, bk, ck, log_a = thyb._ssd_inputs(tb["mamba"], x, tm.cfg)
    assert log_a.dtype == torch.float32 and bool((log_a <= 0).all())
    assert xv.dtype == z.dtype == bk.dtype == torch.bfloat16
    y, st = thyb.mamba_mixer(tb["mamba"], x, cfg=tm.cfg, return_state=True)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32


def test_hybrid_block_prefill_and_decode_match_reference(weights):
    """The block with a cache: a prompt of 11 written at 0, then one
    token at 11 (promoted to S = 1), the caches after each."""
    jm, jp, tm, tp = weights
    cfg = tm.cfg
    jb, tb = _layer0(jp, tp)
    jc = jax.tree.map(lambda t: t[0],
                      jkv.init_cache(jm.cfg, 2, 16, ring=False))
    tc = ttr.layer(tkv.init_cache(cfg, 2, 16, ring=False, device="cpu"), 0)
    x = _x(cfg, 2, 11, seed=5)
    jcs = jtr._cos_sin(jm.cfg, jnp.arange(11))
    tcs = ttr._cos_sin(cfg, torch.arange(11))
    block = jax.jit(functools.partial(jhyb.hybrid_block, cfg=jm.cfg),
                    static_argnames="cache_pos")
    want, jc = block(jb, jnp.asarray(x), *jcs, cache=jc, cache_pos=0)
    ptr = tc["ssm"].data_ptr()
    got, tc2 = thyb.hybrid_block(tb, torch.from_numpy(x), *tcs, cfg=cfg,
                                 cache=tc, cache_pos=0)
    assert tc2 is tc and tc["ssm"].data_ptr() == ptr   # written in place
    _close(got, want)
    for got_leaf, want_leaf in ((tc["ssm"], jc["ssm"]),
                                (tc["attn"]["k"], jc["attn"]["k"]),
                                (tc["attn"]["v"], jc["attn"]["v"])):
        _close(got_leaf, want_leaf)
    x1 = _x(cfg, 2, seed=6)
    jcs = jtr._cos_sin(jm.cfg, jnp.full((2, 1), 11))
    tcs = ttr._cos_sin(cfg, torch.full((2, 1), 11))
    want, jc = block(jb, jnp.asarray(x1), *jcs, cache=jc, cache_pos=11)
    got, _ = thyb.hybrid_block(tb, torch.from_numpy(x1), *tcs, cfg=cfg,
                               cache=tc, cache_pos=11)
    assert tuple(got.shape) == (2, cfg.d_model)
    _close(got, want)
    _close(tc["ssm"], jc["ssm"])
    _close(tc["attn"]["k"], jc["attn"]["k"])


# ---------------------------------------------------------------------------
# The model, the prefill state and the ring.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_forward_prefill_state_and_decode_match_reference(weights,
                                                          use_kernels):
    jm, jp, tm, tp = weights
    jcfg = _kernels(jm.cfg, use_kernels)
    tm = Model(_kernels(tm.cfg, use_kernels), "cpu")
    toks = _tokens(2, 19, seed=2)
    np.testing.assert_allclose(
        tm.forward(tp, torch.from_numpy(toks).long()).numpy(),
        np.asarray(jtr.forward(jp, jnp.asarray(toks), cfg=jcfg)), atol=ATOL)
    jl, jc = jeng.prefill(jp, jnp.asarray(toks), cfg=jcfg, max_len=32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks).long(), max_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)

    def check_cache():
        assert tc.keys() == jc.keys() == {"attn", "ssm"}
        np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                                   atol=ATOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tc["attn"][n].numpy(),
                                       np.asarray(jc["attn"][n]), atol=ATOL)

    check_cache()
    for t in range(3):
        tok = _tokens(2, 1, seed=10 + t)[:, 0]
        jl, jc = jeng.decode_step(jp, jc, jnp.asarray(tok), 19 + t,
                                  cfg=jcfg)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long(),
                                19 + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        check_cache()


def test_ring_matches_reference_and_a_position_addressed_cache(weights):
    """``init_cache(ring=True)``: the attention half a ring of the window
    (8), stepped from 0 past its wrap twice; against the reference's ring
    (1e-4) and against the port's own prefilled full cache past the wrap
    (2e-3, the ring's scores in slot order)."""
    jm, jp, tm, tp = weights
    w, n = tm.cfg.swa_window, 21
    toks = _tokens(2, n, seed=7)
    jc = jkv.init_cache(jm.cfg, 2, 32)
    tc = tm.init_cache(2, 32)
    assert tc["attn"]["k"].shape[2] == w and tc["ssm"].shape[1] == 2
    ring = []
    step = jax.jit(functools.partial(jeng.decode_step, cfg=jm.cfg))
    for t in range(n):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t]), t)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]).long(),
                                t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        ring.append(tl)
    _, full = tm.prefill(tp, torch.from_numpy(toks[:, :w]).long(),
                         max_len=n)
    assert full["attn"]["k"].shape[2] == n
    for t in range(w, n):
        lg, full = tm.decode_step(tp, full,
                                  torch.from_numpy(toks[:, t]).long(), t)
        np.testing.assert_allclose(ring[t].numpy(), lg.numpy(),
                                   atol=RING_ATOL)


# ---------------------------------------------------------------------------
# Caches and pools.
# ---------------------------------------------------------------------------
def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def _jshapes(tree):
    return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "full"])
@pytest.mark.parametrize("batch,max_len", [(32, 3136), (128, 32768)])
def test_cache_and_pool_bytes_match_reference(batch, max_len, ring):
    jcfg, tcfg = jget(ARCH), get_config(ARCH)
    got = tkv.init_cache(tcfg, batch, max_len, ring=ring, device="meta")
    want = jax.eval_shape(lambda: jkv.init_cache(jcfg, batch, max_len,
                                                 ring=ring))
    assert _shapes(got) == _jshapes(want)
    nbytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(want))
    assert tkv.cache_bytes(tcfg, batch, max_len, ring=ring) == nbytes
    assert tkv.slot_pool_bytes(tcfg, batch, max_len) == \
        jkv.slot_pool_bytes(jcfg, batch, max_len)
    pool = tkv.init_paged_pool(tcfg, batch, max_len, page_size=64,
                               device="meta")
    jpool = jax.eval_shape(lambda: jkv.init_paged_pool(
        jcfg, batch, max_len, page_size=64))
    assert _shapes(pool) == _jshapes(jpool)
    assert tkv.paged_pool_bytes(tcfg, batch, max_len, page_size=64) == \
        jkv.paged_pool_bytes(jcfg, batch, max_len, page_size=64)


def test_full_width_state_is_3_28_mb_a_slot():
    cfg = get_config(ARCH)
    pool = tkv.init_paged_pool(cfg, 32, 3136, page_size=64, device="meta")
    assert tuple(pool["kv"]["attn"]["k"].shape) == (32, 1 + 32 * 49, 64, 5,
                                                    64)
    ssm = pool["kv"]["ssm"]
    assert tuple(ssm.shape) == (32, 32, 25, 16, 64)
    assert ssm.dtype == torch.float32
    assert ssm[:, 0].numel() * 4 == 3_276_800
    # a token's K/V: 32 layers x 2 x 5 heads x 64 x bf16
    assert tkv.cache_bytes(cfg, 1, 2, ring=False) - tkv.cache_bytes(
        cfg, 1, 1, ring=False) == 40_960


def test_full_width_parameters_match_reference():
    got = tbuild(ARCH, device="meta").init_shape()
    assert _shapes(got) == _jshapes(jbuild(ARCH).init_shape())
    assert got["blocks"]["mamba"]["a_log"].dtype == torch.float32


def test_adopt_and_free_match_reference(weights):
    """A batch-1 prefill adopted into slot 1 of a paged pool of 3 slots:
    the attention pages and the slot-major state bit-equal to the
    reference's adoption; free resets the table row and leaves the state,
    as the reference's."""
    jm, jp, tm, tp = weights
    jpool = jkv.init_paged_pool(jm.cfg, 3, 32, page_size=8)
    pool = tkv.init_paged_pool(tm.cfg, 3, 32, page_size=8, device="cpu")
    toks = _tokens(1, 11, seed=8)
    # both sides adopt the reference's prefill cache
    _, jc = jeng.prefill(jp, jnp.asarray(toks), cfg=jm.cfg, max_len=16)
    tc = jax.tree.map(lambda t: torch.from_numpy(np.array(t)), jc)
    row = np.array([5, 2, 0, 0], np.int32)
    jpool = jkv.adopt_slot_paged(jpool, jc, 1, 11, jnp.asarray(row))
    ptrs = fused._ptrs(pool)
    tkv.adopt_slot_paged(pool, tc, 1, 11, torch.from_numpy(row))
    assert fused._ptrs(pool) == ptrs
    got = jax.tree.map(np.asarray, jpool)
    assert np.array_equal(pool["kv"]["ssm"].numpy(), got["kv"]["ssm"])
    for n in ("k", "v"):
        assert np.array_equal(pool["kv"]["attn"][n].numpy(),
                              got["kv"]["attn"][n])
    assert pool["page_table"].tolist() == got["page_table"].tolist()
    state = pool["kv"]["ssm"].clone()
    tkv.free_slot_paged(pool, 1)
    jfree = jax.tree.map(np.asarray, jkv.free_slot_paged(jpool, 1))
    assert pool["page_table"].tolist() == jfree["page_table"].tolist()
    assert pool["lengths"].tolist() == jfree["lengths"].tolist() == [0] * 3
    assert torch.equal(pool["kv"]["ssm"], state)


# ---------------------------------------------------------------------------
# Serving: greedy tokens against the JAX lockstep.
# ---------------------------------------------------------------------------
def _requests(vocab, plens=(3, 5, 7, 4), seed=11):
    """The hybrid cells of tests/test_family_parity.py; the 7- and
    9-token prompts reach past the window of 8."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, vocab, n)), max_new_tokens=4 + i) for i, n in enumerate(plens)]


def _copy(reqs):
    return [dataclasses.replace(r) for r in reqs]


def _lockstep(jm, jp, reqs, use_kernels=False):
    jcfg = _kernels(jm.cfg, use_kernels)
    out = []
    for r in reqs:
        toks, _ = jeng.generate_timed(
            jp, jnp.asarray(r.prompt, jnp.int32)[None], cfg=jcfg,
            steps=r.max_new_tokens - 1, key=jax.random.PRNGKey(7),
            temperature=0.0, max_len=MAX_LEN)
        out.append([int(t) for t in np.asarray(toks)[0]])
    return out


def _tokens_of(comps):
    return [list(c.tokens) for c in sorted(comps, key=lambda c: c.rid)]


@pytest.fixture(scope="module")
def jax_lockstep(weights):
    jm, jp, _, _ = weights
    memo = {}

    def run(use_kernels: bool):
        if use_kernels not in memo:
            memo[use_kernels] = _lockstep(jm, jp, _requests(jm.cfg.vocab),
                                          use_kernels)
        return memo[use_kernels]

    return run


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_greedy_tokens_match_jax_lockstep(weights, jax_lockstep, paged,
                                          use_kernels):
    _, _, tm, tp = weights
    tm = Model(_kernels(tm.cfg, use_kernels), "cpu")
    eng = tm.serving_engine(tp, slots=2, max_len=MAX_LEN, page_size=8,
                            paged=paged, temperature=0.0, seed=3)
    assert eng.buckets is None and eng.paged is paged
    got = _tokens_of(eng.run(_copy(_requests(tm.cfg.vocab))))
    assert got == jax_lockstep(use_kernels)
    assert eng.throughput()["admitted"] == 4
    assert eng._prefill_shapes == {3, 5, 7, 4}


def test_hybrid_prompts_are_not_bucketed_and_a_bucketed_prompt_is_wrong(
        weights):
    jm, jp, tm, tp = weights
    reqs = _requests(tm.cfg.vocab, plens=(3, 5, 7, 9))
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   page_size=8, temperature=0.0)
    assert eng.buckets is None
    # the fault the reference's rule avoids: a pad tail runs through the
    # mamba recurrence into the state decode goes on from
    padded = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                      page_size=8, temperature=0.0,
                                      prefill_buckets=(16, MAX_LEN))
    want = _lockstep(jm, jp, reqs)
    assert _tokens_of(padded.run(_copy(reqs))) != want
    assert _tokens_of(eng.run(_copy(reqs))) == want


class ReplayingGraph:
    """A stand-in for ``fused.CudaGraph`` on the CPU: capture keeps the
    step and replay runs it, as the card runs the captured launches."""

    pool_bytes = 0

    def __init__(self):
        self.step = None
        self.replays = self.warm_ups = 0

    def warm_up(self, step):
        for _ in range(fused.CudaGraph.WARMUP):
            step()
            self.warm_ups += 1

    def capture(self, step):
        self.step = step

    def replay(self):
        self.replays += 1
        self.step()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_replayed_step_writes_the_state_in_place(weights, jax_lockstep,
                                                 monkeypatch, paged):
    _, _, tm, tp = weights
    graphs = []

    def graph_for(device, generator=None):
        graphs.append(ReplayingGraph())
        return graphs[-1]

    monkeypatch.setattr(scheduler, "graph_for", graph_for)
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   page_size=8, paged=paged,
                                   temperature=0.0)
    want = fused._ptrs(eng.step_buffers())
    assert {"/pool/kv/ssm", "/pool/kv/attn/k", "/pool/kv/attn/v",
            "/pool/lengths", "/tokens", "/active"} <= want.keys()
    for r in _copy(_requests(tm.cfg.vocab)):
        eng.submit(r)
    eng._run_start = 0.0
    state = eng.pool["kv"]["ssm"].clone()
    while eng.pending or eng.active_slots():
        eng.step()
        assert fused._ptrs(eng.step_buffers()) == want
    assert not torch.equal(eng.pool["kv"]["ssm"], state)
    eng.completions.sort(key=lambda c: c.rid)
    assert _tokens_of(eng.completions) == jax_lockstep(False)
    assert graphs[0].replays == eng.stats["steps"] > 0


def test_rebinding_the_state_stops_the_replay(weights, monkeypatch):
    _, _, tm, tp = weights
    monkeypatch.setattr(scheduler, "graph_for",
                        lambda device, generator=None: ReplayingGraph())
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   page_size=8, temperature=0.0)
    eng.pool["kv"]["ssm"] = eng.pool["kv"]["ssm"].clone()
    with pytest.raises(RuntimeError, match="/pool/kv/ssm"):
        eng.run(_copy(_requests(tm.cfg.vocab)[:2]))


def test_training_refuses_naming_item_32(weights):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.trainer import Trainer, TrainerConfig

    _, _, tm, tp = weights
    batch = {"tokens": torch.from_numpy(_tokens(2, 9)).long()}
    with pytest.raises(NotImplementedError, match="item 32"):
        tm.loss(tp, batch)
    with pytest.raises(NotImplementedError, match="item 32"):
        SyntheticLM(tm.cfg, SHAPES["train_4k"])
    with pytest.raises(NotImplementedError, match="item 32"):
        Trainer(tm, SHAPES["train_4k"], TrainerConfig(steps=1))
