"""The port's ssm family (rwkv6-1.6b) against the JAX package on the CPU:
the WKV6 and SSD scans and their one-token steps, the RWKV6 block, the model
and its serving through the strip pool, with the same weights carried
across through numpy (reduced rwkv6-1.6b: 2 layers, 4 heads of 16,
float32).

Tolerances:
  * the scans, port against JAX (``_scan_tol``): both packages sum a
    chunk's log decays in their own order, a random walk of about sqrt(c)
    float32 ulps for a chunk of c, and every decay factor, so every output,
    carries that relative error: atol 1e-6 * sqrt(c) * max|want|;
  * a prefill then steps against one longer prefill, in one package: the
    steps multiply per-step decays where the scan takes differences of
    cumulative sums, the same error twice over (2 x ``_scan_tol``);
  * blocks, models and logits: ``ATOL`` 1e-4, as test_torch_models;
  * greedy tokens: ``==``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import model_zoo as jzoo
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.serving import engine as jeng
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.models import build_model as tbuild
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.serving import fused, scheduler
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "rwkv6-1.6b"
ATOL = 1e-4
MAX_LEN = 48
CHUNK = 8                      # the reduced config's chunk_size
KINDS = {"wkv6": (jssm.wkv6_chunked, tssm.wkv6_chunked, jssm.wkv6_step,
                  tssm.wkv6_step),
         "ssd": (jssm.ssd_chunked, tssm.ssd_chunked, jssm.ssd_step,
                 tssm.ssd_step)}


@pytest.fixture(scope="module")
def weights():
    jm = jbuild(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(ARCH, reduced=True, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# The scans and their steps.
# ---------------------------------------------------------------------------
def _scan_inputs(kind, s, seed=0, b=2, h=2, dk=16, dv=16):
    """Seeded numpy inputs of a scan, shaped and scaled as the model's."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if kind == "wkv6":
        return dict(r=n(b, s, h, dk) * 0.5, k=n(b, s, h, dk) * 0.5,
                    v=n(b, s, h, dv),
                    log_w=-np.exp(n(b, s, h, dk) * 0.5 - 0.6),
                    u=n(h, dk) * 0.1)
    return dict(xv=n(b, s, h, dv), log_a=-np.exp(n(b, s, h) * 0.5 - 1.0),
                bk=n(b, s, h, 8) * 0.5, ck=n(b, s, h, 8) * 0.5)


def _scan_tol(kind, s, want, times=1):
    c = tssm.chunk_plan("rwkv6" if kind == "wkv6" else "mamba2", s,
                        CHUNK)[0]
    return dict(atol=times * 1e-6 * c ** 0.5 * float(np.abs(want).max()),
                rtol=0)


def _run(fn, x, lib, **kw):
    cast = jnp.asarray if lib == "jax" else torch.from_numpy
    out = fn(**{k: cast(v) for k, v in x.items()}, **kw)
    return tuple(np.asarray(t) for t in out)


# 8448 = 33 chunks of 256: the wkv6 scan branch; 33792 = 33 of 1024: SSD's
@pytest.mark.parametrize("kind,s", [(k, s) for k in KINDS
                                    for s in (7, 33, 100, 8448)]
                         + [("ssd", 33792)])
def test_chunked_scan_matches_reference(kind, s):
    jf, tf, _, _ = KINDS[kind]
    x = _scan_inputs(kind, s)
    want_y, want_st = _run(jf, x, "jax", chunk=CHUNK, return_state=True)
    got_y, got_st = _run(tf, x, "torch", chunk=CHUNK, return_state=True)
    assert got_y.dtype == np.float32 and got_y.shape == want_y.shape
    np.testing.assert_allclose(got_y, want_y, **_scan_tol(kind, s, want_y))
    np.testing.assert_allclose(got_st, want_st,
                               **_scan_tol(kind, s, want_st))


@pytest.mark.parametrize("kind", list(KINDS))
def test_step_matches_reference(kind):
    _, _, jstep, tstep = KINDS[kind]
    x = {k: v[:, 0] if k != "u" else v
         for k, v in _scan_inputs(kind, 1, seed=3).items()}
    st = np.random.default_rng(4).standard_normal(
        (2, 2, 16 if kind == "wkv6" else 8, 16)).astype(np.float32)
    args = ("r", "k", "v", "log_w", "u") if kind == "wkv6" else (
        "xv", "log_a", "bk", "ck")
    want = jstep(jnp.asarray(st), *(jnp.asarray(x[a]) for a in args))
    got = tstep(torch.from_numpy(st), *(torch.from_numpy(x[a])
                                        for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def _steps(step, chunked, x, s, n, lib):
    """chunked(first s positions), then n steps; returns (the steps'
    outputs [B, n, ...], the final state)."""
    cast = jnp.asarray if lib == "jax" else torch.from_numpy
    seq = {k: v for k, v in x.items() if k != "u"}
    kw = {"u": cast(x["u"])} if "u" in x else {}
    _, st = chunked(**{k: cast(v[:, :s]) for k, v in seq.items()}, **kw,
                    chunk=CHUNK, return_state=True)
    if lib == "jax":
        step = jax.jit(step)
    ys = []
    for t in range(s, s + n):
        y, st = step(st, *(cast(np.ascontiguousarray(v[:, t]))
                           for v in seq.values()), *kw.values())
        ys.append(np.asarray(y))
    return np.stack(ys, axis=1), np.asarray(st)


# (s, n): chunked(s) + n steps against chunked(s + n); 8192 + 256 ends in
# the scan branch (chunked(8193) would not divide into chunks of 256)
@pytest.mark.parametrize("s,n", [(7, 1), (33, 1), (100, 1), (8192, 256)])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("lib", ["jax", "torch"])
def test_chunked_then_steps_matches_one_longer_chunked(lib, kind, s, n):
    jf, tf, jstep, tstep = KINDS[kind]
    chunked, step = (jf, jstep) if lib == "jax" else (tf, tstep)
    x = _scan_inputs(kind, s + n, seed=5)
    if kind == "ssd":                  # ssd_step's argument order
        x = {k: x[k] for k in ("xv", "log_a", "bk", "ck")}
    ys, st = _steps(step, chunked, x, s, n, lib)
    want_y, want_st = _run(chunked, x, lib, chunk=CHUNK, return_state=True)
    np.testing.assert_allclose(ys, want_y[:, s:],
                               **_scan_tol(kind, s + n, want_y, 2))
    np.testing.assert_allclose(st, want_st,
                               **_scan_tol(kind, s + n, want_st, 2))


@pytest.mark.parametrize("kind", list(KINDS))
def test_scan_branch_needs_a_multiple_of_the_chunk_as_the_reference(kind):
    jf, tf, _, _ = KINDS[kind]
    s = 8449 if kind == "wkv6" else 32 * 1024 + 1
    x = _scan_inputs(kind, s, b=1, h=1, dk=4, dv=4)
    assert tssm.chunk_plan("rwkv6" if kind == "wkv6" else "mamba2", s,
                           CHUNK)[2]
    with pytest.raises(AssertionError):
        _run(jf, x, "jax", chunk=CHUNK)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        _run(tf, x, "torch", chunk=CHUNK)


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
@pytest.mark.parametrize("s", [7, 1000, 8192, 8448, 33792, 524288])
def test_chunk_plan_and_flops_correction_match_reference(kind, s):
    assert tssm.chunk_plan(kind, s, 32) == jssm.chunk_plan(kind, s, 32)
    assert tssm.scan_flops_correction(kind, 1, s, 32, 64, 64, 32) == \
        jssm.scan_flops_correction(kind, 1, s, 32, 64, 64, 32)


def test_scan_keeps_the_input_dtype():
    x = _scan_inputs("wkv6", 40)
    args = {k: torch.from_numpy(v).to(torch.bfloat16) if k != "u"
            else torch.from_numpy(v) for k, v in x.items()}
    y, st = tssm.wkv6_chunked(**args, chunk=CHUNK, return_state=True)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32


# ---------------------------------------------------------------------------
# The block and the model.
# ---------------------------------------------------------------------------
def _layer0(tree):
    return jax.tree.map(lambda t: t[0], tree)


def test_rwkv_block_prefill_and_decode_match_reference(weights):
    jm, jp, tm, tp = weights
    cfg = tm.cfg
    jb, tb = _layer0(jp["blocks"]), ttr.layer(tp["blocks"], 0)
    x = np.random.default_rng(1).standard_normal((2, 19, cfg.d_model)
                                                 ).astype(np.float32)
    want, jst = jrwkv.rwkv_block(jb, jnp.asarray(x), cfg=jm.cfg,
                                 return_state=True)
    got, tst = trwkv.rwkv_block(tb, torch.from_numpy(x), cfg=cfg,
                                return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for name in ("wkv", "last_t", "last_c"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   atol=ATOL, err_msg=name)
    x1 = np.random.default_rng(2).standard_normal((2, cfg.d_model)).astype(
        np.float32)
    want, jst = jrwkv.rwkv_block(jb, jnp.asarray(x1), cfg=jm.cfg, state=jst)
    got, tst = trwkv.rwkv_block(tb, torch.from_numpy(x1), cfg=cfg,
                                state=tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for name in ("wkv", "last_t", "last_c"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   atol=ATOL, err_msg=name)


def test_model_forward_matches_reference(weights):
    jm, jp, tm, tp = weights
    toks = _tokens(2, 21)
    want = jtr.forward(jp, jnp.asarray(toks), cfg=jm.cfg)
    got = tm.forward(tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_logits_and_state_then_decode_match_reference(weights):
    jm, jp, tm, tp = weights
    toks = _tokens(2, 21, seed=2)
    jl, jc = jeng.prefill(jp, jnp.asarray(toks), cfg=jm.cfg, max_len=32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks).long(), max_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tc.keys() == jc.keys()
    for name in tc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, err_msg=name)
    for t in range(3):
        tok = _tokens(2, 1, seed=10 + t)[:, 0]
        jl, jc = jeng.decode_step(jp, jc, jnp.asarray(tok), 21 + t,
                                  cfg=jm.cfg)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long(),
                                21 + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        for name in tc:
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), atol=ATOL)


def test_prefill_then_decode_matches_forward(weights):
    _, _, tm, tp = weights
    toks = torch.from_numpy(_tokens(2, 9, seed=3)).long()
    want = ttr.lm_logits(tp, tm.forward(tp, toks)[:, -1], cfg=tm.cfg)
    _, cache = tm.prefill(tp, toks[:, :-1], max_len=16)
    got, _ = tm.decode_step(tp, cache, toks[:, -1], 8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# The cache and the facade's shapes.
# ---------------------------------------------------------------------------
def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("batch,max_len", [(8, 1024), (128, 32768),
                                           (1, 524288)])
def test_state_shapes_and_bytes_match_reference(batch, max_len):
    jcfg, tcfg = jget(ARCH), get_config(ARCH)
    want = jax.eval_shape(lambda: jkv.init_cache(jcfg, batch, max_len))
    got = tkv.init_cache(tcfg, batch, max_len, device="meta")
    assert _shapes(got) == jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)), want)
    assert tkv.cache_bytes(tcfg, batch, max_len) == jkv.cache_bytes(
        jcfg, batch, max_len)
    assert tkv.slot_pool_bytes(tcfg, batch, max_len) == jkv.slot_pool_bytes(
        jcfg, batch, max_len)
    for budget in (10 ** 8, 10 ** 9, 40 * 10 ** 9):
        assert tkv.max_slots_in_budget(tcfg, max_len, budget) == \
            jkv.max_slots_in_budget(jcfg, max_len, budget)


def test_full_width_state_is_12_6_mb_a_slot():
    cfg = get_config(ARCH)
    per_slot = tkv.slot_pool_bytes(cfg, 2, 8) - tkv.slot_pool_bytes(cfg, 1,
                                                                     8)
    assert per_slot == 24 * (32 * 64 * 64 * 4 + 2 * 2048 * 2) + 4
    leaves = tkv.init_cache(cfg, 1, 8, device="meta")
    assert {k: v.dtype for k, v in leaves.items()} == {
        "wkv": torch.float32, "last_t": torch.bfloat16,
        "last_c": torch.bfloat16}


def test_init_shape_matches_reference():
    got = tbuild(ARCH, device="meta").init_shape()
    want = jbuild(ARCH).init_shape()
    assert _shapes(got) == jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)), want)


def test_adopt_slot_copies_every_leaf_of_the_slot_in_place(weights):
    _, _, tm, tp = weights
    pool = tm.init_slot_pool(3, MAX_LEN)
    ptrs = {k: v.data_ptr() for k, v in pool["kv"].items()}
    for t in pool["kv"].values():
        t.fill_(7.0)                                 # dead state
    _, cache = tm.prefill(tp, torch.from_numpy(_tokens(1, 5)).long())
    tkv.adopt_slot(pool, cache, 1, 5)
    assert {k: v.data_ptr() for k, v in pool["kv"].items()} == ptrs
    for name, t in pool["kv"].items():
        assert torch.equal(t[:, 1], cache[name][:, 0].to(t.dtype)), name
        assert bool((t[:, 0] == 7).all() and (t[:, 2] == 7).all())
    assert pool["lengths"].tolist() == [0, 5, 0]


def test_ssm_does_not_page():
    cfg = get_config(ARCH).reduced()
    assert not tkv.supports_paging(cfg)
    with pytest.raises(ValueError, match="no position axis"):
        tkv.init_paged_pool(cfg, 2, 16, page_size=8, device="meta")


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k",
                                  "long_500k"])
def test_input_specs_match_reference(cell):
    tcfg, jcfg = get_config(ARCH), jget(ARCH)
    assert tzoo.cell_supported(tcfg, cell) == jzoo.cell_supported(jcfg, cell)
    assert tzoo.cell_supported(tcfg, cell)[0]
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        jzoo.input_specs(jcfg, cell))
    assert _shapes(tzoo.input_specs(tcfg, cell)) == want


def test_training_refuses_naming_item_27(weights):
    from repro_torch.configs import SHAPES
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.trainer import Trainer, TrainerConfig

    _, _, tm, tp = weights
    batch = {"tokens": torch.from_numpy(_tokens(2, 9)).long()}
    with pytest.raises(NotImplementedError, match="item 27"):
        tm.loss(tp, batch)
    with pytest.raises(NotImplementedError, match="item 27"):
        SyntheticLM(tm.cfg, SHAPES["train_4k"])
    with pytest.raises(NotImplementedError, match="item 27"):
        Trainer(tm, SHAPES["train_4k"], TrainerConfig(steps=1))


# ---------------------------------------------------------------------------
# Serving: greedy tokens through the strip pool against the JAX lockstep.
# ---------------------------------------------------------------------------
def _requests(vocab, plens=(3, 5, 7, 4), seed=11):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, vocab, n)), max_new_tokens=4 + i) for i, n in enumerate(plens)]


def _copy(reqs):
    return [dataclasses.replace(r) for r in reqs]


def _lockstep(jm, jp, reqs, use_kernels=False):
    jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
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


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["ssm-jnp", "ssm-kernels"])
def test_greedy_tokens_match_jax_lockstep(weights, use_kernels):
    jm, jp, tm, tp = weights
    tm = Model(dataclasses.replace(tm.cfg, use_kernels=use_kernels), "cpu")
    reqs = _requests(tm.cfg.vocab)
    # 4 requests over 2 slots: slot reuse, ragged ages, the strip pool
    eng = tm.serving_engine(tp, slots=2, max_len=MAX_LEN, temperature=0.0,
                            seed=3)
    assert eng.paged is False and eng.buckets is None
    got = _tokens_of(eng.run(_copy(reqs)))
    assert got == _lockstep(jm, jp, reqs, use_kernels)
    assert eng.throughput()["admitted"] == 4 > eng.n_slots


def test_ssm_prompts_are_not_bucketed_and_a_bucketed_prompt_is_wrong(
        weights):
    jm, jp, tm, tp = weights
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   temperature=0.0)
    assert eng.buckets is None
    # the fault the reference's rule avoids: a pad tail runs through the
    # recurrence into the state decode goes on from
    reqs = _requests(tm.cfg.vocab, plens=(3, 5, 7, 9))
    padded = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                      temperature=0.0,
                                      prefill_buckets=(16, MAX_LEN))
    assert padded.buckets == (16, MAX_LEN)
    want = _lockstep(jm, jp, reqs)
    assert _tokens_of(padded.run(_copy(reqs))) != want
    assert _tokens_of(eng.run(_copy(reqs))) == want


class ReplayingGraph:
    """A stand-in for ``fused.CudaGraph`` on the CPU: capture keeps the
    step and replay runs it, as the card runs the captured launches."""

    pool_bytes = 0

    def __init__(self):
        self.replays = self.warm_ups = 0
        self.step = None

    def warm_up(self, step):
        for _ in range(fused.CudaGraph.WARMUP):
            step()
            self.warm_ups += 1

    def capture(self, step):
        self.step = step

    def replay(self):
        self.replays += 1
        self.step()


def test_replayed_step_matches_jax_lockstep_and_keeps_the_state(
        weights, monkeypatch):
    jm, jp, tm, tp = weights
    graphs = []

    def graph_for(device, generator=None):
        graphs.append(ReplayingGraph())
        return graphs[-1]

    monkeypatch.setattr(scheduler, "graph_for", graph_for)
    reqs = [Request(rid=i, prompt=r.prompt, max_new_tokens=9)
            for i, r in enumerate(_requests(tm.cfg.vocab, (4, 9, 2, 6, 5)))]
    eng = ContinuousBatchingEngine(tm, tp, slots=3, max_len=MAX_LEN,
                                   temperature=0.0)
    want = fused._ptrs(eng.step_buffers())
    assert {"/pool/kv/wkv", "/pool/kv/last_t", "/pool/kv/last_c",
            "/pool/lengths", "/tokens", "/active"} <= want.keys()
    for r in _copy(reqs):
        eng.submit(r)
    eng._run_start = 0.0
    bursts = 0
    while eng.pending or eng.active_slots():
        bursts += eng.step()
        assert fused._ptrs(eng.step_buffers()) == want
    eng.completions.sort(key=lambda c: c.rid)
    assert _tokens_of(eng.completions) == _lockstep(jm, jp, reqs)
    st = eng.stats
    assert graphs[0].warm_ups == 2 and st["admitted"] > eng.n_slots
    assert graphs[0].replays == eng._fused.replays == st["steps"] > bursts


def test_rebinding_a_state_leaf_stops_the_replay(weights, monkeypatch):
    _, _, tm, tp = weights
    monkeypatch.setattr(scheduler, "graph_for",
                        lambda device, generator=None: ReplayingGraph())
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   temperature=0.0)
    eng.pool["kv"]["wkv"] = eng.pool["kv"]["wkv"].clone()
    with pytest.raises(RuntimeError, match="/pool/kv/wkv"):
        eng.run(_copy(_requests(tm.cfg.vocab)[:2]))


def test_sampled_serving_is_seeded(weights):
    _, _, tm, tp = weights
    runs = []
    for _ in range(2):
        eng = tm.serving_engine(tp, slots=2, max_len=MAX_LEN,
                                temperature=0.8, seed=9)
        runs.append(_tokens_of(eng.run(_copy(_requests(tm.cfg.vocab)))))
    assert runs[0] == runs[1]
    assert all(0 <= t < tm.cfg.vocab for x in runs[0] for t in x)


def test_facade_generate_and_ragged_step_match_reference(weights):
    jm, jp, tm, tp = weights
    toks = _tokens(2, 7, seed=4)
    want, _ = jeng.generate_timed(jp, jnp.asarray(toks), cfg=jm.cfg,
                                  steps=5, key=jax.random.PRNGKey(7),
                                  temperature=0.0, max_len=16)
    got = tm.generate(tp, torch.from_numpy(toks).long(), steps=5,
                      temperature=0.0)
    assert got.tolist() == np.asarray(want).tolist()
    # the ragged step on a pool: slot 1 free (dead state, length 0), slot 0
    # holds the first prompt; its logits equal the lockstep step's
    pool = tm.init_slot_pool(2, MAX_LEN)
    _, cache = tm.prefill(tp, torch.from_numpy(toks[:1]).long())
    tkv.adopt_slot(pool, cache, 0, 7)
    tok = torch.tensor([3, 9])
    lg, pool = tm.decode_step_ragged(tp, pool, tok)
    want, _ = tm.decode_step(tp, cache, tok[:1], 7)
    # batch 2 against batch 1: the matmuls may sum in another order
    np.testing.assert_allclose(lg[:1].numpy(), want.numpy(), atol=ATOL)
    assert pool["lengths"].tolist() == [8, 0]
