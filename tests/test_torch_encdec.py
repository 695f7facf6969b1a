"""The port's encdec family (whisper-base) against the JAX package on the
CPU: the GELU MLP, the encoder, the cross-attention routes, the prefill and
the lockstep decode, the paged pool's cross pages, and serving through the
paged engine, with the same weights carried across through numpy (reduced
whisper-base: 2 encoder and 2 decoder layers, d_model 64, 4 heads of 16
over 2 KV heads, float32).

Tolerances:
  * the MLP: 1e-6 (the same float32 products; the GELU forms differ by up
    to 4.7e-4);
  * the encoder, the cross reads, the prefill (logits and both cache
    halves) and 8 lockstep steps: 1e-5, float32;
  * adoption: arena pages and tables bit-equal;
  * greedy tokens: ``==``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.serving import engine as jeng
from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.serving import engine as teng
from repro_torch.serving import fused, scheduler
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "whisper-base"
ATOL = 1e-5
MAX_LEN = 48
N_FRAMES = 6                 # encoder frames a request, as test_family_parity


@pytest.fixture(scope="module")
def weights():
    jm = jbuild(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(ARCH, reduced=True, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, atol=ATOL):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], atol)
        return
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _frames(b, t, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# The GELU MLP: the tanh form, as jax.nn.gelu's default.
# ---------------------------------------------------------------------------
def test_gelu_mlp_matches_reference():
    rng = np.random.default_rng(5)
    d, f = 64, 128
    p = {"up": {"w": rng.standard_normal((d, f)).astype(np.float32)
                * d ** -0.5},
         "down": {"w": rng.standard_normal((f, d)).astype(np.float32)
                  * f ** -0.5}}
    x = (rng.standard_normal((3, 5, d)) * 2).astype(np.float32)
    want = jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                       act="gelu")
    got = tlayers.mlp(jax.tree.map(_t, p), _t(x), act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# Weights, config and shapes.
# ---------------------------------------------------------------------------
def test_params_from_jax_carries_the_encoder_and_cross_leaves(weights):
    jm, jp, tm, tp = weights
    assert set(tp) == {"embed", "norm_f", "blocks", "lm_head", "enc_blocks",
                       "enc_norm"}
    assert {"ln_x", "xattn"} <= set(tp["blocks"])
    assert "xattn" not in tp["enc_blocks"]
    tree = jax.tree.map(np.asarray, jp)
    short = dict(tree, enc_blocks=jax.tree.map(lambda a: a[:1],
                                               tree["enc_blocks"]))
    with pytest.raises(ValueError, match="enc_blocks stack 1 layers"):
        params_from_jax(short, tm.cfg, device="cpu")
    with pytest.raises(ValueError, match="top-level keys"):
        params_from_jax({k: v for k, v in tree.items() if k != "enc_norm"},
                        tm.cfg, device="cpu")


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def test_full_width_init_shape_and_param_count_match_reference():
    got = tbuild(ARCH, device="meta").init_shape()
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        jbuild(ARCH).init_shape())
    assert _shapes(got) == want
    cfg = tbuild(ARCH, device="meta").cfg
    assert cfg.padded_vocab() == 51968 and cfg.param_count() == 103441408


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "full"])
def test_cache_and_pool_shapes_match_reference(ring):
    tm = tbuild(ARCH, device="meta")
    want = jax.eval_shape(lambda: jkv.init_cache(jbuild(ARCH).cfg, 4, 448,
                                                 ring=ring))
    assert _shapes(tm.init_cache(4, 448, ring=ring)) == jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)), want)
    pool = tkv.init_paged_pool(tm.cfg, 32, 448, cross_len=1500,
                               device="meta")
    jpool = jax.eval_shape(lambda: jkv.init_paged_pool(
        jbuild(ARCH).cfg, 32, 448, cross_len=1500))
    assert _shapes(pool) == jax.tree.map(
        lambda x: (tuple(x.shape), str(x.dtype)), jpool)
    assert pool["cross_table"].shape == (32, 12)      # 1,500 in pages of 128
    assert pool["kv"]["k"].shape[1] == 1 + 32 * (4 + 12)


# ---------------------------------------------------------------------------
# The encoder, the cross routes, prefill and lockstep decode.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_encode_matches_reference(weights, use_kernels):
    jm, jp, tm, tp = weights
    jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
    cfg = dataclasses.replace(tm.cfg, use_kernels=use_kernels)
    fr = _frames(2, 11, cfg.d_model)
    want = jtr.encode(jp, jnp.asarray(fr), cfg=jcfg)
    _close(ttr.encode(tp, _t(fr), cfg=cfg), want)


def test_cross_attention_paged_matches_reference(weights):
    jm, jp, tm, tp = weights
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    ps, n_pages, hkv, hd = 4, 9, cfg.n_kv_heads, cfg.resolved_head_dim()
    kp, vp = (rng.standard_normal((n_pages, ps, hkv, hd)).astype(np.float32)
              for _ in "kv")
    # shuffled pages, slot 1 free (length 0: exact zeros), ragged lengths
    table = np.array([[3, 7, 1], [0, 0, 0], [8, 2, 0]], np.int32)
    lengths = np.array([11, 0, 5], np.int32)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    p = jax.tree.map(lambda a: a[0], jp["blocks"]["xattn"])
    want = jattn.cross_attention_paged(
        p, jnp.asarray(x), cfg=jm.cfg, kv={"k": jnp.asarray(kp),
                                           "v": jnp.asarray(vp)},
        cross_table=jnp.asarray(table), cross_lengths=jnp.asarray(lengths))
    got = tattn.cross_attention_paged(
        ttr.layer(tp["blocks"]["xattn"], 0), _t(x), cfg=cfg,
        kv={"k": _t(kp), "v": _t(vp)}, cross_table=_t(table),
        cross_lengths=_t(lengths))
    _close(got, want)
    wo_b = tlayers.dense(ttr.layer(tp["blocks"]["xattn"]["wo"], 0),
                         torch.zeros((1, 1, cfg.d_model)))
    assert torch.equal(got[1], wo_b[0])          # the free slot read zeros


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_prefill_with_encoder_and_lockstep_decode_match_reference(
        weights, use_kernels):
    jm, jp, tm, tp = weights
    jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
    cfg = dataclasses.replace(tm.cfg, use_kernels=use_kernels)
    fr, toks = _frames(2, 9, cfg.d_model, 1), _tokens(2, 7, 2)
    lg_j, c_j = jeng.prefill(jp, jnp.asarray(toks), cfg=jcfg, max_len=24,
                             frames=jnp.asarray(fr))
    lg_t, c_t = teng.prefill(tp, _t(toks), cfg=cfg, max_len=24,
                             frames=_t(fr))
    _close(lg_t, lg_j)
    _close(c_t, c_j)
    # the cross half is exactly T_enc long
    assert c_t["cross"]["k"].shape[2] == 9
    tok_j = jnp.argmax(lg_j[:, :cfg.vocab], -1)
    tok_t = lg_t[:, :cfg.vocab].argmax(-1)
    for i in range(8):
        assert tok_t.tolist() == np.asarray(tok_j).tolist()
        lg_j, c_j = jeng.decode_step(jp, c_j, tok_j, 7 + i, cfg=jcfg)
        lg_t, c_t = teng.decode_step(tp, c_t, tok_t, 7 + i, cfg=cfg)
        _close(lg_t, lg_j)
        tok_j = jnp.argmax(lg_j[:, :cfg.vocab], -1)
        tok_t = lg_t[:, :cfg.vocab].argmax(-1)
    _close(c_t, c_j)


def test_facade_generate_takes_frames(weights):
    jm, jp, tm, tp = weights
    fr, toks = _frames(2, 6, tm.cfg.d_model, 4), _tokens(2, 5, 4)
    want, _ = jeng.generate_timed(jp, jnp.asarray(toks), cfg=jm.cfg,
                                  steps=5, key=jax.random.PRNGKey(7),
                                  temperature=0.0, max_len=16,
                                  frames=jnp.asarray(fr))
    got = tm.generate(tp, _t(toks).long(), steps=5, temperature=0.0,
                      max_len=16, frames=_t(fr))
    assert got.tolist() == np.asarray(want).tolist()


def test_a_decoder_block_without_an_encoder_raises(weights):
    _, _, tm, tp = weights
    x = torch.zeros((1, 3, tm.cfg.d_model))
    cos, sin = ttr._cos_sin(tm.cfg, torch.arange(3))
    with pytest.raises(ValueError, match="encdec decoder block needs"):
        ttr.block_apply(ttr.layer(tp["blocks"], 0), x, cos, sin,
                        cfg=tm.cfg)


# ---------------------------------------------------------------------------
# The paged pool's cross pages.
# ---------------------------------------------------------------------------
def test_adopt_and_free_match_reference_bit_for_bit(weights):
    jm, jp, tm, tp = weights
    ps, slots = 4, 3
    fr, toks = _frames(1, 10, tm.cfg.d_model, 6), _tokens(1, 8, 6)
    _, c_j = jeng.prefill(jp, jnp.asarray(toks), cfg=jm.cfg, max_len=8,
                          frames=jnp.asarray(fr))
    cache = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), c_j)
    jpool = jkv.init_paged_pool(jm.cfg, slots, 16, page_size=ps,
                                cross_len=12)
    pool = tkv.init_paged_pool(tm.cfg, slots, 16, page_size=ps,
                               cross_len=12, device="cpu")
    row = np.array([5, 2, 0, 0], np.int32)
    xrow = np.array([9, 3, 11], np.int32)     # 10 frames: a ragged tail
    jpool = jkv.adopt_slot_encdec(jpool, c_j, 1, 8, jnp.asarray(row), 10,
                                  jnp.asarray(xrow))
    tkv.adopt_slot_encdec(pool, cache, 1, 8, _t(row), 10, _t(xrow))

    def same(a, b):
        # page 0 is the trash page: not compared
        for n in ("k", "v"):
            assert np.array_equal(a["kv"][n].numpy()[:, 1:],
                                  np.asarray(b["kv"][n])[:, 1:])
        for n in ("page_table", "lengths", "cross_table", "cross_lengths"):
            assert np.array_equal(a[n].numpy(), np.asarray(b[n])), n

    same(pool, jpool)
    assert not pool["kv"]["k"][:, 11, 2:].any()     # zero-padded tail page
    jpool = jkv.free_slot_paged(jpool, 1)
    tkv.free_slot_paged(pool, 1)
    same(pool, jpool)
    assert not pool["cross_table"].any() and not pool["cross_lengths"].any()


# ---------------------------------------------------------------------------
# Serving through the paged engine.
# ---------------------------------------------------------------------------
def _requests(vocab, d, plens=(3, 5, 7, 4), frames=None, seed=11):
    rng = np.random.default_rng(seed)
    frames = frames or (N_FRAMES,) * len(plens)
    return [Request(
        rid=i, prompt=tuple(int(t) for t in rng.integers(0, vocab, n)),
        max_new_tokens=4 + i,
        frames=rng.standard_normal((frames[i], d)).astype(np.float32))
        for i, n in enumerate(plens)]


def _copy(reqs):
    return [dataclasses.replace(r) for r in reqs]


def _tokens_of(comps):
    return [list(c.tokens) for c in sorted(comps, key=lambda c: c.rid)]


def _lockstep(jm, jp, reqs, use_kernels=False):
    jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
    out = []
    for r in reqs:
        toks, _ = jeng.generate_timed(
            jp, jnp.asarray(r.prompt, jnp.int32)[None], cfg=jcfg,
            steps=r.max_new_tokens - 1, key=jax.random.PRNGKey(7),
            temperature=0.0, max_len=MAX_LEN,
            frames=jnp.asarray(r.frames)[None])
        out.append([int(t) for t in np.asarray(toks)[0]])
    return out


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["encdec-jnp", "encdec-kernels"])
def test_greedy_tokens_match_jax_lockstep(weights, use_kernels):
    jm, jp, tm, tp = weights
    tm = Model(dataclasses.replace(tm.cfg, use_kernels=use_kernels), "cpu")
    reqs = _requests(tm.cfg.vocab, tm.cfg.d_model)
    # 4 requests over 2 slots: slot reuse, ragged ages, bucketed prefill
    eng = tm.serving_engine(tp, slots=2, max_len=MAX_LEN, temperature=0.0,
                            seed=3)
    assert eng.paged and eng.buckets is not None
    got = _tokens_of(eng.run(_copy(reqs)))
    assert got == _lockstep(jm, jp, reqs, use_kernels)
    st = eng.stats
    assert st["admitted"] == 4 > eng.n_slots
    assert st["encode_frames"] == 4 * N_FRAMES
    assert st["prefill_tokens"] == sum(len(r.prompt) for r in reqs) \
        + 4 * N_FRAMES
    assert eng.allocator.free_pages == eng.allocator.usable_pages


def test_chunked_encoding_matches_the_jax_engine(weights):
    jm, jp, tm, tp = weights
    reqs = _requests(tm.cfg.vocab, tm.cfg.d_model, frames=(8, 5, 7, 3))
    kw = dict(slots=2, max_len=MAX_LEN, temperature=0.0, seed=3,
              max_cross_len=8, enc_chunk=3)
    want = _tokens_of(jsched.ContinuousBatchingEngine(
        jm, jp, **kw).run(_copy(reqs)))
    eng = ContinuousBatchingEngine(tm, tp, **kw)
    assert eng.cross_pages_per_slot == 1
    assert _tokens_of(eng.run(_copy(reqs))) == want
    # each window is encoded alone from position 0: not the whole encode
    whole = ContinuousBatchingEngine(tm, tp, **dict(kw, enc_chunk=None))
    assert _tokens_of(whole.run(_copy(reqs))) == _lockstep(jm, jp, reqs)
    assert eng.stats["encode_frames"] == 23 == whole.stats["encode_frames"]


def _check_pages(eng):
    """Every arena page is free or held, its refcount the number of rows
    (self and cross) that hold it."""
    alloc, held = eng.allocator, {}
    for row in eng.slot_pages + eng.slot_cross_pages:
        for p in row:
            held[p] = held.get(p, 0) + 1
    for p in range(1, alloc.n_pages):
        assert alloc.refcount(p) == held.get(p, 0), f"page {p}"
    assert alloc.free_pages == alloc.usable_pages - len(held)


def test_encdec_engine_walk(weights):
    """Open-loop traffic over a tight arena (7 usable pages of 8): parked
    encodes, page growth and preemption keep the page identities after
    every step, and the pool drains."""
    _, _, tm, tp = weights
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=32, page_size=8,
                                   pages=8, temperature=0.0, seed=4,
                                   max_cross_len=8, enc_chunk=3)
    rid = 0
    for seed in range(3):
        rng = np.random.default_rng(seed)
        left, steps = 4, 0
        while left or eng.pending or eng.active_slots() or eng._encoding:
            n_sub = (min(left, eng.n_slots) if steps == 0
                     else int(min(left, rng.integers(0, 2))))
            for _ in range(n_sub):
                eng.submit(Request(
                    rid=rid, prompt=tuple(int(t) for t in rng.integers(
                        0, tm.cfg.vocab, int(rng.integers(6, 15)))),
                    max_new_tokens=int(rng.integers(10, 19)),
                    frames=rng.standard_normal((int(rng.integers(3, 9)),
                                                tm.cfg.d_model)).astype(
                        np.float32)))
                rid, left = rid + 1, left - 1
            eng.step()
            _check_pages(eng)
            steps += 1
            assert steps < 600
        assert eng.allocator.free_pages == eng.allocator.usable_pages
    assert eng.stats["preempted"] > 0 and eng.stats["admitted"] > 12
    assert not eng.pool["cross_lengths"].any()
    with pytest.raises(ValueError, match="double free"):
        eng.allocator.free([1])


def test_encdec_refusals(weights):
    _, _, tm, tp = weights
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                 paged=False)
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   max_cross_len=8)
    with pytest.raises(ValueError, match="need frames"):
        eng.submit(Request(rid=0, prompt=(1, 2)))
    with pytest.raises(ValueError, match="9 encoder frames exceed "
                                         "max_cross_len 8"):
        eng.submit(Request(rid=1, prompt=(1, 2),
                           frames=np.zeros((9, tm.cfg.d_model), np.float32)))
    dense = tbuild("qwen2.5-14b", reduced=True, device="cpu")
    with pytest.raises(ValueError, match="enc_chunk only applies"):
        ContinuousBatchingEngine(dense, None, slots=2, max_len=MAX_LEN,
                                 enc_chunk=4)


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


@pytest.mark.parametrize("enc_chunk", [None, 4], ids=["whole", "chunked"])
def test_replayed_step_matches_the_eager_step_and_keeps_the_tables(
        weights, monkeypatch, enc_chunk):
    jm, jp, tm, tp = weights
    graphs = []

    def graph_for(device, generator=None):
        graphs.append(ReplayingGraph())
        return graphs[-1]

    monkeypatch.setattr(scheduler, "graph_for", graph_for)
    reqs = _requests(tm.cfg.vocab, tm.cfg.d_model, plens=(4, 9, 2, 6, 5),
                     frames=(6, 3, 8, 5, 6))
    kw = dict(slots=3, max_len=MAX_LEN, temperature=0.0, max_cross_len=8,
              enc_chunk=enc_chunk)
    eng = ContinuousBatchingEngine(tm, tp, **kw)
    want = fused._ptrs(eng.step_buffers())
    assert {"/pool/cross_table", "/pool/cross_lengths", "/pool/page_table",
            "/pool/lengths", "/tokens", "/active"} <= want.keys()
    for r in _copy(reqs):
        eng.submit(r)
    eng._run_start = 0.0
    bursts = 0
    while eng.pending or eng.active_slots() or eng._encoding:
        bursts += eng.step()
        assert fused._ptrs(eng.step_buffers()) == want
    eng.completions.sort(key=lambda c: c.rid)
    got = _tokens_of(eng.completions)
    eager = ContinuousBatchingEngine(tm, tp, fused=False, **kw)
    assert got == _tokens_of(eager.run(_copy(reqs)))
    if enc_chunk is None:
        assert got == _lockstep(jm, jp, reqs)
    st = eng.stats
    assert graphs[0].warm_ups == 2 and st["admitted"] > eng.n_slots
    assert graphs[0].replays == eng._fused.replays == st["steps"] > bursts


def test_rebinding_the_cross_table_stops_the_replay(weights, monkeypatch):
    _, _, tm, tp = weights
    monkeypatch.setattr(scheduler, "graph_for",
                        lambda device, generator=None: ReplayingGraph())
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   temperature=0.0)
    eng.pool["cross_table"] = eng.pool["cross_table"].clone()
    with pytest.raises(RuntimeError, match="/pool/cross_table"):
        eng.run(_copy(_requests(tm.cfg.vocab, tm.cfg.d_model)[:2]))
