"""Multi-head latent attention (deepseek-v2-lite-16b, family moe) against the
JAX package on the CPU, with the same weights carried across through numpy
(``repro_torch.convert.params_from_jax``).

Reduced deepseek (kv_lora 32, nope 16 + rope 8 = D 24, v 16), float32.
``models.attention.mla_attention`` on its four paths (no cache, prefill
into a cache, ragged strip decode, ragged paged decode), kernels off and
on (the reference's Pallas kernels in interpret mode), within ``ATOL``
1e-5 + ``RTOL`` 1e-4, its written cache rows too; the model's prefill and
decode logits within 1e-4 (as test_torch_moe); the latent pools after a
prefill and 5 steps against the reference's on the strip and paged pools;
greedy tokens through both pools, kernels off and on, ``==`` the JAX
lockstep (the deepseek cells of tests/test_family_parity.py), and through
the replay path; the shapes and bytes of the full-width caches, pools and
parameters on the ``meta`` device ``==`` the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import transformer as jtf
from repro.serving import engine as jeng
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model, transformer
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.serving import engine as teng
from repro_torch.serving import fused, kv_cache, scheduler
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "deepseek-v2-lite-16b"
ATOL, RTOL = 1e-5, 1e-4         # one layer, float32
LOGIT_ATOL = 1e-4               # the model's logits, as test_torch_moe
MAX_LEN = 48


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    jm = jbuild(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    assert dataclasses.asdict(jm.cfg.mla) == dataclasses.asdict(cfg.mla)
    return jm, jp, cfg, params_from_jax(_np_tree(jp), cfg, device="cpu")


def _kernels(cfg, use_kernels):
    return dataclasses.replace(cfg, use_kernels=use_kernels)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_converted_tree_has_the_reference_layout(weights):
    _, jp, cfg, tp = weights
    attn = tp["blocks"]["attn"]
    assert set(attn) == {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}
    # q: 4 heads of nope 16 + rope 8; the latent 32 + the shared rope key 8
    assert tuple(attn["wq"]["w"].shape) == (2, 64, 4 * 24)
    assert tuple(attn["wkv_a"]["w"].shape) == (2, 64, 32 + 8)
    assert tuple(attn["wkv_b"]["w"].shape) == (2, 32, 4 * (16 + 16))
    assert tuple(attn["wo"]["w"].shape) == (2, 4 * 16, 64)
    own = transformer.init_lm(cfg, device="cpu", dtype=torch.bfloat16)
    assert jax.tree.map(np.shape, jp) == _shapes(own)
    bad = _np_tree(jp)
    del bad["blocks"]["attn"]["kv_norm"]
    with pytest.raises(ValueError, match="mla attn keys"):
        params_from_jax(bad, cfg, device="cpu")


# ---------------------------------------------------------------------------
# The layer on its four paths.
# ---------------------------------------------------------------------------
B, S, T = 3, 5, 16              # batch, prompt, cache positions
PS, PAGES = 4, 14               # the paged case: 4 pages a slot
LENGTHS = np.array([0, 5, 15], np.int32)     # the ragged slots' positions


def _layer_inputs(cfg, path, seed=3):
    """(x, positions, cache, kw) as numpy, the same for both sides."""
    rng = np.random.default_rng(seed)
    m = cfg.mla

    def leaves(*lead):
        return {"c": rng.standard_normal((*lead, m.kv_lora_rank)),
                "kr": rng.standard_normal((*lead, m.qk_rope_head_dim))}

    s = 1 if path in ("strip", "paged") else S
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    if path == "none":
        return x, np.arange(S), None, {}
    if path == "prefill":
        return x, np.arange(S) + 3, leaves(B, T), {"cache_pos": 3}
    kw = {"cache_positions": LENGTHS}
    if path == "strip":
        return x, LENGTHS, leaves(B, T), kw
    table = rng.permutation(np.arange(1, PAGES))[:B * 4].reshape(B, 4)
    return x, LENGTHS, leaves(PAGES, PS), dict(kw,
                                                page_table=table.astype(
                                                    np.int32))


def _as(tree, fn):
    return None if tree is None else {k: fn(np.asarray(v, np.float32))
                                      for k, v in tree.items()}


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("path", ["none", "prefill", "strip", "paged"])
def test_mla_attention_matches_reference(weights, path, use_kernels):
    jm, jp, cfg, tp = weights
    jcfg, tcfg = _kernels(jm.cfg, use_kernels), _kernels(cfg, use_kernels)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tl = transformer.layer(tp["blocks"]["attn"], 0)
    x, pos, cache, kw = _layer_inputs(cfg, path)
    ragged = "cache_positions" in kw
    if ragged:
        jcs = jeng._cos_sin_at(jcfg, jnp.asarray(pos), B)
        tcs = teng._cos_sin_at(tcfg, torch.from_numpy(pos), B)
    else:
        jcs = jtf._cos_sin(jcfg, jnp.asarray(pos))
        tcs = transformer._cos_sin(tcfg, torch.from_numpy(pos))
    jkw = {k: (v if isinstance(v, int) else jnp.asarray(v))
           for k, v in kw.items()}
    tkw = {k: (v if isinstance(v, int) else torch.from_numpy(v))
           for k, v in kw.items()}
    jout, jcache = jattn.mla_attention(
        jl, jnp.asarray(x), *jcs, cfg=jcfg, cache=_as(cache, jnp.asarray),
        **jkw)
    tcache = _as(cache, torch.from_numpy)
    tout, back = tattn.mla_attention(
        tl, torch.from_numpy(x), *tcs, cfg=tcfg, cache=tcache, **tkw)
    _close(tout, jout)
    assert back is tcache                  # written in place
    if cache is not None:
        for name in ("c", "kr"):
            _close(tcache[name], jcache[name])
            assert not np.array_equal(tcache[name].numpy(), cache[name])


def test_mla_attention_scale_and_dims(weights):
    """The scores run at (nd + rd) ** -0.5 over keys of nd + rd columns and
    values of vd: D 24, Dv 16 reach the core."""
    _, _, cfg, tp = weights
    seen = {}
    real = tattn.attention_core

    def spy(q, k, v, **kw):
        seen.update(d=q.shape[-1], dk=k.shape[-1], dv=v.shape[-1],
                    scale=kw["scale"])
        return real(q, k, v, **kw)

    tl = transformer.layer(tp["blocks"]["attn"], 0)
    x, pos, _, _ = _layer_inputs(cfg, "none")
    cos, sin = transformer._cos_sin(cfg, torch.from_numpy(pos))
    old, tattn.attention_core = tattn.attention_core, spy
    try:
        out, _ = tattn.mla_attention(tl, torch.from_numpy(x), cos, sin,
                                     cfg=cfg)
    finally:
        tattn.attention_core = old
    assert seen == dict(d=24, dk=24, dv=16, scale=24 ** -0.5)
    assert tuple(out.shape) == (B, S, cfg.d_model)


# ---------------------------------------------------------------------------
# The model, the pools and the engine.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_prefill_and_decode_logits_match_reference(weights, use_kernels):
    jm, jp, cfg, tp = weights
    jcfg = _kernels(jm.cfg, use_kernels)
    tm = Model(_kernels(cfg, use_kernels), "cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 13)).astype(
        np.int32)
    jl, jc = jeng.prefill(jp, jnp.asarray(toks[:, :9]), cfg=jcfg,
                          max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :9]).long(),
                        max_len=MAX_LEN)
    _close(tl, jl, LOGIT_ATOL, 0)
    for t in range(9, 13):
        jl, jc = jeng.decode_step(jp, jc, jnp.asarray(toks[:, t]), t,
                                  cfg=jcfg)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]).long(),
                                t)
        _close(tl, jl, LOGIT_ATOL, 0)
    assert set(tc) == {"c", "kr"}                 # the latent cache
    for name in ("c", "kr"):
        _close(tc[name], jc[name])


def test_no_cache_forward_takes_the_flash_route(weights, monkeypatch):
    """With kernels on, the no-cache forward's attention goes through the
    flash op at D 24, Dv 16 (on the card: kernel 12 at Dv != D)."""
    from repro_torch.kernels import ops

    _, _, cfg, tp = weights
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (1, 11)))
    h = Model(_kernels(cfg, True), "cpu").forward(tp, toks)
    assert calls == [(24, 24, 16)] * cfg.n_layers
    want = Model(cfg, "cpu").forward(tp, toks)
    torch.testing.assert_close(h, want, atol=1e-5, rtol=1e-4)


PROMPTS = ((3, 7), (5, 9))      # (slot, prompt length) admitted
STEPS = 5


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_latent_pool_after_prefill_and_steps_matches_reference(weights,
                                                               paged):
    jm, jp, cfg, tp = weights
    rng = np.random.default_rng(6)
    slots = 2
    if paged:
        jpool = jkv.init_paged_pool(jm.cfg, slots, MAX_LEN, page_size=8)
        tpool = kv_cache.init_paged_pool(cfg, slots, MAX_LEN, page_size=8,
                                         device="cpu")
        rows = rng.permutation(np.arange(1, tpool["kv"]["c"].shape[1]))
        rows = rows[:slots * 6].reshape(slots, 6).astype(np.int32)
    else:
        jpool = jkv.init_slot_pool(jm.cfg, slots, MAX_LEN)
        tpool = kv_cache.init_slot_pool(cfg, slots, MAX_LEN, device="cpu")
    for slot, (_, n) in enumerate(PROMPTS):
        prompt = rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
        _, jc = jeng.prefill(jp, jnp.asarray(prompt), cfg=jm.cfg,
                             max_len=MAX_LEN if not paged else 8 * 2)
        _, tc = teng.prefill(tp, torch.from_numpy(prompt).long(), cfg=cfg,
                             max_len=MAX_LEN if not paged else 8 * 2)
        if paged:
            jpool = jkv.adopt_slot_paged(jpool, jc, slot, n,
                                         jnp.asarray(rows[slot]))
            kv_cache.adopt_slot_paged(tpool, tc, slot, n,
                                      torch.from_numpy(rows[slot]))
        else:
            jpool = jkv.adopt_slot(jpool, jc, slot, n)
            kv_cache.adopt_slot(tpool, tc, slot, n)
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, slots).astype(np.int32)
        jl, jpool = jeng.decode_step_ragged(jp, jpool, jnp.asarray(toks),
                                            cfg=jm.cfg)
        tl, _ = teng.decode_step_ragged(tp, tpool, torch.from_numpy(toks),
                                        cfg=cfg)
        _close(tl, jl, LOGIT_ATOL, 0)
    assert set(tpool["kv"]) == {"c", "kr"}
    for name in ("c", "kr"):
        got, want = tpool["kv"][name], jpool["kv"][name]
        if paged:                 # page 0 is the trash page: dead writes
            got, want = got[:, 1:], want[:, 1:]
        _close(got, want)
    np.testing.assert_array_equal(tpool["lengths"].numpy(),
                                  np.asarray(jpool["lengths"]))
    assert tpool["lengths"].tolist() == [n + STEPS for _, n in PROMPTS]


def _requests(vocab, seed=11):
    """The deepseek cells of tests/test_family_parity.py: four requests
    over two slots."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, vocab, n)), max_new_tokens=4 + i)
        for i, n in enumerate((3, 5, 7, 4))]


@pytest.fixture(scope="module")
def jax_lockstep(weights):
    jm, jp, _, _ = weights
    memo = {}

    def run(use_kernels: bool):
        if use_kernels not in memo:
            jcfg = _kernels(jm.cfg, use_kernels)
            memo[use_kernels] = []
            for r in _requests(jcfg.vocab):
                toks, _ = jeng.generate_timed(
                    jp, jnp.asarray(r.prompt, jnp.int32)[None], cfg=jcfg,
                    steps=r.max_new_tokens - 1, key=jax.random.PRNGKey(7),
                    temperature=0.0, max_len=MAX_LEN)
                memo[use_kernels].append([int(t) for t in
                                          np.asarray(toks)[0]])
        return memo[use_kernels]

    return run


def _tokens(comps):
    return [list(c.tokens) for c in sorted(comps, key=lambda c: c.rid)]


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_greedy_tokens_match_jax_lockstep(weights, jax_lockstep, paged,
                                          use_kernels):
    _, _, cfg, tp = weights
    tm = Model(_kernels(cfg, use_kernels), "cpu")
    eng = tm.serving_engine(tp, slots=2, max_len=MAX_LEN, page_size=8,
                            paged=paged, temperature=0.0, seed=3)
    assert eng.buckets is None and eng.moe_impl == "dispatch"
    got = _tokens(eng.run(_requests(cfg.vocab)))
    assert got == jax_lockstep(use_kernels)
    st = eng.throughput()
    assert st["paged"] is paged and st["admitted"] == 4
    assert eng._prefill_shapes == {3, 5, 7, 4}


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
def test_replayed_step_matches_jax_lockstep(weights, jax_lockstep,
                                            monkeypatch, paged):
    _, _, cfg, tp = weights
    graphs = []

    def graph_for(device, generator=None):
        graphs.append(ReplayingGraph())
        return graphs[-1]

    monkeypatch.setattr(scheduler, "graph_for", graph_for)
    eng = ContinuousBatchingEngine(Model(cfg, "cpu"), tp, slots=2,
                                   max_len=MAX_LEN, page_size=8,
                                   paged=paged, temperature=0.0)
    want = fused._ptrs(eng.step_buffers())
    assert {"/pool/kv/c", "/pool/kv/kr", "/pool/lengths", "/tokens",
            "/active", "/params/blocks/attn/wkv_b/w"} <= want.keys()
    for r in _requests(cfg.vocab):
        eng.submit(r)
    eng._run_start = 0.0
    while eng.pending or eng.active_slots():
        eng.step()
        assert fused._ptrs(eng.step_buffers()) == want
    eng.completions.sort(key=lambda c: c.rid)
    assert _tokens(eng.completions) == jax_lockstep(False)
    assert graphs[0].replays == eng.stats["steps"] > 0


# ---------------------------------------------------------------------------
# Full width on the meta device.
# ---------------------------------------------------------------------------
FULL_SLOTS, FULL_LEN, FULL_PS = 16, 4160, 128


def _jbytes(tree):
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))


def test_full_width_parameters_match_reference():
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    assert cfg.param_count() == jcfg.param_count()
    assert round(cfg.param_count() / 1e9, 2) == 16.21
    got = tbuild(ARCH, device="meta").init_shape()
    want = jax.eval_shape(lambda: jbuild(ARCH).init(jax.random.PRNGKey(0)))
    assert _shapes(got) == jax.tree.map(lambda s: tuple(s.shape), want)
    assert tuple(got["blocks"]["attn"]["wkv_b"]["w"].shape) == (
        27, 512, 16 * 256)


@pytest.mark.parametrize("pool", ["cache", "strip", "paged"])
def test_full_width_latent_caches_match_reference(pool):
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    if pool == "cache":
        got = kv_cache.init_cache(cfg, FULL_SLOTS, FULL_LEN, device="meta")
        want = jax.eval_shape(lambda: jkv.init_cache(jcfg, FULL_SLOTS,
                                                     FULL_LEN))
        assert kv_cache.cache_bytes(cfg, FULL_SLOTS, FULL_LEN) == \
            jkv.cache_bytes(jcfg, FULL_SLOTS, FULL_LEN)
        assert tuple(got["c"].shape) == (27, 16, 4160, 512)
    elif pool == "strip":
        got = kv_cache.init_slot_pool(cfg, FULL_SLOTS, FULL_LEN,
                                      device="meta")
        want = jax.eval_shape(lambda: jkv.init_slot_pool(
            jcfg, FULL_SLOTS, FULL_LEN))
        assert kv_cache.slot_pool_bytes(cfg, FULL_SLOTS, FULL_LEN) == \
            jkv.slot_pool_bytes(jcfg, FULL_SLOTS, FULL_LEN)
    else:
        got = kv_cache.init_paged_pool(cfg, FULL_SLOTS, FULL_LEN,
                                       page_size=FULL_PS, device="meta")
        want = jax.eval_shape(lambda: jkv.init_paged_pool(
            jcfg, FULL_SLOTS, FULL_LEN, page_size=FULL_PS))
        assert kv_cache.paged_pool_bytes(
            cfg, FULL_SLOTS, FULL_LEN, page_size=FULL_PS) == \
            jkv.paged_pool_bytes(jcfg, FULL_SLOTS, FULL_LEN,
                                 page_size=FULL_PS)
        # 1 trash page + 16 slots x 33 pages of 128
        assert tuple(got["kv"]["kr"].shape) == (27, 529, 128, 64)
    assert _shapes(got) == jax.tree.map(lambda s: tuple(s.shape), want)
    assert _nbytes(got) == _jbytes(want)


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def test_cache_bytes_mla_smaller_than_dense_equiv():
    """The port's twin of test_serving.py's check of MLA's point: the
    latent cache is much smaller than full KV (27 layers x (512 + 64)
    values x 2 bytes = 31,104 bytes a token)."""
    cfg = get_config(ARCH)
    mla_bytes = kv_cache.cache_bytes(cfg, 8, 1024)
    dense_bytes = kv_cache.cache_bytes(dataclasses.replace(cfg, mla=None),
                                       8, 1024)
    assert mla_bytes < dense_bytes / 5
    assert mla_bytes == 8 * 1024 * 27 * (512 + 64) * 2
