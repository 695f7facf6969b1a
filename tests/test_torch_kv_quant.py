"""The port's int8 KV pages and host-RAM swap tier on the CPU, held against
the reference's (``tests/test_kv_quant.py``'s cases, where they have a
meaning in the port) with the same inputs:

  * ``quantize_symmetric`` / ``dequantize_pages`` / ``_copy_pages_quant``
    and the int8 adoption: codes and scales bit-equal to the JAX
    package's, also on the last page of a prompt whose bucket is not a
    whole number of pages (the reference allocates whole pages and
    leaves zeros past the bucket; the port zero-fills its ragged page:
    the same rows, so the same absmax);
  * the int8 row write of the ragged paged decode, through both
    packages' ``attention`` with weights that pass ``x`` through exactly:
    codes and scales bit-equal;
  * the fused-dequant paged decode op against the reference's plain and
    Pallas (interpret) paths, 2e-5;
  * the pool's leaves, dtypes and bytes at both granularities (equal to
    the reference's), the >= 1.8x page tokens at one budget, the
    refusals;
  * demotion and promotion: the restored slot bit-exact; greedy tokens
    and the swap counters equal the JAX engine's on reduced qwen2.5-14b
    (float32: ``==``; bfloat16: ``==`` wherever the reference's top-2
    margin exceeds twice the two packages' logit difference); a tiny
    budget falls back to preemption; a shared page refuses demotion and
    the prefix cache pins pages to the preemption fallback;
  * int8 engine tokens against the JAX int8 engine, a prefix hit over
    int8 pages, and the replay path (a stand-in graph) against the eager
    step through demotions and promotions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.serving import engine as jeng
from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.serving import engine as teng
from repro_torch.serving import fused, kv_cache, scheduler
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "qwen2.5-14b"
GRANS = ("page", "page_head")
SWAP_COUNTERS = ("demoted", "prefetched", "preempted", "admitted",
                 "peak_pages", "swap_bytes_used")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits_equal(jtree: dict, ttree: dict) -> None:
    assert set(jtree) == set(ttree)
    for n in jtree:
        a, b = np.asarray(jtree[n]), _np(ttree[n])
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(a, b, err_msg=n)


def _weights(**overrides):
    jm = jbuild(ARCH, reduced=True, **overrides)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(ARCH, reduced=True, device="cpu", **overrides)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                       device="cpu")


@pytest.fixture(scope="module")
def dense():
    return _weights()


@pytest.fixture(scope="module")
def dense_bf16():
    return _weights(head_dim=32, dtype="bfloat16")


# ---------------------------------------------------------------------------
# quantize / dequantize against the reference, bit for bit.
# ---------------------------------------------------------------------------
def _rows(seed, shape, scale=4.0):
    """Seeded rows on a grid of half code steps: the first element of
    every row of the last axis is the absmax, 127 steps of 1/8 (so every
    group's scale is exactly 1/8 at either granularity), and the rest are
    whole or half steps, so ``x / scale`` lands on ties that round half to
    even."""
    rng = np.random.default_rng(seed)
    steps = np.clip(np.round(rng.standard_normal(shape) * 8 * scale) / 2,
                    -126.5, 126.5)
    x = (steps / 8).astype(np.float32)
    x[..., 0] = np.float32(127 / 8)
    return x


@pytest.mark.parametrize("granularity", GRANS)
@pytest.mark.parametrize("seed", range(3))
def test_quantize_symmetric_equals_the_reference(granularity, seed):
    x = _rows(seed, (3, 8, 2, 16))
    x[1] = 0.0                                 # an all-zero group: scale 1
    axes = (1, 2, 3) if granularity == "page" else (1, 3)
    jq, js = jkv.quantize_symmetric(jnp.asarray(x), axes)
    tq, ts = kv_cache.quantize_symmetric(_t(x), axes)
    _bits_equal({"q": jq, "s": js}, {"q": tq, "s": ts})
    assert (tq[1] == 0).all() and (ts[1] == 1.0).all()


@pytest.mark.parametrize("granularity", GRANS)
def test_error_bounded_by_half_step(granularity):
    # symmetric absmax: |x - q scale| <= scale / 2 a group
    x = _t(_rows(11, (3, 8, 2, 16)))
    axes = (2, 3) if granularity == "page" else (3,)
    q, scale = kv_cache.quantize_symmetric(x, axes)
    err = (x - q.float() * scale).abs()
    assert bool((err <= scale / 2 + 1e-6).all())


def test_page_head_tighter_than_page():
    # a per-head group can only shrink the absmax, never grow it
    x = torch.randn(4, 8, 4, 16, generator=torch.Generator().manual_seed(0))
    x = x * torch.tensor([0.1, 1.0, 10.0, 100.0])[None, None, :, None]
    errs = {}
    for gran, axes in (("page", (2, 3)), ("page_head", (3,))):
        q, s = kv_cache.quantize_symmetric(x, axes)
        errs[gran] = float((x - q.float() * s).abs().mean())
    assert errs["page_head"] < errs["page"]


@pytest.mark.parametrize("granularity", GRANS)
def test_dequantize_pages_equals_the_reference(granularity):
    ls, pages, ps, h, d = 2, 3, 4, 2, 8
    raw = _rows(5, (ls, pages, ps, h, d))
    axes = (3, 4) if granularity == "page" else (4,)
    q, scale = jkv.quantize_symmetric(jnp.asarray(raw), axes)
    sshape = (ls, pages, ps) if granularity == "page" else (ls, pages, ps, h)
    jtree = {"k": q, "v": q, "k_scale": scale.reshape(sshape),
             "v_scale": scale.reshape(sshape)}
    ttree = {n: _t(x) for n, x in jtree.items()}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jkv.dequantize_pages(jtree, jdt)
        got = kv_cache.dequantize_pages(ttree, tdt)
        assert set(got) == {"k", "v"}               # the scales dropped
        for n in ("k", "v"):
            np.testing.assert_array_equal(
                np.asarray(want[n].astype(jnp.float32)),
                got[n].float().numpy())


# ---------------------------------------------------------------------------
# Adoption into int8 arenas against the reference's.
# ---------------------------------------------------------------------------
def _int8_pools(cfg, granularity, slots=2, max_len=32, ps=8, pages=9):
    kw = dict(page_size=ps, pages=pages, page_dtype="int8",
              scale_granularity=granularity)
    return (jkv.init_paged_pool(cfg, slots, max_len, **kw),
            kv_cache.init_paged_pool(cfg, slots, max_len, device="cpu", **kw))


def _prefill_cache(cfg, t, seed):
    """A seeded batch=1 prefill cache ``{"k", "v"}: [L, 1, t, Hkv, hd]``."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 1, t, cfg.n_kv_heads, cfg.resolved_head_dim())
    return {n: rng.standard_normal(shape).astype(np.float32) * (1 + i)
            for i, n in enumerate(("k", "v"))}


@pytest.mark.parametrize("granularity", GRANS)
def test_int8_adoption_equals_the_reference(dense, granularity):
    """A 24-position cache over a row of 4 pages (3 copied, the trash page
    after), then a copy-on-write copy row that writes only the fresh
    pages: the arenas' codes and scales bit-equal to the reference's."""
    cfg = dense[2].cfg
    jpool, tpool = _int8_pools(cfg, granularity)
    cache = _prefill_cache(cfg, 24, 1)
    row = np.array([3, 1, 4, 0], np.int32)
    jpool = jkv.adopt_slot_paged(jpool, {n: jnp.asarray(x)
                                         for n, x in cache.items()},
                                 0, 21, row)
    kv_cache.adopt_slot_paged(tpool, {n: _t(x) for n, x in cache.items()},
                              0, 21, _t(row))
    cache2 = _prefill_cache(cfg, 16, 2)
    row2, copy2 = (np.array([3, 5, 0, 0], np.int32),
                   np.array([0, 5, 0, 0], np.int32))
    jpool = jkv.adopt_slot_paged(jpool, {n: jnp.asarray(x)
                                         for n, x in cache2.items()},
                                 1, 13, row2, copy2)
    kv_cache.adopt_slot_paged(tpool, {n: _t(x) for n, x in cache2.items()},
                              1, 13, _t(row2), _t(copy2))
    real = [1, 3, 4, 5]                  # the trash page holds garbage
    _bits_equal({n: x[:, real] for n, x in jpool["kv"].items()},
                {n: x[:, real] for n, x in tpool["kv"].items()})
    np.testing.assert_array_equal(np.asarray(jpool["page_table"]),
                                  tpool["page_table"].numpy())
    np.testing.assert_array_equal(np.asarray(jpool["lengths"]),
                                  tpool["lengths"].numpy())


@pytest.mark.parametrize("granularity", GRANS)
@pytest.mark.parametrize("bucket", [13, 21])
def test_last_page_absmax_equals_the_reference(dense, granularity, bucket):
    """A bucket that is not a whole number of pages: the reference
    prefills ``round_up(bucket, ps)`` positions (its rows past the bucket
    stay zero), the port prefills the bucket and zero-fills its ragged
    page.  The pad rows inside the bucket enter the absmax in both; the
    codes and scales of the last page are bit-equal."""
    cfg = dense[2].cfg
    ps = 8
    alloc = -(-bucket // ps) * ps
    cache = _prefill_cache(cfg, alloc, 3)
    for x in cache.values():
        x[:, :, bucket:] = 0.0                  # the reference's allocation
    jpool, tpool = _int8_pools(cfg, granularity)
    row = np.array([2, 6, 7, 0], np.int32)
    jpool = jkv.adopt_slot_paged(jpool, {n: jnp.asarray(x)
                                         for n, x in cache.items()},
                                 0, bucket, row)
    kv_cache.adopt_slot_paged(
        tpool, {n: _t(x[:, :, :bucket]) for n, x in cache.items()}, 0,
        bucket, _t(row))
    used = list(row[:alloc // ps])
    _bits_equal({n: x[:, used] for n, x in jpool["kv"].items()},
                {n: x[:, used] for n, x in tpool["kv"].items()})


@pytest.mark.parametrize("granularity", GRANS)
def test_engine_pools_after_a_ragged_prompt_equal_the_reference(
        dense, granularity):
    """Both engines admit a 13-token prompt in pages of 8, exact lengths
    and bucketed: the int8 codes are equal and the scales within 1e-6 of
    each other (the two packages' float32 K/V differ in their last bits,
    which moves a page's absmax by as much)."""
    jm, jp, tm, tp = dense
    for buckets in (None, "auto"):
        kw = dict(slots=2, max_len=40, page_size=8, temperature=0.0,
                  prefix_cache=False, page_dtype="int8",
                  scale_granularity=granularity, prefill_buckets=buckets)
        je = jsched.ContinuousBatchingEngine(jm, jp, **kw)
        te = ContinuousBatchingEngine(tm, tp, **kw)
        for e, req in ((je, jsched.Request), (te, Request)):
            e.submit(req(rid=0, prompt=tuple(range(3, 16)),
                         max_new_tokens=5))
            e._admit_arrived(0.0)
        for n in ("k", "v"):
            np.testing.assert_array_equal(np.asarray(je.pool["kv"][n]),
                                          te.pool["kv"][n].numpy())
            np.testing.assert_allclose(
                np.asarray(je.pool["kv"][n + "_scale"]),
                te.pool["kv"][n + "_scale"].numpy(), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The int8 row write of the ragged paged decode.
# ---------------------------------------------------------------------------
def _pass_through(cfg, seed):
    """Attention weights whose K and V are ``x``'s first columns exactly
    (one-hot ``wk`` / ``wv``, zero biases), random ``wq`` / ``wo``."""
    rng = np.random.default_rng(seed)
    d, kvd = cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim()
    qd = cfg.n_heads * cfg.resolved_head_dim()
    eye = np.eye(d, kvd, dtype=np.float32)

    def lin(w):
        return {"w": w, "b": np.zeros(w.shape[1], np.float32)}

    return {"wq": lin(rng.standard_normal((d, qd)).astype(np.float32)),
            "wk": lin(eye), "wv": lin(eye * np.float32(0.5)),
            "wo": {"w": rng.standard_normal((qd, d)).astype(np.float32)}}


@pytest.mark.parametrize("granularity", GRANS)
def test_int8_row_write_equals_the_reference(dense, granularity):
    """Three slots write their token's row at their own length (one slot
    free, its row on the trash page) through both packages' attention,
    RoPE off (cos 1, sin 0): every code and scale bit-equal."""
    cfg = dense[2].cfg
    p = _pass_through(cfg, 0)
    jcfg = dense[0].cfg
    jpool, tpool = _int8_pools(cfg, granularity, slots=3, pages=10)
    jl = jax.tree.map(lambda x: x[0], jpool["kv"])
    tl = {n: x[0] for n, x in tpool["kv"].items()}
    table = np.array([[1, 2, 0, 0], [3, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([9, 5, 0], np.int32)
    x = _rows(7, (3, 1, cfg.d_model))
    hd = cfg.resolved_head_dim()
    cos, sin = np.ones((3, 1, hd // 2), np.float32), np.zeros(
        (3, 1, hd // 2), np.float32)
    _, jc = jattn.attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(cos),
        jnp.asarray(sin), cfg=jcfg, cache=jl,
        cache_positions=jnp.asarray(lengths), page_table=jnp.asarray(table))
    tattn.attention({k: {n: _t(w) for n, w in v.items()}
                     for k, v in p.items()}, _t(x), _t(cos), _t(sin),
                    cfg=cfg, cache=tl, cache_positions=_t(lengths),
                    page_table=_t(table))
    _bits_equal({n: v[1:] for n, v in jc.items()},
                {n: v[1:] for n, v in tl.items()})
    # the rows landed where the table says, with their own scales
    assert bool((tl["k_scale"][2, 1] > 0).all())
    assert bool((tl["k_scale"][3, 5] > 0).all())


# ---------------------------------------------------------------------------
# The fused-dequant paged decode op.
# ---------------------------------------------------------------------------
def _quant_arena(seed, pages, ps, h, d, granularity):
    raw = _rows(seed, (pages, ps, h, d), scale=1.0)
    axes = (2, 3) if granularity == "page" else (3,)
    q, scale = kv_cache.quantize_symmetric(_t(raw), axes)
    scale = scale.reshape((pages, ps) if granularity == "page"
                          else (pages, ps, h))
    return q, scale


@pytest.mark.parametrize("granularity", GRANS)
@pytest.mark.parametrize("aliased", [False, True], ids=["own", "aliased"])
def test_fused_dequant_op_equals_the_reference(granularity, aliased):
    """The port's op (plain version, the kernel's oracle) against the
    reference's jnp and Pallas (interpret) paths on the same int8 arenas,
    a shuffled table, and with ``aliased`` two slots reading the same
    pages (prefix sharing): 2e-5."""
    s, h, g, d, ps, pmax = 4, 2, 3, 16, 8, 4
    pages = 1 + s * pmax
    rng = np.random.default_rng(3)
    table = rng.permutation(np.arange(1, pages))[:s * pmax].reshape(
        s, pmax).astype(np.int32)
    lengths = np.array([1, 9, 32, 0], np.int32)
    if aliased:
        table[1] = table[0]
        lengths = np.array([17, 17, 5, 3], np.int32)
    q = rng.standard_normal((s, h, g, d)).astype(np.float32)
    kq, ksc = _quant_arena(1, pages, ps, h, d, granularity)
    vq, vsc = _quant_arena(2, pages, ps, h, d, granularity)
    got = tops.decode_attention_paged(
        _t(q), kq, vq, _t(table), _t(lengths), k_scale=ksc, v_scale=vsc,
        use_kernel=True).numpy()
    for use_kernel in (False, True):
        want = jops.decode_attention_paged(
            jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
            jnp.asarray(table), jnp.asarray(lengths),
            k_scale=jnp.asarray(ksc.numpy()),
            v_scale=jnp.asarray(vsc.numpy()), use_kernel=use_kernel)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    assert (got[3] == 0).all() or aliased      # a free slot reads zeros


# ---------------------------------------------------------------------------
# The pool and its budget.
# ---------------------------------------------------------------------------
def test_resolve_page_quant(dense):
    cfg = dense[2].cfg
    for mod in (jkv, kv_cache):
        assert mod.resolve_page_quant(cfg, 1024) == (128, "page")
        assert mod.resolve_page_quant(cfg, 24) == (32, "page")
        assert mod.resolve_page_quant(cfg, 1024, 32, "page_head") == \
            (32, "page_head")
        with pytest.raises(ValueError, match="granularity"):
            mod.resolve_page_quant(cfg, 1024, 32, "tensor")


@pytest.mark.parametrize("granularity,sdims", [("page", 3),
                                               ("page_head", 4)])
def test_int8_pool_leaves_and_bytes_equal_the_reference(dense, granularity,
                                                        sdims):
    cfg = dense[2].cfg
    jpool, tpool = _int8_pools(cfg, granularity)
    kv = tpool["kv"]
    assert set(kv) == {"k", "v", "k_scale", "v_scale"}
    assert kv["k"].dtype == kv["v"].dtype == torch.int8
    assert kv["k_scale"].dtype == torch.float32 and kv["k_scale"].ndim == sdims
    for n, leaf in jpool["kv"].items():
        assert tuple(leaf.shape) == tuple(kv[n].shape)
    kw = dict(page_size=8, pages=9, page_dtype="int8",
              scale_granularity=granularity)
    assert kv_cache.paged_pool_bytes(cfg, 2, 32, **kw) == \
        jkv.paged_pool_bytes(cfg, 2, 32, 1, **kw)


def test_default_pool_untouched(dense):
    cfg = dense[2].cfg
    pool = kv_cache.init_paged_pool(cfg, 2, 64, page_size=16, device="cpu")
    assert set(pool["kv"]) == {"k", "v"}
    assert pool["kv"]["k"].dtype == kv_cache.cache_dtype(cfg)


def test_pool_bytes_ordering(dense):
    cfg = dense[2].cfg
    kw = dict(page_size=16, pages=9)
    b16 = kv_cache.paged_pool_bytes(cfg, 2, 64, **kw)
    q_page, q_head = (kv_cache.paged_pool_bytes(
        cfg, 2, 64, page_dtype="int8", scale_granularity=g, **kw)
        for g in GRANS)
    assert q_page < q_head < b16


@pytest.mark.parametrize("granularity", GRANS)
def test_equal_budget_admits_1p8x_tokens(dense_bf16, granularity):
    """At one budget, int8 pages (and their scale rows) buy >= 1.8x the
    page tokens of bf16 pages ("page" scales, as the reference's claim;
    "page_head" reported), and the same (slots, pages) as the
    reference's budget solver."""
    cfg = dense_bf16[2].cfg
    budget = kv_cache.slot_pool_bytes(cfg, 4, 64)
    kw = dict(page_size=16, avg_tokens=16)
    _, pages_bf = kv_cache.paged_dims_in_budget(cfg, 64, budget, **kw)
    dims_q = kv_cache.paged_dims_in_budget(
        cfg, 64, budget, page_dtype="int8", scale_granularity=granularity,
        **kw)
    assert dims_q == jkv.paged_dims_in_budget(
        cfg, 64, budget, 1, page_dtype="int8",
        scale_granularity=granularity, **kw)
    ratio = (dims_q[1] - 1) / (pages_bf - 1)
    assert ratio >= (1.8 if granularity == "page" else 1.5), ratio


def test_refusals_are_the_reference_s(dense):
    _, _, tm, tp = dense
    cfg = tm.cfg
    with pytest.raises(ValueError, match="page_dtype"):
        kv_cache.init_paged_pool(cfg, 2, 64, page_dtype="fp4", device="cpu")
    with pytest.raises(ValueError, match="granularity"):
        kv_cache.init_paged_pool(cfg, 2, 64, page_dtype="int8",
                                 scale_granularity="tensor", device="cpu")
    for arch in ("deepseek-v2-lite-16b", "hymba-1.5b", "whisper-base",
                 "rwkv6-1.6b"):
        c = tbuild(arch, reduced=True, device="cpu").cfg
        assert not kv_cache.supports_page_quant(c)
        assert kv_cache.supports_page_quant(c) == jkv.supports_page_quant(
            jbuild(arch, reduced=True).cfg)
    mla = tbuild("deepseek-v2-lite-16b", reduced=True, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        kv_cache.init_paged_pool(mla.cfg, 2, 64, page_dtype="int8",
                                 device="cpu")
    for arch in ("granite-moe-3b-a800m", "qwen2-vl-7b"):
        assert kv_cache.supports_page_quant(
            tbuild(arch, reduced=True, device="cpu").cfg)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(tm, tp, slots=2, max_len=64, paged=False,
                                 page_dtype="int8")
    with pytest.raises(ValueError, match="quantizable"):
        ContinuousBatchingEngine(mla, None, slots=2, max_len=64,
                                 page_dtype="int8")
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(tm, tp, slots=2, max_len=64, paged=False,
                                 host_swap_bytes=1 << 20)
    for arch, what in (("hymba-1.5b", "hybrid"), ("whisper-base", "encdec")):
        m = tbuild(arch, reduced=True, device="cpu")
        with pytest.raises(ValueError, match=what):
            ContinuousBatchingEngine(m, None, slots=2, max_len=64,
                                     page_size=8, prefix_cache=False,
                                     host_swap_bytes=1 << 20)


# ---------------------------------------------------------------------------
# Serving from int8 pages.
# ---------------------------------------------------------------------------
def _greedy_reqs(req, n, vocab, plen=8, new=8, seed=0):
    rng = np.random.default_rng(seed)
    return [req(rid=i, prompt=tuple(int(t) for t in
                                    rng.integers(1, vocab, plen)),
                max_new_tokens=new) for i in range(n)]


def _serve_both(w, reqs_kw=None, **kw):
    """The same requests through the JAX engine and the port's, the same
    arguments; returns ((tokens, throughput, engine) of each)."""
    jm, jp, tm, tp = w
    out = []
    for eng, req in ((jsched.ContinuousBatchingEngine(jm, jp, **kw),
                      jsched.Request),
                     (ContinuousBatchingEngine(tm, tp, **kw), Request)):
        comps = eng.run(_greedy_reqs(req, vocab=tm.cfg.vocab,
                                     **(reqs_kw or dict(n=6))))
        out.append(([list(c.tokens) for c in comps], eng.throughput(), eng))
    return out


def _undecided(w, reqs, got, want) -> bool:
    """bf16: every request whose tokens differ first differs where the
    reference's top-2 margin is within twice the two packages' largest
    logit difference at that context (a near-tie: either token is
    right)."""
    jm, jp, tm, tp = w
    for r, a, b in zip(reqs, got, want):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ctx = list(r.prompt) + list(b[:j])
        lj, _ = jeng.prefill(jp, jnp.asarray([ctx], jnp.int32), cfg=jm.cfg)
        lt, _ = teng.prefill(tp, torch.tensor([ctx]), cfg=tm.cfg)
        lj = np.asarray(lj[0, :jm.cfg.vocab].astype(jnp.float32))
        lt = lt[0, :tm.cfg.vocab].float().numpy()
        top2 = np.sort(lj)[-2:]
        if top2[1] - top2[0] > 2 * np.abs(lj - lt).max():
            return False
    return True


@pytest.mark.parametrize("granularity", GRANS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_engine_tokens_equal_the_jax_int8_engine(dense, dense_bf16,
                                                      granularity, dtype):
    w = dense if dtype == "float32" else dense_bf16
    (jt, jth, _), (tt, tth, eng) = _serve_both(
        w, slots=4, max_len=64, temperature=0.0, seed=1, page_dtype="int8",
        scale_granularity=granularity)
    assert eng.pool["kv"]["k"].dtype == torch.int8
    assert tth["page_dtype"] == "int8"
    assert tth["scale_granularity"] == jth["scale_granularity"] == granularity
    if dtype == "float32":
        assert tt == jt
    else:
        assert tt == jt or _undecided(
            w, _greedy_reqs(Request, 6, w[2].cfg.vocab), tt, jt)


def test_int8_engine_top1_agreement(dense_bf16):
    """The reference's own claim on the port: int8 "page_head" pages agree
    with bf16 pages on >= 80 % of the greedy tokens."""
    (_, _, _), (bt, _, _) = _serve_both(dense_bf16, slots=4, max_len=64,
                                        temperature=0.0, seed=1)
    (_, _, _), (qt, _, _) = _serve_both(
        dense_bf16, slots=4, max_len=64, temperature=0.0, seed=1,
        page_dtype="int8", scale_granularity="page_head")
    matched = sum(a == b for x, y in zip(bt, qt) for a, b in zip(x, y))
    assert matched / sum(map(len, bt)) >= 0.8


def test_bf16_default_exact_strip_parity(dense_bf16):
    _, (paged, th, _) = _serve_both(dense_bf16, slots=4, max_len=64,
                                    temperature=0.0, seed=1)
    _, (strip, _, _) = _serve_both(dense_bf16, slots=4, max_len=64,
                                   temperature=0.0, seed=1, paged=False)
    assert paged == strip and "page_dtype" not in th


@pytest.mark.parametrize("granularity", GRANS)
def test_prefix_hit_over_int8_pages_equals_the_reference(dense, granularity):
    """A shared head over int8 pages: the tails prefill after dequantized
    gathered pages and the copy-on-write copy carries the scales with the
    codes; tokens and prefix counters equal the JAX engine's."""
    jm, jp, tm, tp = dense
    head = tuple(range(5, 17))                     # a page + 4 tokens
    prompts = [head + tuple(100 + 10 * i + j for j in range(5))
               for i in range(3)] + [head[:10] + (77, 78, 79)]
    out = []
    for eng, req in (
            (jsched.ContinuousBatchingEngine, jsched.Request),
            (ContinuousBatchingEngine, Request)):
        m, p = (jm, jp) if req is jsched.Request else (tm, tp)
        e = eng(m, p, slots=2, max_len=48, page_size=8, temperature=0.0,
                prefix_cache=True, page_dtype="int8",
                scale_granularity=granularity)
        comps = e.run([req(rid=i, prompt=pr, max_new_tokens=5)
                       for i, pr in enumerate(prompts)])
        out.append(([list(c.tokens) for c in comps], e.throughput()))
    (jt, jth), (tt, tth) = out
    assert tt == jt
    keys = ("prefix_hits", "prefix_tokens_reused", "cow_copies",
            "peak_pages", "cached_pages")
    assert {k: tth[k] for k in keys} == {k: jth[k] for k in keys}
    assert tth["prefix_hits"] >= 2 and tth["cow_copies"] >= 1


def test_gather_pages_dequantizes_into_the_compute_dtype(dense_bf16):
    cfg = dense_bf16[2].cfg
    pool = kv_cache.init_paged_pool(cfg, 2, 32, page_size=8, device="cpu",
                                    page_dtype="int8")
    cache = {n: _t(x) for n, x in _prefill_cache(cfg, 16, 4).items()}
    kv_cache.adopt_slot_paged(pool, cache, 0, 16, torch.tensor([1, 2, 0, 0]))
    g = teng.gather_pages(pool["kv"], torch.tensor([1, 2]),
                          dtype=torch.bfloat16)
    assert set(g) == {"k", "v"} and g["k"].dtype == torch.bfloat16
    want = jkv.dequantize_pages(
        {n: jnp.asarray(x[:, [1, 2]].reshape(x.shape[0], 1, 16,
                                             *x.shape[3:]).numpy())
         for n, x in pool["kv"].items() if n in ("k", "v")}
        | {n: jnp.asarray(x[:, [1, 2]].reshape(x.shape[0], 1, 16).numpy())
           for n, x in pool["kv"].items() if n.endswith("_scale")},
        jnp.bfloat16)
    for n in ("k", "v"):
        np.testing.assert_array_equal(
            np.asarray(want[n].astype(jnp.float32)), g[n].float().numpy())
    assert pool["kv"]["k"].dtype == torch.int8      # the arena never widens


# ---------------------------------------------------------------------------
# The host-RAM swap tier.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("granularity", GRANS)
def test_restore_slot_is_bit_exact_and_equals_the_reference(dense,
                                                            granularity):
    """A slot's pages gathered into a host blob (what demotion takes) and
    scattered into fresh pages: the restored bytes are the captured bytes,
    int8 codes and float32 scales, and the pool equals the reference's
    ``restore_slot_paged`` of the same blob."""
    cfg = dense[2].cfg
    jpool, tpool = _int8_pools(cfg, granularity, pages=12)
    rng = np.random.default_rng(5)
    for n, leaf in tpool["kv"].items():
        leaf.copy_(_t(rng.integers(-127, 128, leaf.shape).astype(np.int8)
                      if leaf.dtype == torch.int8
                      else rng.random(leaf.shape).astype(np.float32)))
    jpool["kv"] = {n: jnp.asarray(x.numpy())
                   for n, x in tpool["kv"].items()}
    src = torch.tensor([1, 2, 3, 0], dtype=torch.int32)  # 20 tok + padding
    dst = torch.tensor([4, 5, 6, 0], dtype=torch.int32)
    blob = {n: x.clone() for n, x in kv_cache.gather_slot(tpool, src).items()}
    kv_cache.restore_slot_paged(tpool, blob, 1, 20, dst)
    jpool = jkv.restore_slot_paged(jpool, {n: x.numpy()
                                           for n, x in blob.items()},
                                   1, 20, dst.numpy())
    for n, leaf in tpool["kv"].items():
        assert leaf.dtype == blob[n].dtype
        assert torch.equal(leaf[:, :3 + 4][:, [4, 5, 6]], blob[n][:, :3])
        assert torch.equal(leaf[:, [4, 5, 6]], leaf[:, [1, 2, 3]])
    _bits_equal({n: x[:, 1:] for n, x in jpool["kv"].items()},
                {n: x[:, 1:] for n, x in tpool["kv"].items()})
    assert int(tpool["lengths"][1]) == 20
    assert tpool["page_table"][1].tolist() == dst.tolist()


def _swap_kw(**kw):
    kw.setdefault("prefix_cache", False)
    return dict(slots=3, max_len=128, page_size=16, pages=1 + 9,
                temperature=0.0, seed=1, **kw)


OVERLOAD = dict(n=5, plen=48, new=16, seed=7)


@pytest.mark.parametrize("page_dtype,granularity", [
    (None, None), ("int8", "page"), ("int8", "page_head")],
    ids=["compute-dtype", "int8-page", "int8-page_head"])
def test_swap_tokens_and_counters_equal_the_reference(dense, page_dtype,
                                                      granularity):
    """Five 48-token prompts on 9 usable pages of 16: growth must demote.
    Tokens and counters equal the JAX engine's (demoted == prefetched > 0,
    nothing preempted, the store drained), and the tokens equal the
    unpressured preemption run's (the round trip loses no bit)."""
    kw = dict(page_dtype=page_dtype, scale_granularity=granularity)
    (jt, jth, _), (tt, tth, eng) = _serve_both(
        dense, OVERLOAD, **_swap_kw(host_swap_bytes=1 << 30, **kw))
    assert tt == jt
    assert {k: tth[k] for k in SWAP_COUNTERS} == \
        {k: jth[k] for k in SWAP_COUNTERS}
    assert tth["demoted"] == tth["prefetched"] > 0
    assert tth["preempted"] == 0 and tth["swap_bytes_used"] == 0
    assert len(eng.host_swap) == 0 and not eng._swapped
    assert eng.allocator.free_pages == eng.allocator.usable_pages
    _, (pt, pth, _) = _serve_both(dense, OVERLOAD, **_swap_kw(**kw))
    assert pth["preempted"] > 0 and tt == pt


def test_tiny_swap_budget_falls_back_to_preempt(dense):
    (jt, jth, _), (tt, tth, _) = _serve_both(
        dense, OVERLOAD, **_swap_kw(host_swap_bytes=8))
    assert tt == jt
    assert tth["demoted"] == 0 and tth["preempted"] == jth["preempted"] > 0


def test_shared_pages_refuse_demotion(dense):
    _, _, tm, tp = dense
    eng = ContinuousBatchingEngine(tm, tp, **_swap_kw(
        host_swap_bytes=1 << 30))
    eng.submit(Request(rid=0, prompt=tuple(range(1, 33)), max_new_tokens=8))
    eng._admit_arrived(0.0)            # the prefill only: no burst
    slot = eng.active_slots()[0]
    eng.allocator.share(eng.slot_pages[slot][:1])   # a second reader
    assert not eng._demote(slot)
    assert eng.stats["demoted"] == 0 and eng.host_swap.bytes_used == 0
    assert eng.slot_owner[slot] is not None
    eng.allocator.free(eng.slot_pages[slot][:1])
    assert eng._demote(slot) and eng.stats["demoted"] == 1
    assert eng.allocator.free_pages == eng.allocator.usable_pages


def test_prefix_cache_pins_pages_preempt_fallback(dense):
    """The prefix index reads every admitted prompt's pages, so whole-slot
    demotion is refused and pressure preempts, as the reference."""
    (jt, jth, _), (tt, tth, _) = _serve_both(
        dense, OVERLOAD, **_swap_kw(prefix_cache=True,
                                    host_swap_bytes=1 << 30))
    assert tt == jt
    assert tth["demoted"] == 0 and tth["preempted"] == jth["preempted"] > 0


def test_host_swap_store_budget():
    store = kv_cache.HostSwapStore(100)
    blob = {"k": torch.zeros((2, 3, 4), dtype=torch.int8)}   # 24 bytes
    assert store.put(1, blob) and store.bytes_used == 24
    assert not store.put(1, blob)                            # a dup rid
    assert store.put(2, blob) and store.put(3, blob)
    assert not store.put(4, {"k": torch.zeros(40, dtype=torch.int8)})
    store.pop(2)
    assert store.bytes_used == 48 and 2 not in store and len(store) == 2
    assert kv_cache.HostSwapStore.blob_bytes(
        {"s": torch.zeros((2, 5), dtype=torch.float32)}) == 40


class _ReplayingGraph:
    """The stand-in for ``fused.CudaGraph`` on the CPU: capture keeps the
    step and each replay runs it."""

    pool_bytes = 0

    def warm_up(self, step):
        for _ in range(fused.CudaGraph.WARMUP):
            step()

    def capture(self, step):
        self.step = step

    def replay(self):
        self.step()


@pytest.mark.parametrize("granularity", GRANS)
def test_replay_through_demotion_equals_eager(dense, monkeypatch,
                                              granularity):
    """The replay path on int8 pages under swap pressure: promotion
    writes the pages and the table row in place, so the captured step's
    tensors are never rebound, and tokens, counters and every arena leaf
    equal the eager step's."""
    _, _, tm, tp = dense
    kw = _swap_kw(host_swap_bytes=1 << 30, page_dtype="int8",
                  scale_granularity=granularity)
    runs = []
    for graph in (None, _ReplayingGraph()):
        monkeypatch.setattr(scheduler, "graph_for",
                            lambda dev, gen=None, g=graph: g)
        eng = ContinuousBatchingEngine(tm, tp, **kw)
        assert (eng._fused is not None) is (graph is not None)
        comps = eng.run(_greedy_reqs(Request, vocab=tm.cfg.vocab,
                                     **OVERLOAD))
        runs.append(([list(c.tokens) for c in comps], eng.throughput(),
                     eng.pool["kv"]))
    (te, the, kve), (tg, thg, kvg) = runs
    assert tg == te and thg["replays"] == thg["steps"]
    assert {k: thg[k] for k in SWAP_COUNTERS} == \
        {k: the[k] for k in SWAP_COUNTERS}
    assert thg["demoted"] > 0
    for n in kve:                      # the trash page is garbage
        assert torch.equal(kvg[n][:, 1:], kve[n][:, 1:]), n
