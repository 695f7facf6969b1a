"""The port's continuous-batching engine on the CPU: greedy tokens equal to
the JAX lockstep loop with the same weights (kernels off and on), and the
port's own invariants -- paged == strip, ragged == lockstep, preemption
keeps the tokens, page refcounts add up after every step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.serving import engine as jeng
from repro.serving import scheduler as jsched
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import Model
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer as ttr
from repro_torch.serving import engine as teng
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "qwen2.5-14b"
MAX_LEN = 48


@pytest.fixture(scope="module")
def weights():
    jm = jbuild(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(ARCH, reduced=True, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _requests(vocab, n=4, seed=11, plens=(3, 5, 7, 4)):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, vocab, plens[i % len(plens)])), max_new_tokens=4 + i)
        for i in range(n)]


def _copy(reqs):
    return [dataclasses.replace(r) for r in reqs]


def _tokens(comps):
    return [list(c.tokens) for c in sorted(comps, key=lambda c: c.rid)]


def _port_lockstep(tm, tp, req):
    toks, _ = teng.generate_timed(
        tp, torch.tensor([req.prompt]), cfg=tm.cfg,
        steps=req.max_new_tokens - 1, max_len=MAX_LEN, temperature=0.0)
    return toks[0].tolist()


@pytest.mark.parametrize("use_kernels,algorithm", [
    pytest.param(k, a, id=("dense-kernels" if k else "dense-plain")
                 + ("" if a == "two_pass" else f"-{a}"))
    for a in ("two_pass", "three_pass_recompute", "three_pass_reload")
    for k in (False, True)])
def test_greedy_tokens_match_jax_lockstep(weights, use_kernels, algorithm):
    jm, jp, tm, tp = weights
    knobs = dict(use_kernels=use_kernels, softmax_algorithm=algorithm)
    jcfg = dataclasses.replace(jm.cfg, **knobs)
    tm = Model(dataclasses.replace(tm.cfg, **knobs), "cpu")
    reqs = _requests(tm.cfg.vocab)
    ref = []
    for r in reqs:
        toks, _ = jeng.generate_timed(
            jp, jnp.asarray(r.prompt, jnp.int32)[None], cfg=jcfg,
            steps=r.max_new_tokens - 1, key=jax.random.PRNGKey(7),
            temperature=0.0, max_len=MAX_LEN)
        ref.append([int(t) for t in np.asarray(toks)[0]])
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   temperature=0.0, seed=3)
    assert _tokens(eng.run(_copy(reqs))) == ref
    assert [_port_lockstep(tm, tp, r) for r in reqs] == ref


@pytest.mark.parametrize("buckets", ["auto", None],
                         ids=["page-buckets", "exact-lengths"])
def test_paged_equals_strip_and_ragged_equals_lockstep(weights, buckets):
    # exact lengths prefill ragged last pages, zero-filled on adoption
    _, _, tm, tp = weights
    reqs = _requests(tm.cfg.vocab, n=5, plens=(2, 9, 5, 11, 7))
    runs = {}
    for paged in (True, False):
        eng = ContinuousBatchingEngine(tm, tp, slots=3, max_len=MAX_LEN,
                                       page_size=8, temperature=0.0,
                                       paged=paged, prefill_buckets=buckets)
        runs[paged] = _tokens(eng.run(_copy(reqs)))
        assert eng.throughput()["paged"] is paged
    assert runs[True] == runs[False]
    assert runs[True] == [_port_lockstep(tm, tp, r) for r in reqs]


def _refcount_identity(eng):
    """Every live page is held by exactly its slot and, once indexed, the
    prefix cache (these prompts share no head: no page has two slots);
    the rest are free."""
    alloc = eng.allocator
    held = [p for pages in eng.slot_pages for p in pages]
    indexed, stack = set(), list(eng.prefix_cache.root.children.values())
    while stack:                                  # the radix index's nodes
        node = stack.pop()
        indexed.add(node.page)
        stack.extend(node.children.values())
    assert len(indexed) == eng.prefix_cache.n_pages
    assert len(held) == len(set(held))
    assert all(alloc.refcount(p) == 1 + (p in indexed) for p in held)
    assert all(alloc.refcount(p) == 1 for p in indexed - set(held))
    assert alloc.free_pages + len(indexed | set(held)) == alloc.usable_pages
    for slot, pages in enumerate(eng.slot_pages):
        row = eng.pool["page_table"][slot].tolist()
        assert row[:len(pages)] == pages
        assert all(p == 0 for p in row[len(pages):])


def test_preemption_keeps_tokens_and_refcounts_add_up(weights):
    _, _, tm, tp = weights
    reqs = [Request(rid=i, prompt=tuple(range(3 + i, 14 + i)),
                    max_new_tokens=12) for i in range(4)]
    # 3 slots over 6 usable 8-token pages: the slots cannot all grow
    eng = ContinuousBatchingEngine(tm, tp, slots=3, max_len=MAX_LEN,
                                   page_size=8, pages=7, temperature=0.0)
    for r in _copy(reqs):
        eng.submit(r)
    eng._run_start = 0.0
    while eng.pending or eng.active_slots():
        eng.step()
        _refcount_identity(eng)
    assert eng.stats["preempted"] > 0
    eng.completions.sort(key=lambda c: c.rid)
    assert _tokens(eng.completions) == [_port_lockstep(tm, tp, r)
                                        for r in reqs]
    assert all(c.reason == "max_tokens" for c in eng.completions)


def test_budgeted_pools_and_backfill(weights):
    _, _, tm, tp = weights
    from repro_torch.serving import kv_cache

    one = kv_cache.slot_pool_bytes(tm.cfg, 1, MAX_LEN)
    eng = ContinuousBatchingEngine(tm, tp, memory_budget_bytes=2 * one,
                                   max_len=MAX_LEN, paged=False,
                                   temperature=0.0)
    assert eng.n_slots == 2
    comps = eng.run(_copy(_requests(tm.cfg.vocab, n=5)))
    assert eng.throughput()["admitted"] == 5 and len(comps) == 5
    s, p = kv_cache.paged_dims_in_budget(tm.cfg, MAX_LEN, 4 * one,
                                         page_size=8, avg_tokens=16)
    assert kv_cache.paged_pool_bytes(tm.cfg, s, MAX_LEN, page_size=8,
                                     pages=p) <= 4 * one


@pytest.mark.parametrize("kw,item", [
    # the serving half of item 22 is ported (tests/test_torch_tp_serving.py);
    # the swap tier under a mesh is not
    (dict(mesh=make_serving_mesh((1, 1), backend="gloo"),
          host_swap_bytes=1 << 20), "22")])
def test_unported_options_raise(weights, kw, item):
    _, _, tm, tp = weights
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN, **kw)


@pytest.mark.parametrize("kw", [
    dict(page_dtype="int8"), dict(host_swap_bytes=1 << 20),
    dict(page_dtype="int8", scale_granularity="page_head",
         host_swap_bytes=1 << 20)],
    ids=["int8", "swap", "int8-page_head-swap"])
def test_int8_and_swap_options_serve(weights, kw):
    """``page_dtype`` and ``host_swap_bytes`` are served (ROADMAP item
    18): greedy tokens equal the JAX engine's under the same options
    (``tests/test_torch_kv_quant.py`` holds them at page pressure)."""
    jm, jp, tm, tp = weights
    reqs = _requests(tm.cfg.vocab, n=5)
    want = jsched.ContinuousBatchingEngine(
        jm, jp, slots=2, max_len=MAX_LEN, page_size=8, temperature=0.0,
        **kw).run([jsched.Request(rid=r.rid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens)
                   for r in reqs])
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   page_size=8, temperature=0.0, **kw)
    assert _tokens(eng.run(_copy(reqs))) == _tokens(want)
    th = eng.throughput()
    assert th.get("page_dtype") == kw.get("page_dtype")
    assert ("swap_bytes_used" in th) == ("host_swap_bytes" in kw)


@pytest.mark.parametrize("prefix_cache", [True, False, "auto"])
def test_prefix_cache_options_serve(weights, prefix_cache):
    """``prefix_cache`` is served (ROADMAP item 17): requests sharing a
    16-token head give the JAX lockstep's tokens, with the tails prefilled
    after the shared pages unless the cache is off."""
    jm, jp, tm, tp = weights
    head = tuple(range(7, 23))
    reqs = [Request(rid=i, prompt=head + (50 + i,), max_new_tokens=4)
            for i in range(3)]
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   page_size=8, temperature=0.0,
                                   prefix_cache=prefix_cache)
    assert _tokens(eng.run(_copy(reqs))) == [_port_lockstep(tm, tp, r)
                                             for r in reqs]
    th = eng.throughput()
    assert th["prefix_cache"] is bool(prefix_cache)
    assert th.get("prefix_hits", 0) == (2 if prefix_cache else 0)


def test_unported_families_and_policy_sites_raise():
    # every family is served now (tests/test_torch_ssm.py,
    # tests/test_torch_encdec.py, tests/test_torch_moe.py,
    # tests/test_torch_mla.py, tests/test_torch_vlm.py,
    # tests/test_torch_hybrid.py), so the package keeps no family gate;
    # vlm builds and serves text requests
    from repro_torch.configs import base

    assert not {"UNPORTED_FAMILIES", "UNTRAINED_FAMILIES",
                "check_ported"} & set(vars(base))
    m = tbuild("qwen2-vl-7b", reduced=True, device="cpu")
    eng = m.serving_engine(m.init(0), slots=2, max_len=MAX_LEN,
                           temperature=0.0)
    comps = eng.run(_copy(_requests(m.cfg.vocab, n=3)))
    assert sorted(len(c.tokens) for c in comps) == [4, 5, 6]
    # every softmax site of the dense family is ported: the LM-head CE
    # (tests/test_torch_training.py) and the flash route of a no-cache
    # forward under kernels (test_no_cache_forward_under_kernels_...)


def test_no_cache_forward_under_kernels_matches_reference(weights):
    from repro.models import transformer as jtr

    jm, jp, tm, tp = weights
    jcfg = dataclasses.replace(jm.cfg, use_kernels=True)
    cfg = dataclasses.replace(tm.cfg, use_kernels=True)
    tok = np.random.default_rng(2).integers(0, 256, (2, 21)).astype(
        np.int32)
    want = jtr.forward(jp, jnp.asarray(tok), cfg=jcfg)
    got = ttr.forward(tp, torch.from_numpy(tok), cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-4, rtol=1e-4)


def test_softmax_block_overrides_are_refused():
    # the CUDA softmax takes no tile: a block override would do nothing
    cfg = tbuild(ARCH, reduced=True, device="cpu").cfg
    for knob in ("softmax_block_rows", "softmax_block_cols"):
        with pytest.raises(ValueError, match=knob):
            dataclasses.replace(cfg, **{knob: 16}).softmax_policy()
    assert cfg.softmax_policy().resolve_blocks(
        "decode_attention_paged", 8, 1664) == (8, 128)


def test_sampling_at_temperature_is_seeded(weights):
    _, _, tm, tp = weights
    reqs = _requests(tm.cfg.vocab)
    runs = []
    for _ in range(2):
        eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                       temperature=0.8, seed=9)
        runs.append(_tokens(eng.run(_copy(reqs))))
    assert runs[0] == runs[1]
    assert all(0 <= t < tm.cfg.vocab for r in runs[0] for t in r)
