"""The port's prefix sharing on the CPU, held against the reference's:
the radix index (``repro_torch/serving/prefix_cache.py``) by a seeded
random walk that drives both classes over their own allocators and the
cases of ``tests/test_prefix_cache.py``; the engine (tail prefill over
gathered arena pages, copy-on-write adoption, eviction) by greedy tokens
and counters equal to the JAX engine's with the same weights, for dense
(qwen2.5-14b), multi-head latent attention (deepseek-v2-lite-16b under
``moe_impl="dense"``) and vlm (qwen2-vl-7b); and the families whose
prefill cannot be split, which resolve ``prefix_cache="auto"`` off and
refuse True."""

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as tbuild
from repro_torch.serving import engine as teng
from repro_torch.serving import kv_cache
from repro_torch.serving.prefix_cache import PrefixCache, PrefixMatch
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

PS = 4                        # the radix tests' page size
COUNTERS = ("prefix_hits", "prefix_tokens_reused", "cow_copies",
            "prefix_evictions", "cached_pages", "peak_pages", "preempted",
            "admitted")


# ---------------------------------------------------------------------------
# The radix index against the reference's, step by step.
# ---------------------------------------------------------------------------
def _pair(pages=40, ps=PS):
    ja, ta = jkv.PageAllocator(pages), kv_cache.PageAllocator(pages)
    return (ja, JPrefixCache(ja, ps)), (ta, PrefixCache(ta, ps))


def _same_state(j, t):
    (ja, jc), (ta, tc) = j, t
    assert ta.free_pages == ja.free_pages
    assert [ta.refcount(p) for p in range(1, ta.n_pages)] == \
        [ja.refcount(p) for p in range(1, ja.n_pages)]
    assert tc.n_pages == jc.n_pages
    assert sorted(_indexed(tc)) == sorted(_indexed(jc))


def _indexed(pc):
    """Every page the radix index references, one a node."""
    out, stack = [], list(pc.root.children.values())
    while stack:
        node = stack.pop()
        out.append(node.page)
        stack.extend(node.children.values())
    return out


def _same_match(jm, tm):
    assert tm.pages == jm.pages and tm.partial == jm.partial
    assert tm.matched_tokens(PS) == jm.matched_tokens(PS)


@pytest.mark.parametrize("seed", range(8))
def test_random_walk_equals_the_reference(seed):
    """match / trim / insert / evict / clear in a seeded interleaving over
    a 3-token alphabet (so prompts share heads and pages part-fill), with
    slots that keep their pages a while (pinned pages) and retire: every
    return value, refcount and index size equal after every action."""
    rng = np.random.default_rng(seed)
    j, t = _pair()
    live = []                            # pages a "slot" still holds

    def prompt():
        return tuple(int(x) for x in rng.integers(0, 3, rng.integers(1, 15)))

    for _ in range(120):
        op = int(rng.integers(0, 10))
        if op < 3:                                       # match (+ trim)
            p = prompt()
            jm, tm = j[1].match(p), t[1].match(p)
            _same_match(jm, tm)
            n = int(rng.integers(0, len(p) + 1))
            _same_match(jm.trim(PS, n), tm.trim(PS, n))
        elif op < 7:                                     # admit: insert
            p = prompt()
            need = -(-len(p) // PS)
            jids, tids = j[0].alloc(need), t[0].alloc(need)
            assert jids == tids
            if tids is not None:
                assert t[1].insert(p, tids) == j[1].insert(p, jids)
                live.append(tids)
        elif op < 9 and live:                            # retire a slot
            ids = live.pop(int(rng.integers(0, len(live))))
            j[0].free(ids)
            t[0].free(ids)
        elif op == 9:                                    # evict or clear
            if rng.random() < 0.15:
                assert t[1].clear() == j[1].clear()
            else:
                k = int(rng.integers(1, 6))
                assert t[1].evict(k) == j[1].evict(k)
        _same_state(j, t)
    for ids in live:
        j[0].free(ids)
        t[0].free(ids)
    assert t[1].clear() == j[1].clear()
    _same_state(j, t)
    assert t[0].free_pages == t[0].usable_pages


def test_allocator_lifecycle_and_misuse():
    alloc = kv_cache.PageAllocator(5)
    ids = alloc.alloc(2)
    alloc.share(ids)
    assert all(alloc.refcount(p) == 2 for p in ids)
    alloc.free(ids)
    assert alloc.free_pages == 2                  # a reader remains
    alloc.free(ids)
    assert alloc.free_pages == 4
    with pytest.raises(ValueError, match="double free"):
        alloc.free(ids[:1])
    with pytest.raises(ValueError, match="share of free page"):
        alloc.share(ids[:1])
    assert alloc.alloc(100) is None and alloc.free_pages == 4


def _index(pages=16, ps=PS):
    alloc = kv_cache.PageAllocator(pages)
    return alloc, PrefixCache(alloc, ps)


def test_match_walks_whole_page_chain_and_clips():
    alloc, pc = _index()
    prompt = tuple(range(10, 22))                 # 3 pages of 4
    ids = alloc.alloc(3)
    assert pc.insert(prompt, ids) == 3
    m = pc.match(prompt)                          # the last token prefills
    assert m.pages == ids[:2] and m.partial == (ids[2], 3)
    assert m.matched_tokens(PS) == 11
    m2 = pc.match(prompt + (99, 98))
    assert m2.pages == ids and m2.partial is None


def test_divergent_page_is_a_copy_on_write_source():
    alloc, pc = _index()
    ids = alloc.alloc(2)
    pc.insert((1, 2, 3, 4, 5, 6, 7, 8), ids)
    m = pc.match((1, 2, 3, 4, 5, 6, 99, 98, 97))
    assert m.pages == [ids[0]] and m.partial == (ids[1], 2)
    assert pc.match((7, 7, 7, 7, 7)).matched_tokens(PS) == 0


def test_insert_dedups_an_indexed_chain():
    alloc, pc = _index()
    prompt = tuple(range(8))
    ids = alloc.alloc(2)
    assert pc.insert(prompt, ids) == 2
    dup = alloc.alloc(2)
    assert pc.insert(prompt, dup) == 0
    assert pc.n_pages == 2 and alloc.refcount(dup[0]) == 1
    # a partial leaf a longer sibling covers is not indexed again
    more = alloc.alloc(1)
    assert pc.insert((0, 1, 2, 3, 4, 5), [ids[0]] + more) == 0


def test_trim_of_a_partial_match():
    alloc, pc = _index()
    ids = alloc.alloc(2)
    pc.insert(tuple(range(8)), ids)
    m = pc.match(tuple(range(8)) + (50,))
    t = m.trim(PS, 6)                             # cut mid second page
    assert t.pages == [ids[0]] and t.partial == (ids[1], 2)
    assert t.matched_tokens(PS) == 6
    assert m.trim(PS, 4) == PrefixMatch(pages=[ids[0]])
    assert m.trim(PS, 0).matched_tokens(PS) == 0


def test_lru_eviction_frees_cold_leaves_and_skips_pinned():
    alloc, pc = _index()
    cold, hot, pinned = alloc.alloc(1), alloc.alloc(1), alloc.alloc(1)
    pc.insert((1, 1, 1, 1), cold)
    pc.insert((2, 2, 2, 2), hot)
    pc.insert((3, 3, 3, 3), pinned)
    alloc.free(cold + hot + pinned)              # the index's refs remain
    alloc.share(pinned)                          # and a live reader
    pc.match((2, 2, 2, 2, 9))                    # LRU-bump "hot"
    assert pc.evict(1) == 1 and alloc.refcount(cold[0]) == 0
    assert pc.evict(5) == 1                      # "hot" goes, pinned stays
    assert alloc.refcount(pinned[0]) == 2 and pc.n_pages == 1


def test_chain_unwinds_tip_to_root():
    alloc, pc = _index()
    ids = alloc.alloc(3)
    pc.insert(tuple(range(12)), ids)
    alloc.free(ids)
    assert pc.evict(3) == 3 and pc.n_pages == 0
    assert alloc.free_pages == alloc.usable_pages


def test_clear_keeps_pages_live_slots_share():
    alloc, pc = _index()
    ids = alloc.alloc(2)
    pc.insert(tuple(range(8)), ids)
    assert pc.clear() == 0                       # the slot still holds both
    assert [alloc.refcount(p) for p in ids] == [1, 1] and pc.n_pages == 0


# ---------------------------------------------------------------------------
# The engine against the JAX engine, same weights.
# ---------------------------------------------------------------------------
def _weights(arch):
    jm = jbuild(arch, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(arch, reduced=True, device="cpu")
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                       device="cpu")


@pytest.fixture(scope="module")
def dense():
    return _weights("qwen2.5-14b")


def _serve_both(w, reqs, **kw):
    """Serve ``reqs`` ((prompt, max_new) pairs) through the JAX engine and
    the port's with the same arguments; returns (tokens, throughput) of
    each."""
    jm, jp, tm, tp = w
    kw = dict(dict(slots=2, max_len=64, page_size=8, temperature=0.0), **kw)
    out = []
    for eng, req in ((jsched.ContinuousBatchingEngine(jm, jp, **kw),
                      jsched.Request),
                     (ContinuousBatchingEngine(tm, tp, **kw), Request)):
        comps = eng.run([req(rid=i, prompt=p, max_new_tokens=n)
                         for i, (p, n) in enumerate(reqs)])
        out.append(([list(c.tokens) for c in comps], eng.throughput(), eng))
    return out


def _held(w, reqs, **kw):
    """Tokens and counters equal the reference's; returns the port's
    throughput and engine (its tokens as ``eng.completions``)."""
    (jt, jth, _), (tt, tth, eng) = _serve_both(w, reqs, **kw)
    assert tt == jt
    if jth.get("prefix_cache"):
        assert {k: tth[k] for k in COUNTERS} == {k: jth[k] for k in COUNTERS}
    else:
        assert tth["prefix_cache"] is False and "prefix_hits" not in tth
        assert tth["peak_pages"] == jth["peak_pages"]
    return tth, eng


def _tokens(eng):
    return [list(c.tokens) for c in eng.completions]


def _shared(prefix, n=4, tail=3, max_new=6):
    return [(prefix + tuple(100 + i * 10 + j for j in range(tail)), max_new)
            for i in range(n)]


@pytest.mark.parametrize("prefix_cache", [True, "auto"])
def test_shared_head_tokens_and_counters_equal_the_reference(dense,
                                                             prefix_cache):
    reqs = _shared(tuple(range(5, 21)))          # 2 whole pages of 8
    th, eng = _held(dense, reqs, prefix_cache=prefix_cache)
    assert th["prefix_hits"] == 3 and th["prefix_tokens_reused"] == 48
    assert eng.stats["prefill_tokens"] == sum(len(p) for p, _ in reqs)
    # the hits' tails prefilled after gathered pages: one extend shape
    assert ("extend", 8, 3) in eng._prefill_shapes


def test_cow_on_a_part_filled_last_page(dense):
    base = tuple(range(9, 21))                   # a full page + 4 tokens
    th, eng = _held(dense, [(base, 4), (base + tuple(range(60, 68)), 4)],
                    prefix_cache=True)
    assert th["cow_copies"] == 1 and th["prefix_tokens_reused"] == 12
    assert th["prefix_hits"] == 1


def test_cow_on_a_divergent_page(dense):
    th, _ = _held(dense, [((1, 2, 3, 4, 5, 6, 7, 8), 4),
                          ((1, 2, 3, 4, 99, 98, 97, 96, 95), 4)],
                  prefix_cache=True)
    assert th["cow_copies"] == 1 and th["prefix_tokens_reused"] == 4


def test_the_tail_bucket_trims_the_match(dense):
    # 30 cached tokens (3 pages + 6); a 31-token prompt's bucket is 32, so
    # a tail bucket of 8 fits after 24 of them only: the match is trimmed
    # to the 3 whole pages and nothing is copied
    p = tuple(range(40, 70))
    th, eng = _held(dense, [(p, 3), (p + (7,), 3)], slots=1,
                    prefix_cache=True)
    assert th["prefix_hits"] == 1 and th["prefix_tokens_reused"] == 24
    assert th["cow_copies"] == 0
    assert ("extend", 8, 4) in eng._prefill_shapes


def test_exact_lengths_prefill_the_exact_tail(dense):
    base = tuple(range(9, 21))
    th, eng = _held(dense, [(base, 4), (base + (5, 6, 7), 4)],
                    prefix_cache=True, prefill_buckets=None)
    assert th["prefix_tokens_reused"] == 12
    assert ("extend", 3, 2) in eng._prefill_shapes


def test_preemption_keeps_shared_pages_and_frees_the_slots_own(dense):
    _, _, tm, tp = dense
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=64,
                                   temperature=0.0, page_size=8,
                                   prefix_cache=True, eos_token=-1)
    prefix = tuple(range(1, 9))                  # one whole shared page
    eng.submit(Request(rid=0, prompt=prefix, max_new_tokens=8))
    eng.submit(Request(rid=1, prompt=prefix + (70,), max_new_tokens=8))
    eng.step()
    slot = {eng.slot_owner[s].rid: s for s in eng.active_slots()}
    shared = eng.slot_pages[slot[1]][0]
    unique = list(eng.slot_pages[slot[1]][1:])
    assert shared in eng.slot_pages[slot[0]]
    # both slots' table rows name it: the arena holds it once
    rows = eng.pool["page_table"]
    assert int(rows[slot[0], 0]) == int(rows[slot[1], 0]) == shared
    assert eng.allocator.refcount(shared) == 3    # two slots + the index
    eng._preempt(slot[1], 0.0)
    assert eng.allocator.refcount(shared) == 2
    assert all(eng.allocator.refcount(p) <= 1 for p in unique)
    eng.run([])
    assert sorted(c.rid for c in eng.completions) == [0, 1]


def test_preemption_with_sharing_equals_the_reference(dense):
    # recompute on readmission gives the same tokens, shared or not
    reqs = [(tuple(range(1, 9)), 20)] * 2
    th, on = _held(dense, reqs, prefix_cache=True, max_len=32, pages=7,
                   seed=2)
    # (an 8-token prompt fills its bucket: no tail fits after the 7
    # tokens a match may take, so it misses, as in the reference)
    assert th["preempted"] >= 1 and th["prefix_hits"] == 0
    _, off = _held(dense, reqs, prefix_cache=False, max_len=32, seed=2)
    assert _tokens(on) == _tokens(off)


def test_eviction_under_pressure_equals_the_reference(dense):
    reqs = [(tuple(range(1, 9)), 2), (tuple(range(30, 55)), 2)]
    th, eng = _held(dense, reqs, prefix_cache=True, slots=1, pages=5)
    assert th["prefix_evictions"] >= 1
    assert eng.prefix_cache.match(tuple(range(1, 10))).pages == []
    # and the run drains: free + indexed == usable
    assert (eng.allocator.free_pages + th["cached_pages"]
            == eng.allocator.usable_pages)


def test_no_prefix_cache_equals_the_reference(dense):
    th, eng = _held(dense, _shared(tuple(range(16)), n=2),
                    prefix_cache=False)
    assert eng.prefix_cache is None
    assert eng.allocator.free_pages == eng.allocator.usable_pages


def test_prefill_extend_equals_a_whole_prefill(dense):
    """The tail after gathered pages gives the whole prefill's logits and
    the same K/V at every prompt position."""
    _, _, tm, tp = dense
    cfg = tm.cfg
    prompt = torch.tensor([list(range(3, 23))])  # 20 tokens
    want, cache = teng.prefill(tp, prompt, cfg=cfg, max_len=24)
    pool = kv_cache.init_paged_pool(cfg, 1, 24, page_size=8, device="cpu")
    kv_cache.adopt_slot_paged(pool, cache, 0, 20,
                              torch.tensor([1, 2, 3], dtype=torch.int32))
    # pages 1 and 2 hold positions [0, 16); prefill [13, 20) after 13
    got, ext = teng.prefill_extend(
        tp, prompt[:, 13:], pool["kv"], torch.tensor([1, 2, 0]), 13,
        cfg=cfg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    for n in ("k", "v"):
        torch.testing.assert_close(ext[n][:, :, :20], cache[n][:, :, :20],
                                   atol=1e-5, rtol=1e-5)


def test_copy_row_writes_only_the_fresh_pages(dense):
    _, _, tm, _ = dense
    pool = kv_cache.init_paged_pool(tm.cfg, 2, 32, page_size=8,
                                    device="cpu")
    shape = pool["kv"]["k"].shape
    cache = {n: torch.randn(shape[0], 1, 24, *shape[3:])
             for n in ("k", "v")}
    before = pool["kv"]["k"][:, 5].clone()
    kv_cache.adopt_slot_paged(pool, cache, 1, 20,
                              torch.tensor([5, 6, 7, 0], dtype=torch.int32),
                              torch.tensor([0, 6, 7, 0], dtype=torch.int32))
    assert torch.equal(pool["kv"]["k"][:, 5], before)      # shared: kept
    assert torch.equal(pool["kv"]["k"][:, 6], cache["k"][:, 0, 8:16])
    assert pool["page_table"][1].tolist() == [5, 6, 7, 0]
    assert int(pool["lengths"][1]) == 20


@pytest.fixture(scope="module")
def mla():
    return _weights("deepseek-v2-lite-16b")


def test_mla_latent_pages_are_shared_as_the_reference(mla):
    # the latent {c, kr} pages are gathered and copied on write like K/V
    reqs = _shared(tuple(range(7, 23)), n=3, tail=1, max_new=4) + [
        (tuple(range(7, 19)) + (50, 51), 4)]
    th, _ = _held(mla, reqs, prefix_cache=True, moe_impl="dense")
    assert th["prefix_hits"] == 3 and th["cow_copies"] == 1


def test_vlm_tail_positions_cross_the_grid_as_the_reference():
    # reduced qwen2-vl: 8 patches, grid 3; the 16-token head lies partly
    # on the grid and the tails after it, at their original indices
    w = _weights("qwen2-vl-7b")
    reqs = _shared(tuple(range(11, 27)), n=3, tail=5, max_new=5) + [
        (tuple(range(11, 17)) + (90, 91, 92), 5)]
    th, _ = _held(w, reqs, prefix_cache="auto")
    assert th["prefix_hits"] == 3 and th["cow_copies"] == 1


# ---------------------------------------------------------------------------
# Families whose prefill cannot be split bypass the index.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kw", [
    ("rwkv6-1.6b", {}), ("hymba-1.5b", dict(page_size=8)),
    ("whisper-base", dict(page_size=8)),
    ("granite-moe-3b-a800m", dict(page_size=8)),
    ("granite-moe-3b-a800m", dict(page_size=8, moe_impl="gather")),
    ("deepseek-v2-lite-16b", dict(page_size=8)),
    ("qwen2.5-14b", dict(paged=False))],
    ids=["ssm", "hybrid", "encdec", "moe-dispatch", "moe-gather",
         "mla-dispatch", "dense-strip"])
def test_bypass_resolves_auto_off_and_refuses_true(arch, kw):
    m = tbuild(arch, reduced=True, device="cpu")
    eng = ContinuousBatchingEngine(m, None, slots=2, max_len=32, **kw)
    assert eng.prefix_cache is None
    assert eng.throughput().get("prefix_cache") in (False, None)
    with pytest.raises(ValueError, match="cannot share prefixes"):
        ContinuousBatchingEngine(m, None, slots=2, max_len=32,
                                 prefix_cache=True, **kw)


@pytest.mark.parametrize("arch,kw", [
    ("qwen2.5-14b", {}), ("qwen2-vl-7b", {}),
    ("granite-moe-3b-a800m", dict(moe_impl="dense")),
    ("deepseek-v2-lite-16b", dict(moe_impl="dense"))],
    ids=["dense", "vlm", "moe-dense", "mla-dense"])
def test_shareable_families_resolve_auto_on(arch, kw):
    m = tbuild(arch, reduced=True, device="cpu")
    for pc in ("auto", True):
        eng = ContinuousBatchingEngine(m, None, slots=2, max_len=32,
                                       page_size=8, prefix_cache=pc, **kw)
        assert eng.prefix_cache is not None
        assert eng.throughput()["cached_pages"] == 0

