"""Serving invariants of the port under random action sequences, the
counterpart of ``tests/test_serving_invariants.py``: the page allocator
against an independent refcount mirror, and the continuous-batching
engine driven through seeded admit / decode-burst / preempt / evict
interleavings, with the bookkeeping identities checked after EVERY
scheduler step:

  * every arena page is free or referenced, and its refcount equals the
    number of host-side readers exactly (slot tables, cross tables, the
    prefix index): no leak, no phantom reader;
  * each slot's device table row names its pages, then the trash page;
  * when the run ends the pool drains: free + prefix-indexed == usable.

The dense walk runs the eager step and the replay path (a stand-in graph
on the CPU, as ``tests/test_torch_fused_decode.py``), with the prefix
index on and prompts that share heads.  The swap walk overloads the
arena with the host-RAM tier on, so that slots are demoted and promoted
(a demoted slot holds no page; the store is empty when a walk ends).
``stream()`` is held against ``run()``, across preemptions and
demotions too."""

import dataclasses

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # no hypothesis installed
    from _hypothesis_fallback import given, settings, st

from repro_torch.models import build_model
from repro_torch.serving import fused, kv_cache, scheduler
from repro_torch.serving.kv_cache import PageAllocator
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

N_PAGES = 24


# ---------------------------------------------------------------------------
# The allocator against an independent refcount mirror.
# ---------------------------------------------------------------------------
def _allocator_walk(seed: int, n_actions: int = 60) -> None:
    rng = np.random.default_rng(seed)
    alloc = PageAllocator(N_PAGES)
    rc: dict[int, int] = {}              # mirror: page -> refcount
    held: list[int] = []                 # outstanding references

    for _ in range(n_actions):
        op = int(rng.integers(0, 3))
        if op == 0:                                      # alloc
            k = int(rng.integers(1, 7))
            got = alloc.alloc(k)
            if k > alloc.usable_pages - len(rc):
                assert got is None       # all or nothing
            else:
                assert got is not None and len(got) == len(set(got)) == k
                for p in got:
                    assert 0 < p < N_PAGES and p not in rc
                    rc[p] = 1
                held.extend(got)
        elif op == 1 and rc:                             # share live pages
            pick = [int(p) for p in
                    rng.choice(sorted(rc), size=int(rng.integers(1, 4)))]
            alloc.share(pick)
            for p in pick:
                rc[p] += 1
            held.extend(pick)
        elif op == 2 and held:                           # drop references
            rng.shuffle(held)
            k = int(rng.integers(1, 4))
            drop, held = held[:k], held[k:]
            alloc.free(drop)
            for p in drop:
                rc[p] -= 1
                if rc[p] == 0:
                    del rc[p]
        assert alloc.free_pages == alloc.usable_pages - len(rc)
        for p in range(1, N_PAGES):
            assert alloc.refcount(p) == rc.get(p, 0)

    alloc.free(held)
    assert alloc.free_pages == alloc.usable_pages


def test_allocator_mirror_bulk():
    """220 seeded sequences of 60 actions."""
    for seed in range(220):
        _allocator_walk(seed)


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.integers(min_value=5, max_value=160))
def test_allocator_mirror_property(seed, n_actions):
    _allocator_walk(seed, n_actions)


def test_misuse_raises():
    """A free past zero and a share of a free page raise (the reference
    asserts), and leave the pool as it was."""
    a = PageAllocator(4)
    (p,) = a.alloc(1)
    a.free([p])
    with pytest.raises(ValueError, match="double free"):
        a.free([p])
    with pytest.raises(ValueError, match="share of free"):
        a.share([p])
    assert a.free_pages == a.usable_pages


# ---------------------------------------------------------------------------
# Engine walks.
# ---------------------------------------------------------------------------
def indexed_pages(pc) -> list[int]:
    """Every page the radix index references (one node, one reference)."""
    out, stack = [], list(pc.root.children.values())
    while stack:
        node = stack.pop()
        out.append(node.page)
        stack.extend(node.children.values())
    return out


def _check_invariants(eng) -> None:
    alloc = eng.allocator
    held: dict[int, int] = {}
    for row in list(eng.slot_pages) + list(eng.slot_cross_pages):
        for p in row:
            held[p] = held.get(p, 0) + 1
    if eng.prefix_cache is not None:
        pages = indexed_pages(eng.prefix_cache)
        assert len(pages) == eng.prefix_cache.n_pages
        for p in pages:
            held[p] = held.get(p, 0) + 1
    for p in range(1, alloc.n_pages):
        assert alloc.refcount(p) == held.get(p, 0), f"page {p}"
    assert alloc.free_pages == alloc.usable_pages - len(held)
    table = eng.pool["page_table"].tolist()
    for slot, pages in enumerate(eng.slot_pages):
        if slot in eng._encoding:
            continue                     # its row is set when encoding ends
        assert table[slot][:len(pages)] == pages
        assert all(p == kv_cache.TRASH_PAGE for p in table[slot][len(pages):])


def _engine_walk(eng, seed, n_requests, rid0, *, frames_dim=None,
                 plen_lo=2, plen_hi=10, max_new_lo=1, max_new_hi=6,
                 heads=()):
    """Random open-loop traffic against a live engine: submissions
    interleave with decode bursts; the identities hold after every
    scheduler step.  A prompt starts with one of ``heads`` half the time
    (prefix hits).  Returns the next rid and the tokens by rid."""
    rng = np.random.default_rng(seed)
    vocab = eng.cfg.vocab
    rid, left, steps = rid0, n_requests, 0
    while (left or eng.pending or eng.active_slots() or eng._swapped
           or eng._encoding):
        # fill the slots before the first burst (concurrency makes the
        # page pressure), then trickle the rest in
        n_sub = (min(left, eng.n_slots) if steps == 0
                 else int(min(left, rng.integers(0, 2))))
        for _ in range(n_sub):
            plen = int(rng.integers(plen_lo, plen_hi))
            prompt = tuple(int(t) for t in rng.integers(0, vocab, plen))
            if heads and rng.random() < 0.5:
                prompt = heads[int(rng.integers(0, len(heads)))] + prompt
            eng.submit(Request(
                rid=rid, prompt=prompt,
                max_new_tokens=int(rng.integers(max_new_lo, max_new_hi)),
                frames=(rng.standard_normal((6, frames_dim))
                        .astype(np.float32)
                        if frames_dim is not None else None)))
            rid, left = rid + 1, left - 1
        eng.step()
        _check_invariants(eng)
        steps += 1
        assert steps < 600, "walk failed to converge"
    return rid


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


@pytest.fixture(scope="module")
def dense():
    m = build_model("qwen2.5-14b", reduced=True, device="cpu")
    return m, m.init(seed=0)


def _dense_walk(dense, monkeypatch, step, heads):
    """A tight pool (10 usable pages of 8 over 3 slots, as the reference's
    walk): the walks evict the prefix index.  With shared heads, 8 usable
    pages and budgets of 8-11 tokens they also hit it, copy on write and
    preempt at growth.  One
    engine serves every walk, so later walks start from a warm, partly
    indexed pool.  Returns the tokens by rid."""
    m, params = dense
    graph = _ReplayingGraph() if step == "replay" else None
    monkeypatch.setattr(scheduler, "graph_for", lambda dev, gen=None: graph)
    eng = ContinuousBatchingEngine(m, params, slots=3, max_len=32,
                                   page_size=8, pages=9 if heads else 11,
                                   temperature=0.0, seed=4)
    assert eng.prefix_cache is not None
    assert (eng._fused is not None) is (step == "replay")
    hrng = np.random.default_rng(99)
    shared = tuple(tuple(int(t) for t in hrng.integers(0, m.cfg.vocab, n))
                   for n in (8, 11)) if heads else ()
    rid = 0
    for seed in range(6):
        rid = _engine_walk(eng, seed, n_requests=6, rid0=rid, heads=shared,
                           **(dict(max_new_lo=8, max_new_hi=12) if heads
                              else {}))
        assert (eng.allocator.free_pages + eng.prefix_cache.n_pages
                == eng.allocator.usable_pages)
    st_ = eng.stats
    assert st_["admitted"] >= 36 and len(eng.completions) == 36
    assert st_["prefix_evictions"] > 0
    if heads:
        assert st_["prefix_hits"] > 0 and st_["cow_copies"] > 0
        assert st_["preempted"] > 0
    return [c.tokens for c in sorted(eng.completions, key=lambda c: c.rid)]


@pytest.mark.parametrize("heads", [False, True], ids=["random", "heads"])
@pytest.mark.parametrize("step", ["eager", "replay"])
def test_dense_engine_walk(dense, monkeypatch, step, heads):
    _dense_walk(dense, monkeypatch, step, heads)


def test_dense_walk_replay_equals_eager(dense, monkeypatch):
    """Slots whose table rows alias shared pages: the replay path's tokens
    are the eager path's."""
    eager = _dense_walk(dense, monkeypatch, "eager", True)
    assert _dense_walk(dense, monkeypatch, "replay", True) == eager


@pytest.mark.parametrize("page_dtype", [None, "int8"])
@pytest.mark.parametrize("step", ["eager", "replay"])
def test_swap_engine_walk(dense, monkeypatch, step, page_dtype):
    """An overloaded arena with the host-RAM tier on: prompts fill 3 pages
    of 16 and every budget crosses into a 4th, so three resident slots
    want 12 of the 9 usable pages and growth demotes.  The walks demote
    and promote, the identities hold after every step (a demoted request
    holds no page), and the tier balances when each walk ends."""
    m, params = dense
    graph = _ReplayingGraph() if step == "replay" else None
    monkeypatch.setattr(scheduler, "graph_for", lambda dev, gen=None: graph)
    eng = ContinuousBatchingEngine(m, params, slots=3, max_len=128,
                                   page_size=16, pages=10, temperature=0.0,
                                   seed=4, prefix_cache=False,
                                   host_swap_bytes=1 << 30,
                                   page_dtype=page_dtype)
    rid = 0
    for seed in range(3):
        rid = _engine_walk(eng, seed, n_requests=5, rid0=rid, plen_lo=44,
                           plen_hi=49, max_new_lo=10, max_new_hi=17)
        assert eng.stats["demoted"] == eng.stats["prefetched"]
        assert eng.allocator.free_pages == eng.allocator.usable_pages
        assert eng.host_swap.bytes_used == 0 and not eng._swapped
    assert eng.stats["demoted"] > 0 and eng.stats["preempted"] == 0
    assert len(eng.completions) == 15


def test_encdec_engine_walk():
    """encdec walks: cross pages are taken at admission and obey the same
    identities as self pages at every step (the cross table is one more
    reader), and the pool drains when the walk ends."""
    m = build_model("whisper-base", reduced=True, device="cpu")
    eng = ContinuousBatchingEngine(m, m.init(seed=0), slots=2, max_len=32,
                                   page_size=8, pages=8, temperature=0.0,
                                   seed=4, max_cross_len=8, enc_chunk=3)
    assert eng.prefix_cache is None
    rid = 0
    for seed in range(3):
        rid = _engine_walk(eng, seed, n_requests=4, rid0=rid,
                           frames_dim=m.cfg.d_model, plen_hi=8,
                           max_new_hi=5)
        assert eng.allocator.free_pages == eng.allocator.usable_pages
    assert eng.stats["admitted"] > 0


# ---------------------------------------------------------------------------
# stream()
# ---------------------------------------------------------------------------
def _requests(vocab, n, seed, head=(), plen=(3, 12), new=(2, 14)):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=head + tuple(int(t) for t in rng.integers(
        0, vocab, int(rng.integers(*plen)))),
        max_new_tokens=int(rng.integers(*new))) for i in range(n)]


def _streamed(eng, reqs):
    """Drain ``eng.stream(reqs)``: the tokens by rid, and the deltas."""
    got, deltas = {}, []
    for rid, toks in eng.stream(reqs):
        assert toks, "an empty delta"
        deltas.append((rid, toks))
        got.setdefault(rid, []).extend(toks)
    return got, deltas


@pytest.mark.parametrize("kw", [
    dict(), dict(paged=False), dict(eos_token=-1)],
    ids=["paged", "strip", "one-step-bursts"])
def test_stream_deltas_equal_run_tokens(dense, kw):
    m, params = dense
    head = tuple(range(30, 46))
    reqs = _requests(m.cfg.vocab, 7, seed=5, head=head)
    mk = dict(slots=3, max_len=48, page_size=8, temperature=0.0, **kw)
    want = ContinuousBatchingEngine(m, params, **mk).run(
        [dataclasses.replace(r) for r in reqs])
    eng = ContinuousBatchingEngine(m, params, **mk)
    got, deltas = _streamed(eng, [dataclasses.replace(r) for r in reqs])
    assert got == {c.rid: c.tokens for c in want}
    # the completions once the generator is spent are run()'s
    assert [(c.rid, c.tokens, c.reason) for c in eng.completions] == \
        [(c.rid, c.tokens, c.reason) for c in want]
    if kw.get("eos_token") == -1:            # a burst is one step: a
        assert len(deltas) > len(reqs)       # request streams in pieces


def test_stream_after_preemption_yields_no_token_twice(dense):
    """3 slots over 6 usable pages of 8: the slots cannot all grow, so
    requests are preempted and readmitted with their tokens in the
    prompt.  Their deltas still add up to run()'s tokens, each token
    once."""
    m, params = dense
    reqs = [Request(rid=i, prompt=tuple(range(3 + i, 14 + i)),
                    max_new_tokens=12) for i in range(4)]
    mk = dict(slots=3, max_len=48, page_size=8, pages=7, temperature=0.0,
              eos_token=-1)
    want = ContinuousBatchingEngine(m, params, **mk).run(
        [dataclasses.replace(r) for r in reqs])
    eng = ContinuousBatchingEngine(m, params, **mk)
    got, deltas = _streamed(eng, [dataclasses.replace(r) for r in reqs])
    assert eng.stats["preempted"] > 0
    assert got == {c.rid: c.tokens for c in want}
    assert all(len(got[r.rid]) == r.max_new_tokens for r in reqs)
    # a preempted request's carried tokens are not yielded again
    assert sum(len(t) for _, t in deltas) == sum(len(c.tokens)
                                                 for c in want)


def test_stream_through_demotions_yields_every_token_once(dense):
    """The same traffic with the host-RAM tier on: requests are demoted
    and promoted instead of preempted, and their deltas (a demoted
    request's view comes from the swap tier) add up to run()'s tokens,
    each token once."""
    m, params = dense
    reqs = [Request(rid=i, prompt=tuple(range(3 + i, 14 + i)),
                    max_new_tokens=12) for i in range(4)]
    mk = dict(slots=3, max_len=48, page_size=8, pages=7, temperature=0.0,
              eos_token=-1, prefix_cache=False, host_swap_bytes=1 << 30)
    want = ContinuousBatchingEngine(m, params, **mk).run(
        [dataclasses.replace(r) for r in reqs])
    eng = ContinuousBatchingEngine(m, params, **mk)
    got, deltas = _streamed(eng, [dataclasses.replace(r) for r in reqs])
    assert eng.stats["demoted"] == eng.stats["prefetched"] > 0
    assert eng.stats["preempted"] == 0
    assert got == {c.rid: c.tokens for c in want}
    assert sum(len(t) for _, t in deltas) == sum(len(c.tokens)
                                                 for c in want)


def test_stream_honours_arrivals_and_is_lazy(dense):
    """Nothing runs until the generator is iterated; with arrival times
    the first request streams before the last has arrived."""
    m, params = dense
    reqs = _requests(m.cfg.vocab, 3, seed=8, new=(4, 5))
    for i, r in enumerate(reqs):
        r.arrival_s = 0.05 * i
    eng = ContinuousBatchingEngine(m, params, slots=3, max_len=48,
                                   page_size=8, temperature=0.0)
    gen = eng.stream(reqs)
    assert eng.stats["admitted"] == 0 and not eng.pending
    first = next(gen)
    assert first[0] == 0 and eng.pending        # rid 2 not yet arrived
    rest = list(gen)
    assert {rid for rid, _ in [first] + rest} == {0, 1, 2}
    assert [len(c.tokens) for c in eng.completions] == [4, 4, 4]
