"""The fused decode step on the CPU: the engine's static-buffer step gives
greedy tokens equal to the JAX lockstep loop with the same weights (paged
and strip, under preemption and backfill, with run-ahead bursts), through
the eager step and through the replay path with a stand-in graph; the
buffers a captured graph reads are never rebound; a graph's launches are
counted once per replay; and a CPU engine asked to fuse steps eagerly
without touching ``torch.cuda``.  The CUDA graph itself is held on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.serving import engine as jeng
from repro_torch import kernels as tk
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.models import Model
from repro_torch.models import build_model as tbuild
from repro_torch.serving import engine as teng
from repro_torch.serving import fused, scheduler
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


@pytest.fixture(scope="module")
def jax_lockstep(weights):
    """Greedy JAX lockstep tokens of a request, cached by (prompt, new
    tokens, kernels)."""
    jm, jp, _, _ = weights
    memo = {}

    def run(req: Request, use_kernels: bool = False) -> list[int]:
        key = (req.prompt, req.max_new_tokens, use_kernels)
        if key not in memo:
            jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
            toks, _ = jeng.generate_timed(
                jp, jnp.asarray(req.prompt, jnp.int32)[None], cfg=jcfg,
                steps=req.max_new_tokens - 1, key=jax.random.PRNGKey(7),
                temperature=0.0, max_len=MAX_LEN)
            memo[key] = [int(t) for t in np.asarray(toks)[0]]
        return memo[key]

    return run


def _requests(vocab, n, seed=11, plens=(2, 9, 5, 11, 7), new=None):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, vocab, plens[i % len(plens)])),
        max_new_tokens=new or 4 + i) for i in range(n)]


def _copy(reqs):
    return [dataclasses.replace(r) for r in reqs]


def _tokens(comps):
    return [list(c.tokens) for c in sorted(comps, key=lambda c: c.rid)]


class ReplayingGraph:
    """A stand-in for ``fused.CudaGraph`` on the CPU: capture keeps the
    step and replay runs it, as the card runs the captured launches."""

    pool_bytes = 0

    def __init__(self):
        self.step = None
        self.warm_ups = 0
        self.replays = 0

    def warm_up(self, step):
        for _ in range(fused.CudaGraph.WARMUP):
            step()
            self.warm_ups += 1

    def capture(self, step):
        self.step = step

    def replay(self):
        self.replays += 1
        self.step()


@pytest.fixture
def stand_in(monkeypatch):
    """Engines built on the CPU capture into a :class:`ReplayingGraph`."""
    graphs = []

    def graph_for(device, generator=None):
        graphs.append(ReplayingGraph())
        return graphs[-1]

    monkeypatch.setattr(scheduler, "graph_for", graph_for)
    return graphs


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_static_buffer_step_matches_jax_lockstep(weights, jax_lockstep,
                                                 paged, use_kernels):
    _, _, tm, tp = weights
    tm = Model(dataclasses.replace(tm.cfg, use_kernels=use_kernels), "cpu")
    reqs = _requests(tm.cfg.vocab, n=5)
    eng = ContinuousBatchingEngine(tm, tp, slots=3, max_len=MAX_LEN,
                                   page_size=8, temperature=0.0, paged=paged)
    assert eng._fused is None                  # the CPU steps eagerly
    got = _tokens(eng.run(_copy(reqs)))
    assert got == [jax_lockstep(r, use_kernels) for r in reqs]
    assert eng.throughput()["admitted"] == 5 > eng.n_slots


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "stand-in"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_preemption_backfill_and_runahead_match_jax_lockstep(
        weights, jax_lockstep, request, paged, graph):
    _, _, tm, tp = weights
    graphs = request.getfixturevalue("stand_in") if graph else []
    reqs = _requests(tm.cfg.vocab, n=5, plens=(11, 12, 13, 9, 10), new=12)
    # paged: 3 slots over 6 usable 8-token pages cannot all grow
    eng = ContinuousBatchingEngine(tm, tp, slots=3, max_len=MAX_LEN,
                                   page_size=8, pages=7 if paged else None,
                                   temperature=0.0, paged=paged)
    for r in _copy(reqs):
        eng.submit(r)
    eng._run_start = 0.0
    bursts = 0
    while eng.pending or eng.active_slots():
        bursts += eng.step()
    eng.completions.sort(key=lambda c: c.rid)
    assert _tokens(eng.completions) == [jax_lockstep(r) for r in reqs]
    st = eng.stats
    assert st["admitted"] > eng.n_slots                 # backfill
    assert st["preempted"] > 0 if paged else st["preempted"] == 0
    assert st["steps"] > bursts                         # runahead > 1
    if graph:
        assert eng._fused is not None and graphs[0].warm_ups == 2
        assert graphs[0].replays == eng._fused.replays == st["steps"]
        assert eng.throughput()["fused"] is True


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_step_buffers_and_pool_are_never_rebound(weights, stand_in, paged):
    _, _, tm, tp = weights
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   page_size=8, temperature=0.0, paged=paged)
    want = fused._ptrs(eng.step_buffers())
    assert {"/tokens", "/active", "/pool/lengths",
            "/pool/kv/k"} <= want.keys()
    assert ("/pool/page_table" in want) is paged
    history = eng._history.data_ptr()
    for r in _copy(_requests(tm.cfg.vocab, n=4)):
        eng.submit(r)
    eng._run_start = 0.0
    while eng.pending or eng.active_slots():
        eng.step()
        assert fused._ptrs(eng.step_buffers()) == want
        assert eng._history.data_ptr() == history
    assert eng._fused.replays == eng.stats["steps"] > 0


def test_a_rebound_buffer_stops_the_replay(weights, stand_in):
    _, _, tm, tp = weights
    eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                   page_size=8, temperature=0.0)
    eng.pool["lengths"] = eng.pool["lengths"].clone()
    with pytest.raises(RuntimeError, match="/pool/lengths"):
        eng.run(_copy(_requests(tm.cfg.vocab, n=2)))


class RecordingGraph:
    """A stand-in whose capture calls the step once, as capture calls every
    wrapper once, and whose replay runs no Python: the card replays the
    launches."""

    pool_bytes = 0

    def __init__(self):
        self.calls = []

    def warm_up(self, step):
        step()
        self.calls.append("warm_up")

    def capture(self, step):
        step()
        self.calls.append("capture")

    def replay(self):
        self.calls.append("replay")


def test_launch_accounting_is_the_captures_counts_times_replays():
    tk.reset_launch_counts()
    per_step = {"decode_attention_paged": 3, "twopass_softmax_2d": 1}

    def step():
        for name, n in per_step.items():
            tk.WRAPPERS[name].launches += n

    graph = RecordingGraph()
    fs = fused.FusedStep(step, graph, {})
    # the warm-up's launches ran; the capture's did not
    assert tk.launch_counts() == {k: per_step.get(k, 0)
                                  for k in tk.WRAPPERS}
    assert fs.launches == per_step
    tk.reset_launch_counts()
    for _ in range(7):
        fs()
    assert graph.calls == ["warm_up", "capture"] + ["replay"] * 7
    assert fs.replays == 7
    assert tk.launch_counts() == {k: 7 * per_step.get(k, 0)
                                  for k in tk.WRAPPERS}
    info = fs.info()
    assert info["launches_per_replay"] == per_step
    assert info["capture_s"] >= 0 and info["graph_pool_bytes"] == 0
    tk.reset_launch_counts()


def test_fused_on_the_cpu_steps_eagerly_without_torch_cuda(
        weights, jax_lockstep, monkeypatch):
    _, _, tm, tp = weights

    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda reached on the CPU")

    for name in ("CUDAGraph", "graph", "Stream", "stream", "synchronize",
                 "current_stream", "memory_reserved", "device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    reqs = _requests(tm.cfg.vocab, n=3)
    for paged in (True, False):
        eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                       page_size=8, temperature=0.0,
                                       paged=paged, fused=True)
        assert eng._fused is None
        assert _tokens(eng.run(_copy(reqs))) == [jax_lockstep(r)
                                                 for r in reqs]
        assert eng.throughput()["fused"] is False
    assert fused.graph_for("cpu") is None


def test_fused_sampling_is_seeded(weights, stand_in):
    _, _, tm, tp = weights
    reqs = _requests(tm.cfg.vocab, n=4)
    runs = []
    for _ in range(2):
        eng = ContinuousBatchingEngine(tm, tp, slots=2, max_len=MAX_LEN,
                                       temperature=0.8, seed=9)
        assert eng._fused is not None
        runs.append(_tokens(eng.run(_copy(reqs))))
    assert runs[0] == runs[1]
    assert all(0 <= t < tm.cfg.vocab for x in runs[0] for t in x)


def test_the_sampler_draws_as_torch_multinomial():
    g0 = torch.Generator().manual_seed(5)
    g1 = torch.Generator().manual_seed(5)
    logits = torch.from_numpy(np.random.default_rng(3).normal(
        size=(8, 500)).astype(np.float32) * 4)
    probs = DEFAULT_POLICY.softmax(logits / 0.8)
    for _ in range(50):
        want = torch.multinomial(probs, 1, generator=g0)[:, 0]
        got = teng.sample_token(logits, g1, 0.8, policy=DEFAULT_POLICY)
        assert torch.equal(got, want)
