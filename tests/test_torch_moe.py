"""The moe family (granite-moe-3b-a800m) against the JAX package on the CPU,
with the same weights carried across through numpy
(``repro_torch.convert.params_from_jax``).

Reduced granite-moe (4 experts, top 2, d_expert 32), float32.  The layer
(``repro_torch/models/moe.py``): the router's weights, expert ids and
probabilities, ``moe_dense`` / ``moe_dispatch`` / ``moe_gather`` where the
capacity drops tokens, in groups and not, ``moe_apply`` with a shared
expert and the load-balance loss, all within ``ATOL`` 1e-5; tied router
probabilities give the reference's experts (lower id first).  The model:
prefill and decode logits within 1e-4 (as test_torch_models), greedy
tokens through the paged and strip pools ``==`` the JAX lockstep with
kernels off and on, and through the replay path with a stand-in graph.
Then the gates: deepseek-v2-lite-16b (multi-head latent attention, held
in tests/test_torch_mla.py) passes every serving gate, and both models
train through every entry point (a finite loss, batches of the cell's
shape, the CLI to its end; held against the reference in
tests/test_torch_moe_training.py and tests/test_torch_mla_training.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.serving import engine as jeng
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import Model, model_zoo, moe, transformer
from repro_torch.models import build_model as tbuild
from repro_torch.serving import fused, kv_cache, scheduler
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "granite-moe-3b-a800m"
MLA_ARCH = "deepseek-v2-lite-16b"
ATOL = 1e-5                     # the layer, float32
LOGIT_ATOL = 1e-4               # the model's logits, as test_torch_models
MAX_LEN = 48


def _convert(jp, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(scope="module")
def weights():
    jm = jbuild(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    assert cfg.moe.n_shared == 0
    assert dataclasses.asdict(jm.cfg.moe) == dataclasses.asdict(cfg.moe)
    return jm, jp, cfg, _convert(jp, cfg)


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["mlp"]),
            transformer.layer(tp["blocks"]["mlp"], 0))


def _kernels(cfg, use_kernels):
    return dataclasses.replace(cfg, use_kernels=use_kernels)


def _x(b=2, s=12, seed=0):
    x = np.random.default_rng(seed).standard_normal((b, s, 64)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# The layer.
# ---------------------------------------------------------------------------
def test_converted_tree_has_the_reference_layout(weights):
    _, jp, cfg, tp = weights
    mlp = tp["blocks"]["mlp"]
    assert set(mlp) == {"router", "wg", "wu", "wd"}
    assert mlp["router"]["w"].dtype == torch.float32
    assert tuple(mlp["wg"].shape) == (2, 4, 64, 32)
    assert tuple(mlp["wd"].shape) == (2, 4, 32, 64)
    # the port's own init has the same tree, the router float32 in bf16
    own = transformer.init_lm(cfg, device="cpu", dtype=torch.bfloat16)
    assert jax.tree.map(np.shape, jp) == _shapes(own)
    assert own["blocks"]["mlp"]["router"]["w"].dtype == torch.float32
    assert own["blocks"]["mlp"]["wg"].dtype == torch.bfloat16


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_router_matches_reference(weights, use_kernels):
    jm, jp, cfg, tp = weights
    jl, tl = _layer0(jp, tp)
    jx, tx = _x()
    jw, ji, jprobs = jmoe._router(jl, jx, _kernels(jm.cfg, use_kernels))
    tw, ti, tprobs = moe._router(tl, tx, _kernels(cfg, use_kernels))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)
    _close(tprobs, jprobs)
    assert tprobs.dtype == torch.float32 and tw.dtype == tx.dtype


def _drops(tp, cfg, tx, capacity_factor=1.25, group_size=2048):
    """(token, k) pairs past their expert's capacity, by the port's own
    queue order."""
    x = moe._groups(tx, group_size)
    cap = moe._capacity(x.shape[1], cfg, capacity_factor)
    _, idx, _ = moe._router(tp, x, cfg)
    return int((moe._queue_slots(idx, cfg.moe.n_experts)[1] >= cap).sum())


@pytest.mark.parametrize("kw,drops", [
    (dict(), False), (dict(capacity_factor=0.5), True),
    (dict(group_size=4), True), (dict(group_size=4, s=10), False),
    (dict(capacity_factor=0.5, group_size=4), True)],
    ids=["cap-1.25", "cap-0.5-drops", "groups-of-4", "10-tokens-no-groups",
         "groups-drops"])
@pytest.mark.parametrize("impl", ["dispatch", "gather"])
def test_capacity_dispatch_matches_reference(weights, impl, kw, drops):
    jm, jp, cfg, tp = weights
    jl, tl = _layer0(jp, tp)
    kw = dict(kw)
    s = kw.pop("s", 12)
    jx, tx = _x(s=s)
    if drops:
        assert _drops(tl, cfg, tx, **kw) > 0
    want = getattr(jmoe, f"moe_{impl}")(jl, jx, jm.cfg, **kw)
    got = getattr(moe, f"moe_{impl}")(tl, tx, cfg, **kw)
    assert got.shape == tx.shape
    _close(got, want)


def test_group_reshape_follows_the_reference_rule():
    x = torch.zeros((2, 12, 3))
    assert moe._groups(x, 4).shape == (6, 4, 3)
    assert moe._groups(x[:, :10], 4).shape == (2, 10, 3)   # no multiple
    assert moe._groups(x, 12).shape == (2, 12, 3)          # not longer
    assert moe._groups(x, 2048).shape == (2, 12, 3)


def test_dense_matches_reference_and_drops_nothing(weights):
    jm, jp, cfg, tp = weights
    jl, tl = _layer0(jp, tp)
    jx, tx = _x()
    _close(moe.moe_dense(tl, tx, cfg), jmoe.moe_dense(jl, jx, jm.cfg))
    # with room for every (token, k), dispatch is dropless and equal
    _close(moe.moe_dispatch(tl, tx, cfg, capacity_factor=2.0),
           moe.moe_dense(tl, tx, cfg).numpy())


def _tied(jl, tl, cols):
    """Layer weights whose router columns ``cols[1:]`` equal ``cols[0]``:
    those experts' probabilities tie exactly for every token."""
    w = np.array(jl["router"]["w"])
    w[:, cols[1:]] = w[:, cols[:1]]
    jt = dict(jl, router={"w": jnp.asarray(w)})
    tt = dict(tl, router={"w": torch.from_numpy(w)})
    return jt, tt


@pytest.mark.parametrize("cols", [(1, 3), (0, 1, 2, 3)],
                         ids=["pair", "all-four"])
def test_tied_router_probabilities_pick_the_reference_experts(weights, cols):
    jm, jp, cfg, tp = weights
    jl, tl = _tied(*_layer0(jp, tp), list(cols))
    jx, tx = _x()
    _, ji, _ = jmoe._router(jl, jx, jm.cfg)
    _, ti, tprobs = moe._router(tl, tx, cfg)
    assert bool((tprobs[..., cols[0]] == tprobs[..., cols[-1]]).all())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the tie decides the queue order too, and so the drops
    for impl in ("dispatch", "gather"):
        _close(getattr(moe, f"moe_{impl}")(tl, tx, cfg),
               getattr(jmoe, f"moe_{impl}")(jl, jx, jm.cfg))


def test_tie_rule_on_a_row_of_three_equal_probabilities(weights):
    """The row [0.1, 0.3, 0.3, 0.2, 0.3, 0.05] at top 2: the reference's
    ``top_k`` takes experts 1 and 2 (lower id first)."""
    jm, _, cfg, _ = weights
    m = dataclasses.replace(cfg.moe, n_experts=6, top_k=2)
    tc = dataclasses.replace(cfg, moe=m)
    jc = dataclasses.replace(jm.cfg, moe=dataclasses.replace(
        jm.cfg.moe, n_experts=6, top_k=2))
    row = np.log(np.array([0.1, 0.3, 0.3, 0.2, 0.3, 0.05], np.float32))
    w = np.zeros((64, 6), np.float32)
    w[0] = row
    x = np.zeros((1, 1, 64), np.float32)
    x[0, 0, 0] = 1.0
    _, ji, _ = jmoe._router({"router": {"w": jnp.asarray(w)}},
                            jnp.asarray(x), jc)
    _, ti, _ = moe._router({"router": {"w": torch.from_numpy(w)}},
                           torch.from_numpy(x), tc)
    assert np.asarray(ji)[0, 0].tolist() == [1, 2]
    assert ti[0, 0].tolist() == [1, 2]


@pytest.mark.parametrize("impl", ["dense", "dispatch", "gather"])
def test_moe_apply_with_a_shared_expert(impl):
    jm = jbuild(ARCH, reduced=True)
    jm.cfg = dataclasses.replace(jm.cfg, moe=dataclasses.replace(
        jm.cfg.moe, n_shared=1))
    assert jm.cfg.mla is None
    jp = jm.init(jax.random.PRNGKey(3))
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              moe=dataclasses.replace(
                                  get_config(ARCH).reduced().moe, n_shared=1))
    tp = _convert(jp, cfg)
    jl, tl = _layer0(jp, tp)
    assert set(tl["shared"]) == {"up", "down", "gate"}
    jx, tx = _x(seed=4)
    _close(moe.moe_apply(tl, tx, cfg, impl=impl),
           jmoe.moe_apply(jl, jx, jm.cfg, impl=impl))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_aux_load_balance_loss_matches_reference(weights, use_kernels):
    jm, jp, cfg, tp = weights
    jl, tl = _layer0(jp, tp)
    jx, tx = _x(seed=5)
    got = moe.aux_load_balance_loss(tl, tx, _kernels(cfg, use_kernels))
    want = jmoe.aux_load_balance_loss(jl, jx, _kernels(jm.cfg, use_kernels))
    assert got.shape == () and abs(float(got) - float(want)) <= ATOL


# ---------------------------------------------------------------------------
# The model and the engine.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["dispatch", "gather", "dense"])
def test_prefill_and_decode_logits_match_reference(weights, impl):
    jm, jp, cfg, tp = weights
    tm = Model(cfg, "cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 13)).astype(
        np.int32)
    jl, jc = jeng.prefill(jp, jnp.asarray(toks[:, :9]), cfg=jm.cfg,
                          max_len=MAX_LEN, moe_impl=impl)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :9]).long(),
                        max_len=MAX_LEN, moe_impl=impl)
    _close(tl, jl, LOGIT_ATOL)
    for t in range(9, 13):
        jl, jc = jeng.decode_step(jp, jc, jnp.asarray(toks[:, t]), t,
                                  cfg=jm.cfg, moe_impl=impl)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]).long(),
                                t, moe_impl=impl)
        _close(tl, jl, LOGIT_ATOL)
    assert set(tc) == {"k", "v"}                  # the dense cache


def _requests(vocab, seed=11):
    """The moe cells of tests/test_family_parity.py: four requests over
    two slots."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, vocab, n)), max_new_tokens=4 + i)
        for i, n in enumerate((3, 5, 7, 4))]


def _jax_greedy(jp, jcfg, req, impl):
    """The reference's batch-1 greedy lockstep (``engine.generate_timed``)
    under ``impl``; its own jits the prefill and step with the default
    impl, so this one calls them unjitted."""
    if impl == "dispatch":
        toks, _ = jeng.generate_timed(
            jp, jnp.asarray(req.prompt, jnp.int32)[None], cfg=jcfg,
            steps=req.max_new_tokens - 1, key=jax.random.PRNGKey(7),
            temperature=0.0, max_len=MAX_LEN)
        return [int(t) for t in np.asarray(toks)[0]]
    s = len(req.prompt)
    logits, cache = jeng.prefill(jp, jnp.asarray(req.prompt, jnp.int32)[None],
                                 cfg=jcfg, max_len=MAX_LEN, moe_impl=impl)
    out = [int(jnp.argmax(logits[0, :jcfg.vocab]))]
    for i in range(req.max_new_tokens - 1):
        logits, cache = jeng.decode_step(
            jp, cache, jnp.asarray(out[-1:], jnp.int32), s + i, cfg=jcfg,
            moe_impl=impl)
        out.append(int(jnp.argmax(logits[0, :jcfg.vocab])))
    return out


@pytest.fixture(scope="module")
def jax_lockstep(weights):
    jm, jp, _, _ = weights
    memo = {}

    def run(use_kernels: bool, impl: str = "dispatch"):
        if (use_kernels, impl) not in memo:
            jcfg = _kernels(jm.cfg, use_kernels)
            memo[use_kernels, impl] = [_jax_greedy(jp, jcfg, r, impl)
                                       for r in _requests(jcfg.vocab)]
        return memo[use_kernels, impl]

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
    # exact prompt lengths: capacity comes from the prompt's length
    assert eng._prefill_shapes == {3, 5, 7, 4}


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_other_impls_match_their_jax_lockstep(weights, jax_lockstep, impl):
    """The engine's prefills and steps under ``impl`` against the
    reference's lockstep with the same prefill impl.  The 3-token prompt
    has one slot an expert (cap 1), so dispatch and gather drop there and
    dense does not: dense gives other tokens."""
    _, _, cfg, tp = weights
    eng = ContinuousBatchingEngine(Model(cfg, "cpu"), tp, slots=2,
                                   max_len=MAX_LEN, page_size=8,
                                   temperature=0.0, moe_impl=impl)
    got = _tokens(eng.run(_requests(cfg.vocab)))
    assert got == jax_lockstep(False, impl)
    assert (got == jax_lockstep(False)) is (impl == "gather")


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
    assert {"/pool/kv/k", "/pool/kv/v", "/pool/lengths", "/tokens",
            "/active", "/params/blocks/mlp/router/w",
            "/params/blocks/mlp/wg"} <= want.keys()
    for r in _requests(cfg.vocab):
        eng.submit(r)
    eng._run_start = 0.0
    bursts = 0
    while eng.pending or eng.active_slots():
        bursts += eng.step()
        assert fused._ptrs(eng.step_buffers()) == want
    eng.completions.sort(key=lambda c: c.rid)
    assert _tokens(eng.completions) == jax_lockstep(False)
    st = eng.stats
    assert graphs[0].warm_ups == 2 and st["admitted"] > eng.n_slots
    assert graphs[0].replays == eng._fused.replays == st["steps"] > bursts


@pytest.mark.parametrize("impl,exc,match", [
    ("dispatch", ValueError, "capacity dispatch"),
    ("gather", ValueError, "capacity dispatch")])
def test_prefix_cache_true_is_refused(weights, impl, exc, match):
    _, _, cfg, tp = weights
    with pytest.raises(exc, match=match):
        ContinuousBatchingEngine(Model(cfg, "cpu"), tp, slots=2,
                                 max_len=MAX_LEN, prefix_cache=True,
                                 moe_impl=impl)
    eng = ContinuousBatchingEngine(Model(cfg, "cpu"), tp, slots=2,
                                   max_len=MAX_LEN, moe_impl=impl)
    assert eng.prefix_cache is None             # "auto" resolves off


def test_prefix_cache_serves_under_the_dense_impl(weights):
    """``moe_impl="dense"`` routes each token alone, so a tail prefills
    exactly after shared pages: True is taken, "auto" resolves on, and
    the hits' tokens are the reference lockstep's under dense."""
    jm, jp, cfg, tp = weights
    head = tuple(range(5, 21))                    # two pages of 8
    reqs = [Request(rid=i, prompt=head + (30 + i, 40 + i), max_new_tokens=4)
            for i in range(3)]
    for pc in (True, "auto"):
        eng = ContinuousBatchingEngine(Model(cfg, "cpu"), tp, slots=2,
                                       max_len=MAX_LEN, page_size=8,
                                       temperature=0.0, moe_impl="dense",
                                       prefix_cache=pc)
        got = _tokens(eng.run([dataclasses.replace(r) for r in reqs]))
        th = eng.throughput()
        assert th["prefix_hits"] == 2 and th["prefix_tokens_reused"] == 32
        assert got == [_jax_greedy(jp, jm.cfg, r, "dense") for r in reqs]


# ---------------------------------------------------------------------------
# Full width on the meta device.
# ---------------------------------------------------------------------------
def test_full_width_shapes_match_reference():
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    assert cfg.param_count() == jcfg.param_count()
    assert round(cfg.param_count() / 1e9, 2) == 3.37
    tm = tbuild(ARCH, device="meta")
    got = tm.init_shape()
    want = jax.eval_shape(lambda: jbuild(ARCH).init(jax.random.PRNGKey(0)))
    assert _shapes(got) == jax.tree.map(lambda s: tuple(s.shape), want)
    assert got["blocks"]["mlp"]["router"]["w"].dtype == torch.float32
    cache = tm.init_cache(32, 4160, ring=False)
    assert tuple(cache["k"].shape) == (32, 32, 4160, 8, 64)
    assert kv_cache.supports_paging(cfg)


# ---------------------------------------------------------------------------
# The gates.
# ---------------------------------------------------------------------------
def _mla():
    return tbuild(MLA_ARCH, reduced=True, device="cpu")


@pytest.mark.parametrize("gate", [
    "init_lm", "init_cache", "slot_pool", "paged_pool", "decode_specs",
    "convert", "training", "synthetic_batches"])
def test_mla_passes_the_serving_gates_and_trains(gate):
    m = _mla()
    assert m.cfg.family == "moe" and m.cfg.mla is not None
    calls = {
        "init_lm": lambda: m.init(0),
        "init_cache": lambda: m.init_cache(2, 16),
        "slot_pool": lambda: m.init_slot_pool(2, 16),
        "paged_pool": lambda: kv_cache.init_paged_pool(
            m.cfg, 2, 16, page_size=8, device="cpu"),
        "decode_specs": lambda: model_zoo.input_specs(
            get_config(MLA_ARCH), "decode_32k"),
        "convert": lambda: _convert(
            jbuild(MLA_ARCH, reduced=True).init(jax.random.PRNGKey(0)),
            m.cfg),
        "training": lambda: transformer.train_loss(
            m.init(0), {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
            cfg=m.cfg),
        "synthetic_batches": lambda: SyntheticLM(
            m.cfg, ShapeCell("t", 16, 2, "train")).batch_at(0),
    }
    out = calls[gate]()
    if gate == "training":
        assert out.shape == () and torch.isfinite(out)
        return
    if gate == "synthetic_batches":
        assert set(out) == {"tokens"} and out["tokens"].shape == (2, 16)
        return
    leaves = out if isinstance(out, dict) else {}
    if gate in ("init_cache", "decode_specs"):
        leaves = out["cache"] if gate == "decode_specs" else out
        assert set(leaves) == {"c", "kr"}          # the latent cache
    if gate in ("slot_pool", "paged_pool"):
        assert set(out["kv"]) == {"c", "kr"}
    if gate in ("init_lm", "convert"):
        assert set(out["blocks"]["attn"]) == {"wq", "wkv_a", "kv_norm",
                                              "wkv_b", "wo"}


def _final_loss(out):
    final = [ln for ln in out.splitlines() if ln.startswith("final: ")]
    assert len(final) == 1
    return float(final[0].split("'loss': ")[1].split(",")[0])


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_cli_serves_and_trains_mla(cli, capsys):
    argv = ["--arch", MLA_ARCH, "--reduced", "--device", "cpu"]
    if cli == "serve":
        serve.main(argv + ["--requests", "3", "--slots", "2",
                           "--prompt-len", "12", "--steps", "4",
                           "--temperature", "0"])
        out = capsys.readouterr().out
        assert f"{MLA_ARCH}: served 3 requests over 2 slots / paged" in out
        assert "prefill: 36 tok" in out and "decode:  9 tok" in out
        return
    train_cli.main(argv + ["--steps", "1", "--seq", "16", "--batch", "2"])
    assert np.isfinite(_final_loss(capsys.readouterr().out))


@pytest.mark.parametrize("gate", ["train_loss", "model_loss",
                                  "synthetic_batches", "cli"])
def test_moe_trains_through_every_entry_point(weights, gate, capsys):
    _, _, cfg, tp = weights
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64)}
    if gate == "cli":
        train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "1", "--seq", "16", "--batch", "2"])
        assert np.isfinite(_final_loss(capsys.readouterr().out))
        return
    calls = {
        "train_loss": lambda: transformer.train_loss(tp, batch, cfg=cfg),
        "model_loss": lambda: Model(cfg, "cpu").loss(tp, batch),
        "synthetic_batches": lambda: SyntheticLM(
            cfg, SHAPES["train_4k"]).batch_at(0),
    }
    out = calls[gate]()
    if gate == "synthetic_batches":
        assert set(out) == {"tokens"}
        assert out["tokens"].shape == (SHAPES["train_4k"].global_batch,
                                       SHAPES["train_4k"].seq_len)
        assert 0 <= out["tokens"].min() <= out["tokens"].max() < cfg.vocab
        return
    assert out.shape == () and torch.isfinite(out)
