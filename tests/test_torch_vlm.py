"""The port's vlm family (qwen2-vl-7b) against the JAX package on the CPU:
M-RoPE, the stubbed patch prefix, the model and its serving, with the same
weights carried across through numpy (reduced qwen2-vl-7b: 2 layers, 4
query heads over 2 KV heads of 16, sections (2, 3, 3), 8 patches on a grid
of 3, float32).

Two behaviours of the reference are pinned here as they are, not fixed,
because the reference's tokens are the oracle:
  * decode gives every M-RoPE stream the raw cache length, while the
    prefill put token ``idx >= n_patches`` at ``idx - n_patches + grid``:
    the first decoded token jumps ``n_patches - grid`` positions past the
    last prefilled one;
  * the lockstep ``generate`` with patches decodes at ``s + i``, ``s`` the
    TEXT length: the first step overwrites cache row ``s``, inside the
    prefix, and attends rows ``0 .. s`` only.

Tolerances: the RoPE tables 1e-6 (float32 angles, the same products);
logits ``ATOL`` 1e-4, as test_torch_models; greedy tokens ``==``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.serving import engine as jeng
from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.serving import engine as teng
from repro_torch.serving.scheduler import Request

ARCH = "qwen2-vl-7b"
ATOL = 1e-4
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


def _patches(cfg, b, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# M-RoPE.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (16, (2, 3, 3))],
                         ids=["full", "reduced"])
def test_rope_cos_sin_with_sections_matches_reference(head_dim, sections):
    pos = np.random.default_rng(2).integers(0, 5000, (3, 2, 11)).astype(
        np.int32)
    want = jlayers.rope_cos_sin(jnp.asarray(pos), head_dim, 1e6,
                                sections=sections)
    got = tlayers.rope_cos_sin(torch.from_numpy(pos), head_dim, 1e6,
                               sections=sections)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 11, head_dim // 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    with pytest.raises(ValueError, match="M-RoPE positions"):
        tlayers.rope_cos_sin(torch.zeros((2, 11), dtype=torch.int32),
                             head_dim, 1e6, sections=sections)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("s,start", [(300, 0), (5, 250), (40, 0), (7, 3)])
def test_positions_match_reference_on_both_sides_of_the_patches(reduced, s,
                                                                 start):
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = ttr._positions_for(cfg, 2, s, start)
    want = jtr._positions_for(jcfg, 2, s, start)
    assert tuple(got.shape) == (3, 2, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = torch.arange(s) + start
    np.testing.assert_array_equal(
        ttr._positions_at(cfg, 2, idx).numpy(),
        np.asarray(jtr._positions_at(jcfg, 2, jnp.asarray(idx.numpy()))))


def test_decode_position_jumps_past_the_prefill_as_the_reference():
    """A prompt of L = n_patches + s rows: the prefill's last row sits at
    L - 1 - n_patches + grid on all three streams, decode's first token at
    L (the raw cache length): n_patches - grid + 1 apart, 241 at full
    width.  The port's decode tables equal the reference's."""
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    n, grid = cfg.n_patches, 16
    length = n + 512
    last = ttr._positions_for(cfg, 1, length)[:, 0, -1]
    assert last.tolist() == [length - 1 - n + grid] * 3
    pos = torch.tensor([length, 7])
    got = teng._cos_sin_at(cfg, pos, 2)
    want = jeng._cos_sin_at(jcfg, jnp.asarray(pos.numpy()), 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    plain = tlayers.rope_cos_sin(pos.reshape(2, 1), 128, cfg.rope_theta)
    for g, p in zip(got, plain):           # every stream at the position
        assert torch.equal(g, p)
    assert length - int(last[0]) == n - grid + 1 == 241


# ---------------------------------------------------------------------------
# The model with patches.
# ---------------------------------------------------------------------------
def test_converted_tree_has_patch_proj(weights):
    jm, jp, tm, tp = weights
    assert tuple(tp["patch_proj"]["w"].shape) == (tm.cfg.d_model,) * 2
    tree = jax.tree.map(np.asarray, jp)
    del tree["patch_proj"]
    with pytest.raises(ValueError, match="patch_proj"):
        params_from_jax(tree, tm.cfg, device="cpu")


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("with_patches", [True, False],
                         ids=["patches", "text"])
def test_forward_and_prefill_logits_match_reference(weights, use_kernels,
                                                    with_patches):
    jm, jp, tm, tp = weights
    jcfg = _kernels(jm.cfg, use_kernels)
    tm = Model(_kernels(tm.cfg, use_kernels), "cpu")
    toks = _tokens(2, 13)
    pat = _patches(tm.cfg, 2)
    jkw = dict(patches=jnp.asarray(pat)) if with_patches else {}
    tkw = dict(patches=torch.from_numpy(pat)) if with_patches else {}
    want = jtr.forward(jp, jnp.asarray(toks), cfg=jcfg, **jkw)
    got = tm.forward(tp, torch.from_numpy(toks).long(), **tkw)
    assert got.shape[1] == 13 + (8 if with_patches else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    jl, jc = jeng.prefill(jp, jnp.asarray(toks), cfg=jcfg, max_len=16,
                          **jkw)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks).long(), max_len=16,
                        **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # max_len grows to cover the patches, as the reference's
    assert tc["k"].shape == np.asarray(jc["k"]).shape
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL)


def test_first_lockstep_step_overwrites_row_s_inside_the_prefix(weights):
    """``generate`` with patches decodes at ``s + i``: the first step
    writes row s (here a patch row: s 5 < n_patches 8) and attends rows
    0 .. s, whatever the rows after hold.  Its logits equal the
    reference's decode step at s."""
    jm, jp, tm, tp = weights
    s = 5
    toks, pat = _tokens(2, s + 1, seed=3), _patches(tm.cfg, 2, seed=4)
    jl, jc = jeng.prefill(jp, jnp.asarray(toks[:, :s]), cfg=jm.cfg,
                          max_len=s + 4, patches=jnp.asarray(pat))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :s]).long(),
                        max_len=s + 4, patches=torch.from_numpy(pat))
    assert tc["k"].shape[2] == s + tm.cfg.n_patches
    before = tc["k"].clone()
    tok = torch.from_numpy(toks[:, s]).long()
    jl, jc = jeng.decode_step(jp, jc, jnp.asarray(toks[:, s]), s,
                              cfg=jm.cfg)
    tl, tc = tm.decode_step(tp, tc, tok, s)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert not torch.equal(tc["k"][:, :, s], before[:, :, s])
    rows = [r for r in range(tc["k"].shape[2]) if r != s]
    assert torch.equal(tc["k"][:, :, rows], before[:, :, rows])
    # rows past s are not read: garbage there leaves the logits alone
    for name in ("k", "v"):
        tc[name][:, :, s + 1:] = 1e4
    again, _ = tm.decode_step(tp, tc, tok, s)
    assert torch.equal(again, tl)


# ---------------------------------------------------------------------------
# Serving: greedy tokens against the JAX lockstep.
# ---------------------------------------------------------------------------
def _requests(vocab, seed=11):
    """The vlm cells of tests/test_family_parity.py (text-only requests,
    as the reference's engine takes them)."""
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


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_greedy_tokens_match_jax_lockstep(weights, jax_lockstep, paged,
                                          use_kernels):
    _, _, tm, tp = weights
    tm = Model(_kernels(tm.cfg, use_kernels), "cpu")
    eng = tm.serving_engine(tp, slots=2, max_len=MAX_LEN, page_size=8,
                            paged=paged, temperature=0.0, seed=3)
    assert eng.buckets is not None             # vlm prompts are bucketed
    got = [list(c.tokens) for c in sorted(eng.run(_requests(tm.cfg.vocab)),
                                          key=lambda c: c.rid)]
    assert got == jax_lockstep(use_kernels)
    st = eng.throughput()
    assert st["paged"] is paged and st["admitted"] == 4


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_lockstep_generate_with_patches_matches_reference(weights,
                                                          use_kernels):
    """The serving CLI's vlm path: lockstep ``generate_timed`` with patch
    inputs, through the ``Model`` facade."""
    jm, jp, tm, tp = weights
    jcfg = _kernels(jm.cfg, use_kernels)
    tm = Model(_kernels(tm.cfg, use_kernels), "cpu")
    toks, pat = _tokens(3, 6, seed=5), _patches(tm.cfg, 3, seed=6)
    want, jst = jeng.generate_timed(
        jp, jnp.asarray(toks), cfg=jcfg, steps=7, key=jax.random.PRNGKey(7),
        temperature=0.0, max_len=6 + 7 + 8, patches=jnp.asarray(pat))
    got, st = teng.generate_timed(
        tp, torch.from_numpy(toks).long(), cfg=tm.cfg, steps=7,
        temperature=0.0, max_len=6 + 7 + 8, patches=torch.from_numpy(pat))
    assert got.tolist() == np.asarray(want).tolist()
    assert (st["prefill_tokens"], st["decode_tokens"]) == (
        jst["prefill_tokens"], jst["decode_tokens"]) == (18, 21)
    again = tm.generate(tp, torch.from_numpy(toks).long(), steps=7,
                        temperature=0.0, max_len=21,
                        patches=torch.from_numpy(pat))
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# Shapes and the training gate.
# ---------------------------------------------------------------------------
def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def test_full_width_parameters_match_reference():
    got = tbuild(ARCH, device="meta").init_shape()
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                        jbuild(ARCH).init_shape())
    assert _shapes(got) == want
    assert tuple(got["patch_proj"]["w"].shape) == (3584, 3584)


def test_training_refuses_naming_item_31(weights):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.trainer import Trainer, TrainerConfig

    _, _, tm, tp = weights
    batch = {"tokens": torch.from_numpy(_tokens(2, 9)).long()}
    with pytest.raises(NotImplementedError, match="item 31"):
        tm.loss(tp, batch)
    with pytest.raises(NotImplementedError, match="item 31"):
        SyntheticLM(tm.cfg, SHAPES["train_4k"])
    with pytest.raises(NotImplementedError, match="item 31"):
        Trainer(tm, SHAPES["train_4k"], TrainerConfig(steps=1))
