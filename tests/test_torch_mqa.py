"""granite-20b's multi-query attention (48 query heads over one KV head at
full width) against the JAX package on the CPU.  ``ModelConfig.reduced()``
gives every arch two KV heads, so the reduced config here sets
``n_kv_heads=1`` on both sides (4 query heads over one KV head: G 4, the
whole group on one KV head as at full width), with the same weights carried
across through numpy.  Logits: ``ATOL`` 1e-4, as test_torch_models; greedy
tokens: ``==``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.serving import engine as jeng
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.scheduler import Request

ARCH = "granite-20b"
ATOL = 1e-4
MAX_LEN = 48


@pytest.fixture(scope="module")
def weights():
    jm = jbuild(ARCH, reduced=True)
    jm.cfg = dataclasses.replace(jm.cfg, n_kv_heads=1)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_kv_heads=1)
    assert jp["blocks"]["attn"]["wk"]["w"].shape[-1] == cfg.head_dim
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, cfg, tp


def _model(cfg, use_kernels):
    return Model(dataclasses.replace(cfg, use_kernels=use_kernels), "cpu")


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_decode_logits_match_reference(weights, use_kernels):
    jm, jp, cfg, tp = weights
    jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
    tm = _model(cfg, use_kernels)
    toks = np.random.default_rng(2).integers(0, 256, (2, 13)).astype(
        np.int32)
    jl, jc = jeng.prefill(jp, jnp.asarray(toks[:, :9]), cfg=jcfg,
                          max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :9]).long(),
                        max_len=MAX_LEN)
    assert tc["k"].shape[3] == 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for t in range(9, 13):
        jl, jc = jeng.decode_step(jp, jc, jnp.asarray(toks[:, t]), t,
                                  cfg=jcfg)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, t]).long(),
                                t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"step {t}")


def _requests(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, vocab, n)), max_new_tokens=m)
        for i, (n, m) in enumerate(((6, 12), (12, 8), (9, 10), (7, 11)))]


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_greedy_tokens_match_jax_lockstep(weights, paged, use_kernels):
    jm, jp, cfg, tp = weights
    jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
    reqs = _requests(cfg.vocab)
    ref = []
    for r in reqs:
        toks, _ = jeng.generate_timed(
            jp, jnp.asarray(r.prompt, jnp.int32)[None], cfg=jcfg,
            steps=r.max_new_tokens - 1, key=jax.random.PRNGKey(7),
            temperature=0.0, max_len=MAX_LEN)
        ref.append([int(t) for t in np.asarray(toks)[0]])
    eng = _model(cfg, use_kernels).serving_engine(
        tp, slots=2, max_len=MAX_LEN, page_size=8, paged=paged,
        temperature=0.0)
    comps = sorted(eng.run([dataclasses.replace(r) for r in reqs]),
                   key=lambda c: c.rid)
    assert [list(c.tokens) for c in comps] == ref
    assert eng.throughput()["paged"] is paged


def test_full_width_cache_is_26_6_kb_a_token():
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    assert cfg.n_heads // cfg.n_kv_heads == 48
    per_token = tkv.cache_bytes(cfg, 1, 2) - tkv.cache_bytes(cfg, 1, 1)
    assert per_token == 52 * 2 * 1 * 128 * 2 == 26_624
    assert tkv.cache_bytes(cfg, 8, 1664) == jkv.cache_bytes(jcfg, 8, 1664)
    assert cfg.param_count() == jcfg.param_count()
    assert round(cfg.param_count() / 1e9, 2) == 28.17
