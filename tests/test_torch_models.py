"""The port's dense model against the JAX package on the CPU, with the same
weights carried across through numpy (reduced qwen2.5-14b, float32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import transformer as jtr
from repro.serving import engine as jeng
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer as ttr
from repro_torch.serving import engine as teng

ARCH = "qwen2.5-14b"
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = jbuild(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(ARCH, reduced=True, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def test_configs_reduce_exactly_as_the_reference():
    from repro.configs import ARCH_IDS, get_config as jget

    for arch in ARCH_IDS:
        jc, tc = jget(arch).reduced(), get_config(arch).reduced()
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc), arch


def test_converter_round_trips(models):
    _, jp, tm, tp = models
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tp["blocks"]["attn"]["wq"]["w"].shape[0] == tm.cfg.n_layers
    with pytest.raises(ValueError, match="embed"):
        bad = jax.tree.map(np.asarray, jp)
        bad["embed"]["table"] = bad["embed"]["table"][:-1]
        params_from_jax(bad, tm.cfg, device="cpu")


def test_forward_logits(models):
    jm, jp, tm, tp = models
    tok = _tokens(2, 11)
    hj = jtr.forward(jp, jnp.asarray(tok), cfg=jm.cfg)
    want = np.asarray(jtr.lm_logits(jp, hj, cfg=jm.cfg))
    ht = ttr.forward(tp, torch.from_numpy(tok), cfg=tm.cfg)
    got = ttr.lm_logits(tp, ht, cfg=tm.cfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_step(models, use_kernels):
    jm, jp, tm, tp = models
    jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
    tcfg = dataclasses.replace(tm.cfg, use_kernels=use_kernels)
    tok = _tokens(2, 9, seed=1)
    lj, cj = jeng.prefill(jp, jnp.asarray(tok), cfg=jcfg, max_len=16,
                          last_pos=jnp.array([8, 5], jnp.int32))
    lt, ct = teng.prefill(tp, torch.from_numpy(tok).long(), cfg=tcfg,
                          max_len=16, last_pos=torch.tensor([8, 5]))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(ct[n].numpy(), np.asarray(cj[n]),
                                   atol=ATOL)
    nxt = np.array([3, 200], np.int32)
    dj, _ = jeng.decode_step(jp, cj, jnp.asarray(nxt), jnp.int32(9),
                             cfg=jcfg)
    dt, _ = teng.decode_step(tp, ct, torch.from_numpy(nxt), 9, cfg=tcfg)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=ATOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_full_attention_through_the_policy(models, use_kernels):
    _, _, tm, _ = models
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 2, 2, 7, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 12, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 12, 16)).astype(np.float32)
    cfg = dataclasses.replace(tm.cfg, use_kernels=use_kernels)
    kw = dict(causal=True, window=None, scale=0.25, kv_len=10)
    from repro.core.policy import SoftmaxPolicy as JPolicy

    want = jattn.full_attention(
        *map(jnp.asarray, (q, k, v)), qpos=jnp.arange(7) + 3,
        policy=JPolicy(use_kernels=use_kernels), **kw)
    got = tattn.full_attention(
        *map(torch.from_numpy, (q, k, v)), qpos=torch.arange(7) + 3,
        policy=cfg.softmax_policy(), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    chunked = tattn.mn_chunk_attention(
        *map(torch.from_numpy, (q, k, v)), causal=True, scale=0.25,
        q_offset=3, kv_len=10, n_q_chunks=2, n_kv_chunks=3)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), atol=1e-5)
