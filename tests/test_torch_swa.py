"""The port's SWA ring cache and its ``Model`` facade against the JAX package
on the CPU, with the same weights carried across through numpy (reduced
h2o-danube-3-4b, window 8, and reduced stablelm-12b, float32), and the
facade's shapes at full width on the ``meta`` device (nothing allocated).

Which claim each comparison makes:
  * port ring against JAX ring: the same slot order on both sides, so the
    same sums up to float32 order (``ATOL`` 1e-4, as test_torch_models);
  * port ring against the port's position-addressed cache: past the wrap
    the ring's scores come in slot order, not position order, so only
    allclose (the reference's own ring test's 2e-3);
  * greedy tokens: ``==``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import model_zoo as jzoo
from repro.serving import engine as jeng
from repro.serving import kv_cache as jkv
from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import build_model as tbuild
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.serving import kv_cache as tkv

SWA = "h2o-danube-3-4b"
D160 = "stablelm-12b"
DENSE = [a for a in ARCH_IDS if get_config(a).family == "dense"]
ATOL = 1e-4          # port against JAX, the same order of every softmax row
RING_ATOL = 2e-3     # ring against full cache (tests/test_serving.py)
STEPS = 21           # from position 0, past the window of 8 twice
MAX_LEN = 32


def _weights(arch):
    jm = jbuild(arch, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(arch, reduced=True, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def swa():
    return _weights(SWA)


@pytest.fixture(scope="module")
def d160():
    return _weights(D160)


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _port(arch, use_kernels):
    return tbuild(arch, reduced=True, device="cpu", use_kernels=use_kernels)


# ---------------------------------------------------------------------------
# The ring cache.
# ---------------------------------------------------------------------------
def _port_ring_logits(tm, tp, toks):
    cache = tm.init_cache(2, MAX_LEN)
    assert cache["k"].shape[2] == tm.cfg.swa_window
    out = []
    for t in range(toks.shape[1]):
        lg, cache = tm.decode_step(tp, cache, torch.from_numpy(toks[:, t]),
                                   t)
        out.append(lg[:, :tm.cfg.vocab].numpy())
    return out


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_ring_matches_jax_ring(swa, use_kernels):
    jm, jp, _, tp = swa
    jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
    tm = _port(SWA, use_kernels)
    toks = _tokens(2, STEPS)
    step = jax.jit(lambda p, c, tok, pos: jeng.decode_step(p, c, tok, pos,
                                                           cfg=jcfg))
    cache = jkv.init_cache(jcfg, 2, MAX_LEN, ring=True)
    got = _port_ring_logits(tm, tp, toks)
    for t in range(STEPS):
        want, cache = step(jp, cache, jnp.asarray(toks[:, t]), jnp.int32(t))
        np.testing.assert_allclose(got[t], np.asarray(want)[:, :jcfg.vocab],
                                   atol=ATOL, err_msg=f"step {t}")


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_ring_matches_full_cache_past_the_wrap(swa, use_kernels):
    _, _, _, tp = swa
    tm = _port(SWA, use_kernels)
    toks = _tokens(2, STEPS)
    ring = _port_ring_logits(tm, tp, toks)
    _, full = tm.prefill(tp, torch.from_numpy(toks[:, :4]), max_len=MAX_LEN)
    assert full["k"].shape[2] == MAX_LEN          # position-addressed
    for t in range(4, STEPS):
        lg, full = tm.decode_step(tp, full, torch.from_numpy(toks[:, t]), t)
        if t >= tm.cfg.swa_window:
            np.testing.assert_allclose(ring[t], lg[:, :tm.cfg.vocab].numpy(),
                                       atol=RING_ATOL, err_msg=f"step {t}")


@pytest.mark.parametrize("arch,max_len", [(a, 16) for a in DENSE]
                         + [(SWA, 8)])
def test_prefill_then_decode_matches_forward(arch, max_len):
    # max_len 8 <= the window: the prefilled cache is a ring, and the step
    # at position 8 overwrites slot 0, as the reference's decode_step does
    tm = tbuild(arch, reduced=True, device="cpu")
    tp = tm.init(seed=3)
    toks = torch.from_numpy(_tokens(2, 9, seed=3)).long()
    want = ttr.lm_logits(tp, tm.forward(tp, toks)[:, -1], cfg=tm.cfg)
    _, cache = tm.prefill(tp, toks[:, :-1], max_len=max_len)
    got, _ = tm.decode_step(tp, cache, toks[:, -1], toks.shape[1] - 1)
    v = tm.cfg.vocab
    np.testing.assert_allclose(got[:, :v].numpy(), want[:, :v].numpy(),
                               atol=RING_ATOL)


# ---------------------------------------------------------------------------
# Greedy tokens through the engines: every h2o request runs past its window.
# ---------------------------------------------------------------------------
def _requests(vocab, seed=5):
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=tuple(int(t) for t in rng.integers(
        0, vocab, n)), max_new_tokens=m)
        for i, (n, m) in enumerate(((6, 12), (12, 8), (9, 10), (7, 11)))]


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
@pytest.mark.parametrize("arch", [SWA, D160])
def test_greedy_tokens_match_jax_lockstep(swa, d160, arch, paged,
                                          use_kernels):
    jm, jp, _, tp = swa if arch == SWA else d160
    jcfg = dataclasses.replace(jm.cfg, use_kernels=use_kernels)
    tm = _port(arch, use_kernels)
    reqs = _requests(tm.cfg.vocab)
    ref = []
    for r in reqs:
        toks, _ = jeng.generate_timed(
            jp, jnp.asarray(r.prompt, jnp.int32)[None], cfg=jcfg,
            steps=r.max_new_tokens - 1, key=jax.random.PRNGKey(7),
            temperature=0.0, max_len=MAX_LEN)
        ref.append([int(t) for t in np.asarray(toks)[0]])
    eng = tm.serving_engine(tp, slots=2, max_len=MAX_LEN, page_size=8,
                            paged=paged, temperature=0.0)
    comps = sorted(eng.run([dataclasses.replace(r) for r in reqs]),
                   key=lambda c: c.rid)
    assert [list(c.tokens) for c in comps] == ref
    assert eng.throughput()["paged"] is paged


# ---------------------------------------------------------------------------
# The facade's shapes at full width, on the meta device.
# ---------------------------------------------------------------------------
def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _jshapes(tree):
    return {k: _jshapes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype))
            for k, v in tree.items()}


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "full"])
@pytest.mark.parametrize("batch,max_len", [(8, 1024), (128, 32768)])
@pytest.mark.parametrize("arch", DENSE)
def test_cache_shapes_and_bytes_match_reference(arch, batch, max_len, ring):
    jcfg = jget(arch)
    tm = tbuild(arch, device="meta")
    cache = tm.init_cache(batch, max_len, ring=ring)
    assert all(t.device.type == "meta" for t in cache.values())
    want = jax.eval_shape(lambda: jkv.init_cache(jcfg, batch, max_len,
                                                 ring=ring))
    assert _shapes(cache) == _jshapes(want)
    nbytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(want))
    assert tkv.cache_bytes(tm.cfg, batch, max_len, ring=ring) == nbytes
    if ring:
        assert nbytes == jkv.cache_bytes(jcfg, batch, max_len)


def test_ring_sizes_the_decode_32k_cache_at_the_window():
    cfg = get_config(SWA)
    ring = tkv.cache_bytes(cfg, 128, 32768)
    full = tkv.cache_bytes(cfg, 128, 32768, ring=False)
    assert ring * 8 == full == 24 * 128 * 32768 * 8 * 120 * 2 * 2


@pytest.mark.parametrize("arch", DENSE)
def test_init_shape_matches_reference(arch):
    got = tbuild(arch, device="meta").init_shape()
    assert all(t.device.type == "meta" for t in _leaves(got))
    assert _shapes(got) == _jshapes(jbuild(arch).init_shape())


@pytest.mark.parametrize("cell", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_cell_supported_match_reference(arch, cell):
    tcfg, jcfg = get_config(arch), jget(arch)
    assert tzoo.cell_supported(tcfg, cell) == jzoo.cell_supported(jcfg,
                                                                   cell)
    want = jzoo.input_specs(jcfg, cell)
    # every family's cells, decode caches too (vlm and hybrid included)
    assert _shapes(tzoo.input_specs(tcfg, cell)) == _jshapes(want)


@pytest.mark.parametrize("arch", [SWA, D160])
def test_cli_serves_the_arch_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--prompt-len", "12",
                "--steps", "4", "--temperature", "0", "--kernels"])
    out = capsys.readouterr().out
    assert "served 3 requests over 2 slots" in out
    assert "prefill: 36 tok" in out and "decode:  9 tok" in out
