"""``moe_impl`` through the port's ``Model.forward`` and lockstep
``generate`` against the JAX package on the CPU, with the same weights
carried across through numpy (``repro_torch.convert.params_from_jax``).

Reduced granite-moe-3b-a800m and deepseek-v2-lite-16b (multi-head latent
attention), float32.  ``Model.forward(params, tokens, moe_impl=...)``
equals the reference's under each impl, kernels off and on, within the
moe tests' model tolerance (1e-4).  The lockstep ``generate`` passes
``moe_impl`` to the prefill and to every decode step; the reference's
passes it to the prefill only and jits its step with the default impl.
The port keeps its behaviour (ROADMAP "Deliberate differences"), so its
tokens are held against the reference's prefill and decode steps called
unjitted under the same impl, as ``tests/test_torch_moe.py`` builds its
oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.serving import engine as jeng
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model

ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
ATOL = 1e-4                 # the model's outputs, as test_torch_moe
MAX_LEN = 32


@pytest.fixture(scope="module")
def weights():
    memo = {}

    def get(arch):
        if arch not in memo:
            jp = jbuild(arch, reduced=True).init(jax.random.PRNGKey(0))
            cfg = get_config(arch).reduced()
            memo[arch] = jp, cfg, params_from_jax(
                jax.tree.map(np.asarray, jp), cfg, device="cpu")
        return memo[arch]

    return get


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("impl", ["dispatch", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_takes_moe_impl(weights, arch, impl, use_kernels):
    jp, cfg, tp = weights(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 13))
    want = jbuild(arch, reduced=True, use_kernels=use_kernels).forward(
        jp, jnp.asarray(toks, jnp.int32), moe_impl=impl)
    got = Model(dataclasses.replace(cfg, use_kernels=use_kernels),
                "cpu").forward(tp, torch.from_numpy(toks).long(),
                               moe_impl=impl)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _jax_steps(jp, jcfg, prompt, steps, impl):
    """Greedy tokens [B, steps + 1] from the reference's prefill and decode
    steps, each under ``impl``, unjitted."""
    s = prompt.shape[1]
    logits, cache = jeng.prefill(jp, jnp.asarray(prompt, jnp.int32),
                                 cfg=jcfg, max_len=MAX_LEN, moe_impl=impl)
    tok = jnp.argmax(logits[:, :jcfg.vocab], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(steps):
        logits, cache = jeng.decode_step(jp, cache, tok, s + i, cfg=jcfg,
                                         moe_impl=impl)
        tok = jnp.argmax(logits[:, :jcfg.vocab], axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.stack(out, axis=1))


@pytest.mark.parametrize("impl", ["gather", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_generate_runs_every_step_under_moe_impl(weights, arch,
                                                          impl):
    jp, cfg, tp = weights(arch)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, (2, 7))
    steps = 6
    want = _jax_steps(jp, jbuild(arch, reduced=True).cfg, prompt, steps,
                      impl)
    got = Model(cfg, "cpu").generate(
        tp, torch.from_numpy(prompt).long(), steps=steps, temperature=0.0,
        max_len=MAX_LEN, moe_impl=impl)
    assert got.shape == (2, steps + 1)
    assert got.tolist() == want.tolist()
