"""The reference's small public helpers in the port (ROADMAP item 33), each
held against the reference on the CPU: the core's ``ext_exp_reconstruct``,
``exp_via_extexp`` and ``ext_scale_add``, ``SoftmaxPolicy.replace`` and
``softmax_stats``, ``layers.softmax_fn``, ``ref.cross_entropy_grad_ref``
(the oracle of ``tests/test_kernels.py``'s CE backward), and the kernel
entry points on the registry's specs (``KernelSpec.fn``, ``bind``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import numerics as jnum
from repro.core.policy import SoftmaxPolicy as JPolicy
from repro.kernels import ref as jref
from repro.models import layers as jlayers
import repro_torch.core as tcore
from repro_torch.configs import get_config
from repro_torch.core import numerics as tnum
from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.kernels import ops  # noqa: F401  (binds the entry points)
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry
from repro_torch.models import layers as tlayers


def _x(seed=0, shape=(7, 300), scale=30.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_the_core_exports_the_references_helpers():
    for name in ("ext_exp_reconstruct", "exp_via_extexp",
                 "twopass_softmax_sharded", "twopass_logsumexp_sharded"):
        assert hasattr(jcore, name) and hasattr(tcore, name), name


# The reference's ``2^n`` is ``jnp.exp2``, which XLA on the CPU evaluates
# as exp(n ln 2): up to ~4e-6 off the power of two.  ``torch.exp2`` gives
# 2^n exactly at integral n, so the port is held to the reference within
# that error.  XLA's exp2
# flushes 2^-126 and below to zero, torch keeps them: there the two differ
# by less than m 2^-126 <= 2^-125.
REF_EXP2_RTOL = 1e-5
TINY = 2.0 ** -125


@pytest.mark.parametrize("scale", [1.0, 30.0, 80.0])
def test_exp_via_extexp_matches_the_reference(scale):
    x = _x(1, scale=scale)
    got = tcore.exp_via_extexp(torch.from_numpy(x)).numpy()
    want = np.asarray(jcore.exp_via_extexp(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=REF_EXP2_RTOL, atol=TINY)
    inside = np.abs(x) < 80                # no float32 overflow / flush
    # ExtExp's own error (its reduction and polynomial, the reference's
    # too) reaches ~4e-6 at |x| near 80
    np.testing.assert_allclose(got[inside],
                               np.exp(x[inside].astype(np.float64)),
                               rtol=1e-5, atol=0)


def test_ext_exp_reconstruct_matches_the_reference():
    x = _x(2)
    e = tnum.ext_exp(torch.from_numpy(x))
    got = tnum.ext_exp_reconstruct(e).numpy()
    want = np.asarray(jnum.ext_exp_reconstruct(jnum.ext_exp(jnp.asarray(x))))
    np.testing.assert_allclose(got, want, rtol=REF_EXP2_RTOL, atol=TINY)
    exact = e.mantissa * tnum.exp2_int(e.exponent)
    inside = np.abs(x) < 80
    np.testing.assert_array_equal(got[inside], exact.numpy()[inside])


def test_ext_scale_add_is_ext_add_bit_for_bit():
    a, b = _x(3), _x(4)
    ta = tnum.ext_exp(torch.from_numpy(a))
    tb = tnum.ext_exp(torch.from_numpy(b))
    got = tnum.ext_scale_add(ta, tb)
    want = jnum.ext_scale_add(jnum.ext_exp(jnp.asarray(a)),
                              jnum.ext_exp(jnp.asarray(b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got, tnum.ext_add(ta, tb)):
        assert torch.equal(g, w)


def test_policy_replace_matches_the_reference():
    tp = SoftmaxPolicy().replace(use_kernels=True,
                                 algorithm="three_pass_reload",
                                 attn_block_q=64)
    jp = JPolicy().replace(use_kernels=True, algorithm="three_pass_reload",
                           attn_block_q=64)
    assert (tp.use_kernels, tp.algorithm.value, tp.attn_block_q) == (
        jp.use_kernels, jp.algorithm.value, jp.attn_block_q)
    assert SoftmaxPolicy().replace() == SoftmaxPolicy()
    with pytest.raises(TypeError):
        SoftmaxPolicy().replace(no_such_knob=1)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_policy_softmax_stats_are_pass_one(use_kernels):
    """The stats op of either route gives the rows' (m, n), whose ratio
    scale is the two-pass softmax."""
    x = torch.from_numpy(_x(5))
    m, n = SoftmaxPolicy(use_kernels=use_kernels).softmax_stats(x)
    assert m.shape == n.shape == (7, 1)
    p = tnum.ext_ratio_scale(tnum.ext_exp(x), tnum.ExtFloat(m, n))
    np.testing.assert_allclose(p.numpy(), torch.softmax(x, -1).numpy(),
                               atol=2e-6)


@pytest.mark.parametrize("algo", ["two_pass", "three_pass_recompute",
                                  "three_pass_reload"])
def test_softmax_fn_matches_the_reference(algo):
    import dataclasses

    from repro.configs import get_config as jget

    x = _x(6, (3, 5, 64), 10.0)
    tcfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                               softmax_algorithm=algo)
    jcfg = dataclasses.replace(jget("qwen2.5-14b").reduced(),
                               softmax_algorithm=algo)
    got = tlayers.softmax_fn(tcfg)(torch.from_numpy(x)).numpy()
    want = np.asarray(jlayers.softmax_fn(jcfg)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    got0 = tlayers.softmax_fn(tcfg)(torch.from_numpy(x), axis=0).numpy()
    want0 = np.asarray(jlayers.softmax_fn(jcfg)(jnp.asarray(x), axis=0))
    np.testing.assert_allclose(got0, want0, atol=2e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_entropy_grad_ref_matches_the_reference(dtype):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((9, 130)) * 4).astype(np.float32)
    labels = rng.integers(0, 130, 9).astype(np.int32)
    dloss = rng.standard_normal(9).astype(np.float32)
    t = torch.from_numpy(logits).to(dtype)
    got = tref.cross_entropy_grad_ref(t, torch.from_numpy(labels),
                                      torch.from_numpy(dloss))
    assert got.dtype == dtype
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jref.cross_entropy_grad_ref(
        jnp.asarray(t.float().numpy()).astype(jd), jnp.asarray(labels),
        jnp.asarray(dloss)).astype(jnp.float32))
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    # it is the gradient of the CE oracle
    lf = torch.from_numpy(logits).requires_grad_(True)
    (tref.cross_entropy_ref(lf, torch.from_numpy(labels))
     * torch.from_numpy(dloss)).sum().backward()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), lf.grad.numpy(), atol=1e-6)


@pytest.mark.parametrize("op,fn", [
    ("flash_attention", "flash_attention_fwd_gqa"),
    ("flash_attention_bwd", "flash_attention_bwd_gqa"),
    ("lmhead_xent", "lmhead_xent_fwd_2d"),
    ("decode_attention", "decode_attention"),
    ("decode_attention_paged", "decode_attention_paged")])
def test_registry_specs_carry_their_kernel_entry_point(op, fn):
    """``ops`` binds each tiled op's kernel wrapper to its spec, as the
    reference binds its Pallas entry points; the untiled ops (softmax,
    logsumexp, xent) have no spec in the port."""
    spec = registry.get_spec(op)
    assert spec.fn is not None and spec.fn.__name__ == fn


def test_bind_replaces_only_the_entry_point():
    before = registry.get_spec("kv_page")
    try:
        registry.bind("kv_page", len)
        after = registry.get_spec("kv_page")
        assert after.fn is len
        assert after.heuristic_blocks(8, 1000) == before.heuristic_blocks(
            8, 1000)
    finally:
        registry.bind("kv_page", before.fn)
    with pytest.raises(KeyError):
        registry.bind("softmax", len)
