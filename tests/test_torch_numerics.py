"""The port's numerics against the JAX reference on the CPU.

``ext_exp`` and ``exp2_int`` must agree bit for bit (the port writes the
same float32 operations in the same order); the monoid operations agree at
the reference tests' tolerances; the three plain softmax algorithms agree
with each other and with the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import numerics as jnum
from repro.core import softmax_api as jsm
from repro_torch.core import numerics as tnum
from repro_torch.core import softmax_api as tsm


def _inputs(seed):
    rng = np.random.default_rng(seed)
    k = np.arange(-200, 200)
    special = [np.inf, -np.inf, 1e38, -1e38, 3.4e38, -3.4e38, 88.7, 88.72,
               -88.7, -103.9, -87.33, 0.0, -0.0, 1e-40, 1e30, -1e30, 1e37,
               -1e37, 2e37]
    return np.concatenate([
        rng.standard_normal(4000) * 50,
        rng.standard_normal(500) * 1e30,            # the _T_CLAMP regime
        rng.uniform(-90, 90, 500),                  # near the f32 edges
        (k + 0.5) / jnum.LOG2E,                     # half-way roundings
        special]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_ext_exp_bitwise(seed):
    x = _inputs(seed)
    m_j, n_j = jnum.ext_exp(jnp.asarray(x))
    m_t, n_t = tnum.ext_exp(torch.from_numpy(x))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))


def test_exp2_int_bitwise():
    n = np.concatenate([np.arange(-300, 300), [-1e38, 1e38, -127, -126,
                                               127, 128]]).astype(np.float32)
    got = tnum.exp2_int(torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnum.exp2_int(
        jnp.asarray(n))))
    assert got[n <= -127].max() == 0.0          # flush to zero


def _ext(rng, size):
    m = rng.uniform(0.7, 1.4, size).astype(np.float32)
    n = rng.integers(-60, 60, size).astype(np.float32)
    return m, n


def test_ext_add_and_ratio_scale():
    rng = np.random.default_rng(2)
    (ma, na), (mb, nb) = _ext(rng, 256), _ext(rng, 256)
    tj = jnum.ext_add(jnum.ExtFloat(jnp.asarray(ma), jnp.asarray(na)),
                      jnum.ExtFloat(jnp.asarray(mb), jnp.asarray(nb)))
    tt = tnum.ext_add(tnum.ExtFloat(torch.from_numpy(ma),
                                    torch.from_numpy(na)),
                      tnum.ExtFloat(torch.from_numpy(mb),
                                    torch.from_numpy(nb)))
    np.testing.assert_allclose(tt.mantissa.numpy(), np.asarray(tj.mantissa),
                               rtol=1e-6)
    np.testing.assert_array_equal(tt.exponent.numpy(),
                                  np.asarray(tj.exponent))
    rj = jnum.ext_ratio_scale(jnum.ExtFloat(jnp.asarray(ma),
                                            jnp.asarray(na)), tj)
    rt = tnum.ext_ratio_scale(tnum.ExtFloat(torch.from_numpy(ma),
                                            torch.from_numpy(na)), tt)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6)


@pytest.mark.parametrize("keepdims", [False, True])
def test_ext_sum_and_log(keepdims):
    x = (np.random.default_rng(3).standard_normal((7, 300)) * 30).astype(
        np.float32)
    sj = jnum.ext_sum(jnum.ext_exp(jnp.asarray(x)), axis=-1,
                      keepdims=keepdims)
    st = tnum.ext_sum(tnum.ext_exp(torch.from_numpy(x)), axis=-1,
                      keepdims=keepdims)
    np.testing.assert_allclose(st.mantissa.numpy(), np.asarray(sj.mantissa),
                               rtol=1e-5)
    np.testing.assert_array_equal(st.exponent.numpy(),
                                  np.asarray(sj.exponent))
    np.testing.assert_allclose(tnum.ext_log(st).numpy(),
                               np.asarray(jnum.ext_log(sj)), rtol=1e-6)


def test_ext_zero_is_identity():
    m, n = _ext(np.random.default_rng(4), 16)
    e = tnum.ExtFloat(torch.from_numpy(m), torch.from_numpy(n))
    s = tnum.ext_add(e, tnum.ext_zero((16,)))
    np.testing.assert_array_equal(s.mantissa.numpy(), m)
    np.testing.assert_array_equal(s.exponent.numpy(), n)


@pytest.mark.parametrize("algo", list(tsm.SoftmaxAlgorithm))
@pytest.mark.parametrize("shape", [(5, 1000), (2, 3, 257)])
def test_plain_softmax_algorithms(algo, shape):
    x = (np.random.default_rng(5).standard_normal(shape) * 10).astype(
        np.float32)
    got = tsm.softmax(torch.from_numpy(x), algorithm=algo)
    want = jsm.softmax(jnp.asarray(x), algorithm=algo.value)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    two = tsm.softmax(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), two.numpy(), atol=2e-6)
    lse = tsm.logsumexp(torch.from_numpy(x), algorithm=algo)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jsm.logsumexp(jnp.asarray(x),
                                              algorithm=algo.value)),
        rtol=1e-6, atol=1e-5)


def test_plain_softmax_wide_range_and_masks():
    x = np.array([[-500.0, 0.0, 500.0] + [0.0] * 125,
                  [1.0, -np.inf, 2.0] + [-np.inf] * 125], np.float32)
    got = tsm.softmax(torch.from_numpy(x)).numpy()
    want = np.asarray(jsm.softmax(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[1, 1] == 0.0 and not np.isnan(got).any()


def test_combine_partials_matches_reference():
    from repro.core import twopass as jtp
    from repro_torch.core import twopass as ttp

    rng = np.random.default_rng(6)
    m = rng.uniform(0.5, 2.0, (4, 3)).astype(np.float32)
    n = rng.integers(-30, 30, (4, 3)).astype(np.float32)
    o = rng.standard_normal((4, 3, 5)).astype(np.float32)
    want = jtp.ext_combine_partials(*map(jnp.asarray, (m, n, o)))
    got = ttp.ext_combine_partials(*map(torch.from_numpy, (m, n, o)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
