"""The port's three-pass softmax baselines (paper Alg 1 and 2) and its fused
cross-entropy on the CPU: the plain versions of the CUDA kernels against
the JAX package's Pallas kernels (interpret mode), the differentiable ops
against ``jax.grad``, and ``SoftmaxPolicy.cross_entropy`` on both routes.

A CUDA kernel cannot run here; ``chip_smoke.py`` and the ``gpu``-marked
tests of ``tests/test_torch_gpu.py`` hold each against its plain version on
the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import SoftmaxPolicy as JPolicy
from repro.kernels import ops as jops
from repro.kernels import threepass_softmax as jtp3
from repro.kernels import twopass_xent as jxent
from repro_torch import kernels as tk
from repro_torch.core import softmax_api as tsm
from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import threepass_softmax as ttp3
from repro_torch.kernels import twopass_xent as txe

F32 = dict(atol=5e-6, rtol=1e-5)          # tests/test_kernels.py, float32
BF16_STEP = 2.0 ** -7                     # one bfloat16 step, relative
THREE = {"three_pass_recompute": ttp3.threepass_recompute_2d,
         "three_pass_reload": ttp3.threepass_reload_2d}


@pytest.fixture(autouse=True)
def _zero_counts():
    tk.reset_launch_counts()


def _close(got, want, dtype):
    """float32: the reference tests' limits.  bfloat16: both sides round
    float32 values that differ only in sum order, so they land at most one
    bfloat16 step apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, atol=1e-37, rtol=BF16_STEP)


def _pair(x, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return xt, jnp.asarray(x).astype(getattr(jnp, dtype))


# ---------------------------------------------------------------------------
# Three-pass softmax (kernels 5 and 6).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", list(THREE))
@pytest.mark.parametrize("shape", [(8, 128), (5, 1000), (300, 130),
                                   (1, 20000), (3, 1)])
def test_threepass_matches_pallas(shape, algo, dtype):
    x = (np.random.default_rng(0).standard_normal(shape) * 10).astype(
        np.float32)
    x[0, shape[1] // 2 + 1:] = -np.inf             # a masked tail
    xt, xj = _pair(x, dtype)
    got = THREE[algo](xt)
    assert got.dtype == xt.dtype
    _close(got.float(), jops.softmax(xj, algorithm=algo), dtype)


@pytest.mark.parametrize("algo", list(THREE))
def test_threepass_matches_the_pallas_2d_entry(algo):
    x = (np.random.default_rng(1).standard_normal((16, 512)) * 8).astype(
        np.float32)
    want = getattr(jtp3, algo.replace("three_pass", "threepass") + "_2d")(
        jnp.asarray(x), block_rows=8, block_cols=128)
    _close(THREE[algo](torch.from_numpy(x)), want, "float32")


@pytest.mark.parametrize("algo", list(THREE))
def test_threepass_all_neg_inf_row_is_nan_as_in_pallas(algo):
    x = np.full((3, 200), -np.inf, np.float32)
    x[1] = np.linspace(-3, 3, 200)
    x[2, 5] = 0.0
    got = THREE[algo](torch.from_numpy(x)).numpy()
    want = np.asarray(jops.softmax(jnp.asarray(x), algorithm=algo))
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    _close(got[1:], want[1:], "float32")
    assert got[2, 5] == 1.0


@pytest.mark.parametrize("algo", list(THREE))
def test_threepass_exp_flushes_to_zero_below_minus_88(algo):
    """The kernels' exponential is the paper's Alg 4 (ExtExp rebuilt with
    exp2_int), which gives exact zeros for x - mu below about -88, where
    ``torch.exp`` gives denormals: the plain version follows the Pallas
    kernel, the ``use_kernels=False`` form follows ``jnp.exp``."""
    x = np.array([[0.0, -1.0, -50.0, -86.0, -88.5, -95.0, -100.0, -150.0,
                   -1000.0]], np.float32)
    flushed = x[0] <= -88.5
    got = THREE[algo](torch.from_numpy(x)).numpy()
    want = np.asarray(jops.softmax(jnp.asarray(x), algorithm=algo))
    np.testing.assert_array_equal(got[0, flushed], 0.0)
    np.testing.assert_array_equal(want[0, flushed], 0.0)
    _close(got, want, "float32")
    assert got[0, 3] > 0.0                         # -86: still normal
    torch_exp = tsm.softmax(torch.from_numpy(x), algorithm=algo).numpy()
    assert (torch_exp[0, 4:7] > 0.0).all()         # denormals, not zeros


@pytest.mark.parametrize("algo", list(THREE))
def test_threepass_padding_changes_no_bit(algo):
    """-inf columns add exact zeros to the fixed-order sum, so a padded row
    gives the same bits as the row alone."""
    x = (np.random.default_rng(2).standard_normal((6, 1000)) * 8).astype(
        np.float32)
    xp = np.full((6, 1664), -np.inf, np.float32)
    xp[:, :1000] = x
    y = THREE[algo](torch.from_numpy(x))
    yp = THREE[algo](torch.from_numpy(xp))
    torch.testing.assert_close(y, yp[:, :1000], atol=0, rtol=0)
    assert not bool(yp[:, 1000:].any())


@pytest.mark.parametrize("algo", list(THREE))
def test_ops_softmax_gradient_matches_jax_grad(algo):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3, 33)) * 4).astype(np.float32)
    w = rng.standard_normal((2, 3, 33)).astype(np.float32)
    gj = jax.grad(lambda a: jnp.sum(jops.softmax(a, algorithm=algo) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tops.softmax(xt, algo) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), atol=1e-6)


@pytest.mark.parametrize("algo", list(tsm.SoftmaxAlgorithm))
def test_policy_kernel_route_takes_the_algorithms_kernel(algo):
    x = torch.randn(4, 3, 50) * 6
    got = SoftmaxPolicy(algorithm=algo, use_kernels=True).softmax(x)
    fn = tops._SOFTMAX_2D[algo]
    torch.testing.assert_close(got, fn(x.reshape(-1, 50)).reshape(x.shape),
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# Cross-entropy (kernels 7 and 8).
# ---------------------------------------------------------------------------
def _xent_inputs(t, v, seed, scale=5.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((t, v)) * scale).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    dloss = rng.standard_normal(t).astype(np.float32)
    return logits, labels, dloss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,v", [(8, 128), (64, 1000), (3, 4999)])
def test_xent_matches_pallas_and_jax_grad(t, v, dtype):
    logits, labels, dloss = _xent_inputs(t, v, seed=t + v)
    lt, lj = _pair(logits, dtype)
    lab_t, lab_j = torch.from_numpy(labels), jnp.asarray(labels)
    loss, m, n = txe.xent_fwd_2d(lt, lab_t)
    assert loss.dtype == m.dtype == n.dtype == torch.float32
    assert m.shape == n.shape == (t, 1)
    np.testing.assert_allclose(loss.numpy(),
                               np.asarray(jops.cross_entropy(lj, lab_j)),
                               **F32)
    gj = jax.grad(lambda a: (jops.cross_entropy(a, lab_j)
                             * jnp.asarray(dloss)).sum())(lj)
    lt = lt.clone().requires_grad_(True)
    (tops.cross_entropy(lt, lab_t) * torch.from_numpy(dloss)).sum().backward()
    assert lt.grad.dtype == lt.dtype
    _close(lt.grad.float(), np.asarray(gj, np.float32), dtype)
    dx = txe.xent_bwd_2d(lt.detach(), lab_t, m, n, torch.from_numpy(dloss))
    torch.testing.assert_close(dx, lt.grad, atol=0, rtol=0)


def test_xent_label_outside_the_row_gathers_zero():
    """As in the Pallas kernel itself (the JAX op pads the vocabulary with
    -inf columns first, so there a label just past V hits one)."""
    logits, labels, _ = _xent_inputs(8, 256, seed=4)
    labels[5:] = [256, -1, 1000]                        # outside [0, V)
    loss, m, n = txe.xent_fwd_2d(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    want = jxent.xent_fwd_2d(jnp.asarray(logits), jnp.asarray(labels),
                             block_t=8, block_v=128)
    for got, w in zip((loss, m, n), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32)
    lse = torch.logsumexp(torch.from_numpy(logits), -1)
    torch.testing.assert_close(loss[5:], lse[5:], atol=1e-5, rtol=1e-6)


def test_xent_extreme_logits():
    logits = np.array([[300.0, -300.0, 299.0, 0.0] * 32,
                       [-np.inf, 1.0, 2.0, -np.inf] * 32], np.float32)
    labels = np.array([0, 2], np.int32)
    loss, _, _ = txe.xent_fwd_2d(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    want = jops.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("algo", list(tsm.SoftmaxAlgorithm))
def test_policy_cross_entropy_matches_reference(algo, use_kernels):
    logits, labels, _ = _xent_inputs(16, 777, seed=5, scale=8.0)
    want = JPolicy(algorithm=algo.value, use_kernels=use_kernels
                   ).cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = SoftmaxPolicy(algorithm=algo, use_kernels=use_kernels
                        ).cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels))
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
