"""The port's three-pass softmax and cross-entropy CUDA kernels against their
plain versions on the card.  Every test here needs a CUDA device and skips
without one; the file imports no JAX, so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.kernels import ops
from repro_torch.kernels import threepass_softmax as tp3
from repro_torch.kernels import twopass_xent as txe

F32 = dict(atol=5e-6, rtol=1e-5)
BF16 = dict(atol=1e-37, rtol=2.0 ** -7)     # one bfloat16 step
THREE = {"three_pass_recompute": (tp3.threepass_recompute_2d,
                                  tp3.threepass_recompute_2d_plain),
         "three_pass_reload": (tp3.threepass_reload_2d,
                               tp3.threepass_reload_2d_plain)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tk.reset_launch_counts()
    return torch.device("cuda")


def _tol(dtype):
    return F32 if dtype == torch.float32 else BF16


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 1000), (8, 152064), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threepass_kernels_match_plain(cuda, dtype, shape):
    x = (torch.randn(shape, device=cuda) * 8).to(dtype)
    x[0, shape[1] // 2 + 1:] = -torch.inf
    for fn, plain in THREE.values():
        y = fn(x)
        torch.cuda.synchronize()
        assert fn.launches == 1 and y.dtype == dtype
        torch.testing.assert_close(y.float(), plain(x).float(), **_tol(dtype))


@pytest.mark.gpu
def test_threepass_padding_and_all_neg_inf_rows(cuda):
    x = torch.randn(40, 1000, device=cuda) * 8
    xp = torch.full((40, 1664), -torch.inf, device=cuda)
    xp[:, :1000] = x
    xp[3] = -torch.inf
    for fn, _ in THREE.values():
        y, yp = fn(x), fn(xp)
        assert torch.isnan(yp[3]).all()
        keep = torch.arange(40, device=cuda) != 3
        assert torch.equal(y[keep], yp[keep, :1000])
        assert not bool(yp[keep, 1000:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_kernels_match_plain(cuda, dtype):
    x = (torch.randn(64, 5000, device=cuda) * 5).to(dtype)
    lab = torch.randint(0, 5000, (64,), device=cuda)
    lab[0], lab[1] = -1, 5000                   # outside: gathers 0
    dl = torch.randn(64, device=cuda)
    loss, m, n = txe.xent_fwd_2d(x, lab)
    pl, pm, pn = txe.xent_fwd_2d_plain(x, lab)
    torch.testing.assert_close(n, pn, atol=0, rtol=0)
    torch.testing.assert_close(m, pm, atol=0, rtol=1e-5)
    torch.testing.assert_close(loss, pl, atol=0, rtol=1e-5)
    dx = txe.xent_bwd_2d(x, lab, m, n, dl)
    assert dx.dtype == dtype
    torch.testing.assert_close(dx.float(),
                               txe.xent_bwd_2d_plain(x, lab, m, n, dl).float(),
                               **_tol(dtype))
    assert txe.xent_fwd_2d.launches == txe.xent_bwd_2d.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("algo", list(THREE))
def test_ops_launch_the_algorithms_kernels(cuda, algo):
    x = (torch.randn(2, 5, 300, device=cuda) * 4).requires_grad_(True)
    w = torch.randn(2, 5, 300, device=cuda)
    y = SoftmaxPolicy(algorithm=algo, use_kernels=True).softmax(x)
    (y * w).sum().backward()
    counts = tk.launch_counts()
    assert counts[THREE[algo][0].__name__] == 1
    assert counts["twopass_softmax_2d"] == 0
    xr = x.detach().requires_grad_(True)
    (torch.softmax(xr, -1) * w).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, atol=1e-5, rtol=1e-4)
    logits = torch.randn(16, 777, device=cuda).requires_grad_(True)
    labels = torch.randint(0, 777, (16,), device=cuda)
    pol = SoftmaxPolicy(algorithm=algo, use_kernels=True)
    pol.cross_entropy(logits, labels).sum().backward()
    plain = SoftmaxPolicy(algorithm=algo).cross_entropy(logits, labels)
    torch.testing.assert_close(pol.cross_entropy(logits, labels), plain,
                               atol=1e-5, rtol=1e-5)
    assert tk.launch_counts()["xent_bwd_2d"] == 1
    torch.testing.assert_close(logits.grad.sum(-1),
                               torch.zeros(16, device=cuda), atol=1e-5,
                               rtol=0)
    assert ops.softmax(x.detach(), algo).shape == x.shape
