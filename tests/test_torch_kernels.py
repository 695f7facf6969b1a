"""The port's kernel modules on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode), the routing of CPU tensors
to the plain versions, and lazy builds.

A CUDA kernel cannot run here; ``chip_smoke.py`` holds each against its
plain version on the card, and the ``gpu``-marked tests below do so when a
card is present."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro.kernels import ops as jops
from repro_torch import kernels as tk
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import threepass_softmax as tp3
from repro_torch.kernels import twopass_softmax as ttp
from repro_torch.kernels import twopass_xent as txe

F32 = dict(atol=5e-6, rtol=1e-5)          # tests/test_kernels.py, float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _zero_counts():
    tk.reset_launch_counts()


# ---------------------------------------------------------------------------
# Two-pass softmax and stats.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 128), (5, 1000), (300, 130),
                                   (1, 20000), (3, 1)])
def test_softmax_and_stats_match_pallas(shape):
    x = (np.random.default_rng(0).standard_normal(shape) * 10).astype(
        np.float32)
    x[0, shape[1] // 2:] = -np.inf                 # a masked tail
    got = ttp.twopass_softmax_2d(torch.from_numpy(x)).numpy()
    want = np.asarray(jops.softmax(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **F32)
    m, n = ttp.twopass_stats_2d(torch.from_numpy(x))
    mj, nj = jops.logsumexp_stats(jnp.asarray(x))
    assert m.shape == n.shape == (shape[0], 1)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-5)
    np.testing.assert_array_equal(n.numpy(), np.asarray(nj))


def test_all_neg_inf_row_is_nan_as_in_pallas():
    """An all -inf row has m_sum = 0, so y = 0 * inf = NaN in the Pallas
    kernel; the port (plain version and CUDA kernel) does the same."""
    x = np.full((3, 200), -np.inf, np.float32)
    x[1] = np.linspace(-3, 3, 200)
    x[2, 5] = 0.0
    got = ttp.twopass_softmax_2d(torch.from_numpy(x)).numpy()
    want = np.asarray(jops.softmax(jnp.asarray(x)))
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    np.testing.assert_allclose(got[1:], want[1:], **F32)
    m, _ = ttp.twopass_stats_2d(torch.from_numpy(x))
    assert float(m[0, 0]) == 0.0


def test_softmax_gradient_matches_jax_grad():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 33)) * 4).astype(np.float32)
    w = rng.standard_normal((6, 33)).astype(np.float32)
    gj = jax.grad(lambda a: jnp.sum(jops.softmax(a) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tops.softmax(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), atol=1e-6)


# ---------------------------------------------------------------------------
# Decode attention.
# ---------------------------------------------------------------------------
def _paged_copy(k, v, pmax, ps, rng):
    """Scatter contiguous [S, H, T, D] K/V into a shuffled page arena."""
    s, h, _, d = k.shape
    pages = 1 + s * pmax
    pt = rng.permutation(np.arange(1, pages))[:s * pmax].reshape(s, pmax)
    kp = np.zeros((pages, ps, h, d), k.dtype)
    vp = np.zeros((pages, ps, h, d), v.dtype)
    for i in range(s):
        for p in range(pmax):
            kp[pt[i, p]] = k[i, :, p * ps:(p + 1) * ps].transpose(1, 0, 2)
            vp[pt[i, p]] = v[i, :, p * ps:(p + 1) * ps].transpose(1, 0, 2)
    return kp, vp, pt.astype(np.int32)


class TestDecode:
    s, h, g, d, ps, pmax = 5, 2, 3, 16, 8, 6

    def setup_method(self, _):
        rng = np.random.default_rng(2)
        t = self.ps * self.pmax
        self.q = rng.standard_normal((self.s, self.h, self.g, self.d)
                                     ).astype(np.float32)
        self.k = rng.standard_normal((self.s, self.h, t, self.d)
                                     ).astype(np.float32)
        self.v = rng.standard_normal((self.s, self.h, t, self.d)
                                     ).astype(np.float32)
        self.lengths = np.array([1, 7, 48, 0, 23], np.int32)
        self.kp, self.vp, self.pt = _paged_copy(self.k, self.v, self.pmax,
                                                self.ps, rng)
        self.scale = self.d ** -0.5

    def _t(self, *xs):
        return [torch.from_numpy(np.asarray(x)) for x in xs]

    @pytest.mark.parametrize("window", [None, 6])
    @pytest.mark.parametrize("block_t", [16, 48, 128])
    def test_contiguous_matches_pallas(self, window, block_t):
        want = jda.decode_attention_pallas(
            *map(jnp.asarray, (self.q, self.k, self.v, self.lengths)),
            scale=self.scale, window=window, block_t=128)
        got = tda.decode_attention(*self._t(self.q, self.k, self.v,
                                            self.lengths),
                                   scale=self.scale, window=window,
                                   block_t=block_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(got[3].numpy(), 0.0)    # free slot

    @pytest.mark.parametrize("window", [None, 6])
    @pytest.mark.parametrize("ppt", [1, 2, 4, 6])
    def test_paged_matches_pallas(self, window, ppt):
        args = (self.q, self.kp, self.vp, self.pt, self.lengths)
        want = jda.decode_attention_paged_pallas(
            *map(jnp.asarray, args), scale=self.scale, window=window,
            pages_per_tile=ppt)
        got = tda.decode_attention_paged(*self._t(*args), scale=self.scale,
                                         window=window, pages_per_tile=ppt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(got[3].numpy(), 0.0)

    def test_aliased_table_entries_are_invisible(self):
        pt = self.pt.copy()
        pt[0, 1:] = pt[2, :self.pmax - 1]         # slot 0 (len 1) aliases
        pt[3, :] = pt[2, :]                       # free slot aliases slot 2
        want = jda.decode_attention_pallas(
            *map(jnp.asarray, (self.q, self.k, self.v, self.lengths)),
            scale=self.scale)
        got = tops.decode_attention_paged(
            *self._t(self.q, self.kp, self.vp, pt, self.lengths),
            use_kernel=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(got[3].numpy(), 0.0)

    def test_ops_plain_forms_match_the_jnp_forms(self):
        for window in (None, 6):
            want = jops.decode_attention_paged(
                *map(jnp.asarray, (self.q, self.kp, self.vp, self.pt,
                                   self.lengths)),
                window=window, use_kernel=False)
            got = tops.decode_attention_paged(
                *self._t(self.q, self.kp, self.vp, self.pt, self.lengths),
                window=window, use_kernel=False)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
            want = jops.decode_attention(
                *map(jnp.asarray, (self.q, self.k, self.v, self.lengths)),
                window=window, use_kernel=False)
            got = tops.decode_attention(
                *self._t(self.q, self.k, self.v, self.lengths),
                window=window, use_kernel=False)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)

    def test_bf16(self):
        qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16)
                      for x in (self.q, self.kp, self.vp))
        want = jda.decode_attention_paged_pallas(
            qb, kb, vb, jnp.asarray(self.pt), jnp.asarray(self.lengths),
            scale=self.scale, pages_per_tile=2)
        tb = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
              for x in (qb, kb, vb)]
        got = tda.decode_attention_paged(
            *tb, *self._t(self.pt, self.lengths), scale=self.scale,
            pages_per_tile=2)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=3e-2)

    @pytest.mark.parametrize("gran", ["page", "page_head"])
    def test_int8_scales_match_pallas(self, gran):
        rng = np.random.default_rng(3)
        shp = self.kp.shape
        k8 = rng.integers(-127, 128, shp).astype(np.int8)
        v8 = rng.integers(-127, 128, shp).astype(np.int8)
        sshape = shp[:2] if gran == "page" else shp[:3]
        ksc = rng.uniform(0.001, 0.02, sshape).astype(np.float32)
        vsc = rng.uniform(0.001, 0.02, sshape).astype(np.float32)
        args = (self.q, k8, v8, self.pt, self.lengths, ksc, vsc)
        want = jda.decode_attention_paged_pallas(
            *map(jnp.asarray, args), scale=self.scale, pages_per_tile=3)
        got = tda.decode_attention_paged(*self._t(*args), scale=self.scale,
                                         pages_per_tile=3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_strip_view_is_read_in_place(self):
        # the strip pool stores [S, T, Hkv, D]; the op takes the transposed
        # view without a copy and must give the contiguous result
        strip = torch.from_numpy(self.k.transpose(0, 2, 1, 3).copy())
        vstrip = torch.from_numpy(self.v.transpose(0, 2, 1, 3).copy())
        q, lens = self._t(self.q, self.lengths)
        got = tda.decode_attention(q, strip.transpose(1, 2),
                                   vstrip.transpose(1, 2), lens,
                                   scale=self.scale)
        want = tda.decode_attention(*self._t(self.q, self.k, self.v,
                                             self.lengths), scale=self.scale)
        torch.testing.assert_close(got, want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# The decode kernels' choice of tile body (dtype, head dims, alignment).
# ---------------------------------------------------------------------------
BF, F32T, I8 = torch.bfloat16, torch.float32, torch.int8
ALIGNED = (1 << 20, 2 << 20, 2048, 256, 4096, 2048, 256, 4096)


@pytest.mark.parametrize("q_dt,kv_dt,d,dv,row_bytes,want", [
    (BF, BF, 128, 128, ALIGNED, "bf16"),
    (BF, BF, 120, 120, ALIGNED, "bf16"),
    (BF, BF, 16, 16, ALIGNED, "bf16"),
    (BF, BF, 256, 256, ALIGNED, "bf16"),
    (BF, BF, 192, 128, ALIGNED, "bf16"),
    (BF, BF, 60, 60, ALIGNED, "general"),
    (BF, BF, 128, 100, ALIGNED, "general"),
    (BF, BF, 264, 264, ALIGNED, "general"),
    (F32T, F32T, 128, 128, ALIGNED, "general"),
    (BF, I8, 128, 128, ALIGNED, "general"),
    (F32T, I8, 128, 128, ALIGNED, "general"),
    (BF, BF, 128, 128, ((1 << 20) + 8,) + ALIGNED[1:], "general"),
    (BF, BF, 128, 128, ALIGNED[:4] + (2056,) + ALIGNED[5:], "general"),
])
def test_decode_kernel_body_choice(q_dt, kv_dt, d, dv, row_bytes, want):
    assert tda.kernel_body(q_dt, kv_dt, d, dv, row_bytes) == want


def test_decode_row_bytes_of_the_pools():
    # the strip pool [B, T, Hkv, hd] read transposed and the arena
    # [P, ps, Hkv, hd] meet the bf16 body's alignment; a view 4 elements
    # (8 bytes) off a 16-byte boundary, or a head dim of 12, do not
    strip = torch.zeros(3, 40, 2, 64, dtype=BF)
    arena = torch.zeros(9, 16, 2, 64, dtype=BF)
    for k in (strip.transpose(1, 2), arena):
        rows = tda._row_bytes(k, k)
        assert tda.kernel_body(BF, BF, 64, 64, rows) == "bf16"
    assert tda._row_bytes(arena, arena)[2:5] == (4096, 256, 128)
    off = torch.zeros(arena.numel() + 4, dtype=BF)[4:].view(arena.shape)
    assert tda.kernel_body(BF, BF, 64, 64,
                           tda._row_bytes(off, arena)) == "general"
    narrow = torch.zeros(9, 16, 2, 12, dtype=BF)
    assert tda.kernel_body(BF, BF, 12, 12,
                           tda._row_bytes(narrow, narrow)) == "general"


# ---------------------------------------------------------------------------
# Routing and lazy builds.
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions():
    x = torch.randn(4, 40)
    lab = torch.tensor([0, 3, 39, 7])
    for fn, plain in ((ttp.twopass_softmax_2d, ttp.twopass_softmax_2d_plain),
                      (tp3.threepass_recompute_2d,
                       tp3.threepass_recompute_2d_plain),
                      (tp3.threepass_reload_2d,
                       tp3.threepass_reload_2d_plain),
                      (lambda a: txe.xent_fwd_2d(a, lab)[0],
                       lambda a: txe.xent_fwd_2d_plain(a, lab)[0])):
        torch.testing.assert_close(fn(x), plain(x), atol=0, rtol=0)
    q = torch.randn(2, 1, 2, 8)
    k = torch.randn(2, 1, 16, 8)
    lens = torch.tensor([3, 16])
    tops.decode_attention(q, k, k, lens, use_kernel=True)
    tops.cross_entropy(x, lab)
    assert tk.launch_counts() == {n: 0 for n in tk.WRAPPERS}


def test_other_devices_raise():
    x = torch.empty(4, 40, device="meta")
    lab = torch.empty(4, dtype=torch.int32, device="meta")
    for fn in (ttp.twopass_softmax_2d, tp3.threepass_recompute_2d,
               tp3.threepass_reload_2d, lambda a: txe.xent_fwd_2d(a, lab),
               lambda a: txe.xent_bwd_2d(a, lab, a[:, :1], a[:, :1], a[:, 0])):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tda.decode_attention(torch.empty(1, 1, 1, 8, device="meta"),
                             torch.empty(1, 1, 4, 8, device="meta"),
                             torch.empty(1, 1, 4, 8, device="meta"),
                             torch.empty(1, device="meta"), scale=1.0)


def test_import_needs_neither_nvcc_nor_triton(tmp_path):
    code = ("import sys, repro_torch.kernels.ops, repro_torch.kernels._build "
            "as b; assert 'triton' not in sys.modules; "
            "assert not b._libs and b.build_seconds is None; print('ok')")
    env = dict(os.environ, PATH=str(tmp_path))   # no nvcc on PATH
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


# ---------------------------------------------------------------------------
# On the card (skipped here): kernels against their plain versions.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_softmax_kernel_matches_plain(cuda):
    x = torch.randn(300, 1000, device=cuda) * 8
    y = ttp.twopass_softmax_2d(x)
    assert ttp.twopass_softmax_2d.launches == 1
    torch.testing.assert_close(y, ttp.twopass_softmax_2d_plain(x), **F32)
    m, n = ttp.twopass_stats_2d(x)
    mp, np_ = ttp.twopass_stats_2d_plain(x)
    torch.testing.assert_close(n, np_, atol=0, rtol=0)
    torch.testing.assert_close(m, mp, atol=0, rtol=1e-5)


@pytest.mark.gpu
def test_cuda_decode_kernels_match_plain(cuda):
    rng = np.random.default_rng(4)
    k = rng.standard_normal((3, 2, 64, 32)).astype(np.float32)
    kp, vp, pt = _paged_copy(k, k[::-1].copy(), 4, 16, rng)
    q = torch.randn(3, 2, 5, 32, device=cuda)
    lens = torch.tensor([0, 17, 64], device=cuda)
    args = [torch.from_numpy(x).to(cuda) for x in (kp, vp, pt)]
    got = tda.decode_attention_paged(q, *args, lens, scale=0.2,
                                     pages_per_tile=2)
    want = tda.decode_attention_paged_plain(q, *args, lens, scale=0.2,
                                            n_t_chunks=2)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert tda.decode_attention_paged.launches == 1
