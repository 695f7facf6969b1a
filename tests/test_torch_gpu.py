"""The port's two-pass and three-pass softmax, cross-entropy, fused LM-head
cross-entropy, flash-attention and decode-attention CUDA kernels against
their plain versions on the card, and an SWA ring's decode step with
the kernels against the same step without them.  Every test here needs a
CUDA device and skips without one; the file imports no JAX, so it runs on
a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import importlib.util
import json
import math
import pathlib
import tempfile

import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import threepass_softmax as tp3
from repro_torch.kernels import twopass_softmax as tp
from repro_torch.kernels import twopass_xent as txe

F32 = dict(atol=5e-6, rtol=1e-5)
BF16 = dict(atol=1e-37, rtol=2.0 ** -7)     # one bfloat16 step
THREE = {"three_pass_recompute": (tp3.threepass_recompute_2d,
                                  tp3.threepass_recompute_2d_plain),
         "three_pass_reload": (tp3.threepass_reload_2d,
                               tp3.threepass_reload_2d_plain)}


# the kernels with a register path and a split path
TWO_LAYOUTS = {"two_pass": (tp.twopass_softmax_2d,
                            tp.twopass_softmax_2d_plain),
               "three_pass_recompute": THREE["three_pass_recompute"],
               "three_pass_reload": THREE["three_pass_reload"],
               "stats": (tp.twopass_stats_2d, tp.twopass_stats_2d_plain)}
SPLIT_KERNELS = {"two_pass": ("twopass_slots_kernel",
                              "twopass_scale_kernel"),
                 "three_pass_recompute": ("recompute_max_kernel",
                                          "recompute_sum_kernel",
                                          "recompute_scale_kernel"),
                 "three_pass_reload": ("recompute_max_kernel",
                                       "reload_sum_kernel",
                                       "reload_scale_kernel"),
                 "stats": ("twopass_slots_kernel", "stats_fold_kernel")}
REGS_KERNEL = {"two_pass": "twopass_regs_kernel",
               "three_pass_recompute": "recompute_regs_kernel",
               "three_pass_reload": "reload_regs_kernel",
               "stats": "stats_regs_kernel"}


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
@pytest.mark.parametrize("cols", [1, 31, 32, 255, 256, 257, 1000, 1024,
                                  1664, 8192, 8193, 152064])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_layouts_match_plain(cuda, dtype, cols):
    """Two-pass, recompute, reload and the stats on either side of the
    register path's edges (a chunk is 256 columns, the register path ends
    at 8192): the same ExtExp bits as the plain versions, only the sum
    order differs."""
    rows = 5 if cols > 8192 else 37
    gen = torch.Generator(device=cuda).manual_seed(cols)
    x = (torch.randn(rows, cols, device=cuda, generator=gen) * 8).to(dtype)
    x[0, cols // 2 + 1:] = -torch.inf
    for algo, (fn, plain) in TWO_LAYOUTS.items():
        if algo == "stats":
            continue
        y = fn(x)
        torch.cuda.synchronize()
        assert fn.launches == 1 and y.dtype == dtype
        torch.testing.assert_close(y.float(), plain(x).float(), **_tol(dtype))
    m, n = tp.twopass_stats_2d(x)
    mp, np_ = tp.twopass_stats_2d_plain(x)
    assert torch.equal(n, np_)
    torch.testing.assert_close(m, mp, atol=0, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cols,padded", [(1000, 8193), (8192, 16384),
                                         (1000, 1664), (1000, 152064)])
def test_softmax_bits_under_padding_across_layouts(cuda, cols, padded):
    """-inf columns add the fold's identity, so a padded row keeps its bits
    though the padding moves it from the register path to the split one."""
    gen = torch.Generator(device=cuda).manual_seed(padded)
    x = torch.randn(6, cols, device=cuda, generator=gen) * 8
    xp = torch.full((6, padded), -torch.inf, device=cuda)
    xp[:, :cols] = x
    for fn in (tp.twopass_softmax_2d, tp3.threepass_recompute_2d,
               tp3.threepass_reload_2d):
        y, yp = fn(x), fn(xp)
        assert torch.equal(y, yp[:, :cols]), fn.__name__
        assert not bool(yp[:, cols:].any())
    for a, b in zip(tp.twopass_stats_2d(x), tp.twopass_stats_2d(xp)):
        assert torch.equal(a, b)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_two_pass_stats_and_xent_bits_as_pinned(cuda):
    """The two-pass softmax and stats kernels, the reload kernels, and
    xent_fwd_2d (whose pass 1 is row_stats), give the bits pinned in
    chip_smoke.py."""
    cs = _chip_smoke()
    assert cs.twopass_digest(torch, tp) == cs.TWOPASS_DIGEST
    assert cs.reload_digest(torch, tp3) == cs.RELOAD_DIGEST
    assert cs.xent_digest(torch, txe) == cs.XENT_DIGEST


def _launched_kernels(fn, expect, tries=5):
    """(name, blocks) of each kernel one call of ``fn`` launches, from the
    profiler's trace.  A profiler session sometimes comes back without
    some of its kernel records (seen in a few full runs of this file on
    an H100); a session whose
    kernel names lack one of the substrings ``expect`` is taken again, up
    to ``tries`` times, and the last one is returned for the caller's
    checks."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        out = [(e["name"], math.prod(e["args"]["grid"])) for e in events
               if e.get("cat") == "kernel"]
        if all(any(w in name for name, _ in out) for w in expect):
            break
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("algo", list(TWO_LAYOUTS))
def test_layout_chosen_by_row_length(cuda, algo):
    """Rows of at most 8192 columns take the register kernel alone; the
    sampler's [8, 152064] takes the split kernels, each launching more
    blocks than there are rows (the stats' fold: one warp a row)."""
    fn = TWO_LAYOUTS[algo][0]
    x = torch.randn(8, 152064, device=cuda)
    grids = _launched_kernels(lambda: fn(x), SPLIT_KERNELS[algo])
    for want in SPLIT_KERNELS[algo]:
        blocks = [b for name, b in grids if want in name]
        assert len(blocks) == 1, (want, grids)
        if want == "stats_fold_kernel":             # one warp a row
            assert blocks[0] == 2, (want, grids)
        else:
            assert blocks[0] > 8, (want, grids)
    assert not any(REGS_KERNEL[algo] in name for name, _ in grids)
    assert tp.path_for(152064) == "split" and tp.path_for(8192) == "registers"
    short = x[:, :8192].contiguous()
    grids = _launched_kernels(lambda: fn(short), [REGS_KERNEL[algo]])
    assert [REGS_KERNEL[algo] in name for name, _ in grids] == [True], grids


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


# (tokens, d_model, vocab): ragged token tiles, a d_model that is no
# multiple of 8 (unvectorised loads) or of the 32-wide k tile, vocab widths
# that end inside a 128-column tile and span several backward slabs
LMHEAD_SHAPES = [(40, 32, 300), (77, 999, 1000), (130, 64, 2000),
                 (77, 1000, 50257)]


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,v", LMHEAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lmhead_kernels_match_plain(cuda, dtype, t, d, v):
    # Both sides take the same (bf16-exact) products and differ only in
    # float32 sum order over d (logits) and over the vocab (dh) or the
    # tokens (dw): errors ~1e-6 at these sizes.  Limits: the loss within
    # atol 2e-4 + rtol 1e-5 (values ~ln v), dh and dw within atol 1e-5 +
    # rtol 1e-4 (values ~1e-2).
    g = torch.Generator(device=cuda).manual_seed(t + d + v)
    h = torch.randn(t, d, device=cuda, generator=g).to(dtype)
    w = (torch.randn(d, v, device=cuda, generator=g) * d ** -0.5).to(dtype)
    lab = torch.randint(0, v, (t,), device=cuda, generator=g)
    lab[0], lab[1] = -1, v                       # outside: gathers 0
    dl = torch.randn(t, device=cuda, generator=g)
    bv = 512
    n = txe.lmhead_v_chunks(v, bv)
    loss, m_sum, n_sum = txe.lmhead_xent_fwd_2d(h, w, lab, block_v=bv)
    pl, pm, pn = txe.lmhead_xent_fwd_2d_plain(h, w, lab, n)
    torch.testing.assert_close(loss, pl, atol=2e-4, rtol=1e-5)
    lse = torch.log(m_sum) + n_sum * txe.LN2
    torch.testing.assert_close(lse, torch.log(pm) + pn * txe.LN2,
                               atol=2e-4, rtol=1e-5)
    args = (h, w, lab, m_sum, n_sum, dl)
    dh = txe.lmhead_xent_dh_2d(*args, block_v=bv)
    dw = txe.lmhead_xent_dw_2d(*args, block_v=bv)
    torch.testing.assert_close(dh, txe.lmhead_xent_dh_2d_plain(*args, n),
                               atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(dw, txe.lmhead_xent_dw_2d_plain(*args, n),
                               atol=1e-5, rtol=1e-4)
    # no atomics: the same bits on a second run
    assert torch.equal(txe.lmhead_xent_fwd_2d(h, w, lab, block_v=bv)[0],
                       loss)
    assert torch.equal(txe.lmhead_xent_dh_2d(*args, block_v=bv), dh)
    assert torch.equal(txe.lmhead_xent_dw_2d(*args, block_v=bv), dw)
    counts = tk.launch_counts()
    assert counts["lmhead_xent_fwd_2d"] == 2
    assert counts["lmhead_xent_dh_2d"] == counts["lmhead_xent_dw_2d"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,v", LMHEAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lmhead_fused_backward_equals_separate(cuda, dtype, t, d, v):
    # lmhead_xent_bwd_2d runs the same kernels on the same slabs as the two
    # entry points, each slab's dlogits computed once: equal bits, and one
    # launch counted on each of the two wrappers
    g = torch.Generator(device=cuda).manual_seed(t + d + v)
    h = torch.randn(t, d, device=cuda, generator=g).to(dtype)
    w = (torch.randn(d, v, device=cuda, generator=g) * d ** -0.5).to(dtype)
    lab = torch.randint(0, v, (t,), device=cuda, generator=g)
    lab[0], lab[1] = -1, v                       # outside: gathers 0
    dl = torch.randn(t, device=cuda, generator=g)
    _, m_sum, n_sum = txe.lmhead_xent_fwd_2d(h, w, lab, block_v=512)
    args = (h, w, lab, m_sum, n_sum, dl)
    dh, dw = txe.lmhead_xent_bwd_2d(*args, block_v=512)
    assert tk.launch_counts()["lmhead_xent_dh_2d"] == 1
    assert tk.launch_counts()["lmhead_xent_dw_2d"] == 1
    assert torch.equal(dh, txe.lmhead_xent_dh_2d(*args, block_v=512))
    assert torch.equal(dw, txe.lmhead_xent_dw_2d(*args, block_v=512))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lmhead_op_backward_computes_dlogits_once_a_slab(cuda, dtype):
    # the op's backward launches one dlogits kernel for each vocab slab
    # (3000 columns in slabs of 512: 6), not one for dh and one for dw
    h = torch.randn(100, 64, device=cuda).to(dtype).requires_grad_(True)
    w = (torch.randn(64, 3000, device=cuda) * 0.125).to(dtype)
    w.requires_grad_(True)
    lab = torch.randint(0, 3000, (100,), device=cuda)
    loss = ops.lmhead_cross_entropy(h, w, lab, block_v=512, impl="cuda")
    grads = _launched_kernels(lambda: loss.sum().backward(retain_graph=True),
                              ["lmhead_dlogits"])
    names = [name for name, _ in grads]
    assert sum("lmhead_dlogits" in x for x in names) == 6, names
    assert sum("lmhead_dw_slab" in x for x in names) == 6, names
    assert sum("lmhead_dh_slab" in x for x in names) == 6, names


@pytest.mark.gpu
def test_lmhead_op_launches_the_kernels_and_matches_the_reference(cuda):
    h = torch.randn(100, 64, device=cuda).to(torch.bfloat16)
    w = (torch.randn(64, 3000, device=cuda) * 0.125).to(torch.bfloat16)
    lab = torch.randint(0, 3000, (100,), device=cuda)
    hk, wk = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    SoftmaxPolicy(use_kernels=True).lmhead_cross_entropy(
        hk, wk, lab).sum().backward()
    counts = tk.launch_counts()
    assert [counts[f"lmhead_xent_{k}_2d"] for k in ("fwd", "dh", "dw")] \
        == [1, 1, 1]
    hr, wr = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ops.lmhead_cross_entropy(hr, wr, lab, impl="ref").sum().backward()
    assert hk.grad.dtype == wk.grad.dtype == torch.bfloat16
    torch.testing.assert_close(hk.grad.float(), hr.grad.float(), atol=1e-2,
                               rtol=2.0 ** -6)
    torch.testing.assert_close(wk.grad.float(), wr.grad.float(), atol=1e-2,
                               rtol=2.0 ** -6)


# The bf16 forward (lmhead_fwd_bf16): T 1 and 77 (< 128), 130 (a second
# token tile of 2 rows), 300 and 512; V 1000 + 129, 50257 and 769 (rows
# not 16-byte aligned: the cp.async loader; 769 leaves one column in the
# last tile), 1000, 3000 and 4096 (TMA); D 200 ends inside a 64-deep k
# tile
LMHEAD_FWD_EDGES = [(1, 64, 1000), (77, 256, 1000 + 129), (130, 128, 50257),
                    (300, 200, 3000), (300, 64, 769), (512, 128, 4096)]


def _lmhead_fwd_inputs(cuda, t, d, v):
    g = torch.Generator(device=cuda).manual_seed(t + d + v)
    h = torch.randn(t, d, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.randn(d, v, device=cuda, generator=g) * d ** -0.5).to(
        torch.bfloat16)
    lab = torch.randint(0, v, (t,), device=cuda, generator=g)
    # the last column, outside [0, V) at -1 and at V (in the last tile's
    # masked columns where V is not a multiple of 256), the last tile's
    # first column
    for i, x in enumerate((v - 1, -1, v, (v - 1) // 256 * 256)[:t]):
        lab[i] = x
    return h, w, lab


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,v", LMHEAD_FWD_EDGES)
def test_lmhead_forward_edges_match_plain(cuda, t, d, v):
    # tolerances as test_lmhead_kernels_match_plain: the same bf16-exact
    # products summed in other float32 orders
    h, w, lab = _lmhead_fwd_inputs(cuda, t, d, v)
    loss, m_sum, n_sum = txe.lmhead_xent_fwd_2d(h, w, lab, block_v=512)
    pl, pm, pn = txe.lmhead_xent_fwd_2d_plain(h, w, lab,
                                              txe.lmhead_v_chunks(v, 512))
    torch.testing.assert_close(loss, pl, atol=2e-4, rtol=1e-5)
    torch.testing.assert_close(torch.log(m_sum) + n_sum * txe.LN2,
                               torch.log(pm) + pn * txe.LN2, atol=2e-4,
                               rtol=1e-5)
    assert torch.equal(txe.lmhead_xent_fwd_2d(h, w, lab, block_v=512)[0],
                       loss)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,v,kernel", [
    (torch.bfloat16, 4096, "lmhead_fwd_bf16"),
    (torch.bfloat16, 4095, "lmhead_fwd_bf16"),
    (torch.float32, 4096, "lmhead_fwd_tiles")])
def test_lmhead_forward_kernel_by_dtype(cuda, dtype, v, kernel):
    # bf16 takes the wgmma kernel, by TMA where the rows are 16-byte
    # aligned and by cp.async where they are not (V 4095), persistent over
    # min(SMs, tiles) blocks (16 x 4 tiles of 128 x 256 here); float32 the
    # FFMA tiles.  Then the combine.  (The wrapper's int32 cast of the
    # labels is a PyTorch kernel.)
    h = torch.randn(512, 64, device=cuda).to(dtype)
    w = (torch.randn(64, v, device=cuda) * 0.125).to(dtype)
    lab = torch.randint(0, v, (512,), device=cuda)
    launched = [(name, blocks) for name, blocks in _launched_kernels(
        lambda: txe.lmhead_xent_fwd_2d(h, w, lab, block_v=512),
        [kernel, "lmhead_fwd_combine"]) if "lmhead" in name]
    names = [name for name, _ in launched]
    assert sum(kernel in x for x in names) == 1, names
    assert sum("lmhead_fwd_combine" in x for x in names) == 1, names
    assert len(names) == 2, names
    if dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        blocks = [b for name, b in launched if kernel in name]
        assert blocks == [min(sms, 16 * 4)], launched


# (B, H, Hkv, Sq, Skv, D, causal, window): GQA groups, MQA, ragged Sq / Skv
# (tile edges inside both), empty causal rows (Sq > Skv), a window, and the
# dense family's other head dims (120: no multiple of 16; 160: over 128).
# bf16 with D <= 128 takes the mma forward and backward kernels, D > 128
# the others: qwen2.5-14b's group of 5 at D 128, a window across several
# 64-row tiles, and D 144, just past the mma kernels' limit.
FLASH_CASES = [(2, 4, 2, 200, 200, 64, True, None),
               (1, 3, 1, 40, 100, 32, False, None),
               (1, 4, 4, 129, 257, 64, True, None),
               (1, 2, 1, 100, 40, 64, True, None),
               (1, 4, 2, 150, 150, 64, True, 24),
               (1, 2, 1, 70, 70, 120, True, None),
               (1, 2, 2, 70, 90, 160, False, 33),
               (1, 2, 1, 64, 64, 256, True, None),
               (1, 10, 2, 333, 333, 128, True, None),
               (1, 4, 2, 700, 700, 128, True, 100),
               (1, 2, 1, 333, 333, 144, True, None)]
# float32 on FFMA: only the sum order differs (errors ~1e-6 here); bf16: the
# float32 results that close round at most one bf16 step apart
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
             torch.bfloat16: dict(atol=1e-4, rtol=2.0 ** -7)}


def _flash_inputs(cuda, dtype, b, h, hkv, sq, skv, d):
    g = torch.Generator(device=cuda).manual_seed(sq * 1000 + skv + d)
    q = torch.randn(b, h, sq, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, hkv, skv, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, hkv, skv, d, device=cuda, generator=g).to(dtype)
    do = torch.randn(b, h, sq, d, device=cuda, generator=g).to(dtype)
    return q, k, v, do


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda, dtype, case):
    b, h, hkv, sq, skv, d, causal, window = case
    q, k, v, do = _flash_inputs(cuda, dtype, b, h, hkv, sq, skv, d)
    kw = dict(causal=causal, scale=d ** -0.5, window=window)
    o, m, n = tfa.flash_attention_fwd_gqa(q, k, v, **kw)
    torch.cuda.synchronize()
    po, pm, pn = tfa.flash_attention_fwd_gqa_plain(q, k, v, **kw)
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), po.float(), **FLASH_TOL[dtype])
    # the stats pair through lse: m_sum may differ by a factor of 2 where a
    # score lands on a rounding boundary of n
    live = pm > 0
    lse = torch.log(m) + n * txe.LN2
    torch.testing.assert_close(lse[live], (torch.log(pm) + pn * txe.LN2)[live],
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(m[~live], pm[~live]) and torch.equal(n[~live],
                                                            pn[~live])
    grads = tfa.flash_attention_bwd_gqa(q, k, v, o, m, n, do, **kw)
    torch.cuda.synchronize()
    plain = tfa.flash_attention_bwd_gqa_plain(q, k, v, o, m, n, do, **kw)
    for got, want in zip(grads, plain):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[dtype])
    if causal and sq > skv:                     # rows that see no key
        empty = sq - skv
        assert not o[:, :, :empty].any() and not grads[0][:, :, :empty].any()
        assert not m[:, :, :empty].any()
    # no atomics: the same bits on a second run
    again = tfa.flash_attention_fwd_gqa(q, k, v, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, (o, m, n)))
    again = tfa.flash_attention_bwd_gqa(q, k, v, o, m, n, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, grads))
    counts = tk.launch_counts()
    assert counts["flash_attention_fwd_gqa"] == 2
    assert counts["flash_attention_bwd_gqa"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, d, mma", [(torch.bfloat16, 128, True),
                                           (torch.bfloat16, 120, True),
                                           (torch.bfloat16, 144, False),
                                           (torch.float32, 128, False)])
def test_flash_forward_and_backward_kernels_chosen_by_dtype_and_head_dim(
        cuda, dtype, d, mma):
    q, k, v, do = _flash_inputs(cuda, dtype, 1, 2, 1, 64, 64, d)

    def fwd_bwd():
        o, m, n = tfa.flash_attention_fwd_gqa(q, k, v, causal=True)
        tfa.flash_attention_bwd_gqa(q, k, v, o, m, n, do, causal=True)

    names = [name for name, _ in _launched_kernels(
        fwd_bwd, ("flash_fwd", "flash_dq", "flash_dkv"))]
    for kernel in ("flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma"):
        assert any(kernel in x for x in names) == mma, names
    # flash_fwd (the wmma kernel) exactly where the mma kernels do not run
    assert any("flash_fwd" in x and "flash_fwd_mma" not in x
               for x in names) != mma, names
    if dtype == torch.bfloat16:
        assert (min(tfa.blocks_per_sm(d, w) for w in (0, 1, 2)) >= 1) == mma


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_mma_kernels_fit_two_blocks_an_sm(cuda, d):
    # which: 0 = dq, 1 = dk/dv, 2 = forward
    assert [tfa.blocks_per_sm(d, w) >= 2 for w in (0, 1, 2)] == [True] * 3


@pytest.mark.gpu
def test_flash_refuses_what_the_kernels_do_not_take(cuda):
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, 1, 2, 1, 16, 16, 64)
    # any head dim up to 256 is taken (D 60, Dv != D too); past it the
    # tiles would not fit shared memory
    wide = [t.repeat(1, 1, 1, 5)[..., :264].contiguous() for t in (q, k, v)]
    with pytest.raises(ValueError, match="head dim D = 264"):
        tfa.flash_attention_fwd_gqa(*wide)
    with pytest.raises(ValueError, match="head dim Dv = 264"):
        tfa.flash_attention_fwd_gqa(q, k, wide[2])
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd_gqa(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention_fwd_gqa(q, k, v, window=0)
    assert tk.launch_counts()["flash_attention_fwd_gqa"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_autograd_and_policy_route(cuda, dtype):
    q, k, v, do = _flash_inputs(cuda, dtype, 1, 4, 2, 96, 96, 64)

    def grads(**kw):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = ops.flash_attention(*leaves, causal=True, **kw)
        o.backward(do)
        return [o] + [t.grad for t in leaves]

    got = grads(policy=SoftmaxPolicy(use_kernels=True))
    counts = tk.launch_counts()
    assert counts["flash_attention_fwd_gqa"] == 1
    assert counts["flash_attention_bwd_gqa"] == 1
    want = grads(impl="twopass")
    assert sum(tk.launch_counts().values()) == 2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **FLASH_TOL[dtype])
    ref = grads(impl="ref")
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                   rtol=2.0 ** -6)


# ---------------------------------------------------------------------------
# Decode attention (strip and paged) against the plain versions.
# ---------------------------------------------------------------------------
# The encdec family's shapes (whisper-base, D 64, 8 heads over 8 KV heads),
# non-causal with Sq != Skv: the encoder's self-attention over one 30-s
# window, the cross-attention at a prefill of 37 prompt tokens, and the
# lockstep decode's cross read, one query a row.  The forward only: the
# backward at these shapes is encdec training (ROADMAP item 28).
FLASH_ENCDEC = [(1, 8, 8, 1500, 1500), (1, 8, 8, 37, 1500), (3, 8, 8, 1, 700)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_ENCDEC)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_at_the_encdec_shapes(cuda, dtype, case):
    b, h, hkv, sq, skv = case
    q, k, v, _ = _flash_inputs(cuda, dtype, b, h, hkv, sq, skv, 64)
    kw = dict(causal=False, scale=64 ** -0.5, window=None)
    o, m, n = tfa.flash_attention_fwd_gqa(q, k, v, **kw)
    torch.cuda.synchronize()
    po, pm, pn = tfa.flash_attention_fwd_gqa_plain(q, k, v, **kw)
    assert o.dtype == dtype and o.shape == (b, h, sq, 64)
    torch.testing.assert_close(o.float(), po.float(), **FLASH_TOL[dtype])
    lse = torch.log(m) + n * txe.LN2
    torch.testing.assert_close(lse, torch.log(pm) + pn * txe.LN2,
                               atol=1e-5, rtol=1e-5)
    again = tfa.flash_attention_fwd_gqa(q, k, v, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, (o, m, n)))
    assert tk.launch_counts()["flash_attention_fwd_gqa"] == 2


# bf16: the float32 results differ by the f32 sum order, then each rounds to
# bf16, so they may land one bf16 step apart; f32: the order alone.  These
# are chip_smoke.py's decode tolerances.
DECODE_TOL = {torch.bfloat16: dict(atol=1e-5, rtol=1e-2),
              torch.float32: dict(atol=1e-5, rtol=0.0)}
# lengths: a free slot, one position, one exact tile (128), a tile and one,
# six tiles; slot 1's table past its length aliases slot 4's pages
DECODE_LENGTHS = [0, 1, 128, 129, 700]


def _decode_inputs(cuda, dtype, d, g, *, hkv=2, ps=64, pmax=12,
                   lengths=DECODE_LENGTHS, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed * 1000 + d + g)
    s = len(lengths)
    n_pages = 1 + s * pmax
    table = torch.randperm(n_pages - 1, device=cuda, generator=gen)
    table = (table + 1).reshape(s, pmax).to(torch.int32)
    if s > 4:
        table[1, 1:] = table[4, :pmax - 1]
    q = torch.randn(s, hkv, g, d, device=cuda, generator=gen).to(dtype)
    kp, vp = (torch.randn(n_pages, ps, hkv, d, device=cuda,
                          generator=gen).to(dtype) for _ in "kv")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return q, kp, vp, table, lens


def _strip(arena, table):
    """The paged cache as a strip pool [S, T, Hkv, D], read transposed."""
    s, pmax = table.shape
    _, ps, hkv, d = arena.shape
    return (arena[table.long()].reshape(s, pmax * ps, hkv, d)
            .transpose(1, 2))


def _check_decode(q, kp, vp, table, lens, dtype, *, window=None, ppt=2,
                  k_scale=None, v_scale=None, strip=True):
    """Kernel vs plain, the same bits twice, a free slot's exact zeros,
    and (``strip``: both take one body) strip bit-equal to paged."""
    sc = q.shape[-1] ** -0.5
    pmax, ps = table.shape[1], kp.shape[1]
    got = tda.decode_attention_paged(q, kp, vp, table, lens, k_scale,
                                     v_scale, scale=sc, window=window,
                                     pages_per_tile=ppt)
    torch.cuda.synchronize()
    want = tda.decode_attention_paged_plain(
        q, kp, vp, table, lens, k_scale, v_scale, scale=sc, window=window,
        n_t_chunks=-(-pmax // ppt))
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL[dtype])
    assert torch.equal(tda.decode_attention_paged(
        q, kp, vp, table, lens, k_scale, v_scale, scale=sc, window=window,
        pages_per_tile=ppt), got)
    free = lens == 0
    assert not got[free].any()
    if strip:
        st = tda.decode_attention(q, _strip(kp, table), _strip(vp, table),
                                  lens, scale=sc, window=window,
                                  block_t=ppt * ps)
        assert torch.equal(st, got)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("d,g,window", [(16, 5, None), (64, 5, None),
                                        (120, 5, None), (128, 5, None),
                                        (160, 5, None), (128, 10, None),
                                        (128, 5, 300), (64, 10, 300)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_match_plain(cuda, dtype, d, g, window):
    q, kp, vp, table, lens = _decode_inputs(cuda, dtype, d, g)
    _check_decode(q, kp, vp, table, lens, dtype, window=window)
    assert tda.decode_attention_paged.launches == 2
    assert tda.decode_attention.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_long_slot_folds_128_tiles(cuda, dtype):
    q, kp, vp, table, lens = _decode_inputs(cuda, dtype, 128, 5, hkv=8,
                                            ps=128, pmax=128,
                                            lengths=[16384])
    _check_decode(q, kp, vp, table, lens, dtype, ppt=1)


# the SWA serving shapes: h2o-danube-3-4b (G 4, D 120, window 4096) and
# stablelm-12b (G 4, D 160); lengths past the window leave whole tiles
# outside it
SWA_LENGTHS = [0, 1, 4096, 4097, 7000]


@pytest.mark.gpu
@pytest.mark.parametrize("d,window", [(120, 4096), (120, None),
                                      (160, 4096), (160, None)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_at_the_swa_shapes(cuda, dtype, d, window):
    q, kp, vp, table, lens = _decode_inputs(cuda, dtype, d, 4, hkv=8,
                                            ps=128, pmax=55,
                                            lengths=SWA_LENGTHS)
    _check_decode(q, kp, vp, table, lens, dtype, window=window)


@pytest.mark.gpu
def test_ring_decode_step_kernels_match_plain(cuda):
    from repro_torch.models import build_model

    toks = torch.randint(0, 256, (2, 21), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    logits = {}
    for use_kernels in (False, True):
        m = build_model("h2o-danube-3-4b", reduced=True,
                        use_kernels=use_kernels)
        params = m.init(seed=0)
        cache = m.init_cache(2, 32)
        assert cache["k"].shape[2] == m.cfg.swa_window
        tk.reset_launch_counts()
        out = []
        for t in range(toks.shape[1]):
            lg, cache = m.decode_step(params, cache, toks[:, t], t)
            out.append(lg)
        logits[use_kernels] = torch.stack(out)
        launched = tk.launch_counts()["twopass_softmax_2d"]
        assert launched == use_kernels * m.cfg.n_layers * toks.shape[1]
    # float32: only the order of the softmax sums differs
    torch.testing.assert_close(logits[True], logits[False], atol=1e-4,
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("gran", ["page", "page_head"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_int8_pages_with_scales(cuda, dtype, gran):
    q, kp, _, table, lens = _decode_inputs(cuda, dtype, 128, 5)
    gen = torch.Generator(device=cuda).manual_seed(11)
    k8, v8 = (torch.randint(-127, 128, kp.shape, device=cuda, generator=gen,
                            dtype=torch.int8) for _ in "kv")
    shp = kp.shape[:2] if gran == "page" else kp.shape[:3]
    ksc, vsc = (torch.rand(shp, device=cuda, generator=gen) * 0.02
                for _ in "kv")
    _check_decode(q, k8, v8, table, lens, dtype, k_scale=ksc, v_scale=vsc,
                  strip=False)


def _decode_kernel_names(fn):
    return [name for name, _ in _launched_kernels(
        fn, ("decode_tile", "decode_combine"))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,int8,bf16_body",
                         [(torch.bfloat16, False, True),
                          (torch.float32, False, False),
                          (torch.bfloat16, True, False)])
def test_decode_body_chosen_by_dtype(cuda, dtype, int8, bf16_body):
    q, kp, vp, table, lens = _decode_inputs(cuda, dtype, 128, 5)
    kw = {}
    if int8:
        kp, vp = kp.to(torch.int8), vp.to(torch.int8)
        kw = dict(k_scale=torch.ones(kp.shape[:2], device=cuda),
                  v_scale=torch.ones(kp.shape[:2], device=cuda))
    for fn in (lambda: tda.decode_attention_paged(q, kp, vp, table, lens,
                                                  scale=0.1, **kw),
               lambda: tda.decode_attention(q, _strip(kp, table),
                                            _strip(vp, table), lens,
                                            scale=0.1)):
        names = _decode_kernel_names(fn)
        assert any("decode_combine" in x for x in names), names
        assert any("decode_tile_bf16" in x for x in names) == bf16_body
        assert any("decode_tile<" in x for x in names) != bf16_body
        if int8:
            break                      # the strip takes no int8 cache
    want = "bf16" if bf16_body else "general"
    assert tda.kernel_body(q.dtype, kp.dtype, 128, 128,
                           tda._row_bytes(kp, vp)) == want


@pytest.mark.gpu
def test_decode_misaligned_rows_take_the_general_body(cuda):
    q, kp, vp, table, lens = _decode_inputs(cuda, torch.bfloat16, 128, 5)
    # the same arenas 4 elements (8 bytes) past a 16-byte boundary
    flat = torch.empty(kp.numel() + 4, dtype=kp.dtype, device=cuda)
    ko = flat[4:].view(kp.shape)
    ko.copy_(kp)
    rows = tda._row_bytes(ko, vp)
    assert tda.kernel_body(q.dtype, ko.dtype, 128, 128, rows) == "general"
    names = _decode_kernel_names(lambda: tda.decode_attention_paged(
        q, ko, vp, table, lens, scale=0.1))
    assert not any("decode_tile_bf16" in x for x in names), names
    # the strip copy is aligned (the bf16 body): no bit-equality to hold
    _check_decode(q, ko, vp, table, lens, torch.bfloat16, strip=False)
    # no fallback: the bf16 body refuses rows it cannot load 16 bytes at
    # a time, and the launch raises
    o = torch.empty_like(q)
    _, _, strides = tda._paged_operands("t", q, ko, vp, None, None)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tda.launch_paged("bf16", q, ko, vp, table, lens, None, None, strides,
                         o, tile=128, window=None, scale=0.1)


# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_at_the_encdec_cross_read(cuda, dtype):
    # whisper's cross read: G 1 (8 query heads over 8 KV heads), D 64, a
    # shuffled table of 12 pages of 128 (1,500 frames), one empty slot
    q, kp, vp, table, lens = _decode_inputs(
        cuda, dtype, 64, 1, hkv=8, ps=128, pmax=12,
        lengths=[600, 0, 1500, 1, 1499])
    _check_decode(q, kp, vp, table, lens, dtype, ppt=1)


# The fused decode step: the engine's step captured in a CUDA graph.
# ---------------------------------------------------------------------------
def _fused_model():
    from repro_torch.models import build_model

    m = build_model("qwen2.5-14b", reduced=True, use_kernels=True)
    assert m.cfg.n_layers == 2
    return m, m.init(seed=0)


def _fused_requests(vocab, n=5, new=12):
    from repro_torch.serving.scheduler import Request

    gen = torch.Generator().manual_seed(11)
    return [Request(rid=i, prompt=tuple(torch.randint(
        0, vocab, (9 + i,), generator=gen).tolist()), max_new_tokens=new)
        for i in range(n)]


def _serve(m, params, paged, fuse, reqs, hook=None, **kw):
    """Tokens, launches and the engine of one run, the counts zeroed after
    the engine (and so its capture) is built; ``hook(eng)`` runs before
    the requests."""
    eng = m.serving_engine(params, slots=3, max_len=48, page_size=8,
                           pages=7 if paged else None, paged=paged,
                           fused=fuse, **kw)
    if hook is not None:
        hook(eng)
    tk.reset_launch_counts()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    return [c.tokens for c in comps], tk.launch_counts(), eng


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_fused_step_tokens_equal_eager(cuda, paged):
    m, params = _fused_model()
    reqs = _fused_requests(m.cfg.vocab)
    runs = {f: _serve(m, params, paged, f, reqs, temperature=0.0)
            for f in (True, False)}
    (toks, counts, eng), (toks_e, counts_e, eng_e) = runs[True], runs[False]
    assert toks == toks_e
    assert eng._fused is not None and eng_e._fused is None
    st = eng.stats
    assert st["admitted"] > eng.n_slots and st["steps"] == eng_e.stats["steps"]
    assert (st["preempted"] > 0) is paged
    kname = "decode_attention_paged" if paged else "decode_attention"
    assert eng._fused.launches == {kname: m.cfg.n_layers}
    assert eng._fused.replays == st["steps"]
    assert counts == counts_e and counts[kname] == m.cfg.n_layers * st["steps"]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_graph_captured_before_admission_leaves_the_cache_as_eager(cuda,
                                                                   paged):
    m, params = _fused_model()
    reqs = _fused_requests(m.cfg.vocab, n=4, new=6)
    pools = {}
    for fuse in (True, False):
        _, _, eng = _serve(m, params, paged, fuse, reqs, temperature=0.0)
        assert eng.stats["admitted"] > eng.n_slots
        pools[fuse] = eng.pool["kv"]
    for name in ("k", "v"):
        got, want = pools[True][name], pools[False][name]
        if paged:                 # page 0 is the trash page: dead writes
            got, want = got[:, 1:], want[:, 1:]
        assert torch.equal(got, want), name


@pytest.mark.gpu
def test_fused_sampling_is_seeded_and_launches_the_softmax_kernel(cuda):
    m, params = _fused_model()
    reqs = _fused_requests(m.cfg.vocab, n=4, new=5)
    runs = [_serve(m, params, True, True, reqs, temperature=0.8, seed=9)
            for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    assert all(0 <= t < m.cfg.vocab for x in runs[0][0] for t in x)
    _, counts, eng = runs[0]
    st = eng.stats
    assert eng._fused.launches == {"decode_attention_paged": m.cfg.n_layers,
                                   "twopass_softmax_2d": 1}
    # a prefill: a launch a layer and one for its sampler; a replay: one
    assert counts["twopass_softmax_2d"] == (
        st["admitted"] * (m.cfg.n_layers + 1) + st["steps"])


@pytest.mark.gpu
def test_a_failed_capture_raises(cuda, monkeypatch):
    m, params = _fused_model()
    launch = tda.launch_paged

    def syncing(*args, **kw):
        torch.cuda.current_stream().synchronize()   # waits for the device
        return launch(*args, **kw)

    monkeypatch.setattr(tda, "launch_paged", syncing)
    with pytest.raises(RuntimeError):
        m.serving_engine(params, slots=2, max_len=48, temperature=0.0)
    # nothing falls back: only fused=False steps eagerly, through the same
    # syncing wrapper
    eng = m.serving_engine(params, slots=2, max_len=48, temperature=0.0,
                           fused=False)
    assert eng._fused is None
    assert len(eng.run(_fused_requests(m.cfg.vocab, n=2, new=3))) == 2


# ---------------------------------------------------------------------------
# granite-20b's multi-query decode: 48 query heads over one KV head.
# ---------------------------------------------------------------------------
# the served shape's lengths (prompts of 200-1,500 + 32 new, pages of 128,
# max_len 1664): a free slot, one position, a page and one, the longest
MQA_LENGTHS = [0, 1, 129, 700, 1500, 1532, 1663, 1664]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_at_g48_over_one_kv_head(cuda, dtype):
    q, kp, vp, table, lens = _decode_inputs(cuda, dtype, 128, 48, hkv=1,
                                            ps=128, pmax=13,
                                            lengths=MQA_LENGTHS)
    assert q.shape == (8, 1, 48, 128)
    _check_decode(q, kp, vp, table, lens, dtype, ppt=1)
    assert tda.decode_attention_paged.launches == 2
    assert tda.decode_attention.launches == 1


# ---------------------------------------------------------------------------
# The ssm family (rwkv6-1.6b): its recurrent state inside the graph step.
# ---------------------------------------------------------------------------
def _rwkv_model(dtype="float32"):
    from repro_torch.models import build_model

    m = build_model("rwkv6-1.6b", reduced=True, use_kernels=True,
                    dtype=dtype)
    assert m.cfg.n_layers == 2
    return m, m.init(seed=0)


def _serve_strip(m, params, fuse, reqs, **kw):
    eng = m.serving_engine(params, slots=3, max_len=48, fused=fuse, **kw)
    tk.reset_launch_counts()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    return [c.tokens for c in comps], tk.launch_counts(), eng


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_graph_step_equals_eager_with_the_state_bit_equal(cuda, dtype):
    m, params = _rwkv_model(dtype)
    reqs = _fused_requests(m.cfg.vocab)
    runs = {f: _serve_strip(m, params, f, reqs, temperature=0.0)
            for f in (True, False)}
    (toks, counts, eng), (toks_e, counts_e, eng_e) = runs[True], runs[False]
    assert not eng.paged and eng.buckets is None
    assert toks == toks_e and counts == counts_e
    assert eng._fused is not None and eng_e._fused is None
    assert eng._fused.launches == {}           # greedy: no kernel a step
    st = eng.stats
    assert st["admitted"] > eng.n_slots and st["steps"] == eng_e.stats["steps"]
    assert eng._fused.replays == st["steps"]
    # every slot was admitted, so the warm-up's dead state was overwritten
    assert {c.slot for c in eng.completions} == set(range(eng.n_slots))
    for name in ("wkv", "last_t", "last_c"):
        assert torch.equal(eng.pool["kv"][name], eng_e.pool["kv"][name]), name
    assert torch.equal(eng.pool["lengths"], eng_e.pool["lengths"])


@pytest.mark.gpu
def test_rwkv_sampler_launches_the_softmax_kernel_once_a_replay(cuda):
    m, params = _rwkv_model()
    reqs = _fused_requests(m.cfg.vocab, n=4, new=5)
    runs = [_serve_strip(m, params, True, reqs, temperature=0.8, seed=9)
            for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    assert all(0 <= t < m.cfg.vocab for x in runs[0][0] for t in x)
    _, counts, eng = runs[0]
    st = eng.stats
    assert eng._fused.launches == {"twopass_softmax_2d": 1}
    # a prefill: one launch for its sampler; a replay: one
    assert counts["twopass_softmax_2d"] == st["admitted"] + st["steps"]
    _, counts_e, _ = _serve_strip(m, params, False, reqs, temperature=0.8,
                                  seed=9)
    assert counts_e == counts


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 32])
def test_softmax_kernel_on_rwkv_sampler_rows(cuda, rows):
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, 65536), device=cuda, generator=gen) * 8 / 0.8
    got = tp.twopass_softmax_2d(x)
    torch.testing.assert_close(got, tp.twopass_softmax_2d_plain(x), **F32)
    assert tp.path_for(65536) == "split"


# ---------------------------------------------------------------------------
# The encdec family (whisper-base): the cross read inside the graph step.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("enc_chunk", [None, 4], ids=["whole", "chunked"])
def test_whisper_graph_step_equals_eager(cuda, enc_chunk):
    from repro_torch.models import build_model

    m = build_model("whisper-base", reduced=True, use_kernels=True)
    assert m.cfg.n_layers == 2
    params = m.init(seed=0)
    reqs = _fused_requests(m.cfg.vocab)
    gen = torch.Generator().manual_seed(3)
    for i, r in enumerate(reqs):
        r.frames = torch.randn((5 + 2 * i, m.cfg.d_model),
                               generator=gen).numpy()
    runs = {}
    for fuse in (True, False):
        eng = m.serving_engine(params, slots=3, max_len=48, page_size=8,
                               max_cross_len=16, enc_chunk=enc_chunk,
                               temperature=0.0, fused=fuse)
        tk.reset_launch_counts()
        comps = eng.run([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
        runs[fuse] = [c.tokens for c in comps], tk.launch_counts(), eng
    (toks, counts, eng), (toks_e, counts_e, eng_e) = runs[True], runs[False]
    assert toks == toks_e and counts == counts_e
    st = eng.stats
    assert st["admitted"] == 5 > eng.n_slots
    # a replay: self and cross reads, one each a layer
    assert eng._fused.launches == {"decode_attention_paged":
                                   2 * m.cfg.n_layers}
    assert eng._fused.replays == st["steps"] == eng_e.stats["steps"]
    # every encode window and every prefill's cross read take the flash
    # forward (the decoder's self-attention prefill takes the softmax)
    windows = sum(-(-r.frames.shape[0] // (enc_chunk or 99)) for r in reqs)
    assert counts["flash_attention_fwd_gqa"] == (
        m.cfg.n_enc_layers * windows + m.cfg.n_layers * st["admitted"])
    for name in ("k", "v"):                     # page 0: the trash page
        assert torch.equal(eng.pool["kv"][name][:, 1:],
                           eng_e.pool["kv"][name][:, 1:])
    for name in ("page_table", "lengths", "cross_table", "cross_lengths"):
        assert torch.equal(eng.pool[name], eng_e.pool[name]), name


# ---------------------------------------------------------------------------
# The moe family (granite-moe-3b-a800m): the router's rows through the
# softmax kernels, the decode kernels at G 3 / D 64, the graph step.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("rows", [32, 2048])
@pytest.mark.parametrize("algo", ["two_pass", "three_pass_recompute",
                                  "three_pass_reload"])
def test_softmax_kernels_on_moe_router_rows(cuda, algo, rows):
    # the router's float32 logits over 40 experts: a decode step's 32
    # slots and one prefill group of 2,048 tokens
    fn, plain = TWO_LAYOUTS[algo]
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, 40), device=cuda, generator=gen) * 4
    got = fn(x)
    torch.testing.assert_close(got, plain(x), **F32)
    assert tp.path_for(40) == "registers"
    assert fn.launches == 1


# granite-moe's served lengths: prompts of 200-4,096 + 64 new tokens,
# pages of 128, max_len 4,160
MOE_LENGTHS = [0, 1, 129, 2048, 3064, 4159, 4160]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_at_g3_d64(cuda, dtype):
    q, kp, vp, table, lens = _decode_inputs(cuda, dtype, 64, 3, hkv=8,
                                            ps=128, pmax=33,
                                            lengths=MOE_LENGTHS)
    assert q.shape == (7, 8, 3, 64)
    _check_decode(q, kp, vp, table, lens, dtype, ppt=1)
    assert tda.decode_attention_paged.launches == 2
    assert tda.decode_attention.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["dispatch", "gather"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_moe_graph_step_equals_eager_with_the_cache_bit_equal(cuda, paged,
                                                              impl):
    from repro_torch.models import build_model

    m = build_model("granite-moe-3b-a800m", reduced=True, use_kernels=True)
    assert m.cfg.n_layers == 2
    params = m.init(seed=0)
    reqs = _fused_requests(m.cfg.vocab)
    runs = {f: _serve(m, params, paged, f, reqs, temperature=0.0,
                      moe_impl=impl) for f in (True, False)}
    (toks, counts, eng), (toks_e, counts_e, eng_e) = runs[True], runs[False]
    assert eng.buckets is None and eng.moe_impl == impl
    assert toks == toks_e and counts == counts_e
    st = eng.stats
    assert st["admitted"] > eng.n_slots and st["steps"] == eng_e.stats["steps"]
    # a replay: the decode read and the router's softmax, one each a layer
    kname = "decode_attention_paged" if paged else "decode_attention"
    assert eng._fused.launches == {kname: m.cfg.n_layers,
                                   "twopass_softmax_2d": m.cfg.n_layers}
    assert eng._fused.replays == st["steps"]
    for name in ("k", "v"):
        got, want = eng.pool["kv"][name], eng_e.pool["kv"][name]
        if paged:                 # page 0 is the trash page: dead writes
            got, want = got[:, 1:], want[:, 1:]
        assert torch.equal(got, want), name
    assert torch.equal(eng.pool["lengths"], eng_e.pool["lengths"])


# ---------------------------------------------------------------------------
# Multi-head latent attention (deepseek-v2-lite-16b): kernels 12-13 with v's
# head dim Dv apart from D (192 / 128 at full width, 24 / 16 reduced) and
# head dims that are no multiple of 8; the decode kernel at G 1, D 192 /
# Dv 128; reduced deepseek's graph step.
# ---------------------------------------------------------------------------
# (b, h, hkv, sq, skv, d, dv, causal)
FLASH_V_DIMS = [(1, 16, 16, 300, 300, 192, 128, True),
                (2, 4, 4, 37, 37, 24, 16, True),
                (1, 2, 1, 45, 60, 20, 12, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_V_DIMS,
                         ids=["d192-dv128", "d24-dv16", "d20-dv12"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_v_head_dims(cuda, dtype, case):
    b, h, hkv, sq, skv, d, dv, causal = case
    q, k, _, _ = _flash_inputs(cuda, dtype, b, h, hkv, sq, skv, d)
    _, _, v, do = _flash_inputs(cuda, dtype, b, h, hkv, sq, skv, dv)
    kw = dict(causal=causal, scale=d ** -0.5, window=None)
    o, m, n = tfa.flash_attention_fwd_gqa(q, k, v, **kw)
    torch.cuda.synchronize()
    po, pm, pn = tfa.flash_attention_fwd_gqa_plain(q, k, v, **kw)
    assert o.dtype == dtype and o.shape == (b, h, sq, dv)
    torch.testing.assert_close(o.float(), po.float(), **FLASH_TOL[dtype])
    lse = torch.log(m) + n * txe.LN2
    torch.testing.assert_close(lse, torch.log(pm) + pn * txe.LN2,
                               atol=1e-5, rtol=1e-5)
    grads = tfa.flash_attention_bwd_gqa(q, k, v, o, m, n, do, **kw)
    torch.cuda.synchronize()
    plain = tfa.flash_attention_bwd_gqa_plain(q, k, v, o, m, n, do, **kw)
    for got, want, t in zip(grads, plain, (q, k, v)):
        assert got.dtype == dtype and got.shape == t.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[dtype])
    again = tfa.flash_attention_fwd_gqa(q, k, v, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, (o, m, n)))
    again = tfa.flash_attention_bwd_gqa(q, k, v, o, m, n, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, grads))

    def fwd_bwd():
        o_, m_, n_ = tfa.flash_attention_fwd_gqa(q, k, v, **kw)
        tfa.flash_attention_bwd_gqa(q, k, v, o_, m_, n_, do, **kw)

    # Dv != D takes the wmma / FFMA kernels, never the mma ones
    names = [x for x, _ in _launched_kernels(
        fwd_bwd, ("flash_fwd", "flash_dq", "flash_dkv"))]
    assert not any("_mma" in x for x in names), names
    assert all(any(k_ in x for x in names)
               for k_ in ("flash_fwd", "flash_dq", "flash_dkv")), names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_at_g1_d192_dv128(cuda, dtype):
    # the MLA ragged decode's operands: each head's key the up-projected
    # nope part and the shared rope key, read through transposed views of
    # [S, T, H, 192] and of the value half of [S, T, H, 256]
    s, t, h = 5, 700, 16
    gen = torch.Generator(device=cuda).manual_seed(192)
    kf = torch.randn(s, t, h, 192, device=cuda, generator=gen).to(dtype)
    kv = torch.randn(s, t, h, 256, device=cuda, generator=gen).to(dtype)
    q = torch.randn(s, h, 1, 192, device=cuda, generator=gen).to(dtype)
    k, v = kf.transpose(1, 2), kv[..., 128:].transpose(1, 2)
    lens = torch.tensor([0, 1, 129, 512, 700], dtype=torch.int32,
                        device=cuda)
    got = tda.decode_attention(q, k, v, lens, scale=192 ** -0.5)
    torch.cuda.synchronize()
    want = tda.decode_attention_plain(q, k, v, lens, scale=192 ** -0.5)
    assert got.shape == (s, h, 1, 128) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **DECODE_TOL[dtype])
    assert not got[0].any()                      # a free slot
    assert torch.equal(tda.decode_attention(q, k, v, lens,
                                            scale=192 ** -0.5), got)
    assert tda.decode_attention.launches == 2


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_mla_graph_step_equals_eager_with_the_cache_bit_equal(cuda, paged):
    from repro_torch.models import build_model

    m = build_model("deepseek-v2-lite-16b", reduced=True, use_kernels=True)
    assert m.cfg.n_layers == 2 and m.cfg.mla is not None
    params = m.init(seed=0)
    reqs = _fused_requests(m.cfg.vocab)
    runs = {f: _serve(m, params, paged, f, reqs, temperature=0.0)
            for f in (True, False)}
    (toks, counts, eng), (toks_e, counts_e, eng_e) = runs[True], runs[False]
    assert eng.buckets is None
    assert toks == toks_e and counts == counts_e
    st = eng.stats
    assert st["admitted"] > eng.n_slots and st["steps"] == eng_e.stats["steps"]
    # a replay: the strip decode op over the up-projected latent (both
    # pools) and the router's softmax, one each a layer
    assert eng._fused.launches == {"decode_attention": m.cfg.n_layers,
                                   "twopass_softmax_2d": m.cfg.n_layers}
    assert eng._fused.replays == st["steps"]
    for name in ("c", "kr"):
        got, want = eng.pool["kv"][name], eng_e.pool["kv"][name]
        if paged:                 # page 0 is the trash page: dead writes
            got, want = got[:, 1:], want[:, 1:]
        assert torch.equal(got, want), name
    assert torch.equal(eng.pool["lengths"], eng_e.pool["lengths"])
    if paged:
        # strip == paged where no request is preempted (a preempted one is
        # prefilled again over its tokens, which rounds otherwise): with
        # every page provisioned a slot gathers the strip's 48 positions
        full, strip = (m.serving_engine(params, slots=3, max_len=48,
                                        page_size=8, paged=p,
                                        temperature=0.0) for p in (True,
                                                                   False))
        def tokens(e):
            return [c.tokens for c in sorted(e.run(reqs),
                                             key=lambda c: c.rid)]

        toks_full = tokens(full)
        assert full.stats["preempted"] == 0
        assert tokens(strip) == toks_full


# ---------------------------------------------------------------------------
# The vlm and hybrid families: the decode kernels at qwen2-vl-7b's G 7, D
# 128 and hymba-1.5b's G 5, D 64 under its 1,024 window; the two-pass
# softmax on hymba's windowed prefill rows; both reduced models' graph step.
# ---------------------------------------------------------------------------
# (hkv, g, d, window, lengths): lengths past hymba's window leave whole
# tiles outside it; qwen2-vl's reach its max_len of 2,176
FAMILY_DECODE = {"vlm_g7_d128": (4, 7, 128, None, [0, 1, 256, 257, 2176]),
                 "hybrid_g5_d64_w1024": (5, 5, 64, 1024,
                                         [0, 1, 1024, 1025, 3136])}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FAMILY_DECODE))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernels_at_the_vlm_and_hybrid_shapes(cuda, dtype, case):
    hkv, g, d, window, lengths = FAMILY_DECODE[case]
    q, kp, vp, table, lens = _decode_inputs(cuda, dtype, d, g, hkv=hkv,
                                            ps=64, pmax=49, lengths=lengths)
    _check_decode(q, kp, vp, table, lens, dtype, window=window)
    assert tda.decode_attention_paged.launches == 2
    assert tda.decode_attention.launches == 1


@pytest.mark.gpu
def test_two_pass_softmax_on_windowed_hybrid_rows(cuda):
    # one KV head's 5 query heads over a 1,500-token prompt: causal, and
    # nothing 1,024 or more positions back
    s, g, w = 1500, 5, 1024
    gen = torch.Generator(device=cuda).manual_seed(25)
    pos = torch.arange(s, device=cuda)
    dead = (pos[None, :] > pos[:, None]) | (pos[None, :] <= pos[:, None] - w)
    x = (torch.randn(g, s, s, device=cuda, generator=gen) * 8).masked_fill_(
        dead, -torch.inf).reshape(g * s, s)
    got = tp.twopass_softmax_2d(x)
    torch.cuda.synchronize()
    want = tp.twopass_softmax_2d_plain(x)
    torch.testing.assert_close(got, want, atol=5e-6, rtol=1e-5)
    assert not got.masked_select(torch.isinf(x)).any()
    assert torch.equal(got[0], want[0])        # one finite column
    assert tp.twopass_softmax_2d.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "hymba-1.5b"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "strip"])
def test_vlm_and_hybrid_graph_step_equals_eager(cuda, arch, paged):
    from repro_torch.models import build_model

    m = build_model(arch, reduced=True, use_kernels=True)
    assert m.cfg.n_layers == 2
    params = m.init(seed=0)
    reqs = _fused_requests(m.cfg.vocab)
    released = {True: [], False: []}

    def keeping(fuse):
        """Keep a hybrid slot's mamba state as each request leaves it:
        after that the free slot steps dead state whose attention reads
        the trash page, which every free slot writes at once."""
        def hook(eng):
            if m.cfg.family != "hybrid":
                return
            release, ssm = eng._release_slot, eng.pool["kv"]["ssm"]

            def keep(slot):
                released[fuse].append((eng.slot_owner[slot].rid,
                                       ssm[:, slot].clone()))
                release(slot)

            eng._release_slot = keep
        return hook

    runs = {f: _serve(m, params, paged, f, reqs, hook=keeping(f),
                      temperature=0.0) for f in (True, False)}
    (toks, counts, eng), (toks_e, counts_e, eng_e) = runs[True], runs[False]
    assert toks == toks_e and counts == counts_e
    assert (eng.buckets is None) is (m.cfg.family == "hybrid")
    st = eng.stats
    assert st["admitted"] > eng.n_slots and st["steps"] == eng_e.stats["steps"]
    kname = "decode_attention_paged" if paged else "decode_attention"
    assert eng._fused.launches == {kname: m.cfg.n_layers}
    assert eng._fused.replays == st["steps"]
    kv, kv_e = eng.pool["kv"], eng_e.pool["kv"]
    if m.cfg.family == "hybrid":
        # the mamba state, written in place by every replay, as each
        # request (preempted ones too) left its slot
        got, want = released[True], released[False]
        assert len(got) == len(want) >= len(reqs)
        assert all(ra == rb and torch.equal(a, b)
                   for (ra, a), (rb, b) in zip(got, want))
        kv, kv_e = kv["attn"], kv_e["attn"]
    for name in ("k", "v"):
        got, want = kv[name], kv_e[name]
        if paged:                 # page 0 is the trash page: dead writes
            got, want = got[:, 1:], want[:, 1:]
        assert torch.equal(got, want), name
    assert torch.equal(eng.pool["lengths"], eng_e.pool["lengths"])


@pytest.mark.gpu
def test_vlm_lockstep_with_patches_kernels_equal_plain(cuda):
    from repro_torch.models import build_model

    gen = torch.Generator(device=cuda).manual_seed(7)
    toks = {}
    for use_kernels in (True, False):
        m = build_model("qwen2-vl-7b", reduced=True, use_kernels=use_kernels)
        params = m.init(seed=0)
        prompt = torch.randint(0, m.cfg.vocab, (3, 9), device=cuda,
                               generator=gen.manual_seed(7))
        patches = torch.randn(3, m.cfg.n_patches, m.cfg.d_model,
                              device=cuda, generator=gen.manual_seed(8))
        tk.reset_launch_counts()
        toks[use_kernels] = m.generate(params, prompt, steps=6,
                                       temperature=0.0, patches=patches)
        counts = tk.launch_counts()
        # a prefill layer's scores and a step layer's over a cache of
        # max_len rows: the two-pass kernel each
        assert counts["twopass_softmax_2d"] == use_kernels * 7 * 2
    assert torch.equal(toks[True], toks[False])
