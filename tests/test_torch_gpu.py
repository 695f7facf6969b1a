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


# The vocab-parallel CE (a model axis of 2 splitting the columns in
# halves), as training under a mesh runs kernels 9-11 on a rank's columns.
VOCAB_SPLITS = [(77, 1000, 2000), (130, 64, 2048)]


def _halves(cuda, dtype, t, d, v):
    g = torch.Generator(device=cuda).manual_seed(t + d + v + 1)
    h = torch.randn(t, d, device=cuda, generator=g).to(dtype)
    w = (torch.randn(d, v, device=cuda, generator=g) * d ** -0.5).to(dtype)
    lab = torch.randint(0, v, (t,), device=cuda, generator=g)
    dl = torch.randn(t, device=cuda, generator=g)
    half = v // 2
    return h, w, lab, dl, half, (w[:, :half].contiguous(),
                                 w[:, half:].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,v", VOCAB_SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lmhead_labels_outside_the_shard_gather_zero(cuda, dtype, t, d, v):
    # every label outside this rank's columns: the label logit is exactly
    # 0, so the loss is the shard's own lse; the plain version agrees
    h, _, lab, _, half, (_, w1) = _halves(cuda, dtype, t, d, v)
    lab1 = torch.remainder(lab, half) - half          # all below 0
    loss, m_sum, n_sum = txe.lmhead_xent_fwd_2d(h, w1, lab1, block_v=512)
    lse = torch.log(torch.clamp(m_sum[:, 0], min=1e-37)) \
        + n_sum[:, 0] * txe.LN2
    assert torch.equal(loss, lse)
    pl, _, _ = txe.lmhead_xent_fwd_2d_plain(h, w1, lab1,
                                            txe.lmhead_v_chunks(half, 512))
    torch.testing.assert_close(loss, pl, atol=2e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,v", VOCAB_SPLITS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lmhead_halves_fold_to_the_full_vocabulary(cuda, dtype, t, d, v):
    # kernel 9 on each half, the two (m, n) folded and the label logits
    # summed, against kernel 9 over all columns; kernels 10-11 on one half
    # from the folded stats against their plain versions, and against the
    # full backward's columns of that half
    from repro_torch.core import numerics

    h, w, lab, dl, half, cols = _halves(cuda, dtype, t, d, v)
    parts = []
    for r, wr in enumerate(cols):
        lr = lab - r * half
        loss_r, m_r, n_r = txe.lmhead_xent_fwd_2d(h, wr, lr, block_v=512)
        lse_r = torch.log(torch.clamp(m_r[:, 0], min=1e-37)) \
            + n_r[:, 0] * txe.LN2
        parts.append((m_r, n_r, torch.where((lr >= 0) & (lr < half),
                                            lse_r - loss_r, 0.0)))
    s = numerics.ext_sum(numerics.ExtFloat(
        torch.stack([p[0] for p in parts]),
        torch.stack([p[1] for p in parts])), axis=0)
    folded = (torch.log(torch.clamp(s.mantissa[:, 0], min=1e-37))
              + s.exponent[:, 0] * txe.LN2 - parts[0][2] - parts[1][2])
    full, fm, fn = txe.lmhead_xent_fwd_2d(h, w, lab, block_v=512)
    torch.testing.assert_close(folded, full, atol=2e-4, rtol=1e-5)
    args = (h, cols[0], lab, s.mantissa, s.exponent, dl)
    dh, dw = txe.lmhead_xent_bwd_2d(*args, block_v=512)
    n = txe.lmhead_v_chunks(half, 512)
    pdh, pdw = txe.lmhead_xent_bwd_2d_plain(*args, n)
    torch.testing.assert_close(dh, pdh, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(dw, pdw, atol=1e-5, rtol=1e-4)
    _, dw_full = txe.lmhead_xent_bwd_2d(h, w, lab, fm, fn, dl, block_v=512)
    torch.testing.assert_close(dw, dw_full[:, :half], atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_parallel_op_on_one_rank_equals_the_fused_op(cuda, dtype):
    # with no mesh the sharded op's fold is the rank's own stats: its loss,
    # dh and dw through the kernels equal the unsharded op's (the loss up
    # to the one rounding of recovering the label logit)
    h, w, lab, dl, _, _ = _halves(cuda, dtype, 130, 64, 2048)
    outs = []
    for fn in (ops.lmhead_cross_entropy, ops.lmhead_cross_entropy_sharded):
        hh, ww = (x.clone().requires_grad_(True) for x in (h, w))
        extra = (0,) if fn is ops.lmhead_cross_entropy_sharded else ()
        loss = fn(hh, ww, lab, *extra, block_v=512, impl="cuda")
        loss.backward(dl)
        outs.append((loss.detach(), hh.grad, ww.grad))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=2e-4, rtol=1e-5)
    assert torch.equal(outs[1][1], outs[0][1])
    assert torch.equal(outs[1][2], outs[0][2])
    assert tk.launch_counts()["lmhead_xent_fwd_2d"] == 2


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
# bf16 with D a multiple of 8 takes the mma forward and backward kernels
# (split over two warps a strip past D 128): qwen2.5-14b's group of 5 at
# D 128, a window across several 64-row tiles, and D 144 (the (160, 160)
# instantiation, its columns past 144 zero-filled).
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
                                           (torch.bfloat16, 144, True),
                                           (torch.bfloat16, 160, True),
                                           (torch.bfloat16, 256, True),
                                           (torch.bfloat16, 100, False),
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
    assert tfa.design(dtype, d) == ("mma" if mma else "wmma")
    if dtype == torch.bfloat16:
        assert (min(tfa.blocks_per_sm(d, w) for w in (0, 1, 2)) >= 1) == mma


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_mma_kernels_fit_two_blocks_an_sm(cuda, d):
    # which: 0 = dq, 1 = dk/dv, 2 = forward
    assert [tfa.blocks_per_sm(d, w) >= 2 for w in (0, 1, 2)] == [True] * 3


# (D, Dv, blocks an SM of dq, dk/dv, forward) past D 128: the split
# backward (8 warps) holds one block an SM by its shared memory (157-232
# KB); the forward keeps two at (160, 160) and (192, 128) (4 warps, 108 /
# 112 KB) and splits at Dv 192 and 256 (8 warps, one block)
@pytest.mark.gpu
@pytest.mark.parametrize("d, dv, blocks", [(160, 160, [1, 1, 2]),
                                           (192, 128, [1, 1, 2]),
                                           (192, 192, [1, 1, 1]),
                                           (256, 256, [1, 1, 1])],
                         ids=["d160", "d192-dv128", "d192-dv192", "d256"])
def test_flash_mma_kernels_blocks_an_sm_at_wide_heads(cuda, d, dv, blocks):
    assert [tfa.blocks_per_sm(d, w, dv) for w in (0, 1, 2)] == blocks


@pytest.mark.gpu
def test_flash_refuses_what_the_kernels_do_not_take(cuda):
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, 1, 2, 1, 16, 16, 64)
    # every head dim is taken: past 256 the wmma kernels walk it in
    # chunks, so D 264 and Dv 264 are no refusal
    wide = [t.repeat(1, 1, 1, 5)[..., :264].contiguous() for t in (q, k, v)]
    assert tfa.design(torch.bfloat16, 264) == "wmma"
    for args in (wide, (q, k, wide[2])):
        o = tfa.flash_attention_fwd_gqa(*args)[0]
        want = tfa.flash_attention_fwd_gqa_plain(
            *args, causal=False, scale=args[0].shape[-1] ** -0.5)[0]
        assert (o.float() - want.float()).abs().max() < 2e-2
    assert tk.launch_counts()["flash_attention_fwd_gqa"] == 2
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd_gqa(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention_fwd_gqa(q, k, v, window=0)
    assert tk.launch_counts()["flash_attention_fwd_gqa"] == 2


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
def test_padded_heads_graph_step_equals_eager(cuda, paged):
    """Reduced qwen built for tp 3 on one card: 4 q-heads padded to 6 over
    2 KV heads, the ungrouped layout (the decode's q-heads regrouped over
    the arena through cached indices, so the captured step copies nothing
    from the host);
    graph tokens and launches == eager, and == the unpadded model's."""
    from repro_torch.models import build_model

    m = build_model("qwen2.5-14b", reduced=True, use_kernels=True, tp=3)
    params = m.init(seed=0)
    assert params["blocks"]["attn"]["wq"]["w"].shape[-1] == 6 * 16
    reqs = _fused_requests(m.cfg.vocab)
    runs = {f: _serve(m, params, paged, f, reqs, temperature=0.0)
            for f in (True, False)}
    (toks, counts, eng), (toks_e, counts_e, _) = runs[True], runs[False]
    assert eng._fused is not None
    assert toks == toks_e and counts == counts_e
    # the padded heads' weights are zero: the tp-1 model on the real
    # heads' weights gives the same tokens
    m1 = build_model("qwen2.5-14b", reduced=True, use_kernels=True)
    real = {**params, "blocks": {**params["blocks"], "attn": {
        "wq": {"w": params["blocks"]["attn"]["wq"]["w"][..., :64],
               "b": params["blocks"]["attn"]["wq"]["b"][..., :64]},
        "wk": params["blocks"]["attn"]["wk"],
        "wv": params["blocks"]["attn"]["wv"],
        "wo": {"w": params["blocks"]["attn"]["wo"]["w"][:, :64]}}}}
    assert _serve(m1, real, paged, False, reqs, temperature=0.0)[0] == toks


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


def _shared_head_requests(vocab, n=5, new=10):
    from repro_torch.serving.scheduler import Request

    gen = torch.Generator().manual_seed(5)
    head = tuple(torch.randint(0, vocab, (20,), generator=gen).tolist())
    return [Request(rid=i, prompt=head + tuple(torch.randint(
        0, vocab, (3 + i,), generator=gen).tolist()), max_new_tokens=new)
        for i in range(n)]


@pytest.mark.gpu
def test_shared_pages_graph_equals_eager_and_unshared_tokens(cuda):
    """Requests that share a 20-token head (two whole pages of 8 and a
    copy-on-write page) on 6 usable pages: the graph step replays over
    table rows that alias arena pages as the eager step runs (the same
    tokens, launches, counters and pages), each hit's tail prefill
    launches the softmax kernel once a layer, and the tokens equal the
    cache-off run's."""
    m, params = _fused_model()
    runs = {name: _serve(m, params, True, fuse,
                         _shared_head_requests(m.cfg.vocab),
                         temperature=0.0, prefix_cache=pc)
            for name, fuse, pc in (("graph", True, "auto"),
                                   ("eager", False, "auto"),
                                   ("off", True, False))}
    (toks, counts, eng), (toks_e, counts_e, eng_e) = (runs["graph"],
                                                      runs["eager"])
    st = eng.stats
    assert st["prefix_hits"] > 0 and st["cow_copies"] > 0
    assert st["preempted"] > 0 or st["prefix_evictions"] > 0
    assert toks == toks_e and counts == counts_e
    keys = ("prefix_hits", "prefix_tokens_reused", "cow_copies",
            "prefix_evictions", "peak_pages", "preempted", "steps")
    assert {k: st[k] for k in keys} == {k: eng_e.stats[k] for k in keys}
    for name in ("k", "v"):                  # page 0: the trash page
        assert torch.equal(eng.pool["kv"][name][:, 1:],
                           eng_e.pool["kv"][name][:, 1:]), name
    n_l = m.cfg.n_layers
    assert counts["twopass_softmax_2d"] == st["admitted"] * n_l
    assert counts["decode_attention_paged"] == st["steps"] * n_l
    assert toks == runs["off"][0]
    assert runs["off"][2].stats["prefix_hits"] == 0


@pytest.mark.gpu
def test_stream_deltas_equal_run_tokens_on_the_graph_step(cuda):
    m, params = _fused_model()
    kw = dict(slots=3, max_len=48, page_size=8, pages=7, temperature=0.0)
    eng = m.serving_engine(params, **kw)
    assert eng._fused is not None
    got = {}
    for rid, new in eng.stream(_shared_head_requests(m.cfg.vocab)):
        got.setdefault(rid, []).extend(new)
    want = m.serving_engine(params, **kw).run(
        _shared_head_requests(m.cfg.vocab))
    assert eng.stats["prefix_hits"] > 0
    assert {c.rid: c.tokens for c in want} == got
    assert [c.tokens for c in eng.completions] == [c.tokens for c in want]


# ---------------------------------------------------------------------------
# int8 KV pages and the host-RAM swap tier.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("gran", ["page", "page_head"])
def test_int8_graph_step_equals_eager_with_codes_and_scales(cuda, gran):
    """Reduced qwen2.5-14b on int8 arenas: the graph step writes the same
    codes and scales as the eager step (the trash page aside), with the
    same tokens and launches, every launch of kernel 3 an int8 one."""
    m, params = _fused_model()
    reqs = _fused_requests(m.cfg.vocab)
    runs = {f: _serve(m, params, True, f, reqs, temperature=0.0,
                      page_dtype="int8", scale_granularity=gran)
            for f in (True, False)}
    (toks, counts, eng), (toks_e, counts_e, eng_e) = runs[True], runs[False]
    assert toks == toks_e and counts == counts_e
    assert eng._fused.launches == {"decode_attention_paged_int8":
                                   m.cfg.n_layers}
    assert counts["decode_attention_paged"] == 0
    assert counts["decode_attention_paged_int8"] == (
        m.cfg.n_layers * eng.stats["steps"])
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(eng.pool["kv"][name][:, 1:],
                           eng_e.pool["kv"][name][:, 1:]), name
    assert eng.pool["kv"]["k"].dtype == torch.int8


@pytest.mark.gpu
@pytest.mark.parametrize("gran", ["page", "page_head"])
def test_decode_int8_at_the_served_shape(cuda, gran):
    """Kernel 3 at the quant phase's shape (q [8, 8, 5, 128] bf16, pages of
    128, up to 1,664 positions) over arenas quantized a page at a time
    as adoption does, against its plain version at the decode limits."""
    from repro_torch.serving import kv_cache

    q, kp, vp, table, lens = _decode_inputs(
        cuda, torch.bfloat16, 128, 5, hkv=8, ps=128, pmax=13,
        lengths=[0, 1, 129, 700, 1500, 1532, 1663, 1664])
    axes = (1, 2, 3) if gran == "page" else (1, 3)
    (k8, ksc), (v8, vsc) = (kv_cache.quantize_symmetric(x, axes)
                            for x in (kp, vp))
    ksc, vsc = (x.expand(-1, 128, 8 if gran == "page_head" else 1, 1)
                .reshape((-1, 128, 8) if gran == "page_head" else (-1, 128))
                .contiguous() for x in (ksc, vsc))
    _check_decode(q, k8, v8, table, lens, torch.bfloat16, k_scale=ksc,
                  v_scale=vsc, strip=False, ppt=1)
    assert tda.decode_attention_paged_int8.launches == 2
    assert tda.decode_attention_paged.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("page_dtype", [None, "int8"])
def test_demote_promote_round_trip_on_the_card(cuda, page_dtype):
    """A slot's pages gathered to pinned host memory and scattered back
    into other pages are the same bytes; then an overloaded engine with
    the swap tier on demotes and promotes (never preempts), and its graph
    step, replaying after each promotion, gives the eager step's tokens
    and launches and the unpressured run's tokens."""
    from repro_torch.serving import kv_cache

    m, params = _fused_model()
    pool = kv_cache.init_paged_pool(m.cfg, 2, 48, page_size=8, pages=9,
                                    page_dtype=page_dtype, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for leaf in pool["kv"].values():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, device=cuda,
                                     generator=gen, dtype=torch.int8))
        else:
            leaf.copy_(torch.randn(leaf.shape, device=cuda, generator=gen))
    src = torch.tensor([1, 2, 3, 0, 0, 0], dtype=torch.int32)
    dst = torch.tensor([6, 4, 8, 0, 0, 0], dtype=torch.int32)
    dev = kv_cache.gather_slot(pool, src)
    blob = {n: torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
            for n, x in dev.items()}
    kv_cache.restore_slot_paged(pool, blob, 1, 20, dst)
    for n, leaf in pool["kv"].items():
        assert torch.equal(leaf[:, [6, 4, 8]], leaf[:, [1, 2, 3]]), n
        assert torch.equal(leaf[:, [6, 4, 8]].cpu(), blob[n][:, :3]), n
    assert pool["page_table"][1].tolist() == dst.tolist()

    reqs = [r for r in _fused_requests(m.cfg.vocab, n=5, new=14)]
    kw = dict(temperature=0.0, prefix_cache=False, page_dtype=page_dtype)
    runs = {f: _serve(m, params, True, f, reqs, host_swap_bytes=1 << 30,
                      **kw) for f in (True, False)}
    (toks, counts, eng), (toks_e, counts_e, eng_e) = runs[True], runs[False]
    st = eng.stats
    assert st["demoted"] == st["prefetched"] > 0 and st["preempted"] == 0
    assert eng.host_swap.bytes_used == 0
    assert eng.allocator.free_pages == eng.allocator.usable_pages
    assert toks == toks_e and counts == counts_e
    assert eng._fused.replays == st["steps"]
    roomy = m.serving_engine(params, slots=3, max_len=48, page_size=8,
                             **kw).run(reqs)
    assert toks == [c.tokens for c in roomy]


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
# (b, h, hkv, sq, skv, d, dv, causal): deepseek's 192 / 128, reduced
# deepseek's 24 / 16, stablelm-12b's 160 (GQA), 192 / 192 and 256 (ragged
# edges; the split forward) and 20 / 12 (no multiple of 8: the wmma
# kernels in bf16 too)
FLASH_V_DIMS = [(1, 16, 16, 300, 300, 192, 128, True),
                (2, 4, 4, 37, 37, 24, 16, True),
                (1, 2, 1, 45, 60, 20, 12, False),
                (1, 4, 2, 200, 200, 160, 160, True),
                (1, 2, 2, 150, 170, 192, 192, False),
                (1, 4, 2, 130, 130, 256, 256, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_V_DIMS,
                         ids=["d192-dv128", "d24-dv16", "d20-dv12", "d160",
                              "d192-dv192", "d256"])
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

    # bf16 with D and Dv multiples of 8 takes the mma kernels, forward and
    # backward; float32 and 20 / 12 the wmma / FFMA ones
    mma = dtype == torch.bfloat16 and d % 8 == 0 and dv % 8 == 0
    assert tfa.design(dtype, d, dv) == ("mma" if mma else "wmma")
    kinds = ("flash_fwd", "flash_dq", "flash_dkv")
    names = [x for x, _ in _launched_kernels(fwd_bwd, kinds)
             if any(k_ in x for k_ in kinds)]
    assert all(any(k_ in x for x in names) for k_ in kinds), names
    assert all(("_mma" in x) == mma for x in names), names


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


# ---------------------------------------------------------------------------
# The autotuner on the card (repro_torch.kernels.autotune).
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_autotune_decode_paged_on_the_card(cuda, tmp_path):
    """A sweep of kernel 3 at 8 slots x 256 positions in bf16: every
    candidate is whole pages within the kernel, the best is persisted under
    the gpu backend, and the kernel at the best block agrees with its plain
    version at the decode limits."""
    from repro_torch.kernels import autotune, registry

    t = str(tmp_path / "tune.json")
    res = autotune.autotune_op("decode_attention_paged", 8, 256,
                               torch.bfloat16, reps=1, min_time_s=0.005,
                               cache_file=t)
    ps = autotune.ATTN_PAGE_SIZE
    assert res.refused == {} and res.best in res.timings
    assert all(bc % ps == 0 and bc <= tda.MAX_TILE for _, bc in res.timings)
    assert res.cache_key == "decode_attention_paged|r8|c256|bfloat16|gpu"
    assert tda.decode_attention_paged.launches > 0
    registry.load_cache(t, force=True)
    assert registry.block_shapes("decode_attention_paged", 8, 256,
                                 torch.bfloat16, use_cache=True,
                                 backend="gpu", cache_file=t) == res.best
    q, kp, vp, pt, lens = autotune._inputs_for(
        "decode_attention_paged", 8, 256, torch.bfloat16, cuda)
    got = autotune._runner_for("decode_attention_paged")(
        (q, kp, vp, pt, lens), *res.best)
    torch.cuda.synchronize()
    ppt = max(1, res.best[1] // ps)
    want = tda.decode_attention_paged_plain(
        q, kp, vp, pt, lens, scale=q.shape[-1] ** -0.5,
        n_t_chunks=-(-pt.shape[1] // ppt))
    torch.testing.assert_close(got.float(), want.float(),
                               **DECODE_TOL[torch.bfloat16])
    registry.load_cache(t, force=True)


@pytest.mark.gpu
def test_autotune_refuses_past_the_kernel_before_any_launch(cuda, tmp_path,
                                                           monkeypatch):
    """Candidates past MAX_TILE or MAX_PAGES_PER_TILE never reach the
    kernel: with 16-token pages a 256-position block is 16 pages a tile,
    and a 512-position block is past the tile; with every candidate and
    the heuristic's block refused the sweep raises having launched
    nothing."""
    from repro_torch.kernels import autotune, registry

    t = str(tmp_path / "tune.json")
    x = autotune._inputs_for("decode_attention_paged", 8, 1024,
                             torch.bfloat16, cuda)
    pages16 = (x[0], x[1][:, :16], x[2][:, :16], x[3], x[4])
    assert "MAX_PAGES_PER_TILE" in autotune._refusal(
        "decode_attention_paged", 8, 256, pages16)
    monkeypatch.setattr(autotune, "_inputs_for", lambda *a: pages16)
    tk.reset_launch_counts()
    res = autotune.autotune_op("decode_attention_paged", 8, 1024,
                               torch.bfloat16, candidates=[(8, 256),
                                                           (8, 512)],
                               reps=1, min_time_s=0.005, cache_file=t)
    assert set(res.refused) == {(8, 256), (8, 512)}
    assert set(res.timings) == {(8, 128)}
    pages48 = (x[0], x[1][:, :48], x[2][:, :48], x[3], x[4])
    monkeypatch.setattr(autotune, "_inputs_for", lambda *a: pages48)
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="no viable block candidate"):
        autotune.autotune_op("decode_attention_paged", 8, 1024,
                             torch.bfloat16, candidates=[(8, 512)], reps=1,
                             min_time_s=0.005, cache_file=t)
    assert sum(tk.launch_counts().values()) == 0
    registry.load_cache(t, force=True)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_paged_over_512_token_pages(cuda, int8):
    """Pages of 512 tokens, the kv_page envelope's largest, are longer than
    the kernel's tile: kernel 3 folds them in tiles of MAX_TILE positions
    (the bf16 body for bf16 pages, the general one with scales for int8),
    against its plain version at the decode limits and, bf16, bit-equal to
    the strip at the same tile."""
    q, kp, vp, table, lens = _decode_inputs(
        cuda, torch.bfloat16, 128, 5, hkv=8, ps=512, pmax=4,
        lengths=[0, 1, 255, 256, 511, 513, 1500, 2048])
    if not int8:
        _check_decode(q, kp, vp, table, lens, torch.bfloat16, ppt=1)
        assert tda.decode_attention_paged.launches == 2
        return
    from repro_torch.serving import kv_cache

    (k8, ksc), (v8, vsc) = (kv_cache.quantize_symmetric(x, (1, 2, 3))
                            for x in (kp, vp))
    ksc, vsc = (x.expand(-1, 512, 1, 1).reshape(-1, 512).contiguous()
                for x in (ksc, vsc))
    _check_decode(q, k8, v8, table, lens, torch.bfloat16, k_scale=ksc,
                  v_scale=vsc, strip=False, ppt=1)
    assert tda.decode_attention_paged_int8.launches == 2


# ---------------------------------------------------------------------------
# Training of the families without experts: kernels 12-13 at the shapes
# their train steps give them, kernels 9-11 at their (d, vocab), and each
# reduced family's train step, kernel route against plain route.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "whisper_encoder", "whisper_cross", "whisper_encoder_f32",
    "whisper_cross_f32", "whisper_decoder", "qwen2vl_g7",
    "hymba_g5_window"])
def test_flash_kernels_at_the_family_train_shapes(cuda, case):
    # o, lse, dq, dk, dv within chip_smoke.py's derived limits plus one bf16
    # step, the same bits twice (a failed check raises SystemExit)
    cs = _chip_smoke()
    c = cs.flash_check(torch, case, cs.FAM_FLASH[case])
    assert all(over <= 1.0 for _, over in c["res"].values()), c["res"]


@pytest.mark.gpu
@pytest.mark.parametrize("d,v", [(512, 51968), (2048, 65536),
                                 (3584, 152064), (1600, 32128),
                                 (512, 51865), (1600, 32001)])
def test_lmhead_kernels_at_the_family_vocabularies(cuda, d, v):
    # 130 tokens (a ragged token tile) at each family's d and padded vocab,
    # and at the configs' own 51,865 and 32,001, whose bf16 w rows are not
    # 16-byte aligned (the cp.async loads); chip_smoke.py's derived limits
    cs = _chip_smoke()
    c = cs.lmhead_check(torch, f"t130_d{d}_v{v}", (130, d, v),
                        torch.bfloat16)
    assert all(over <= 1.0 for _, over in c["res"].values()), c["res"]
    counts = tk.launch_counts()
    assert counts["lmhead_xent_fwd_2d"] == 2
    assert counts["lmhead_xent_dh_2d"] == counts["lmhead_xent_dw_2d"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-base",
                                  "qwen2-vl-7b", "hymba-1.5b"])
def test_family_train_step_kernels_equal_plain(cuda, arch):
    # reduced and float32: the kernels (flash on FFMA, the fused LM-head CE)
    # and the plain route differ only in float32 summation order
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import step_fn

    mk = build_model(arch, reduced=True, use_kernels=True)
    mp = build_model(arch, reduced=True)
    cfg = mk.cfg
    params = mk.init(seed=0)
    batch = {k: torch.from_numpy(x).to(cuda) for k, x in SyntheticLM(
        cfg, ShapeCell("t", 40, 2, "train"), seed=0).batch_at(0).items()}
    tk.reset_launch_counts()
    lk, gk = step_fn.loss_and_grads(mk, params, batch)
    counts = tk.launch_counts()
    tk.reset_launch_counts()
    lp, gp = step_fn.loss_and_grads(mp, params, batch)
    assert not any(tk.launch_counts().values())
    att = {"ssm": 0, "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)
    assert counts["flash_attention_fwd_gqa"] == att * (2 if cfg.remat
                                                        else 1)
    assert counts["flash_attention_bwd_gqa"] == att
    assert all(counts[k] == 8 for k in ("lmhead_xent_fwd_2d",
                                        "lmhead_xent_dh_2d",
                                        "lmhead_xent_dw_2d"))
    torch.testing.assert_close(lk, lp, atol=0, rtol=1e-5)
    for a, b in zip(adamw.leaves(gk), adamw.leaves(gp)):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-9


# ---------------------------------------------------------------------------
# Training of the moe family (granite-moe-3b-a800m, deepseek-v2-lite-16b):
# kernels 12-13 at their train shapes cut in length, kernel 1 on the
# router's rows of one 4,095-token group, and each reduced model's train
# step under each moe_impl, kernel route against plain route.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("case", ["granite_moe_g3", "deepseek_d192_dv128"])
def test_flash_kernels_at_the_moe_train_shapes(cuda, case):
    # the step's heads and head dims (G 3, D 64; D 192 / Dv 128) over
    # 1,023 of its 4,095 positions, causal, bf16, within chip_smoke.py's
    # derived limits, the same bits twice
    cs = _chip_smoke()
    shape = cs.FAM_FLASH[case]
    assert shape[3] == shape[4] == 4095
    c = cs.flash_check(torch, f"{case}_1023", (*shape[:3], 1023, 1023,
                                               *shape[5:]))
    assert all(over <= 1.0 for _, over in c["res"].values()), c["res"]


@pytest.mark.gpu
@pytest.mark.parametrize("experts", [40, 64])
def test_twopass_softmax_on_the_train_router_rows(cuda, experts):
    # [4095, E] float32, the router's rows of one train group; the op's
    # backward is the analytic VJP from y alone, so no second launch
    gen = torch.Generator(device=cuda).manual_seed(experts)
    x = torch.randn((4095, experts), device=cuda, generator=gen) * 4
    got = tp.twopass_softmax_2d(x)
    torch.testing.assert_close(got, tp.twopass_softmax_2d_plain(x), **F32)
    assert tp.path_for(experts) == "registers"
    dy = torch.randn((4095, experts), device=cuda, generator=gen)
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    ops.softmax(xk).backward(dy)
    torch.softmax(xp, -1).backward(dy)
    torch.testing.assert_close(xk.grad, xp.grad, **F32)
    assert tp.twopass_softmax_2d.launches == 2


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["dense", "dispatch", "gather"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_train_step_kernels_equal_plain(cuda, arch, impl):
    # reduced and float32: the kernels (the router's softmax, flash on
    # FFMA at D 16 or 24 / Dv 16, the fused LM-head CE) and the plain
    # route differ only in float32 summation order, so both routes pick
    # the same experts and drop the same (token, k) pairs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import step_fn

    mk = build_model(arch, reduced=True, use_kernels=True)
    mp = build_model(arch, reduced=True)
    cfg = mk.cfg
    params = mk.init(seed=0)
    batch = {k: torch.from_numpy(x).to(cuda) for k, x in SyntheticLM(
        cfg, ShapeCell("t", 40, 2, "train"), seed=0).batch_at(0).items()}
    tk.reset_launch_counts()
    lk, gk = step_fn.loss_and_grads(mk, params, batch, moe_impl=impl)
    counts = tk.launch_counts()
    tk.reset_launch_counts()
    lp, gp = step_fn.loss_and_grads(mp, params, batch, moe_impl=impl)
    assert not any(tk.launch_counts().values())
    per_layer = 2 if cfg.remat else 1
    assert counts["twopass_softmax_2d"] == cfg.n_layers * per_layer
    assert counts["flash_attention_fwd_gqa"] == cfg.n_layers * per_layer
    assert counts["flash_attention_bwd_gqa"] == cfg.n_layers
    assert all(counts[k] == 8 for k in ("lmhead_xent_fwd_2d",
                                        "lmhead_xent_dh_2d",
                                        "lmhead_xent_dw_2d"))
    torch.testing.assert_close(lk, lp, atol=0, rtol=1e-5)
    for a, b in zip(adamw.leaves(gk), adamw.leaves(gp)):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-9
    assert gk["blocks"]["mlp"]["router"]["w"].dtype == torch.float32
