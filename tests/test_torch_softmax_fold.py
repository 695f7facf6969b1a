"""The fold order of the port's row-wise softmax kernels, emulated on the
CPU in float32 one rounded operation at a time, as ``csrc/rowfold.cuh``
writes it, on the port's own ``core/numerics`` ExtExp and ``exp2_int``.

The CUDA kernels cannot run here.  These tests hold the arithmetic their
layouts rest on, bit for bit:

* a lane's 8 columns of a chunk folded max-first (``lane_fold``: the
  largest n, then sum m 2^(n_e - n)) give the bits of the sequential
  ``ext_add`` fold that ``row_stats`` ran before;
* ``exp2_int`` through the exponent-field add gives the bits of the
  float-to-int form for every integral ``n`` it is called with;
* the register layout (``butterfly_scatter``, then ``slots_in_warp`` or
  shared slots) and the split layout (``slot_fold`` a slot, then the slot
  butterfly) give the bits of the one-block order of ``row_stats`` and of
  its float sum, whatever the warps a block, for the two-pass (m, n) fold
  and recompute's float sum;
* reload's split launch 2, which stores e at its columns and sums what it
  stored, and the stats' fold launch over the slot scratch, give those
  bits too; reload's pass 3 reads each column once, and every load takes a
  column that another lane stored.
"""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - exercised on bare envs
    from _hypothesis_fallback import given, settings, st

from repro_torch.core import numerics as nm
from repro_torch.kernels import threepass_softmax as tp3
from repro_torch.kernels import twopass_softmax as tp

LANES, PER_LANE, CHUNK = 32, 8, 256
LANE = torch.arange(LANES)
BATCH = 4                                  # rowfold.cuh kBatch


# ---------------------------------------------------------------------------
# The device arithmetic, op by op.
# ---------------------------------------------------------------------------
def exp2_int_device(n: torch.Tensor) -> torch.Tensor:
    """extexp.cuh's exp2_int: n + 2^23 + 127 leaves n + 127 in the low
    mantissa bits; a 32-bit shift by 23 moves them into the exponent."""
    n = n.clamp(-127.0, 127.0)
    bits = (n + 8388735.0).view(torch.int32).to(torch.int64)
    return ((bits << 23) & 0xFFFFFFFF).to(torch.int32).view(torch.float32)


def ext_combine(a, b):
    s = nm.ext_add(nm.ExtFloat(*a), nm.ExtFloat(*b))
    return (s.mantissa, s.exponent)


def sum_combine(a, b):
    return (a[0] + b[0],)


def ext_ident(shape):
    z = nm.ext_zero(shape)
    return (z.mantissa, z.exponent)


def sum_ident(shape):
    return (torch.zeros(shape),)


def where(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def shfl_xor(v, off):
    return tuple(t[..., LANE ^ off] for t in v)


def shfl(v, src):
    return tuple(t[..., src:src + 1].expand_as(t) for t in v)


def butterfly(v, combine, offs=(16, 8, 4, 2, 1)):
    """warp_fold / warp_sum over the last (lane) dimension."""
    for off in offs:
        v = combine(v, shfl_xor(v, off))
    return v


def butterfly_scatter(vs, combine):
    """rowfold.cuh's butterfly_scatter on K values, lanes last."""
    vs = list(vs)
    k = len(vs)
    q = k.bit_length() - 1
    for r in range(q):
        h, off = k >> (r + 1), 16 >> r
        upper = (LANE & off) != 0
        for i in range(h):
            keep = where(upper, vs[i + h], vs[i])
            send = where(upper, vs[i], vs[i + h])
            vs[i] = combine(keep, shfl_xor(send, off))
    return butterfly(vs[0], combine, [16 >> q >> s for s in range(5 - q)])


# ---------------------------------------------------------------------------
# Lane values: x [R, C] laid out [R, chunk, e, lane] (column 256 j + 32 e +
# l), missing columns loaded as -inf.
# ---------------------------------------------------------------------------
def lanes(x: torch.Tensor, chunks: int):
    r, c = x.shape
    pad = torch.full((r, chunks * CHUNK), -torch.inf)
    pad[:, :c] = x
    valid = (torch.arange(chunks * CHUNK) < c).reshape(chunks, PER_LANE,
                                                       LANES)
    return pad.reshape(r, chunks, PER_LANE, LANES), valid


def ext_lane_sequential(m, n, valid):
    """The fold row_stats ran before: ext_add column by column, a missing
    column skipped.  m, n [..., e, lane]; valid broadcasts to them."""
    acc = ext_ident(m[..., 0, :].shape)
    for e in range(PER_LANE):
        acc = where(valid[..., e, :],
                    ext_combine(acc, (m[..., e, :], n[..., e, :])), acc)
    return acc


def ext_lane_max_first(m, n):
    """rowfold.cuh's lane_fold, a missing column as ExtExp(-inf)."""
    ns = n[..., 0, :]
    for e in range(1, PER_LANE):
        ns = torch.maximum(ns, n[..., e, :])
    ms = torch.zeros_like(ns)
    for e in range(PER_LANE):
        ms = ms + m[..., e, :] * exp2_int_device(n[..., e, :] - ns)
    return (ms, ns)


def sum_lane(x, mu, valid=None):
    """The one-block float sum's lane sum (a missing column skipped when
    ``valid`` is given) or recompute's lane_sum (a missing column adds
    e(-inf) = +0)."""
    acc = torch.zeros_like(x[..., 0, :])
    for e in range(PER_LANE):
        t = acc + tp3._exp_nonpos(x[..., e, :] - mu)
        acc = t if valid is None else torch.where(valid[..., e, :], t, acc)
    return (acc,)


# ---------------------------------------------------------------------------
# The three orders.
# ---------------------------------------------------------------------------
def block_order(lane_vals, combine, ident, warps: int):
    """row_stats and its float sum with ``warps`` warps a block: warp w folds chunk
    j = w, w + W, ... (butterfly), the lane of slot j % 32 adds it to the
    slot, then the butterfly over the 32 slots.  lane_vals [R, J, 32]."""
    r, chunks = lane_vals[0].shape[:2]
    slots = [ident((r,)) for _ in range(LANES)]
    for w in range(warps):
        for j in range(w, chunks, warps):
            cv = butterfly(tuple(t[:, j] for t in lane_vals), combine)
            slot = j % LANES
            slots[slot] = combine(slots[slot], tuple(t[:, 0] for t in cv))
    sv = tuple(torch.stack([s[i] for s in slots], -1)
               for i in range(len(slots[0])))
    return tuple(t[:, 0] for t in butterfly(sv, combine))


def regs_shape(cols: int):
    """rowfold.cuh's regs_shape: (chunks a warp, warps a row)."""
    chunks = -(-cols // CHUNK)
    if chunks <= 4:
        return (1 if chunks <= 1 else 2 if chunks <= 2 else 4), 1
    return 4, -(-chunks // 4)


def register_order(lane_vals, combine, ident, cols: int):
    """The register layout: warp w holds chunks w K .. w K + K - 1, folds
    them with butterfly_scatter, then slots_in_warp (one warp a row) or
    the butterfly over __shared__ slots.  lane_vals [R, W K, 32]."""
    k, w = regs_shape(cols)
    r = lane_vals[0].shape[0]
    v = tuple(t[:, :w * k].reshape(r, w, k, LANES) for t in lane_vals)
    x = butterfly_scatter([tuple(t[:, :, i] for t in v) for i in range(k)],
                          combine)                          # [R, W, 32]
    if w == 1:
        x = butterfly(x, combine, [o for o in (16, 8, 4, 2, 1)
                                   if o >= LANES // k])
        return tuple(t[:, 0, 0] for t in x)
    span = LANES // k
    sm = tuple(t[:, :, ::span].reshape(r, w * k) for t in x)
    full = ident((r, LANES))
    sm = tuple(torch.cat([a, f[:, w * k:]], -1) for a, f in zip(sm, full))
    return tuple(t[:, 0] for t in butterfly(sm, combine))


def split_order(lane_vals, combine, ident):
    """The split layout: warp (row, slot s) folds chunks s, s + 32, ... in
    batches of 4 (butterfly_scatter, then in order into the slot), then
    the butterfly over the 32 slot values.  lane_vals [R, J, 32] with J a
    multiple of 128 (missing chunks are -inf lanes)."""
    r, chunks = lane_vals[0].shape[:2]
    g = chunks // (LANES * BATCH)
    v = tuple(t.reshape(r, g, BATCH, LANES, LANES) for t in lane_vals)
    acc = ident((r, LANES, LANES))                 # [R, slot, lane]
    for gi in range(g):
        w = butterfly_scatter([tuple(t[:, gi, b] for t in v)
                               for b in range(BATCH)], combine)
        for b in range(BATCH):
            acc = combine(acc, shfl(w, b * (LANES // BATCH)))
    slots = tuple(t[:, :, 0] for t in acc)
    return tuple(t[:, 0] for t in butterfly(slots, combine))


def bits(v):
    return tuple(t.contiguous().view(torch.int32) for t in v)


def assert_bits_equal(a, b):
    for x, y in zip(bits(a), bits(b)):
        assert torch.equal(x, y)


def rows_with_edges(cols: int, r: int = 4, seed: int = 0) -> torch.Tensor:
    """Seeded float32 rows of spreads 8 to 1e4, one with 20 % -inf columns
    and one with a -inf tail."""
    rng = np.random.default_rng(seed + cols)
    x = rng.standard_normal((r, cols)).astype(np.float32)
    x *= np.array([8, 100, 1e4, 8][:r], np.float32)[:, None]
    x[0, rng.random(cols) < 0.2] = -np.inf
    x[-1, cols // 2 + 1:] = -np.inf
    return torch.from_numpy(x)


# ---------------------------------------------------------------------------
# Tests.
# ---------------------------------------------------------------------------
def test_exp2_int_exponent_field_equals_conversion():
    n = torch.cat([torch.arange(-127, 128, dtype=torch.float32),
                   torch.tensor([-0.0, -1e38, -1e4, -128.0, 128.0, 1e4,
                                 1e38])])
    got, want = exp2_int_device(n), nm.exp2_int(n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    nonpos = n[n <= 0]                  # exp2_int_nonpos: no upper clamp
    assert torch.equal(exp2_int_device(nonpos.clamp(min=-127.0)),
                       nm.exp2_int(nonpos))
    assert got[0] == 0.0                       # n <= -127 flushes to zero
    assert torch.equal(got[1:255], torch.exp2(torch.arange(-126.0, 128.0)))


def exp_nonpos_lean(t: torch.Tensor) -> torch.Tensor:
    """threepass_softmax.cu's exp_nonpos: ExtExp and exp2_int without the
    upper clamps and the +-inf cases, which cannot matter at t <= 0."""
    xc = torch.maximum(t, torch.tensor(-nm._X_CLAMP))
    n = torch.round(xc * nm.LOG2E)
    r = xc - n * nm.LN2_HI
    r = r - n * nm.LN2_LO
    r = r.clamp(-nm._T_CLAMP, nm._T_CLAMP)
    p = r * nm.EXP_C5 + nm.EXP_C4
    p = p * r + nm.EXP_C3
    p = p * r + nm.EXP_C2
    p = p * r + nm.EXP_C1
    m = p * r + 1.0
    return m * exp2_int_device(torch.maximum(n, torch.tensor(-127.0)))


def test_lean_exp_nonpos_equals_ext_exp_rebuilt():
    """For t <= 0 (the three-pass kernels' x - mu) the lean form gives the
    bits of ExtExp rebuilt as m * exp2_int(n), -inf and deep underflow
    included."""
    rng = np.random.default_rng(5)
    t = -np.abs(np.concatenate([
        rng.standard_normal(200000) * s for s in (1, 30, 1e3, 1e6, 1e30)]))
    t = torch.from_numpy(np.concatenate(
        [t, [0.0, -0.0, -87.3, -88.7, -103.0, -1e37, -3e38, -np.inf]])
        .astype(np.float32))
    assert torch.equal(exp_nonpos_lean(t).view(torch.int32),
                       tp3._exp_nonpos(t).view(torch.int32))


@pytest.mark.parametrize("scale", [1.0, 10.0, 100.0, 1e3, 1e4])
def test_max_first_lane_fold_equals_sequential(scale):
    rng = np.random.default_rng(int(scale))
    x = (rng.standard_normal((50000, PER_LANE, 1)) * scale).astype(
        np.float32)
    x[rng.random(x.shape) < 0.2] = -np.inf
    x[:100] = -np.inf                                  # all -inf lanes
    x[100:110, 3] = np.inf
    valid = torch.from_numpy(
        np.arange(PER_LANE)[None, :, None]
        < rng.integers(1, PER_LANE + 1, (x.shape[0], 1, 1)))
    xt = torch.from_numpy(x)
    m, n = nm.ext_exp(xt)
    want = ext_lane_sequential(m, n, valid)
    xm = torch.where(valid, xt, -torch.inf)           # missing as -inf
    got = ext_lane_max_first(*nm.ext_exp(xm))
    assert_bits_equal(got, want)


@given(st.lists(st.floats(-1e4, 1e4, width=32), min_size=1, max_size=8),
       st.integers(0, 255))
@settings(max_examples=200, deadline=None)
def test_max_first_lane_fold_equals_sequential_property(vals, neg_inf):
    x = torch.full((PER_LANE, 1), -torch.inf)
    x[:len(vals), 0] = torch.tensor(vals, dtype=torch.float32)
    for e in range(PER_LANE):
        if neg_inf >> e & 1:
            x[e, 0] = -torch.inf
    valid = (torch.arange(PER_LANE) < len(vals))[:, None]
    m, n = nm.ext_exp(x)
    assert_bits_equal(ext_lane_max_first(m, n),
                      ext_lane_sequential(m, n, valid))


def _orders(x: torch.Tensor, cols: int, pad_chunks: int):
    """Lane values of x under the sequential (block) and max-first
    (register, split) lane folds, for the (m, n) fold and recompute's
    sum, with the row's true chunk count and padded to ``pad_chunks``."""
    chunks = -(-cols // CHUNK)
    xl, valid = lanes(x, pad_chunks)
    m, n = nm.ext_exp(xl)
    seq = tuple(t[:, :chunks] for t in ext_lane_sequential(m, n, valid))
    mf = ext_lane_max_first(m, n)
    mu = x.amax(dim=1)[:, None, None]
    s_seq = tuple(t[:, :chunks] for t in sum_lane(xl, mu, valid))
    s_new = sum_lane(xl, mu)
    return seq, mf, s_seq, s_new


@pytest.mark.parametrize("warps", [1, 4, 32])
@pytest.mark.parametrize("cols", [1000, 8193, 152064])
def test_split_layout_equals_block_order(cols, warps):
    """Per-slot folds then the 32-slot butterfly (the long-row path) give
    row_stats' bits and its float sum's at any warps a block."""
    x = rows_with_edges(cols, r=3)
    pad = -(-cols // (CHUNK * LANES * BATCH)) * LANES * BATCH
    seq, mf, s_seq, s_new = _orders(x, cols, pad)
    assert_bits_equal(split_order(mf, ext_combine, ext_ident),
                      block_order(seq, ext_combine, ext_ident, warps))
    assert_bits_equal(split_order(s_new, sum_combine, sum_ident),
                      block_order(s_seq, sum_combine, sum_ident, warps))


@pytest.mark.parametrize("cols", [1, 31, 255, 256, 257, 1000, 1024, 1025,
                                  1664, 4096, 8192])
def test_register_layout_equals_block_order(cols):
    """The register path at every launch shape it takes (K = 1, 2, 4
    chunks a warp, 1 to 8 warps a row) gives row_stats' bits and its float
    sum's, at the threads the one-block kernels take for the row."""
    x = rows_with_edges(cols)
    k, w = regs_shape(cols)
    seq, mf, s_seq, s_new = _orders(x, cols, k * w)
    warps = tp.threads_for(cols) // LANES
    assert_bits_equal(register_order(mf, ext_combine, ext_ident, cols),
                      block_order(seq, ext_combine, ext_ident, warps))
    assert_bits_equal(register_order(s_new, sum_combine, sum_ident, cols),
                      block_order(s_seq, sum_combine, sum_ident, warps))


def test_register_layout_stats_equal_the_plain_stats_where_exact():
    """The emulated register fold's n_sum is the plain version's (a max,
    exact) and its m_sum within the sum-order tolerance."""
    x = rows_with_edges(1000)
    seq, mf, _, _ = _orders(x, 1000, 4)
    m, n = register_order(mf, ext_combine, ext_ident, 1000)
    pm, pn = tp.twopass_stats_2d_plain(x)
    assert torch.equal(n, pn[:, 0])
    torch.testing.assert_close(m, pm[:, 0], atol=0, rtol=1e-5)


def reload_stored(x: torch.Tensor, pad_chunks: int):
    """Reload's launch 2 (and its register pass 2): lane l of chunk j stores
    e(x - mu) of column 256 j + 32 i + l at that column of a float32 buffer
    (a missing column is not stored) and sums, in i order, what it stored
    (a missing column adds e(-inf) = +0).  Returns the buffer, how often
    each column was stored, and the lane sums [R, J, 32]."""
    r, cols = x.shape
    xl, _ = lanes(x, pad_chunks)
    mu = x.amax(dim=1)[:, None, None]
    col = (torch.arange(pad_chunks)[:, None, None] * CHUNK
           + torch.arange(PER_LANE)[None, :, None] * LANES + LANE)
    buf = torch.full((r, pad_chunks * CHUNK), torch.nan)
    stores = torch.zeros(pad_chunks * CHUNK, dtype=torch.int64)
    acc = torch.zeros(r, pad_chunks, LANES)
    for i in range(PER_LANE):
        ev = exp_nonpos_lean(xl[:, :, i, :] - mu)
        c = col[:, i, :]
        keep = c < cols
        buf[:, c[keep]] = ev[:, keep]
        stores[c[keep]] += 1
        acc = acc + buf[:, c].where(keep, ev)     # the value it stored
    return buf[:, :cols], stores[:cols], (acc,)


@pytest.mark.parametrize("warps", [1, 8, 32])
@pytest.mark.parametrize("cols", [1000, 8193, 152064])
def test_reload_split_sum_equals_block_order(cols, warps):
    """Reload's e buffer holds the plain version's e at every column,
    stored once, and the split layout's sum of the stored values gives the
    one-block float sum's bits."""
    x = rows_with_edges(cols, r=3)
    pad = -(-cols // (CHUNK * LANES * BATCH)) * LANES * BATCH
    buf, stores, lane_sums = reload_stored(x, pad)
    mu = x.amax(dim=1, keepdim=True)
    assert torch.equal(buf.view(torch.int32),
                       tp3._exp_nonpos(x - mu).view(torch.int32))
    assert bool((stores == 1).all())
    _, _, s_seq, _ = _orders(x, cols, pad)
    assert_bits_equal(split_order(lane_sums, sum_combine, sum_ident),
                      block_order(s_seq, sum_combine, sum_ident, warps))


@pytest.mark.parametrize("cols", [8193, 20000, 152064])
def test_stats_fold_launch_equals_row_stats(cols):
    """The stats' split path: launch A's slot pairs written to the [rows,
    32, 2] scratch (m at even, n at odd offsets) and folded by one warp a
    row, lane l reading slot l, give row_stats' bits at the threads it ran
    with; n_sum is the plain version's (a max, exact)."""
    x = rows_with_edges(cols, r=3)
    pad = -(-cols // (CHUNK * LANES * BATCH)) * LANES * BATCH
    seq, mf, _, _ = _orders(x, cols, pad)
    r, chunks = mf[0].shape[:2]
    v = tuple(t.reshape(r, chunks // (LANES * BATCH), BATCH, LANES, LANES)
              for t in mf)
    acc = ext_ident((r, LANES, LANES))
    for gi in range(v[0].shape[1]):
        w = butterfly_scatter([tuple(t[:, gi, b] for t in v)
                               for b in range(BATCH)], ext_combine)
        for b in range(BATCH):
            acc = ext_combine(acc, shfl(w, b * (LANES // BATCH)))
    scratch = torch.stack([acc[0][:, :, 0], acc[1][:, :, 0]], -1)
    flat = scratch.reshape(-1)                     # [rows, 32, 2] in memory
    idx = (torch.arange(r)[:, None] * LANES + LANE) * 2
    got = butterfly((flat[idx], flat[idx + 1]), ext_combine)
    got = tuple(t[:, 0] for t in got)
    assert_bits_equal(got, block_order(seq, ext_combine, ext_ident,
                                       tp.threads_for(cols) // LANES))
    assert torch.equal(got[1], tp.twopass_stats_2d_plain(x)[1][:, 0])


def pass3_loads(cols: int):
    """Reload's register pass 3 for a row of ``cols`` columns: per load, the
    columns it reads and the lane that issues it, and the lane that stored
    each column in pass 2 (column 256 j + 32 i + l by lane l)."""
    k, w = regs_shape(cols)
    loads = []
    for warp in range(w):
        c0 = warp * k * CHUNK
        for lane in range(LANES):
            if cols % 4 == 0:                       # 16-byte loads
                for i in range(k * CHUNK // (4 * LANES)):
                    c = c0 + 4 * (i * LANES + lane)
                    if c < cols:
                        loads.append((lane, list(range(c, c + 4))))
            else:                                   # the neighbour's column
                for j in range(k):
                    for i in range(PER_LANE):
                        c = c0 + j * CHUNK + i * LANES + (lane + 1) % LANES
                        if c < cols:
                            loads.append((lane, [c]))
    return loads


@pytest.mark.parametrize("cols", [1, 31, 256, 257, 1000, 1024, 1025, 1664,
                                  4096, 8190, 8192])
def test_reload_pass3_reads_what_other_lanes_stored(cols):
    """Pass 3 reads every column once, within the warp that stored it, and
    every load takes at least one column another lane stored, so no load
    can be served from the issuing lane's registers."""
    loads = pass3_loads(cols)
    read = sorted(c for _, cs in loads for c in cs)
    assert read == list(range(cols))
    k, _ = regs_shape(cols)
    for lane, cs in loads:
        assert len({c // (k * CHUNK) for c in cs}) == 1   # one warp's span
        assert any(c % LANES != lane for c in cs)


def test_layout_named_by_row_length():
    assert tp.path_for(1) == tp.path_for(8192) == "registers"
    assert tp.path_for(8193) == tp.path_for(152064) == "split"
    assert tp.slot_scratch(torch.empty(3, 8192)) is None
    s = tp.slot_scratch(torch.empty(3, 8193))
    assert s.shape == (3, tp.SLOTS, 2) and s.dtype == torch.float32
    # all four kernels take the layout path_for names: the split one with
    # the slot scratch, and reload with its float32 e buffer for bfloat16
    for cols in (8192, 8193):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.empty(3, cols, dtype=dt)
            e, slots = tp3.reload_scratch(x)
            assert (slots is None) == (tp.path_for(cols) == "registers")
            assert (e is None) == (dt == torch.float32)
            if e is not None:
                assert e.shape == (3, cols) and e.dtype == torch.float32
