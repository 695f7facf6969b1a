"""The fused LM-head CE backward that computes each vocab slab's dlogits
once for both dh and dw (``lmhead_xent_bwd_2d``), on the CPU: its plain
version against the separate plain dh and dw (bit for bit) and against the
reference's Pallas kernels (interpret mode), the op's backward against the
reference's VJP, and a model of the shared-memory layout of the bf16
product core (``wg_tile`` in ``csrc/lmhead_xent.cu``, shared by the
backward and the forward) that the ``wgmma`` descriptors read."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import twopass_xent as jxe
from repro_torch.kernels import ops
from repro_torch.kernels import twopass_xent as txe


def _inputs(t, d, v, seed=0, label_outside=True):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    if label_outside:
        labels[0] = -1                               # gathers 0
    dl = rng.standard_normal(t).astype(np.float32)
    return h, w, labels, dl


def _torch_args(h, w, labels, dl, dtype=torch.float32):
    ht, wt = torch.from_numpy(h).to(dtype), torch.from_numpy(w).to(dtype)
    lab = torch.from_numpy(labels)
    _, m, n = txe.lmhead_xent_fwd_2d_plain(ht, wt, lab)
    return ht, wt, lab, m, n, torch.from_numpy(dl)


# ---------------------------------------------------------------------------
# The plain fused backward: one dlogits pass feeding both sums.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block_v", [64, 128, 512, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plain_equals_separate_plain(block_v, dtype):
    # the same float32 operations in the same order: equal bits
    args = _torch_args(*_inputs(37, 24, 1000), dtype)
    n = txe.lmhead_v_chunks(1000, block_v)
    dh, dw = txe.lmhead_xent_bwd_2d_plain(*args, n)
    assert torch.equal(dh, txe.lmhead_xent_dh_2d_plain(*args, n))
    assert torch.equal(dw, txe.lmhead_xent_dw_2d_plain(*args, n))
    # on the CPU the wrapper is its plain version
    wdh, wdw = txe.lmhead_xent_bwd_2d(*args, block_v=block_v)
    assert torch.equal(wdh, dh) and torch.equal(wdw, dw)


def test_fused_wrapper_counts_no_launch_on_the_cpu():
    from repro_torch import kernels as tk

    tk.reset_launch_counts()
    txe.lmhead_xent_bwd_2d(*_torch_args(*_inputs(8, 16, 40)), block_v=16)
    counts = tk.launch_counts()
    assert counts["lmhead_xent_dh_2d"] == counts["lmhead_xent_dw_2d"] == 0


@pytest.mark.parametrize("t,v,v_pad", [(48, 384, 384), (48, 300, 384),
                                       (32, 256, 256)])
def test_fused_plain_matches_reference_kernels(t, v, v_pad):
    # the reference's dh and dw kernels (Pallas, interpret mode) take w
    # zero-padded to a block_v multiple with v_len the true width; both
    # sides take the reference forward's stats.  Tolerance as
    # test_lmhead_matches_reference: float32 sums in other orders.
    h, w, labels, dl = _inputs(t, 32, v, seed=t + v,
                               label_outside=v == v_pad)
    wp = np.zeros((32, v_pad), np.float32)
    wp[:, :v] = w
    jargs = (jnp.asarray(h), jnp.asarray(wp), jnp.asarray(labels))
    _, m, n = jxe.lmhead_xent_fwd_2d(*jargs, block_t=16, block_v=128,
                                     v_len=v)
    kw = dict(block_t=16, block_v=128, v_len=v)
    want_dh = np.asarray(jxe.lmhead_xent_dh_2d(*jargs, m, n,
                                               jnp.asarray(dl), **kw))
    want_dw = np.asarray(jxe.lmhead_xent_dw_2d(*jargs, m, n,
                                               jnp.asarray(dl), **kw))[:, :v]
    dh, dw = txe.lmhead_xent_bwd_2d_plain(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels),
        torch.from_numpy(np.array(m)), torch.from_numpy(np.array(n)),
        torch.from_numpy(dl), txe.lmhead_v_chunks(v, 128))
    np.testing.assert_allclose(dh.numpy(), want_dh, atol=5e-5)
    np.testing.assert_allclose(dw.numpy(), want_dw, atol=5e-5)


@pytest.mark.parametrize("jimpl", ["pallas", "twopass"])
@pytest.mark.parametrize("t,v", [(40, 300), (37, 1000)])
def test_op_backward_matches_reference_vjp(jimpl, t, v):
    # the op's backward goes through lmhead_xent_bwd_2d (its plain version
    # here); the reference's through its VJP
    h, w, labels, dl = _inputs(t, 32, v, seed=3, label_outside=False)

    def f(h_, w_):
        return jops.lmhead_cross_entropy(h_, w_, jnp.asarray(labels), None,
                                         None, None, jimpl)
    _, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(w))
    want = [np.asarray(x) for x in vjp(jnp.asarray(dl))]
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    ops.lmhead_cross_entropy(ht, wt, torch.from_numpy(labels),
                             impl="cuda").backward(torch.from_numpy(dl))
    for got, ref in zip((ht.grad, wt.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)


# ---------------------------------------------------------------------------
# The bf16 product core's shared memory: a model of kmajor_off /
# mnmajor_off (csrc/lmhead_xent.cu) and of what a wgmma descriptor reads,
# so that a layout fault shows before the card.  A k tile is BK = 64 or 32
# deep: K-major rows of 2 BK bytes (128- or 64-byte swizzle), MN-major
# atoms of 64 columns by BK k rows (128-byte swizzle).  Offsets are bytes
# from a 1024-byte aligned tile; a 16-byte chunk's bank group is
# (offset / 16) % 8 (32 banks of 4 bytes).
# ---------------------------------------------------------------------------
def kmajor_off(r, c, bk):
    if bk == 64:
        return r * 128 + ((c ^ (r & 7)) << 4)
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4)


def mnmajor_off(k, cm, bk):
    return ((cm >> 3) * (bk * 128) + (k >> 3) * 1024 + (k & 7) * 128
            + (((cm & 7) ^ (k & 7)) << 4))


def swizzle(addr, row_bytes):
    """The hardware's swizzle of 128-byte (bits 4-6 ^= bits 7-9) or
    64-byte (bits 4-5 ^= bits 7-8) rows."""
    mask = 7 if row_bytes == 128 else 3
    return addr ^ (((addr >> 7) & mask) << 4)


def _tile_map(kind, extent, bk):
    """[rows, chunks] offsets: K-major rows are m or n, MN-major rows k."""
    if kind == "k":
        r, c = torch.meshgrid(torch.arange(extent), torch.arange(bk // 8),
                              indexing="ij")
        return kmajor_off(r, c, bk)
    k, cm = torch.meshgrid(torch.arange(bk), torch.arange(extent // 8),
                           indexing="ij")
    return mnmajor_off(k, cm, bk)


TILES = [(kind, extent, bk) for kind in ("k", "mn") for extent in (128, 256)
         for bk in (32, 64)]


@pytest.mark.parametrize("kind,extent,bk", TILES)
def test_core_tile_map_is_a_permutation(kind, extent, bk):
    # every (row, 16-byte chunk) of a k tile on its own address, all inside
    # the tile's extent * bk * 2 bytes
    off = _tile_map(kind, extent, bk)
    assert off.numel() * 16 == extent * bk * 2
    assert torch.equal(torch.sort(off.flatten()).values,
                       torch.arange(0, extent * bk * 2, 16))


@pytest.mark.parametrize("kind,extent,bk", TILES)
def test_core_reads_hit_eight_bank_groups(kind, extent, bk):
    # a descriptor (or ldmatrix) read takes one 16-byte chunk column of 8
    # consecutive rows (k-major: m or n rows; mn-major: k rows) a phase:
    # 8 distinct bank groups, no conflict
    groups = (_tile_map(kind, extent, bk) // 16) % 8
    for r0 in range(0, groups.shape[0], 8):
        for c in range(groups.shape[1]):
            assert len(set(groups[r0:r0 + 8, c].tolist())) == 8


@pytest.mark.parametrize("kind,extent,bk", TILES)
def test_core_map_is_the_hardware_swizzle(kind, extent, bk):
    # the stored address of each chunk is the swizzle of its place in the
    # unswizzled canonical layout, so a tile that starts on a 1024-byte
    # boundary is what the descriptor's layout type (1: 128 bytes, 2: 64)
    # names
    off = _tile_map(kind, extent, bk)
    a, b = torch.meshgrid(torch.arange(off.shape[0]),
                          torch.arange(off.shape[1]), indexing="ij")
    if kind == "k":
        plain, row_bytes = a * 2 * bk + b * 16, 2 * bk
    else:
        plain = ((b >> 3) * (bk * 128) + (a >> 3) * 1024 + (a & 7) * 128
                 + (b & 7) * 16)
        row_bytes = 128
    assert torch.equal(off, swizzle(plain, row_bytes))


def _desc_read(kind, bk, start, lbo, sbo, mn, k):
    """Byte address a descriptor (start, LBO, SBO) gives element (mn, k) of
    its 16-deep operand: k-major, 8-row groups SBO apart and k inside the
    2 bk-byte row; mn-major, 64-element atoms LBO apart along mn and 8-k
    groups SBO apart."""
    if kind == "k":
        plain = start + (mn >> 3) * sbo + (mn & 7) * 2 * bk + k * 2
        return swizzle(plain, 2 * bk)
    plain = (start + (mn >> 6) * lbo + (k >> 3) * sbo + (k & 7) * 128
             + (mn & 63) * 2)
    return swizzle(plain, 128)


@pytest.mark.parametrize("kind,extent,bk,wg_rows", [
    (*tile, rows) for tile in TILES for rows in (64, 128, 256)
    if rows <= tile[1]])
def test_core_descriptors_read_the_stored_elements(kind, extent, bk,
                                                   wg_rows):
    # wg_tile's descriptors (step_desc): a warpgroup's 64 A rows start 64
    # K-major rows or one MN-major atom in; k step s adds 32 bytes
    # (k-major) or 2048 (mn-major); LBO 16 / bk * 128, SBO 16 bk / 1024.
    # Each element (mn, k) of every 16-deep step reads where the loader
    # stored it.
    lbo, sbo = (16, 16 * bk) if kind == "k" else (bk * 128, 1024)
    group = (64 * 2 * bk if kind == "k" else bk * 128) * (wg_rows // 64)
    for g, s in itertools.product(range(extent // wg_rows), range(bk // 16)):
        start = g * group + (s * 32 if kind == "k" else s * 2048)
        mn0 = g * wg_rows
        for mn, kk in itertools.product(range(0, wg_rows, 7), range(16)):
            k = 16 * s + kk
            if kind == "k":
                stored = kmajor_off(mn0 + mn, k >> 3, bk) + (k & 7) * 2
            else:
                stored = (mnmajor_off(k, (mn0 + mn) >> 3, bk)
                          + ((mn0 + mn) & 7) * 2)
            got = _desc_read(kind, bk, start, lbo, sbo, mn, kk)
            assert got == stored, (g, s, mn, kk)
