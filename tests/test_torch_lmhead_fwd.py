"""The bf16 LM-head CE forward kernel's fold, modelled on the CPU.

``lmhead_fwd_bf16`` (``csrc/lmhead_xent.cu``) holds each 128 x 256 logit
tile in the registers of two warpgroups and folds it there (``fold_tile``):
each lane of a quad holds 64 columns of a row, 8 j + 2 q + e for lane q,
and folds them max-first in (j, e) order (n_loc = n of the largest logit,
m_loc = sum of m 2^(n - n_loc) from 0), columns >= V as -inf; the quad's
four lanes combine by ``ext_add`` with lane q ^ 1, then q ^ 2; the label
logit comes from the lane that holds it.  ``lmhead_fwd_combine`` then
folds the 256-column tiles' partials in vocab order.  ``kernel_fold`` below
repeats that order on float32 logits, and is held against the reference's
Pallas forward (interpret mode) and against the port's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import twopass_xent as jxe
from repro_torch.core import numerics
from repro_torch.kernels import twopass_xent as txe

TILE = 256      # kBn: a logit tile's columns
LANES = 4       # the quad that holds a row

# float32 sums in other orders on the two sides (the logits over D, the
# fold over V), ~1e-6 at these sizes; as test_lmhead_matches_reference
TOL = dict(atol=5e-5, rtol=1e-6)


def kernel_fold(x: torch.Tensor, labels: torch.Tensor):
    """``(loss [T], m_sum [T, 1], n_sum [T, 1])`` of float32 logits ``x
    [T, V]`` folded in the kernel's order."""
    t, v = x.shape
    tiles = -(-v // TILE)
    xp = torch.full((t, tiles * TILE), -torch.inf)
    xp[:, :v] = x
    # tile column 8 j + 2 q + e is value 2 j + e of lane q
    lanes = (xp.view(t, tiles, TILE // 8, LANES, 2).transpose(2, 3)
             .reshape(t, tiles, LANES, TILE // LANES))
    n = numerics.ext_exp(lanes.amax(dim=-1)).exponent
    m = torch.zeros_like(n)
    for i in range(lanes.shape[-1]):
        me, ne = numerics.ext_exp(lanes[..., i])
        m = m + me * numerics.exp2_int(ne - n)
    lane = [numerics.ExtFloat(m[..., q], n[..., q]) for q in range(LANES)]
    pm, pn = numerics.ext_add(numerics.ext_add(lane[0], lane[1]),
                              numerics.ext_add(lane[2], lane[3]))
    lab = labels.to(torch.int64)
    rows = torch.nonzero((lab >= 0) & (lab < v)).flatten()
    pll = torch.zeros(t, tiles)
    pll[rows, lab[rows] // TILE] = x[rows, lab[rows]]
    acc, ll = numerics.ext_zero((t,)), torch.zeros(t)
    for j in range(tiles):
        acc = numerics.ext_add(acc, numerics.ExtFloat(pm[:, j], pn[:, j]))
        ll = ll + pll[:, j]
    lse = (torch.log(torch.clamp(acc.mantissa, min=1e-37))
           + acc.exponent * txe.LN2)
    return lse - ll, acc.mantissa[:, None], acc.exponent[:, None]


def _inputs(t, d, v, seed):
    """Seeded h, w and labels: one in the last (partial) tile's last
    column, one at -1 (outside: gathers 0)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    labels[0] = v - 1
    if t > 1:
        labels[1] = -1
    return h, w, labels


def _lse(m, n):
    return torch.log(m[:, 0]) + n[:, 0] * txe.LN2


def _jax_forward(h, w, labels, v):
    """The reference's Pallas forward (interpret mode): h and w padded to
    whole blocks, ``v_len`` the true width."""
    t = h.shape[0]
    bt, bv = -(-t // 8) * 8, 4096
    hp = np.zeros((bt, h.shape[1]), np.float32)
    hp[:t] = h
    wp = np.zeros((w.shape[0], -(-v // bv) * bv), np.float32)
    wp[:, :v] = w
    lp = np.zeros(bt, np.int32)
    lp[:t] = labels
    loss, m, n = jxe.lmhead_xent_fwd_2d(jnp.asarray(hp), jnp.asarray(wp),
                                        jnp.asarray(lp), block_t=bt,
                                        block_v=bv, v_len=v)
    return (torch.from_numpy(np.array(loss[:t])),
            torch.from_numpy(np.array(m[:t])),
            torch.from_numpy(np.array(n[:t])))


@pytest.mark.parametrize("v", [1000, 1000 + 129, 50257])
@pytest.mark.parametrize("t", [1, 37, 300])
def test_kernel_fold_matches_reference_and_plain(t, v):
    h, w, labels = _inputs(t, 32, v, seed=t * v)
    ht, wt, lab = (torch.from_numpy(a) for a in (h, w, labels))
    loss, m, n = kernel_fold(ht @ wt, lab)
    assert torch.isfinite(loss).all()
    for want_loss, wm, wn in (_jax_forward(h, w, labels, v),
                              txe.lmhead_xent_fwd_2d_plain(ht, wt, lab)):
        torch.testing.assert_close(loss, want_loss, **TOL)
        torch.testing.assert_close(_lse(m, n), _lse(wm, wn), **TOL)


@pytest.mark.parametrize("v", [769, 1000, 1000 + 129])
def test_kernel_fold_labels_at_the_vocab_edge(v):
    # the last tile holds 1 (v = 769), 232 or 105 columns: its columns past
    # V are -inf, and a label there (outside [0, V)) gathers 0 as a label
    # at -1 or V does; a label in the tile's last valid column gathers it
    h, w, labels = _inputs(40, 24, v, seed=v)
    last = (v - 1) // TILE * TILE
    labels[2], labels[3] = v, min(last + TILE - 1, v + 7)
    labels[4] = last
    ht, wt, lab = (torch.from_numpy(a) for a in (h, w, labels))
    x = ht @ wt
    loss, m, n = kernel_fold(x, lab)
    want, wm, wn = txe.lmhead_xent_fwd_2d_plain(ht, wt, lab)
    torch.testing.assert_close(loss, want, **TOL)
    torch.testing.assert_close(_lse(m, n), _lse(wm, wn), **TOL)
    lse = _lse(m, n)
    for r in (1, 2, 3):                      # outside: the loss is lse
        assert loss[r] == lse[r]
    for r in (0, 4):
        torch.testing.assert_close(loss[r], lse[r] - x[r, labels[r]])


def test_kernel_fold_bf16_inputs_match_plain():
    # bf16 h and w: the kernel's products are exact in float32, so its
    # logits are the float32 product of the upcast values up to sum order
    h, w, labels = _inputs(37, 64, 3000, seed=5)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    lab = torch.from_numpy(labels)
    loss, m, n = kernel_fold(hb.float() @ wb.float(), lab)
    want, wm, wn = txe.lmhead_xent_fwd_2d_plain(hb, wb, lab)
    torch.testing.assert_close(loss, want, **TOL)
    torch.testing.assert_close(_lse(m, n), _lse(wm, wn), **TOL)


@pytest.mark.parametrize("scale", [1.0, 100.0, 1e6, 1e36])
def test_n_of_the_largest_logit_is_the_largest_n(scale):
    # fold_tile takes n_loc as ext_exp_n(max x): n does not decrease as x
    # grows, through the clamp, the rounding and -inf / +inf
    rng = np.random.default_rng(int(np.log10(scale)))
    x = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)
                         * np.float32(scale))
    x[0] = -torch.inf
    x[1, :5] = -torch.inf
    x[2, 7] = torch.inf
    want = numerics.ext_exp(x).exponent.amax(dim=-1)
    assert torch.equal(numerics.ext_exp(x.amax(dim=-1)).exponent, want)
