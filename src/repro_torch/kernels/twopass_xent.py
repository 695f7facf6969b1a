"""Cross-entropy by the two-pass softmax: CUDA kernel wrappers and their
plain versions.

``xent_fwd_2d`` (pass 1 plus the label logit) and ``xent_bwd_2d`` (pass 2)
launch the kernels of ``csrc/twopass_xent.cu``; the fused LM-head CE
``lmhead_xent_fwd_2d`` / ``lmhead_xent_dh_2d`` / ``lmhead_xent_dw_2d``
(logits ``h @ w`` recomputed per vocab tile, never stored whole) and the
backward that computes each slab's dlogits once for both dh and dw,
``lmhead_xent_bwd_2d``, launch those of ``csrc/lmhead_xent.cu``.  Each
wrapper launches its kernel for tensors on the card and runs its plain
version beside it for tensors on the CPU.  There is no fallback: a CUDA tensor reaches the kernel or the call
raises.  Each wrapper counts its launches in ``.launches``.  A label
outside ``[0, V)`` gathers 0, as in the TPU kernels.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import numerics, twopass
from repro_torch.kernels import _build
from repro_torch.kernels.twopass_softmax import _DTYPES, _I, _P, _check
from repro_torch.kernels.twopass_softmax import threads_for

# ln2 as the reference rounds LN2_HI + LN2_LO to float32
LN2 = float(torch.tensor(numerics.LN2_HI + numerics.LN2_LO,
                         dtype=torch.float32))


@functools.cache
def _lib():
    lib = _build.load("twopass_xent")
    lib.xent_fwd_2d.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.xent_fwd_2d.restype = _I
    lib.xent_bwd_2d.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.xent_bwd_2d.restype = _I
    return lib


@functools.cache
def _lmhead_lib():
    lib = _build.load("lmhead_xent")
    lib.lmhead_xent_fwd_2d.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    lib.lmhead_xent_fwd_2d.restype = _I
    lib.lmhead_xent_bwd_2d.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    lib.lmhead_xent_bwd_2d.restype = _I
    return lib


def _onehot(labels: torch.Tensor, cols: int) -> torch.Tensor:
    return (torch.arange(cols, device=labels.device)[None, :]
            == labels.to(torch.int64)[:, None])


def xent_fwd_2d_plain(logits: torch.Tensor, labels: torch.Tensor):
    """``(loss [T] f32, m_sum [T, 1], n_sum [T, 1])``: pass 1 and the label
    logit gathered as ``sum(where(col == label, x, 0))``."""
    x = logits.to(torch.float32)
    m, n = twopass.twopass_softmax_stats(x)
    ll = torch.where(_onehot(labels, x.shape[1]), x, 0.0).sum(dim=-1)
    return torch.log(m[:, 0]) + n[:, 0] * LN2 - ll, m, n


def xent_bwd_2d_plain(logits: torch.Tensor, labels: torch.Tensor,
                      m_sum: torch.Tensor, n_sum: torch.Tensor,
                      dloss: torch.Tensor) -> torch.Tensor:
    """``dlogits = (m * (1 / m_sum) * 2^(n - n_sum) - onehot) * dloss`` in
    ``logits.dtype``."""
    m, n = numerics.ext_exp(logits)
    p = m * (1.0 / m_sum) * numerics.exp2_int(n - n_sum)
    onehot = _onehot(labels, logits.shape[1]).to(torch.float32)
    return ((p - onehot) * dloss.to(torch.float32)[:, None]).to(logits.dtype)


def _check_rows(t: torch.Tensor, rows: int, what: str) -> None:
    if t.device.type != "cuda" or t.numel() != rows:
        raise ValueError(f"{what}: needs {rows} values on the card, got "
                         f"{tuple(t.shape)} on {t.device}")


def xent_fwd_2d(logits: torch.Tensor, labels: torch.Tensor):
    """Per-token loss and the saved stats of ``logits [T, V]`` (float32 or
    bfloat16) against ``labels [T]`` (int): ``(loss [T], m_sum [T, 1],
    n_sum [T, 1])``, all float32."""
    if logits.device.type == "cpu":
        return xent_fwd_2d_plain(logits, labels)
    _check(logits, "xent_fwd_2d")
    rows, cols = logits.shape
    _check_rows(labels, rows, "xent_fwd_2d labels")
    lab = labels.to(torch.int32).contiguous()
    loss = torch.empty((rows,), dtype=torch.float32, device=logits.device)
    m = torch.empty((rows, 1), dtype=torch.float32, device=logits.device)
    n = torch.empty((rows, 1), dtype=torch.float32, device=logits.device)
    if rows == 0:
        return loss, m, n
    lib = _lib()
    rc = lib.xent_fwd_2d(
        logits.data_ptr(), lab.data_ptr(), loss.data_ptr(), m.data_ptr(),
        n.data_ptr(), rows, cols, _DTYPES[logits.dtype], threads_for(cols),
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(lib, rc, "xent_fwd_2d")
    xent_fwd_2d.launches += 1
    return loss, m, n


def xent_bwd_2d(logits: torch.Tensor, labels: torch.Tensor,
                m_sum: torch.Tensor, n_sum: torch.Tensor,
                dloss: torch.Tensor) -> torch.Tensor:
    """``dlogits [T, V]`` in ``logits.dtype`` from the forward's stats and
    the loss gradient ``dloss [T]``: one read of the logits, one write."""
    if logits.device.type == "cpu":
        return xent_bwd_2d_plain(logits, labels, m_sum, n_sum, dloss)
    _check(logits, "xent_bwd_2d")
    rows, cols = logits.shape
    for t, what in ((labels, "labels"), (m_sum, "m_sum"), (n_sum, "n_sum"),
                    (dloss, "dloss")):
        _check_rows(t, rows, f"xent_bwd_2d {what}")
    lab = labels.to(torch.int32).contiguous()
    m, n, dl = (t.to(torch.float32).contiguous()
                for t in (m_sum, n_sum, dloss))
    dx = torch.empty_like(logits)
    if rows == 0 or cols == 0:
        return dx
    lib = _lib()
    rc = lib.xent_bwd_2d(
        logits.data_ptr(), lab.data_ptr(), m.data_ptr(), n.data_ptr(),
        dl.data_ptr(), dx.data_ptr(), rows, cols, _DTYPES[logits.dtype],
        threads_for(cols), torch.cuda.current_stream(logits.device)
        .cuda_stream)
    _build.check(lib, rc, "xent_bwd_2d")
    xent_bwd_2d.launches += 1
    return dx


# ---------------------------------------------------------------------------
# Fused LM-head CE: loss(h @ w, labels) with the logits recomputed per vocab
# chunk in the forward and in both backward products.
# ---------------------------------------------------------------------------
MAX_V_CHUNKS = 16          # chunk-count guard of the plain versions
_DH_SPLITS = 8             # kMaxDhSplits of csrc/lmhead_xent.cu


def lmhead_v_chunks(v: int, block_v: int) -> int:
    """Vocab chunks of the plain versions for a ``block_v`` chunk width."""
    return max(1, min(MAX_V_CHUNKS, -(-v // block_v)))


def _vocab_chunks(v: int, n_v_chunks: int):
    vc = -(-v // n_v_chunks)
    return [(lo, min(v, lo + vc)) for lo in range(0, v, vc)]


def lmhead_xent_fwd_2d_plain(h: torch.Tensor, w: torch.Tensor,
                             labels: torch.Tensor, n_v_chunks: int = 1):
    """``(loss [T], m_sum [T, 1], n_sum [T, 1])`` float32 of ``h [T, D] @
    w [D, V]`` against ``labels [T]``: float32 logits one vocab chunk at a
    time, each folded into the running (m, n) and the label logit."""
    t = h.shape[0]
    hf, wf = h.to(torch.float32), w.to(torch.float32)
    lab = labels.to(torch.int64)[:, None]
    m_acc = torch.zeros((t, 1), dtype=torch.float32, device=h.device)
    n_acc = torch.full((t, 1), numerics.MINUS_INF_N, dtype=torch.float32,
                       device=h.device)
    ll = torch.zeros((t,), dtype=torch.float32, device=h.device)
    for lo, hi in _vocab_chunks(w.shape[1], n_v_chunks):
        x = hf @ wf[:, lo:hi]
        m, n = numerics.ext_exp(x)
        n_loc = n.amax(dim=-1, keepdim=True)
        m_loc = (m * numerics.exp2_int(n - n_loc)).sum(dim=-1, keepdim=True)
        n_new = torch.maximum(n_acc, n_loc)
        m_acc = (m_acc * numerics.exp2_int(n_acc - n_new)
                 + m_loc * numerics.exp2_int(n_loc - n_new))
        n_acc = n_new
        hit = torch.arange(lo, hi, device=h.device)[None, :] == lab
        ll = ll + torch.where(hit, x, 0.0).sum(dim=-1)
    lse = torch.log(torch.clamp(m_acc, min=1e-37)) + n_acc * LN2
    return lse[:, 0] - ll, m_acc, n_acc


def _lmhead_dlogits_plain(h, w, labels, m_sum, n_sum, dloss, n_v_chunks):
    """Yields ``(lo, hi, dlogits)`` float32 per vocab chunk: x recomputed,
    ``(m * (1 / max(m_sum, 1e-37)) * 2^(n - n_sum) - onehot) * dloss``."""
    hf, wf = h.to(torch.float32), w.to(torch.float32)
    inv = 1.0 / torch.clamp(m_sum.to(torch.float32), min=1e-37)
    ns = n_sum.to(torch.float32)
    dl = dloss.to(torch.float32)[:, None]
    lab = labels.to(torch.int64)[:, None]
    for lo, hi in _vocab_chunks(w.shape[1], n_v_chunks):
        m, n = numerics.ext_exp(hf @ wf[:, lo:hi])
        p = m * inv * numerics.exp2_int(n - ns)
        hit = torch.arange(lo, hi, device=h.device)[None, :] == lab
        yield lo, hi, (p - hit.to(torch.float32)) * dl


def lmhead_xent_dh_2d_plain(h, w, labels, m_sum, n_sum, dloss,
                            n_v_chunks: int = 1) -> torch.Tensor:
    """``dh [T, D]`` float32 = sum over chunks of ``dlogits @ w_chunk^T``."""
    wf = w.to(torch.float32)
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for lo, hi, dlog in _lmhead_dlogits_plain(h, w, labels, m_sum, n_sum,
                                              dloss, n_v_chunks):
        dh = dh + dlog @ wf[:, lo:hi].T
    return dh


def lmhead_xent_dw_2d_plain(h, w, labels, m_sum, n_sum, dloss,
                            n_v_chunks: int = 1) -> torch.Tensor:
    """``dw [D, V]`` float32, chunk by chunk ``h^T @ dlogits``."""
    hf = h.to(torch.float32)
    return torch.cat([hf.T @ dlog for _, _, dlog in _lmhead_dlogits_plain(
        h, w, labels, m_sum, n_sum, dloss, n_v_chunks)], dim=1)


def lmhead_xent_bwd_2d_plain(h, w, labels, m_sum, n_sum, dloss,
                             n_v_chunks: int = 1):
    """``(dh, dw)`` of :func:`lmhead_xent_dh_2d_plain` and
    :func:`lmhead_xent_dw_2d_plain` from one pass over the chunks' dlogits,
    each chunk feeding both sums."""
    hf, wf = h.to(torch.float32), w.to(torch.float32)
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dws = []
    for lo, hi, dlog in _lmhead_dlogits_plain(h, w, labels, m_sum, n_sum,
                                              dloss, n_v_chunks):
        dh = dh + dlog @ wf[:, lo:hi].T
        dws.append(hf.T @ dlog)
    return dh, torch.cat(dws, dim=1)


def _check_lmhead(h, w, labels, what):
    for t, name in ((h, "h"), (w, "w")):
        _check(t, f"{what} {name}")
    if h.dtype != w.dtype or h.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: h {tuple(h.shape)} {h.dtype} and w "
                         f"{tuple(w.shape)} {w.dtype} need one dtype and a "
                         "shared D")
    _check_rows(labels, h.shape[0], f"{what} labels")
    return labels.to(torch.int32).contiguous()


def lmhead_xent_fwd_2d(h: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor, *, block_v: int):
    """Fused LM-head CE forward of ``h [T, D]``, ``w [D, V]`` (both float32
    or both bfloat16) against ``labels [T]``: ``(loss [T], m_sum [T, 1],
    n_sum [T, 1])``, float32.  ``block_v`` is the plain version's vocab
    chunk width; the kernels fold tiles of their own whatever it is: 256
    columns for bf16 (``lmhead_fwd_bf16``, ``wgmma``), 128 for float32
    (FFMA).  A tensor map that cannot be made raises."""
    if h.device.type == "cpu":
        return lmhead_xent_fwd_2d_plain(
            h, w, labels, lmhead_v_chunks(w.shape[1], block_v))
    lab = _check_lmhead(h, w, labels, "lmhead_xent_fwd_2d")
    (t, d), v = h.shape, w.shape[1]
    f32 = dict(dtype=torch.float32, device=h.device)
    loss = torch.empty((t,), **f32)
    m = torch.empty((t, 1), **f32)
    n = torch.empty((t, 1), **f32)
    if t == 0:
        return loss, m, n
    # one (m, n, ll) partial a row and vocab tile (128 columns or more)
    scratch = torch.empty((3, -(-v // 128), t), **f32)
    lib = _lmhead_lib()
    rc = lib.lmhead_xent_fwd_2d(
        h.data_ptr(), w.data_ptr(), lab.data_ptr(), scratch.data_ptr(),
        loss.data_ptr(), m.data_ptr(), n.data_ptr(), t, d, v,
        _DTYPES[h.dtype], torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, rc, "lmhead_xent_fwd_2d")
    lmhead_xent_fwd_2d.launches += 1
    return loss, m, n


def _lmhead_bwd(h, w, labels, m_sum, n_sum, dloss, block_v, want_dh,
                want_dw, what):
    """The backward kernels: ``(dh or None, dw or None)`` float32, each
    vocab slab's dlogits computed once for both."""
    lab = _check_lmhead(h, w, labels, what)
    (t, d), v = h.shape, w.shape[1]
    for x, name in ((m_sum, "m_sum"), (n_sum, "n_sum"), (dloss, "dloss")):
        _check_rows(x, t, f"{what} {name}")
    m, n, dl = (x.to(torch.float32).contiguous()
                for x in (m_sum, n_sum, dloss))
    f32 = dict(dtype=torch.float32, device=h.device)
    if t == 0 or v == 0:
        return (torch.zeros((t, d), **f32) if want_dh else None,
                torch.zeros((d, v), **f32) if want_dw else None)
    dh = torch.empty((t, d), **f32) if want_dh else None
    dw = torch.empty((d, v), **f32) if want_dw else None
    if block_v <= 0 or block_v % 8:
        raise ValueError(f"{what}: block_v {block_v} must be a positive "
                         "multiple of 8 (16-byte rows of the scratch)")
    slab = min(block_v, -(-v // 8) * 8)
    # dlogits of one slab (float32, or three bf16 planes: 2 t slab floats
    # either way); dh adds its float32 k-split parts
    scratch = torch.empty((2 * t * slab + (_DH_SPLITS * t * d if want_dh
                                           else 0),), **f32)
    lib = _lmhead_lib()
    rc = lib.lmhead_xent_bwd_2d(
        h.data_ptr(), w.data_ptr(), lab.data_ptr(), m.data_ptr(),
        n.data_ptr(), dl.data_ptr(), scratch.data_ptr(),
        dh.data_ptr() if want_dh else None,
        dw.data_ptr() if want_dw else None, t, d, v, slab, _DTYPES[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, rc, what)
    return dh, dw


def lmhead_xent_dh_2d(h, w, labels, m_sum, n_sum, dloss, *,
                      block_v: int) -> torch.Tensor:
    """``dh [T, D]`` float32 from the forward's stats and ``dloss [T]``:
    ``block_v`` vocab columns of dlogits at a time (the kernel's scratch,
    ``2 T block_v`` floats plus up to 8 float32 ``[T, D]`` partial
    products; the plain version's chunk width, a multiple of 8)."""
    if h.device.type == "cpu":
        return lmhead_xent_dh_2d_plain(h, w, labels, m_sum, n_sum, dloss,
                                       lmhead_v_chunks(w.shape[1], block_v))
    dh, _ = _lmhead_bwd(h, w, labels, m_sum, n_sum, dloss, block_v, True,
                        False, "lmhead_xent_dh_2d")
    lmhead_xent_dh_2d.launches += 1
    return dh


def lmhead_xent_dw_2d(h, w, labels, m_sum, n_sum, dloss, *,
                      block_v: int) -> torch.Tensor:
    """``dw [D, V]`` float32 from the forward's stats and ``dloss [T]``,
    ``block_v`` vocab columns at a time as :func:`lmhead_xent_dh_2d`."""
    if h.device.type == "cpu":
        return lmhead_xent_dw_2d_plain(h, w, labels, m_sum, n_sum, dloss,
                                       lmhead_v_chunks(w.shape[1], block_v))
    _, dw = _lmhead_bwd(h, w, labels, m_sum, n_sum, dloss, block_v, False,
                        True, "lmhead_xent_dw_2d")
    lmhead_xent_dw_2d.launches += 1
    return dw


def lmhead_xent_bwd_2d(h, w, labels, m_sum, n_sum, dloss, *,
                       block_v: int):
    """``(dh [T, D], dw [D, V])`` float32, equal to those of
    :func:`lmhead_xent_dh_2d` and :func:`lmhead_xent_dw_2d`, with each
    vocab slab's dlogits computed once for both products.  Counts one
    launch on each of those two wrappers."""
    if h.device.type == "cpu":
        return lmhead_xent_bwd_2d_plain(h, w, labels, m_sum, n_sum, dloss,
                                        lmhead_v_chunks(w.shape[1], block_v))
    dh, dw = _lmhead_bwd(h, w, labels, m_sum, n_sum, dloss, block_v, True,
                         True, "lmhead_xent_bwd_2d")
    lmhead_xent_dh_2d.launches += 1
    lmhead_xent_dw_2d.launches += 1
    return dh, dw


xent_fwd_2d.launches = 0
xent_bwd_2d.launches = 0
lmhead_xent_fwd_2d.launches = 0
lmhead_xent_dh_2d.launches = 0
lmhead_xent_dw_2d.launches = 0
