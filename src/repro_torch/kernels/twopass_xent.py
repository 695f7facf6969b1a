"""Cross-entropy by the two-pass softmax: CUDA kernel wrappers and their
plain versions.

``xent_fwd_2d`` (pass 1 plus the label logit) and ``xent_bwd_2d`` (pass 2)
launch the kernels of ``csrc/twopass_xent.cu`` for tensors on the card and
run the plain versions beside them for tensors on the CPU.  There is no
fallback: a CUDA tensor reaches the kernel or the call raises.  Each
wrapper counts its launches in ``.launches``.  A label outside ``[0, V)``
gathers 0, as in the TPU kernel.
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


xent_fwd_2d.launches = 0
xent_bwd_2d.launches = 0
