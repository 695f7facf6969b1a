"""The Two-Pass softmax (paper Alg 3): CUDA kernel wrappers and their plain
versions.

``twopass_softmax_2d`` and ``twopass_stats_2d`` launch the kernels of
``csrc/twopass_softmax.cu`` for a tensor on the card and run the plain
versions beside them for a tensor on the CPU.  There is no fallback: a CUDA
tensor reaches the kernel or the call raises.  Each wrapper counts its
launches in ``.launches``.

``twopass_softmax_2d`` and ``twopass_stats_2d`` (and the three-pass
wrappers) take one of two layouts, named by :func:`path_for`: rows of at
most ``REGS_MAX_COLS`` columns are held in registers; longer rows are split
over the fold's 32 slots, two launches with a float32 scratch of ``[rows,
32, 2]`` that the wrapper gives.  Both fold in one order, so the bits do
not depend on it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import twopass
from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("twopass_softmax")
    lib.twopass_softmax_2d.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    lib.twopass_softmax_2d.restype = _I
    lib.twopass_stats_2d.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.twopass_stats_2d.restype = _I
    return lib


REGS_MAX_COLS = 8192        # 32 chunks of 256 columns: one a fold slot
SLOTS = 32                  # fold slots a row (csrc/rowfold.cuh)


def path_for(cols: int) -> str:
    """The layout the softmax kernels take for rows of ``cols`` columns:
    ``"registers"`` up to ``REGS_MAX_COLS``, else ``"split"``."""
    return "registers" if cols <= REGS_MAX_COLS else "split"


def slot_scratch(x: torch.Tensor):
    """The split path's float32 scratch ``[rows, 32, 2]`` for ``x``, or
    None for the register path."""
    if path_for(x.shape[1]) == "registers":
        return None
    return torch.empty((x.shape[0], SLOTS, 2), dtype=torch.float32,
                       device=x.device)


def threads_for(cols: int) -> int:
    """Threads per row block of the one-block-a-row kernels (cross-entropy):
    about 8 elements a thread, one warp for short rows, at
    most 1024; always a power of two.  The kernels' sum order does not
    depend on it."""
    want = max(1, -(-cols // 8))
    return min(1024, max(32, 1 << (want - 1).bit_length()))


def _check(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.ndim != 2 or not x.is_contiguous() or x.dtype not in _DTYPES:
        raise ValueError(f"{what}: needs a contiguous 2-D float32/bfloat16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")


def twopass_softmax_2d_plain(x: torch.Tensor) -> torch.Tensor:
    """Rowwise softmax of ``x [R, C]``: the plain (m, n) form."""
    return twopass.twopass_softmax(x, axis=-1)


def twopass_stats_2d_plain(x: torch.Tensor):
    """Pass 1 only: per-row ``(m_sum, n_sum)``, each ``[R, 1]`` f32."""
    return tuple(twopass.twopass_softmax_stats(x, axis=-1))


def twopass_softmax_2d(x: torch.Tensor) -> torch.Tensor:
    """Rowwise softmax of ``x [R, C]`` (float32 or bfloat16, y in x.dtype)."""
    if x.device.type == "cpu":
        return twopass_softmax_2d_plain(x)
    _check(x, "twopass_softmax_2d")
    rows, cols = x.shape
    y = torch.empty_like(x)
    if rows == 0 or cols == 0:
        return y
    slots = slot_scratch(x)
    lib = _lib()
    rc = lib.twopass_softmax_2d(
        x.data_ptr(), y.data_ptr(), None if slots is None else
        slots.data_ptr(), rows, cols, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "twopass_softmax_2d")
    twopass_softmax_2d.launches += 1
    return y


def twopass_stats_2d(x: torch.Tensor):
    """Pass 1 only: per-row ``(m_sum, n_sum)`` of ``x [R, C]``, each
    ``[R, 1]`` f32."""
    if x.device.type == "cpu":
        return twopass_stats_2d_plain(x)
    _check(x, "twopass_stats_2d")
    rows, cols = x.shape
    m = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    n = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return m, n
    slots = slot_scratch(x)
    lib = _lib()
    rc = lib.twopass_stats_2d(
        x.data_ptr(), m.data_ptr(), n.data_ptr(),
        None if slots is None else slots.data_ptr(), rows, cols,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "twopass_stats_2d")
    twopass_stats_2d.launches += 1
    return m, n


twopass_softmax_2d.launches = 0
twopass_stats_2d.launches = 0
