"""The paper's three-pass softmax baselines (Alg 1 and Alg 2): CUDA kernel
wrappers and their plain versions.

``threepass_recompute_2d`` and ``threepass_reload_2d`` launch the kernels of
``csrc/threepass_softmax.cu`` for a tensor on the card and run the plain
versions beside them for a tensor on the CPU.  There is no fallback: a CUDA
tensor reaches the kernel or the call raises.  Each wrapper counts its
launches in ``.launches``.  Both take the two-pass kernel's two layouts
(``twopass_softmax.path_for``): registers up to ``REGS_MAX_COLS`` columns,
split beyond, with the same bits either way.

The exponential is the paper's Alg 4 as the TPU kernels compute it
(``ext_exp`` rebuilt as ``m * exp2_int(n)``), which flushes to zero where
``x - mu`` is below about -88; the ``use_kernels=False`` forms in
``core/softmax_api.py`` use ``torch.exp`` instead, as the reference's jnp
forms do.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import numerics
from repro_torch.kernels import _build
from repro_torch.kernels.twopass_softmax import _DTYPES, _I, _P, _check
from repro_torch.kernels.twopass_softmax import slot_scratch


@functools.cache
def _lib():
    lib = _build.load("threepass_softmax")
    lib.threepass_recompute_2d.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    lib.threepass_recompute_2d.restype = _I
    lib.threepass_reload_2d.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.threepass_reload_2d.restype = _I
    return lib


def _exp_nonpos(t: torch.Tensor) -> torch.Tensor:
    """Paper Alg 4 for ``t <= 0``: ExtExp's ``m * 2^n``, rebuilt exactly
    (``n <= -127`` flushes to zero)."""
    m, n = numerics.ext_exp(t)
    return m * numerics.exp2_int(n)


def threepass_recompute_2d_plain(x: torch.Tensor) -> torch.Tensor:
    """Alg 1: ``mu = max x``, ``sigma = sum e(x - mu)``, ``y = e(x - mu) *
    (1 / sigma)`` with the exponential computed again."""
    xf = x.to(torch.float32)
    mu = xf.amax(dim=-1, keepdim=True)
    sigma = _exp_nonpos(xf - mu).sum(dim=-1, keepdim=True)
    return (_exp_nonpos(xf - mu) * (1.0 / sigma)).to(x.dtype)


def threepass_reload_2d_plain(x: torch.Tensor) -> torch.Tensor:
    """Alg 2: the float32 exponentials ``e = e(x - mu)`` are stored and
    summed, then scaled: ``y = e * (1 / sigma)``."""
    xf = x.to(torch.float32)
    mu = xf.amax(dim=-1, keepdim=True)
    e = _exp_nonpos(xf - mu)
    sigma = e.sum(dim=-1, keepdim=True)
    return (e * (1.0 / sigma)).to(x.dtype)


def reload_scratch(x: torch.Tensor):
    """The reload kernels' float32 scratch for ``x``: the e buffer ``[rows,
    cols]`` (None for float32 x, whose e buffer is y) and the split path's
    slots (None for the register path)."""
    e = (None if x.dtype == torch.float32
         else torch.empty(x.shape, dtype=torch.float32, device=x.device))
    return e, slot_scratch(x)


def threepass_recompute_2d(x: torch.Tensor) -> torch.Tensor:
    """Rowwise softmax of ``x [R, C]`` by Alg 1 (float32 or bfloat16, y in
    x.dtype): 3 reads and 1 write of a long row; a row of at most
    ``REGS_MAX_COLS`` columns is read once into registers and its
    exponentials computed twice from there."""
    if x.device.type == "cpu":
        return threepass_recompute_2d_plain(x)
    _check(x, "threepass_recompute_2d")
    rows, cols = x.shape
    y = torch.empty_like(x)
    if rows == 0 or cols == 0:
        return y
    slots = slot_scratch(x)
    lib = _lib()
    rc = lib.threepass_recompute_2d(
        x.data_ptr(), y.data_ptr(), None if slots is None else
        slots.data_ptr(), rows, cols, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "threepass_recompute_2d")
    threepass_recompute_2d.launches += 1
    return y


def threepass_reload_2d(x: torch.Tensor) -> torch.Tensor:
    """Rowwise softmax of ``x [R, C]`` by Alg 2 (float32 or bfloat16, y in
    x.dtype): the exponentials go to a float32 buffer -- y itself for
    float32 x, scaled in place; a scratch tensor for bfloat16 x -- and are
    read back from it: 5N for a long row; a row of at most
    ``REGS_MAX_COLS`` columns reads x once into registers."""
    if x.device.type == "cpu":
        return threepass_reload_2d_plain(x)
    _check(x, "threepass_reload_2d")
    rows, cols = x.shape
    y = torch.empty_like(x)
    if rows == 0 or cols == 0:
        return y
    e, slots = reload_scratch(x)
    lib = _lib()
    rc = lib.threepass_reload_2d(
        x.data_ptr(), y.data_ptr(), None if e is None else e.data_ptr(),
        None if slots is None else slots.data_ptr(), rows, cols,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "threepass_reload_2d")
    threepass_reload_2d.launches += 1
    return y


threepass_recompute_2d.launches = 0
threepass_reload_2d.launches = 0
