"""Single-query decode attention, contiguous and PAGED: CUDA kernel wrappers
and their plain versions.

The serving hot path is one query per slot against that slot's whole KV
cache.  The kernels (``csrc/decode_attention.cu``) fold the cache in tiles
with the length/window mask applied per tile and the online softmax run in
the paper's ``(m, n)`` form: rescales are exact powers of two, so tiles --
and therefore pages -- may be folded in any order.

The kernels split the cache along its positions: one block a tile, then a
second kernel folds the tiles' partials in tile order.  Which tile body a
launch takes -- bf16 with 16-byte loads, or the general one -- is decided
by :func:`kernel_body` alone.

The plain versions are the torch twins of the reference's chunked forms
(``_decode_attention_chunked`` / ``_decode_attention_paged_chunked``):
Python-looped chunks over slots and positions with the same
``_mn_mask_update`` fold.  A wrapper runs its plain version for a tensor on
the CPU and launches its kernel for a tensor on the card; each counts its
launches in ``.launches``.  The paged wrapper counts its launches over
int8 arenas apart, in ``decode_attention_paged_int8.launches``, and the
rest in its own.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from repro_torch.core import numerics
from repro_torch.kernels import _build

MAX_TILE = 256          # KV positions per kernel tile (shared-memory rows)
MAX_PAGES_PER_TILE = 8  # pages folded per tile, as in the reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------
def _mn_mask_update(acc, q_blk, k_chunk, v_chunk, kpos, l_blk, *,
                    scale: float, window: int | None,
                    k_scale=None, v_scale=None):
    """One (m, n) online-softmax step: score the chunk, apply the length /
    window mask, fold into the running ``(o, m, n)`` accumulator.  The
    slot's query sits at ``l_blk - 1`` (write-then-attend), so the validity
    prefix is the causal mask.  ``k_scale`` multiplies the scores before the
    mask; ``v_scale`` goes into the numerators after ``m_loc``."""
    o_acc, m_acc, n_acc = acc
    sco = torch.einsum("shgd,shtd->shgt", q_blk, k_chunk) * scale
    if k_scale is not None:
        sco = sco * k_scale
    mask = kpos[None, :] < l_blk[:, None]
    if window is not None:
        mask &= kpos[None, :] > l_blk[:, None] - 1 - window
    sco = torch.where(mask[:, None, None, :], sco, -torch.inf)

    m, n = numerics.ext_exp(sco)
    n_loc = n.amax(dim=-1, keepdim=True)
    w = m * numerics.exp2_int(n - n_loc)
    m_loc = w.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        w = w * v_scale
    o_loc = torch.einsum("shgt,shtd->shgd", w, v_chunk)

    n_new = torch.maximum(n_acc, n_loc)
    a_acc = numerics.exp2_int(n_acc - n_new)
    a_loc = numerics.exp2_int(n_loc - n_new)
    return (o_acc * a_acc + o_loc * a_loc,
            m_acc * a_acc + m_loc * a_loc, n_new)


def _mn_init(bs: int, hkv: int, g: int, dv: int, device):
    return (torch.zeros((bs, hkv, g, dv), dtype=torch.float32, device=device),
            torch.zeros((bs, hkv, g, 1), dtype=torch.float32, device=device),
            torch.full((bs, hkv, g, 1), numerics.MINUS_INF_N,
                       dtype=torch.float32, device=device))


def decode_attention_plain(q, k, v, lengths, *, scale: float,
                           window: int | None = None, n_s_chunks: int = 1,
                           n_t_chunks: int = 1) -> torch.Tensor:
    """(m, n)-streamed single-query attention.  q: [S, Hkv, G, D]; k/v:
    [S, Hkv, T, D|Dv]; lengths: [S] (0 = free slot, exact zeros).  Returns
    [S, Hkv, G, Dv] in q.dtype."""
    s, hkv, g, _ = q.shape
    t = k.shape[2]
    dv = v.shape[3]
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    lens = lengths.to(torch.int32)
    sc = -(-s // n_s_chunks)
    tc = -(-t // n_t_chunks)
    outs = []
    for i in range(n_s_chunks):
        q_blk = qf[i * sc:(i + 1) * sc]
        bs = q_blk.shape[0]
        if bs == 0:
            continue
        l_blk = lens[i * sc:i * sc + bs]
        acc = _mn_init(bs, hkv, g, dv, q.device)
        for j in range(n_t_chunks):
            lo, hi = j * tc, min(t, (j + 1) * tc)
            if lo >= hi:
                continue
            acc = _mn_mask_update(
                acc, q_blk, kf[i * sc:i * sc + bs, :, lo:hi],
                vf[i * sc:i * sc + bs, :, lo:hi],
                torch.arange(lo, hi, device=q.device), l_blk,
                scale=scale, window=window)
        # a free slot (length 0) has m == 0: the max() guard gives zeros
        outs.append(acc[0] / torch.clamp(acc[1], min=1e-37))
    return torch.cat(outs, dim=0).to(q.dtype)


def _gather_scale_chunk(scale_leaf, pt, bs, npg, ps, hkv):
    """One chunk's scale rows through the page table, shaped to broadcast
    against ``[bs, hkv, g, t]`` scores."""
    sch = scale_leaf[pt]                             # [bs, npg, ps(, hkv)]
    if scale_leaf.ndim == 2:
        return sch.reshape(bs, 1, 1, npg * ps)
    return sch.reshape(bs, npg * ps, hkv).permute(0, 2, 1)[:, :, None, :]


def decode_attention_paged_plain(q, k_pages, v_pages, page_table, lengths,
                                 k_scale=None, v_scale=None, *, scale: float,
                                 window: int | None = None,
                                 n_s_chunks: int = 1,
                                 n_t_chunks: int = 1) -> torch.Tensor:
    """Paged twin of :func:`decode_attention_plain`: K/V live in page arenas
    ``[P, ps, Hkv, D|Dv]`` gathered per chunk through ``page_table [S,
    Pmax]``.  int8 arenas pass f32 ``k_scale``/``v_scale`` (``[P, ps]`` or
    ``[P, ps, Hkv]``), folded into the sweep as per-column multipliers."""
    s, hkv, g, d = q.shape
    ps = k_pages.shape[1]
    pmax = page_table.shape[1]
    dv = v_pages.shape[3]
    qf = q.to(torch.float32)
    lens = lengths.to(torch.int32)
    table = page_table.long()
    sc = -(-s // n_s_chunks)
    pc = -(-pmax // n_t_chunks)
    outs = []
    for i in range(n_s_chunks):
        q_blk = qf[i * sc:(i + 1) * sc]
        bs = q_blk.shape[0]
        if bs == 0:
            continue
        l_blk = lens[i * sc:i * sc + bs]
        pt_blk = table[i * sc:i * sc + bs]
        acc = _mn_init(bs, hkv, g, dv, q.device)
        for j in range(n_t_chunks):
            p0, p1 = j * pc, min(pmax, (j + 1) * pc)
            if p0 >= p1:
                continue
            npg = p1 - p0
            pt = pt_blk[:, p0:p1]
            kc = k_pages[pt].reshape(bs, npg * ps, hkv, d)
            vc = v_pages[pt].reshape(bs, npg * ps, hkv, dv)
            ksc = vsc = None
            if k_scale is not None:
                ksc = _gather_scale_chunk(k_scale, pt, bs, npg, ps, hkv)
                vsc = _gather_scale_chunk(v_scale, pt, bs, npg, ps, hkv)
            acc = _mn_mask_update(
                acc, q_blk, kc.permute(0, 2, 1, 3).to(torch.float32),
                vc.permute(0, 2, 1, 3).to(torch.float32),
                torch.arange(p0 * ps, p1 * ps, device=q.device), l_blk,
                scale=scale, window=window, k_scale=ksc, v_scale=vsc)
        outs.append(acc[0] / torch.clamp(acc[1], min=1e-37))
    return torch.cat(outs, dim=0).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    f = lib.decode_attention_contig
    f.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                  ctypes.c_float, _I, _I, _I, *[_L] * 6, _P]
    f.restype = _I
    f = lib.decode_attention_paged
    f.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I,
                  *[_L] * 9, _P]
    f.restype = _I
    return lib


BODIES = ("general", "bf16")     # index = the C entries' ``body`` code


def kernel_body(q_dtype, kv_dtype, d: int, dv: int, row_bytes) -> str:
    """The tile body a launch takes (``csrc/decode_attention.cu``).

    ``"bf16"`` -- 16-byte row loads, q and the accumulators in registers
    -- for bfloat16 q and K/V with D and Dv multiples of 8 (at most 256)
    and every K / V row 16-byte aligned: ``row_bytes`` are the K and V base
    addresses and their row strides in bytes (:func:`_row_bytes`), all
    multiples of 16.  ``"general"`` for everything else: float32, int8
    pages with scales, other head dims or alignments.  This reads dtypes,
    head dims and alignment only.  The C entry refuses a ``"bf16"`` launch
    whose operands do not meet these conditions; nothing falls back."""
    if (q_dtype == kv_dtype == torch.bfloat16 and d % 8 == 0 and dv % 8 == 0
            and max(d, dv) <= 256 and all(x % 16 == 0 for x in row_bytes)):
        return "bf16"
    return "general"


def _row_bytes(k, v) -> tuple[int, ...]:
    """Base addresses and strides of the three row axes, in bytes, of K and
    V (strip [S, Hkv, T, D] or arenas [P, ps, Hkv, D])."""
    return (k.data_ptr(), v.data_ptr(),
            *(x * k.element_size() for x in k.stride()[:3]),
            *(x * v.element_size() for x in v.stride()[:3]))


def _check_cuda(what: str, q, *tensors) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what}: expected CPU or CUDA tensors, got "
                         f"{q.device}")
    for x in tensors:
        if x is not None and x.device != q.device:
            raise ValueError(f"{what}: all operands must be on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: q must be float32 or bfloat16")


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _scratch(q, dv: int, positions: int, tile: int) -> torch.Tensor:
    """The tiles' partials ``[S, Hkv, G, n_split, Dv + 2]`` (o_loc, m_loc,
    n_loc), float32; only live tiles are written and read."""
    s, hkv, g, _ = q.shape
    n_split = max(1, -(-positions // tile))
    return torch.empty((s, hkv, g, n_split, dv + 2), dtype=torch.float32,
                       device=q.device)


def launch_contig(body: str, q, k, v, lens, o, *, tile: int,
                  window: int | None, scale: float) -> None:
    """One strip launch (the tile kernel of ``body`` and the combine) on
    checked card tensors: q contiguous, lens int32, o ``[S, Hkv, G, Dv]``.
    Counts nothing: :func:`decode_attention` counts its launches, and a
    check may call one body alone."""
    s, hkv, g, d = q.shape
    dv = v.shape[3]
    part = _scratch(q, dv, k.shape[2], tile)
    lib = _lib()
    rc = lib.decode_attention_contig(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        o.data_ptr(), part.data_ptr(), s, hkv, g, d, dv, tile,
        part.shape[3], -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], _DTYPES[k.dtype], BODIES.index(body),
        *k.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "decode_attention")


def launch_paged(body: str, q, k_pages, v_pages, table, lens, ksp, vsp,
                 strides, o, *, tile: int, window: int | None,
                 scale: float) -> None:
    """One paged launch on checked card tensors (see
    :func:`launch_contig`); ``strides`` are the arenas' and the scales'
    element strides as the C entry takes them."""
    s, hkv, g, d = q.shape
    ps, dv = k_pages.shape[1], v_pages.shape[3]
    pmax = table.shape[1]
    part = _scratch(q, dv, pmax * ps, tile)
    lib = _lib()
    rc = lib.decode_attention_paged(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), lens.data_ptr(),
        None if ksp is None else ksp.data_ptr(),
        None if vsp is None else vsp.data_ptr(), o.data_ptr(),
        part.data_ptr(), s, hkv, g, d, dv, pmax, ps, tile, part.shape[3],
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], _DTYPES[k_pages.dtype], BODIES.index(body),
        *strides, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "decode_attention_paged")


def decode_attention(q, k, v, lengths, *, scale: float,
                     window: int | None = None,
                     block_t: int = 128) -> torch.Tensor:
    """Single-query length-masked attention over a contiguous cache.

    q: [S, Hkv, G, D]; k/v: [S, Hkv, T, D|Dv] (any strides over the first
    three axes, contiguous last axis -- a transposed ``[S, T, Hkv, D]``
    strip is read in place); lengths: [S] int (0 = free slot, exact
    zeros).  The kernel folds ``block_t`` positions per tile, one tile a
    block, then combines the tiles.  Returns [S, Hkv, G, Dv] in q.dtype."""
    s, hkv, g, d = q.shape
    t = k.shape[2]
    dv = v.shape[3]
    tile = max(1, min(block_t, MAX_TILE))
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale=scale,
                                      window=window,
                                      n_t_chunks=max(1, -(-t // tile)))
    _check_cuda("decode_attention", q, k, v, lengths)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("decode_attention: q, k and v must share a dtype")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: k/v need a contiguous last axis")
    q = q.contiguous()
    lens = _i32(lengths)
    o = torch.empty((s, hkv, g, dv), dtype=q.dtype, device=q.device)
    if s == 0:
        return o
    body = kernel_body(q.dtype, k.dtype, d, dv, _row_bytes(k, v))
    launch_contig(body, q, k, v, lens, o, tile=tile, window=window,
                  scale=scale)
    decode_attention.launches += 1
    return o


def _paged_operands(what, q, k_pages, v_pages, k_scale, v_scale):
    """Check a paged call's operands; returns the scales made contiguous and
    the element strides the C entry takes (arenas, then scales)."""
    hkv = q.shape[1]
    ps = k_pages.shape[1]
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError(f"{what}: int8 arenas need both k_scale and "
                         "v_scale, and only they take scales")
    if not quant and (k_pages.dtype != q.dtype or v_pages.dtype != q.dtype):
        raise ValueError(f"{what}: q and the arenas must share a dtype")
    if k_pages.stride(3) != 1 or v_pages.stride(3) != 1:
        raise ValueError(f"{what}: arenas need a contiguous last axis")
    strides = [*k_pages.stride()[:3], *v_pages.stride()[:3], 0, 0, 0]
    if not quant:
        return None, None, strides
    if k_scale.shape != v_scale.shape or k_scale.dtype != torch.float32:
        raise ValueError(f"{what}: scales must be f32 and of one shape")
    ksp, vsp = k_scale.contiguous(), v_scale.contiguous()
    strides[6:] = [ps, 1, 0] if ksp.ndim == 2 else [ps * hkv, hkv, 1]
    return ksp, vsp, strides


def decode_attention_paged(q, k_pages, v_pages, page_table, lengths,
                           k_scale=None, v_scale=None, *, scale: float,
                           window: int | None = None,
                           pages_per_tile: int = 1) -> torch.Tensor:
    """Single-query attention against a PAGED cache.

    q: [S, Hkv, G, D]; k_pages/v_pages: [P, ps, Hkv, D|Dv] arenas (bf16,
    f32, or int8 with ``k_scale``/``v_scale`` f32 sidecars ``[P, ps]`` or
    ``[P, ps, Hkv]``); page_table: [S, Pmax] int; lengths: [S] int.  Table
    entries backing no valid position may point anywhere: the length mask
    hides them.  The kernel folds ``pages_per_tile * ps`` positions per
    tile (at most ``MAX_TILE``), one tile a block, then combines the
    tiles.  Returns [S, Hkv, G, Dv] in q.dtype."""
    s, hkv, g, d = q.shape
    ps = k_pages.shape[1]
    dv = v_pages.shape[3]
    pmax = page_table.shape[1]
    ppt = max(1, min(pages_per_tile, pmax, MAX_PAGES_PER_TILE))
    if q.device.type == "cpu":
        return decode_attention_paged_plain(
            q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
            scale=scale, window=window, n_t_chunks=max(1, -(-pmax // ppt)))
    _check_cuda("decode_attention_paged", q, k_pages, v_pages, page_table,
                lengths, k_scale, v_scale)
    ksp, vsp, strides = _paged_operands("decode_attention_paged", q,
                                        k_pages, v_pages, k_scale, v_scale)
    q = q.contiguous()
    table, lens = _i32(page_table), _i32(lengths)
    o = torch.empty((s, hkv, g, dv), dtype=q.dtype, device=q.device)
    if s == 0:
        return o
    body = kernel_body(q.dtype, k_pages.dtype, d, dv,
                       _row_bytes(k_pages, v_pages))
    launch_paged(body, q, k_pages, v_pages, table, lens, ksp, vsp, strides,
                 o, tile=min(ppt * ps, MAX_TILE), window=window, scale=scale)
    if ksp is None:
        decode_attention_paged.launches += 1
    else:
        decode_attention_paged_int8.launches += 1
    return o


decode_attention.launches = 0
decode_attention_paged.launches = 0
# the paged kernel's launches over int8 arenas (its general body with the
# scales fused), counted apart from its other launches
decode_attention_paged_int8 = types.SimpleNamespace(launches=0)
