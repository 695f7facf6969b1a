"""Flash attention with the paper's (m, n) accumulator: CUDA kernel wrappers
and their plain versions.

``flash_attention_fwd_gqa`` launches the forward of
``csrc/flash_attention.cu`` (o and the per-row ``(m_sum, n_sum)`` it
saves); ``flash_attention_bwd_gqa`` launches its dq and dk/dv kernels,
which recompute the probabilities from those stats.  Each wrapper launches
its kernels for tensors on the card and runs its plain version beside it
for tensors on the CPU.  There is no fallback: a CUDA tensor reaches the
kernel or the call raises.  Each wrapper counts its launches in
``.launches``.

Layouts: q ``[B, H, Sq, D]``; o, do ``[B, H, Sq, Dv]``; k ``[B, Hkv, Skv,
D]``, v ``[B, Hkv, Skv, Dv]`` with H a multiple of Hkv.  v may carry a head
dim of its own (multi-head latent attention: D 192, Dv 128), as the
reference's.  GQA indexes KV head ``h // (H // Hkv)`` for q-head ``h``:
K/V are never repeated, and dk/dv sum over the group.  With Hkv == H this
is the reference's layout (K/V pre-expanded to the q-heads).  Query row
``i`` sits at position ``i + Skv - Sq``: the ends of the two sequences
align, as in the reference, so rows of a causal call with Sq > Skv attend
nothing and give exact zeros.

The plain versions are the torch twins of the reference's chunked (m, n)
forms (``ops._flash_mn_fwd`` / ``_flash_mn_bwd``): Python-looped chunks of
queries and keys, with chunks that every row's mask covers skipped, as
``models.attention.mn_chunk_attention`` skips them (a masked chunk folds in
as the monoid's identity, so the skip changes no number).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import numerics
from repro_torch.kernels import _build
from repro_torch.kernels.twopass_softmax import _DTYPES, _I, _P

MAX_Q_CHUNKS = 8           # chunk-count guards of the plain versions
MAX_KV_CHUNKS = 16
MMA_MAX_D = 256            # the mma kernels' largest head dim; wider
                           # heads take the wmma kernels, in chunks

_F = ctypes.c_float


def chunk_counts(sq: int, skv: int, block_q: int, block_k: int):
    """The plain versions' chunk counts for chunk lengths ``block_q`` x
    ``block_k`` (capped; the kernels' tiles do not depend on them)."""
    return (max(1, min(MAX_Q_CHUNKS, -(-sq // block_q))),
            max(1, min(MAX_KV_CHUNKS, -(-skv // block_k))))


def _spans(n: int, chunks: int):
    c = max(1, -(-n // chunks))
    return [(lo, min(n, lo + c)) for lo in range(0, n, c)]


def _dead(qlo, qhi, klo, khi, off, causal, window) -> bool:
    """Every row of queries [qlo, qhi) is masked off keys [klo, khi)."""
    if causal and klo > qhi - 1 + off:
        return True
    return window is not None and khi - 1 <= qlo + off - window


def _masked_scores(q_blk, k_blk, qlo, klo, off, *, scale, causal, window):
    """Scores ``[b, hkv, g, bq, bk]`` of one chunk pair with the end-aligned
    causal / window mask (-inf)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
    if causal or window is not None:
        dev = s.device
        qpos = (torch.arange(qlo, qlo + s.shape[3], device=dev) + off)[:, None]
        kpos = torch.arange(klo, klo + s.shape[4], device=dev)[None, :]
        mask = torch.ones((s.shape[3], s.shape[4]), dtype=torch.bool,
                          device=dev)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, -torch.inf)
    return s


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """``[B, H, S, E]`` -> ``[B, Hkv, G, S, E]`` float32 (a view when it
    can be)."""
    b, h, s, e = x.shape
    return x.to(torch.float32).reshape(b, hkv, h // hkv, s, e)


def flash_attention_fwd_gqa_plain(q, k, v, *, causal: bool, scale: float,
                                  window: int | None = None,
                                  n_q_chunks: int = 1, n_kv_chunks: int = 1):
    """``(o [B, H, Sq, Dv] in q.dtype, m_sum [B, H, Sq, 1], n_sum [B, H,
    Sq, 1])``: per chunk pair ``(m, n) = ExtExp(s)``, ``n_loc = max n``,
    ``w = m 2^(n - n_loc)``, folded with exact power-of-two rescales;
    ``o / max(m_sum, 1e-37)`` at the end."""
    b, h, sq, _ = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    qf = _grouped(q, hkv)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    off = skv - sq
    f32 = dict(dtype=torch.float32, device=q.device)
    os_, ms, ns = [], [], []
    for qlo, qhi in _spans(sq, n_q_chunks):
        bq = qhi - qlo
        o_acc = torch.zeros((b, hkv, g, bq, dv), **f32)
        m_acc = torch.zeros((b, hkv, g, bq, 1), **f32)
        n_acc = torch.full((b, hkv, g, bq, 1), numerics.MINUS_INF_N, **f32)
        for klo, khi in _spans(skv, n_kv_chunks):
            if _dead(qlo, qhi, klo, khi, off, causal, window):
                continue
            s = _masked_scores(qf[:, :, :, qlo:qhi], kf[:, :, klo:khi], qlo,
                               klo, off, scale=scale, causal=causal,
                               window=window)
            m, n = numerics.ext_exp(s)
            n_loc = n.amax(dim=-1, keepdim=True)
            w = m * numerics.exp2_int(n - n_loc)
            m_loc = w.sum(dim=-1, keepdim=True)
            o_loc = torch.einsum("bhgqk,bhkd->bhgqd", w, vf[:, :, klo:khi])
            n_new = torch.maximum(n_acc, n_loc)
            a_acc = numerics.exp2_int(n_acc - n_new)
            a_loc = numerics.exp2_int(n_loc - n_new)
            o_acc = o_acc * a_acc + o_loc * a_loc
            m_acc = m_acc * a_acc + m_loc * a_loc
            n_acc = n_new
        os_.append(o_acc / torch.clamp(m_acc, min=1e-37))
        ms.append(m_acc)
        ns.append(n_acc)

    def cat(xs, e):
        return torch.cat(xs, dim=3).reshape(b, h, sq, e)

    return cat(os_, dv).to(q.dtype), cat(ms, 1), cat(ns, 1)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(do * o)`` over the Dv columns, float32 ``[B, H, Sq, 1]``:
    the backward's diagonal term, plain PyTorch on every route (the
    reference computes it outside its kernels too)."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1,
                                                           keepdim=True)


def flash_attention_bwd_gqa_plain(q, k, v, o, m_sum, n_sum, do, *,
                                  causal: bool, scale: float,
                                  window: int | None = None,
                                  n_q_chunks: int = 1, n_kv_chunks: int = 1):
    """``(dq, dk, dv)`` in the inputs' dtypes from the forward's stats:
    per chunk pair ``p = m 2^(n - n_sum) / max(m_sum, 1e-37)``,
    ``ds = p (do v^T - delta) scale``; ``dq = ds k``, ``dk = ds^T q``,
    ``dv = p^T do``, dk/dv summed over each KV head's q-heads."""
    b, h, sq, d = q.shape
    hkv, skv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    qf, dof = _grouped(q, hkv), _grouped(do, hkv)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    delta = _grouped(attention_delta(o, do), hkv)
    inv = 1.0 / torch.clamp(_grouped(m_sum, hkv), min=1e-37)
    ns = _grouped(n_sum, hkv)
    off = skv - sq
    f32 = dict(dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, hkv, skv, d), **f32)
    dv = torch.zeros((b, hkv, skv, dv_dim), **f32)
    dqs = []
    for qlo, qhi in _spans(sq, n_q_chunks):
        q_i, do_i = qf[:, :, :, qlo:qhi], dof[:, :, :, qlo:qhi]
        dq_i = torch.zeros((b, hkv, g, qhi - qlo, d), **f32)
        for klo, khi in _spans(skv, n_kv_chunks):
            if _dead(qlo, qhi, klo, khi, off, causal, window):
                continue
            s = _masked_scores(q_i, kf[:, :, klo:khi], qlo, klo, off,
                               scale=scale, causal=causal, window=window)
            m, n = numerics.ext_exp(s)
            p = (m * numerics.exp2_int(n - ns[:, :, :, qlo:qhi])
                 * inv[:, :, :, qlo:qhi])
            dp = torch.einsum("bhgqe,bhke->bhgqk", do_i, vf[:, :, klo:khi])
            ds = p * (dp - delta[:, :, :, qlo:qhi]) * scale
            dq_i = dq_i + torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                       kf[:, :, klo:khi])
            dk[:, :, klo:khi] += torch.einsum("bhgqk,bhgqd->bhkd", ds, q_i)
            dv[:, :, klo:khi] += torch.einsum("bhgqk,bhgqe->bhke", p, do_i)
        dqs.append(dq_i)
    dq = torch.cat(dqs, dim=3).reshape(b, h, sq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P] * 6 + [_I] * 7 + [_F, _I, _I,
                                                              _I, _P]
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_bwd.argtypes = [_P] * 10 + [_I] * 7 + [_F] + [_I] * 4 \
        + [_P]
    lib.flash_attention_bwd.restype = _I
    lib.flash_attention_blocks_per_sm.argtypes = [_I, _I, _I]
    lib.flash_attention_blocks_per_sm.restype = _I
    lib.flash_attention_uses_mma.argtypes = [_I, _I, _I]
    lib.flash_attention_uses_mma.restype = _I
    return lib


def blocks_per_sm(d: int, which: int, dv: int | None = None) -> int:
    """Blocks an SM of the bf16 ``mma.sync`` kernel at head dims ``d``,
    ``dv`` (v's, ``d`` by default; ``which`` 0 = dq, 1 = dk/dv, 2 =
    forward), or -1 where bf16 at those head dims takes the wmma / FFMA
    kernels."""
    return _lib().flash_attention_blocks_per_sm(d, d if dv is None else dv,
                                                which)


def design(dtype: torch.dtype, d: int, dv: int | None = None) -> str:
    """The kernels a call on the card takes at ``dtype`` and head dims
    ``d``, ``dv``, as the CUDA side routes it: ``"mma"`` (``flash_fwd_mma``,
    ``flash_dq_mma``, ``flash_dkv_mma``: bf16 with both head dims
    multiples of 8, at most ``MMA_MAX_D``) or ``"wmma"`` (``flash_fwd``,
    ``flash_dq``, ``flash_dkv``; a head dim over 256 in chunks of 256)."""
    dv = d if dv is None else dv
    rc = _lib().flash_attention_uses_mma(d, dv, _DTYPES[dtype])
    if rc < 0:
        raise ValueError(f"flash attention: head dims {d} / {dv}; the "
                         "kernels take 1 or more")
    return "mma" if rc else "wmma"


def _check_qkv(what: str, q, k, v, window) -> None:
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} on {t.device}; expected all "
                             "tensors on the CPU or all on the card")
        if (t.ndim != 4 or not t.is_contiguous() or t.dtype not in _DTYPES
                or t.dtype != q.dtype):
            raise ValueError(f"{what}: {name} must be a contiguous 4-D "
                             f"float32/bfloat16 tensor of q's dtype, got "
                             f"{tuple(t.shape)} {t.dtype}")
    b, h, _, d = q.shape
    if (k.shape[0] != b or v.shape[:3] != k.shape[:3]
            or h % k.shape[1] or k.shape[3] != d):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need q [B, H, Sq, D], k "
                         "[B, Hkv, Skv, D], v [B, Hkv, Skv, Dv] with Hkv "
                         "dividing H")
    for name, e in (("D", d), ("Dv", v.shape[3])):
        if e < 1:
            raise ValueError(f"{what}: head dim {name} = {e}; the kernels "
                             "take 1 or more")
    if window is not None and window <= 0:
        raise ValueError(f"{what}: window {window} must be positive")


def _args(q, k, v, scale, causal, window):
    b, h, sq, d = q.shape
    return (b, h, k.shape[1], sq, k.shape[2], d, v.shape[3], scale,
            int(bool(causal)), 0 if window is None else int(window))


def flash_attention_fwd_gqa(q, k, v, *, causal: bool = False,
                            scale: float | None = None,
                            window: int | None = None, block_q: int = 64,
                            block_k: int = 64):
    """Flash-attention forward: ``(o [B, H, Sq, Dv] in q.dtype, m_sum,
    n_sum [B, H, Sq, 1] float32)``.  ``block_q`` / ``block_k`` are the
    plain version's chunk lengths; the kernel's tile depends on D and the
    dtype only."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        nq, nkv = chunk_counts(q.shape[2], k.shape[2], block_q, block_k)
        return flash_attention_fwd_gqa_plain(
            q, k, v, causal=causal, scale=scale, window=window,
            n_q_chunks=nq, n_kv_chunks=nkv)
    _check_qkv("flash_attention_fwd_gqa", q, k, v, window)
    b, h, sq, _ = q.shape
    o = q.new_empty((b, h, sq, v.shape[3]))
    m = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    n = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, m, n
    lib = _lib()
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        m.data_ptr(), n.data_ptr(), *_args(q, k, v, scale, causal, window),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention_fwd_gqa")
    flash_attention_fwd_gqa.launches += 1
    return o, m, n


def flash_attention_bwd_gqa(q, k, v, o, m_sum, n_sum, do, *,
                            causal: bool = False, scale: float | None = None,
                            window: int | None = None, block_q: int = 64,
                            block_k: int = 64):
    """``(dq, dk, dv)`` in the inputs' dtypes from the forward's ``(m_sum,
    n_sum)`` at the same mask and scale: the dq kernel, then the dk/dv
    kernel (one launch of this wrapper counts both).  ``block_q`` /
    ``block_k`` are the plain version's chunk lengths."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        nq, nkv = chunk_counts(q.shape[2], k.shape[2], block_q, block_k)
        return flash_attention_bwd_gqa_plain(
            q, k, v, o, m_sum, n_sum, do, causal=causal, scale=scale,
            window=window, n_q_chunks=nq, n_kv_chunks=nkv)
    what = "flash_attention_bwd_gqa"
    _check_qkv(what, q, k, v, window)
    want = (*q.shape[:3], v.shape[3])
    for t, name in ((o, "o"), (do, "do")):
        if tuple(t.shape) != want or t.device != q.device:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} on "
                             f"{t.device}; expected {want} (q's rows, v's "
                             f"head dim) on {q.device}")
    rows = q.shape[0] * q.shape[1] * q.shape[2]
    for t, name in ((m_sum, "m_sum"), (n_sum, "n_sum")):
        if t.numel() != rows or t.device != q.device:
            raise ValueError(f"{what}: {name} needs {rows} values on "
                             f"{q.device}, got {tuple(t.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.shape[2] == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dout = do.to(q.dtype).contiguous()
    m, n = (t.to(torch.float32).contiguous() for t in (m_sum, n_sum))
    delta = attention_delta(o, do).contiguous()
    for which in (0, 1):
        bwd_kernel(which, q, k, v, dout, m, n, delta, dq, dk, dv,
                   causal=causal, scale=scale, window=window)
    flash_attention_bwd_gqa.launches += 1
    return dq, dk, dv


def bwd_kernel(which: int, q, k, v, dout, m, n, delta, dq, dk, dv, *,
               causal: bool, scale: float, window: int | None) -> None:
    """One kernel of the backward on checked, contiguous card tensors:
    ``which`` 0 writes dq, 1 writes dk and dv.  Counts nothing: the wrapper
    above counts its pair of launches, and a timing may call one alone."""
    lib = _lib()
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        m.data_ptr(), n.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_args(q, k, v, scale, causal,
                                             window),
        which, _DTYPES[q.dtype], torch.cuda.current_stream(q.device)
        .cuda_stream)
    _build.check(lib, rc, "flash_attention_bwd_gqa")


flash_attention_fwd_gqa.launches = 0
flash_attention_bwd_gqa.launches = 0
