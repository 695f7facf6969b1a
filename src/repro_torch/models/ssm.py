"""Linear-recurrence mixers: mamba2-style SSD (hymba) and RWKV6 (Finch).

Both are computed in *chunked* form, as in the reference: the contributions
inside a chunk as dense products, the state carried from chunk to chunk.
Every decay factor is applied as ``exp(log-decay difference) <= 1``, so
nothing overflows: the same "never scale up" discipline as the paper's
``(m, n)`` algebra.  Decode uses the exact one-token recurrence.

The chunk plan is the reference's, chunk for chunk, because the chunk sets
the float32 summation order:

  * up to ``MAX_CHUNKS`` chunks the loop is unrolled, the chunk at least
    ``ceil(s / MAX_CHUNKS)`` and at most the cap;
  * past that the chunk is the cap and the reference runs the loop as a
    ``lax.scan``, which needs ``s`` to be a multiple of the chunk (it
    asserts so).  The port runs the same chunks in a Python loop and
    raises ``ValueError`` on the same inputs.

  * mamba2-style SSD: one scalar decay per head and step (state
    ``[H, dk, dv]``);
  * RWKV6: a data-dependent decay per channel (state ``[H, dk, dv]``) and a
    bonus ``u`` on the diagonal.

Everything inside a chunk runs in float32; each chunk's output is cast
back to the input dtype.
"""

from __future__ import annotations

import torch

MAX_CHUNKS = 32          # the reference's unrolled-loop bound
SSD_CHUNK_CAP = 1024     # intra tensor is O(c^2 * H): cheap
WKV_CHUNK_CAP = 256      # intra tensor is O(c^2 * H * dk): expensive

F32 = torch.float32


def _plan(s: int, chunk: int, cap: int):
    """Returns (chunk, n_chunks, use_scan)."""
    chunk = min(max(chunk, -(-s // MAX_CHUNKS)), cap)
    n = -(-s // chunk)
    return chunk, n, n > MAX_CHUNKS


def _slices(s: int, chunk: int, nchunks: int, use_scan: bool):
    if use_scan and s % chunk:
        raise ValueError(
            f"{s} positions in {nchunks} chunks of {chunk}: past "
            f"{MAX_CHUNKS} chunks the length must be a multiple of the "
            "chunk (the reference's scan asserts s % chunk == 0)")
    return [slice(i * chunk, min(s, (i + 1) * chunk))
            for i in range(nchunks)]


# ---------------------------------------------------------------------------
# Chunked scalar-decay SSD (mamba2-style).  Everything is [B, S, H, ...].
# ---------------------------------------------------------------------------
SSD_GROUP_ELEMS = 1 << 24   # elements of one [B, g, c, c, H] decay tensor


def ssd_chunked(xv, log_a, bk, ck, chunk: int, state0=None,
                return_state: bool = False):
    """y_t = c_t^T h_t,  h_t = exp(log_a_t) * h_{t-1} + b_t xv_t^T.

    xv:    [B, S, H, dv]   (input values, dt premultiplied)
    log_a: [B, S, H]       (<= 0; per-head scalar log decay)
    bk,ck: [B, S, H, dk]   (input/output projections, B and C)
    Returns y: [B, S, H, dv] (and the final state [B, H, dk, dv]).

    The chunks are the reference's; the work inside them, which does not
    depend on the carried state, runs for a group of chunks at once (as
    many as keep a [B, g, c, c, H] tensor within SSD_GROUP_ELEMS), and
    only the carry from chunk to chunk is a loop: a scan of one chunk at
    a time is bound by the host, some 30 small kernel launches a chunk.  A ragged last
    chunk is zero-padded: its pad positions decay by exp(0) = 1 and add
    nothing (b = 0), so the state and the real positions are unchanged."""
    b, s, h, dv = xv.shape
    chunk, nchunks, use_scan = _plan(s, chunk, SSD_CHUNK_CAP)
    _slices(s, chunk, nchunks, use_scan)
    pad = nchunks * chunk - s

    def chunks(t):                     # -> float32 [B, n, c, H, ...]
        t = t.to(F32)
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad, *t.shape[2:]))], dim=1)
        return t.reshape(b, nchunks, chunk, *t.shape[2:])

    xvc, bc, cc = chunks(xv), chunks(bk), chunks(ck)
    la_cum = torch.cumsum(chunks(log_a), dim=2)            # [B, n, c, H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=F32,
                                device=xv.device))[:, :, None]
    state = (torch.zeros((b, h, bk.shape[-1], dv), dtype=F32,
                         device=xv.device)
             if state0 is None else state0.to(F32))
    group = max(1, SSD_GROUP_ELEMS // (b * chunk * chunk * h))
    ys = []
    for lo in range(0, nchunks, group):
        la, x, bg, cg = (t[:, lo:lo + group] for t in (la_cum, xvc, bc, cc))
        # inside a chunk: D_ij = exp(LA_i - LA_j) for j <= i (<= 1, safe)
        delta = la[:, :, :, None, :] - la[:, :, None, :, :]  # [B,g,c,c,H]
        d = torch.exp(torch.clamp(delta, max=0.0)) * tri
        scores = torch.einsum("bnchk,bnjhk->bncjh", cg, bg) * d
        y_intra = torch.einsum("bncjh,bnjhv->bnchv", scores, x)
        # each chunk's own part of the state it hands on:
        # sum_j exp(LA_C - LA_j) b_j x_j^T; the carry adds exp(LA_C) h_0
        w_all = torch.exp(la[:, :, -1:] - la)                 # [B, g, c, H]
        own = torch.einsum("bnch,bnchk,bnchv->bnhkv", w_all, bg, x)
        decay = torch.exp(la[:, :, -1])[..., None, None]     # [B,g,H,1,1]
        entering = []
        for i in range(own.shape[1]):
            entering.append(state)
            state = decay[:, i] * state + own[:, i]
        # the carried state's contribution to every position
        y_state = torch.einsum("bnch,bnchk,bnhkv->bnchv", torch.exp(la), cg,
                               torch.stack(entering, dim=1))
        ys.append((y_state + y_intra).to(xv.dtype))
    y = torch.cat(ys, dim=1).reshape(b, nchunks * chunk, h, dv)[:, :s]
    return (y, state) if return_state else y


def ssd_step(state, xv, log_a, bk, ck):
    """One token of the recurrence.  state: [B, H, dk, dv]; the others
    [B, H, ...].  Returns (y [B, H, dv], new state)."""
    state = (torch.exp(log_a.to(F32))[:, :, None, None] * state
             + torch.einsum("bhk,bhv->bhkv", bk.to(F32), xv.to(F32)))
    y = torch.einsum("bhk,bhkv->bhv", ck.to(F32), state)
    return y.to(xv.dtype), state


# ---------------------------------------------------------------------------
# Chunked per-channel-decay WKV6 (RWKV "Finch").
# ---------------------------------------------------------------------------
def _wkv6_chunk(state, rc, kc, vc, lw, u):
    """One chunk: returns (new_state, out_chunk).  All float32.

    ``dmat`` is [B, c, c, H, dk]: the chunk's length bounds it, and the
    chunk is at most WKV_CHUNK_CAP (256).  At rwkv6-1.6b's full width (32
    heads of 64) one prompt's chunk of 256 is 537 MB; the serving engine
    prefills one prompt at a time, so B is 1 there."""
    c = rc.shape[1]
    lw_cum = torch.cumsum(lw, dim=1)                       # [B, c, H, dk]
    # the state's contribution ("decay, then read", as wkv6_step)
    y_state = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(lw_cum), state)
    # inside the chunk: j < i with decay prod_{s in (j, i]} w_s per channel,
    # plus the u bonus on the diagonal (j == i)
    delta = lw_cum[:, :, None] - lw_cum[:, None]           # [B, c, c, H, dk]
    tri = torch.tril(torch.ones((c, c), dtype=F32, device=rc.device),
                     diagonal=-1)
    dmat = torch.exp(torch.clamp(delta, max=0.0)) * tri[None, :, :, None,
                                                        None]
    del delta
    scores = torch.einsum("bcjhk,bjhk->bcjh", dmat * rc[:, :, None], kc)
    del dmat
    diag = torch.einsum("bchk,hk,bchk->bch", rc, u, kc)
    y_intra = (torch.einsum("bcjh,bjhv->bchv", scores, vc)
               + diag[..., None] * vc)
    # the carry: S_C = diag(exp(LW_C)) S_0 + sum_j diag(exp(LW_C - LW_j)) k v^T
    w_tail = torch.exp(lw_cum[:, -1:] - lw_cum)            # [B, c, H, dk]
    state = (torch.exp(lw_cum[:, -1])[..., None] * state
             + torch.einsum("bchk,bchv->bhkv", kc * w_tail, vc))
    return state, y_state + y_intra


def wkv6_chunked(r, k, v, log_w, u, chunk: int, state0=None,
                 return_state: bool = False):
    """out_t = r_t^T (diag(u) k_t v_t^T + S_{t-1});
       S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T.

    r, k:  [B, S, H, dk];  v: [B, S, H, dv]
    log_w: [B, S, H, dk]   (<= 0, a data-dependent decay per channel)
    u:     [H, dk]         (the bonus of the current token)
    """
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    chunk, nchunks, use_scan = _plan(s, chunk, WKV_CHUNK_CAP)
    state = (torch.zeros((b, h, dk, dv), dtype=F32, device=r.device)
             if state0 is None else state0.to(F32))
    outs = []
    for sl in _slices(s, chunk, nchunks, use_scan):
        state, y = _wkv6_chunk(state, r[:, sl].to(F32), k[:, sl].to(F32),
                               v[:, sl].to(F32), log_w[:, sl].to(F32), u)
        outs.append(y.to(r.dtype))
    out = torch.cat(outs, dim=1)
    return (out, state) if return_state else out


def wkv6_step(state, r, k, v, log_w, u):
    """One token of WKV6.  state [B, H, dk, dv]; r / k / v / log_w
    [B, H, d*].  Returns (y [B, H, dv], new state)."""
    rf, kf, vf = r.to(F32), k.to(F32), v.to(F32)
    w = torch.exp(log_w.to(F32))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    y = torch.einsum("bhk,bhkv->bhv", rf, u[None, :, :, None] * kv
                     + w[..., None] * state)
    state = w[..., None] * state + kv
    return y.to(r.dtype), state


# ---------------------------------------------------------------------------
# Flop accounting for the reference's scan branch (its roofline correction).
# ---------------------------------------------------------------------------
def chunk_plan(kind: str, s: int, chunk: int):
    cap = WKV_CHUNK_CAP if kind == "rwkv6" else SSD_CHUNK_CAP
    return _plan(s, chunk, cap)


def scan_flops_correction(kind: str, b: int, s: int, h: int, dk: int,
                          dv: int, chunk: int) -> float:
    """The FLOPs the reference's cost analysis misses when the chunk loop
    is a scan: (n_chunks - 1) x a chunk's flops (a scan body is counted
    once); 0 when the loop is unrolled.  A chunk counts its dominant
    products at 2 flops a multiply-add, plus one op each for the decay
    tensors."""
    chunk, n, use_scan = chunk_plan(kind, s, chunk)
    if not use_scan:
        return 0.0
    c = chunk
    if kind == "rwkv6":
        per = (b * c * c * h * dk * 3        # dmat (sub, exp, mask)
               + 2 * b * c * c * h * dk      # scores
               + 2 * b * c * c * h * dv      # applied to v
               + 3 * 2 * b * c * h * dk * dv)  # the state's read and carry
    else:
        per = (b * c * c * h * 3             # scalar dmat
               + 2 * b * c * c * h * dk      # B^T C scores
               + 2 * b * c * c * h * dv      # applied to the values
               + 3 * 2 * b * c * h * dk * dv)
    return float((n - 1) * per)
