"""GQA attention with the paper's (m, n) softmax as its core (dense, encdec
and moe families), and DeepSeek-V2's multi-head latent attention (MLA: a
compressed latent cache re-expanded on every read).

Cores take q: [B, Hkv, G, Sq, D]; k: [B, Hkv, Skv, D]; v: [B, Hkv, Skv, Dv]:
GQA runs in grouped form, KV heads are never repeated.

Caches are updated IN PLACE (the reference is functional): a serving pool
holds every layer's KV, and a copy per step would double its memory and
traffic.  ``attention`` returns the same cache dict it was given.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import numerics
from repro_torch.core.policy import DEFAULT_POLICY, SoftmaxPolicy
from repro_torch.core.softmax_api import SoftmaxAlgorithm
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers


def head_layout(cfg: ModelConfig, tp: int = 1):
    """Returns (hq_padded, grouped, real_head_mask, head_to_kv), as the
    reference.  q-heads are padded up to a multiple of ``tp``.
    ``grouped``: group-major, ``hq / hkv`` q-heads a KV head, the first
    ``n_heads / hkv`` of each group real (the KV heads divide tp).
    Otherwise KV is replicated and expanded per q-head through
    ``head_to_kv`` (the first ``n_heads`` real, padded ones read KV head
    ``hkv - 1``).  Static numpy."""
    hq = cfg.padded_heads(tp)
    hkv = cfg.n_kv_heads
    if hq % hkv == 0 and hkv % tp == 0:
        g_pad = hq // hkv
        g_real = cfg.n_heads // hkv
        return hq, True, (np.arange(hq) % g_pad) < g_real, None
    g_real = max(1, cfg.n_heads // hkv)
    head_to_kv = np.minimum(np.arange(hq) // g_real, hkv - 1)
    return hq, False, np.arange(hq) < cfg.n_heads, head_to_kv


class Layout(NamedTuple):
    """A rank's heads (:func:`local_layout`).  ``hq`` q-heads and ``hkv``
    KV heads its weights and cache hold.  Grouped, ``hq / hkv`` q-heads
    read each KV head.  Ungrouped, q-head ``h`` reads KV head
    ``h2k[h]`` (an index tensor): a prefill expands its own K/V through
    it, and a decode step, which reads the arena, regroups the q-heads
    instead: ``q_rows`` ([nkv * g] of q-head indices, ``hq`` a zero row)
    lays them out as ``g`` rows for each of the ``nkv`` KV heads from
    ``kv0`` on (a view of the arena: ``h2k`` rises, so they are one
    run), and ``o_rows`` ([hq]) picks each q-head's row back out.  The
    grouped layout is the same with ``kv0`` 0, ``nkv = hkv`` and no
    index."""
    hq: int
    grouped: bool
    hkv: int
    h2k: torch.Tensor | None
    kv0: int
    nkv: int
    g: int
    q_rows: torch.Tensor | None
    o_rows: torch.Tensor | None


def local_layout(cfg: ModelConfig, tp: int, device) -> Layout:
    """This rank's :class:`Layout`, its index tensors on ``device``.
    Without an active mesh (or on a model axis of one rank) it is
    :func:`head_layout`'s at ``tp`` (padding only).  Under a mesh whose
    model axis has ``tp`` ranks the q-heads split evenly (padding made
    them a multiple of tp); grouped, so do the KV heads, and each rank
    keeps whole groups; ungrouped, every rank holds all KV heads and its
    q-heads' slice of ``head_to_kv``."""
    from repro_torch.distributed import collectives

    shards, rank = collectives.model_axis()
    if shards > 1 and shards != tp:
        raise ValueError(f"a model axis of {shards} ranks over weights "
                         f"padded for tp {tp}: build the model with "
                         f"tp={shards}")
    return _local_layout(cfg, tp, shards, rank, torch.device(device))


@functools.lru_cache(maxsize=None)
def _local_layout(cfg: ModelConfig, tp: int, shards: int, rank: int,
                  device: torch.device) -> Layout:
    """:func:`local_layout`, its indices made once (a captured decode step
    reads the same tensors at every replay, and copies nothing from the
    host)."""
    hq, grouped, _, h2k = head_layout(cfg, tp)
    hkv = cfg.n_kv_heads
    if shards > 1:
        hq //= shards
        if grouped:
            hkv //= shards
        else:
            h2k = h2k[rank * hq:(rank + 1) * hq]
    if grouped:
        return Layout(hq, True, hkv, None, 0, hkv, hq // hkv, None, None)
    kv0 = int(h2k[0])
    nkv = int(h2k[-1]) - kv0 + 1
    counts = np.bincount(h2k - kv0, minlength=nkv)
    g = int(counts.max())
    q_rows = np.full(nkv * g, hq)
    first = np.concatenate([[0], np.cumsum(counts)])[h2k - kv0]
    o_rows = (h2k - kv0) * g + np.arange(hq) - first
    q_rows[o_rows] = np.arange(hq)

    def index(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return Layout(hq, False, hkv, index(h2k), kv0, nkv, g, index(q_rows),
                  index(o_rows))


def _regroup(q: torch.Tensor, lay: Layout) -> torch.Tensor:
    """One query a q-head ``[B, hq, hd]`` as the decode ops take it:
    ``[B, nkv, g, hd]`` (ungrouped: :class:`Layout`'s rows, zero rows
    where a KV head reads fewer than ``g`` q-heads)."""
    b, _, hd = q.shape
    if lay.grouped:
        return q.reshape(b, lay.hkv, lay.g, hd)
    q = torch.cat([q, q.new_zeros(b, 1, hd)], 1)
    return q[:, lay.q_rows].reshape(b, lay.nkv, lay.g, hd)


def _ungroup(o: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The decode ops' ``[B, nkv, g, hd]`` back to ``[B, hq * hd]``."""
    b = o.shape[0]
    o = o.reshape(b, lay.nkv * lay.g, -1)
    if not lay.grouped:
        o = o[:, lay.o_rows]
    return o.reshape(b, -1)


def _zero_pad_heads(w: torch.Tensor, mask, head_dim: int,
                    axis: int) -> torch.Tensor:
    """Zero the slices of ``w`` along ``axis`` that belong to padded heads
    (``mask``: static numpy, True for a real head), in place.  Zero
    q-columns and out-projection rows make the padding exact."""
    if bool(np.asarray(mask).all()):
        return w
    full = torch.as_tensor(np.repeat(np.asarray(mask), head_dim))
    pad = (~full).nonzero()[:, 0].to(w.device)
    w.index_fill_(axis, pad, 0)
    return w


def _block_mask(qpos, kpos, causal, window, kv_len):
    mask = kpos[None, :] < kv_len
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def mn_chunk_attention(q, k, v, *, causal, window=None, scale,
                       q_offset: int = 0, kv_len=None,
                       n_q_chunks: int = 1, n_kv_chunks: int = 1):
    """(m, n)-streamed chunked attention: causal/window-dead chunks are
    skipped, the running output is rescaled by exact powers of two."""
    b, hkv, g, sq, _ = q.shape
    skv = k.shape[2]
    dv = v.shape[3]
    kv_len = skv if kv_len is None else kv_len
    dev = q.device
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    qc = -(-sq // n_q_chunks)
    kc = -(-skv // n_kv_chunks)
    outs = []
    for i in range(n_q_chunks):
        q_blk = qf[:, :, :, i * qc:(i + 1) * qc]
        bq = q_blk.shape[3]
        if bq == 0:
            continue
        qpos = torch.arange(i * qc, i * qc + bq, device=dev) + q_offset
        o_acc = torch.zeros((b, hkv, g, bq, dv), device=dev)
        m_acc = torch.zeros((b, hkv, g, bq, 1), device=dev)
        n_acc = torch.full((b, hkv, g, bq, 1), numerics.MINUS_INF_N,
                           device=dev)
        for j in range(n_kv_chunks):
            lo, hi = j * kc, min(skv, (j + 1) * kc)
            if lo >= hi:
                continue
            if causal and lo > (i * qc + bq - 1) + q_offset:
                continue
            if window is not None and hi - 1 <= i * qc + q_offset - window:
                continue
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, kf[:, :, lo:hi]) \
                * scale
            mask = _block_mask(qpos, torch.arange(lo, hi, device=dev),
                               causal, window, kv_len)
            s = torch.where(mask, s, -torch.inf)
            m, n = numerics.ext_exp(s)
            n_loc = n.amax(dim=-1, keepdim=True)
            w = m * numerics.exp2_int(n - n_loc)
            m_loc = w.sum(dim=-1, keepdim=True)
            o_loc = torch.einsum("bhgqk,bhkd->bhgqd", w, vf[:, :, lo:hi])
            n_new = torch.maximum(n_acc, n_loc)
            a_acc = numerics.exp2_int(n_acc - n_new)
            a_loc = numerics.exp2_int(n_loc - n_new)
            o_acc = o_acc * a_acc + o_loc * a_loc
            m_acc = m_acc * a_acc + m_loc * a_loc
            n_acc = n_new
        outs.append(o_acc / torch.clamp(m_acc, min=1e-37))
    return torch.cat(outs, dim=3).to(q.dtype)


def full_attention(q, k, v, *, causal, window=None, scale, q_offset=0,
                   kv_len=None, policy: SoftmaxPolicy | None = None,
                   qpos=None):
    """Single-block grouped attention; the softmax goes through the policy
    (the two-pass kernel with ``use_kernels``).  ``qpos`` overrides the
    query positions (prefill into a cache)."""
    policy = policy or DEFAULT_POLICY
    sq, skv = q.shape[3], k.shape[2]
    kv_len = skv if kv_len is None else kv_len
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if qpos is None:
        qpos = torch.arange(sq, device=q.device) + q_offset
    mask = _block_mask(qpos, torch.arange(skv, device=q.device), causal,
                       window, kv_len)
    s = torch.where(mask, s, -torch.inf)
    p = policy.softmax(s, axis=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p,
                        v.to(torch.float32)).to(q.dtype)


MAX_Q_CHUNKS = 8
MAX_KV_CHUNKS = 16
# Score matrices up to this size stay single-block (policy-honouring
# full_attention) unless blocks are overridden or tuned.
SINGLE_BLOCK_SCORES = 2048 * 2048


def resolve_chunks(sq: int, skv: int, policy: SoftmaxPolicy | None = None,
                   dtype=torch.float32, device=None) -> tuple[int, int]:
    """Chunk counts for :func:`mn_chunk_attention`; (1, 1) = single block.
    The registry's ``chunk_attention`` op resolves chunk LENGTHS (policy
    overrides > autotune cache > heuristic, keyed by ``dtype`` and the
    backend of ``device``); absent overrides or an autotune opt-in the
    heuristic never chunks a score matrix under ``SINGLE_BLOCK_SCORES``."""
    from repro_torch.kernels import registry

    policy = policy or DEFAULT_POLICY
    bq, bk = policy.resolve_blocks("chunk_attention", sq, skv, dtype,
                                   backend=registry.backend_of(device))
    heuristic_only = (policy.attn_block_q is None
                      and policy.attn_block_k is None
                      and not policy.autotune)
    if heuristic_only and sq * skv <= SINGLE_BLOCK_SCORES:
        return 1, 1
    return (min(MAX_Q_CHUNKS, -(-sq // bq)),
            min(MAX_KV_CHUNKS, -(-skv // bk)))


def _flash_route(q, k, v, policy, *, causal, window, scale, q_offset,
                 kv_len, qpos):
    """The training fast path: [B, Hkv, G, Sq, hd] self-attention through
    the differentiable ``flash_attention`` op (stats-saving forward,
    recompute-from-stats backward: the CUDA kernels on the card, their
    plain versions on the CPU), under exactly the reference's conditions:
    kernels on, the two-pass algorithm, no cache (no ``qpos`` / ``kv_len``,
    ``q_offset`` 0), and Sq == Skv when masked, because the kernels'
    positions are end-aligned and ``q_offset=0`` is begin-aligned.  Returns
    None otherwise.  K/V keep their Hkv heads: the kernels index KV head
    ``h // G`` (the reference broadcasts K/V to the q-heads instead)."""
    if not (policy.use_kernels and qpos is None and kv_len is None
            and q_offset == 0
            and policy.algorithm == SoftmaxAlgorithm.TWO_PASS):
        return None
    sq, skv = q.shape[3], k.shape[2]
    if (causal or window is not None) and sq != skv:
        return None
    b, hkv, g, _, hd = q.shape
    o = kernel_ops.flash_attention(q.reshape(b, hkv * g, sq, hd), k, v,
                                   causal=causal, scale=scale, window=window,
                                   policy=policy)
    return o.reshape(b, hkv, g, sq, v.shape[3])


def attention_core(q, k, v, *, causal, window, scale, q_offset=0,
                   kv_len=None, qpos=None, cfg: ModelConfig):
    """The flash route first (:func:`_flash_route`), as the reference.
    Serving always passes ``qpos`` (a cache is written), which takes
    :func:`full_attention` and so the policy's softmax."""
    policy = cfg.softmax_policy()
    o = _flash_route(q, k, v, policy, causal=causal, window=window,
                     scale=scale, q_offset=q_offset, kv_len=kv_len,
                     qpos=qpos)
    if o is not None:
        return o
    nq, nkv = resolve_chunks(q.shape[3], k.shape[2], policy, q.dtype,
                             q.device)
    if (nq == 1 and nkv == 1) or qpos is not None:
        return full_attention(
            q, k, v, causal=causal, window=window, scale=scale,
            q_offset=q_offset, kv_len=kv_len, qpos=qpos, policy=policy)
    return mn_chunk_attention(
        q, k, v, causal=causal, window=window, scale=scale,
        q_offset=q_offset, kv_len=kv_len, n_q_chunks=nq, n_kv_chunks=nkv)


def init_attention(gen, cfg: ModelConfig, dtype, lead: tuple = (),
                   tp: int = 1) -> dict:
    """q-heads padded to a multiple of ``tp`` (:func:`head_layout`), the
    padded heads' q-columns and out-projection rows zero, as the
    reference's ``init_attention(..., tp)``."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    hq, _, mask, _ = head_layout(cfg, tp)
    n = len(lead)

    def pad(axis):
        # zeroed as drawn, before a rank cuts its shard (layers.CutDraws)
        return functools.partial(_zero_pad_heads, mask=mask, head_dim=hd,
                                 axis=axis)

    p = {
        "wq": layers.init_dense(gen, d, hq * hd, dtype, bias=cfg.qkv_bias,
                                lead=lead, zero=pad(n + 1)),
        "wk": layers.init_dense(gen, d, cfg.n_kv_heads * hd, dtype,
                                bias=cfg.qkv_bias, lead=lead),
        "wv": layers.init_dense(gen, d, cfg.n_kv_heads * hd, dtype,
                                bias=cfg.qkv_bias, lead=lead),
        "wo": layers.init_dense(gen, hq * hd, d, dtype, lead=lead,
                                zero=pad(n)),
    }
    # (the biases start at zero: nothing to pad)
    return p


def attention(p: dict, x: torch.Tensor, cos, sin, *, cfg: ModelConfig,
              tp: int = 1, causal: bool = True, cache: dict | None = None,
              cache_pos=None, xkv: torch.Tensor | None = None,
              use_rope: bool = True, cache_positions=None, page_table=None,
              ring_valid=None):
    """GQA attention.  x: [B, S, d].

    * ``xkv`` ([B, T, d]): cross-attention, K/V from the encoder states,
      no causal mask.  RoPE applies only when ``use_rope and xkv is
      None``, as in the reference.
    * ``cache`` with ``cache_pos`` None (and no ``cache_positions``): a
      read-only cache (the lockstep decode's cross half): the query
      attends all of it, and nothing is written.  The K/V this call would
      project are not needed and not computed (the reference projects and
      drops them).

    * ``cache`` + ``cache_pos`` (int): write-then-attend over the cache
      (prefill at 0, lockstep decode at the fill).
    * ``ring_valid`` (int, with ``cache_pos`` already reduced mod the
      ring): the cache is an SWA ring whose first ``ring_valid`` slots are
      written.  Every written slot holds an in-window position, so only
      that bound masks: no causal or window mask, and the scores come in
      slot order.
    * ``cache_positions`` ([B] int, S == 1): ragged continuous-batching
      decode.  Each slot writes at its own position and attends its own
      prefix through ``decode_attention``; with ``page_table`` ([B, Pmax])
      the cache leaves are page arenas ``[P, ps, Hkv, hd]`` and the op is
      ``decode_attention_paged``.

    ``tp`` pads the q-heads (:func:`head_layout`).  The layout is
    grouped where the KV heads divide tp; otherwise each q-head reads its
    KV head through ``head_to_kv``: a prefill expands its K/V to the
    q-heads (G 1), and a ragged decode regroups the q-heads over a view
    of the cache's KV heads (:class:`Layout`), so that no step copies the
    arena.  Under a mesh (an active
    ``autoshard.hints`` context) the weights and the cache are this
    rank's (:func:`local_layout`) and the out-projection is row-parallel:
    its partial products are summed over the model axis.

    Returns (out, cache)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    lay = local_layout(cfg, tp, x.device)
    hq, grouped, hkv = lay.hq, lay.grouped, lay.hkv
    window = cfg.swa_window
    policy = cfg.softmax_policy()

    # the column-parallel inputs' gradients sum over the model axis
    # (collectives.copy_to_model); K / V replicated over it (KV heads that
    # do not divide tp) are copied after their product instead, so that
    # their weights' gradients, which each rank sees only for its q-heads,
    # are summed too
    from repro_torch.distributed import collectives

    kv_split = cfg.n_kv_heads % collectives.model_axis()[0] == 0
    xc = collectives.copy_to_model(x)
    q = layers.dense(p["wq"], xc).reshape(b, s, hq, hd)
    rope = use_rope and xkv is None
    if rope:
        q = layers.apply_rope(q, cos, sin)
    if cache is not None and cache_pos is None and cache_positions is None:
        k = v = None                  # read-only: the cache is the K/V below
    else:
        src = x if xkv is None else xkv
        if kv_split:
            src = xc if xkv is None else collectives.copy_to_model(xkv)
        k = layers.dense(p["wk"], src).reshape(b, src.shape[1], hkv, hd)
        v = layers.dense(p["wv"], src).reshape(b, src.shape[1], hkv, hd)
        if not kv_split:
            k, v = collectives.copy_to_model(k), collectives.copy_to_model(v)
        if rope:
            k = layers.apply_rope(k, cos, sin)

    if cache_positions is not None:
        assert cache is not None and s == 1
        assert ring_valid is None, "ring caches are not slot-addressable"
        qg = _regroup(q[:, 0], lay)
        if page_table is not None:
            # Paged ragged decode: scatter this token's K/V through the
            # table (free slots' rows point at the trash page), attend
            # through the page-gathering op.
            ps = cache["k"].shape[1]
            t_logical = page_table.shape[1] * ps
            wpos = torch.clamp(cache_positions.long(), max=t_logical - 1)
            pg = page_table.long().gather(1, (wpos // ps)[:, None])[:, 0]
            off = wpos % ps
            if "k_scale" in cache:
                _write_int8_rows(cache, k[:, 0], v[:, 0], pg, off)
            else:
                cache["k"][pg, off] = k[:, 0].to(cache["k"].dtype)
                cache["v"][pg, off] = v[:, 0].to(cache["v"].dtype)
            kk = cache["k"].narrow(2, lay.kv0, lay.nkv)
            vv = cache["v"].narrow(2, lay.kv0, lay.nkv)
            ks, vs = cache.get("k_scale"), cache.get("v_scale")
            if ks is not None and ks.ndim == 3:
                ks = ks.narrow(2, lay.kv0, lay.nkv)
                vs = vs.narrow(2, lay.kv0, lay.nkv)
            o = kernel_ops.decode_attention_paged(
                qg, kk, vv, page_table, wpos + 1, scale=hd ** -0.5,
                window=window, k_scale=ks, v_scale=vs, policy=policy)
        else:
            # strip cache [B, T, Hkv, hd]: read in place through a
            # transposed view [B, Hkv, T, hd]
            wpos = torch.clamp(cache_positions.long(),
                               max=cache["k"].shape[1] - 1)
            rows = torch.arange(b, device=x.device)
            cache["k"][rows, wpos] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, wpos] = v[:, 0].to(cache["v"].dtype)
            kk = cache["k"].transpose(1, 2).narrow(1, lay.kv0, lay.nkv)
            vv = cache["v"].transpose(1, 2).narrow(1, lay.kv0, lay.nkv)
            o = kernel_ops.decode_attention(
                qg, kk, vv, wpos + 1, scale=hd ** -0.5, window=window,
                policy=policy)
        return (layers.dense_row(p["wo"], _ungroup(o, lay)[:, None]),
                cache)

    kv_len = None
    qpos = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]            # [B, Smax, Hkv, hd]
        if cache_pos is not None:
            ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
            kv_len = cache_pos + s
            qpos = torch.arange(s, device=x.device) + cache_pos
        k, v = ck, cv
    if ring_valid is not None:
        kv_len, qpos, causal, window = ring_valid, None, False, None

    kk, vv = k.transpose(1, 2), v.transpose(1, 2)
    if grouped:
        qg = q.reshape(b, s, hkv, lay.g, hd).permute(0, 2, 3, 1, 4)
    else:                                  # KV expanded per q-head
        kk, vv = kk[:, lay.h2k], vv[:, lay.h2k]
        qg = q.transpose(1, 2)[:, :, None]  # [B, Hq, 1, S, hd]
    o = attention_core(qg, kk, vv, causal=causal and xkv is None,
                       window=window, scale=hd ** -0.5, kv_len=kv_len,
                       qpos=qpos, cfg=cfg)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, hq * hd)
    return layers.dense_row(p["wo"], o), cache


def _write_int8_rows(cache: dict, k, v, pg, off) -> None:
    """This token's K/V rows ``[B, Hkv, hd]`` into an int8 arena layer at
    ``[pg, off]``: each row quantized by its own absmax (per row at
    "page" granularity, a ``[P, ps]`` sidecar; per row and KV head at
    "page_head", ``[P, ps, Hkv]``), its scale written beside it, as the
    reference's row write (``kv_cache.quantize_symmetric``'s order of
    operations).  In-place writes only, no host sync: the captured decode
    step runs it."""
    from repro_torch.serving import kv_cache   # serving imports models

    per_head = cache["k_scale"].ndim == 3
    for n, row in (("k", k), ("v", v)):
        codes, scale = kv_cache.quantize_symmetric(
            row, (2,) if per_head else (1, 2))
        cache[n][pg, off] = codes
        cache[n + "_scale"][pg, off] = (scale[..., 0] if per_head
                                        else scale[:, 0, 0])


def cross_attention_paged(p: dict, x: torch.Tensor, *, cfg: ModelConfig,
                          tp: int = 1, kv: dict, cross_table,
                          cross_lengths):
    """Ragged READ-ONLY cross-attention over paged encoder K/V (the encdec
    continuous-batching decode).  x: [B, 1, d], one decoder query a slot.
    ``kv`` is one layer's page arenas (``{"k", "v"}: [P, ps, Hkv, hd]``),
    the same arenas self-attention pages into; ``cross_table`` ([B,
    Pmax_x] int32) and ``cross_lengths`` ([B] int32, the slot's encoder
    frames) address the slot's encoder pages.  Nothing is written: the
    cross pages were filled at admission, and the paged decode op's
    length-prefix mask is exactly the cross mask (every frame visible, no
    causality).  No RoPE, no window.  A slot of length 0 (free, or parked
    mid-encode) reads exact zeros."""
    b, s, _ = x.shape
    assert s == 1
    hd = cfg.resolved_head_dim()
    lay = local_layout(cfg, tp, x.device)
    q = _regroup(layers.dense(p["wq"], x).reshape(b, lay.hq, hd), lay)
    o = kernel_ops.decode_attention_paged(
        q, kv["k"].narrow(2, lay.kv0, lay.nkv),
        kv["v"].narrow(2, lay.kv0, lay.nkv), cross_table, cross_lengths,
        scale=hd ** -0.5, window=None, policy=cfg.softmax_policy())
    return layers.dense_row(p["wo"], _ungroup(o, lay)[:, None])


# ---------------------------------------------------------------------------
# MLA: DeepSeek-V2 multi-head latent attention (compressed KV cache).
# ---------------------------------------------------------------------------
def init_mla(gen, cfg: ModelConfig, dtype, lead: tuple = ()) -> dict:
    """The reference's leaves: ``wq`` (every head's nope and rope query),
    ``wkv_a`` (the down-projection to the latent ``c`` and the head-shared
    rope key), ``kv_norm`` (over ``c``), ``wkv_b`` (the up-projection of
    ``c`` to every head's nope key and value) and ``wo``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.padded_heads(1)
    nd, rd, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    return {
        "wq": layers.init_dense(gen, d, h * (nd + rd), dtype, lead=lead),
        "wkv_a": layers.init_dense(gen, d, m.kv_lora_rank + rd, dtype,
                                   lead=lead),
        "kv_norm": layers.init_rmsnorm(m.kv_lora_rank, dtype, gen.device,
                                       lead),
        "wkv_b": layers.init_dense(gen, m.kv_lora_rank, h * (nd + vd), dtype,
                                   lead=lead),
        "wo": layers.init_dense(gen, h * vd, d, dtype, lead=lead),
    }


def _expand_latent(p, cc, ckr, h, nd, vd):
    """Every head's key ``[B, H, T, nd + rd]`` (the up-projected nope part,
    then the shared rope key) and value ``[B, H, T, vd]`` from the latent
    ``cc`` ``[B, T, rank]`` and rope key ``ckr`` ``[B, T, rd]``, as
    transposed views whose last axis is contiguous."""
    b, t, _ = cc.shape
    kv = layers.dense(p["wkv_b"], cc).reshape(b, t, h, nd + vd)
    kf = torch.cat([kv[..., :nd],
                    ckr[:, :, None, :].expand(b, t, h, ckr.shape[-1])], -1)
    return kf.transpose(1, 2), kv[..., nd:].transpose(1, 2)


def mla_attention(p: dict, x: torch.Tensor, cos, sin, *, cfg: ModelConfig,
                  cache: dict | None = None, cache_pos=None,
                  cache_positions=None, page_table=None):
    """MLA forward, x: [B, S, d].  The cache holds only the latent ``c``
    (``kv_lora_rank`` wide, after ``kv_norm``) and the head-shared rope
    key ``kr``; every read re-expands them through ``wkv_b`` into per-head
    keys of ``nd + rd`` columns and values of ``vd``, as the reference
    does (no weight absorption).  The scale is ``(nd + rd) ** -0.5``.

    * no cache: causal self-attention through :func:`attention_core` (the
      flash kernels, D ``nd + rd`` and Dv ``vd``, with kernels on);
    * ``cache`` + ``cache_pos`` (int): write ``(c, kr)`` at the fill, then
      attend the whole cache up to ``cache_pos + S`` (prefill, lockstep
      decode); ``cache`` alone: read it whole;
    * ``cache_positions`` ([B], S == 1): ragged decode.  Each slot writes
      its row at its own position, then its latent is up-projected and
      ``decode_attention`` (G 1) reads it.  With ``page_table`` the leaves
      are arenas ``[P, ps, ...]``: the row is scattered through the table
      and the slot-contiguous latent gathered back before the
      up-projection.

    The cache is written in place.  Returns (out, cache)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.padded_heads(1)
    nd, rd, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    scale = (nd + rd) ** -0.5

    q = layers.dense(p["wq"], x).reshape(b, s, h, nd + rd)
    qf = torch.cat([q[..., :nd], layers.apply_rope(q[..., nd:], cos, sin)],
                   -1)
    a = layers.dense(p["wkv_a"], x)
    c = layers.rmsnorm(p["kv_norm"], a[..., :m.kv_lora_rank],
                       eps=cfg.norm_eps)
    kr = layers.apply_rope(a[..., m.kv_lora_rank:][:, :, None, :], cos,
                           sin)[:, :, 0, :]           # [B, S, rd]

    if cache_positions is not None:
        assert cache is not None and s == 1
        cl, kl = cache["c"], cache["kr"]
        if page_table is not None:
            ps = cl.shape[1]
            t_logical = page_table.shape[1] * ps
            wpos = torch.clamp(cache_positions.long(), max=t_logical - 1)
            pt = page_table.long()
            pg = pt.gather(1, (wpos // ps)[:, None])[:, 0]
            off = wpos % ps
            cl[pg, off] = c[:, 0].to(cl.dtype)
            kl[pg, off] = kr[:, 0].to(kl.dtype)
            cc = cl[pt].reshape(b, t_logical, -1)
            ckr = kl[pt].reshape(b, t_logical, -1)
        else:
            wpos = torch.clamp(cache_positions.long(), max=cl.shape[1] - 1)
            rows = torch.arange(b, device=x.device)
            cl[rows, wpos] = c[:, 0].to(cl.dtype)
            kl[rows, wpos] = kr[:, 0].to(kl.dtype)
            cc, ckr = cl, kl
        kk, vv = _expand_latent(p, cc, ckr, h, nd, vd)
        o = kernel_ops.decode_attention(
            qf[:, 0][:, :, None], kk, vv, wpos + 1, scale=scale,
            policy=cfg.softmax_policy())
        return layers.dense(p["wo"], o.reshape(b, 1, h * vd)), cache

    kv_len = qpos = None
    if cache is not None:
        cc, ckr = cache["c"], cache["kr"]         # [B, Smax, ...]
        if cache_pos is not None:
            cc[:, cache_pos:cache_pos + s] = c.to(cc.dtype)
            ckr[:, cache_pos:cache_pos + s] = kr.to(ckr.dtype)
            kv_len = cache_pos + s
            qpos = torch.arange(s, device=x.device) + cache_pos
        c, kr = cc, ckr
    kk, vv = _expand_latent(p, c, kr, h, nd, vd)
    o = attention_core(qf.permute(0, 2, 1, 3)[:, :, None], kk, vv,
                       causal=True, window=None, scale=scale, kv_len=kv_len,
                       qpos=qpos, cfg=cfg)            # [B, H, 1, S, vd]
    o = o[:, :, 0].transpose(1, 2).reshape(b, s, h * vd)
    return layers.dense(p["wo"], o), cache
