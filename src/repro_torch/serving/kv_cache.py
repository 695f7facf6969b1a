"""Cache construction for every family: the lockstep cache, the
continuous-batching strip pool and the PAGED pool.

Cache leaves are stacked on a leading layer axis ``[L, ...]``.  The
functions that change a pool change it IN PLACE and return it (the
reference is functional): at full width a pool is tens of gigabytes, and a
copy per admission or step would double it.

  * lockstep cache (:func:`init_cache`): ``ring=True`` sizes an SWA
    config's cache at its window, and decode addresses it ``pos % window``
    (every written slot holds an in-window position, RoPE baked in at the
    write, so a read needs only a validity bound); ``ring=False`` is
    position-addressed at ``max_len``, which prefill and the pools use.
  * strip pool (:func:`init_slot_pool`): ``max_len`` positions per slot plus
    per-slot ``lengths`` (0 = free; also the next write position).
  * paged pool (:func:`init_paged_pool`): a shared arena of ``ps``-token
    pages plus a per-slot page table.  Arena page 0 is the TRASH page:
    free slots' rows and entries past a slot's pages point at it, so the
    writes inactive slots still issue land where nothing is read.  The
    flat k/v families' arenas may be int8 with float32 scale sidecars
    (``page_dtype="int8"``); a demoted slot's pages wait in host RAM
    (:class:`HostSwapStore`) until :func:`restore_slot_paged` scatters
    them back.

An ssm (RWKV6) cache is the recurrent state, with no position axis:
``{"wkv": float32 [L, B, H, hd, hd], "last_t", "last_c": [L, B, d]}`` in
the compute dtype.  It rides the strip pool, one state a slot, and cannot
page.  An encdec (whisper) lockstep cache is ``{"self", "cross"}``; its
paged pool keeps the encoder's cross K/V as read-only pages of the same
arenas, addressed by a second table.  A multi-head latent attention
(deepseek) cache is the latent ``{"c": [L, B, T, kv_lora_rank], "kr": [L,
B, T, qk_rope_head_dim]}``, paged as arenas ``[L, P, ps, ...]`` like any
position-addressed leaf: admission, page copies and freeing need no branch
of their own.  A hybrid (hymba) cache is ``{"attn": {"k", "v"}, "ssm":
float32 [L, B, H, state_size, head_dim]}``: its paged pool pages the
attention half as arenas and keeps the ssm state slot-major ``[L, slots,
...]``, one state a slot, as the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import torch_dtype

TRASH_PAGE = 0


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """Cache storage dtype: the model's compute dtype (an ssm state's
    ``wkv`` is the exception: it accumulates in float32)."""
    return torch_dtype(cfg.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               ring: bool = True, mesh=None, device="cuda") -> dict:
    """Stacked-layer lockstep cache ``{"k", "v"}: [L, B, T, Hkv, hd]``.
    ``T`` is ``max_len``, or ``min(max_len, swa_window)`` for an SWA config
    with ``ring`` (the ring that ``engine.decode_step`` addresses mod
    ``T``); prefill paths pass ``ring=False`` for position addressing.  An
    ssm config's cache is its state, whatever ``max_len``.  An encdec
    config's is ``{"self": {"k", "v"}, "cross": {"k", "v"}}``, an MLA
    config's the latent ``{"c", "kr"}``, a hybrid config's ``{"attn":
    {"k", "v"}, "ssm"}`` (the ring applies to the attention half).
    Under ``mesh`` (default: the active one) the cache holds this rank's
    KV heads (:func:`local_kv_heads`)."""
    dt = cache_dtype(cfg)
    if cfg.family == "ssm":
        h, hd, d = cfg.n_heads, cfg.ssm.head_dim, cfg.d_model
        ls = cfg.n_layers
        return {"wkv": torch.zeros((ls, batch, h, hd, hd),
                                   dtype=torch.float32, device=device),
                "last_t": torch.zeros((ls, batch, d), dtype=dt,
                                      device=device),
                "last_c": torch.zeros((ls, batch, d), dtype=dt,
                                      device=device)}
    if cfg.mla is not None:
        return _latent(cfg, batch, max_len, dt, device)
    alloc = max_len
    if ring and cfg.swa_window is not None:
        alloc = min(max_len, cfg.swa_window)
    shape = (cfg.n_layers, batch, alloc, local_kv_heads(cfg, mesh),
             cfg.resolved_head_dim())

    def kv():
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    if cfg.family == "encdec":
        # the cross half is a placeholder of max_len positions, as the
        # reference's: the prefill replaces it with T_enc positions
        return {"self": kv(), "cross": kv()}
    if cfg.family == "hybrid":
        return {"attn": kv(), "ssm": _ssm_state(cfg, batch, device)}
    return kv()


def local_kv_heads(cfg: ModelConfig, mesh=None) -> int:
    """The KV heads a rank's caches and arenas hold under ``mesh`` (default:
    the active one): ``n_kv_heads / tp`` where the model axis splits them
    (``sharding.kv_shard_factor``), all of them otherwise.  Every cache and
    pool is allocated at this count, so a rank never holds the whole
    arena (the reference's ``shard_pool`` places a whole one)."""
    from repro_torch.distributed import autoshard, sharding

    mesh = mesh if mesh is not None else autoshard.active_mesh()
    if mesh is None:
        return cfg.n_kv_heads
    return cfg.n_kv_heads // sharding.kv_shard_factor(cfg, mesh)


def _ssm_state(cfg: ModelConfig, n: int, device) -> torch.Tensor:
    """A hybrid model's float32 mamba state ``[L, n, H, state_size,
    head_dim]`` (``n`` lockstep rows or pool slots)."""
    return torch.zeros((cfg.n_layers, n, cfg.d_model // cfg.ssm.head_dim,
                        cfg.ssm.state_size, cfg.ssm.head_dim),
                       dtype=torch.float32, device=device)


def _latent(cfg: ModelConfig, n: int, t: int, dt, device) -> dict:
    """MLA's latent leaves ``[L, n, t, ...]`` (slots x positions, or arena
    pages x page size)."""
    m, ls = cfg.mla, cfg.n_layers
    return {"c": torch.zeros((ls, n, t, m.kv_lora_rank), dtype=dt,
                             device=device),
            "kr": torch.zeros((ls, n, t, m.qk_rope_head_dim), dtype=dt,
                              device=device)}


# ---------------------------------------------------------------------------
# Strip pool.
# ---------------------------------------------------------------------------
def init_slot_pool(cfg: ModelConfig, slots: int, max_len: int, *,
                   mesh=None, device="cuda") -> dict:
    """``{"kv": init_cache(slots, max_len), "lengths": int32[slots]}``,
    the cache at this rank's KV heads under ``mesh`` (default: the active
    one)."""
    return {"kv": init_cache(cfg, slots, max_len, ring=False, mesh=mesh,
                             device=device),
            "lengths": torch.zeros((slots,), dtype=torch.int32,
                                   device=device)}


def _adopt_strip(dst: dict, src: dict, slot: int) -> None:
    for n, d in dst.items():
        if isinstance(d, dict):
            _adopt_strip(d, src[n], slot)
        else:
            s = src[n][:, 0]
            d[:, slot, :s.shape[1]] = s.to(d.dtype)


def adopt_slot(pool: dict, cache: dict, slot: int, length: int) -> dict:
    """Copy a batch=1 prefill cache of at most ``max_len`` positions into
    the head of ``slot``'s strip; rows past it keep stale values, hidden by
    the length mask until overwritten.  Every leaf is written in place; an
    ssm state's leaves (and a hybrid cache's ``ssm``) have no position
    axis, so the slice is all of them and replaces the dead state a free
    slot's steps left there."""
    _adopt_strip(pool["kv"], cache, slot)
    pool["lengths"][slot] = length
    return pool


def free_slot(pool: dict, slot: int) -> dict:
    """Mark ``slot`` free; its rows are hidden by the length mask."""
    pool["lengths"][slot] = 0
    return pool


# ---------------------------------------------------------------------------
# Paged pool.
# ---------------------------------------------------------------------------
def supports_paging(cfg: ModelConfig) -> bool:
    """Position-addressed caches page; an ssm state has no position axis
    and stays on the strip pool."""
    return cfg.family != "ssm"


def resolve_page_size(cfg: ModelConfig, max_len: int,
                      page_size: int | None = None, device=None) -> int:
    """Tokens per page, resolved through the registry's ``kv_page`` spec:
    explicit ``page_size`` > the autotune cache (when the config's policy
    opts in; keyed by ``cache_dtype(cfg)`` and the backend of ``device``)
    > the 128-token heuristic, shrunk to the pool's length for tiny
    pools."""
    if page_size is not None:
        return int(page_size)
    from repro_torch.kernels import registry

    pol = cfg.softmax_policy()
    _, ps = registry.block_shapes(
        "kv_page", 1, max_len, cache_dtype(cfg), use_cache=pol.autotune,
        backend=registry.backend_of(device), cache_file=pol.autotune_cache)
    return int(ps)


def resolve_page_quant(cfg: ModelConfig, max_len: int,
                       page_size: int | None = None,
                       scale_granularity: str | None = None, device=None
                       ) -> tuple[int, str]:
    """``(page_size, scale_granularity)`` of an int8 pool, through the
    registry's ``kv_page_quant`` spec: its cols are the tokens per page
    (as ``kv_page``'s), its rows the granularity (1 row: one scale a
    stored position, "page"; more: one a position and KV head,
    "page_head").  Explicit arguments win per axis; else the policy's
    autotune cache (keyed by int8 and the backend of ``device``; a tuned
    row count is clamped to ``n_kv_heads``); else the heuristic (128-token
    pages, "page" scales)."""
    if page_size is not None and scale_granularity is not None:
        _check_granularity(scale_granularity)
        return int(page_size), scale_granularity
    from repro_torch.kernels import registry

    pol = cfg.softmax_policy()
    gr, ps = registry.block_shapes(
        "kv_page_quant", cfg.n_kv_heads, max_len, torch.int8,
        use_cache=pol.autotune, backend=registry.backend_of(device),
        cache_file=pol.autotune_cache)
    if page_size is not None:
        ps = page_size
    if scale_granularity is None:
        scale_granularity = "page_head" if gr > 1 else "page"
    _check_granularity(scale_granularity)
    return int(ps), scale_granularity


def _check_granularity(granularity: str) -> None:
    if granularity not in ("page", "page_head"):
        raise ValueError(f"unknown scale granularity {granularity!r}; "
                         "expected 'page' or 'page_head'")


def pages_per_slot(max_len: int, page_size: int) -> int:
    return -(-int(max_len) // int(page_size))


def supports_page_quant(cfg: ModelConfig) -> bool:
    """Families whose paged pool can hold int8 pages: the flat ``k``/``v``
    arenas (dense, moe, vlm).  MLA's latent pages, hybrid (slot-major ssm
    state beside its pages) and encdec (cross pages written once, read
    every step) keep the compute dtype, as the reference's."""
    return (supports_paging(cfg) and cfg.mla is None
            and cfg.family not in ("hybrid", "encdec"))


def init_paged_pool(cfg: ModelConfig, slots: int, max_len: int, *,
                    page_size: int | None = None, pages: int | None = None,
                    cross_len: int | None = None,
                    page_dtype: str | None = None,
                    scale_granularity: str | None = None,
                    mesh=None, device="cuda") -> dict:
    """``{"kv": {"k", "v"}: [L, pages, ps, Hkv, hd], "page_table":
    int32[slots, pages_per_slot], "lengths": int32[slots]}``.  ``pages``
    defaults to full provisioning (``1 + slots * pages_per_slot``, page 0
    the trash page); fewer oversubscribe the arena.  An MLA pool's arenas
    are the latent ``{"c", "kr"}: [L, pages, ps, ...]``.

    An encdec pool has two tables over the one arena: the encoder's
    cross K/V has self K/V's leaf shape a position, so its pages live in
    the same arenas (one allocator), addressed by ``cross_table
    int32[slots, ceil(cross_len / ps)]`` and ``cross_lengths
    int32[slots]`` (``cross_len`` defaults to ``max_len``; the default
    ``pages`` covers both tables).  Cross pages are written once at
    admission and only read after.  A hybrid pool's ``kv`` is ``{"attn":
    {"k", "v"} arenas, "ssm": [L, slots, H, state_size, head_dim]}``.

    ``page_dtype="int8"`` (:func:`supports_page_quant` families) makes
    ``k``/``v`` symmetric-absmax int8 arenas with float32 sidecars
    ``k_scale``/``v_scale``: ``[L, pages, ps]`` ("page" granularity) or
    ``[L, pages, ps, Hkv]`` ("page_head").  A scale is stored for every
    POSITION even at "page" granularity: adoption broadcasts a page's
    absmax over its positions, and a decode write quantizes its own row
    with its own scale, so no page is ever requantized.  The sidecars
    exist from construction and are written in place (the captured
    decode step reads them).

    Under ``mesh`` (default: the active one) ``Hkv`` is this rank's
    (:func:`local_kv_heads`); the tables stay whole on every rank."""
    if not supports_paging(cfg):
        raise ValueError(f"family {cfg.family!r}: the recurrent state has "
                         "no position axis to page; use the strip pool")
    if page_dtype not in (None, "int8"):
        raise ValueError(f"unknown page_dtype {page_dtype!r}; "
                         "expected None or 'int8'")
    quant = page_dtype == "int8"
    if quant and not supports_page_quant(cfg):
        raise ValueError(f"family {cfg.family!r} (mla={cfg.mla is not None})"
                         " has no int8 page path: quantized pages need the"
                         " flat k/v arenas (dense / moe / vlm)")
    if quant:
        ps, gran = resolve_page_quant(cfg, max_len, page_size,
                                      scale_granularity, device)
    else:
        ps = resolve_page_size(cfg, max_len, page_size, device)
    n_tab = pages_per_slot(max_len, ps)
    encdec = cfg.family == "encdec"
    n_xtab = pages_per_slot(cross_len or max_len, ps) if encdec else 0
    if pages is None:
        pages = 1 + slots * (n_tab + n_xtab)
    shape = (cfg.n_layers, pages, ps, local_kv_heads(cfg, mesh),
             cfg.resolved_head_dim())
    dt = cache_dtype(cfg)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    if cfg.mla is not None:
        kv = _latent(cfg, pages, ps, dt, device)
    elif quant:
        sshape = shape[:3] if gran == "page" else shape[:4]
        kv = {n: torch.zeros(shape, dtype=torch.int8, device=device)
              for n in ("k", "v")}
        kv.update({n: torch.zeros(sshape, dtype=torch.float32,
                                  device=device)
                   for n in ("k_scale", "v_scale")})
    else:
        kv = {"k": torch.zeros(shape, dtype=dt, device=device),
              "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.family == "hybrid":
        kv = {"attn": kv, "ssm": _ssm_state(cfg, slots, device)}
    pool = {"kv": kv, "page_table": i32(slots, n_tab),
            "lengths": i32(slots)}
    if encdec:
        pool["cross_table"] = i32(slots, n_xtab)
        pool["cross_lengths"] = i32(slots)
    return pool


def quantize_symmetric(x: torch.Tensor, axes):
    """Symmetric absmax int8 of ``x``, one scale an element of the dims
    not in ``axes``: ``scale = absmax / 127`` (1 where the absmax is 0, so
    zeros round-trip exactly), ``q = round(clip(x / scale, -127, 127))``,
    rounding half to even.  The reference's order of operations, so that
    equal inputs give equal codes.  Returns ``(q int8, scale float32 with
    ``axes`` kept as size-1 dims)``."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=tuple(axes), keepdim=True)
    scale = torch.where(amax > 0.0, amax / 127.0, 1.0)
    q = torch.round(torch.clamp(xf / scale, -127.0, 127.0)).to(torch.int8)
    return q, scale


def dequantize_pages(kv: dict, dtype) -> dict:
    """``{"k", "v", "k_scale", "v_scale"}`` int8 leaves (arena or gathered
    shape; the scales trail the values by 2 dims at "page" granularity, by
    1 at "page_head") back to ``{"k", "v"}`` in ``dtype``."""
    out = {}
    for n in ("k", "v"):
        s = kv[n + "_scale"]
        s = s[..., None, None] if s.ndim == kv[n].ndim - 2 else s[..., None]
        out[n] = (kv[n].to(torch.float32) * s).to(dtype)
    return out


def _src_pages(src, ps: int, width: int):
    """A batch=1 position-major cache ``[L, 1, T, ...]`` as whole pages
    ``[L, n, ps, ...]``, ``n = min(ceil(T / ps), width)``: a ragged last
    page is zero-filled past T, source pages past ``width`` dropped."""
    ls = src.shape[0]
    n_copy = min(-(-src.shape[2] // ps), width)
    src = src[:, 0, :n_copy * ps]
    tail = n_copy * ps - src.shape[1]
    if tail:
        src = torch.cat([src, src.new_zeros((ls, tail, *src.shape[2:]))], 1)
    return src.reshape(ls, n_copy, ps, *src.shape[2:])


def _copy_pages(dst, src, page_row):
    """Scatter a batch=1 position-major cache ``[L, 1, T, ...]`` into arena
    pages ``[L, P, ps, ...]`` at ``page_row``'s ids.  A ragged last page is
    zero-filled past T; source pages past the row are dropped, and row
    entries past the allocated pages are the trash page (garbage over
    garbage)."""
    srcp = _src_pages(src, dst.shape[2], page_row.shape[0])
    dst[:, page_row[:srcp.shape[1]].long()] = srcp.to(dst.dtype)


def _copy_pages_quant(dst, scale_dst, src, page_row):
    """Quantizing :func:`_copy_pages`: scatter a compute-dtype cache into an
    int8 arena and its float32 sidecar.  The absmax is taken per page
    ("page", a 3-D sidecar) or per page and KV head ("page_head", 4-D)
    and broadcast over the page's positions.  The zero rows past T move
    no absmax: the reference's cache holds zeros there too (it allocates
    whole pages and writes the bucket's positions)."""
    srcp = _src_pages(src, dst.shape[2], page_row.shape[0])
    ls, n, ps = srcp.shape[:3]
    per_head = scale_dst.ndim == 4
    q, scale = quantize_symmetric(srcp, (2, 4) if per_head else (2, 3, 4))
    if per_head:                                  # [ls, n, 1, H, 1]
        srows = scale[..., 0].expand(ls, n, ps, srcp.shape[3])
    else:                                         # [ls, n, 1, 1, 1]
        srows = scale[:, :, :, 0, 0].expand(ls, n, ps)
    idx = page_row[:n].long()
    dst[:, idx] = q
    scale_dst[:, idx] = srows


def adopt_slot_paged(pool: dict, cache: dict, slot: int, length: int,
                     page_row: torch.Tensor,
                     copy_row: torch.Tensor | None = None) -> dict:
    """Admit a batch=1 prefill cache into ``slot``: copy its pages to the
    row's arena pages, set the table row and the length.  A hybrid
    cache's attention half pages so; its ssm state is copied into the
    slot's row of the slot-major state, replacing the dead state a free
    slot's steps left there.

    ``copy_row`` (default ``page_row``) says where the cache's pages are
    WRITTEN, apart from what the table row names: the copy-on-write seam
    of prefix sharing.  A prefix hit's table row names the shared pages
    and then the fresh ones; its copy row names only the fresh ones, with
    the trash page in the shared positions, so a shared page is never
    written.  This holds for every paged leaf (``{k, v}``, MLA's latent
    ``{c, kr}``).  An int8 pool quantizes the cache's pages as it copies
    them (:func:`_copy_pages_quant`): a copied page takes its codes and
    its scales together."""
    kv = pool["kv"]
    if copy_row is None:
        copy_row = page_row
    if "ssm" in kv:
        kv["ssm"][:, slot] = cache["ssm"][:, 0]
        kv, cache = kv["attn"], cache["attn"]
    if "k_scale" in kv:
        for n in ("k", "v"):
            _copy_pages_quant(kv[n], kv[n + "_scale"], cache[n], copy_row)
    else:
        for n, dst in kv.items():
            _copy_pages(dst, cache[n], copy_row)
    pool["page_table"][slot] = page_row.to(torch.int32)
    pool["lengths"][slot] = length
    return pool


def adopt_slot_encdec(pool: dict, cache: dict, slot: int, length: int,
                      page_row: torch.Tensor, cross_len: int,
                      cross_row: torch.Tensor) -> dict:
    """Admit a batch=1 encdec prefill cache (``{"self", "cross"}``) into
    ``slot``: the decoder's self K/V goes through ``page_row`` as
    :func:`adopt_slot_paged`'s, the encoder's cross K/V through
    ``cross_row`` into the same arenas, its tail page zero-padded and
    hidden behind ``cross_lengths``.  The cross pages are never written
    again.  Every tensor is written in place (a captured decode step reads
    the tables)."""
    for n, dst in pool["kv"].items():
        _copy_pages(dst, cache["self"][n], page_row)
        _copy_pages(dst, cache["cross"][n], cross_row)
    pool["page_table"][slot] = page_row.to(torch.int32)
    pool["lengths"][slot] = length
    pool["cross_table"][slot] = cross_row.to(torch.int32)
    pool["cross_lengths"][slot] = cross_len
    return pool


def free_slot_paged(pool: dict, slot: int) -> dict:
    """Mark ``slot`` free: length 0 and the table row reset to the trash
    page, so its dead writes cannot land in a page handed to someone
    else.  An encdec pool's cross row and length are reset too: the cross
    pages are only read, but a stale row must not alias pages handed
    out again.  A hybrid pool's ssm row is left as it is, as the
    reference's: the free slot's steps go on writing dead state there,
    which the next admission replaces."""
    pool["page_table"][slot] = TRASH_PAGE
    pool["lengths"][slot] = 0
    if "cross_table" in pool:
        pool["cross_table"][slot] = TRASH_PAGE
        pool["cross_lengths"][slot] = 0
    return pool


def set_page_row(pool: dict, slot: int, page_row: torch.Tensor) -> dict:
    """Update one slot's table row (page growth before a decode burst).
    Entries past the slot's pages must be the trash page."""
    pool["page_table"][slot] = page_row.to(torch.int32)
    return pool


def gather_slot(pool: dict, page_row: torch.Tensor) -> dict:
    """A slot's pages as they lie in the arenas, page-major ``[L,
    len(page_row), ps, ...]`` for every leaf (int8 codes and float32
    scales as stored), gathered on the pool's device.  ``page_row`` is the
    slot's whole table row, the trash page as padding: one shape for
    every length, as the reference's demotion gathers."""
    idx = page_row.to(pool["lengths"].device).long()
    return {n: leaf[:, idx] for n, leaf in pool["kv"].items()}


def restore_slot_paged(pool: dict, blob: dict, slot: int, length: int,
                       page_row: torch.Tensor,
                       copy_row: torch.Tensor | None = None) -> dict:
    """Re-admit a demoted slot from its host blob (the swap tier's
    promotion): every leaf of ``blob`` (page-major ``[L, pages_per_slot,
    ps, ...]``, as :func:`gather_slot` took it) is scattered through
    ``copy_row`` (default ``page_row``), whose trash entries send the
    padding back to the trash page.  A copy of the demoted bytes in their
    own dtype (int8 codes and float32 scales included), so demotion and
    promotion are bit-lossless, where preemption recomputes the prefix.
    Written in place: a captured decode step reads the restored pages at
    its next replay."""
    if copy_row is None:
        copy_row = page_row
    dev = pool["lengths"].device
    idx = copy_row.to(dev).long()
    for n, leaf in pool["kv"].items():
        leaf[:, idx] = blob[n].to(device=dev, dtype=leaf.dtype)
    pool["page_table"][slot] = page_row.to(torch.int32)
    pool["lengths"][slot] = length
    return pool


class HostSwapStore:
    """Host RAM for demoted slots' pages (the swap tier's cold side),
    keyed by request id.  A blob is a dict of CPU tensors (pinned where
    the pages came from the card), the exact bytes of the arenas' leaves,
    scale sidecars included.  ``budget_bytes`` caps the store (None:
    unbounded); :meth:`put` refuses a blob over it, and a request id
    already stored, and the scheduler then preempts instead."""

    def __init__(self, budget_bytes: int | None = None):
        self.budget_bytes = budget_bytes
        self.bytes_used = 0
        self._blobs: dict[int, dict] = {}

    def __len__(self) -> int:
        return len(self._blobs)

    def __contains__(self, rid: int) -> bool:
        return rid in self._blobs

    @staticmethod
    def blob_bytes(blob: dict) -> int:
        return sum(x.numel() * x.element_size() for x in blob.values())

    def fits(self, nbytes: int) -> bool:
        return (self.budget_bytes is None
                or self.bytes_used + nbytes <= self.budget_bytes)

    def put(self, rid: int, blob: dict) -> bool:
        """Store ``rid``'s pages; False (nothing stored) if over budget or
        already stored."""
        nbytes = self.blob_bytes(blob)
        if rid in self._blobs or not self.fits(nbytes):
            return False
        self._blobs[rid] = blob
        self.bytes_used += nbytes
        return True

    def pop(self, rid: int) -> dict:
        blob = self._blobs.pop(rid)
        self.bytes_used -= self.blob_bytes(blob)
        return blob


class PageAllocator:
    """Host-side refcounted free list over arena pages ``1 .. pages - 1``
    (page 0 is the trash page and is never handed out).  A page starts at
    refcount 1; :meth:`share` adds a reader and :meth:`free` drops one; a
    page returns to the free list at refcount 0.  A free past zero is a
    double free and raises."""

    def __init__(self, pages: int):
        self.n_pages = int(pages)
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._refs = [0] * self.n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    def refcount(self, page_id: int) -> int:
        return self._refs[page_id]

    def alloc(self, n: int) -> list[int] | None:
        """``n`` distinct pages at refcount 1, or None (nothing taken)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def _check(self, p: int, what: str) -> None:
        if not 0 < p < self.n_pages:
            raise ValueError(f"bad page id {p}")
        if self._refs[p] <= 0:
            raise ValueError(f"{what} of free page {p}")

    def share(self, page_ids) -> None:
        for p in page_ids:
            self._check(p, "share")
            self._refs[p] += 1

    def free(self, page_ids) -> None:
        for p in page_ids:
            self._check(p, "double free")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)


# ---------------------------------------------------------------------------
# Memory accounting, from shapes on the meta device (nothing allocated).
# Inside an active mesh each counts a rank's share (:func:`local_kv_heads`).
# ---------------------------------------------------------------------------
def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int, *,
                ring: bool = True) -> int:
    """Bytes of a lockstep cache (:func:`init_cache`), at any size."""
    return _nbytes(init_cache(cfg, batch, max_len, ring=ring,
                              device="meta"))


def slot_pool_bytes(cfg: ModelConfig, slots: int, max_len: int) -> int:
    return _nbytes(init_slot_pool(cfg, slots, max_len, device="meta"))


def max_slots_in_budget(cfg: ModelConfig, max_len: int,
                        budget_bytes: int) -> int:
    """Largest slot count whose strip pool fits ``budget_bytes``."""
    one = slot_pool_bytes(cfg, 1, max_len)
    per_slot = max(1, slot_pool_bytes(cfg, 2, max_len) - one)
    return max(0, int((budget_bytes - (one - per_slot)) // per_slot))


def paged_pool_bytes(cfg: ModelConfig, slots: int, max_len: int, *,
                     page_size: int | None = None,
                     pages: int | None = None,
                     page_dtype: str | None = None,
                     scale_granularity: str | None = None) -> int:
    """Bytes of a paged pool: arenas, tables, lengths and, on an int8
    pool, the scale sidecars."""
    return _nbytes(init_paged_pool(cfg, slots, max_len, page_size=page_size,
                                   pages=pages, page_dtype=page_dtype,
                                   scale_granularity=scale_granularity,
                                   device="meta"))


def max_pages_in_budget(cfg: ModelConfig, slots: int, max_len: int,
                        budget_bytes: int, *,
                        page_size: int | None = None,
                        page_dtype: str | None = None,
                        scale_granularity: str | None = None) -> int:
    """Largest arena page count (trash page included) that fits.  An int8
    page and its scale rows cost about half a bf16 page, so the same
    budget buys about twice the pages."""
    kw = dict(page_size=page_size, page_dtype=page_dtype,
              scale_granularity=scale_granularity)
    one = paged_pool_bytes(cfg, slots, max_len, pages=1, **kw)
    per_page = max(1, paged_pool_bytes(cfg, slots, max_len, pages=2, **kw)
                   - one)
    return max(0, int((budget_bytes - (one - per_page)) // per_page))


def paged_dims_in_budget(cfg: ModelConfig, max_len: int, budget_bytes: int,
                         *, page_size: int, avg_tokens: int,
                         page_dtype: str | None = None,
                         scale_granularity: str | None = None
                         ) -> tuple[int, int]:
    """(slots, pages) under ``budget_bytes``: the budget buys pages, and
    the slot count is sized for ``avg_tokens``-token requests."""
    kw = dict(page_size=page_size, page_dtype=page_dtype,
              scale_granularity=scale_granularity)
    slots, pages = 1, 0
    for _ in range(4):
        pages = max_pages_in_budget(cfg, slots, max_len, budget_bytes, **kw)
        if pages < 2:
            break
        new_slots = max(1, ((pages - 1) * page_size) // max(1, avg_tokens))
        if new_slots == slots:
            break
        slots = new_slots
    else:
        pages = max_pages_in_budget(cfg, slots, max_len, budget_bytes, **kw)
    return slots, pages
