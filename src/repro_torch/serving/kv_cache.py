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
    writes inactive slots still issue land where nothing is read.

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

from repro_torch.configs.base import ModelConfig, check_ported
from repro_torch.models.transformer import torch_dtype

TRASH_PAGE = 0


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """Cache storage dtype: the model's compute dtype (an ssm state's
    ``wkv`` is the exception: it accumulates in float32)."""
    return torch_dtype(cfg.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               ring: bool = True, device="cuda") -> dict:
    """Stacked-layer lockstep cache ``{"k", "v"}: [L, B, T, Hkv, hd]``.
    ``T`` is ``max_len``, or ``min(max_len, swa_window)`` for an SWA config
    with ``ring`` (the ring that ``engine.decode_step`` addresses mod
    ``T``); prefill paths pass ``ring=False`` for position addressing.  An
    ssm config's cache is its state, whatever ``max_len``.  An encdec
    config's is ``{"self": {"k", "v"}, "cross": {"k", "v"}}``, an MLA
    config's the latent ``{"c", "kr"}``, a hybrid config's ``{"attn":
    {"k", "v"}, "ssm"}`` (the ring applies to the attention half)."""
    check_ported(cfg, "its cache")
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
    shape = (cfg.n_layers, batch, alloc, cfg.n_kv_heads,
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
                   device="cuda") -> dict:
    return {"kv": init_cache(cfg, slots, max_len, ring=False,
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
                      page_size: int | None = None) -> int:
    """Tokens per page: explicit ``page_size``, else the registry's
    ``kv_page`` heuristic (128, shrunk to the pool's length for tiny
    pools)."""
    if page_size is not None:
        return int(page_size)
    from repro_torch.kernels import registry

    _, ps = registry.block_shapes("kv_page", 1, max_len)
    return int(ps)


def pages_per_slot(max_len: int, page_size: int) -> int:
    return -(-int(max_len) // int(page_size))


def init_paged_pool(cfg: ModelConfig, slots: int, max_len: int, *,
                    page_size: int | None = None, pages: int | None = None,
                    cross_len: int | None = None, device="cuda") -> dict:
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
    {"k", "v"} arenas, "ssm": [L, slots, H, state_size, head_dim]}``."""
    check_ported(cfg, "its cache")
    if not supports_paging(cfg):
        raise ValueError(f"family {cfg.family!r}: the recurrent state has "
                         "no position axis to page; use the strip pool")
    ps = resolve_page_size(cfg, max_len, page_size)
    n_tab = pages_per_slot(max_len, ps)
    encdec = cfg.family == "encdec"
    n_xtab = pages_per_slot(cross_len or max_len, ps) if encdec else 0
    if pages is None:
        pages = 1 + slots * (n_tab + n_xtab)
    shape = (cfg.n_layers, pages, ps, cfg.n_kv_heads,
             cfg.resolved_head_dim())
    dt = cache_dtype(cfg)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    if cfg.mla is not None:
        kv = _latent(cfg, pages, ps, dt, device)
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


def _copy_pages(dst, src, page_row):
    """Scatter a batch=1 position-major cache ``[L, 1, T, ...]`` into arena
    pages ``[L, P, ps, ...]`` at ``page_row``'s ids.  A ragged last page is
    zero-filled past T; source pages past the row are dropped, and row
    entries past the allocated pages are the trash page (garbage over
    garbage)."""
    ls, _, ps = dst.shape[:3]
    n_copy = min(-(-src.shape[2] // ps), page_row.shape[0])
    src = src[:, 0, :n_copy * ps]
    tail = n_copy * ps - src.shape[1]
    if tail:
        src = torch.cat([src, src.new_zeros((ls, tail, *src.shape[2:]))], 1)
    srcp = src.reshape(ls, n_copy, ps, *src.shape[2:])
    dst[:, page_row[:n_copy].long()] = srcp.to(dst.dtype)


def adopt_slot_paged(pool: dict, cache: dict, slot: int, length: int,
                     page_row: torch.Tensor) -> dict:
    """Admit a batch=1 prefill cache into ``slot``: copy its pages to the
    row's arena pages, set the table row and the length.  A hybrid
    cache's attention half pages so; its ssm state is copied into the
    slot's row of the slot-major state, replacing the dead state a free
    slot's steps left there."""
    kv = pool["kv"]
    if "ssm" in kv:
        kv["ssm"][:, slot] = cache["ssm"][:, 0]
        kv, cache = kv["attn"], cache["attn"]
    for n, dst in kv.items():
        _copy_pages(dst, cache[n], page_row)
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
                     pages: int | None = None) -> int:
    return _nbytes(init_paged_pool(cfg, slots, max_len, page_size=page_size,
                                   pages=pages, device="meta"))


def max_pages_in_budget(cfg: ModelConfig, slots: int, max_len: int,
                        budget_bytes: int, *,
                        page_size: int | None = None) -> int:
    """Largest arena page count (trash page included) that fits."""
    one = paged_pool_bytes(cfg, slots, max_len, page_size=page_size, pages=1)
    per_page = max(1, paged_pool_bytes(cfg, slots, max_len,
                                       page_size=page_size, pages=2) - one)
    return max(0, int((budget_bytes - (one - per_page)) // per_page))


def paged_dims_in_budget(cfg: ModelConfig, max_len: int, budget_bytes: int,
                         *, page_size: int,
                         avg_tokens: int) -> tuple[int, int]:
    """(slots, pages) under ``budget_bytes``: the budget buys pages, and
    the slot count is sized for ``avg_tokens``-token requests."""
    slots, pages = 1, 0
    for _ in range(4):
        pages = max_pages_in_budget(cfg, slots, max_len, budget_bytes,
                                    page_size=page_size)
        if pages < 2:
            break
        new_slots = max(1, ((pages - 1) * page_size) // max(1, avg_tokens))
        if new_slots == slots:
            break
        slots = new_slots
    else:
        pages = max_pages_in_budget(cfg, slots, max_len, budget_bytes,
                                    page_size=page_size)
    return slots, pages
