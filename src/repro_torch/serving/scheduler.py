"""Continuous-batching request scheduler over a fixed pool of cache slots.

Decode is one query token per sequence against its whole KV cache --
memory-bound at any realistic batch -- so throughput comes from keeping the
batch axis full.  The scheduler:

  * keeps a fixed pool of ``slots`` cache slots, PAGED by default
    (``kv_cache.init_paged_pool``: a shared arena of pages plus a per-slot
    page table, so capacity is bounded by tokens in flight), or the strip
    pool with ``paged=False``;
  * admits a request by prefilling it into a free slot; paged admission
    also needs ``ceil(prompt / page_size)`` free pages;
  * BUCKETS prompt lengths (multiples of the page size, doubling up to
    ``max_len``); logits are read at the true last token and the pad tail
    is hidden by the pool's length mask.  Only families whose prefill is
    position-local bucket by default: an ssm or hybrid prompt's pad tail
    would run through the recurrence into the state decode goes on from;
  * advances every occupied slot with one ragged decode step per
    iteration, whatever its age;
  * allocates decode-time pages just before each burst; when pages run
    out the latest-admitted request is PREEMPTED (pages recycled, request
    requeued with prompt = original prompt + tokens so far), and a lone
    request that cannot grow retires as ``"oom_pages"``;
  * frees slots on max-tokens / EOS / cache-full and backfills them from
    the queue between bursts;
  * for the encdec family (paged only), reserves a request's self and
    cross pages in one allocation, encodes its frames whole or one
    ``enc_chunk`` window a scheduler step (the slot parked meanwhile),
    then prefills the decoder prompt and adopts both halves, the cross
    K/V as read-only pages of the same arenas.

Host state (who owns which slot and pages, emitted tokens) stays in Python;
device state (arenas, page table, lengths) is the pool, changed in place.
The decode step reads its tokens and active mask from static buffers and
writes the sampled tokens back in place; on the card it is captured once in
a CUDA graph and replayed (``serving/fused.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.serving import engine, kv_cache
from repro_torch.serving.fused import FusedStep, graph_for


# families whose prefill is position-local: a pad tail past the true prompt
# cannot influence earlier positions, so it stays invisible behind the
# length mask and prompts can be bucketed (the reference's set; ssm and
# hybrid carry state through prefill, moe sizes expert capacity from the
# padded length)
_BUCKETABLE_FAMILIES = ("dense", "vlm", "encdec")


def _unported(what: str, item: int):
    return NotImplementedError(
        f"ContinuousBatchingEngine({what}) is not ported yet "
        f"(ROADMAP queue A item {item})")


@dataclass
class Request:
    """One generation request.  ``resumed`` marks a requeue after a page
    preemption (prompt = original prompt + tokens generated before).
    ``frames`` (encdec only) are the encoder's frame embeddings [T_enc,
    d_model]; they go with the request through a preemption, so that its
    readmission encodes them again."""
    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int = 32
    arrival_s: float = 0.0             # offset from ``run()`` start
    resumed: bool = False
    frames: np.ndarray | None = None   # encdec: [T_enc, d_model]

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")


@dataclass
class Completion:
    """A finished request: its tokens and timeline.  ``reason``:
    ``"max_tokens"``, ``"eos"``, ``"cache_full"`` or ``"oom_pages"``.
    ``seq`` is the admission order (preemption evicts the highest)."""
    rid: int
    slot: int
    prompt_len: int
    max_new_tokens: int
    tokens: list[int] = field(default_factory=list)
    admitted_s: float = 0.0
    finished_s: float = 0.0
    reason: str = ""
    seq: int = 0
    ttft_s: float | None = None


class ContinuousBatchingEngine:
    """Slot-based continuous batching for one model + parameter set on one
    device.  ``slots`` is given, or derived from ``memory_budget_bytes``
    (strip pool: slots that fit; paged pool: the budget buys pages and the
    slot count fits ``avg_tokens_hint`` tokens per request).

    The decode step -- ``engine.decode_step_ragged`` and ``sample_token``
    over the static buffers ``_tokens`` / ``_active`` -- is FUSED on the
    card: captured once in a CUDA graph when the engine is built, before
    any admission, and replayed ``runahead`` times a burst, greedy and at
    ``temperature > 0`` alike (the generator is registered with the
    graph).  The graph keeps what the step read at capture: the
    temperature and config for the engine's life, and the tensors of
    :meth:`step_buffers`, which are written in place and checked before
    each burst.  A capture that fails raises.  ``fused=False`` keeps the
    step eager on the card: the oracle the graph is held against, as
    ``jax.disable_jit`` is the reference's.  On the CPU the step is
    always eager.

    moe: ``moe_impl`` routes the prefills and the decode step (the
    graph keeps the one it captured); prompts are not bucketed under
    "auto", since expert capacity comes from the prompt's length.

    encdec (paged only): ``max_cross_len`` bounds a request's encoder
    frames (default ``max_len``) and sizes its cross table; ``enc_chunk``
    encodes a request ``enc_chunk`` frames a scheduler step, each window
    alone with its positions from 0 (the reference's streaming windows;
    None encodes the whole request at admission)."""

    def __init__(self, model, params, *, slots: int | None = None,
                 max_len: int = 256, temperature: float = 1.0,
                 eos_token: int | None = None, seed: int = 0,
                 memory_budget_bytes: int | None = None,
                 paged: bool | str = "auto", page_size: int | None = None,
                 pages: int | None = None, prefill_buckets="auto",
                 avg_tokens_hint: int | None = None,
                 prefix_cache: bool | str = "auto", mesh=None,
                 page_dtype: str | None = None,
                 host_swap_bytes: int | None = None, fused: bool = True,
                 max_cross_len: int | None = None,
                 enc_chunk: int | None = None, moe_impl: str = "dispatch"):
        cfg = model.cfg
        if prefix_cache is True:
            if cfg.family == "moe" and moe_impl != "dense":
                # as the reference: capacity dispatch sizes the expert
                # queues from the whole prompt, so a prefix and its tail
                # compete for capacity and a split prompt drops others
                raise ValueError(
                    f"prefix_cache=True: family 'moe' (moe_impl "
                    f"{moe_impl!r}) cannot share prefixes: capacity "
                    "dispatch couples tokens across the sequence; use "
                    "prefix_cache='auto'")
            raise _unported("prefix_cache=True", 17)
        if page_dtype is not None:
            raise _unported("page_dtype", 18)
        if host_swap_bytes is not None:
            raise _unported("host_swap_bytes", 18)
        if mesh is not None:
            raise _unported("mesh", 22)
        if paged == "auto":
            paged = kv_cache.supports_paging(cfg)
        self.encdec = cfg.family == "encdec"
        if self.encdec and not paged:
            raise ValueError(
                "encdec serving needs the paged pool: the encoder's cross "
                "K/V lives in read-only arena pages (cross_table); the "
                "strip pool has nowhere to put it")
        if enc_chunk is not None and not self.encdec:
            raise ValueError("enc_chunk only applies to the encdec family")
        self.paged = bool(paged)
        self.moe_impl = moe_impl
        self.max_len = int(max_len)
        self.max_cross_len = int(max_cross_len or max_len)
        self.enc_chunk = int(enc_chunk) if enc_chunk else None
        self.page_size = (kv_cache.resolve_page_size(cfg, max_len, page_size)
                          if self.paged else None)
        if slots is None:
            if memory_budget_bytes is None:
                raise ValueError("pass slots= or memory_budget_bytes=")
            if self.paged:
                slots, pages = kv_cache.paged_dims_in_budget(
                    cfg, max_len, memory_budget_bytes,
                    page_size=self.page_size,
                    avg_tokens=avg_tokens_hint or max(1, max_len // 2))
                if slots < 1 or pages < 2:
                    raise ValueError(
                        f"memory budget {memory_budget_bytes} fits no usable "
                        f"paged pool at max_len {max_len}")
            else:
                slots = kv_cache.max_slots_in_budget(cfg, max_len,
                                                     memory_budget_bytes)
                if slots < 1:
                    raise ValueError(
                        f"memory budget {memory_budget_bytes} fits 0 slots "
                        f"of max_len {max_len}")
        self.model = model
        self.cfg = cfg
        self.params = params
        self.device = model.device
        self.n_slots = int(slots)
        self.temperature = temperature
        self.eos_token = eos_token
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        if self.paged:
            self.pages_per_slot = kv_cache.pages_per_slot(self.max_len,
                                                          self.page_size)
            self.cross_pages_per_slot = (
                kv_cache.pages_per_slot(self.max_cross_len, self.page_size)
                if self.encdec else 0)
            if pages is None:
                pages = 1 + self.n_slots * (self.pages_per_slot
                                            + self.cross_pages_per_slot)
            # an encdec pool's cross_table / cross_lengths exist from here
            # on, before the capture, and are only written in place
            self.pool = kv_cache.init_paged_pool(
                cfg, self.n_slots, self.max_len, page_size=self.page_size,
                pages=int(pages),
                cross_len=self.max_cross_len if self.encdec else None,
                device=self.device)
            self.allocator = kv_cache.PageAllocator(int(pages))
            self.slot_pages: list[list[int]] = [[] for _ in
                                                range(self.n_slots)]
            self.slot_cross_pages: list[list[int]] = [[] for _ in
                                                      range(self.n_slots)]
        else:
            self.pool = kv_cache.init_slot_pool(cfg, self.n_slots,
                                                self.max_len,
                                                device=self.device)
        self.buckets = self._resolve_buckets(prefill_buckets)
        self._prefill_shapes: set[tuple] = set()

        self.slot_owner: list[Completion | None] = [None] * self.n_slots
        self.slot_req: list[Request | None] = [None] * self.n_slots
        self.next_tok = np.zeros((self.n_slots,), np.int64)
        self.pending: list[Request] = []
        self.completions: list[Completion] = []
        # encdec chunked admission: slot -> its encode in flight (pages
        # reserved, windows still to run); the slot is neither free nor
        # active until the last window lands
        self._encoding: dict[int, dict] = {}
        self._carried: dict[int, tuple[int, list[int], float | None]] = {}
        self._admit_seq = 0
        self._run_start: float | None = None
        # prefill_tokens counts an encdec request's frames and prompt, as
        # the reference; encode_frames / encode_s are the encoder's share
        self.stats = dict(prefill_tokens=0, prefill_s=0.0, decode_tokens=0,
                          decode_s=0.0, steps=0, admitted=0, preempted=0,
                          peak_pages=0, encode_frames=0, encode_s=0.0)

        # The decode step's static buffers: written in place each burst,
        # never rebound (a captured graph reads them).  ``_history`` keeps
        # a burst's sampled tokens on the device until it ends.
        dev = self.device
        self._tokens = torch.zeros((self.n_slots,), dtype=torch.int64,
                                   device=dev)
        self._active = torch.zeros((self.n_slots,), dtype=torch.bool,
                                   device=dev)
        self._history = torch.zeros((self.max_len, self.n_slots),
                                    dtype=torch.int64, device=dev)
        self._fused = None
        graph = graph_for(dev, self.generator) if fused else None
        if graph is not None:
            # every slot is free: the warm-up steps write nothing that a
            # slot will read
            self._fused = FusedStep(self._decode, graph, self.step_buffers())

    # -- device steps ---------------------------------------------------------
    def _sample(self, logits):
        return engine.sample_token(logits, self.generator, self.temperature,
                                   cfg=self.cfg, vocab=self.cfg.vocab)

    def _decode(self) -> None:
        """One decode step over the static buffers: ``_tokens`` of the
        ``_active`` slots in, their sampled tokens written back into
        ``_tokens``."""
        logits, _ = engine.decode_step_ragged(
            self.params, self.pool, self._tokens, cfg=self.cfg,
            moe_impl=self.moe_impl, active=self._active)
        self._tokens.copy_(self._sample(logits))

    def step_buffers(self) -> dict:
        """Every tensor the decode step reads or writes that outlives it:
        the parameters, the pool and the static step buffers."""
        return {"params": self.params, "pool": self.pool,
                "tokens": self._tokens, "active": self._active}

    def _row(self, row: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(row).to(self.device)

    # -- prefill buckets -------------------------------------------------------
    def _resolve_buckets(self, prefill_buckets):
        """Padded prompt lengths.  None = exact lengths (a family outside
        ``_BUCKETABLE_FAMILIES`` under "auto", or an explicit opt-out)."""
        if prefill_buckets is None or prefill_buckets is False:
            return None
        if prefill_buckets == "auto":
            if self.cfg.family not in _BUCKETABLE_FAMILIES:
                return None
            base = self.page_size or kv_cache.resolve_page_size(
                self.cfg, self.max_len)
            bs, b = [], base
            while b < self.max_len:
                bs.append(b)
                b *= 2
            bs.append(self.max_len)
            return tuple(sorted(set(bs)))
        bs = tuple(sorted(int(b) for b in prefill_buckets))
        if not bs or bs[-1] < self.max_len:
            raise ValueError("prefill_buckets must cover max_len "
                             f"(got {bs}, max_len {self.max_len})")
        return bs

    def _bucket_for(self, plen: int) -> int:
        if self.buckets is None:
            return plen
        return next(b for b in self.buckets if b >= plen)

    # -- request intake --------------------------------------------------------
    def _check_frames(self, req: Request) -> int:
        """An encdec request's frame count; raises for missing frames or
        more than ``max_cross_len``."""
        if req.frames is None:
            raise ValueError(f"request {req.rid}: encdec requests need "
                             "frames")
        t_enc = int(req.frames.shape[0])
        if t_enc > self.max_cross_len:
            raise ValueError(
                f"request {req.rid}: {t_enc} encoder frames exceed "
                f"max_cross_len {self.max_cross_len}")
        return t_enc

    def submit(self, req: Request) -> None:
        """Queue ``req``; requests that can never be served are rejected."""
        plen = len(req.prompt)
        if plen + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {plen} + {req.max_new_tokens} "
                f"new tokens exceeds max_len {self.max_len}")
        need = self._pages_for(plen) if self.paged else 0
        if self.encdec:
            need += self._pages_for(self._check_frames(req))
        if self.paged and need > self.allocator.usable_pages:
            raise ValueError(
                f"request {req.rid}: prompt {plen} needs {need} pages; the "
                f"pool has {self.allocator.usable_pages} (page_size "
                f"{self.page_size})")
        self.pending.append(req)
        self.pending.sort(key=lambda r: r.arrival_s)

    def free_slots(self) -> list[int]:
        """Slots with no owner; a slot parked mid-encode is reserved."""
        return [i for i, o in enumerate(self.slot_owner)
                if o is None and i not in self._encoding]

    def active_slots(self) -> list[int]:
        return [i for i, o in enumerate(self.slot_owner) if o is not None]

    # -- paged bookkeeping -----------------------------------------------------
    def _pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def _page_row(self, slot: int) -> np.ndarray:
        row = np.full((self.pages_per_slot,), kv_cache.TRASH_PAGE, np.int32)
        ids = self.slot_pages[slot]
        row[:len(ids)] = ids
        return row

    def _cross_row(self, slot: int) -> np.ndarray:
        """The slot's cross-table row (encdec): its cross pages, then the
        trash page."""
        row = np.full((self.cross_pages_per_slot,), kv_cache.TRASH_PAGE,
                      np.int32)
        ids = self.slot_cross_pages[slot]
        row[:len(ids)] = ids
        return row

    def _note_peak(self) -> None:
        used = self.allocator.usable_pages - self.allocator.free_pages
        self.stats["peak_pages"] = max(self.stats["peak_pages"], used)

    def _release_slot(self, slot: int) -> None:
        self.slot_owner[slot] = None
        self.slot_req[slot] = None
        if self.paged:
            # reset the table row first: a freed page may be handed out in
            # this same iteration
            kv_cache.free_slot_paged(self.pool, slot)
            self.allocator.free(self.slot_pages[slot])
            self.slot_pages[slot] = []
            if self.encdec:
                self.allocator.free(self.slot_cross_pages[slot])
                self.slot_cross_pages[slot] = []
        else:
            kv_cache.free_slot(self.pool, slot)

    # -- admission -------------------------------------------------------------
    def _admit(self, req: Request, slot: int, now: float) -> bool:
        """Prefill ``req`` into ``slot``; False (nothing consumed) when the
        page pool cannot back the prompt right now."""
        if self.encdec:
            return self._admit_encdec(req, slot, now)
        plen = len(req.prompt)
        bucket = self._bucket_for(plen)
        page_ids = None
        if self.paged:
            need = self._pages_for(plen)
            if need > self.allocator.usable_pages:
                if req.resumed:
                    # a preempted request regrew past the pool: retire it
                    # with what it generated
                    self._finalize_oom(req, now)
                    return True
                raise ValueError(
                    f"request {req.rid}: prompt {plen} needs {need} pages; "
                    f"the pool has {self.allocator.usable_pages}")
            page_ids = self.allocator.alloc(need)
            if page_ids is None:
                return False
        t0 = time.perf_counter()
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :plen] = torch.tensor(req.prompt)
        # Prefill attends over the bucket's positions and no more, for
        # either pool: keys past the bucket would all be masked.  (The
        # reference prefills max_len positions for the strip pool and whole
        # pages for the paged one.)
        logits, cache = engine.prefill(
            self.params, padded.to(self.device), cfg=self.cfg,
            max_len=bucket, last_pos=plen - 1, moe_impl=self.moe_impl)
        tok_dev = self._sample(logits)
        self._prefill_shapes.add(bucket)
        if self.paged:
            self.slot_pages[slot] = page_ids
            kv_cache.adopt_slot_paged(self.pool, cache, slot, plen,
                                      self._row(self._page_row(slot)))
            self._note_peak()
        else:
            kv_cache.adopt_slot(self.pool, cache, slot, plen)
        self._seat(req, slot, tok_dev, plen, now, now, t0)
        return True

    def _seat(self, req: Request, slot: int, tok_dev, tokens: int,
              admitted_s: float, now: float, t0: float) -> None:
        """Give ``slot`` to ``req`` after its prefill: wait for its first
        token, count ``tokens`` prefilled since ``t0``, retire it if one
        token was all it wanted."""
        tok = int(tok_dev[0])                # waits for the device
        t1 = time.perf_counter()
        self.stats["prefill_s"] += t1 - t0
        self.stats["prefill_tokens"] += tokens
        self.stats["admitted"] += 1
        self._admit_seq += 1
        comp = Completion(rid=req.rid, slot=slot, prompt_len=len(req.prompt),
                          max_new_tokens=req.max_new_tokens,
                          admitted_s=admitted_s, seq=self._admit_seq)
        comp.ttft_s = (max(0.0, t1 - self._run_start - req.arrival_s)
                       if self._run_start is not None else t1 - t0)
        self.slot_owner[slot] = comp
        self.slot_req[slot] = req
        comp.tokens.append(tok)
        self.next_tok[slot] = tok
        self._maybe_retire(slot, now)        # max_new_tokens == 1

    # -- encdec admission --------------------------------------------------------
    def _admit_encdec(self, req: Request, slot: int, now: float) -> bool:
        """Reserve the request's self and cross pages in one all-or-nothing
        allocation, then encode its frames: whole (and finish now), or one
        ``enc_chunk`` window a scheduler step with the slot parked in
        ``_encoding`` while other requests go on admitting."""
        plen = len(req.prompt)
        t_enc = self._check_frames(req)
        need = self._pages_for(plen) + self._pages_for(t_enc)
        if need > self.allocator.usable_pages:
            if req.resumed:
                self._finalize_oom(req, now)
                return True
            raise ValueError(
                f"request {req.rid}: prompt {plen} + {t_enc} frames need "
                f"{need} pages; the pool has {self.allocator.usable_pages} "
                f"(page_size {self.page_size})")
        page_ids = self.allocator.alloc(need)
        if page_ids is None:
            return False
        n_self = self._pages_for(plen)
        self.slot_pages[slot] = page_ids[:n_self]
        self.slot_cross_pages[slot] = page_ids[n_self:]
        ent = dict(req=req, parts=[], off=0, admit_s=now)
        if self.enc_chunk is None:
            enc = self._encode(req.frames)
            self._finish_encdec(slot, ent, enc, now)
        else:
            self._encoding[slot] = ent
        return True

    def _encode(self, frames: np.ndarray) -> torch.Tensor:
        """Encode frames [T, d] as one window: [1, T, d] on the device."""
        t0 = time.perf_counter()
        enc = transformer.encode(
            self.params, torch.from_numpy(np.asarray(frames))[None].to(
                self.device), cfg=self.cfg)
        engine.sync(self.device)
        dt = time.perf_counter() - t0
        self.stats["encode_s"] += dt
        self.stats["prefill_s"] += dt
        self.stats["encode_frames"] += int(frames.shape[0])
        return enc

    def _advance_encoding(self, now: float) -> None:
        """Encode one ``enc_chunk`` window of every parked slot (once a
        scheduler step, between admission and the decode burst).  Each
        window is encoded alone, its positions from 0; the windows are
        joined on the position axis when the last one lands."""
        for slot in list(self._encoding):
            ent = self._encoding[slot]
            frames = ent["req"].frames
            end = min(int(frames.shape[0]), ent["off"] + self.enc_chunk)
            ent["parts"].append(self._encode(frames[ent["off"]:end]))
            ent["off"] = end
            if end >= frames.shape[0]:
                del self._encoding[slot]
                self._finish_encdec(slot, ent, torch.cat(ent["parts"], 1),
                                    now)

    def _finish_encdec(self, slot: int, ent: dict, enc, now: float) -> None:
        """The decoder prompt's prefill against the encoded frames (self
        K/V written, cross K/V projected once), both halves adopted into
        the arenas through their tables, the first token sampled."""
        req = ent["req"]
        plen = len(req.prompt)
        t_enc = int(req.frames.shape[0])
        bucket = self._bucket_for(plen)
        t0 = time.perf_counter()
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :plen] = torch.tensor(req.prompt)
        logits, cache = engine.prefill_with_encoder(
            self.params, enc, padded.to(self.device), cfg=self.cfg,
            max_len=bucket, last_pos=plen - 1)
        tok_dev = self._sample(logits)
        self._prefill_shapes.add(bucket)
        kv_cache.adopt_slot_encdec(
            self.pool, cache, slot, plen, self._row(self._page_row(slot)),
            t_enc, self._row(self._cross_row(slot)))
        self._note_peak()
        self._seat(req, slot, tok_dev, plen + t_enc, ent["admit_s"], now, t0)

    def _admit_arrived(self, now: float) -> None:
        free = self.free_slots()
        while free and self.pending and self.pending[0].arrival_s <= now:
            if not self._admit(self.pending[0], free[0], now):
                break                        # no pages: wait for retirements
            self.pending.pop(0)
            free = self.free_slots()

    # -- retirement ------------------------------------------------------------
    def _merge_carried(self, comp: Completion) -> None:
        """Fold tokens generated before a preemption back in."""
        if comp.rid in self._carried:
            orig_plen, prior, ttft = self._carried.pop(comp.rid)
            comp.tokens = prior + comp.tokens
            comp.max_new_tokens += len(prior)
            comp.prompt_len = orig_plen
            if ttft is not None:
                comp.ttft_s = ttft

    def _maybe_retire(self, slot: int, now: float) -> None:
        comp = self.slot_owner[slot]
        reason = None
        if self.eos_token is not None and comp.tokens[-1] == self.eos_token:
            reason = "eos"
        elif len(comp.tokens) >= comp.max_new_tokens:
            reason = "max_tokens"
        elif comp.prompt_len + len(comp.tokens) >= self.max_len:
            reason = "cache_full"
        if reason is not None:
            comp.finished_s = now
            comp.reason = reason
            self._merge_carried(comp)
            self.completions.append(comp)
            self._release_slot(slot)

    # -- paged preemption ------------------------------------------------------
    def _finalize_oom(self, req: Request, now: float) -> None:
        orig_plen, prior, ttft = self._carried.pop(
            req.rid, (len(req.prompt), [], None))
        self.completions.append(Completion(
            rid=req.rid, slot=-1, prompt_len=orig_plen,
            max_new_tokens=len(prior) + req.max_new_tokens, tokens=prior,
            finished_s=now, reason="oom_pages", ttft_s=ttft))

    def _preempt(self, slot: int, now: float) -> None:
        """Evict ``slot``: requeue its request with prompt = original prompt
        + tokens so far (recomputed on readmission)."""
        comp = self.slot_owner[slot]
        req = self.slot_req[slot]
        orig_plen, prior, ttft = self._carried.get(
            comp.rid, (comp.prompt_len, [], comp.ttft_s))
        self._carried[comp.rid] = (orig_plen, prior + comp.tokens, ttft)
        remaining = comp.max_new_tokens - len(comp.tokens)
        self.pending.insert(0, Request(
            rid=comp.rid, prompt=tuple(req.prompt) + tuple(comp.tokens),
            max_new_tokens=max(1, remaining), arrival_s=0.0, resumed=True,
            frames=req.frames))
        self._release_slot(slot)
        self.stats["preempted"] += 1

    def _pick_victim(self) -> int:
        """Latest-admitted active slot (least sunk work to recompute)."""
        return max((self.slot_owner[s].seq, s)
                   for s in self.active_slots())[1]

    def _ensure_pages(self, runahead: int, now: float) -> int:
        """Back every active slot's next ``h <= runahead`` write positions
        with pages.  Shrinks the horizon first, then preempts the latest
        admitted slot; a lone slot that cannot grow retires as
        ``"oom_pages"``.  Returns the horizon (0 = nothing left active)."""
        while True:
            active = self.active_slots()
            if not active:
                return 0

            def extra(slot: int, h: int) -> int:
                comp = self.slot_owner[slot]
                dev_len = comp.prompt_len + len(comp.tokens) - 1
                target = min(dev_len + h, self.max_len)
                return max(0, self._pages_for(target)
                           - len(self.slot_pages[slot]))

            h = max(1, runahead)
            while h > 1 and (sum(extra(s, h) for s in active)
                             > self.allocator.free_pages):
                h -= 1
            if sum(extra(s, h) for s in active) <= self.allocator.free_pages:
                for s in active:
                    n = extra(s, h)
                    if n:
                        self.slot_pages[s].extend(self.allocator.alloc(n))
                        kv_cache.set_page_row(self.pool, s,
                                              self._row(self._page_row(s)))
                self._note_peak()
                return h
            if len(active) == 1:
                comp = self.slot_owner[active[0]]
                comp.finished_s = now
                comp.reason = "oom_pages"
                self._merge_carried(comp)
                self.completions.append(comp)
                self._release_slot(active[0])
                return 0
            self._preempt(self._pick_victim(), now)

    # -- one scheduler iteration ------------------------------------------------
    def _runahead(self, comps: list[Completion]) -> int:
        """Decode steps that can run back to back without a host decision:
        until the first budget or cache expiry when there is no EOS token
        and no request waiting for a free slot."""
        if self.eos_token is not None:
            return 1
        if self.pending and self.free_slots():
            return 1
        if self._encoding:
            return 1                     # chunked encodes advance a step
        rem = min(c.max_new_tokens - len(c.tokens) for c in comps)
        head = min(self.max_len - (c.prompt_len + len(c.tokens))
                   for c in comps)
        return max(1, min(rem, head))

    def step(self, now: float | None = None) -> bool:
        """Admit arrived requests, then run one ragged decode burst over the
        occupied slots.  Returns False when idle."""
        if now is None:
            now = 0.0
        self._admit_arrived(now)
        if self._encoding:
            self._advance_encoding(now)
        active = self.active_slots()
        if not active:
            return bool(self._encoding)
        runahead = self._runahead([self.slot_owner[s] for s in active])
        if self.paged:
            runahead = self._ensure_pages(runahead, now)
            active = self.active_slots()
            if not active:
                return bool(self.pending)
        mask = np.zeros((self.n_slots,), bool)
        mask[active] = True
        self._active.copy_(torch.from_numpy(mask))
        self._tokens.copy_(torch.from_numpy(self.next_tok))
        decode = self._decode
        if self._fused is not None:
            self._fused.check(self.step_buffers())
            decode = self._fused
        t0 = time.perf_counter()
        for i in range(runahead):
            decode()
            self._history[i].copy_(self._tokens)
        harvested = self._history[:runahead].cpu().numpy()   # waits once
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_tokens"] += len(active) * runahead
        self.stats["steps"] += runahead
        for row in harvested:                            # [runahead, slots]
            for slot in active:
                self.slot_owner[slot].tokens.append(int(row[slot]))
        for slot in active:
            self.next_tok[slot] = self.slot_owner[slot].tokens[-1]
            self._maybe_retire(slot, now)
        return True

    def run(self, requests=None, *,
            use_wall_clock: bool | None = None) -> list[Completion]:
        """Serve ``requests`` (plus anything submitted) to completion.
        Arrival times are honoured against the wall clock when any request
        has ``arrival_s > 0``; otherwise everything is offered at t=0."""
        for req in requests or ():
            self.submit(req)
        if use_wall_clock is None:
            use_wall_clock = any(r.arrival_s > 0 for r in self.pending)
        if not use_wall_clock:
            for req in self.pending:
                req.arrival_s = 0.0
        start = time.perf_counter()
        self._run_start = start
        while self.pending or self.active_slots() or self._encoding:
            now = (time.perf_counter() - start) if use_wall_clock else 0.0
            progressed = self.step(now=now)
            if not progressed and self.pending:
                wait = self.pending[0].arrival_s - now
                if use_wall_clock and wait > 0:
                    time.sleep(min(wait, 0.05))
        self.completions.sort(key=lambda c: c.rid)
        return self.completions

    def reset_stats(self) -> None:
        """Zero the counters and completions (keeps the pool)."""
        for k in self.stats:
            self.stats[k] = 0.0 if isinstance(self.stats[k], float) else 0
        self.completions = []

    def throughput(self) -> dict:
        """Phase-separated throughput: prefill vs decode tokens/s."""
        st = self.stats
        wall = st["prefill_s"] + st["decode_s"]
        out = dict(
            prefill_tok_s=(st["prefill_tokens"] / st["prefill_s"]
                           if st["prefill_s"] else 0.0),
            decode_tok_s=(st["decode_tokens"] / st["decode_s"]
                          if st["decode_s"] else 0.0),
            requests_s=(len(self.completions) / wall if wall else 0.0),
            slots=self.n_slots, steps=st["steps"], admitted=st["admitted"],
            prefill_tokens=st["prefill_tokens"],
            decode_tokens=st["decode_tokens"], wall_s=wall,
            paged=self.paged, prefill_shapes=len(self._prefill_shapes),
            fused=self._fused is not None)
        if self._fused is not None:
            out.update(self._fused.info())
        if self.encdec:
            # the prefill's two parts apart: the encoder over the frames,
            # the decoder over the prompt tokens
            prompt = st["prefill_tokens"] - st["encode_frames"]
            dec_s = st["prefill_s"] - st["encode_s"]
            out.update(encode_frames=st["encode_frames"],
                       encode_s=st["encode_s"],
                       encode_frames_s=(st["encode_frames"] / st["encode_s"]
                                        if st["encode_s"] else 0.0),
                       prompt_tokens=prompt,
                       prompt_tok_s=prompt / dec_s if dec_s > 0 else 0.0)
        if self.paged:
            out.update(page_size=self.page_size,
                       pages=self.allocator.usable_pages,
                       peak_pages=st["peak_pages"],
                       preempted=st["preempted"])
        return out
