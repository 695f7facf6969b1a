"""Block-shape autotuner: the paper's meta-parameter search, persisted.

The paper tunes its unroll factor and accumulator count per architecture
by timing every choice.  Here the choices are the blocks of
:mod:`repro_torch.kernels.registry`: this module sweeps the candidates of
one op at one problem shape, times each (the median of repeated calls,
each ending in ``torch.cuda.synchronize()`` on the card), and records the
best in the JSON cache that :func:`registry.block_shapes` consults under
``SoftmaxPolicy(autotune=True)``.  Resolution is a dict lookup, so a
CUDA-graph capture reads the tuned blocks at capture time; a cache written
after a capture does not change the captured graph.

Each sweep times what the op's path runs on the device its inputs are on:

  * ``decode_attention`` / ``decode_attention_paged``: kernel 4 / kernel 3
    on the card (only the col block reaches them, so the row block is held
    at the heuristic's there), the plain chunked forms on the CPU;
  * ``kv_page`` / ``kv_page_quant``: kernel 3 over bf16 (or the sweep's
    dtype) / int8 arenas laid out at each candidate's page size (and scale
    granularity), each layout built outside the timed region;
  * ``lmhead_xent``: forward plus backward through autograd (kernels
    9-11 on the card, whose vocab slab is the col block);
  * ``chunk_attention``, ``flash_attention``, ``flash_attention_bwd``: the
    plain forms on any device -- the flash kernels take a fixed tile, so
    their blocks reach only the plain forms' chunk lengths.

``softmax``, ``logsumexp`` and ``xent`` take no tile in the port (one
thread block sweeps a whole row), so they have no spec and no sweep.  A
candidate outside the op's envelope (past the decode kernel's
``MAX_TILE``, not whole pages, more than ``MAX_PAGES_PER_TILE`` pages) is
refused before any launch; nothing else is caught.

    python -m repro_torch.kernels.autotune [--op OP --rows R --cols C]
        [--dtype float32] [--cache FILE] [--device cuda]

Without ``--op`` it runs :data:`DEFAULT_SWEEP`.  The cache defaults to
``$REPRO_TORCH_AUTOTUNE_CACHE`` or ``~/.cache/repro_torch/autotune.json``.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import registry

# Ops the reference tunes that take no tile in the port.
NO_TILE_OPS = {
    op: (f"{op!r} takes no tile in the port: its CUDA kernels give each row "
         "its own thread block and sweep the whole row, so there is no "
         "block to tune")
    for op in ("softmax", "logsumexp", "xent")}

DECODE_OPS = ("decode_attention", "decode_attention_paged")

ATTN_HEAD_DIM = 64       # proxy head dim of the attention sweeps
ATTN_HEADS = 2           # proxy head count
ATTN_PAGE_SIZE = 64      # proxy page size of the paged decode sweep
QUANT_SLOTS = 8          # slots of the page-layout sweeps


@dataclass
class TuneResult:
    op: str
    rows: int
    cols: int
    dtype: str
    best: tuple[int, int]
    best_s: float
    default: tuple[int, int]
    default_s: float
    cache_key: str | None = None
    timings: dict = field(default_factory=dict)   # (br, bc) -> seconds
    refused: dict = field(default_factory=dict)   # (br, bc) -> why

    @property
    def speedup(self) -> float:
        return self.default_s / self.best_s if self.best_s else 1.0


def _ready(out) -> None:
    """Waits for ``out``'s tensors: a synchronize where one is on the card."""
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


def _median_time(fn: Callable, *args, reps: int = 3,
                 min_time_s: float = 0.05) -> float:
    """Median seconds a call, each call waited for; the first call (build
    and warm-up) is not timed."""
    _ready(fn(*args))
    meds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        calls = 0
        while time.perf_counter() - t0 < min_time_s / reps:
            _ready(fn(*args))
            calls += 1
        meds.append((time.perf_counter() - t0) / max(calls, 1))
    meds.sort()
    return meds[len(meds) // 2]


def decode_kernel_path(device) -> bool:
    """Whether a sweep on ``device`` times the CUDA kernels (on the card)
    or the plain forms (elsewhere): each device tunes what its serving
    path runs."""
    return torch.device(device).type == "cuda"


def _logical_cache(slots, hkv, d, cols, dtype, device, gen, *, quant=False):
    """One logical cache ``[slots, T, hkv, d]`` (T = ``cols`` rounded up to
    the largest page a sweep lays out), from which every candidate's
    layout is cut, so that each layout holds the same values.  int8: codes
    with a float32 scale a position (a layout with per-head scales
    repeats it over the heads)."""
    t = registry.round_up(cols, 512)
    if not quant:
        return {n: torch.randn((slots, t, hkv, d), generator=gen).to(
            device, dtype) for n in "kv"}
    out = {n: torch.randint(-127, 128, (slots, t, hkv, d), generator=gen,
                            dtype=torch.int8).to(device) for n in "kv"}
    out.update({f"{n}_scale": (torch.rand((slots, t), generator=gen) * 0.1
                               + 1e-3).to(device) for n in "kv"})
    return out


def _page_layout(cache, cols, ps, *, gran=None):
    """``cache`` (:func:`_logical_cache`) in ``ps``-token pages behind a
    shuffled table: arenas ``[1 + slots * pmax, ps, hkv, d]`` (page 0 the
    trash page) and, for int8, scales ``[P, ps]`` (``gran`` 1) or ``[P,
    ps, hkv]`` (``gran`` > 1).  Returns (k, v, k_scale, v_scale, table)."""
    slots, _, hkv, _ = cache["k"].shape
    pmax = -(-cols // ps)
    perm = np.random.default_rng(0).permutation(np.arange(1, 1 + slots * pmax))
    table = torch.from_numpy(perm.reshape(slots, pmax).astype(np.int32)).to(
        cache["k"].device)

    def paged(x):
        pages = x[:, :pmax * ps].reshape(slots * pmax, ps, *x.shape[2:])
        out = torch.zeros((1 + slots * pmax, *pages.shape[1:]),
                          dtype=x.dtype, device=x.device)
        out[table.reshape(-1).long()] = pages
        return out

    k, v = paged(cache["k"]), paged(cache["v"])
    if gran is None:
        return k, v, None, None, table
    ksc, vsc = (paged(cache[f"{n}_scale"]) for n in "kv")
    if gran > 1:
        ksc, vsc = (x[..., None].expand(-1, -1, hkv).contiguous()
                    for x in (ksc, vsc))
    return k, v, ksc, vsc, table


def _runner_for(op: str) -> Callable:
    """``(inputs, br, bc) -> outputs``: one op at fixed blocks, passed as
    explicit overrides so that the sweep bypasses the cache."""
    from repro_torch.kernels import ops

    if op == "decode_attention":
        def run(args, br, bc):
            q, k, v, lengths = args
            return ops.decode_attention(
                q, k, v, lengths, block_s=br, block_t=bc,
                use_kernel=decode_kernel_path(q.device))
        return run
    if op == "decode_attention_paged":
        # block_t rounds down to whole pages: pages_per_tile on the card
        def run(args, br, bc):
            q, kp, vp, pt, lengths = args
            return ops.decode_attention_paged(
                q, kp, vp, pt, lengths, block_s=br, block_t=bc,
                use_kernel=decode_kernel_path(q.device))
        return run
    if op in ("kv_page", "kv_page_quant"):
        # A candidate is a LAYOUT, not a tile: bc the page size and, for
        # int8, br the scale granularity.  Each layout is built once,
        # outside the timed region; what is timed is the paged decode
        # over it at the registry's own decode tile.
        prepped: dict = {}

        def run(args, br, bc):
            q, lengths, cols, cache = args
            if (br, bc) not in prepped:
                prepped[(br, bc)] = _page_layout(
                    cache, cols, bc,
                    gran=br if op == "kv_page_quant" else None)
            kp, vp, ksc, vsc, pt = prepped[(br, bc)]
            return ops.decode_attention_paged(
                q, kp, vp, pt, lengths, k_scale=ksc, v_scale=vsc,
                use_kernel=decode_kernel_path(q.device))
        return run
    if op == "flash_attention":
        def run(args, br, bc):
            q, k, v = args
            return ops.flash_attention(q, k, v, causal=True, block_q=br,
                                       block_k=bc, impl="twopass")
        return run
    if op == "flash_attention_bwd":
        def run(args, br, bc):
            q, k, v, o, m_sum, n_sum, do = args
            return ops.flash_attention_bwd(q, k, v, o, m_sum, n_sum, do,
                                           causal=True, block_q=br,
                                           block_k=bc, impl="twopass")
        return run
    if op == "lmhead_xent":
        # what the vocab slab trades is the backward's recompute against
        # its scratch, so the timed unit is forward plus backward
        def run(args, br, bc):
            h, w, labels = args
            impl = "cuda" if decode_kernel_path(h.device) else "twopass"
            loss = ops.lmhead_cross_entropy(h, w, labels, block_v=bc,
                                            impl=impl)
            return (loss, *torch.autograd.grad(loss.sum(), (h, w)))
        return run
    if op == "chunk_attention":
        # blocks are chunk LENGTHS; the counts are resolve_chunks' ceil-div
        # and unroll caps
        from repro_torch.models import attention as A

        def run(args, br, bc):
            q, k, v = args
            return A.mn_chunk_attention(
                q, k, v, causal=True, scale=q.shape[-1] ** -0.5,
                n_q_chunks=min(A.MAX_Q_CHUNKS, -(-q.shape[3] // br)),
                n_kv_chunks=min(A.MAX_KV_CHUNKS, -(-k.shape[2] // bc)))
        return run
    if op in NO_TILE_OPS:
        raise ValueError(NO_TILE_OPS[op])
    raise ValueError(f"op {op!r} is not autotunable here "
                     f"(registered: {registry.registered_ops()})")


def _quant_candidates(rows: int, cols: int) -> list[tuple[int, int]]:
    """(scale granularity, page size) layouts of the ``kv_page_quant``
    sweep, as the reference's: rows encode the granularity (1 or per
    head), so the set is spelled out rather than taken from
    ``registry.candidate_blocks``."""
    spec = registry.get_spec("kv_page_quant")
    rcands = [1] + ([min(spec.tune_row_cap, rows)] if rows > 1 else [])
    cmax = max(spec.col_align, -(-cols // spec.col_align) * spec.col_align)
    ccands = [c for c in (16, 32, 64, 128, 256)
              if c <= min(cmax, spec.tune_col_cap)]
    return [(r, c) for r in rcands for c in ccands]


def _page_candidates(cols: int) -> list[tuple[int, int]]:
    """Page sizes of the ``kv_page`` sweep, up to its envelope (512: a page
    longer than the decode kernel's tile, folded in tiles of 256)."""
    spec = registry.get_spec("kv_page")
    cmax = max(spec.col_align, -(-cols // spec.col_align) * spec.col_align)
    return [(1, c) for c in (16, 32, 64, 128, 256, 512)
            if c <= min(cmax, spec.envelope()[1])]


def _candidates(op: str, rows: int, cols: int, x, device):
    if op == "kv_page_quant":
        return _quant_candidates(rows, cols)
    if op == "kv_page":
        return _page_candidates(cols)
    cands = registry.candidate_blocks(op, rows, cols)
    if op == "decode_attention_paged":
        ps = x[1].shape[1]
        cands = [(br, bc) for br, bc in cands if bc % ps == 0]
    if op in DECODE_OPS and decode_kernel_path(device):
        hr = registry.get_spec(op).heuristic_blocks(rows, cols)[0]
        cands = sorted({(hr, bc) for _, bc in cands})
    return cands


def _refusal(op: str, br: int, bc: int, x) -> str | None:
    """Why a candidate may not run (None: it may), decided before any
    launch: off the spec's alignment grid, outside its envelope (the
    decode ops' is the kernel's ``MAX_TILE``), or for the paged op not
    whole pages / more than ``MAX_PAGES_PER_TILE``."""
    spec = registry.get_spec(op)
    er, ec = spec.envelope()
    if br <= 0 or bc <= 0 or br % spec.row_align or bc % spec.col_align:
        return (f"off the ({spec.row_align}, {spec.col_align}) alignment "
                "grid")
    if br > er or bc > ec:
        return f"beyond the envelope ({er}, {ec})"
    if op == "decode_attention_paged":
        ps = x[1].shape[1]
        if bc % ps:
            return f"not whole pages of {ps}"
        if bc // ps > _da.MAX_PAGES_PER_TILE:
            return (f"{bc // ps} pages a tile, past MAX_PAGES_PER_TILE "
                    f"{_da.MAX_PAGES_PER_TILE}")
    return None


def _inputs_for(op: str, rows: int, cols: int, dtype, device):
    """Seeded inputs (a CPU ``torch.Generator``, moved to ``device``) at the
    reference's proxy geometry."""
    gen = torch.Generator().manual_seed(0)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)

    def lengths(n, hi):
        return torch.randint(1, hi + 1, (n,), generator=gen,
                             dtype=torch.int32).to(device)

    d, hkv = ATTN_HEAD_DIM, ATTN_HEADS
    if op in ("kv_page", "kv_page_quant"):
        # kv_page_quant: rows = KV heads; kv_page: the pool's own row.  q
        # is float32 under int8 pages (as the reference's sweep), else of
        # the sweep's dtype; the layouts are cut in the runner from one
        # logical cache.
        quant = op == "kv_page_quant"
        heads = rows if quant else hkv
        qdt = torch.float32 if quant else dtype
        q = (torch.randn((QUANT_SLOTS, heads, 1, d), generator=gen)
             .to(device, qdt))
        return (q, lengths(QUANT_SLOTS, cols), cols,
                _logical_cache(QUANT_SLOTS, heads, d, cols, dtype, device,
                               gen, quant=quant))
    if op == "decode_attention_paged":
        # rows/cols are (slots, logical positions); a fully backed arena
        # behind a shuffled table: the gather is part of what is timed
        ps = ATTN_PAGE_SIZE
        kp, vp, _, _, pt = _page_layout(
            _logical_cache(rows, hkv, d, cols, dtype, device, gen), cols, ps)
        q = normal(rows, hkv, 1, d)
        return (q, kp, vp, pt, lengths(rows, pt.shape[1] * ps))
    if op == "decode_attention":
        # mixed-age slots: random lengths, the masking is part of the time
        q = normal(rows, hkv, 1, d)
        k, v = normal(rows, hkv, cols, d), normal(rows, hkv, cols, d)
        return (q, k, v, lengths(rows, cols))
    if op == "flash_attention":
        return (normal(1, hkv, rows, d), normal(1, hkv, cols, d),
                normal(1, hkv, cols, d))
    if op == "chunk_attention":
        return (normal(1, hkv, 1, rows, d), normal(1, hkv, cols, d),
                normal(1, hkv, cols, d))
    if op == "flash_attention_bwd":
        # the forward's residuals, computed here, outside the timed region
        from repro_torch.kernels import ops

        q, k, v = (normal(1, hkv, rows, d), normal(1, hkv, cols, d),
                   normal(1, hkv, cols, d))
        do = normal(1, hkv, rows, d)
        o, m_sum, n_sum = ops.flash_attention_fwd_stats(q, k, v, causal=True,
                                                        impl="twopass")
        return (q, k, v, o, m_sum, n_sum, do)
    if op == "lmhead_xent":
        # rows/cols are (tokens, vocab); the hidden dim is a proxy
        h = normal(rows, 2 * d).requires_grad_(True)
        w = normal(2 * d, cols, scale=0.1).requires_grad_(True)
        labels = torch.randint(0, cols, (rows,), generator=gen).to(device)
        return (h, w, labels)
    raise ValueError(f"op {op!r} has no sweep inputs")


def autotune_op(op: str, rows: int, cols: int, dtype=torch.float32, *,
                candidates: list[tuple[int, int]] | None = None,
                reps: int = 3, min_time_s: float = 0.05,
                persist: bool = True, cache_file: str | None = None,
                device="cuda", verbose: bool = False) -> TuneResult:
    """Sweeps block candidates for one (op, shape, dtype) on ``device`` (the
    card unless asked otherwise) and persists the best under the key of
    that device's backend.  Returns the whole timing table."""
    run = _runner_for(op)
    spec = registry.get_spec(op)
    device = torch.device(device)
    x = _inputs_for(op, rows, cols, dtype, device)
    cands = list(candidates or _candidates(op, rows, cols, x, device))
    default = spec.heuristic_blocks(rows, cols)
    if default not in cands:
        cands.append(default)

    timings: dict = {}
    refused: dict = {}
    for br, bc in cands:
        why = _refusal(op, br, bc, x)
        if why is not None:
            refused[(br, bc)] = why
            if verbose:
                print(f"  {op} ({br},{bc}): refused, {why}")
            continue
        sec = _median_time(lambda t: run(t, br, bc), x, reps=reps,
                           min_time_s=min_time_s)
        timings[(br, bc)] = sec
        if verbose:
            print(f"  {op} ({br},{bc}): {sec * 1e6:.1f}us")
    if not timings:
        raise ValueError(f"no viable block candidate for {op} ({rows}x"
                         f"{cols}, {registry.dtype_name(dtype)}): {refused}")

    best = min(timings, key=timings.get)
    res = TuneResult(op=op, rows=rows, cols=cols,
                     dtype=registry.dtype_name(dtype), best=best,
                     best_s=timings[best], default=default,
                     default_s=timings.get(default, timings[best]),
                     timings=timings, refused=refused)
    res.cache_key = registry.record_tuned(
        op, rows, cols, dtype, best, backend=registry.backend_of(device),
        path=cache_file, persist=persist,
        meta=dict(best_us=round(timings[best] * 1e6, 2),
                  default_us=round(res.default_s * 1e6, 2),
                  rows=rows, cols=cols))
    return res


DEFAULT_SWEEP = (
    # (op, rows, cols): the reference's sweep without the ops that take no
    # tile here (softmax, xent).  Attention rows/cols are (Sq, Skv).
    ("flash_attention", 128, 256),
    ("chunk_attention", 2048, 2048),
    # serving decode: an 8-slot pool against a 4K cache (rows=slots, cols=T)
    ("decode_attention", 8, 4096),
    # paged serving decode: same pool, KV gathered through the page table
    ("decode_attention_paged", 8, 4096),
    # int8 page layout (rows = kv heads, cols = cache positions)
    ("kv_page_quant", 2, 4096),
    # training backward from saved stats (rows/cols = Sq/Skv)
    ("flash_attention_bwd", 128, 256),
    # fused LM-head CE forward + backward (rows/cols = tokens/vocab)
    ("lmhead_xent", 128, 4096),
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Sweep block shapes on the card and persist the best.")
    p.add_argument("--op", default=None,
                   help="flash_attention|flash_attention_bwd|"
                        "chunk_attention (rows/cols = Sq/Skv)|"
                        "decode_attention|decode_attention_paged "
                        "(rows/cols = slots/Skv)|"
                        "kv_page (cols = positions)|"
                        "kv_page_quant (rows/cols = kv heads/positions; "
                        "always swept at int8)|"
                        "lmhead_xent (rows/cols = tokens/vocab)")
    p.add_argument("--rows", type=int, default=64)
    p.add_argument("--cols", type=int, default=4096)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache", default=None,
                   help=f"cache file (default: ${registry.DEFAULT_CACHE_ENV}"
                        f" or {registry.DEFAULT_CACHE_FILE})")
    args = p.parse_args(argv)
    if args.op in NO_TILE_OPS:
        p.error(NO_TILE_OPS[args.op])

    sweep = ([(args.op, args.rows, args.cols)] if args.op
             else list(DEFAULT_SWEEP))
    for op, rows, cols in sweep:
        # kv_page_quant is keyed under int8, the dtype resolve_page_quant
        # looks up, whatever the sweep's dtype
        dt = torch.int8 if op == "kv_page_quant" else getattr(torch,
                                                              args.dtype)
        r = autotune_op(op, rows, cols, dt, cache_file=args.cache,
                        device=args.device, verbose=True)
        print(f"{op} {rows}x{cols} {r.dtype}: best={r.best} "
              f"({r.best_s * 1e6:.1f}us) default={r.default} "
              f"({r.default_s * 1e6:.1f}us) speedup={r.speedup:.2f}x")
    print(f"cache: {registry.cache_path(args.cache)}")


if __name__ == "__main__":
    main()
