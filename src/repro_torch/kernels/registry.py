"""Kernel registry: the one block-shape model for every kernel op.

Every op registers a :class:`KernelSpec` (alignment grid and caps);
:func:`block_shapes` resolves ``(rows, cols)`` for a key ``(op, rows, cols,
dtype, backend)`` through three levels: explicit overrides > the persisted
autotune cache (opt-in: ``SoftmaxPolicy(autotune=True)``) > the spec's
heuristic.  The cache is a JSON file written by
``repro_torch.kernels.autotune``; its keys are power-of-two shape buckets,
so one sweep covers a band of nearby shapes, and a cached entry is clamped
to the tuner's envelope and to the shape's own padded width.

The port keeps a cache file of its own (``$REPRO_TORCH_AUTOTUNE_CACHE``,
default ``~/.cache/repro_torch/autotune.json``), never the reference's: a
block means something else here (decode rows align to 1, not 8; decode
cols to 16, not 128), so an entry the reference's tuner wrote would be
read with the wrong meaning.  Keys are the reference's letter for letter:
``op|r{bucket}|c{bucket}|{dtype}|{backend}`` (``|s{shards}`` appended
when shards > 1), with the dtype under its NumPy / jnp name (``float32``,
``bfloat16``, ``int8``) and the backend ``gpu`` for a CUDA device, ``cpu``
for the CPU.

The alignments are re-derived for Hopper rather than copied from the TPU's
(8, 128) sublane/lane grid:

  * ``softmax`` / ``logsumexp``: no spec.  The CUDA kernels (two-pass and
    both three-pass baselines) give each row its own thread block, sweep
    the whole row inside it and mask the ragged edge themselves, so they
    take no tile and nothing is padded.
  * ``xent``: no spec, for the same reason: the cross-entropy kernels
    sweep whole rows of the logits, so ``ops.cross_entropy`` pads nothing.
  * ``decode_attention`` / ``decode_attention_paged``: one block per
    (slot, KV head), so slots never tile (``row_align`` 8 -> 1; the row
    block sets only the plain forms' slot chunks).  The col block is the
    kernel's KV tile, whose scores live in shared memory (``[G, tile]``
    f32): 16-aligned, 128 by the heuristic (no full-width tile), the same
    model as ``kv_page``, so a strip cache folds in the same tiles a paged
    cache folds in pages and the two give equal bits.  The tuner may reach
    the kernel's ``MAX_TILE`` (256); the paged op's col block rounds down
    to whole pages, at most ``MAX_PAGES_PER_TILE`` of them.
  * ``lmhead_xent``: the fused LM-head CE (``csrc/lmhead_xent.cu``).  Its
    kernels compute fixed 128 x 128 logit tiles (128 tokens, 128 vocab
    columns: the wmma warp grid and the FFMA 8 x 8-a-thread tile), so the
    row block is 128 and never tiles anything else.  The col block is the
    vocab slab of the backward's float32 dlogits scratch (``2 T block_v``
    floats: bounded, never ``[T, V]``) and the plain versions' chunk
    width; 128-aligned, 8192 by the heuristic.  The tuner may take slabs
    up to 32768 columns while that scratch stays within 128 MiB.
  * ``flash_attention`` / ``flash_attention_bwd``: rows = Sq, cols = Skv.
    The CUDA kernels (``csrc/flash_attention.cu``) take a fixed tile of
    64 query x 64 key rows (32 where a head dim over 128 or float32 inputs
    would overflow shared memory): 4 warps of 16 wmma rows, one cp.async
    stage.  The blocks here are that tile, 64-aligned and capped at 64
    (the reference's 128 MXU tile halved), and they set only the plain
    versions' chunk lengths: a block override (policy ``attn_block_q`` /
    ``attn_block_k``) or a tuned entry changes the plain forms' chunking
    and never reaches the CUDA tile.
  * ``chunk_attention``, ``kv_page``, ``kv_page_quant``: the reference's
    specs unchanged (128-token pages, 16-aligned, shrunk to the pool's own
    length for tiny pools), so the port resolves the same chunks, page
    size and scale granularity as the reference, tuned or not.  An int8
    pool's cols are its tokens per page, as ``kv_page``'s; its rows the
    granularity (1 row: one float32 scale a stored position, "page"; more:
    one a position and KV head, "page_head").  The paged decode kernel
    maps each position to its page, so a page longer than a tile (512
    tokens) is folded in tiles of ``MAX_TILE``.
"""

from __future__ import annotations

import json
import os
import threading
import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch

DEFAULT_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
DEFAULT_CACHE_FILE = os.path.join(
    os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


# ---------------------------------------------------------------------------
# Kernel specs.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class KernelSpec:
    """One registered op and its block-shape model.

    cols: full row width while ``cols <= full_col_threshold``, else
          ``col_cap``; always a ``col_align`` multiple.
    rows: smallest ``row_align`` multiple covering ``rows``, clamped to
          ``[row_align, row_cap]``.

    The tuner may explore past the heuristic caps: ``tune_row_cap`` /
    ``tune_col_cap`` bound the sweep's candidates AND the clamp applied to
    cached entries (None: ``row_cap`` / ``2 * col_cap``, as the
    reference).  ``sweep_rows`` / ``sweep_cols`` are the candidate grid
    (clamped to the envelope and the shape), and ``sweep_budget_bytes``
    bounds a candidate's float32 working set, ``2 * 4 * br * bc`` bytes --
    or ``2 * 4 * rows * bc`` where ``scratch_spans_rows`` says the
    working set spans every row (the LM-head backward's ``[2, T,
    block_v]`` scratch).
    """
    name: str
    fn: Optional[Callable] = None        # the kernel entry point (bind)
    row_align: int = 8
    row_cap: int = 256
    col_align: int = 128
    col_cap: int = 2048
    full_col_threshold: int = 4096
    tune_row_cap: Optional[int] = None
    tune_col_cap: Optional[int] = None
    sweep_budget_bytes: int = 4 << 20
    sweep_rows: tuple[int, ...] = (8, 16, 32, 64, 128, 256)
    sweep_cols: tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096)
    scratch_spans_rows: bool = False

    def heuristic_blocks(self, rows: int, cols: int) -> tuple[int, int]:
        bc = cols if cols <= self.full_col_threshold else self.col_cap
        bc = round_up(min(bc, round_up(cols, self.col_align)),
                      self.col_align)
        br = max(self.row_align,
                 min(self.row_cap, round_up(rows, self.row_align)))
        return br, bc

    def envelope(self) -> tuple[int, int]:
        """(max rows, max cols) a tuned or candidate block may take."""
        return (self.tune_row_cap or self.row_cap,
                self.tune_col_cap or 2 * self.col_cap)


_REGISTRY: dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(op: str) -> KernelSpec:
    if op not in _REGISTRY:
        raise KeyError(f"unknown kernel op {op!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[op]


def bind(op: str, fn: Callable) -> None:
    """Attach the kernel entry point to a registered spec (``ops`` binds
    each op's; an introspection surface, the ops stay the public API)."""
    _REGISTRY[op] = dataclasses.replace(get_spec(op), fn=fn)


def registered_ops() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Key parts: dtype and backend names.
# ---------------------------------------------------------------------------
def dtype_name(dtype) -> str:
    """The dtype's NumPy / jnp name (``torch.bfloat16`` -> ``bfloat16``), the
    name the reference's keys carry.  Takes a ``torch.dtype`` or a name."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"not a torch dtype or dtype name: {dtype!r}")
    return str(dtype).removeprefix("torch.")


def backend_of(device) -> str:
    """``gpu`` for a CUDA device, ``cpu`` for the CPU; a device with no
    backend of its own (``meta``: shapes alone) and None take
    :func:`default_backend`."""
    kind = None if device is None else torch.device(device).type
    return {"cuda": "gpu", "cpu": "cpu"}.get(kind) or default_backend()


def default_backend() -> str:
    """What ``backend=None`` means: the backend of the port's default
    device, ``gpu`` where a CUDA device is present, else ``cpu`` (as the
    reference's None means ``jax.default_backend()``).  Resolution inside
    the ops passes the backend of the tensors' own device instead."""
    return "gpu" if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------
# Autotune cache (JSON, persisted across runs).  Memoised per cache file so
# policies with different cache paths coexist in one process.
# ---------------------------------------------------------------------------
_cache_lock = threading.Lock()
_caches: dict[str, dict] = {}              # cache file path -> entries


def cache_path(path: str | None = None) -> str:
    return path or os.environ.get(DEFAULT_CACHE_ENV) or DEFAULT_CACHE_FILE


def _bucket(x: int) -> int:
    """Power-of-two shape bucket: one tuned entry covers nearby shapes."""
    return 1 << max(0, (x - 1).bit_length())


def cache_key(op: str, rows: int, cols: int, dtype, backend: str,
              shards: int = 1) -> str:
    """Bucketed tuning key, the reference's format.  ``shards`` is the
    tensor-parallel shard count the op runs under (the decode ops pass the
    serving mesh's model axis, ``ops._tp_shards``); ``shards=1`` adds
    nothing to the key."""
    key = "|".join((op, f"r{_bucket(rows)}", f"c{_bucket(cols)}",
                    dtype_name(dtype), backend))
    return key if shards <= 1 else f"{key}|s{shards}"


def load_cache(path: str | None = None, *, force: bool = False) -> dict:
    """Loads (and memoises per path) the JSON cache; a missing or corrupt
    file gives ``{}``.  ``force`` rereads the file."""
    p = cache_path(path)
    with _cache_lock:
        if not force and p in _caches:
            return _caches[p]
        try:
            with open(p) as f:
                entries = json.load(f)
        except (OSError, ValueError):
            entries = {}
        _caches[p] = entries if isinstance(entries, dict) else {}
        return _caches[p]


def save_cache(path: str | None = None) -> str:
    p = cache_path(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with _cache_lock:
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_caches.get(p, {}), f, indent=2, sort_keys=True)
        os.replace(tmp, p)
    return p


def record_tuned(op: str, rows: int, cols: int, dtype,
                 blocks: tuple[int, int], *, backend: str | None = None,
                 meta: dict | None = None, path: str | None = None,
                 persist: bool = True, shards: int = 1) -> str:
    """Stores a tuned block shape; returns the cache key."""
    key = cache_key(op, rows, cols, dtype, backend or default_backend(),
                    shards)
    p = cache_path(path)
    load_cache(p)
    with _cache_lock:
        _caches[p][key] = dict(block_rows=int(blocks[0]),
                               block_cols=int(blocks[1]), **(meta or {}))
    if persist:
        save_cache(p)
    return key


def lookup_tuned(op: str, rows: int, cols: int, dtype,
                 *, backend: str | None = None, path: str | None = None,
                 shards: int = 1) -> Optional[tuple[int, int]]:
    entry = load_cache(path).get(cache_key(
        op, rows, cols, dtype, backend or default_backend(), shards))
    if entry is None:
        return None
    return int(entry["block_rows"]), int(entry["block_cols"])


# ---------------------------------------------------------------------------
# Resolution: overrides > autotune cache > heuristic.
# ---------------------------------------------------------------------------
def block_shapes(op: str, rows: int, cols: int, dtype=torch.float32, *,
                 block_rows: int | None = None, block_cols: int | None = None,
                 use_cache: bool = False, backend: str | None = None,
                 cache_file: str | None = None,
                 shards: int = 1) -> tuple[int, int]:
    """Explicit ``block_rows``/``block_cols`` win per axis (alignment-rounded
    only); otherwise, with ``use_cache``, a persisted entry for the
    bucketed key, clamped to the tuner's envelope and to this shape's own
    padded width (a bucket neighbour must not inherit a tile wider than its
    data); otherwise the registered spec's heuristic."""
    spec = get_spec(op)
    tuned = None
    if use_cache and (block_rows is None or block_cols is None):
        tuned = lookup_tuned(op, rows, cols, dtype, backend=backend,
                             path=cache_file, shards=shards)
        if tuned is not None:
            er, ec = spec.envelope()
            tuned = (min(tuned[0], er, round_up(rows, spec.row_align)),
                     min(tuned[1], ec, round_up(cols, spec.col_align)))
    hr, hc = spec.heuristic_blocks(rows, cols)
    br = block_rows if block_rows is not None else (
        tuned[0] if tuned else hr)
    bc = block_cols if block_cols is not None else (
        tuned[1] if tuned else hc)
    br = max(spec.row_align, round_up(br, spec.row_align))
    bc = max(spec.col_align, round_up(bc, spec.col_align))
    return br, bc


def candidate_blocks(op: str, rows: int, cols: int, *,
                     budget_bytes: int | None = None
                     ) -> list[tuple[int, int]]:
    """Sweep candidates: the spec's grid clamped to its envelope and the
    shape, within its working-set budget, plus the heuristic point."""
    spec = get_spec(op)
    budget = budget_bytes or spec.sweep_budget_bytes
    er, ec = spec.envelope()
    pr, pc = round_up(rows, spec.row_align), round_up(cols, spec.col_align)
    row_opts = sorted({max(spec.row_align, min(er, r))
                       for r in (*spec.sweep_rows, pr)})
    col_opts = sorted({max(spec.col_align, min(ec, c))
                       for c in (*spec.sweep_cols, pc)})
    cands = []
    for br in row_opts:
        if br > pr:
            continue
        for bc in col_opts:
            if bc > pc:
                continue
            span = rows if spec.scratch_spans_rows else br
            if 2 * 4 * span * bc > budget:
                continue
            cands.append((br, bc))
    hr, hc = spec.heuristic_blocks(rows, cols)
    if (hr, hc) not in cands:
        cands.append((hr, hc))
    return cands


# ---------------------------------------------------------------------------
# Registered ops (the decode ops' caps are the kernel's MAX_TILE 256 and
# MAX_PAGES_PER_TILE 8, kernels/decode_attention.py).
# ---------------------------------------------------------------------------
_DECODE_COLS = (16, 32, 64, 128, 256)

# chunked plain attention (models.attention.mn_chunk_attention): blocks are
# chunk LENGTHS along (Sq, Skv); no kernel, so the reference's geometry.
register(KernelSpec(name="chunk_attention", row_align=256, row_cap=2048,
                    col_align=256, col_cap=2048, full_col_threshold=2048,
                    tune_row_cap=2048, tune_col_cap=4096,
                    sweep_budget_bytes=64 << 20))
register(KernelSpec(name="decode_attention", row_align=1, row_cap=256,
                    col_align=16, col_cap=128, full_col_threshold=0,
                    tune_row_cap=256, tune_col_cap=256,
                    sweep_budget_bytes=64 << 20, sweep_cols=_DECODE_COLS))
register(KernelSpec(name="decode_attention_paged", row_align=1, row_cap=256,
                    col_align=16, col_cap=128, full_col_threshold=0,
                    tune_row_cap=256, tune_col_cap=256,
                    sweep_budget_bytes=64 << 20, sweep_cols=_DECODE_COLS))
register(KernelSpec(name="lmhead_xent", row_align=128, row_cap=128,
                    col_align=128, col_cap=8192, full_col_threshold=8192,
                    tune_row_cap=128, tune_col_cap=32768,
                    sweep_budget_bytes=2 * 4 * 512 * 32768,
                    sweep_rows=(128,),
                    sweep_cols=(1024, 2048, 4096, 8192, 16384, 32768),
                    scratch_spans_rows=True))
register(KernelSpec(name="flash_attention", row_align=64, row_cap=64,
                    col_align=64, col_cap=64, full_col_threshold=0,
                    tune_row_cap=512, tune_col_cap=512,
                    sweep_rows=(64, 128, 256, 512),
                    sweep_cols=(64, 128, 256, 512)))
register(KernelSpec(name="flash_attention_bwd", row_align=64, row_cap=64,
                    col_align=64, col_cap=64, full_col_threshold=0,
                    tune_row_cap=512, tune_col_cap=512,
                    sweep_rows=(64, 128, 256, 512),
                    sweep_cols=(64, 128, 256, 512)))
register(KernelSpec(name="kv_page", row_align=1, row_cap=1,
                    col_align=16, col_cap=128, full_col_threshold=0,
                    tune_col_cap=512))
register(KernelSpec(name="kv_page_quant", row_align=1, row_cap=1,
                    col_align=16, col_cap=128, full_col_threshold=0,
                    tune_row_cap=8, tune_col_cap=512))
