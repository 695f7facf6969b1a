"""Kernel registry: the one block-shape model for every kernel op.

Every op registers a :class:`KernelSpec` (alignment grid and caps);
:func:`block_shapes` resolves ``(rows, cols)`` for an op: explicit
overrides > the spec's heuristic.  (The persisted autotune cache of the
reference package is not ported yet: ROADMAP queue A item 20.)

The alignments are re-derived for Hopper rather than copied from the TPU's
(8, 128) sublane/lane grid:

  * ``softmax`` / ``logsumexp``: no spec.  The CUDA kernels (two-pass and
    both three-pass baselines) give each row its own thread block, sweep
    the whole row inside it and mask the ragged edge themselves, so they
    take no tile and nothing is padded.
  * ``xent``: no spec, for the same reason: the cross-entropy kernels
    sweep whole rows of the logits, so ``ops.cross_entropy`` pads nothing.
  * ``decode_attention`` / ``decode_attention_paged``: one block per
    (slot, KV head), so slots never tile (``row_align`` 8 -> 1).  The col
    block is the kernel's KV tile, whose scores live in shared memory
    (``[G, tile]`` f32); it is capped at 128 positions and 16-aligned
    (``col_align`` 128 -> 16, ``col_cap`` 2048 -> 128, no full-width
    tile), the same model as ``kv_page``, so a strip cache folds in the
    same tiles a paged cache folds in pages and the two give equal bits.
  * ``lmhead_xent``: the fused LM-head CE (``csrc/lmhead_xent.cu``).  Its
    kernels compute fixed 128 x 128 logit tiles (128 tokens, 128 vocab
    columns: the wmma warp grid and the FFMA 8 x 8-a-thread tile), so the
    row block is 128 and never tiles anything else.  The col block is the
    vocab slab of the backward's float32 dlogits scratch (``[T, block_v]``,
    16 MB at 512 tokens and 8192 columns: bounded, never ``[T, V]``) and
    the plain versions' chunk width; 128-aligned, capped at 8192.
  * ``flash_attention`` / ``flash_attention_bwd``: rows = Sq, cols = Skv.
    The CUDA kernels (``csrc/flash_attention.cu``) take a fixed tile of
    64 query x 64 key rows (32 where a head dim over 128 or float32 inputs
    would overflow shared memory): 4 warps of 16 wmma rows, one cp.async
    stage.  The blocks here are that tile, 64-aligned and capped at 64
    (the reference's 128 MXU tile halved), and they set only the plain
    versions' chunk lengths: a block override (policy ``attn_block_q`` /
    ``attn_block_k``) changes the plain forms' chunking and never reaches
    the CUDA tile.
  * ``kv_page``: unchanged (128-token pages, 16-aligned, shrunk to the
    pool's own length for tiny pools), so the port resolves the same page
    size as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass


def round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


@dataclass(frozen=True)
class KernelSpec:
    """One registered op and its block-shape model.

    cols: full row width while ``cols <= full_col_threshold``, else
          ``col_cap``; always a ``col_align`` multiple.
    rows: smallest ``row_align`` multiple covering ``rows``, clamped to
          ``[row_align, row_cap]``.
    """
    name: str
    row_align: int = 8
    row_cap: int = 256
    col_align: int = 128
    col_cap: int = 2048
    full_col_threshold: int = 4096

    def heuristic_blocks(self, rows: int, cols: int) -> tuple[int, int]:
        bc = cols if cols <= self.full_col_threshold else self.col_cap
        bc = round_up(min(bc, round_up(cols, self.col_align)),
                      self.col_align)
        br = max(self.row_align,
                 min(self.row_cap, round_up(rows, self.row_align)))
        return br, bc


_REGISTRY: dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(op: str) -> KernelSpec:
    if op not in _REGISTRY:
        raise KeyError(f"unknown kernel op {op!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[op]


def block_shapes(op: str, rows: int, cols: int, *,
                 block_rows: int | None = None,
                 block_cols: int | None = None) -> tuple[int, int]:
    """Explicit ``block_rows``/``block_cols`` win per axis (alignment-rounded
    only); otherwise the registered spec's heuristic."""
    spec = get_spec(op)
    hr, hc = spec.heuristic_blocks(rows, cols)
    br = block_rows if block_rows is not None else hr
    bc = block_cols if block_cols is not None else hc
    br = max(spec.row_align, round_up(br, spec.row_align))
    bc = max(spec.col_align, round_up(bc, spec.col_align))
    return br, bc


# chunked plain attention (models.attention.mn_chunk_attention): blocks are
# chunk LENGTHS along (Sq, Skv); no kernel, so the reference's geometry.
register(KernelSpec(name="chunk_attention", row_align=256, row_cap=2048,
                    col_align=256, col_cap=2048, full_col_threshold=2048))
register(KernelSpec(name="decode_attention", row_align=1, row_cap=256,
                    col_align=16, col_cap=128, full_col_threshold=0))
register(KernelSpec(name="decode_attention_paged", row_align=1, row_cap=256,
                    col_align=16, col_cap=128, full_col_threshold=0))
register(KernelSpec(name="lmhead_xent", row_align=128, row_cap=128,
                    col_align=128, col_cap=8192, full_col_threshold=8192))
register(KernelSpec(name="flash_attention", row_align=64, row_cap=64,
                    col_align=64, col_cap=64, full_col_threshold=0))
register(KernelSpec(name="flash_attention_bwd", row_align=64, row_cap=64,
                    col_align=64, col_cap=64, full_col_threshold=0))
register(KernelSpec(name="kv_page", row_align=1, row_cap=1,
                    col_align=16, col_cap=128, full_col_threshold=0))
