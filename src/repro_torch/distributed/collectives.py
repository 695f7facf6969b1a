"""The collectives of tensor-parallel serving, over the model axis of the
active mesh (``autoshard.active_mesh()``).

The reference leaves these to XLA's partitioner; the port writes them.
Every function is the identity (or the plain single-rank form) when no
mesh is active or its model axis has one rank, so the model code calls
them unconditionally.

All of them are ``all_reduce``: ``gloo`` reduces CUDA tensors but may lack
an ``all_gather`` of them, so a gather is written as the ``all_reduce`` of
a zero-filled ``[tp, ...]`` buffer in which each rank fills its own row.
Adding zeros is exact, so the gathered rows are the ranks' values bit for
bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import autoshard


def model_axis(mesh=None) -> tuple[int, int]:
    """``(tp, rank)``: the model axis's size and this rank's place on it
    (``(1, 0)`` without an active mesh)."""
    mesh = mesh if mesh is not None else autoshard.active_mesh()
    if mesh is None:
        return 1, 0
    return mesh.size("model"), mesh.local_rank("model")


def all_reduce(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum ``x`` over the model axis, in place (row-parallel products:
    each rank holds a partial sum over its slice of the inner dim)."""
    mesh = mesh if mesh is not None else autoshard.active_mesh()
    if mesh is None or mesh.size("model") == 1:
        return x
    dist.all_reduce(x, group=mesh.group("model"))
    return x


def all_gather(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``[tp, *x.shape]``: every rank's ``x``, row ``r`` from rank ``r``,
    as one ``all_reduce`` of a zero-filled buffer (exact)."""
    tp, rank = model_axis(mesh)
    if tp == 1:
        return x[None]
    buf = x.new_zeros((tp, *x.shape))
    buf[rank] = x
    return all_reduce(buf, mesh)


def all_gather_columns(x: torch.Tensor, cols: int,
                       mesh=None) -> torch.Tensor:
    """The whole ``[..., cols]`` of a tensor whose last axis is split over
    the model axis (this rank's ``x`` holds its ``shard_bounds`` slice,
    which may be shorter or empty where ``cols`` does not divide):
    each slice is padded to the longest, gathered, and the padding cut
    away."""
    from repro_torch.distributed.sharding import shard_bounds

    tp, _ = model_axis(mesh)
    if tp == 1:
        return x
    step = -(-cols // tp)
    pad = x.new_zeros((*x.shape[:-1], step))
    pad[..., :x.shape[-1]] = x
    parts = all_gather(pad, mesh)
    return torch.cat([parts[r, ..., :hi - lo] for r, (lo, hi) in enumerate(
        shard_bounds(cols, tp, r) for r in range(tp))], dim=-1)


def vocab_range(rows: int, mesh=None) -> tuple[int, int]:
    """``[lo, hi)``: this rank's rows of a vocab-parallel table of
    ``rows`` rows (``sharding.shard_bounds``)."""
    from repro_torch.distributed.sharding import shard_bounds

    tp, rank = model_axis(mesh)
    return shard_bounds(rows, tp, rank)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, rows: int,
                dtype) -> torch.Tensor:
    """The embedding of ``tokens`` from a vocab-parallel ``table`` (this
    rank's rows of a full table of ``rows``): a rank looks up the tokens
    in its range, gives zeros for the others, and the ranks' rows are
    summed.  One rank holds each token, so the sum is exact."""
    tp, _ = model_axis()
    if tp == 1:
        return table[tokens.long()].to(dtype)
    lo, hi = vocab_range(rows)
    t = tokens.long()
    mine = (t >= lo) & (t < hi)
    x = table[torch.where(mine, t - lo, 0)].to(dtype)
    x = x * mine[..., None].to(dtype)
    return all_reduce(x.contiguous())


def sharded_argmax(x: torch.Tensor, lo: int) -> torch.Tensor:
    """``argmax`` over the last axis of a tensor split by columns across
    the model axis (``x`` this rank's columns, the first at global column
    ``lo``), with one collective: each rank's largest value and its first
    global index, gathered; the largest value wins and a tie goes to the
    lowest index, as ``torch.argmax``.  float32 carries an index exactly
    up to 2**24."""
    tp, _ = model_axis()
    if tp == 1:
        return x.argmax(dim=-1)
    x = x.to(torch.float32)
    if x.shape[-1]:
        val, idx = x.max(dim=-1)
        idx = (idx + lo).to(torch.float32)
    else:                      # a rank past the vocabulary's end
        val = x.new_full(x.shape[:-1], -torch.inf)
        idx = x.new_full(x.shape[:-1], float(2 ** 24))
    pairs = all_gather(torch.stack([val, idx]))           # [tp, 2, ...]
    vals, idxs = pairs[:, 0], pairs[:, 1]
    best = vals.amax(dim=0, keepdim=True)
    idxs = torch.where(vals == best, idxs, float(2 ** 24))
    return idxs.amin(dim=0).to(torch.int64)
