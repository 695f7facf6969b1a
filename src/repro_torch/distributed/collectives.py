"""The collectives of tensor-parallel serving and training, over the axes
of the active mesh (``autoshard.active_mesh()``).

The reference leaves these to XLA's partitioner; the port writes them.
Every function is the identity (or the plain single-rank form) when no
mesh is active or its axis has one rank, so the model code calls them
unconditionally.

All of them are ``all_reduce``: ``gloo`` reduces CUDA tensors but may lack
an ``all_gather`` of them, so a gather is written as the ``all_reduce`` of
a zero-filled ``[tp, ...]`` buffer in which each rank fills its own row.
Adding zeros is exact, so the gathered rows are the ranks' values bit for
bit.  ``gloo`` has no reduce-scatter either: it is an ``all_reduce``
after which a rank keeps its own slice.  (Under NCCL the same calls run;
its native all-gather and reduce-scatter would move half the bytes.)

Training differentiates through them (Megatron's pair and FSDP's
gather, as ``torch.autograd.Function``s):

  * :func:`copy_to_model`: the identity forward, an all-reduce of the
    gradient over ``model`` backward; on the input of every
    column-parallel product, whose ranks each see part of its gradient;
  * :func:`all_reduce` (reduce from the model axis): the sum forward, the
    identity backward; after every row-parallel product and the
    vocab-parallel embedding;
  * :func:`gather_data`: an all-gather over ``data`` forward whose
    backward reduce-scatters in float32 (FSDP: a leaf is whole only while
    it is used).

With gradients off (serving) they run the forward alone, as before.
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


def _group(axis: str, mesh=None):
    """The active (or given) mesh's group along ``axis``; None where the
    axis has one rank or there is no mesh."""
    mesh = mesh if mesh is not None else autoshard.active_mesh()
    if mesh is None or mesh.size(axis) == 1:
        return None
    return mesh.group(axis)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in a new contiguous tensor."""
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _Sum(torch.autograd.Function):
    """The sum over a group forward, the gradient passed back as is."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def _grads_on(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum ``x`` over the model axis (row-parallel products: each rank
    holds a partial sum over its slice of the inner dim).  In place with
    gradients off; with them on, a new tensor whose gradient passes back
    to each rank's partial unchanged."""
    group = _group("model", mesh)
    if group is None:
        return x
    if _grads_on(x):
        return _Sum.apply(x, group)
    dist.all_reduce(x, group=group)
    return x


def copy_to_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the model axis: the
    input of a column-parallel product (each rank's columns give part of
    its gradient).  The identity with gradients off."""
    group = _group("model", mesh)
    if group is None or not _grads_on(x):
        return x
    return _CopyToModel.apply(x, group)


def sum_over(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis``, the gradient passed back
    unchanged (the loss's sum over the data ranks' tokens)."""
    group = _group(axis, mesh)
    if group is None:
        return x
    if _grads_on(x):
        return _Sum.apply(x, group)
    return _summed(x, group)


class _GatherData(torch.autograd.Function):
    """A leaf's FSDP shard -> the whole leaf along ``dim`` in ``dtype``;
    the gradient back in float32, summed over the data ranks and cut to
    this rank's shard."""

    @staticmethod
    def forward(ctx, x, dim, size, dtype, group, n, idx):
        from repro_torch.distributed.sharding import shard_bounds

        step = -(-size // n)
        shape = list(x.shape)
        shape[dim] = step * n
        buf = x.new_zeros(shape, dtype=dtype)
        buf.narrow(dim, idx * step, x.shape[dim]).copy_(x)
        dist.all_reduce(buf, group=group)
        lo, hi = shard_bounds(size, n, idx)
        ctx.args = (dim, group, lo, hi, x.dtype)
        return buf.narrow(dim, 0, size)

    @staticmethod
    def backward(ctx, g):
        dim, group, lo, hi, dtype = ctx.args
        g32 = g.to(torch.float32).contiguous().clone()
        dist.all_reduce(g32, group=group)
        return (g32.narrow(dim, lo, hi - lo).to(dtype), None, None, None,
                None, None, None)


def gather_data(x: torch.Tensor, spec, full_shape, dtype=None,
                mesh=None) -> torch.Tensor:
    """The whole of a leaf whose dims are cut over the data axis by
    ``spec`` (``x`` this rank's shard, ``full_shape`` the leaf's), cast to
    ``dtype`` first (the compute dtype: half the bytes of a float32 leaf,
    and every product casts to it anyway); its dims cut over ``model``
    stay cut.  The gradient comes back in float32, summed over the data
    ranks and cut to this rank's shard (a reduce-scatter), in ``x``'s
    dtype.  ``x`` cast to ``dtype`` where nothing is cut over data."""
    mesh = mesh if mesh is not None else autoshard.active_mesh()
    dtype = dtype or x.dtype
    for dim, part in enumerate(spec):
        names = (part,) if isinstance(part, str) else tuple(part or ())
        if all(a == "model" for a in names):
            continue
        if names != ("data",):
            raise NotImplementedError(
                f"spec entry {part!r}: FSDP over one data axis only")
        if mesh is not None and mesh.size("data") > 1:
            return _GatherData.apply(x, dim, full_shape[dim], dtype,
                                     mesh.group("data"), mesh.size("data"),
                                     mesh.local_rank("data"))
    return x.to(dtype)


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


class _FsdpEmbed(torch.autograd.Function):
    """:func:`fsdp_embed`: forward and backward by hand, as the table is
    never whole."""

    @staticmethod
    def forward(ctx, table, tokens, rows, dtype, mesh, n, idx, cols):
        from repro_torch.distributed.sharding import shard_bounds

        lo, hi = vocab_range(rows, mesh)
        c_lo, c_hi = shard_bounds(cols, n, idx)
        group = mesh.group("data")
        tok = tokens.long().new_zeros((n, *tokens.shape))
        tok[idx] = tokens.long()
        dist.all_reduce(tok, group=group)        # every data rank's tokens
        mine = (tok >= lo) & (tok < hi)
        local = torch.where(mine, tok - lo, 0)
        buf = table.new_zeros((*tok.shape, cols), dtype=dtype)
        buf[..., c_lo:c_hi] = (table[local] * mine[..., None]).to(dtype)
        dist.all_reduce(buf)          # rows over model, columns over data
        ctx.save_for_backward(local, mine)
        ctx.args = (group, idx, c_lo, c_hi, table.shape, table.dtype)
        return buf[idx]

    @staticmethod
    def backward(ctx, dx):
        local, mine = ctx.saved_tensors
        group, idx, c_lo, c_hi, shape, dtype = ctx.args
        g = dx.new_zeros((local.shape[0], *dx.shape), dtype=torch.float32)
        g[idx] = dx
        dist.all_reduce(g, group=group)          # every data rank's dx
        dt = torch.zeros(shape, dtype=torch.float32, device=dx.device)
        dt.index_add_(0, local[mine], g[..., c_lo:c_hi][mine])
        return dt.to(dtype), None, None, None, None, None, None, None


def fsdp_embed(table: torch.Tensor, tokens: torch.Tensor, rows: int,
               cols: int, dtype, mesh=None) -> torch.Tensor:
    """The embedding of ``tokens`` (this data rank's) from a table whose
    rows are cut over ``model`` and columns over ``data`` (FSDP: ``table``
    is this rank's ``[rows / tp, cols / data]`` block), without making
    the table whole: the data ranks' tokens are gathered, each rank looks
    up its block for all of them, and one all-reduce over the world of a
    zero-filled ``[data, *tokens.shape, cols]`` buffer assembles each
    token's row (one rank holds each row and column: exact).  The
    backward gathers every data rank's output gradient (float32) and adds
    the rows of this rank's block, as the single process's lookup adds
    those of its table.  Moves the activations' bytes, not the
    table's."""
    mesh = mesh if mesh is not None else autoshard.active_mesh()
    n, idx = mesh.size("data"), mesh.local_rank("data")
    return _FsdpEmbed.apply(table, tokens, rows, dtype, mesh, n, idx, cols)


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
