"""Parallelism rules: parameter path -> partition spec, as the reference.

Scheme (Megatron tensor parallelism x FSDP):
  * column-parallel in-projections: output dim over ``model``, input dim
    over the FSDP axes (all data-parallel axes);
  * row-parallel out-projections: input dim over ``model``, output over
    FSDP;
  * embeddings / LM head: vocab over ``model`` (the vocab-parallel
    softmax is one of the paper's technique sites), d over FSDP;
  * MoE experts: the expert axis over ``model`` when it divides, else the
    expert hidden dim;
  * K / V projections over ``model`` only when the KV heads divide tp,
    else replicated over it;
  * small and 1-D parameters replicated; the stacked layer axis never
    sharded.

A spec is a plain tuple with one entry a dim: ``None`` (replicated), an
axis name, or a tuple of axis names.  It compares equal, entry for entry,
with the reference's ``PartitionSpec``.  A mesh here is anything with
``axis_names`` and ``devices.shape`` (``launch.mesh.Mesh``, or the
reference's mesh); nothing else is read.

The rules are the reference's; what the port does with them differs.  It
has no partitioner: :func:`local_shard` cuts each rank's own tensor out of
a full one along the ``model`` entries of its spec, and the model code
issues the collectives.  The data axes replicate the serving step (every
data rank runs every slot), so serving cuts along ``model`` only.
"""

from __future__ import annotations

import logging
import re

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

log = logging.getLogger(__name__)

Spec = tuple


def _spec(parts) -> Spec:
    """A spec from its entries, a one-axis tuple written as the axis, as
    the reference's ``PartitionSpec`` normalises it."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


def _fsdp(mesh) -> tuple[str, ...] | None:
    axes = tuple(a for a in mesh.axis_names if a != "model")
    return axes if axes else None


def _tp(mesh) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)


def _rules(cfg: ModelConfig, mesh):
    """Ordered (regex, spec) table.  Specs are for the parameter without
    the stacked L axis; the L axis is prepended for block parameters."""
    f = _fsdp(mesh)
    tp = _tp(mesh)
    kv_tp = "model" if cfg.n_kv_heads % tp == 0 else None
    ep = cfg.moe is not None and cfg.moe.n_experts % tp == 0

    col = (f, "model")                # (in, out): column-parallel
    row = ("model", f)                # row-parallel
    col_b = ("model",)                # column bias
    rep2 = (None, None)
    rep1 = (None,)

    table = [
        # attention (GQA and MLA share prefixes)
        (r"attn/wq/w$", col), (r"attn/wq/b$", col_b),
        (r"attn/wk/w$", (f, kv_tp)), (r"attn/wk/b$", (kv_tp,)),
        (r"attn/wv/w$", (f, kv_tp)), (r"attn/wv/b$", (kv_tp,)),
        (r"attn/wo/w$", row),
        (r"attn/wkv_a/w$", (f, None)),           # MLA latent: head-shared
        (r"attn/wkv_b/w$", col),
        (r"attn/kv_norm/scale$", rep1),
        (r"xattn/wq/w$", col), (r"xattn/wk/w$", (f, kv_tp)),
        (r"xattn/wv/w$", (f, kv_tp)), (r"xattn/wo/w$", row),
        # dense MLP
        (r"mlp/(up|gate)/w$", col), (r"mlp/down/w$", row),
        (r"mlp/(up|gate)/b$", col_b), (r"mlp/down/b$", (f,)),
        # MoE
        (r"mlp/router/w$", (f, None)),
        (r"mlp/w[gu]$", ("model", f, None) if ep else (None, f, "model")),
        (r"mlp/wd$", ("model", None, f) if ep else (None, "model", f)),
        (r"mlp/shared/(up|gate)/w$", col), (r"mlp/shared/down/w$", row),
        # hymba's mamba half first (its wo / in_* must not hit the rwkv
        # generics): replicated over model, FSDP on d
        (r"mamba/in_[a-z_]+/w$", (f, None)),
        (r"mamba/wo/w$", (f, None)),
        (r"mamba/out_norm/scale$", rep1),
        # rwkv6 time-mix / channel-mix
        (r"w[rkvg]/w$", col), (r"wo/w$", row),
        (r"wa/w$", (f, None)), (r"wb/w$", (None, "model")),
        (r"(w0|dt_bias|a_log)$", rep1),
        (r"u$", rep2), (r"mu/.*$", rep1), (r"mu_c[kr]$", rep1),
        (r"ck/w$", col), (r"cv/w$", row), (r"cr/w$", col),
        # embeddings / head
        (r"^embed/table$", ("model", f)),        # vocab-parallel
        (r"^lm_head/w$", (f, "model")),
        (r"^patch_proj/w$", (f, None)),
        # norms and anything 1-D
        (r"(ln\w*|norm\w*|out_norm|enc_norm|norm_f)/scale$", rep1),
    ]
    return [(re.compile(pat), spec) for pat, spec in table]


def map_paths(tree, fn, prefix: str = ""):
    """The tree of ``fn(path, leaf)``, paths joined by ``/``."""
    if isinstance(tree, dict):
        return {k: map_paths(v, fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def flatten(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs of a nested dict in insertion order, paths
    joined by ``/`` (a spec, a tuple, is a leaf)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in flatten(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def param_specs(params_tree, cfg: ModelConfig, mesh, fsdp: bool = True):
    """The spec of every leaf of a parameter tree (tensors, ``meta``
    tensors or anything with ``.shape``), by the path rules.

    ``fsdp=False`` replicates parameters over the data axes (serving:
    parameters are read-only, so FSDP would gather them every step for no
    memory gain); the model axis is kept."""
    rules = _rules(cfg, mesh)
    if not fsdp:
        f_set = set(_fsdp(mesh) or ())

        def _is_fsdp(part):
            if isinstance(part, str):
                return part in f_set
            if isinstance(part, tuple):
                return set(part) <= f_set
            return False

        rules = [(rx, tuple(None if _is_fsdp(p) else p for p in spec))
                 for rx, spec in rules]

    def spec_for(path: str, leaf) -> Spec:
        nd = len(leaf.shape)
        stacked = path.startswith(("blocks/", "enc_blocks/"))
        for rx, spec in rules:
            if rx.search(path):
                parts = ([None] if stacked else []) + list(spec)
                return _spec((parts + [None] * nd)[:nd])
        if max(leaf.shape, default=0) >= 1024:
            log.warning("sharding fallback to replicated for %s %s", path,
                        tuple(leaf.shape))
        return (None,) * nd

    return map_paths(params_tree, spec_for)


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if isinstance(axes, str):
        return sizes[axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def batch_specs(batch_tree, mesh):
    """Data-parallel sharding of step inputs: the leading batch dim over
    every non-model axis where it divides; scalars replicated."""
    dp = _fsdp(mesh)
    dp_n = _axes_size(mesh, dp)

    def spec_for(_path, leaf) -> Spec:
        if not leaf.shape:
            return ()
        lead = dp if leaf.shape[0] % dp_n == 0 else None
        return _spec((lead,) + (None,) * (len(leaf.shape) - 1))

    return map_paths(batch_tree, spec_for)


def cache_specs(cache_tree, cfg: ModelConfig, mesh,
                seq_shard: bool = False):
    """Decode-cache sharding: ``[L, B, S, ...]``, batch over the data axes.
    ``seq_shard=True`` also shards dim 2 (the sequence) over ``model``
    (sequence-parallel decode); so does a batch that cannot shard."""
    dp = _fsdp(mesh)
    dp_n = _axes_size(mesh, dp)
    tp_n = _axes_size(mesh, "model")

    def spec_for(_path, leaf) -> Spec:
        nd = len(leaf.shape)
        if nd < 2:
            return (None,) * nd
        parts = [None] * nd
        batch_ok = leaf.shape[1] % dp_n == 0
        if batch_ok:
            parts[1] = dp
        if nd >= 3 and (seq_shard or not batch_ok) \
                and leaf.shape[2] % tp_n == 0:
            parts[2] = "model"
        return _spec(parts)

    return map_paths(cache_tree, spec_for)


def kv_shard_factor(cfg: ModelConfig, mesh) -> int:
    """How many shards the serving KV arena splits into across ``model``:
    each rank stores ``n_kv_heads / tp`` heads of every page, so a
    per-rank byte budget buys ``factor`` times the global arena.  1 where
    the heads do not divide the model axis, and for MLA (the latent arena
    is head-shared)."""
    tp = _tp(mesh)
    if cfg.mla is not None or tp <= 1 or cfg.n_kv_heads % tp:
        return 1
    return tp


def pool_specs(pool_tree, cfg: ModelConfig, mesh):
    """Serving-pool sharding (``kv_cache.init_paged_pool`` /
    ``init_slot_pool`` state): page arenas ``[L, P, ps, Hkv, hd]`` (and
    strip leaves ``[L, S, T, Hkv, hd]``) split their KV-head axis over
    ``model`` where it divides; MLA's latent arenas replicate; int8
    "page_head" scales split with the heads, "page" scales replicate;
    hybrid's ssm state and a strip pool's slot axis go over the data axes
    where they divide; the page table and lengths replicate.  A paged
    arena's dim 1 is the page axis, which is never split (pages are shared
    across slots)."""
    dp = _fsdp(mesh)
    dp_n = _axes_size(mesh, dp)
    tp = _tp(mesh)
    kv_tp = "model" if (tp > 1 and cfg.n_kv_heads % tp == 0) else None
    paged = isinstance(pool_tree, dict) and "page_table" in pool_tree

    def spec_for(path: str, leaf) -> Spec:
        nd = len(leaf.shape)
        parts = [None] * nd
        if not path.startswith("kv"):                # page_table / lengths
            return tuple(parts)
        if path.endswith(("/k", "/v")) and nd == 5:
            parts[3] = kv_tp                         # KV-head axis
            if not paged and leaf.shape[1] % dp_n == 0:
                parts[1] = dp                        # strip slot axis
            return _spec(parts)
        if path.endswith(("/k_scale", "/v_scale")):
            if nd == 4:
                parts[3] = kv_tp
            return tuple(parts)
        if path.endswith("ssm") and nd >= 2:         # slot-major state
            if leaf.shape[1] % dp_n == 0:
                parts[1] = dp
            return _spec(parts)
        return tuple(parts)                          # MLA c / kr

    return map_paths(pool_tree, spec_for)


def prefill_cache_specs(cache_tree, cfg: ModelConfig, mesh):
    """A batch=1 prefill cache (``kv_cache.init_cache``, ``[L, B, S, Hkv,
    hd]``) laid out as the head-sharded arena it is adopted into: the
    KV-head axis over ``model`` for 5-D attention leaves, everything else
    replicated."""
    tp = _tp(mesh)
    kv_tp = "model" if (tp > 1 and cfg.n_kv_heads % tp == 0) else None

    def spec_for(_path, leaf) -> Spec:
        nd = len(leaf.shape)
        parts = [None] * nd
        if nd == 5 and leaf.shape[3] == cfg.n_kv_heads:
            parts[3] = kv_tp
        return tuple(parts)

    return map_paths(cache_tree, spec_for)


def named(tree_specs, mesh):
    """Each spec with its mesh, as the reference pairs them into
    ``NamedSharding``s: ``(mesh, spec)``."""
    if isinstance(tree_specs, dict):
        return {k: named(v, mesh) for k, v in tree_specs.items()}
    return (mesh, tree_specs)


# ---------------------------------------------------------------------------
# Cutting a rank's shard.
# ---------------------------------------------------------------------------
def shard_bounds(size: int, parts: int, index: int) -> tuple[int, int]:
    """``[lo, hi)`` of shard ``index`` of ``parts`` along a dim of ``size``:
    shards of ``ceil(size / parts)``, the last ones shorter (or empty)
    where it does not divide, as ``torch.chunk``."""
    step = -(-size // parts)
    lo = min(size, index * step)
    return lo, min(size, lo + step)


def _names(part) -> tuple[str, ...]:
    return (part,) if isinstance(part, str) else tuple(part or ())


def named_axes(spec: Spec) -> set[str]:
    """The mesh axes that ``spec`` cuts along."""
    return {a for part in spec for a in _names(part)}


def _index(mesh, axis: str, at) -> int:
    return mesh.local_rank(axis) if at is None else at[axis]


def shard_region(shape, spec: Spec, mesh,
                 axes: tuple[str, ...] = ("model",), at=None) -> list:
    """``(dim, lo, hi)`` of this rank's shard of a full tensor of
    ``shape`` for every dim whose spec entry names an axis of ``axes``
    (:func:`shard_bounds`, row-major over the named axes).  ``at`` maps
    each axis to another rank's index on it, for that rank's shard."""
    out = []
    for dim, part in enumerate(spec):
        cut = [a for a in _names(part) if a in axes]
        if not cut:
            continue
        n, idx = 1, 0
        for a in cut:                 # row-major over the named axes
            idx = idx * mesh.size(a) + _index(mesh, a, at)
            n *= mesh.size(a)
        out.append((dim, *shard_bounds(shape[dim], n, idx)))
    return out


def local_shard(x, spec: Spec, mesh, axes: tuple[str, ...] = ("model",)):
    """This rank's piece of the full tensor ``x`` (torch or numpy) under
    ``spec``: every dim whose entry names an axis of ``axes`` is cut to
    this rank's shard along it (:func:`shard_bounds`), a contiguous copy.
    Entries naming other axes are left whole (serving replicates over the
    data axes)."""
    out = x
    for dim, lo, hi in shard_region(x.shape, spec, mesh, axes):
        if isinstance(out, torch.Tensor):
            out = out.narrow(dim, lo, hi - lo)
        else:
            out = out[(slice(None),) * dim + (slice(lo, hi),)]
    if out is x:
        return x
    return (out.contiguous() if isinstance(out, torch.Tensor)
            else out.copy())


def first_holder(spec: Spec, mesh, at=None) -> bool:
    """Whether this rank (or the rank at ``at``, as in
    :func:`shard_region`) is the first of those holding the same shard of
    a leaf: index 0 along every mesh axis that ``spec`` does not name (a
    replicated leaf is counted, or written, once)."""
    named = named_axes(spec)
    return all(_index(mesh, a, at) == 0 for a in mesh.axis_names
               if a not in named)


def gather_to_rank0(x: torch.Tensor, spec: Spec, shape,
                    mesh) -> torch.Tensor | None:
    """The whole leaf of ``shape`` on rank 0, in host memory, from each
    rank's shard ``x`` (cut along ``model`` and the data axes); ``None``
    on the other ranks.  The first holder of each shard
    (:func:`first_holder`) sends it to rank 0, which receives the shards
    one at a time on ``x``'s device and places them: no other rank holds
    more than its shard, and rank 0 one whole leaf."""
    import torch.distributed as dist

    if dist.get_rank() != 0:
        if first_holder(spec, mesh) and x.numel():
            dist.send(x.contiguous(), dst=0)
        return None
    buf = torch.empty(tuple(shape), dtype=x.dtype)
    for idx, rank in np.ndenumerate(mesh.devices):
        at = dict(zip(mesh.axis_names, idx))
        if not first_holder(spec, mesh, at):
            continue
        view = buf
        for dim, lo, hi in shard_region(shape, spec, mesh,
                                        tuple(mesh.axis_names), at):
            view = view.narrow(dim, lo, hi - lo)
        if rank == 0:
            view.copy_(x)
        elif view.numel():
            part = x.new_empty(view.shape)
            dist.recv(part, src=int(rank))
            view.copy_(part)
    return buf


def fsdp_plan(shapes, specs):
    """Each leaf's ``(spec, full shape)``, the tree of ``shapes`` (the
    parameters on the ``meta`` device) and ``specs`` (their
    :func:`param_specs`): what ``autoshard.hints`` takes for FSDP."""
    spec_of = dict(flatten(specs))
    return map_paths(shapes, lambda path, leaf: (spec_of[path],
                                               tuple(leaf.shape)))


def shard_tree(tree, specs, mesh, axes: tuple[str, ...] = ("model",)):
    """:func:`local_shard` over a tree and its specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, axes)
                for k, v in tree.items()}
    return local_shard(tree, specs, mesh, axes)


def shard_params(params, cfg: ModelConfig, mesh):
    """A rank's serving parameters: each leaf cut along ``model`` by
    ``param_specs(..., fsdp=False)``."""
    return shard_tree(params, param_specs(params, cfg, mesh, fsdp=False),
                      mesh)
