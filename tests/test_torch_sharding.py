"""The port's sharding rule tables against the reference's, for every arch
at tp 1, 2, 4 and 16 on a ``('data', 'model')`` mesh of 2 x tp.

Both sides get the same stub mesh, which has only ``axis_names`` and
``devices.shape`` (all that the rules read), and trees of the same paths
and shapes: the reference's through ``jax.eval_shape``, the port's on the
``meta`` device.  A spec of the port is a plain tuple; it must equal the
reference's ``PartitionSpec`` entry for entry."""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jcfg
from repro.distributed import sharding as jsh
from repro.models import build_model as jbuild
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config as tcfg
from repro_torch.distributed import sharding as tsh
from repro_torch.models import transformer
from repro_torch.serving import kv_cache as tkv

TPS = (1, 2, 4, 16)
CASES = [(a, tp) for a in ARCH_IDS for tp in TPS]
IDS = [f"{a}-tp{tp}" for a, tp in CASES]


def _mesh(tp):
    return SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((2, tp)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _jflat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in kp): v
            for kp, v in leaves}


def _equal(port, ref):
    """Every path of both trees, each spec equal entry for entry."""
    p, r = _flat(port), _jflat(ref)
    assert set(p) == set(r)
    for path, spec in p.items():
        assert isinstance(spec, tuple), path
        assert spec == tuple(r[path]) and r[path] == spec, (path, spec,
                                                             r[path])


@functools.lru_cache(maxsize=None)
def _params(arch, tp):
    m = jbuild(arch, tp=tp)
    ref = jax.eval_shape(lambda k: m.init(k), jax.random.PRNGKey(0))
    cfg = tcfg(arch)
    # the port pads the heads of the GQA families; the others keep their
    # tp-1 tree (the rules read a leaf's path and rank, never its width)
    try:
        port = transformer.init_lm(cfg, device="meta", tp=tp)
    except NotImplementedError:
        port = transformer.init_lm(cfg, device="meta")
    return port, ref


@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_param_specs_equal_the_reference(arch, tp):
    port, ref = _params(arch, tp)
    mesh = _mesh(tp)
    for fsdp in (True, False):
        _equal(tsh.param_specs(port, tcfg(arch), mesh, fsdp=fsdp),
               jsh.param_specs(ref, jcfg(arch), mesh, fsdp=fsdp))


@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_cache_and_prefill_specs_equal_the_reference(arch, tp):
    mesh = _mesh(tp)
    ref = jax.eval_shape(lambda: jkv.init_cache(jcfg(arch), 4, 64, tp))
    port = tkv.init_cache(tcfg(arch), 4, 64, device="meta")
    for seq in (False, True):
        _equal(tsh.cache_specs(port, tcfg(arch), mesh, seq_shard=seq),
               jsh.cache_specs(ref, jcfg(arch), mesh, seq_shard=seq))
    one = jax.eval_shape(lambda: jkv.init_cache(jcfg(arch), 1, 48, tp,
                                                ring=False))
    _equal(tsh.prefill_cache_specs(
        tkv.init_cache(tcfg(arch), 1, 48, ring=False, device="meta"),
        tcfg(arch), mesh),
        jsh.prefill_cache_specs(one, jcfg(arch), mesh))


@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_pool_specs_and_shard_factor_equal_the_reference(arch, tp):
    mesh = _mesh(tp)
    jc, tc = jcfg(arch), tcfg(arch)
    assert tsh.kv_shard_factor(tc, mesh) == jsh.kv_shard_factor(jc, mesh)
    strip = jax.eval_shape(lambda: jkv.init_slot_pool(jc, 4, 64, tp))
    _equal(tsh.pool_specs(tkv.init_slot_pool(tc, 4, 64, device="meta"), tc,
                          mesh),
           jsh.pool_specs(strip, jc, mesh))
    if not tkv.supports_paging(tc):
        return
    paged = jax.eval_shape(lambda: jkv.init_paged_pool(jc, 4, 64, tp,
                                                       page_size=16))
    _equal(tsh.pool_specs(tkv.init_paged_pool(tc, 4, 64, page_size=16,
                                              device="meta"), tc, mesh),
           jsh.pool_specs(paged, jc, mesh))
    if tkv.supports_page_quant(tc):
        for gran in ("page", "page_head"):
            q = jax.eval_shape(lambda: jkv.init_paged_pool(
                jc, 4, 64, tp, page_size=16, page_dtype="int8",
                scale_granularity=gran))
            _equal(tsh.pool_specs(tkv.init_paged_pool(
                tc, 4, 64, page_size=16, page_dtype="int8",
                scale_granularity=gran, device="meta"), tc, mesh),
                jsh.pool_specs(q, jc, mesh))


@pytest.mark.parametrize("tp", TPS)
def test_batch_specs_equal_the_reference(tp):
    mesh = _mesh(tp)
    batch = {"tokens": torch.empty((8, 16), device="meta"),
             "one": torch.empty((1, 16), device="meta"),
             "scalar": torch.empty((), device="meta")}
    ref = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.int32)
           for k, v in batch.items()}
    _equal(tsh.batch_specs(batch, mesh), jsh.batch_specs(ref, mesh))


@pytest.mark.parametrize("size,parts", [(256, 2), (256, 3), (5, 3), (2, 4)])
def test_shard_bounds_cut_as_torch_chunk(size, parts):
    """A rank's rows are those ``torch.chunk`` gives it (empty past the
    end), and the shards tile the dim."""
    x = torch.arange(size)
    chunks = x.chunk(parts)
    for r in range(parts):
        lo, hi = tsh.shard_bounds(size, parts, r)
        want = chunks[r] if r < len(chunks) else x[:0]
        assert torch.equal(x[lo:hi], want)
