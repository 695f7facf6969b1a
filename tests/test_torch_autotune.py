"""The port's autotune cache and tuner (``repro_torch.kernels.registry`` /
``autotune``) on the CPU, held against the reference package's with the
same entries written to two temporary cache files: keys letter for
letter, write / reload / hit, overrides over the cache, a missing or
corrupt file, stale entries clamped, resolution at every point that
consults the cache (``block_shapes``, ``resolve_chunks``,
``resolve_page_size``, ``resolve_page_quant``) for the specs both
packages share, the sweep of every port op at tiny shapes, and a reduced
qwen2.5-14b paged engine served at a tuned page size against the JAX
engine.  Every cache here is a temporary file: no user's cache is read.

    PYTHONPATH=src python -m pytest tests/test_torch_autotune.py -q
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import SoftmaxPolicy as JPolicy
from repro.kernels import autotune as jtune
from repro.kernels import registry as jreg
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import SoftmaxPolicy
from repro_torch.kernels import autotune, registry
from repro_torch.kernels import decode_attention as tda
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.int8, torch.int8)]
SHARED_OPS = ("chunk_attention", "kv_page", "kv_page_quant")
SHAPES = [(1, 1), (2, 24), (7, 100), (8, 1664), (100, 3000), (2048, 2048),
          (4096, 4096), (8, 4096), (65536, 65536)]
ATTN_TOL = dict(atol=2e-5, rtol=0)           # tests/test_autotune_attention
LOSS_TOL = dict(atol=1e-5, rtol=0)           # tests/test_policy: CE
GRAD_TOL = dict(atol=5e-5, rtol=0)           # tests/test_policy: gradients


@pytest.fixture
def caches(tmp_path):
    """Two fresh cache files, the port's and the reference's; both
    memoised copies are dropped after the test."""
    t, j = str(tmp_path / "torch.json"), str(tmp_path / "jax.json")
    yield t, j
    for reg, p in ((registry, t), (jreg, j)):
        reg.load_cache(p, force=True)


def _record_both(t, j, op, rows, cols, dtypes, blocks):
    jdt, tdt = dtypes
    kt = registry.record_tuned(op, rows, cols, tdt, blocks, backend="cpu",
                               path=t)
    kj = jreg.record_tuned(op, rows, cols, jdt, blocks, backend="cpu",
                           path=j)
    assert kt == kj
    registry.load_cache(t, force=True)
    jreg.load_cache(j, force=True)


# ---------------------------------------------------------------------------
# Keys and the cache file.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16", "int8"])
def test_cache_key_equals_the_reference(dtypes, shards):
    jdt, tdt = dtypes
    ops = sorted(set(registry.registered_ops()) | set(jreg.registered_ops()))
    for op in ops:
        for rows, cols in SHAPES:
            for backend in ("cpu", "gpu"):
                want = jreg.cache_key(op, rows, cols, jdt, backend, shards)
                assert registry.cache_key(op, rows, cols, tdt, backend,
                                          shards) == want
                # names as the reference's keys carry them
                assert registry.cache_key(
                    op, rows, cols, registry.dtype_name(tdt), backend,
                    shards) == want
    assert registry.cache_key("kv_page", 1, 1664, torch.bfloat16, "gpu",
                              2) == "kv_page|r1|c2048|bfloat16|gpu|s2"


def test_backend_names():
    assert registry.backend_of("cpu") == "cpu"
    assert registry.backend_of(torch.device("cuda", 0)) == "gpu"
    assert registry.backend_of("meta") == registry.default_backend()
    assert registry.backend_of(None) == registry.default_backend()
    assert registry.default_backend() == (
        "gpu" if torch.cuda.is_available() else "cpu")


def test_write_reload_hit_as_the_reference(caches):
    t, j = caches
    _record_both(t, j, "chunk_attention", 4096, 4096, DTYPES[0],
                 (1024, 2048))
    with open(t) as f:
        tf = json.load(f)
    with open(j) as f:
        jf = json.load(f)
    assert tf == jf
    # a fresh process's view: memo dropped, the file reread
    registry._caches.pop(t)
    assert registry.lookup_tuned("chunk_attention", 3000, 4000,
                                 torch.float32, backend="cpu",
                                 path=t) == (1024, 2048)
    for rows, cols in ((4096, 4096), (3000, 2100), (4097, 4096)):
        got = registry.block_shapes("chunk_attention", rows, cols,
                                    use_cache=True, backend="cpu",
                                    cache_file=t)
        want = jreg.block_shapes("chunk_attention", rows, cols,
                                 use_cache=True, backend="cpu",
                                 cache_file=j)
        assert got == want
    # the other backend and dtype miss
    assert registry.lookup_tuned("chunk_attention", 4096, 4096,
                                 torch.float32, backend="gpu",
                                 path=t) is None
    assert registry.lookup_tuned("chunk_attention", 4096, 4096,
                                 torch.bfloat16, backend="cpu",
                                 path=t) is None
    # use_cache off: the heuristic
    assert registry.block_shapes("chunk_attention", 4096, 4096,
                                 backend="cpu", cache_file=t) == (2048, 2048)


def test_override_beats_the_cache(caches):
    t, j = caches
    _record_both(t, j, "kv_page_quant", 8, 1664, DTYPES[2], (8, 64))
    for kw in (dict(block_rows=1), dict(block_cols=32),
               dict(block_rows=1, block_cols=256)):
        got = registry.block_shapes("kv_page_quant", 8, 1664, torch.int8,
                                    use_cache=True, backend="cpu",
                                    cache_file=t, **kw)
        want = jreg.block_shapes("kv_page_quant", 8, 1664, jnp.int8,
                                 use_cache=True, backend="cpu",
                                 cache_file=j, **kw)
        assert got == want
        assert got[0] == kw.get("block_rows", 8)
        assert got[1] == kw.get("block_cols", 64)
    pol = SoftmaxPolicy(autotune=True, autotune_cache=t, attn_block_k=96)
    _record_both(t, j, "decode_attention", 8, 1664, DTYPES[1], (8, 64))
    assert pol.resolve_blocks("decode_attention", 8, 1664, torch.bfloat16,
                              backend="cpu") == (8, 96)


@pytest.mark.parametrize("content", [None, "{not json", "[1, 2]"],
                         ids=["missing", "corrupt", "not-a-dict"])
def test_missing_or_corrupt_file_gives_empty(tmp_path, content):
    p = str(tmp_path / "cache.json")
    if content is not None:
        with open(p, "w") as f:
            f.write(content)
    assert registry.load_cache(p, force=True) == {}
    assert registry.block_shapes("kv_page", 1, 1664, use_cache=True,
                                 backend="cpu", cache_file=p) == (1, 128)
    if content != "[1, 2]":
        assert jreg.load_cache(p, force=True) == {}
    registry.load_cache(p, force=True)


def test_stale_entries_clamped_to_envelope_and_width(caches):
    t, j = caches
    for op in SHARED_OPS:
        dt = DTYPES[2] if op == "kv_page_quant" else DTYPES[0]
        _record_both(t, j, op, 4096, 4096, dt, (1 << 16, 1 << 16))
        for rows, cols in ((4096, 4096), (3000, 2500)):
            got = registry.block_shapes(op, rows, cols, dt[1],
                                        use_cache=True, backend="cpu",
                                        cache_file=t)
            assert got == jreg.block_shapes(op, rows, cols, dt[0],
                                            use_cache=True, backend="cpu",
                                            cache_file=j)
            er, ec = registry.get_spec(op).envelope()
            spec = registry.get_spec(op)
            assert got == (min(er, registry.round_up(rows, spec.row_align)),
                           min(ec, registry.round_up(cols, spec.col_align)))
    # the port's own envelopes: the decode kernel's MAX_TILE, the LM-head
    # backward's scratch
    for op, ec in (("decode_attention", tda.MAX_TILE),
                   ("decode_attention_paged", tda.MAX_TILE),
                   ("lmhead_xent", 32768)):
        registry.record_tuned(op, 8, 1 << 20, torch.bfloat16,
                              (1 << 16, 1 << 20), backend="cpu", path=t)
        spec = registry.get_spec(op)
        assert registry.block_shapes(
            op, 8, 1 << 20, torch.bfloat16, use_cache=True, backend="cpu",
            cache_file=t) == (spec.envelope()[0] if op == "lmhead_xent"
                              else 8, ec)
        # a bucket neighbour narrower than the entry keeps its own width
        assert registry.block_shapes(
            op, 8, 600_000, torch.bfloat16, use_cache=True, backend="cpu",
            cache_file=t)[1] == ec


# ---------------------------------------------------------------------------
# Resolution equal to the reference's.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", SHARED_OPS)
@pytest.mark.parametrize("tuned", [False, True], ids=["heuristic", "tuned"])
def test_block_shapes_equal_the_reference(caches, op, tuned):
    t, j = caches
    jdt, tdt = DTYPES[2] if op == "kv_page_quant" else DTYPES[1]
    entries = {"chunk_attention": (512, 1024), "kv_page": (1, 32),
               "kv_page_quant": (8, 64)}
    if tuned:
        for rows, cols in SHAPES:
            _record_both(t, j, op, rows, cols, (jdt, tdt), entries[op])
    for rows, cols in SHAPES:
        for use_cache in (False, True):
            got = registry.block_shapes(op, rows, cols, tdt,
                                        use_cache=use_cache, backend="cpu",
                                        cache_file=t)
            want = jreg.block_shapes(op, rows, cols, jdt,
                                     use_cache=use_cache, backend="cpu",
                                     cache_file=j)
            assert got == want, (op, rows, cols, use_cache)
        assert registry.get_spec(op).heuristic_blocks(rows, cols) == \
            jreg.get_spec(op).heuristic_blocks(rows, cols)
    assert registry.candidate_blocks(op, 2048, 2048) == \
        jreg.candidate_blocks(op, 2048, 2048)


@pytest.mark.parametrize("tuned", [False, True], ids=["heuristic", "tuned"])
def test_resolve_chunks_equals_the_reference(caches, tuned):
    t, j = caches
    if tuned:
        for sq, skv, blk in ((4096, 1024, (2048, 1024)),
                             (65536, 65536, (256, 256)),
                             (512, 512, (256, 256))):
            _record_both(t, j, "chunk_attention", sq, skv, DTYPES[0], blk)
    for knobs in (dict(), dict(autotune=True), dict(attn_block_q=256),
                  dict(attn_block_q=256, attn_block_k=512, autotune=True)):
        tp = SoftmaxPolicy(autotune_cache=t, **knobs)
        jp = JPolicy(autotune_cache=j, **knobs)
        for sq, skv in ((256, 256), (512, 512), (4096, 1024), (512, 8192),
                        (4096, 4096), (65536, 65536), (10 ** 5, 10 ** 6)):
            assert tattn.resolve_chunks(sq, skv, tp, torch.float32, "cpu") \
                == jattn.resolve_chunks(sq, skv, jp, jnp.float32), \
                (knobs, sq, skv)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-20b"])
@pytest.mark.parametrize("autotune_on", [False, True], ids=["off", "on"])
def test_resolve_page_size_and_quant_equal_the_reference(caches, arch,
                                                         autotune_on):
    t, j = caches
    jm = jbuild(arch, reduced=True)
    knobs = dict(softmax_autotune=autotune_on)
    jcfg = dataclasses.replace(jm.cfg, softmax_autotune_cache=j, **knobs)
    tcfg = dataclasses.replace(
        tbuild(arch, reduced=True, device="cpu").cfg,
        softmax_autotune_cache=t, **knobs)
    jdt, tdt = DTYPES[0]                      # reduced configs are float32
    for max_len in (24, 48, 1664):
        _record_both(t, j, "kv_page", 1, max_len, (jdt, tdt), (1, 16))
        _record_both(t, j, "kv_page_quant", tcfg.n_kv_heads, max_len,
                     DTYPES[2], (8, 32))
    for max_len in (24, 48, 100, 1664, 5000):
        got = tkv.resolve_page_size(tcfg, max_len, device="cpu")
        assert got == jkv.resolve_page_size(jcfg, max_len)
        assert got == (16 if autotune_on and max_len != 100 and
                       max_len != 5000 else min(128, registry.round_up(
                           max_len, 16)))
        assert tkv.resolve_page_size(tcfg, max_len, 40) == 40
        for ps, gran in ((None, None), (64, None), (None, "page"),
                         (64, "page_head")):
            got = tkv.resolve_page_quant(tcfg, max_len, ps, gran,
                                         device="cpu")
            assert got == jkv.resolve_page_quant(jcfg, max_len, ps, gran)
    # a tuned row count clamps to the pool's own KV heads
    if autotune_on:
        assert tkv.resolve_page_quant(tcfg, 48, device="cpu") == (
            32, "page_head" if tcfg.n_kv_heads > 1 else "page")


def test_policy_autotune_runs_and_tune_persists(tmp_path):
    t = str(tmp_path / "tune.json")
    pol = SoftmaxPolicy(autotune=True, autotune_cache=t)
    cfg = dataclasses.replace(
        tbuild("qwen2.5-14b", reduced=True, device="cpu").cfg,
        softmax_autotune=True, softmax_autotune_cache=t)
    assert cfg.softmax_policy() == pol
    res = pol.tune("decode_attention", 4, 100, torch.float32,
                   candidates=[(4, 16), (4, 32)], reps=1, min_time_s=0.001,
                   device="cpu")
    assert res.cache_key == "decode_attention|r4|c128|float32|cpu"
    # the heuristic's block is always timed beside the candidates given
    assert set(res.timings) == {(4, 16), (4, 32), (4, 112)}
    assert res.best in res.timings
    registry.load_cache(t, force=True)
    assert pol.resolve_blocks("decode_attention", 4, 100, torch.float32,
                              backend="cpu") == res.best
    assert SoftmaxPolicy(autotune_cache=t).resolve_blocks(
        "decode_attention", 4, 100, torch.float32,
        backend="cpu") == (4, 112)
    registry.load_cache(t, force=True)


# ---------------------------------------------------------------------------
# The tuner.
# ---------------------------------------------------------------------------
# (rows, cols, dtype, candidates or None = the tuner's own) at tiny shapes
SWEEPS = {
    "decode_attention": (4, 100, torch.float32, None),
    "decode_attention_paged": (3, 300, torch.float32, None),
    "kv_page": (1, 100, torch.float32, None),
    "kv_page_quant": (2, 100, torch.int8, None),
    "chunk_attention": (300, 600, torch.float32, None),
    "flash_attention": (64, 160, torch.float32, None),
    "flash_attention_bwd": (64, 160, torch.float32, None),
    "lmhead_xent": (16, 600, torch.float32,
                    [(128, 128), (128, 256), (128, 640)]),
}


def _close(op, got, want):
    if op == "lmhead_xent":
        for g, w, tol in zip(got, want, (LOSS_TOL, GRAD_TOL, GRAD_TOL)):
            torch.testing.assert_close(g, w, **tol)
    elif isinstance(got, tuple):
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), **ATTN_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)


def test_every_port_op_has_a_sweep():
    assert set(SWEEPS) == set(registry.registered_ops())


@pytest.mark.parametrize("op", sorted(SWEEPS))
def test_autotune_op_best_persisted_and_every_candidate_close(tmp_path, op):
    rows, cols, dt, cands = SWEEPS[op]
    t = str(tmp_path / "tune.json")
    res = autotune.autotune_op(op, rows, cols, dt, candidates=cands, reps=1,
                               min_time_s=0.001, cache_file=t, device="cpu")
    assert res.refused == {}
    assert len(res.timings) >= 2
    assert res.best in res.timings
    assert res.best_s == min(res.timings.values())
    assert res.default == registry.get_spec(op).heuristic_blocks(rows, cols)
    assert res.default in res.timings
    assert res.dtype == registry.dtype_name(dt)
    with open(t) as f:
        entry = json.load(f)[res.cache_key]
    assert (entry["block_rows"], entry["block_cols"]) == res.best
    assert res.cache_key == registry.cache_key(op, rows, cols, dt, "cpu")
    registry.load_cache(t, force=True)
    hit = registry.block_shapes(op, rows, cols, dt, use_cache=True,
                                backend="cpu", cache_file=t)
    spec = registry.get_spec(op)
    er, ec = spec.envelope()
    assert hit == (min(res.best[0], er,
                       registry.round_up(rows, spec.row_align)),
                   min(res.best[1], ec,
                       registry.round_up(cols, spec.col_align)))
    x = autotune._inputs_for(op, rows, cols, dt, torch.device("cpu"))
    run = autotune._runner_for(op)
    want = run(x, *res.default)
    for blocks in res.timings:
        _close(op, run(x, *blocks), want)
    registry.load_cache(t, force=True)


def test_paged_candidates_are_whole_pages_within_the_kernel():
    """The paged op's candidates are whole pages of the proxy page size;
    a candidate past the kernel's tile or page count is refused before
    anything runs."""
    x = autotune._inputs_for("decode_attention_paged", 8, 4096,
                             torch.float32, torch.device("cpu"))
    ps = autotune.ATTN_PAGE_SIZE
    cands = autotune._candidates("decode_attention_paged", 8, 4096, x,
                                 torch.device("cpu"))
    assert cands and all(bc % ps == 0 for _, bc in cands)
    assert max(bc for _, bc in cands) <= tda.MAX_TILE
    refuse = autotune._refusal
    assert refuse("decode_attention_paged", 8, 2 * tda.MAX_TILE, x)
    assert refuse("decode_attention_paged", 8, 96, x)        # 1.5 pages
    assert registry.get_spec("decode_attention").envelope()[1] == \
        registry.get_spec("decode_attention_paged").envelope()[1] == \
        tda.MAX_TILE
    assert refuse("decode_attention", 8, tda.MAX_TILE + 16, x)
    assert refuse("decode_attention", 8, 24, x)              # off the grid
    assert refuse("decode_attention_paged", 8, 128, x) is None
    # 16-token pages: 256 positions are 16 pages, past MAX_PAGES_PER_TILE
    y = (x[0], x[1][:, :16], x[2][:, :16], x[3], x[4])
    assert "MAX_PAGES_PER_TILE" in refuse("decode_attention_paged", 8, 256,
                                          y)
    assert refuse("decode_attention_paged", 8, 128, y) is None


def test_refused_candidates_time_nothing(tmp_path, monkeypatch):
    """Candidates past the kernel's tile, not whole pages, or past the
    envelope are refused and never run; with every candidate refused (the
    heuristic's 128 positions are no whole number of 48-token pages) the
    sweep raises before running anything."""
    calls = []
    real = autotune._runner_for

    def counting(op):
        run = real(op)

        def wrapped(x, br, bc):
            calls.append((br, bc))
            return run(x, br, bc)
        return wrapped

    monkeypatch.setattr(autotune, "_runner_for", counting)
    t = str(tmp_path / "tune.json")
    too_wide = [(8, 2 * tda.MAX_TILE), (8, 96), (8, 4096)]
    res = autotune.autotune_op("decode_attention_paged", 8, 4096,
                               torch.float32, candidates=too_wide, reps=1,
                               min_time_s=0.001, cache_file=t, device="cpu")
    assert set(res.refused) == set(too_wide)
    assert set(res.timings) == {res.default} == {(8, 128)}
    assert set(calls) == {(8, 128)}
    calls.clear()
    x = autotune._inputs_for("decode_attention_paged", 8, 1024,
                             torch.float32, torch.device("cpu"))
    pages48 = (x[0], x[1][:, :48], x[2][:, :48], x[3], x[4])
    monkeypatch.setattr(autotune, "_inputs_for", lambda *a: pages48)
    with pytest.raises(ValueError, match="no viable block candidate"):
        autotune.autotune_op("decode_attention_paged", 8, 1024,
                             torch.float32, candidates=[(8, 64)], reps=1,
                             min_time_s=0.001, cache_file=t, device="cpu")
    assert calls == []
    registry.load_cache(t, force=True)


def test_default_sweep_is_the_reference_minus_the_untiled_ops():
    ref = [row for row in jtune.DEFAULT_SWEEP
           if row[0] not in ("softmax", "logsumexp", "xent")]
    assert list(autotune.DEFAULT_SWEEP) == ref
    assert {op for op, _, _ in jtune.DEFAULT_SWEEP} - {
        op for op, _, _ in autotune.DEFAULT_SWEEP} == {"softmax", "xent"}


@pytest.mark.parametrize("op", ["softmax", "logsumexp", "xent"])
def test_untiled_ops_raise(op):
    assert op not in registry.registered_ops()
    with pytest.raises(ValueError, match="takes no tile"):
        autotune.autotune_op(op, 8, 256, device="cpu")
    with pytest.raises(SystemExit):
        autotune.main(["--op", op, "--device", "cpu"])


def test_unknown_op_raises():
    with pytest.raises(ValueError):
        autotune._runner_for("not_an_op")
    with pytest.raises(KeyError):
        registry.get_spec("not_an_op")


def test_the_port_keeps_its_own_cache_file(tmp_path, monkeypatch):
    assert registry.DEFAULT_CACHE_ENV == "REPRO_TORCH_AUTOTUNE_CACHE"
    assert registry.DEFAULT_CACHE_ENV != jreg.DEFAULT_CACHE_ENV
    assert registry.DEFAULT_CACHE_FILE != jreg.DEFAULT_CACHE_FILE
    assert registry.DEFAULT_CACHE_FILE.endswith(
        "/.cache/repro_torch/autotune.json")
    monkeypatch.delenv(jreg.DEFAULT_CACHE_ENV, raising=False)
    monkeypatch.delenv(registry.DEFAULT_CACHE_ENV, raising=False)
    assert registry.cache_path() == registry.DEFAULT_CACHE_FILE
    p = str(tmp_path / "env.json")
    monkeypatch.setenv(jreg.DEFAULT_CACHE_ENV, p)
    assert registry.cache_path() == registry.DEFAULT_CACHE_FILE
    monkeypatch.setenv(registry.DEFAULT_CACHE_ENV, p)
    assert registry.cache_path() == p
    assert registry.cache_path("x.json") == "x.json"


def test_cli_sweeps_into_the_cache_given(tmp_path, capsys):
    t = str(tmp_path / "cli.json")
    autotune.main(["--op", "kv_page", "--rows", "1", "--cols", "64",
                   "--cache", t, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "kv_page 1x64 float32: best=" in out and f"cache: {t}" in out
    with open(t) as f:
        assert list(json.load(f)) == ["kv_page|r1|c64|float32|cpu"]
    registry.load_cache(t, force=True)


# ---------------------------------------------------------------------------
# A reduced engine served from a tuned cache, against the JAX engine.
# ---------------------------------------------------------------------------
ARCH = "qwen2.5-14b"
MAX_LEN = 48


@pytest.fixture(scope="module")
def weights():
    jm = jbuild(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(ARCH, reduced=True, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("page_dtype", [None, "int8"], ids=["f32", "int8"])
def test_tuned_engine_tokens_equal_the_jax_engine(weights, tmp_path,
                                                  page_dtype):
    """Both packages' configs opt in, each cache holds the same entries (a
    16-token page, int8 pages of 32 with per-head scales, and a decode tile
    of 32): the engines resolve the tuned layout, not the heuristic's
    48-token page, and give equal greedy tokens."""
    jm, jp, tm, tp = weights
    t, j = str(tmp_path / "torch.json"), str(tmp_path / "jax.json")
    _record_both(t, j, "kv_page", 1, MAX_LEN, DTYPES[0], (1, 16))
    _record_both(t, j, "kv_page_quant", tm.cfg.n_kv_heads, MAX_LEN,
                 DTYPES[2], (8, 32))
    _record_both(t, j, "decode_attention_paged", 2, MAX_LEN, DTYPES[0],
                 (2, 32))
    knobs = dict(softmax_autotune=True)
    jmod = jbuild(ARCH, reduced=True, softmax_autotune_cache=j, **knobs)
    tmod = tbuild(ARCH, reduced=True, device="cpu",
                  softmax_autotune_cache=t, **knobs)
    rng = np.random.default_rng(5)
    prompts = [tuple(int(x) for x in rng.integers(1, tm.cfg.vocab, n))
               for n in (3, 17, 9, 30, 5)]
    kw = dict(slots=2, max_len=MAX_LEN, temperature=0.0, seed=1,
              page_dtype=page_dtype)
    je = jsched.ContinuousBatchingEngine(jmod, jp, **kw)
    te = ContinuousBatchingEngine(tmod, tp, **kw)
    want_ps = 32 if page_dtype else 16
    assert te.page_size == je.page_size == want_ps
    if page_dtype:
        assert te.scale_granularity == je.scale_granularity == "page_head"
    assert te.pool["kv"]["k"].shape[2] == want_ps
    want = je.run([jsched.Request(rid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    got = te.run([Request(rid=i, prompt=p, max_new_tokens=6)
                  for i, p in enumerate(prompts)])
    assert [list(c.tokens) for c in got] == [list(c.tokens) for c in want]
    # the heuristic engine resolves another page: the cache was what moved it
    assert ContinuousBatchingEngine(tm, tp, **kw).page_size == 48
    for reg, p in ((registry, t), (jreg, j)):
        reg.load_cache(p, force=True)
