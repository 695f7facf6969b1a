"""Tensor-parallel serving over a ``('data', 'model')`` mesh of ``gloo``
ranks on the CPU (ROADMAP item 22, its serving half).

Reduced qwen2.5-14b, float32, the paged pool with the prefix cache on, the
reference's sharded-serving prompts (``tests/test_sharded_serving.py``,
whose mesh lanes fail under the installed jax): greedy tokens over meshes
1x2, 2x2 and 1x3 equal the port's single-process engine's and the JAX
single-device engine's on the same weights.  1x3 pads the 4 q-heads to 6
and replicates the 2 KV heads (the ungrouped layout: a prefill expands
K/V per q-head, a decode regroups the q-heads over the arena); 1x2 and
2x2 split both (grouped).  The row-parallel sums run in
another order than one product, so this holds the port's claim that
sharding changes no token at these sizes, as the reference's tests claim
it with ``==``.

Ranks are spawned processes (``tests/_torch_ranks.py``); each mesh runs
once for the module."""

import dataclasses

import jax
import numpy as np
import pytest

from _torch_ranks import cli_worker, run_ranks, serve_worker
from repro.models import build_model as jbuild
from repro.serving import scheduler as jsched
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import Mesh, make_serving_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.serving.scheduler import Request

ARCH = dict(arch="qwen2.5-14b", reduced=True)
ENGINE = dict(slots=3, max_len=64, temperature=0.0, seed=2, page_size=8)
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x3": (1, 3)}
EXTRAS = {"1x2": ("budget", "fused", "sampled"), "2x2": ("budget",),
          "1x3": ()}


def _prompts():
    rng = np.random.default_rng(0)
    prompts = [tuple(rng.integers(1, 100, size=rng.integers(4, 14)).tolist())
               for _ in range(6)]
    prompts[3] = prompts[0][:8] + (55, 56)   # a shared-prefix pair
    return prompts


@pytest.fixture(scope="module")
def reference():
    """Per tp: the reference's parameters at tp (numpy), the JAX
    single-device engine's tokens, and the port's single-process tokens
    on the same weights."""
    out = {}
    for tp in (2, 3):
        jm = jbuild(ARCH["arch"], tp=tp, reduced=True)
        jp = jm.init(jax.random.PRNGKey(0))
        eng = jsched.ContinuousBatchingEngine(jm, jp, **ENGINE)
        jtok = [tuple(c.tokens) for c in eng.run(
            [jsched.Request(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(_prompts())])]
        params = jax.tree.map(np.asarray, jp)
        tm = tbuild(device="cpu", tp=tp, **ARCH)
        tp_params = params_from_jax(params, tm.cfg, "cpu")
        teng = tm.serving_engine(tp_params, **ENGINE)
        ttok = [tuple(c.tokens) for c in teng.run(
            [Request(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(_prompts())])]
        sampled = [tuple(c.tokens) for c in tm.serving_engine(
            tp_params, **dict(ENGINE, temperature=0.8)).run(
                [Request(rid=i, prompt=p, max_new_tokens=6)
                 for i, p in enumerate(_prompts())])]
        out[tp] = dict(params=params, jax=jtok, port=ttok, sampled=sampled,
                       model=tm, torch_params=tp_params,
                       hits=teng.stats["prefix_hits"])
    return out


@pytest.fixture(scope="module")
def meshes(reference, tmp_path_factory):
    """Each mesh's rank-0 result, run once."""
    cache = {}

    def get(name):
        if name not in cache:
            shape = MESHES[name]
            cache[name] = run_ranks(
                serve_worker, shape[0] * shape[1],
                tmp_path_factory.mktemp(f"mesh{name}"), shape,
                reference[shape[1]]["params"], ARCH, _prompts(), ENGINE,
                EXTRAS[name])
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_tokens_equal_the_single_device_engines(reference, meshes,
                                                     name):
    ref = reference[MESHES[name][1]]
    assert ref["port"] == ref["jax"]
    for rank, res in enumerate(meshes(name)):
        assert res["tokens"] == ref["port"], rank


@pytest.mark.parametrize("name", list(MESHES))
def test_each_rank_holds_its_shard(meshes, name):
    """The arena keeps Hkv / tp KV heads where they divide (2 of 2 at tp
    2: one a rank), all of them where they do not (tp 3: KV replicated);
    the q-heads split (4 at tp 2, 4 padded to 6 at tp 3), the vocabulary
    of 256 rows splits as ``torch.chunk``; the prefix cache hit and its
    refcounts stay consistent."""
    tp = MESHES[name][1]
    res = meshes(name)[0]
    hd = 16
    assert res["arena"][3] == (1 if tp == 2 else 2)
    assert res["wq"][2] == (4 // tp if tp == 2 else 2) * hd
    assert res["embed"][0] == (128 if tp == 2 else 86)
    free_cached, usable = res["free_and_cached"]
    assert free_cached == usable
    assert res["throughput"]["prefix_hits"] > 0


@pytest.mark.parametrize("name", list(MESHES))
def test_throughput_reports_the_mesh(meshes, name):
    d, m = MESHES[name]
    th = meshes(name)[0]["throughput"]
    assert th["mesh_axes"] == {"data": d, "model": m}
    assert th["kv_shards"] == (2 if m == 2 else 1)
    assert th["backend"] == "gloo" and th["fused"] is False


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_rank_budget_buys_kv_shards_times_the_pages(meshes, name):
    """A rank's budget buys the pages whose arena share it holds: each
    rank stores one of the 2 KV heads, so twice the pages but for the
    tables, which every rank holds whole (page 0 is the trash page)."""
    plain, sharded = meshes(name)[0]["budget_pages"]
    assert sharded > plain
    assert 2 * (plain + 1) - 2 <= sharded + 1 <= 2 * (plain + 1)


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_rank_pool_stays_within_its_budget(meshes, name):
    """The pool a rank allocates (at its KV heads, never whole) fits its
    ``memory_budget_bytes``, and one page more would not."""
    budget, held, one_more = meshes(name)[0]["budget_bytes"]
    assert held <= budget < one_more


def test_fused_step_under_gloo_raises(meshes):
    err = meshes("1x2")[0]["fused_error"]
    assert "gloo" in err and "captured" in err


def test_sampled_tokens_under_the_mesh_equal_the_single_process(reference,
                                                                meshes):
    """temperature 0.8: the sharded two-pass softmax and the race over the
    ranks' columns of one draw give the single process's tokens."""
    assert meshes("1x2")[0]["sampled"] == reference[2]["sampled"]


def test_one_by_one_mesh_gives_the_no_mesh_tokens(reference):
    ref = reference[2]
    mesh = make_serving_mesh((1, 1), backend="gloo")
    eng = ref["model"].serving_engine(ref["torch_params"], mesh=mesh,
                                      **ENGINE)
    toks = [tuple(c.tokens) for c in eng.run(
        [Request(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(_prompts())])]
    assert toks == ref["port"]
    assert eng.throughput()["mesh_axes"] == {"data": 1, "model": 1}
    assert eng.stats["prefix_hits"] == ref["hits"] > 0


@pytest.mark.parametrize("what,item", [
    (dict(arch="rwkv6-1.6b"), 35), (dict(arch="deepseek-v2-lite-16b"), 35),
    (dict(arch="qwen2.5-14b", n_kv_heads=1), 35),
    (dict(arch="qwen2.5-14b", decode_seq_parallel=True), 34)],
    ids=["ssm", "mla", "mqa", "seq-parallel"])
def test_unserved_cases_under_a_mesh_name_their_item(what, item):
    # the refusals come before any collective: a mesh of two model ranks
    # needs no process group to be refused
    mesh = Mesh(("data", "model"), np.arange(2).reshape(1, 2), "gloo")
    what = dict(what)
    m = tbuild(what.pop("arch"), reduced=True, device="cpu")
    if what:
        m.cfg = dataclasses.replace(m.cfg, **what)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        m.serving_engine(m.init_shape(), mesh=mesh, slots=2, max_len=32)


CLI = ["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu",
       "--requests", "3", "--slots", "2", "--prompt-len", "12", "--steps",
       "4", "--temperature", "0"]


def test_cli_serves_over_a_mesh_of_ranks(tmp_path):
    """``--mesh 1x2 --backend gloo`` under two ranks: rank 0 prints the
    mesh, the eager step and the sharded arena; the other rank prints
    nothing; both serve the three requests."""
    out = run_ranks(cli_worker, 2, tmp_path,
                    CLI + ["--mesh", "1x2", "--backend", "gloo"])
    assert "mesh: 1x2" in out[0] and "eager decode step" in out[0]
    assert "served 3 requests over 2 slots" in out[0]
    assert "KV heads in 2 shard(s) (1: replicated), backend gloo" in out[0]
    assert "decode:  9 tok" in out[0]
    assert out[1] == ""


@pytest.mark.parametrize("flags,says", [
    (["--mesh", "1x2"], "needs --backend"),
    (["--mesh", "1x2", "--backend", "gloo"], "torchrun --nproc-per-node 2"),
    (["--mesh", "2"], "expected DATAxMODEL"),
    (["--backend", "gloo"], "only with --mesh")],
    ids=["no-backend", "no-ranks", "bad-shape", "backend-alone"])
def test_cli_mesh_flags_are_checked_before_any_rank_joins(flags, says,
                                                         capsys,
                                                         monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        serve.main(CLI + flags)
    assert e.value.code == 2
    assert says in capsys.readouterr().err


def test_params_for_rank_cuts_the_references_tree(reference):
    """``convert.params_for_rank``: the reference's tp-2 tree carried
    across and cut for rank 0 of a 1x2 mesh (a mesh object that never
    joined a group reads as rank 0): the q-heads, KV heads, MLP columns
    and vocabulary rows of its half, the row-parallel rows likewise, the
    norms whole."""
    import torch

    from repro_torch.convert import params_for_rank

    ref = reference[2]
    cfg = ref["model"].cfg
    mesh = Mesh(("data", "model"), np.arange(2).reshape(1, 2), "gloo")
    got = params_for_rank(ref["params"], cfg, mesh, "cpu")
    full = ref["torch_params"]
    b, fb = got["blocks"], full["blocks"]
    assert torch.equal(b["attn"]["wq"]["w"], fb["attn"]["wq"]["w"][..., :32])
    assert torch.equal(b["attn"]["wq"]["b"], fb["attn"]["wq"]["b"][..., :32])
    assert torch.equal(b["attn"]["wk"]["w"], fb["attn"]["wk"]["w"][..., :16])
    assert torch.equal(b["attn"]["wo"]["w"], fb["attn"]["wo"]["w"][:, :32])
    assert torch.equal(b["mlp"]["down"]["w"], fb["mlp"]["down"]["w"][:, :64])
    assert torch.equal(b["mlp"]["up"]["w"], fb["mlp"]["up"]["w"][..., :64])
    assert torch.equal(got["embed"]["table"], full["embed"]["table"][:128])
    assert torch.equal(got["lm_head"]["w"], full["lm_head"]["w"][:, :128])
    assert torch.equal(b["ln1"]["scale"], fb["ln1"]["scale"])


@pytest.mark.parametrize("rank,want", [(0, (0, 3, 5)), (1, (2, 4, 5)),
                                       (2, (5, 3, 7))])
def test_ungrouped_decode_regroups_each_ranks_q_heads(rank, want):
    """qwen2.5-14b at tp 3: 40 q-heads padded to 42, 14 a rank, over 8
    replicated KV heads.  A rank's decode reads the run of KV heads its
    q-heads use (first, count) with ``g`` q rows each, zero rows where a
    KV head has fewer; regrouping and ungrouping give back every q-head."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import attention

    lay = attention._local_layout(get_config("qwen2.5-14b"), 3, 3, rank,
                                  torch.device("cpu"))
    assert (lay.hq, lay.grouped, lay.hkv) == (14, False, 8)
    assert (lay.kv0, lay.nkv, lay.g) == want
    q = torch.randn(2, lay.hq, 16)
    rows = attention._regroup(q, lay)
    assert rows.shape == (2, lay.nkv, lay.g, 16)
    h2k = lay.h2k.tolist()
    for h in range(lay.hq):
        kv, slot = divmod(int(lay.o_rows[h]), lay.g)
        assert kv + lay.kv0 == h2k[h]
        assert torch.equal(rows[:, kv, slot], q[:, h])
    assert int((rows.abs().sum(-1) == 0).sum()) == 2 * (
        lay.nkv * lay.g - lay.hq)
    assert torch.equal(attention._ungroup(rows, lay),
                       q.reshape(2, lay.hq * 16))


def test_ungrouped_decode_reads_the_arena_in_place(reference, monkeypatch):
    """Ungrouped (tp 3 padding, 2 KV heads): every decode step hands the
    paged op views of the arena's own storage, never an expanded copy, and
    the tokens stay the port's."""
    from repro_torch.kernels import ops as kernel_ops

    ref = reference[3]
    eng = ref["model"].serving_engine(ref["torch_params"], **ENGINE)
    arena = eng.pool["kv"]["k"]
    real = kernel_ops.decode_attention_paged
    seen = []

    def spy(q, k_pages, v_pages, *a, **kw):
        seen.append((q.shape[1:3], k_pages.untyped_storage().data_ptr()))
        return real(q, k_pages, v_pages, *a, **kw)

    monkeypatch.setattr(kernel_ops, "decode_attention_paged", spy)
    toks = [tuple(c.tokens) for c in eng.run(
        [Request(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(_prompts())])]
    assert toks == ref["port"]
    assert seen and all(s == ((2, 4), arena.untyped_storage().data_ptr())
                        for s in seen)
