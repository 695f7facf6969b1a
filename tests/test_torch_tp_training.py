"""Tensor-parallel training over a ``('data', 'model')`` mesh of ``gloo``
ranks on the CPU (ROADMAP item 22, its training half), against the JAX
package.  The data axis and elastic restore:
tests/test_torch_fsdp_training.py.

Reduced qwen2.5-14b, float32, 3 AdamW steps through ``Trainer.run`` over
meshes 1x2 (2 q-heads and 1 KV head a rank) and 1x3 (4 q-heads padded to
6, the 2 KV heads replicated), kernels on (their plain versions here: the
flash route and the vocab-parallel fused LM-head CE) and off (the
vocab-parallel CE over materialised logits), from the reference's weights
carried through numpy.  The losses, grad norms and final parameters are
held against the reference's single-device jitted ``make_train_step`` on
the same global batches, 1x3 against ``Model(cfg, tp=3)``: a padded
head's ``wo`` rows take a gradient (a zero query attends uniformly, so its
output is the mean of v), so a padded model leaves the unpadded one after
its first update, in the reference as in the port.  Each rank's gradients
are held against the single process's cut to its shard; the CE op against
the single-rank plain forms; one loss's collectives are counted.  Each
mesh's ranks are spawned once (``tests/_torch_ranks.py``)."""

import functools
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks, train_worker
from repro.configs import ARCH_IDS
from repro.configs.base import ShapeCell as JShapeCell
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.distributed import sharding as jsh
from repro.models import build_model as jbuild
from repro.optim import schedules as jsched
from repro.training import step_fn as jstep
from repro.training import train_state as jstate
from repro_torch.configs import get_config as tcfg
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model, transformer
from repro_torch.training import step_fn, train_state

ARCH = "qwen2.5-14b"
CELL = (32, 8)                # seq_len, global batch
LR = 5e-3
STEPS = 3
MESHES = {"1x2": (1, 2), "1x3": (1, 3)}


# Tolerances.  tests/test_torch_training.py holds one AdamW update at rtol
# 1e-6.  A mesh changes only the order of float32 sums: a row-parallel
# product, the gradients' sums over the data ranks, the (m, n) fold and
# the global norm each add up to tp + data partials where one device adds
# one, every partial a rounding of at most 2^-24 of the total, over STEPS
# steps.  The losses and grad norms are held at that.
def rtol(shape) -> float:
    return 1e-6 + STEPS * (shape[0] + shape[1]) * 2.0 ** -24


# The parameters: AdamW's first update is lr * g / (|g| + eps), about lr *
# sign(g), so rounding passes into it only where g cancels to near zero,
# and moves such an element by a part of lr; an element is held at
# 2^-5 lr a step.  ``attn/wk/b`` is left to its bound: its exact gradient
# is zero (shifting every key by one vector leaves each softmax as it
# was), so both sides step on rounding noise, at most lr a step.
def param_atol(path: str) -> float:
    return (2 * LR * STEPS if path.endswith("attn/wk/b")
            else 2.0 ** -5 * LR * STEPS)


def jax_run(tp):
    """The reference's single-device jitted step, ``STEPS`` steps at the
    Trainer's schedule (warmup_cosine without warm-up): numpy initial and
    final parameters, the losses and grad norms."""
    jm = jbuild(ARCH, reduced=True, tp=tp)
    params = jm.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    state = jstate.init_state(params)
    ds = JSyntheticLM(jm.cfg, JShapeCell("t", *CELL, "train"), seed=0)
    step = jax.jit(jstep.make_train_step(jm, lr_schedule=functools.partial(
        jsched.warmup_cosine, peak_lr=LR, warmup=0, total=STEPS)))
    losses, norms = [], []
    for i in range(STEPS):
        state, met = step(state, ds.batch_at(i))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return dict(init=init, losses=losses, norms=norms,
                final=jax.tree.map(np.asarray, state.params))


def single_grads(tp, params, kernels):
    """The port's single-process gradients of batch 0, numpy, by path."""
    m = build_model(ARCH, reduced=True, device="cpu", tp=tp,
                    use_kernels=kernels)
    ds = SyntheticLM(m.cfg, ShapeCell("t", *CELL, "train"), seed=0)
    _, g = step_fn.loss_and_grads(m, params_from_jax(params, m.cfg, "cpu"),
                                  {"tokens": torch.from_numpy(
                                      ds.batch_at(0)["tokens"])})
    return {p: x.numpy() for p, x in sharding.flatten(g)}


def plan_for(shape):
    """The FSDP plan of reduced qwen over a ``shape`` mesh."""
    m = build_model(ARCH, reduced=True, device="cpu", tp=shape[1])
    return sharding.fsdp_plan(m.init_shape(), sharding.param_specs(
        m.init_shape(), m.cfg, stub(shape)))


def stub(shape):
    """What the rule tables read of a mesh."""
    return SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty(shape))


def coords_mesh(shape, coords) -> Mesh:
    """A mesh's coordinates without a process group: what the cuts read."""
    return Mesh(("data", "model"), np.arange(int(np.prod(shape))).reshape(
        shape), "gloo", {a: (None, c) for a, c in zip(("data", "model"),
                                                       coords)})


def jflat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def check_steps(ranks, ref, shape, kernels):
    """Every rank's losses and grad norms, and the final parameters
    gathered on rank 0 (and on no other rank), against the reference's
    run."""
    for res in ranks:
        got = res[kernels]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=rtol(shape))
        np.testing.assert_allclose(got["norms"], ref["norms"],
                                   rtol=rtol(shape))
    for res in ranks[1:]:
        assert all(p is None for _, p in
                   sharding.flatten(res[kernels]["params"]))
    want, init = jflat(ref["final"]), jflat(ref["init"])
    got = dict(sharding.flatten(ranks[0][kernels]["params"]))
    assert got.keys() == want.keys()
    for path, p in got.items():
        np.testing.assert_allclose(p, want[path], rtol=rtol(shape),
                                   atol=param_atol(path), err_msg=path)
        assert np.abs(p - init[path]).max() > 0, path       # it trained


def check_grads(ranks, single, shape, kernels, plan):
    """Each rank's gradient of every leaf equals the single process's cut
    to the rank's shard: whole on every rank where the leaf is
    replicated (summed once, not once a rank), the rank's part where it
    is cut."""
    specs = {p: e[0] for p, e in sharding.flatten(plan)}
    for res in ranks:
        mesh = coords_mesh(shape, res["coords"])
        got = dict(sharding.flatten(res[kernels]["grads"]))
        assert got.keys() == specs.keys()
        for path, g in got.items():
            want = sharding.local_shard(single[path], specs[path], mesh,
                                        ("model", "data"))
            np.testing.assert_allclose(
                g, want, rtol=1e-5, atol=1e-6 * np.abs(single[path]).max(),
                err_msg=f"{path} at {res['coords']}")


def check_shards(ranks, plan, shape):
    """Each leaf of a rank's state is its ``param_specs(fsdp=True)`` cut of
    the full leaf, and ``Model.init_shard`` draws exactly the cut of
    ``Model.init``."""
    for res in ranks:
        mesh = coords_mesh(shape, res["coords"])
        shapes = dict(sharding.flatten(res[False]["shapes"]))
        assert shapes.keys() == dict(sharding.flatten(plan)).keys()
        for path, (spec, full) in sharding.flatten(plan):
            want = sharding.local_shard(np.empty(full), spec, mesh,
                                        ("model", "data")).shape
            assert shapes[path] == want, path
        assert {p: s for p, s, _ in res["init_equal"]} == shapes
        assert all(eq for _, _, eq in res["init_equal"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs at tp 1 and 3, the port's single-process
    gradients, and each mesh's ranks, run once for the module."""
    out = {}
    for name, shape in MESHES.items():
        tp = shape[1]
        ref = jax_run(3 if tp == 3 else 1)
        out[name] = dict(
            ref=ref, single={k: single_grads(tp, ref["init"], k)
                             for k in (False, True)},
            plan=plan_for(shape),
            ranks=run_ranks(train_worker, shape[0] * shape[1],
                            tmp_path_factory.mktemp(f"tp{name}"), shape,
                            ref["init"], CELL, STEPS, LR, ["init", "ce"]))
    return out


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_steps_equal_the_reference_single_device(runs, name, kernels):
    r = runs[name]
    check_steps(r["ranks"], r["ref"], MESHES[name], kernels)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", list(MESHES))
def test_rank_gradients_are_the_single_process_cut(runs, name, kernels):
    r = runs[name]
    check_grads(r["ranks"], r["single"][kernels], MESHES[name], kernels,
                r["plan"])


@pytest.mark.parametrize("name", list(MESHES))
def test_each_rank_holds_its_cut_of_the_state(runs, name):
    r = runs[name]
    check_shards(r["ranks"], r["plan"], MESHES[name])


def test_padded_heads_train_in_the_reference_and_on_the_mesh(runs):
    """1x3 pads 4 q-heads to 6 with zero weights.  A padded head's zero
    query attends uniformly, so its output is the mean of v and its
    ``wo`` rows take a gradient: after 3 steps they are no longer zero in
    the reference's single-device ``Model(cfg, tp=3)``, nor on the mesh,
    which is why 1x3 is held against the padded reference and not the
    unpadded model."""
    from repro_torch.models import attention

    cfg = build_model(ARCH, reduced=True, device="cpu", tp=3).cfg
    _, _, mask, _ = attention.head_layout(cfg, 3)
    hd = cfg.resolved_head_dim()
    padded = np.repeat(~np.asarray(mask), hd)
    r = runs["1x3"]
    init = jflat(r["ref"]["init"])["blocks/attn/wo/w"]
    assert not init[:, padded].any()
    want = jflat(r["ref"]["final"])["blocks/attn/wo/w"]
    got = dict(sharding.flatten(r["ranks"][0][False]["params"]))[
        "blocks/attn/wo/w"]
    assert np.abs(want[:, padded]).max() > 0
    assert np.abs(got[:, padded]).max() > 0


@pytest.mark.parametrize("route", ["fused", "logits"])
@pytest.mark.parametrize("name", list(MESHES))
def test_vocab_parallel_ce_equals_the_single_rank_plain_forms(runs, name,
                                                              route):
    """Loss, dh (summed over the model axis by ``copy_to_model``) and the
    rank's dw columns against ``lmhead_xent_{fwd,bwd}_2d_plain`` over all
    300 columns, labels in every rank's range (300 splits 150 / 150 and
    100 / 100 / 100)."""
    for res in runs[name]["ranks"]:
        loss, dh, dw = res["ce"][route]
        assert loss <= 2e-6 and dh <= 2e-6 and dw <= 2e-6, res["ce"][route]


@pytest.mark.parametrize("kernels", [True, False], ids=["fused", "logits"])
@pytest.mark.parametrize("name", list(MESHES))
def test_loss_folds_by_one_collective_and_gathers_no_logits(runs, name,
                                                            kernels):
    """A chunk of the loss issues one ``ext_sum_sharded`` (a collective of
    2 floats a row and rank) and one sum of the label logits (1 a row);
    nothing of a chunk's logits' size is ever reduced or gathered."""
    tp = MESHES[name][1]
    for res in runs[name]["ranks"]:
        calls, folds = res["ce"][f"calls_{kernels}"]
        assert folds == 3
        assert calls == [tp * 2 * 6, 6] * 3
        assert max(calls) < res["ce"]["chunk_logits"]


# ---------------------------------------------------------------------------
# The specs of the state and of the batch, against the reference's.
# ---------------------------------------------------------------------------
def jflat_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in kp): tuple(v)
            for kp, v in leaves}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_equal_the_reference(arch):
    """The moments take the parameters' specs, the step is replicated:
    entry for entry the reference's ``PartitionSpec``s (a 2 x 2 mesh)."""
    mesh = stub((2, 2))
    cfg = tcfg(arch).reduced()
    # the heads unpadded: the port pads no family but the GQA ones
    shapes = transformer.init_lm(cfg, device="meta")
    got = train_state.state_specs(sharding.param_specs(shapes, cfg, mesh))
    jm = jbuild(arch, reduced=True)
    want = jstate.state_specs(jsh.param_specs(jm.init_shape(), jm.cfg,
                                              mesh))
    assert got.opt.step == tuple(want.opt.step) == ()
    for g, w in ((got.params, want.params), (got.opt.m, want.opt.m),
                 (got.opt.v, want.opt.v)):
        assert dict(sharding.flatten(g)) == jflat_specs(w)


def test_shard_batch_equals_the_reference():
    """The reference's ``shard_batch`` on a 2 x 2 mesh of host devices
    (its own process: the device count is fixed when JAX starts): each
    device's rows of a global batch of 8 (and of a leaf of 3 rows, which
    does not divide and stays whole), and the port's rank at the same
    (data, model) coordinates takes the same rows; the specs are the
    reference's ``batch_specs``."""
    code = textwrap.dedent("""
        import json, jax, numpy as np
        from repro.data.pipeline import shard_batch
        from repro.distributed import sharding
        mesh = jax.make_mesh((2, 2), ("data", "model"))
        batch = {"tokens": np.arange(8 * 5).reshape(8, 5),
                 "frames": np.arange(3 * 2).reshape(3, 2)}
        specs = sharding.batch_specs(batch, mesh)
        out = shard_batch(batch, mesh, specs)
        rows = {}
        for k, arr in out.items():
            for s in arr.addressable_shards:
                coord = [int(c[0]) for c in np.nonzero(
                    mesh.devices == s.device)]
                rows.setdefault(k, {})[str(coord)] = np.asarray(
                    s.data)[:, 0].tolist()
        print(json.dumps({"rows": rows, "specs": {
            k: list(v) for k, v in specs.items()}}))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    batch = {"tokens": np.arange(8 * 5).reshape(8, 5),
             "frames": np.arange(3 * 2).reshape(3, 2)}
    specs = sharding.batch_specs(batch, stub((2, 2)))
    assert {k: list(v) for k, v in specs.items()} == ref["specs"]
    for d in range(2):
        for m in range(2):
            got = shard_batch(batch, coords_mesh((2, 2), (d, m)), specs)
            for k, x in got.items():
                assert x[:, 0].tolist() == ref["rows"][k][str([d, m])], k
