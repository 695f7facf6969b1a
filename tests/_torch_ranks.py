"""Rank processes for the port's mesh tests: ``run_ranks`` spawns ``world``
CPU processes joined over ``gloo`` through a ``file://`` store (no ports,
so parallel test workers cannot clash), runs ``fn(rank, *args)`` in each
and returns rank 0's result.  Imports torch and the port only, never JAX:
the parent test holds the results against the reference."""

from __future__ import annotations

import os
import pickle
import traceback

import torch.multiprocessing as mp


def _entry(rank, world, store, out_dir, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        res = fn(rank, *args)
        if dist.is_initialized():          # a CLI run destroys its own
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def run_ranks(fn, world: int, tmp_path, *args):
    """``fn(rank, *args)`` in ``world`` spawned ranks; rank 0's result (a
    rank's exception is raised here with its traceback)."""
    store = str(tmp_path / "store")
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    mp.start_processes(_entry, args=(world, store, str(out), fn, args),
                       nprocs=world, join=True, start_method="spawn")
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    for r, res in enumerate(results):
        if isinstance(res, dict) and "error" in res:
            raise AssertionError(f"rank {r}:\n{res['error']}")
    return results


# ---------------------------------------------------------------------------
# Workers.
# ---------------------------------------------------------------------------
def twopass_worker(rank, x, world, cuts):
    """The sharded two-pass softmax and logsumexp of this rank's columns of
    ``x`` (``cuts``: the column bounds), counting the collectives each
    call issues."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import twopass
    from repro_torch.launch.mesh import make_serving_mesh

    calls = []
    real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                          "all_gather_into_tensor",
                                          "broadcast", "reduce_scatter")}

    def counted(name):
        def f(*a, **kw):
            calls.append(name)
            return real[name](*a, **kw)
        return f

    for n in real:
        setattr(dist, n, counted(n))
    mesh = make_serving_mesh((1, world), backend="gloo")
    xl = torch.from_numpy(x[:, cuts[rank]:cuts[rank + 1]])
    out = {}
    group = mesh.group("model")
    for name, fn in (("softmax", twopass.twopass_softmax_sharded),
                     ("lse", twopass.twopass_logsumexp_sharded)):
        before = len(calls)
        out[name] = fn(xl, group).numpy()
        out[name + "_calls"] = calls[before:]
    # the active mesh's model axis is the default group
    from repro_torch.distributed import autoshard

    before = len(calls)
    with autoshard.hints(mesh):
        out["softmax_active"] = twopass.twopass_softmax_sharded(xl).numpy()
    out["active_calls"] = calls[before:]
    for n, f in real.items():
        setattr(dist, n, f)
    return out


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def serve_worker(rank, shape, params, arch_kw, prompts, engine_kw,
                 extras):
    """Serve ``prompts`` through the port's engine over a ``shape`` mesh
    from the reference's (padded) parameters; returns the tokens, the
    throughput dict and, for the names in ``extras``, the budget pages
    with and without the mesh and the fused refusal."""
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import build_model
    from repro_torch.serving.scheduler import Request

    mesh = make_serving_mesh(shape, backend="gloo")
    model = build_model(device="cpu", tp=shape[1], **arch_kw)
    full = params_from_jax(params, model.cfg, "cpu")
    eng = model.serving_engine(full, mesh=mesh, fused=False, **engine_kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    out = dict(tokens=[tuple(c.tokens) for c in eng.run(reqs)],
               throughput=eng.throughput(),
               arena=tuple(eng.pool["kv"]["k"].shape),
               wq=tuple(eng.params["blocks"]["attn"]["wq"]["w"].shape),
               embed=tuple(eng.params["embed"]["table"].shape),
               free_and_cached=(eng.allocator.free_pages
                                + eng.prefix_cache.n_pages,
                                eng.allocator.usable_pages))
    if "budget" in extras:
        # a rank's pool against its budget: the bytes it allocated, and
        # those of one page more (counted at its heads under the mesh)
        from repro_torch.distributed import autoshard
        from repro_torch.serving import kv_cache

        budget = 1 << 20
        kw = dict(memory_budget_bytes=budget, max_len=64, temperature=0.0,
                  page_size=8)
        plain = model.serving_engine(full, **kw)
        sharded = model.serving_engine(full, mesh=mesh, fused=False, **kw)
        with autoshard.hints(mesh):
            more = kv_cache.paged_pool_bytes(
                model.cfg, sharded.n_slots, 64, page_size=8,
                pages=sharded.allocator.usable_pages + 2)
        out["budget_pages"] = (plain.allocator.usable_pages,
                               sharded.allocator.usable_pages)
        out["budget_bytes"] = (budget, _nbytes(sharded.pool), more)
    if "fused" in extras:
        try:
            model.serving_engine(full, mesh=mesh, slots=2, max_len=64)
        except ValueError as e:
            out["fused_error"] = str(e)
    if "sampled" in extras:
        eng = model.serving_engine(full, mesh=mesh, fused=False,
                                   **dict(engine_kw, temperature=0.8))
        out["sampled"] = [tuple(c.tokens) for c in eng.run(
            [Request(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)])]
    return out


def cli_worker(rank, argv, cli: str = "serve"):
    """``python -m repro_torch.launch.<cli>`` (serve or train) with
    ``argv`` as a rank of torchrun would run it (the group made here,
    ``WORLD_SIZE`` set); returns what it printed."""
    import contextlib
    import importlib
    import io

    import torch.distributed as dist

    main = importlib.import_module(f"repro_torch.launch.{cli}").main
    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _gathered_state(tree, plan, mesh):
    """The whole of each leaf of a tree of this rank's shards, numpy, on
    rank 0 (``None`` leaves on the others)."""
    from repro_torch.distributed.sharding import gather_to_rank0

    if isinstance(tree, dict):
        return {k: _gathered_state(v, plan[k], mesh) for k, v in tree.items()}
    full = gather_to_rank0(tree, *plan, mesh)
    return None if full is None else full.numpy()


def train_worker(rank, shape, params, cell, steps, lr, jobs):
    """Reduced qwen2.5-14b (float32) over a ``shape`` mesh.  From
    ``params`` (the reference's, numpy, padded for the model axis), for
    kernels off and on: ``steps`` steps through ``Trainer.run`` (the
    losses, the global grad norms, the final parameters gathered whole on rank 0),
    this rank's gradients of the first batch after the data axes' sums,
    and each leaf's local shape.  ``jobs`` adds ``"init"``
    (``Model.init_shard`` against the cut of ``Model.init``), ``"ce"``
    (:func:`_ce_checks`), ``"embed"`` (:func:`_embed_calls`), ``("save",
    a, b, copies)`` (6 steps straight from seeded weights, checkpointing
    into ``a``, then 3 into ``b``; 3 warm-up steps, so that the first 3
    take the same rates whatever the run's length; then ``b`` copied to
    each directory of ``copies``), ``("resume", d, shape)`` (resume ``d``
    to step 6 over a ``shape`` mesh of the same ranks) and ``("cli",
    argv)`` (the training CLI, last: it ends the group)."""
    import shutil

    import torch

    from repro_torch.configs.base import ShapeCell
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import autoshard, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.training import step_fn, train_state
    from repro_torch.training.trainer import Trainer, TrainerConfig

    mesh = make_mesh(shape, ("data", "model"), backend="gloo")

    def trainer(kernels, n, on=mesh, **kw):
        m = build_model("qwen2.5-14b", reduced=True, device="cpu",
                        tp=on.size("model"), use_kernels=kernels)
        return Trainer(m, ShapeCell("t", *cell, "train"), TrainerConfig(
            **{"steps": n, "peak_lr": lr, "warmup": 0, "log_every": 100,
               **kw}),
            mesh=on)

    def run(t, state=None):
        norms, step = [], t.step

        def recorded(st, batch):
            st, met = step(st, batch)
            norms.append(float(met["grad_norm"]))
            return st, met

        t.step = recorded
        st = t.run(state, 0 if state is not None else None)
        return st, [h["loss"] for h in t.metrics_history], norms

    out = {"coords": tuple(mesh.local_rank(a) for a in mesh.axis_names)}
    for kernels in (False, True):
        t = trainer(kernels, steps)
        local = sharding.shard_tree(params_from_jax(params, t.model.cfg,
                                                    "cpu"),
                                    t.pspecs, mesh, ("model", "data"))
        state = train_state.init_state(local)
        batch = t.data.batch_at(0)
        batch = shard_batch(batch, mesh, sharding.batch_specs(batch, mesh))
        with autoshard.hints(mesh, t.plan):
            _, grads = step_fn.loss_and_grads(
                t.model, state.params,
                {k: torch.from_numpy(v) for k, v in batch.items()})
            step_fn.sum_replicated_grads(grads, t.pspecs, mesh)
        st, losses, norms = run(t, state)
        out[kernels] = dict(
            losses=losses, norms=norms,
            grads=sharding.map_paths(grads, lambda _, g: g.numpy()),
            params=_gathered_state(st.params, t.plan, mesh),
            shapes=sharding.map_paths(local, lambda _, x: tuple(x.shape)))
    for job in jobs:
        if job == "init":
            t = trainer(True, 1)
            want = sharding.shard_tree(t.model.init(seed=3), t.pspecs, mesh,
                                       ("model", "data"))
            got = t.model.init_shard(t.pspecs, mesh, seed=3)
            out["init_equal"] = [
                (p, tuple(a.shape), bool(torch.equal(a, b))) for (p, a), (_, b)
                in zip(sharding.flatten(got), sharding.flatten(want))]
        elif job == "ce":
            out["ce"] = _ce_checks(mesh, trainer(True, 1).model.cfg)
        elif job == "embed":
            out["embed"] = _embed_calls(mesh, trainer(True, 1))
        elif job[0] == "save":
            out["straight"] = run(trainer(True, 6, checkpoint_every=3,
                                          checkpoint_dir=job[1],
                                          warmup=3))[1]
            run(trainer(True, 3, checkpoint_every=3, checkpoint_dir=job[2],
                        warmup=3))
            if rank == 0:
                for d in job[3]:
                    shutil.copytree(job[2], d)
            torch.distributed.barrier()
        elif job[0] == "resume":
            on = make_mesh(job[2], ("data", "model"), backend="gloo")
            t = trainer(True, 6, on, checkpoint_every=3,
                        checkpoint_dir=job[1], warmup=3)
            t.run()
            out.setdefault("resumed", {})[job[2]] = [
                (h["step"], h["loss"]) for h in t.metrics_history]
        elif job[0] == "cli":
            out["cli"] = cli_worker(rank, job[1], "train")
    return out


def _embed_calls(mesh, t):
    """The payloads (elements) of the collectives that the embedding of
    one batch issues forward and backward under ``t``'s FSDP plan."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import autoshard, sharding
    from repro_torch.models import transformer

    params = t.model.init_shard(t.pspecs, mesh)
    table = params["embed"]["table"].requires_grad_(True)
    batch = t.data.batch_at(0)
    batch = shard_batch(batch, mesh, sharding.batch_specs(batch, mesh))
    tokens = torch.from_numpy(batch["tokens"])
    calls, real = [], dist.all_reduce

    def counted(x, *a, **k):
        calls.append(x.numel())
        return real(x, *a, **k)

    dist.all_reduce = counted
    try:
        with autoshard.hints(mesh, t.plan):
            x = transformer.embed_tokens(params, tokens, t.model.cfg)
            fwd = list(calls)
            x.float().sum().backward()
    finally:
        dist.all_reduce = real
    return dict(fwd=fwd, bwd=calls[len(fwd):], tokens=tokens.numel(),
                grad_shape=tuple(table.grad.shape),
                local_shape=tuple(table.shape))


def _ce_checks(mesh, cfg):
    """The vocab-parallel CE op, both routes, against the single-rank plain
    forms over all columns (``lmhead_xent_*_plain``; labels in every
    rank's range), and the collectives one loss of the model issues: the
    payload of each (elements) and the (m, n) folds, per route."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import twopass
    from repro_torch.core.policy import SoftmaxPolicy
    from repro_torch.distributed import autoshard, collectives
    from repro_torch.kernels import ops
    from repro_torch.kernels import twopass_xent as xe
    from repro_torch.models import transformer

    rng = np.random.default_rng(5)
    t_, d, v = 40, 32, 300
    h = torch.from_numpy(rng.standard_normal((t_, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d, v)) * 0.5)
                         .astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, v, t_))
    dl = torch.from_numpy(rng.standard_normal(t_).astype(np.float32))
    loss_w, m_w, n_w = xe.lmhead_xent_fwd_2d_plain(h, w, lab)
    dh_w, dw_w = xe.lmhead_xent_bwd_2d_plain(h, w, lab, m_w, n_w, dl)
    res = {}
    with autoshard.hints(mesh):
        lo, hi = collectives.vocab_range(v)
        for route in ("fused", "logits"):
            hh = h.clone().requires_grad_(True)
            ww = w[:, lo:hi].clone().requires_grad_(True)
            hc = collectives.copy_to_model(hh)
            if route == "fused":
                loss = ops.lmhead_cross_entropy_sharded(hc, ww, lab, lo,
                                                        block_v=64)
            else:
                loss = ops.cross_entropy_sharded(hc @ ww, lab, lo)
            loss.backward(dl)
            res[route] = [float((a - b).abs().max()) for a, b in (
                (loss.detach(), loss_w), (hh.grad, dh_w),
                (ww.grad, dw_w[:, lo:hi]))]
    # one loss of the model over hidden states [2, 9, d]: three chunks of
    # 6 tokens; every collective counted with its payload
    calls, folds = [], []
    real, fold = dist.all_reduce, twopass.ext_sum_sharded

    def counted(x, *a, **k):
        calls.append(x.numel())
        return real(x, *a, **k)

    def fold_counted(*a, **k):
        folds.append(1)
        return fold(*a, **k)

    hs = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model))
                          .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)))
    dist.all_reduce, twopass.ext_sum_sharded = counted, fold_counted
    try:
        with torch.no_grad(), autoshard.hints(mesh):
            lo, hi = collectives.vocab_range(cfg.padded_vocab())
            params = {"lm_head": {"w": torch.from_numpy(rng.standard_normal(
                (cfg.d_model, hi - lo)).astype(np.float32))}}
            for kernels in (True, False):
                calls.clear()
                folds.clear()
                transformer.lm_loss_from_hidden(
                    params, hs, labels, cfg=cfg, n_chunks=3,
                    policy=SoftmaxPolicy(use_kernels=kernels))
                res[f"calls_{kernels}"] = (list(calls), len(folds))
    finally:
        dist.all_reduce, twopass.ext_sum_sharded = real, fold
    res["chunk_logits"] = 6 * (hi - lo)
    return res
