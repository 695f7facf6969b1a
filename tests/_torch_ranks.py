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


def cli_worker(rank, argv):
    """``python -m repro_torch.launch.serve`` with ``argv`` as a rank of
    torchrun would run it (the group made here, ``WORLD_SIZE`` set);
    returns what it printed."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.launch import serve

    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(argv)
    return out.getvalue()
