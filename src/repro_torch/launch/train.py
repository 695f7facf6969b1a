"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

    python -m repro_torch.launch.train --arch qwen2.5-14b --reduced \
        --device cpu --steps 2
    python -m repro_torch.launch.train --arch qwen2.5-14b --reduced \
        --kernels --steps 6 --checkpoint-dir build/ckpt
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2.5-14b --reduced --device cpu --mesh 1x2 --backend gloo

The reference's flags and final printout (``final: {step, loss,
time_s}``), plus ``--device`` (``cuda`` unless the CPU is asked for) and
``--kernels`` (the model's ``use_kernels``: attention through the
flash-attention kernels and the loss through the fused LM-head CE kernels;
on the CPU their plain versions).  Weights are random, from seed 0, in the
config's parameter dtype.  Every family trains: an encdec batch is
seeded frames and decoder tokens, a vlm batch seeded patches ahead of
the tokens (``SyntheticLM``), and a moe model routes through the
reference's default ``moe_impl``, ``dispatch``.

``--mesh DATAxMODEL`` trains over a ``('data', 'model')`` mesh, one rank a
process under ``torchrun`` (``Trainer(..., mesh=)``: tensor-parallel over
``model``, FSDP over ``data``), with ``--backend`` said outright:
``gloo`` for ranks that share a card or the CPU, ``nccl`` for a card a
rank (written; it has not run across cards).  The flags are checked
before any rank joins the group: the dense family with more than one KV
head trains under a mesh, the others exit naming their ROADMAP item.
Rank 0 prints; the loss it prints is the global one.  A checkpoint holds
the global arrays and resumes under another ``--mesh``, or none.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import logging
import os


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default="train_4k")
    p.add_argument("--reduced", action="store_true",
                   help="tiny same-family config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seq", type=int, default=None)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--softmax", default="two_pass",
                   choices=["two_pass", "three_pass_recompute",
                            "three_pass_reload"])
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="train over a (data, model) mesh of ranks, e.g. 1x2 "
                        "(under torchrun; needs --backend)")
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="the mesh's collectives: gloo (ranks sharing a "
                        "card, or the CPU) or nccl (a card a rank)")
    p.add_argument("--kernels", action="store_true",
                   help="attention and the loss through the CUDA kernels "
                        "(ModelConfig.use_kernels)")
    p.add_argument("--device", default="cuda",
                   help="device of the weights and the state (default "
                        "cuda; cpu runs the plain versions)")
    return p


def main(argv=None) -> None:
    p = parser()
    args = p.parse_args(argv)
    mesh = _mesh(args, p)
    if mesh is None:
        _main(args, p, None)
        return
    import torch.distributed as dist

    try:
        quiet = dist.get_rank() != 0
        with (contextlib.redirect_stdout(io.StringIO()) if quiet
              else contextlib.nullcontext()):
            _main(args, p, mesh)
    finally:
        dist.destroy_process_group()


def _mesh(args, p):
    """The training mesh of ``--mesh`` (None without it), after the checks
    that need no process group."""
    if args.mesh is None:
        if args.backend is not None:
            p.error("--backend applies only with --mesh")
        return None
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, parse_mesh

    try:
        d, m = parse_mesh(args.mesh)
        cfg = get_config(args.arch)
    except (ValueError, KeyError) as e:
        p.error(str(e))
    if cfg.family != "dense" or cfg.n_kv_heads == 1:
        what = ("MQA (one KV head)" if cfg.family == "dense"
                else f"family {cfg.family!r}")
        p.error(f"--mesh: {args.arch}: {what} under a mesh is not ported "
                "yet (ROADMAP queue A item 35)")
    if args.backend is None:
        p.error("--mesh needs --backend: gloo (ranks sharing a card, or "
                "the CPU) or nccl (a card a rank)")
    if int(os.environ.get("WORLD_SIZE", 1)) != d * m:
        p.error(f"--mesh {args.mesh} needs {d * m} ranks: run it under "
                f"torchrun --nproc-per-node {d * m}")
    return make_mesh((d, m), ("data", "model"), backend=args.backend)


def _main(args, p, mesh) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    from repro_torch import kernels
    from repro_torch.configs.base import SHAPES, ShapeCell
    from repro_torch.launch.mesh import mesh_tp, torch_device_for
    from repro_torch.models import build_model
    from repro_torch.training.trainer import Trainer, TrainerConfig

    device = (torch_device_for(mesh, args.device) if mesh is not None
              else args.device)
    try:
        model = build_model(args.arch, reduced=args.reduced,
                            device=device, tp=mesh_tp(mesh),
                            softmax_algorithm=args.softmax,
                            use_kernels=args.kernels)
    except (KeyError, RuntimeError) as e:    # unknown arch; no card
        p.error(str(e))
    base = SHAPES[args.shape]
    cell = ShapeCell(base.name,
                     args.seq or (64 if args.reduced else base.seq_len),
                     args.batch or (8 if args.reduced else
                                    base.global_batch),
                     "train")
    trainer = Trainer(model, cell, TrainerConfig(
        steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, peak_lr=args.lr,
        microbatches=args.microbatches), mesh=mesh)
    kernels.reset_launch_counts()
    trainer.run()
    if args.kernels:
        print("kernel launches:", {k: v for k, v in
                                   kernels.launch_counts().items() if v})
    last = trainer.metrics_history[-1] if trainer.metrics_history else {}
    print(f"final: {last}")


if __name__ == "__main__":
    main()
