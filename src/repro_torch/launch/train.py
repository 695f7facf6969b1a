"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

    python -m repro_torch.launch.train --arch qwen2.5-14b --reduced \
        --device cpu --steps 2
    python -m repro_torch.launch.train --arch qwen2.5-14b --reduced \
        --kernels --steps 6 --checkpoint-dir build/ckpt

The reference's flags and final printout (``final: {step, loss,
time_s}``), plus ``--device`` (``cuda`` unless the CPU is asked for) and
``--kernels`` (the model's ``use_kernels``: attention through the
flash-attention kernels and the loss through the fused LM-head CE kernels;
on the CPU their plain versions).  Weights are random, from seed 0, in the
config's parameter dtype.  Every family trains: an encdec batch is
seeded frames and decoder tokens, a vlm batch seeded patches ahead of
the tokens (``SyntheticLM``), and a moe model routes through the
reference's default ``moe_impl``, ``dispatch``.  ``--mesh`` exits with
an error that names its ROADMAP item.
"""

from __future__ import annotations

import argparse
import logging


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
                   help="sharded training over a device mesh: not ported "
                        "yet")
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
    if args.mesh is not None:
        p.error("--mesh is not ported yet (ROADMAP queue A item 22)")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    from repro_torch import kernels
    from repro_torch.configs.base import SHAPES, ShapeCell
    from repro_torch.models import build_model
    from repro_torch.training.trainer import Trainer, TrainerConfig

    try:
        model = build_model(args.arch, reduced=args.reduced,
                            device=args.device,
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
        microbatches=args.microbatches))
    kernels.reset_launch_counts()
    trainer.run()
    if args.kernels:
        print("kernel launches:", {k: v for k, v in
                                   kernels.launch_counts().items() if v})
    last = trainer.metrics_history[-1] if trainer.metrics_history else {}
    print(f"final: {last}")


if __name__ == "__main__":
    main()
