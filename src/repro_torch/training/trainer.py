"""The train loop: data -> step -> metrics -> checkpoints, with
crash-resume and straggler detection, as the reference's
``repro.training.trainer`` (without its mesh: ROADMAP queue A item 22).

This is the loop ``python -m repro_torch.launch.train`` runs.

A checkpoint's step is the number of updates its state holds, so a run
resumed from step k runs batch k next.  (The reference labels its periodic
checkpoints one step lower than the state they hold; its final checkpoint,
which the crash-resume test resumes from, is labelled as here.)
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Optional

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import fault_tolerance
from repro_torch.models.model_zoo import Model
from repro_torch.optim import schedules
from repro_torch.training import step_fn as step_mod
from repro_torch.training import train_state

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup: int = 20
    seed: int = 0
    straggler_factor: float = 3.0


class Trainer:
    def __init__(self, model: Model, cell: ShapeCell, tcfg: TrainerConfig,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): sharded training is not ported yet "
                "(ROADMAP queue A item 22)")
        self.model = model
        self.cell = cell
        self.tcfg = tcfg
        self.data = SyntheticLM(model.cfg, cell, seed=tcfg.seed)
        self.ckpt = (Checkpointer(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_dir else None)
        self.timer = fault_tolerance.StepTimer(
            straggler_factor=tcfg.straggler_factor)
        self.metrics_history: list[dict] = []
        lr = functools.partial(schedules.warmup_cosine,
                               peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                               total=tcfg.steps)
        # the loss runs under the model config's SoftmaxPolicy: with
        # use_kernels, the flash-attention and LM-head CE kernels (and a
        # moe router's softmax); a moe model's experts by the default
        # moe_impl, "dispatch", as the reference's Trainer
        self.step = step_mod.make_train_step(
            model, lr_schedule=lr, microbatches=tcfg.microbatches)

    # -- state --------------------------------------------------------------
    def init_or_resume(self):
        """Fresh weights from ``tcfg.seed`` (a seeded generator on the
        model's device), or the latest checkpoint.  Returns ``(state,
        first step to run)``."""
        params = self.model.init(seed=self.tcfg.seed)
        state = train_state.init_state(params)
        start = 0
        if self.ckpt is not None:
            step, restored = self.ckpt.restore_latest(state)
            if restored is not None:
                state, start = restored, step
                log.info("resumed from step %d", step)
        return state, start

    # -- loop ---------------------------------------------------------------
    def run(self, state=None, start_step: int | None = None):
        if state is None:
            state, start_step = self.init_or_resume()
        every = self.tcfg.checkpoint_every
        for step_idx, batch in self.data.iterate(start_step or 0):
            if step_idx >= self.tcfg.steps:
                break
            t0 = time.perf_counter()
            state, metrics = self.step(state, batch)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.perf_counter() - t0
            if self.timer.record(dt):
                log.warning("straggler step %d: %.2fs (median %.2fs)",
                            step_idx, dt, self.timer.median())
            if step_idx % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step_idx, loss, dt)
            self.metrics_history.append(
                {"step": step_idx, "loss": loss, "time_s": dt})
            done = step_idx + 1
            if (self.ckpt is not None and done % every == 0
                    and done < self.tcfg.steps):
                self.ckpt.save(done, state)
        if self.ckpt is not None:
            self.ckpt.save(self.tcfg.steps, state, blocking=True)
        return state
