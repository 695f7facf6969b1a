"""The train loop: data -> step -> metrics -> checkpoints, with
crash-resume, straggler detection and elastic-mesh restore, as the
reference's ``repro.training.trainer``.

This is the loop ``python -m repro_torch.launch.train`` runs.

Under a ``('data', 'model')`` mesh (the dense family, more than one KV
head) each rank holds its cut of the state along ``model`` and the data
axes (``sharding.param_specs(..., fsdp=True)``, the reference's specs),
the model code issues the collectives (``distributed/collectives.py``),
and every rank logs the global loss.  Checkpoints hold the global arrays
and restore onto any mesh, or none.

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
from repro_torch.distributed import fault_tolerance, sharding
from repro_torch.models.model_zoo import Model
from repro_torch.optim import adamw, schedules
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
            _check_mesh(model, mesh)
        self.model = model
        self.cell = cell
        self.tcfg = tcfg
        self.mesh = mesh
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
        self.pspecs = self.sspecs = self.plan = None
        if mesh is not None:
            shapes = model.init_shape()
            self.pspecs = sharding.param_specs(shapes, model.cfg, mesh)
            self.sspecs = train_state.state_specs(self.pspecs)
            self.plan = sharding.fsdp_plan(shapes, self.pspecs)
        self.step = step_mod.make_train_step(
            model, lr_schedule=lr, microbatches=tcfg.microbatches,
            mesh=mesh, plan=self.plan)

    # -- state --------------------------------------------------------------
    def init_or_resume(self):
        """Fresh weights from ``tcfg.seed`` (a seeded generator on the
        model's device; under a mesh the same draws, each leaf cut to this
        rank's shard as it is drawn), or the latest checkpoint (saved on
        any mesh, or none).  Returns ``(state, first step to run)``."""
        if self.mesh is None:
            params = self.model.init(seed=self.tcfg.seed)
        else:
            params = self.model.init_shard(self.pspecs, self.mesh,
                                           seed=self.tcfg.seed)
        state = train_state.init_state(params)
        start = 0
        if self.ckpt is not None:
            step, restored = self.ckpt.restore_latest(state, self.mesh,
                                                      self.sspecs)
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
            loss = float(metrics["loss"])      # waits for the step
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
                self._save(done, state)
        if self.ckpt is not None:
            self._save(self.tcfg.steps, state, blocking=True)
        return state

    def _save(self, step: int, state, blocking: bool = False) -> None:
        plan = None
        if self.mesh is not None:
            plan = train_state.TrainState(self.plan, adamw.AdamWState(
                ((), ()), self.plan, self.plan))
        self.ckpt.save(step, state, blocking=blocking, mesh=self.mesh,
                       plan=plan)


def _check_mesh(model: Model, mesh) -> None:
    """What trains under a mesh: the dense family with more than one KV
    head, at the model's ``tp`` (its q-heads padded for the model axis)."""
    cfg = model.cfg
    if cfg.family != "dense" or cfg.n_kv_heads == 1:
        what = ("MQA (one KV head)" if cfg.family == "dense"
                else f"family {cfg.family!r}")
        raise NotImplementedError(
            f"Trainer(mesh=...): {cfg.name}: {what} under a mesh is not "
            "ported yet (ROADMAP queue A item 35)")
    tp = mesh.size("model")
    if model.tp != tp:
        raise ValueError(f"a model axis of {tp} ranks over a model built "
                         f"with tp={model.tp}: build it with tp={tp}")
