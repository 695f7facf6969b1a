"""Model facade: build an architecture from its config on a device, plus
``input_specs`` -- ``meta``-device stand-ins for every (arch x shape) cell
(shapes and dtypes, no storage).

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``; nothing moves to the CPU by itself when there is no card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import transformer
from repro_torch.serving import engine, kv_cache


class Model:
    """A config bound to a device and a tensor-parallel factor ``tp`` (the
    reference's ``Model(cfg, tp)``): the q-heads are padded to a multiple
    of ``tp``, with zero weights, and every entry point runs the padded
    layout.  On one rank that gives the unpadded model's function; under a
    serving mesh of ``tp`` model ranks each rank runs its shard.  The
    scheduler and entry points take it with the parameters made by
    :meth:`init`."""

    def __init__(self, cfg: ModelConfig, device="cuda", tp: int = 1):
        self.cfg = cfg
        self.device = torch.device(device)
        self.tp = int(tp)

    # -- construction -------------------------------------------------------
    def init(self, seed: int = 0, dtype: torch.dtype | None = None):
        """Random weights from a seeded generator on the device."""
        return transformer.init_lm(self.cfg, seed=seed, device=self.device,
                                   dtype=dtype, tp=self.tp)

    def init_shard(self, specs, mesh, seed: int = 0):
        """This rank's shard of :meth:`init`'s weights: the same draws from
        the same seed, each leaf cut along ``model`` and ``data`` by its
        spec in
        ``specs`` (``sharding.local_shard``) as soon as it is drawn, so
        that no rank holds the whole tree (at full width a few ranks
        sharing one card could not)."""
        from repro_torch.distributed import sharding

        axes = ("model", "data")
        drawn = []
        meta = transformer.init_lm(self.cfg, device="meta", tp=self.tp,
                                   cut=lambda t: drawn.append(t) or t)
        path_of = {id(t): path for path, t in sharding.flatten(meta)}
        spec_of = dict(sharding.flatten(specs))
        order = iter([path_of[id(t)] for t in drawn])

        def cut(t):
            return sharding.local_shard(t, spec_of[next(order)], mesh, axes)

        params = transformer.init_lm(self.cfg, seed=seed, device=self.device,
                                     tp=self.tp, cut=cut)
        full = dict(sharding.flatten(meta))
        # the leaves made without a draw (norm scales, biases), still whole
        return sharding.map_paths(params, lambda path, x: (
            sharding.local_shard(x, spec_of[path], mesh, axes)
            if x.shape == full[path].shape else x))

    def init_shape(self):
        """The parameter tree on the ``meta`` device: shapes and dtypes,
        nothing allocated or drawn."""
        return transformer.init_lm(self.cfg, device="meta", tp=self.tp)

    # -- functional entry points -------------------------------------------
    def loss(self, params, batch: dict, moe_impl: str = "dispatch",
             policy=None):
        """Mean next-token CE of ``batch`` (tensors on the device); a moe
        model's experts run by ``moe_impl``; ``policy`` overrides the
        config's SoftmaxPolicy for the loss."""
        return transformer.train_loss(params, batch, cfg=self.cfg,
                                      tp=self.tp, moe_impl=moe_impl,
                                      policy=policy)

    def forward(self, params, tokens, patches=None,
                moe_impl: str = "dispatch"):
        """Hidden states [B, S, d]; a vlm prompt's ``patches`` ([B,
        n_patches, d]) come first and count in S; a moe model's experts
        run by ``moe_impl``."""
        return transformer.forward(params, tokens, cfg=self.cfg,
                                   tp=self.tp, patches=patches,
                                   moe_impl=moe_impl)

    def prefill(self, params, tokens, **kw):
        """``kw`` as :func:`engine.prefill`'s (``max_len``, ``last_pos``,
        an encdec prompt's ``frames``, a vlm prompt's ``patches``)."""
        return engine.prefill(params, tokens, cfg=self.cfg, tp=self.tp,
                              **kw)

    def decode_step(self, params, cache, tokens, pos,
                    moe_impl: str = "dispatch"):
        return engine.decode_step(params, cache, tokens, pos, cfg=self.cfg,
                                  tp=self.tp, moe_impl=moe_impl)

    def init_cache(self, batch: int, max_len: int, ring: bool = True):
        return kv_cache.init_cache(self.cfg, batch, max_len, ring=ring,
                                   device=self.device)

    def generate(self, params, prompt, *, steps: int,
                 generator: torch.Generator | None = None, **kw):
        """Lockstep tokens [B, steps + 1] (:func:`engine.generate`; a vlm
        prompt's ``patches`` go in ``kw``)."""
        return engine.generate(params, prompt, cfg=self.cfg, steps=steps,
                               generator=generator, tp=self.tp, **kw)

    # -- continuous batching -------------------------------------------------
    def init_slot_pool(self, slots: int, max_len: int):
        return kv_cache.init_slot_pool(self.cfg, slots, max_len,
                                       device=self.device)

    def decode_step_ragged(self, params, pool, tokens, active=None,
                           moe_impl: str = "dispatch"):
        return engine.decode_step_ragged(params, pool, tokens, cfg=self.cfg,
                                         tp=self.tp, moe_impl=moe_impl,
                                         active=active)

    def serving_engine(self, params, **kw):
        """A :class:`repro_torch.serving.scheduler.ContinuousBatchingEngine`
        bound to this model (slot pool + request scheduler)."""
        from repro_torch.serving.scheduler import ContinuousBatchingEngine

        return ContinuousBatchingEngine(self, params, **kw)


def build_model(arch: str, reduced: bool = False, device="cuda",
                tp: int = 1, **overrides) -> Model:
    """``device`` defaults to ``cuda`` and raises where there is no card:
    the CPU is taken only when asked for.  ``tp`` pads the q-heads
    (:class:`Model`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_model: no CUDA device; pass device='cpu' to run the "
            "plain versions on the CPU")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return Model(cfg, device, tp)


# ---------------------------------------------------------------------------
# input_specs: meta-device stand-ins per (arch x shape) cell.
# ---------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell | str) -> dict:
    """Input shapes for one cell.  ``train``/``prefill`` describe the step
    batch; ``decode`` describes (cache, tokens, pos).  An ssm decode
    cell's cache is the recurrent state, the same at any ``seq_len``
    (long_500k included); a hybrid one's is ``{"attn", "ssm"}``, the
    attention half a ring of ``swa_window`` positions."""
    if isinstance(cell, str):
        cell = SHAPES[cell]
    b, s = cell.global_batch, cell.seq_len
    i32, f32 = torch.int32, torch.float32

    if cell.kind == "train":
        if cfg.family == "encdec":
            return {"batch": {
                "frames": _spec((b, s, cfg.d_model), f32),
                "dec_tokens": _spec((b, cfg.dec_len), i32),
            }}
        batch = {"tokens": _spec((b, s), i32)}
        if cfg.family == "vlm":
            batch["tokens"] = _spec((b, s - cfg.n_patches), i32)
            batch["patches"] = _spec((b, cfg.n_patches, cfg.d_model), f32)
        return {"batch": batch}

    if cell.kind == "prefill":
        if cfg.family == "encdec":
            return {"tokens": _spec((b, cfg.dec_len), i32),
                    "frames": _spec((b, s, cfg.d_model), f32)}
        spec = {"tokens": _spec((b, s - cfg.n_patches), i32)}
        if cfg.family == "vlm":
            spec["patches"] = _spec((b, cfg.n_patches, cfg.d_model), f32)
        return spec

    # decode: one new token against a cache of seq_len
    return {"cache": kv_cache.init_cache(cfg, b, s, device="meta"),
            "tokens": _spec((b,), i32), "pos": _spec((), i32)}


def cell_supported(cfg: ModelConfig, cell: ShapeCell | str) -> tuple[bool,
                                                                     str]:
    """Cell applicability per the assignment's skip rules."""
    if isinstance(cell, str):
        cell = SHAPES[cell]
    if cell.name == "long_500k" and not cfg.sub_quadratic():
        return False, ("needs sub-quadratic attention; " + cfg.name +
                       " is pure full-attention (DESIGN SSArch-applicability)")
    return True, ""
