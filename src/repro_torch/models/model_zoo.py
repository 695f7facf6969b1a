"""Model facade: build an architecture from its config on a device.

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``; nothing moves to the CPU by itself when there is no card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


class Model:
    """A config bound to a device; the scheduler and entry points take
    it with the parameters made by :meth:`init`."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, seed: int = 0, dtype: torch.dtype | None = None):
        """Random weights from a seeded generator on the device."""
        return transformer.init_lm(self.cfg, seed=seed, device=self.device,
                                   dtype=dtype)

    def loss(self, params, batch: dict, policy=None):
        """Mean next-token CE of ``batch`` (tensors on the device);
        ``policy`` overrides the config's SoftmaxPolicy for the loss."""
        return transformer.train_loss(params, batch, cfg=self.cfg,
                                      policy=policy)


def build_model(arch: str, reduced: bool = False, device="cuda",
                **overrides) -> Model:
    """``device`` defaults to ``cuda`` and raises where there is no card:
    the CPU is taken only when asked for."""
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
    return Model(cfg, device)
