"""Learning-rate schedules: float32 functions of an integer step tensor."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float = 3e-4,
                  warmup: int = 100, total: int = 10000,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total``."""
    s = step.to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float = 3e-4,
             **_) -> torch.Tensor:
    return torch.full_like(step, peak_lr, dtype=torch.float32)
