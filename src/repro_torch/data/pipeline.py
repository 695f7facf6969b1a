"""Deterministic synthetic LM batches: ``batch_at(step)`` is a pure
function of (seed, step), so a run resumed at step k sees the batches a
fresh run would have seen.

Tokens follow a Zipf law drawn by inverse CDF from
``numpy.random.default_rng((seed, step))``: the same token arrays, bit for
bit, as the reference's ``repro.data.pipeline.SyntheticLM``.  numpy only;
the train step moves a batch to its device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import (UNTRAINED_FAMILIES, ModelConfig,
                                      ShapeCell, check_ported)


class SyntheticLM:
    """Stateless: ``batch_at(step)`` is a pure function of (seed, step)."""

    def __init__(self, cfg: ModelConfig, cell: ShapeCell, seed: int = 0,
                 zipf_a: float = 1.2):
        check_ported(cfg, "training", UNTRAINED_FAMILIES)
        self.cfg = cfg
        self.cell = cell
        self.seed = seed
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** -zipf_a
        self.cdf = np.cumsum(probs / probs.sum())

    def _tokens(self, rng, shape):
        u = rng.random(shape)
        return np.searchsorted(self.cdf, u).astype(np.int32).clip(
            0, self.cfg.vocab - 1)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.cell.global_batch, self.cell.seq_len
        return {"tokens": self._tokens(rng, (b, s))}

    def iterate(self, start_step: int = 0):
        """Resume-aware iterator: skip-ahead is O(1) (exactly-once)."""
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1
