"""Deterministic synthetic LM batches: ``batch_at(step)`` is a pure
function of (seed, step), so a run resumed at step k sees the batches a
fresh run would have seen.

Tokens follow a Zipf law drawn by inverse CDF from
``numpy.random.default_rng((seed, step))``: the same token arrays, bit for
bit, as the reference's ``repro.data.pipeline.SyntheticLM``; an encdec
batch is ``{"frames" [b, s, d_model] float32, "dec_tokens" [b, dec_len]}``
and a vlm batch ``{"tokens" [b, s - n_patches], "patches" [b, n_patches,
d_model] float32}``, drawn in the reference's order.  numpy only;
the train step moves a batch to its device.  Under a mesh every rank
draws the global batch and keeps its rows (:func:`shard_batch`), so a
mesh run sees the single process's stream.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCell


class SyntheticLM:
    """Stateless: ``batch_at(step)`` is a pure function of (seed, step)."""

    def __init__(self, cfg: ModelConfig, cell: ShapeCell, seed: int = 0,
                 zipf_a: float = 1.2):
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
        cfg = self.cfg
        if cfg.family == "encdec":
            return {
                "frames": rng.standard_normal(
                    (b, s, cfg.d_model)).astype(np.float32),
                "dec_tokens": self._tokens(rng, (b, cfg.dec_len)),
            }
        batch = {"tokens": self._tokens(rng, (b, s))}
        if cfg.family == "vlm":
            # the reference draws the full-length tokens first and then
            # redraws the text tail: the same draws, in the same order
            batch["tokens"] = self._tokens(rng, (b, s - cfg.n_patches))
            batch["patches"] = rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        return batch

    def iterate(self, start_step: int = 0):
        """Resume-aware iterator: skip-ahead is O(1) (exactly-once)."""
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1


def shard_batch(batch: dict, mesh, specs) -> dict:
    """This rank's rows of a global host batch: each leaf cut along the
    data axes its spec names (``sharding.batch_specs``: the batch dim over
    the data axes where it divides, else whole).  The model ranks at one
    data index read the same rows."""
    from repro_torch.distributed.sharding import local_shard

    axes = tuple(a for a in mesh.axis_names if a != "model")
    return {k: local_shard(np.asarray(x), specs[k], mesh, axes)
            for k, x in batch.items()}
