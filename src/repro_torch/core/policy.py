"""SoftmaxPolicy: one frozen object deciding how every softmax site runs.

A policy carries which of the paper's three algorithms runs, whether the
hand-written CUDA kernels are used (vs the plain tensor forms), explicit
attention block-shape overrides, and whether resolution may consult the
persisted autotune cache.  ``configs/base.py`` builds it once per
``ModelConfig`` (:meth:`ModelConfig.softmax_policy`).  Block shapes resolve
through ``repro_torch.kernels.registry``: overrides > the cache (with
``autotune``) > the heuristic.  The CUDA softmax takes no tile
(one thread block sweeps a whole row), so a config's
``softmax_block_rows``/``softmax_block_cols`` are refused rather than
silently ignored.

With ``use_kernels=True`` a kernel wrapper launches its CUDA kernel for a
tensor on the card and runs its plain version for a tensor on the CPU;
``use_kernels=False`` takes the plain ``(m, n)`` forms on any device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import twopass
from repro_torch.core.softmax_api import _ALGOS, SoftmaxAlgorithm

# the ops that take the attention block overrides below
ATTENTION_OPS = ("flash_attention", "chunk_attention", "decode_attention",
                 "decode_attention_paged", "flash_attention_bwd")


@dataclass(frozen=True)
class SoftmaxPolicy:
    algorithm: SoftmaxAlgorithm = SoftmaxAlgorithm.TWO_PASS
    use_kernels: bool = False
    autotune: bool = False               # consult the persisted tune cache
    autotune_cache: Optional[str] = None  # cache file (None: env / default)
    attn_block_q: Optional[int] = None
    attn_block_k: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "algorithm",
                           SoftmaxAlgorithm(self.algorithm))

    def replace(self, **changes) -> "SoftmaxPolicy":
        """A copy with ``changes`` applied (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_config(cls, cfg) -> "SoftmaxPolicy":
        """Build from any object with the ModelConfig softmax knobs."""
        for knob in ("softmax_block_rows", "softmax_block_cols"):
            if getattr(cfg, knob, None) is not None:
                raise ValueError(
                    f"{knob}: the CUDA softmax takes no tile (one thread "
                    "block sweeps each row), so the port has no softmax "
                    "block shape to set")
        return cls(
            algorithm=getattr(cfg, "softmax_algorithm", "two_pass"),
            use_kernels=getattr(cfg, "use_kernels", False),
            autotune=getattr(cfg, "softmax_autotune", False),
            autotune_cache=getattr(cfg, "softmax_autotune_cache", None),
            attn_block_q=getattr(cfg, "attn_block_q", None),
            attn_block_k=getattr(cfg, "attn_block_k", None))

    def resolve_blocks(self, op: str, rows: int, cols: int,
                       dtype=torch.float32, *,
                       block_rows: Optional[int] = None,
                       block_cols: Optional[int] = None,
                       shards: int = 1,
                       backend: Optional[str] = None) -> tuple[int, int]:
        """Explicit args > this policy's attention overrides > (autotune
        cache) > registry heuristic.  ``backend`` ("gpu" | "cpu") is the
        device the op runs on (None: ``registry.default_backend()``);
        ``shards`` keys tensor-parallel variants apart."""
        from repro_torch.kernels import registry

        pbr, pbc = ((self.attn_block_q, self.attn_block_k)
                    if op in ATTENTION_OPS else (None, None))
        return registry.block_shapes(
            op, rows, cols, dtype,
            block_rows=block_rows if block_rows is not None else pbr,
            block_cols=block_cols if block_cols is not None else pbc,
            use_cache=self.autotune, backend=backend,
            cache_file=self.autotune_cache, shards=shards)

    def tune(self, op: str, rows: int, cols: int, dtype=torch.float32, **kw):
        """Sweep one (op, shape) now and persist the best block to this
        policy's cache (``autotune.autotune_op``; it times real calls, on
        the card unless ``device=`` says otherwise)."""
        from repro_torch.kernels import autotune

        return autotune.autotune_op(op, rows, cols, dtype,
                                    cache_file=self.autotune_cache, **kw)

    def softmax(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """Softmax along ``axis``.  The kernel path covers last-axis
        reductions (leading dims collapse to rows); other axes take the
        plain algorithm forms."""
        if self.use_kernels and axis in (-1, x.ndim - 1):
            from repro_torch.kernels import ops

            return ops.softmax(x, algorithm=self.algorithm)
        return _ALGOS[self.algorithm](x, axis=axis)

    def softmax_stats(self, x: torch.Tensor):
        """Pass 1 of the two-pass softmax over the last axis: the rows'
        ``(m_sum, n_sum)`` (an ``ExtFloat``, the axis kept).  With kernels
        it is the stats kernel (``ops.logsumexp_stats``: the CUDA kernel on
        the card, its plain version on the CPU); otherwise the plain form.
        The sharded softmax takes it for each rank's slice."""
        if self.use_kernels:
            from repro_torch.core.numerics import ExtFloat
            from repro_torch.kernels import ops

            lead = x.shape[:-1]
            m, n = ops.logsumexp_stats(x.reshape(-1, x.shape[-1]))
            return ExtFloat(m.reshape(*lead, 1), n.reshape(*lead, 1))
        return twopass.twopass_softmax_stats(x, axis=-1)

    def logsumexp(self, x: torch.Tensor, axis: int = -1,
                  keepdims: bool = False) -> torch.Tensor:
        """logsumexp with the selected algorithm's pass structure."""
        if self.algorithm == SoftmaxAlgorithm.TWO_PASS:
            return twopass.twopass_logsumexp(x, axis=axis, keepdims=keepdims)
        mu = x.amax(dim=axis, keepdim=True)
        s = torch.exp(x - mu).sum(dim=axis, keepdim=True)
        out = (torch.log(s) + mu).to(x.dtype)
        return out if keepdims else out.squeeze(axis)

    def cross_entropy(self, logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        """Per-token CE ([T, V], [T] -> [T] float32).  Kernel path: the
        fused two-pass CE (forward = pass 1, backward = pass 2); otherwise
        this algorithm's logsumexp minus the label logit."""
        if self.use_kernels:
            from repro_torch.kernels import ops

            return ops.cross_entropy(logits, labels)
        x = logits.to(torch.float32)
        lse = self.logsumexp(x, axis=-1)
        ll = torch.gather(x, -1, labels.to(torch.int64)[:, None])[:, 0]
        return lse - ll

    def lmhead_cross_entropy(self, h: torch.Tensor, w: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
        """Fused LM-head CE ([T, D] @ [D, V] vs [T] -> [T] float32).  With
        kernels, neither the logits nor their gradient is stored whole
        (``ops.lmhead_cross_entropy``: the CUDA kernels on the card, the
        plain (m, n) chunked forms on the CPU).  Without: materialised
        float32 logits through :meth:`cross_entropy`."""
        if self.use_kernels:
            from repro_torch.kernels import ops

            return ops.lmhead_cross_entropy(h, w, labels, policy=self)
        logits = h.to(torch.float32) @ w.to(torch.float32)
        return self.cross_entropy(logits, labels)


DEFAULT_POLICY = SoftmaxPolicy()
