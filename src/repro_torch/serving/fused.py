"""The serving engine's decode step captured once in a CUDA graph and
replayed: the counterpart of the reference's ``jax.jit(_fused_decode)``
(``repro.serving.scheduler``), which compiles decode and sampling into one
program.

The port's decode step is a Python loop over the layers that dispatches
every op and kernel from the host, so at full width the host, not the card,
paces it.  A CUDA graph records the step's launches once, and one host call
replays them all.  What that asks of the step:

  * every tensor the graph reads -- the parameters, the pool (an ssm
    pool's state leaves too, and a hybrid pool's ``ssm`` leaf, which each
    step writes with ``copy_``), the
    engine's static step buffers -- is written in place between replays
    and never rebound: :meth:`FusedStep.check` holds their addresses to
    those at capture;
  * nothing in the step waits for the device or allocates outside PyTorch:
    the kernel wrappers allocate with ``torch.empty`` (from the graph's
    pool during capture) and launch on the current stream (the capture
    stream during capture), and the sampler draws without
    ``torch.multinomial``'s host-side check (``engine.sample_token``);
  * the kernels are built and every lazy initialisation done before
    capture: :meth:`CudaGraph.warm_up` runs the step eagerly on a side
    stream first.  Those steps execute, so the engine captures before its
    first admission, while every slot is free: their K/V writes land on
    the paged pool's trash page or on the strip rows that admission
    overwrites, an ssm (or hybrid) pool's state writes are dead state
    that admission replaces whole, and ``lengths`` do not advance (no slot
    is active);
  * a wrapper's ``.launches`` counts when Python calls it, which under a
    graph is at capture only: :class:`FusedStep` takes the capture's
    counts back out and adds them once per replay, so the counters go on
    counting launches on the card.

A capture that fails raises.  Nothing falls back to the eager step: the
engine steps eagerly on the card only when it is built with
``fused=False``.
"""

from __future__ import annotations

import time

import torch

from repro_torch import kernels


def _ptrs(tree, prefix: str = "") -> dict[str, int]:
    """``{path: data_ptr}`` of every tensor in a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ptrs(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.data_ptr()}


def _add_launches(counts: dict[str, int], sign: int) -> None:
    for name, n in counts.items():
        kernels.WRAPPERS[name].launches += sign * n


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the three calls :class:`FusedStep`
    makes.  ``generator``, the ``torch.Generator`` the step draws from, is
    registered with the graph, so that each replay draws anew from it and
    eager draws between replays go on from where the replays left it."""

    WARMUP = 2              # eager steps before capture

    def __init__(self, device, generator: torch.Generator | None = None):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        self.pool_bytes = 0             # the graph's private memory pool

    def warm_up(self, step) -> None:
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    step()
            main.wait_stream(side)

    def capture(self, step) -> None:
        with torch.cuda.device(self.device):
            with torch.cuda.graph(self.graph):
                before = torch.cuda.memory_reserved()
                step()
            self.pool_bytes = torch.cuda.memory_reserved() - before

    def replay(self) -> None:
        self.graph.replay()


def graph_for(device, generator: torch.Generator | None = None):
    """A :class:`CudaGraph` for a device on the card; None for the CPU,
    where the engine steps eagerly."""
    if torch.device(device).type != "cuda":
        return None
    return CudaGraph(device, generator)


class FusedStep:
    """``step`` -- a function of no arguments that reads and writes only
    the tensors of ``buffers`` (a nested dict) and tensors it allocates --
    warmed up and captured once in ``graph`` (a :class:`CudaGraph`, or an
    object with the same three methods and ``pool_bytes``), then replayed
    by calling this object.  ``launches`` holds each wrapper's kernel
    launches in one replay."""

    def __init__(self, step, graph, buffers: dict):
        self.graph = graph
        t0 = time.perf_counter()
        graph.warm_up(step)
        before = kernels.launch_counts()
        graph.capture(step)
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        _add_launches(self.launches, -1)      # the capture ran nothing
        self.capture_s = time.perf_counter() - t0
        self.replays = 0
        self._ptrs = _ptrs(buffers)

    def check(self, buffers: dict) -> None:
        """Raise if a tensor the graph reads was rebound since capture
        (the graph would go on reading the old one)."""
        now = _ptrs(buffers)
        if now != self._ptrs:
            moved = sorted(k for k in self._ptrs.keys() | now.keys()
                           if self._ptrs.get(k) != now.get(k))
            raise RuntimeError(
                "FusedStep: tensors the captured decode step reads were "
                f"rebound since capture ({', '.join(moved)}); write them "
                "in place")

    def __call__(self) -> None:
        self.graph.replay()
        self.replays += 1
        _add_launches(self.launches, 1)

    def info(self) -> dict:
        return dict(capture_s=self.capture_s,
                    graph_pool_bytes=self.graph.pool_bytes,
                    replays=self.replays,
                    launches_per_replay=dict(self.launches))
