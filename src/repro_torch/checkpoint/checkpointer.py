"""Checkpointing: atomic, asynchronous, in the reference's on-disk layout.

  * atomic: a step is written to ``step_XXXXXXXXXX.tmp/`` and published
    with ``os.replace``; a crash mid-write leaves the last published step
    as it was, and an unpublished ``.tmp`` directory is never listed.
  * asynchronous: :meth:`Checkpointer.save` copies every tensor to host
    memory now and writes the files on a background thread; ``wait()``
    joins it (before the next save, and at the end of a run).
  * layout: one ``.npy`` per leaf and a ``manifest.json`` with ``step``
    and ``keys``, named as the reference names them: a dict key is its
    name, a NamedTuple field is ``.`` + its name (how JAX prints such a
    path), the path joined with ``/`` in the manifest and ``__`` in file
    names, dict keys in sorted order.  So a ``TrainState`` leaf is e.g.
    ``.opt__.m__blocks__attn__wk__b.npy``, and a float32 state written by
    the reference's ``Checkpointer`` restores here.
  * ``restore`` loads into the structure, dtypes and devices of a target
    state.
  * a mesh: ``save`` writes the global arrays, as the reference's does:
    leaf by leaf, the ranks' shards are sent to rank 0
    (``sharding.gather_to_rank0``), which writes the leaf before the next
    one comes, so that no rank holds more than one global leaf; on a
    blocking save the others wait for the publish.  ``restore`` onto a
    mesh reads each rank's shard of the global arrays (the files mapped,
    not loaded whole), cut by the target's specs: a checkpoint saved on
    one mesh resumes on another, or on none (elastic restore).

numpy has no bfloat16: a bfloat16 leaf is written as float32 (exact) and
restored to the target's dtype.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's order and names."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), prefix + ("." + f,))]
    return [("/".join(prefix), tree)]


def _unflatten(tree, leaves: dict, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves,
                                       prefix + ("." + f,))
                            for f in tree._fields))
    return leaves["/".join(prefix)]


def _encode(key: str) -> str:
    return key.replace("/", "__")


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A host copy (also of a CPU tensor: the train step updates the
    state in place while the background thread writes)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.to("cpu", copy=True).numpy()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    def _path(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:010d}"

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False, mesh=None,
             plan=None) -> None:
        """Copy ``tree`` to host memory now; write it on a background
        thread (now, with ``blocking``).  Saving a step that exists
        replaces it.  Under a ``mesh`` (every rank calls it) ``tree`` holds
        this rank's shards and ``plan`` each leaf's ``(spec, full
        shape)`` (a tree like ``tree``): rank 0 receives each global leaf
        and writes it now, and with ``blocking`` every rank returns once
        the step is published."""
        self.wait()
        if mesh is not None:
            self._save_global(step, tree, mesh, plan)
            if blocking:
                _barrier()
            return
        flat = [(k, _to_host(v)) for k, v in _flatten(tree)]

        def write():
            tmp = self._tmp(step)
            for k, v in flat:
                np.save(tmp / (_encode(k) + ".npy"), v)
            self._publish(step, tmp, [k for k, _ in flat])

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _save_global(self, step: int, tree, mesh, plan) -> None:
        from repro_torch.distributed.sharding import gather_to_rank0

        root = _rank() == 0
        tmp = self._tmp(step) if root else None
        plan_of = dict(_flatten(plan))
        keys = []
        for k, v in _flatten(tree):
            # gloo sends host tensors; NCCL device tensors only
            v = (v.detach() if mesh.backend == "nccl"
                 else torch.from_numpy(_to_host(v)))
            full = gather_to_rank0(v, *plan_of[k], mesh)
            if root:
                np.save(tmp / (_encode(k) + ".npy"),
                        full.numpy() if full.dtype != torch.bfloat16
                        else _to_host(full))
                keys.append(k)
            del full
        if root:
            self._publish(step, tmp, keys)

    def _tmp(self, step: int) -> pathlib.Path:
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        return tmp

    def _publish(self, step: int, tmp: pathlib.Path, keys: list) -> None:
        (tmp / "manifest.json").write_text(
            json.dumps({"step": int(step), "keys": keys}))
        final = self._path(step)
        if final.exists():                   # os.replace needs it gone
            old = self.dir / f"step_{step:010d}.old"
            os.replace(final, old)
            shutil.rmtree(old)
        os.replace(tmp, final)               # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, mesh=None, specs=None):
        """Load ``step`` into the structure of ``target_tree``: each leaf
        becomes a tensor of its target's shape, dtype and device.  Under a
        ``mesh`` the target holds this rank's shards, cut by ``specs`` (a
        tree like it, e.g. ``train_state.state_specs``): each global array
        is cut the same way."""
        if mesh is not None and specs is None:
            raise ValueError("restore onto a mesh needs the target's specs")
        from repro_torch.distributed.sharding import local_shard

        spec_of = dict(_flatten(specs)) if mesh is not None else {}
        src = self._path(step)
        leaves = {}
        for key, tgt in _flatten(target_tree):
            path = src / (_encode(key) + ".npy")
            if mesh is None:
                arr = np.load(path)
            else:                            # read only this rank's shard
                arr = np.array(local_shard(np.load(path, mmap_mode="r"),
                                           spec_of[key], mesh,
                                           tuple(mesh.axis_names)))
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"checkpoint leaf {key}: shape "
                                 f"{arr.shape} != {tuple(tgt.shape)}")
            leaves[key] = torch.from_numpy(arr).to(device=tgt.device,
                                                   dtype=tgt.dtype)
        return _unflatten(target_tree, leaves)

    def restore_latest(self, target_tree, mesh=None, specs=None):
        """``(step, tree)`` of the latest published step, or ``(None,
        None)``; ``mesh`` / ``specs`` as :meth:`restore`'s."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, mesh, specs)
