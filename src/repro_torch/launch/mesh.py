"""Device meshes over ``torch.distributed``, with the reference's axis names.

A :class:`Mesh` exposes what the rule tables read (``axis_names`` and
``devices.shape``, as a JAX mesh) and what the explicit collectives need
(each axis's process group, this rank's index along it, the backend).
The groups are made by hand (``dist.new_group`` for every line of ranks
along each axis, every rank making all of them in one order), which is
what a torch ``DeviceMesh`` would make, without importing DTensor.

The backend is always the caller's word, never guessed: ``"nccl"`` where
each rank has a card of its own, ``"gloo"`` otherwise (several ranks on
one card, which NCCL refuses, or the CPU).  ``gloo`` carries CUDA tensors
through host memory, and a CUDA graph cannot capture it; its collectives
take tensors of either device and its ranks may share one card.

The process group comes from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``), or from an
``init_method`` the caller passes (a ``file://`` store in the tests).  The
world size must equal the mesh's size.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class Mesh:
    """A named mesh of ranks.  ``devices`` is the ranks' grid (numpy, the
    mesh's shape), as a JAX mesh's array of devices; ``lines`` maps each
    axis to ``(process group of this rank's line along it, this rank's
    index on it)`` (empty for a mesh of one rank outside any process
    group)."""
    axis_names: tuple[str, ...]
    devices: np.ndarray
    backend: str
    lines: dict = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.lines[axis][0]

    def local_rank(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on a one-rank mesh)."""
        if not self.lines or axis not in self.axis_names:
            return 0
        return self.lines[axis][1]


def _init_group(backend: str, world: int, init_method: str | None,
                rank: int | None) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}"
                             f", not {backend!r}")
    else:
        kw = {}
        if init_method is not None:
            kw = dict(init_method=init_method, world_size=world, rank=rank)
        dist.init_process_group(backend, **kw)
    if dist.get_world_size() != world:
        raise ValueError(f"a mesh of {world} ranks in a world of "
                         f"{dist.get_world_size()}")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              backend: str, init_method: str | None = None,
              rank: int | None = None) -> Mesh:
    """A mesh of ``prod(shape)`` ranks named ``axes`` (every rank calls
    it).  A mesh of one rank needs no process group."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    world = int(np.prod(shape))
    if world == 1 and not dist.is_initialized():
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: expected one of "
                             f"{BACKENDS}")
        return Mesh(tuple(axes), np.zeros(shape, np.int64), backend)
    _init_group(backend, world, init_method, rank)
    grid = np.arange(world).reshape(shape)
    me = dist.get_rank()
    lines = {}
    for i, axis in enumerate(axes):
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
            group = dist.new_group([int(r) for r in line])
            if me in line:
                lines[axis] = (group, int(np.flatnonzero(line == me)[0]))
    return Mesh(tuple(axes), grid, backend, lines)


def make_serving_mesh(shape: tuple[int, int] | None = None, *,
                      backend: str, init_method: str | None = None,
                      rank: int | None = None) -> Mesh:
    """``('data', 'model')`` mesh for sharded serving.  By default every
    rank of the world is on the model axis (pure tensor parallelism over
    KV heads); ``shape=(data, model)`` splits off a data axis."""
    if shape is None:
        shape = (1, dist.get_world_size() if dist.is_initialized() else 1)
    return make_mesh(tuple(shape), ("data", "model"), backend=backend,
                     init_method=init_method, rank=rank)


def make_production_mesh(*, multi_pod: bool = False) -> tuple:
    """The reference's production layout, shape and axis names only:
    16 x 16 ``('data', 'model')``, 2 x 16 x 16 with a leading ``'pod'``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def data_axes(mesh) -> tuple[str, ...]:
    """Axes gradients are reduced over (everything that is not 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def mesh_tp(mesh) -> int:
    """The model axis's size (1 without a mesh or a model axis)."""
    if mesh is None:
        return 1
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DATAxMODEL"`` (the CLI's ``--mesh``) -> ``(data, model)``."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DATAxMODEL, e.g. 1x2")
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {text!r}: axes must be at least 1")
    return d, m


def torch_device_for(mesh: Mesh, device: str) -> torch.device:
    """The device a rank of ``mesh`` computes on: ``cuda:<i>`` with one card
    a rank under NCCL (``i`` the rank's index on its host, torchrun's
    ``LOCAL_RANK``), the first card for every rank under gloo (ranks share
    a card), or the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if mesh.backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cuda", 0)
