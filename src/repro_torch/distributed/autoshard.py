"""The mesh in scope (serving and training).

The reference's model code calls ``hint`` with logical axis names and, in
a launcher's :func:`hints` context, XLA's partitioner turns that into
sharding constraints and inserts the collectives itself.  The port has no
partitioner: each rank holds its own shard of the weights and the pool,
and the model code issues its collectives by hand
(``distributed/collectives.py``).  So :func:`hint` is the identity here,
kept so that code written against the reference's names reads the same.

What the port does keep is the context: inside :func:`hints` the
collectives and the kernel dispatch read :func:`active_mesh` to find the
model axis (its size, this rank's place on it, its process group)
without threading the mesh through every call.  Outside one (tests, a
single card) there is no mesh and every collective is the identity.

Training also passes its FSDP plan (``sharding.fsdp_plan``: each
parameter leaf's spec and full shape): the model code then gathers a
leaf over the data axes where it uses it (``collectives.gather_data``).
Serving passes none: its parameters are whole along the data axes.
"""

from __future__ import annotations

import contextlib
from typing import Optional

_MESH: Optional[object] = None
_PLAN: Optional[dict] = None


@contextlib.contextmanager
def hints(mesh, plan: Optional[dict] = None):
    """Make ``mesh`` the active mesh for the enclosed calls, and ``plan``
    (a tree of ``(spec, full shape)`` per parameter leaf) its FSDP plan."""
    global _MESH, _PLAN
    prev = _MESH, _PLAN
    _MESH, _PLAN = mesh, plan
    try:
        yield
    finally:
        _MESH, _PLAN = prev


def enabled() -> bool:
    return _MESH is not None


def active_mesh():
    """The mesh of the enclosing :func:`hints` context (None outside)."""
    return _MESH


def fsdp_plan() -> Optional[dict]:
    """The FSDP plan of the enclosing :func:`hints` context (None: the
    parameters are whole along the data axes)."""
    return _PLAN


def hint(x, *axes):
    """The identity: the port's collectives are explicit, so there is no
    partitioner to constrain (see the module's docstring)."""
    return x
