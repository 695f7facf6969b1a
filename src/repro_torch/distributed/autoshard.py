"""The serving mesh in scope.

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
"""

from __future__ import annotations

import contextlib
from typing import Optional

_MESH: Optional[object] = None


@contextlib.contextmanager
def hints(mesh):
    """Make ``mesh`` the active mesh for the enclosed calls."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def enabled() -> bool:
    return _MESH is not None


def active_mesh():
    """The mesh of the enclosing :func:`hints` context (None outside)."""
    return _MESH


def hint(x, *axes):
    """The identity: the port's collectives are explicit, so there is no
    partitioner to constrain (see the module's docstring)."""
    return x
