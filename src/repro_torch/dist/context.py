"""Thread-local mesh context: the ranks, their axes and process groups.

Counterpart of ``repro.dist.context``. A :class:`Mesh` is a grid of
ranks with named axes (the port's stand-in for ``jax.sharding.Mesh``):
its ``devices`` are the rank grid, ``shape`` maps each axis to its size,
and it knows this rank's coordinate and one process group per axis
(``None`` where the axis has size 1: a one-rank mesh needs no process
group). ``launch.mesh.make_host_mesh`` builds one over the ranks of the
initialised default group.

Everything here is mesh-optional: with no active mesh every function
degrades to a default (size 1, no axes), so the same model code runs
unmodified on one rank. The reference's ``set_batch_axes`` and sharding
constraints (``constrain``/``constrain_dims``) serve GSPMD layouts of a
data axis and tensor-parallel params, which the port does not have yet
(ROADMAP Queue 1 #4.1, a data axis larger than 1, and #4.2,
tensor-parallel params).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence

import numpy as np

_STATE = threading.local()


def _get(name, default=None):
    return getattr(_STATE, name, default)


class Mesh:
    """Named axes over a grid of ranks.

    Args:
      devices: the rank grid, one axis per name (``devices.size`` ranks).
      axis_names: one name per grid axis.
      rank: this process's rank (0 on a one-rank mesh).
      groups: axis name -> the process group of this rank's line along
        that axis; axes of size 1 need none.
    """

    def __init__(self, devices, axis_names: Sequence[str], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"rank grid {self.devices.shape} does not match "
                             f"axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = int(rank)
        where = np.argwhere(self.devices == self.rank)
        self.coords = (dict(zip(self.axis_names, (int(c) for c in where[0])))
                       if len(where) else None)
        self.groups = dict(groups or {})

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        if axis not in self.shape:
            return 0
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in this mesh")
        return self.coords[axis]

    def group(self, axis: str):
        """The process group along ``axis`` (None when it has one rank)."""
        return self.groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------


@contextmanager
def mesh_context(mesh):
    """Install ``mesh`` as the ambient mesh for this thread.

    Nests: the previous mesh (possibly None) is restored on exit, even on
    exception.
    """
    prev = _get("mesh")
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def get_mesh():
    """The ambient mesh, or None outside any ``mesh_context``."""
    return _get("mesh")


def axis_size(name: str, mesh=None) -> int:
    """Size of mesh axis ``name``; 1 if there is no mesh or no such axis."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or name not in mesh.shape:
        return 1
    return int(mesh.shape[name])


# ---------------------------------------------------------------------------
# Data-parallel axes
# ---------------------------------------------------------------------------


def dp_axes(mesh=None) -> tuple:
    """The data-parallel (batch) mesh axes: every mesh axis except
    "model"; () without a mesh."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in mesh.axis_names if a != "model")
