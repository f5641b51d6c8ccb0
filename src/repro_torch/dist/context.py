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
unmodified on one rank.

The data axes carry the batch (:func:`dp_axes`, overridable with
:func:`set_batch_axes` as in the reference). Where the reference's GSPMD
partitioner places rows by sharding annotations, the port's engine cuts
them itself and says so with :func:`row_shard`: code that mixes rows (a
capacity-bound MoE dispatch) reads :func:`current_rows` to learn whether
its tokens are the whole batch or one data shard of it. The reference's
``constrain``/``constrain_dims`` are GSPMD placement hints with no
counterpart in explicit layouts: the port's tensors already have the
planner's local shapes (ROADMAP Queue 3, differences by design).

Where params are cut over the data axes (ZeRO-3), :func:`param_layout`
declares their shardings so the model code gathers each unit before
use; :func:`batch_axes` sets the batch axes for a block (every axis
under "fsdp", :func:`fsdp_batch_axes`). The state is thread-local, and
autograd runs a CUDA backward on a thread of its own: :func:`snapshot`
and :func:`restored` carry it there (a remat layer's recomputation).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

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

    def group(self, axis):
        """The process group along ``axis``, or along a tuple of axes
        (their lines taken together, as the data axes are, or every axis
        at once); None when it has one rank. Axes of size 1 drop out."""
        axes = line_axes(self, axis)
        if not axes:
            return None
        return self.groups.get(axes[0] if len(axes) == 1 else axes)

    def rank_at(self, **coords) -> int:
        """The rank at this rank's coordinates with ``coords`` replaced
        (e.g. ``rank_at(data=0)``: this rank's peer on data row 0)."""
        where = dict(self.coords or {}, **coords)
        return int(self.devices[tuple(where[a] for a in self.axis_names)])

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def line_axes(mesh, axes) -> tuple:
    """``axes`` (a name or a tuple of names) in the mesh's own order,
    without the axes of size 1: the key of the line the ranks along them
    form. Every rank of the line holds block ``line_index`` of a dim cut
    over them, and the line's process group ranks them in that order."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    return tuple(a for a in mesh.axis_names
                 if a in axes and int(mesh.shape[a]) > 1)


def line_index(mesh, axes) -> int:
    """This rank's row-major index along ``axes`` taken together."""
    index = 0
    for a in line_axes(mesh, axes):
        index = index * int(mesh.shape[a]) + mesh.coord(a)
    return index


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


def set_batch_axes(axes: Optional[Sequence[str]]):
    """Override which mesh axes carry the batch (``None`` restores the
    default). Axes absent from the mesh are ignored at query time."""
    _STATE.batch_axes = tuple(axes) if axes is not None else None


def dp_axes(mesh=None) -> tuple:
    """The data-parallel (batch) mesh axes, honouring
    :func:`set_batch_axes`. Default: every mesh axis except "model"; ()
    without a mesh."""
    mesh = mesh if mesh is not None else get_mesh()
    override = _get("batch_axes")
    if override is not None:
        if mesh is None:
            return tuple(override)
        return tuple(a for a in override if a in mesh.shape)
    if mesh is None:
        return ()
    return tuple(a for a in mesh.axis_names if a != "model")


@contextmanager
def batch_axes(axes: Optional[Sequence[str]]):
    """:func:`set_batch_axes` for the block inside, restored on exit."""
    prev = _get("batch_axes")
    set_batch_axes(axes)
    try:
        yield
    finally:
        _STATE.batch_axes = prev


def fsdp_batch_axes(mesh=None) -> tuple:
    """The batch axes of the "fsdp" layout: every mesh axis, "model"
    included, as the reference's pure-FSDP cells set them
    (``set_batch_axes``); a train step under "fsdp" cuts its rows over
    them."""
    mesh = mesh if mesh is not None else get_mesh()
    return tuple(mesh.axis_names) if mesh is not None else ()


def dp_size(mesh=None) -> int:
    """Ranks along the data axes taken together (1 without a mesh)."""
    mesh = mesh if mesh is not None else get_mesh()
    return int(np.prod([axis_size(a, mesh) for a in dp_axes(mesh)] or [1]))


def dp_index(mesh=None) -> int:
    """This rank's row-major index along the data axes taken together."""
    mesh = mesh if mesh is not None else get_mesh()
    index = 0
    for a in dp_axes(mesh):
        index = index * axis_size(a, mesh) + mesh.coord(a)
    return index


def dp_group(mesh=None):
    """The process group of this rank's line along the data axes (None
    when they hold one rank)."""
    mesh = mesh if mesh is not None else get_mesh()
    if dp_size(mesh) <= 1:
        return None
    axes = tuple(a for a in dp_axes(mesh) if axis_size(a, mesh) > 1)
    group = mesh.group(axes)
    if group is None:
        raise ValueError(f"{mesh} has no process group on {axes}")
    return group


# ---------------------------------------------------------------------------
# Params cut over the data axes (ZeRO-3)
# ---------------------------------------------------------------------------


@contextmanager
def param_layout(shardings):
    """Declare that the params the model code reads are this rank's shards
    as ``shardings`` (a tree of ``dist.sharding.Sharding`` mirroring the
    params) cuts them: a leaf cut over the data axes is gathered before
    use (``dist.collectives.gathered``). ``None`` declares leaves ready to
    use. Nests like :func:`mesh_context`."""
    prev = _get("layout")
    _STATE.layout = shardings
    try:
        yield
    finally:
        _STATE.layout = prev


def get_param_layout():
    """The shardings of :func:`param_layout`, or None."""
    return _get("layout")


# ---------------------------------------------------------------------------
# Row sharding of the activations
# ---------------------------------------------------------------------------


@contextmanager
def row_shard(n: int, index: int):
    """Declare that the activations computed inside hold data shard
    ``index`` of ``n`` equal shards of the batch's rows (``n == 1``: the
    whole batch). Nests like :func:`mesh_context`."""
    prev = _get("rows")
    _STATE.rows = (int(n), int(index))
    try:
        yield
    finally:
        _STATE.rows = prev


_FIELDS = ("mesh", "batch_axes", "layout", "rows")


def snapshot() -> dict:
    """This thread's context (mesh, batch axes, param layout, rows), for
    :func:`restored` on another thread: autograd runs a CUDA backward,
    and a remat layer's recomputation in it, on a thread of its own."""
    return {f: _get(f) for f in _FIELDS}


@contextmanager
def restored(state: dict):
    """The context of :func:`snapshot` on this thread, the previous one
    back on exit."""
    prev = snapshot()
    for f, v in state.items():
        setattr(_STATE, f, v)
    try:
        yield
    finally:
        for f, v in prev.items():
            setattr(_STATE, f, v)


def current_rows() -> Tuple[int, int]:
    """(shards, index) of the rows being computed: (1, 0) unless inside
    :func:`row_shard`."""
    return _get("rows") or (1, 0)
