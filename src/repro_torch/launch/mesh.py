"""Rank meshes for one host: process groups, backends and spawned ranks.

Counterpart of ``repro.launch.mesh`` (``make_production_mesh``,
``make_host_mesh``, ``n_chips``). JAX sees every local device from one
process; PyTorch runs one process per rank, so a mesh spans the ranks of
the initialised default process group (or one rank with no group).
:func:`make_production_mesh` is the pod layout, (16, 16) over ("data",
"model") or (2, 16, 16) over ("pod", "data", "model"): 256 or 512 ranks,
one GPU each, launched across hosts by ``torchrun`` (NCCL, each rank on
its local GPU as :func:`init_from_env` sets it). The compile-only dry run
(``launch.dryrun``) plays one rank of it under the ``"fake"`` backend.

Backends follow the layout: NCCL when every rank has a GPU of its own,
gloo when ranks share a card or run on the CPU (NCCL refuses two ranks on
one device). :func:`init_distributed` prints the one it picked. Nothing
here falls back: a rank that cannot join raises.

Launching: ``torchrun --nproc-per-node M`` sets ``RANK`` and
``WORLD_SIZE`` (and a TCP rendezvous); :func:`spawn_ranks` starts M
processes of a command itself with a file rendezvous
(``REPRO_TORCH_STORE``), which needs no port. :func:`init_from_env` joins
either way.
"""
from __future__ import annotations

import atexit
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.context import Mesh

STORE_ENV = "REPRO_TORCH_STORE"
# how long a gloo rank waits at exit for its peers before tearing down
EXIT_BARRIER = timedelta(seconds=60)


def pick_backend(world_size: int, device) -> str:
    """NCCL when each of ``world_size`` ranks has a CUDA device of its
    own, else gloo (ranks share a card, or run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(rank: int, world_size: int, *, device,
                     store_path: Optional[str] = None,
                     init_method: Optional[str] = None) -> str:
    """Join the default process group as ``rank`` of ``world_size``:
    through a ``FileStore`` at ``store_path``, or ``init_method`` (e.g.
    ``env://`` under torchrun). Returns the backend
    (:func:`pick_backend`), after printing it."""
    backend = pick_backend(world_size, device)
    kw = {}
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world_size)
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    # tear the group down before the interpreter does: left to exit, gloo's
    # threads can abort the process after its work is done
    atexit.register(_destroy)
    layout = ("one GPU a rank" if backend == "nccl"
              else f"ranks share {torch.device(device).type}")
    print(f"rank {rank} of {world_size}: process group backend {backend} "
          f"({layout})", flush=True)
    return backend


def _destroy():
    if not dist.is_initialized():
        return
    if dist.get_backend() == "gloo":
        # every rank reaches teardown before any destroys its group: a
        # rank destroying while a peer's gloo threads still run aborted
        # that peer ("terminate called without an active exception") now
        # and then; a rank that never arrives (it failed) is waited for
        # at most EXIT_BARRIER
        try:
            dist.monitored_barrier(timeout=EXIT_BARRIER)
        except RuntimeError:
            pass
    dist.destroy_process_group()


def rank_env() -> tuple:
    """(rank, world size) from the environment (1 rank when unset)."""
    return int(os.environ.get("RANK", 0)), int(os.environ.get(
        "WORLD_SIZE", 1))


def init_from_env(device) -> torch.device:
    """Join the process group this process was started into (by
    :func:`spawn_ranks` or torchrun; none when it runs alone) and return
    the device this rank computes on: ``device``, or under NCCL the GPU
    of the rank's own index."""
    rank, world = rank_env()
    device = torch.device(device)
    if world > 1 and not dist.is_initialized():
        store = os.environ.get(STORE_ENV)
        backend = init_distributed(rank, world, device=device,
                                   store_path=store,
                                   init_method=None if store else "env://")
        if backend == "nccl":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
    return device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh, (16, 16) over ("data", "model") or, with
    ``multi_pod``, (2, 16, 16) over ("pod", "data", "model"), laid
    row-major over the ranks of the default process group (rank r at
    position r, as JAX's ``make_mesh`` lays its devices), with this rank's
    process groups. Raises ``ValueError`` naming both counts when the
    world holds another number of ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {need} ranks; the process group has "
                         f"{world}")
    return make_host_mesh(shape, axes)


def make_host_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """A mesh of ``shape`` over the ranks of the default process group
    (one rank without one), rank r at row-major position r, with this
    rank's process groups (:func:`line_groups`)."""
    shape = tuple(int(n) for n in shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{int(np.prod(shape))} ranks; {world} running")
    grid = np.arange(world).reshape(shape)
    return Mesh(grid, axes, rank=rank, groups=line_groups(grid, axes))


def line_groups(grid, axes) -> Dict[object, object]:
    """The process groups of a mesh over the rank grid ``grid`` (global
    ranks, one grid axis per name of ``axes``): one group per line of
    every axis longer than 1, of the data axes taken together when more
    than one of them is, and of every axis at once when that is another
    set again (a leaf cut over every axis, "fsdp"; the grad norm; a
    slice's agreement). Every rank of the world makes every group, in
    the same order, as ``new_group`` requires, also for a grid it is not
    in (a slice of another replica); returns this rank's, keyed by axis
    or tuple of axes (none for a rank outside the grid). A line that
    spans the whole world is the default group."""
    grid = np.asarray(grid)
    shape = grid.shape
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    groups: Dict[object, object] = {}
    every = tuple(axis for axis, n in zip(axes, shape) if n > 1)
    lined = [(axis,) for axis in every]
    data = tuple(a for a in every if a != "model")
    if len(data) > 1:  # the data axes taken together carry the batch
        lined.append(data)
    if len(every) > 1 and every != data:  # every axis at once
        lined.append(every)
    for line_axes in lined:
        dims = [axes.index(a) for a in line_axes]
        rest = [i for i in range(len(axes)) if i not in dims]
        n = int(np.prod([shape[i] for i in dims]))
        lines = np.transpose(grid, rest + dims).reshape(-1, n)
        for line in lines:
            ranks = [int(r) for r in line]
            group = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks))
            if rank in ranks:
                groups[line_axes if len(line_axes) > 1
                       else line_axes[0]] = group
    return groups


def n_chips(mesh: Mesh) -> int:
    """Ranks in the mesh."""
    return int(mesh.devices.size)


def spawn_ranks(argv: Sequence[str], world_size: int, *, store_path: str,
                timeout: float, env: Optional[dict] = None,
                cwd: Optional[str] = None
                ) -> List[subprocess.CompletedProcess]:
    """Run ``python argv...`` as ``world_size`` processes that join one
    group through a ``FileStore`` at ``store_path`` (which must not exist
    yet): rank r gets ``RANK``, ``WORLD_SIZE`` and ``REPRO_TORCH_STORE``.
    Waits for all; when one fails or ``timeout`` seconds pass, kills the
    others. Returns each rank's completed process (stdout, stderr)."""
    if os.path.exists(store_path):
        raise ValueError(f"{store_path} exists: a FileStore needs a new file")
    procs, outs = [], []
    for rank in range(world_size):
        penv = dict(os.environ if env is None else env, RANK=str(rank),
                    WORLD_SIZE=str(world_size), **{STORE_ENV: store_path})
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        outs.append((out, err))
        procs.append(subprocess.Popen([sys.executable, *argv], env=penv,
                                      cwd=cwd, text=True, stdout=out,
                                      stderr=err))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    done = []
    for p, (out, err) in zip(procs, outs):
        code = p.wait()
        out.seek(0)
        err.seek(0)
        done.append(subprocess.CompletedProcess(p.args, code, out.read(),
                                                err.read()))
        out.close()
        err.close()
    return done
