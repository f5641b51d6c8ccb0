"""Checkpointing: atomic save/restore of params + optimizer + data cursor.

Counterpart of ``repro.training.checkpoint``, with the same contract and
the same on-disk layout:
  * saves are atomic (write to ``step_%010d.tmp``, fsync, rename to
    ``step_%010d``) — a crash mid-save never corrupts the latest
    checkpoint;
  * ``arrays.npz`` holds the leaves as ``leaf_i`` in the reference's
    flattening order (depth first, dict keys sorted), bf16
    stored as raw ``uint8`` bytes beside a dtype manifest (numpy has no
    bfloat16); ``manifest.json`` records ``step``, ``n_leaves``, the
    structure, the ``dtypes`` and ``extra`` (the data cursor), so a restart
    resumes bit-exact into the same batch sequence;
  * retention keeps the last N checkpoints for rollback.

Where the reference writes ``str(treedef)`` the manifest holds the port's
own structure string (``tree.tree_structure``) under the same key.

Under a mesh (``shardings=``, a tree of ``dist.sharding.Sharding``
mirroring the state, under the ambient ``dist.context.Mesh``) a leaf is
this rank's block: ``save`` gathers each leaf whole over the ranks that
cut it (``dist.collectives.whole``, every rank taking part) and rank 0
writes it, as the reference's ``np.asarray`` gathers a sharded array, so
the file is the one a single rank writes; ``restore`` reads the whole
leaf and keeps this rank's block.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist import collectives
from repro_torch.dist import context as dctx
from repro_torch.dist.sharding import Sharding
from repro_torch.tree import (tree_leaves_with_path, tree_map_with_path,
                              tree_structure)

# torch dtype <-> the numpy dtype name the manifest records
_NP_NAMES = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.bfloat16: "bfloat16",
             torch.int64: "int64", torch.int32: "int32", torch.int8: "int8",
             torch.uint8: "uint8", torch.bool: "bool"}


def _to_numpy(t: torch.Tensor):
    """(array to store, dtype name): bf16 as its raw bytes."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint8).numpy(), "bfloat16"
    if t.dtype not in _NP_NAMES:
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    return t.numpy(), _NP_NAMES[t.dtype]


def _from_numpy(arr: np.ndarray, meta: dict) -> torch.Tensor:
    if meta["dtype"] == "bfloat16":
        flat = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
        return flat.view(torch.bfloat16).reshape(meta["shape"])
    return torch.from_numpy(np.array(arr)).reshape(meta["shape"])


def _flatten(tree) -> list:
    """(path, leaf) pairs in ``jax.tree.flatten``'s order: depth first,
    dict keys sorted, sequences in order (siblings' keys share a type, so
    sorting the paths gives exactly that order)."""
    return sorted(tree_leaves_with_path(tree), key=lambda pl: pl[0])


def _cuts(shardings) -> dict:
    return dict(tree_leaves_with_path(
        shardings, lambda x: isinstance(x, Sharding))) if shardings else {}


def save(ckpt_dir: str, step: int, state: dict, *, keep: int = 3,
         extra: Optional[dict] = None, shardings=None) -> str:
    """state: any tree of tensors (params/opt_state/...). Returns path.
    With ``shardings`` every rank of the ambient mesh calls this: the
    leaves are gathered whole and rank 0 writes them."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if shardings is not None:
        cuts = _cuts(shardings)
        state = tree_map_with_path(
            lambda p, t: collectives.whole(t, cuts[p]) if p in cuts else t,
            state)
        mesh = dctx.get_mesh()
        if mesh.rank == 0:
            save(ckpt_dir, step, state, keep=keep, extra=extra)
        torch.distributed.barrier()  # no rank reads before it is written
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = [leaf for _, leaf in _flatten(state)]
    arrs, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arr, name = _to_numpy(leaf)
        dtypes.append({"dtype": name, "shape": list(leaf.shape)})
        arrs[f"leaf_{i}"] = arr
    np.savez(os.path.join(tmp, "arrays.npz"), **arrs)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": tree_structure(state),
        "dtypes": dtypes,
        "time": time.time(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)  # atomic on POSIX

    _retain(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str) -> list:
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                  and not d.endswith(".tmp"))


def _retain(ckpt_dir: str, keep: int):
    for d in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _steps(ckpt_dir)
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1])


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            shardings=None):
    """Restore into the structure of ``like``: each leaf takes the dtype and
    device of ``like``'s leaf at its position. With ``shardings`` the
    leaves of ``like`` are this rank's blocks, and each whole leaf read
    is cut to its block. Returns (state, manifest)."""
    cuts = _cuts(shardings)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = _flatten(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(like_leaves)} — structure mismatch")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        new = {}
        for i, (p, leaf) in enumerate(like_leaves):
            t = _from_numpy(data[f"leaf_{i}"], manifest["dtypes"][i])
            if p in cuts:
                t = cuts[p].slice(t).clone()
            new[p] = t.to(device=leaf.device, dtype=leaf.dtype)
    return tree_map_with_path(lambda p, _: new[p], like), manifest
