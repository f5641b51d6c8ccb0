"""Weight bridge: the reference's parameter tree -> the port's.

The reference (``repro.models.model_zoo.Model.init``) stacks every pattern
position's leaves along a leading "layers" axis of size ``n_groups``
(``params["blocks"][p]`` holds layers ``p, p + period, ...``); the port
keeps one tree per layer. ``from_reference`` takes the reference tree as
numpy arrays, unstacks the blocks, and casts each leaf to the port's
declared dtype (bf16 weights, fp32 norms). It raises on any missing or
extra leaf and on any shape that disagrees.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, is_axspec
from repro_torch.models.transformer import lm_specs
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path


def reference_path(cfg: ModelConfig, path: tuple):
    """(reference leaf path, layer-group index or None) of a port path."""
    if path[0] == "blocks":
        layer = path[1]
        return ("blocks", layer % cfg.period) + path[2:], layer // cfg.period
    return path, None


def from_reference(params_np, cfg: ModelConfig, device="cuda"):
    """Reference param tree (nested dicts/tuples of numpy arrays, bf16 or
    fp32) -> the port's tree of tensors on ``device``."""
    ref = {path: np.asarray(leaf)
           for path, leaf in tree_leaves_with_path(params_np)}
    used = set()

    def convert(path, spec):
        rpath, group = reference_path(cfg, path)
        if rpath not in ref:
            raise KeyError(f"reference tree has no leaf {rpath}")
        arr = ref[rpath]
        used.add(rpath)
        want = spec.shape if group is None else (cfg.n_groups,) + spec.shape
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"leaf {rpath}: shape {arr.shape}, want {want}")
        if group is not None:
            arr = arr[group]
        if arr.dtype.name == "bfloat16":  # ml_dtypes; exact in fp32
            arr = arr.astype(np.float32)
        return torch.tensor(arr).to(device=device, dtype=spec.dtype)

    out = tree_map_with_path(convert, lm_specs(cfg), is_axspec)
    extra = sorted(map(str, set(ref) - used))
    if extra:
        raise KeyError(f"reference leaves with no port counterpart: {extra}")
    return out
