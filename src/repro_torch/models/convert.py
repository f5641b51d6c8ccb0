"""Weight bridge: the reference's parameter tree -> the port's.

The reference (``repro.models.model_zoo.Model.init``) stacks every pattern
position's leaves along a leading "layers" axis of size ``n_groups``
(``params["blocks"][p]`` holds layers ``p, p + period, ...``); the port
keeps one tree per layer. ``from_reference`` takes the reference tree as
numpy arrays, unstacks the blocks, and casts each leaf to the port's
declared dtype (bf16 weights, fp32 norms). It raises on any missing or
extra leaf and on any shape that disagrees. ``cache_from_reference`` does
the same for a decode cache, so a test can hand both sides one cache.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, is_axspec
from repro_torch.models.transformer import Cache, lm_specs
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path


def reference_path(cfg: ModelConfig, path: tuple):
    """(reference leaf path, layer-group index or None) of a port path."""
    if path[0] == "blocks":
        layer = path[1]
        return ("blocks", layer % cfg.period) + path[2:], layer // cfg.period
    return path, None


def _to_tensor(arr, dtype, device):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes; exact in fp32
        arr = arr.astype(np.float32)
    return torch.tensor(arr).to(device=device, dtype=dtype)


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
        return _to_tensor(arr, spec.dtype, device)

    out = tree_map_with_path(convert, lm_specs(cfg), is_axspec)
    extra = sorted(map(str, set(ref) - used))
    if extra:
        raise KeyError(f"reference leaves with no port counterpart: {extra}")
    return out


def cache_from_reference(cache_np, cfg: ModelConfig, device="cuda") -> Cache:
    """Reference dense decode cache -> the port's ``Cache`` on ``device``.

    ``cache_np`` has the reference ``Cache``'s fields with numpy leaves:
    ``layers`` (one ``{"k", "v"}`` dict per pattern position, leaves
    stacked (G, B, T, KV, hd)) and ``lengths`` (B,). Layer ``l`` of the
    port is group ``l // period`` of pattern position ``l % period``.
    """
    layers = []
    for layer in range(cfg.n_layers):
        ref = cache_np.layers[layer % cfg.period]
        if set(ref) != {"k", "v"}:
            raise KeyError(f"want a bf16 dense cache with k and v leaves, "
                           f"got {sorted(ref)}")
        want = (cfg.n_groups,) + tuple(np.shape(ref["k"]))[1:]
        for name in ("k", "v"):
            shape = tuple(np.shape(ref[name]))
            if shape != want or len(want) != 5:
                raise ValueError(f"cache leaf {name}: shape {shape}, want "
                                 f"(G={cfg.n_groups}, B, T, KV, hd)")
        group = layer // cfg.period
        layers.append({name: _to_tensor(np.asarray(ref[name])[group],
                                        torch.bfloat16, device)
                       for name in ("k", "v")})
    return Cache(layers=tuple(layers),
                 lengths=_to_tensor(cache_np.lengths, torch.int32, device))
