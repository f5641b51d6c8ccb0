"""Weight bridge: the reference's parameter tree -> the port's.

The reference (``repro.models.model_zoo.Model.init``) stacks every pattern
position's leaves along a leading "layers" axis of size ``n_groups``
(``params["blocks"][p]`` holds layers ``p, p + period, ...``), and an
encoder-decoder's ``enc_blocks`` / ``dec_blocks`` along one of
``n_enc_layers`` / ``n_layers``; the port keeps one tree per layer.
``from_reference`` takes the reference tree as numpy arrays, unstacks the
layers, and casts each leaf to the port's declared dtype (bf16 weights,
fp32 norms, routers and SSM scalars). It raises on any missing or extra
leaf and on any shape that disagrees. ``cache_from_reference`` does the
same for a decode cache (bf16 or int8 attention layers, SSM layers, or an
encoder-decoder's ``EncDecCache``) and ``paged_cache_from_reference`` for
a paged one, so a test can hand both sides one cache.

``from_reference(..., shardings=)`` gives one rank of a mesh its shard:
it cuts each reference leaf by the planner's ``Sharding``
(``serving.Engine.params_sharding``) in host memory and moves only the
rank's slice to ``device``; ``gather_shards`` puts the ranks' shards back
together.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.sharding import seq_blocks
from repro_torch.models.common import ModelConfig, is_axspec
from repro_torch.models.encdec import EncDecCache
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import Cache, PagedCache
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path


def reference_path(cfg: ModelConfig, path: tuple):
    """(reference leaf path, index along its stacked layer axis or None) of
    a port path."""
    if path[0] == "blocks":
        layer = path[1]
        return ("blocks", layer % cfg.period) + path[2:], layer // cfg.period
    if path[0] in ("enc_blocks", "dec_blocks"):
        return (path[0],) + path[2:], path[1]
    return path, None


def _stacked(cfg: ModelConfig, path: tuple) -> int:
    """Length of the reference's stacked layer axis for a port path."""
    return {"blocks": cfg.n_groups, "enc_blocks": cfg.n_enc_layers,
            "dec_blocks": cfg.n_layers}[path[0]]


def _to_tensor(arr, dtype, device):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes; exact in fp32
        arr = arr.astype(np.float32)
    return torch.tensor(arr).to(device=device, dtype=dtype)


def from_reference(params_np, cfg: ModelConfig, device="cuda",
                   shardings=None):
    """Reference param tree (nested dicts/tuples of numpy arrays, bf16 or
    fp32) -> the port's tree of tensors on ``device``; with ``shardings``
    (a tree of ``dist.sharding.Sharding`` mirroring the port's params)
    each leaf is cut on the host first and only this rank's slice reaches
    ``device``."""
    ref = {path: np.asarray(leaf)
           for path, leaf in tree_leaves_with_path(params_np)}
    cuts = dict(tree_leaves_with_path(shardings)) if shardings else {}
    used = set()

    def convert(path, spec):
        rpath, group = reference_path(cfg, path)
        if rpath not in ref:
            raise KeyError(f"reference tree has no leaf {rpath}")
        arr = ref[rpath]
        used.add(rpath)
        want = (spec.shape if group is None
                else (_stacked(cfg, path),) + spec.shape)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"leaf {rpath}: shape {arr.shape}, want {want}")
        if group is not None:
            arr = arr[group]
        if path in cuts:
            arr = cuts[path].slice(arr)
        return _to_tensor(arr, spec.dtype, device)

    out = tree_map_with_path(convert, build(cfg).param_specs, is_axspec)
    extra = sorted(map(str, set(ref) - used))
    if extra:
        raise KeyError(f"reference leaves with no port counterpart: {extra}")
    return out


def gather_shards(shards, shardings):
    """The whole param tree from every rank's shard: ``shards[r]`` and
    ``shardings[r]`` are rank r's (trees of one structure). Each cut dim
    is concatenated in block order; the replicated ranks' copies must
    agree bit for bit."""
    flat = [(dict(tree_leaves_with_path(tree)),
             dict(tree_leaves_with_path(plan)))
            for tree, plan in zip(shards, shardings)]

    def whole(path, _):
        parts = {}
        for tensors, cuts in flat:
            key = tuple(None if c is None else c[1]
                        for c in cuts[path].cuts)
            t = tensors[path]
            if key in parts and not torch.equal(parts[key], t):
                raise ValueError(f"leaf {path}: replicas of block {key} "
                                 f"differ")
            parts[key] = t
        return _assemble(parts)
    return tree_map_with_path(whole, shards[0])


def _assemble(parts: dict):
    """Blocks keyed by their index along each dim (None: whole) -> one
    tensor, concatenated along the first cut dim, then recursively."""
    key = next(iter(parts))
    dim = next((d for d, i in enumerate(key) if i is not None), None)
    if dim is None:
        return parts[key]
    blocks = sorted({k[dim] for k in parts})
    return torch.cat([_assemble({k[:dim] + (None,) + k[dim + 1:]: v
                                 for k, v in parts.items() if k[dim] == b})
                      for b in blocks], dim=dim)


# cache leaf names of each layer kind; None: int8 or bf16, by the layer
_KV = {"k": None, "v": None}
_KV_INT8 = dict(_KV, k_scale=torch.float32, v_scale=torch.float32)
_SSM = {"conv_x": torch.bfloat16, "conv_B": torch.bfloat16,
        "conv_C": torch.bfloat16, "state": torch.float32}


def _cache_layers(ref_layers, cfg: ModelConfig, device, layout: str):
    """Unstack the reference's per-pattern-position cache leaves (G, ...)
    into one dict per layer. bf16 attention layers hold ``k``/``v``; int8
    ones int8 ``k``/``v`` and fp32 ``k_scale``/``v_scale``; SSM layers
    bf16 ``conv_x``/``conv_B``/``conv_C`` and an fp32 ``state``."""
    layers = []
    for layer in range(cfg.n_layers):
        ref = ref_layers[layer % cfg.period]
        names = set(ref)
        kinds = [kind for kind in (_KV, _KV_INT8, _SSM) if set(kind) == names]
        if not kinds:
            raise KeyError(f"want cache leaves k and v (bf16), k, v, "
                           f"k_scale and v_scale (int8) or conv_x, conv_B, "
                           f"conv_C and state (SSM), got {sorted(ref)}")
        dtypes = kinds[0]
        if "k" in names:
            kv_dtype = torch.int8 if "k_scale" in names else torch.bfloat16
            want = (cfg.n_groups,) + tuple(np.shape(ref["k"]))[1:]
            for name in names:
                shape = tuple(np.shape(ref[name]))
                expect = want if name in ("k", "v") else want[:-1] + (1,)
                if shape != expect or len(want) != 5:
                    raise ValueError(f"cache leaf {name}: shape {shape}, "
                                     f"want (G={cfg.n_groups}, {layout})")
        else:
            kv_dtype = None
            for name in names:
                if np.shape(ref[name])[:1] != (cfg.n_groups,):
                    raise ValueError(f"cache leaf {name}: shape "
                                     f"{np.shape(ref[name])}, want "
                                     f"(G={cfg.n_groups}, B, ...)")
        group = layer // cfg.period
        layers.append({name: _to_tensor(np.asarray(ref[name])[group],
                                        dtypes[name] or kv_dtype, device)
                       for name in dtypes})
    return tuple(layers)


def _unstack(x, device):
    return tuple(_to_tensor(t, torch.bfloat16, device) for t in np.asarray(x))


def cache_from_reference(cache_np, cfg: ModelConfig, device="cuda",
                         mesh=None):
    """Reference dense decode cache -> the port's ``Cache`` on ``device``.

    ``cache_np`` has the reference ``Cache``'s fields with numpy leaves:
    ``layers`` (one dict per pattern position, ``{"k", "v"}`` leaves
    stacked (G, B, T, KV, hd), plus ``k_scale``/``v_scale``
    (G, B, T, KV, 1) beside int8 k/v, or an SSM layer's leaves stacked
    (G, B, ...)) and ``lengths`` (B,). Layer ``l`` of the port is group
    ``l // period`` of pattern position ``l % period``. An encoder-decoder
    model's ``EncDecCache`` (``self_k``/``self_v``/``cross_k``/``cross_v``
    stacked (L, B, ...)) becomes the port's ``EncDecCache``.

    With a ``mesh`` (``dist.context.Mesh``) it returns this rank's block
    of the sequence as ``dist.sharding.seq_blocks`` cuts it: one of M
    equal blocks over "model" (``Cache.seq_shards`` = M), or the whole
    cache where M does not divide T.
    """
    if cfg.encdec:
        return EncDecCache(*(_unstack(getattr(cache_np, f), device)
                             for f in ("self_k", "self_v", "cross_k",
                                       "cross_v")),
                           _to_tensor(cache_np.lengths, torch.int32, device))
    layers = _cache_layers(cache_np.layers, cfg, device, "B, T, KV, hd")
    t = Cache(layers, None).kv_capacity() or 0
    shards, index = seq_blocks(mesh, t)
    if shards > 1:
        block = t // shards
        lo = index * block
        layers = tuple({n: x[:, lo:lo + block].contiguous()
                        for n, x in layer.items()} if "k" in layer
                       else layer for layer in layers)
    return Cache(layers=layers,
                 lengths=_to_tensor(cache_np.lengths, torch.int32, device),
                 seq_shards=shards)


def paged_cache_from_reference(cache_np, cfg: ModelConfig,
                               device="cuda") -> PagedCache:
    """Reference ``PagedCache`` -> the port's on ``device``: pools stacked
    (G, P, ps, KV, hd) (and (G, P, ps, KV, 1) int8 scale pools) become one
    (P, ps, KV, hd) pool per layer; ``page_table`` (B, Pmax), ``lengths``
    and ``page_size`` carry over."""
    return PagedCache(
        layers=_cache_layers(cache_np.layers, cfg, device,
                             "P, ps, KV, hd"),
        page_table=_to_tensor(cache_np.page_table, torch.int32, device),
        lengths=_to_tensor(cache_np.lengths, torch.int32, device),
        page_size=int(cache_np.page_size))
