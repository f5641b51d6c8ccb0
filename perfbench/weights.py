"""Seeded weights made on the device in a few large calls.

The port declares its leaf layout (``Model.param_specs``: shape, dtype and
kind of every leaf); this module fills it from ``--seed`` by the
configuration file's ``init`` rules, with one normal draw per dtype into a
flat buffer whose slices become the leaves, and one scale and shift per
group of leaves that share a distribution. The same tree goes to the port
(``params=``) and to the reference.
"""
from __future__ import annotations

import math
from collections import defaultdict

import torch

ALIGN = 64  # elements: every leaf starts on a 128-byte boundary in bf16


def leaf_law(spec, init: dict):
    """(std, base) of one leaf: a float32 leaf (a norm's scale or offset)
    is ``base + N(0, norm_std)`` around the kind's constant, an
    embedding ``N(0, embed_std)``, a bias (a leaf the port zeroes)
    ``N(0, bias_std)``, and a matrix
    ``N(0, 1 / fan_in)`` where the fan-in is every dim but the last for a
    kernel that writes the residual stream (last axis ``d_model``, such as
    ``wo`` and ``w2``) and the first dim otherwise."""
    if spec.dtype == torch.float32:
        return init["norm_std"], 1.0 if spec.init == "ones" else 0.0
    if spec.init == "embed":
        return init["embed_std"], 0.0
    if spec.init == "zeros":          # the port's biases start at zero
        return init["bias_std"], 0.0
    if spec.axes and spec.axes[-1] == "d_model":
        fan_in = math.prod(spec.shape[:-1])
    else:
        fan_in = spec.shape[0]
    return 1.0 / math.sqrt(fan_in), 0.0


def make_weights(spec_tree, init: dict, seed: int, device) -> object:
    """The tree ``spec_tree`` describes, drawn from ``seed`` on ``device``."""
    from repro_torch.models.common import is_axspec
    from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

    leaves = list(tree_leaves_with_path(spec_tree, is_axspec))
    groups = defaultdict(list)            # (dtype, std, base) -> paths
    for path, spec in leaves:
        groups[(spec.dtype,) + leaf_law(spec, init)].append(path)
    specs = dict(leaves)
    gen = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    out = {}
    for dtype in sorted({k[0] for k in groups}, key=str):
        keys = sorted((k for k in groups if k[0] == dtype), key=str)
        offset, spans, at = 0, [], {}
        for key in keys:
            lo = offset
            for path in groups[key]:
                at[path] = offset
                offset += -(-math.prod(specs[path].shape) // ALIGN) * ALIGN
            spans.append((key, lo, offset))
        buf = torch.randn(offset, dtype=dtype, device=device, generator=gen)
        for (_, std, base), lo, hi in spans:
            buf[lo:hi].mul_(std).add_(base)
        for path, off in at.items():
            shape = specs[path].shape
            out[path] = buf[off:off + math.prod(shape)].view(shape)
    return tree_map_with_path(lambda path, _: out[path], spec_tree,
                              is_axspec)
