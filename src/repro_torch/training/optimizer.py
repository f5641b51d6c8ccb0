"""Optimizers in plain torch ops: AdamW (fp32 master + moments) and Adafactor.

Counterpart of ``repro.training.optimizer``, written out by hand (no
``torch.optim``) so every update is the reference's arithmetic in the
reference's order. The state is a tree of tensors that mirrors the
parameter tree, with the reference's keys: ``m``, ``v``, ``master`` and
``step`` for AdamW; ``factored`` and ``step`` for Adafactor. Updates are
functional: they return new params and a new state and write nothing in
place.

Under a mesh the state mirrors the params leaf for leaf (ZeRO-3: params,
grads and moments all cut alike; ``state_specs`` is the spec tree,
``dist.sharding.state_shardings`` this rank's cut of it), and ``update``
takes the params' ``shardings``: each rank updates its own shard. What
is not elementwise spans the ranks: AdamW's clip uses the global grad
norm (:func:`global_norm` with ``shardings``: every element counted
once), and Adafactor's row and column statistics and its update RMS are
summed over the ranks that hold a cut of their dims.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.dist import collectives
from repro_torch.dist import context as dctx
from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.tree import (tree_leaves, tree_map, tree_map_multi,
                              tree_unflatten)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable:
    """Linear warmup over ``warmup`` steps, then a cosine decay to
    ``final_frac`` of ``base_lr`` at ``total``. The step and the rate are
    fp32 tensors on the step's device."""
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant(base_lr: float) -> Callable:
    return lambda step: torch.full((), base_lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params):
        return {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                       copy=True), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params)),
        }

    def update(self, grads, state, params, shardings=None):
        """grads fp32; returns (new params in the param dtype, new state,
        stats). ``shardings`` (the params' ``Sharding`` tree, under the
        ambient mesh) makes the clip's norm the whole grad's."""
        step = state["step"] + 1
        gnorm = global_norm(grads, shardings)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)

        new_m = tree_map_multi(lambda m, g: b1 * m + (1 - b1) * g,
                               state["m"], grads)
        new_v = tree_map_multi(lambda v, g: b2 * v + (1 - b2) * g * g,
                               state["v"], grads)

        def upd(master, m, v):
            mh = m / c1
            vh = v / c2
            return master - lr * (mh / (torch.sqrt(vh) + self.eps)
                                  + self.weight_decay * master)

        new_master = tree_map_multi(upd, state["master"], new_m, new_v)
        new_params = tree_map_multi(lambda mp, p: mp.to(p.dtype),
                                    new_master, params)
        new_state = {"m": new_m, "v": new_v, "master": new_master,
                     "step": step}
        return new_params, new_state, {"grad_norm": gnorm, "lr": lr}

    def state_specs(self, param_spec_tree):
        """PartitionSpec tree of the state: the params' for the moments
        and master weights, ``step`` whole (the reference's)."""
        return {"m": param_spec_tree, "v": param_spec_tree,
                "master": param_spec_tree, "step": P()}


# ---------------------------------------------------------------------------
# Adafactor (memory-lean option for the 340B-class train cells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Adafactor:
    schedule: Callable
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params):
        def rowcol(p):
            if p.ndim >= 2:
                return {"row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                           device=p.device),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           dtype=torch.float32,
                                           device=p.device)}
            return {"full": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}
        return {"factored": tree_map(rowcol, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params))}

    def update(self, grads, state, params, shardings=None):
        """As :meth:`AdamW.update`; with ``shardings`` each statistic
        over a cut dim is the whole dim's."""
        step = state["step"] + 1
        beta = 1.0 - step.to(torch.float32) ** (-self.decay)
        lr = self.schedule(step)
        cuts = (tree_leaves(shardings) if shardings is not None
                else [None] * len(tree_leaves(params)))

        def upd(g, f, p, sh):
            def cut(*dims):  # the axes that cut g's ``dims`` (all: none)
                if sh is None:
                    return ()
                return sh.axes([d % g.ndim for d in dims] if dims else None)
            g2 = g * g + self.eps
            if "full" in f:
                nf = {"full": beta * f["full"] + (1 - beta) * g2}
                u = g * torch.rsqrt(nf["full"])
            else:
                nr = beta * f["row"] + (1 - beta) * _mean(g2, -1, cut(-1))
                nc = beta * f["col"] + (1 - beta) * _mean(g2, -2, cut(-2))
                nf = {"row": nr, "col": nc}
                # V ≈ nr ⊗ nc / mean(nr): u = g / sqrt(V)
                r_fac = torch.rsqrt(nr / torch.clamp(
                    _mean(nr, -1, cut(-2), keepdim=True), min=self.eps))
                c_fac = torch.rsqrt(torch.clamp(nc, min=self.eps))
                u = g * r_fac[..., None] * c_fac[..., None, :]
            rms_u = torch.sqrt(_mean(u * u, None, cut()) + 1e-12)
            u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
            newp = p.to(torch.float32) - lr * u \
                - lr * self.weight_decay * p.to(torch.float32)
            return newp.to(p.dtype), nf

        # the per-leaf factored state is a dict, so walk the params' leaves
        # and look the state up by position
        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        flat_f = tree_leaves(state["factored"],
                             is_leaf=lambda x: isinstance(x, dict) and (
                                 "full" in x or "row" in x))
        outs = [upd(g, f, p, sh)
                for g, f, p, sh in zip(flat_g, flat_f, flat_p, cuts)]
        new_params = tree_unflatten(params, [o[0] for o in outs])
        new_f = tree_unflatten(params, [o[1] for o in outs])
        return new_params, {"factored": new_f, "step": step}, \
            {"grad_norm": global_norm(grads, shardings), "lr": lr}

    def state_specs(self, param_spec_tree):
        """PartitionSpec tree of the state: a leaf's row statistic is cut
        as the leaf without its last dim, its column statistic without
        the one before; ``step`` whole."""
        def rowcol(spec):
            if len(spec) >= 2:
                return {"row": P(*spec[:-1]),
                        "col": P(*(spec[:-2] + spec[-1:]))}
            return {"full": spec}
        return {"factored": tree_map(
                    rowcol, param_spec_tree,
                    is_leaf=lambda x: isinstance(x, P)),
                "step": P()}


def _mean(x, dim, axes, keepdim: bool = False):
    """``x``'s mean over ``dim`` (every dim when None), where the mesh
    ``axes`` cut what it averages over (this rank holds one block): the
    local mean is summed over the ranks of their line and divided by
    their count."""
    m = torch.mean(x) if dim is None else torch.mean(x, dim=dim,
                                                     keepdim=keepdim)
    if not axes:
        return m
    count = collectives.line_size(dctx.get_mesh(), axes)
    return collectives.sum_over([m], axes)[0] / count


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (fp32).
    With ``shardings`` (the leaves' ``Sharding`` tree, under the ambient
    mesh) the leaves are this rank's blocks: each rank sums the squares
    of the leaves it counts (``Sharding.counted_here``: a leaf whole over
    an axis counts on that axis's coordinate 0 only) and the sums are
    summed over every rank, so each element counts once."""
    leaves = tree_leaves(tree)
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.to(
            torch.float32))) for leaf in leaves))
    mesh = dctx.get_mesh()
    local = sum(torch.sum(torch.square(leaf.to(torch.float32)))
                for leaf, sh in zip(leaves, tree_leaves(shardings))
                if sh.counted_here(mesh))
    if not torch.is_tensor(local):
        local = torch.zeros((), dtype=torch.float32,
                            device=leaves[0].device)
    return torch.sqrt(collectives.sum_over([local],
                                           tuple(mesh.axis_names))[0])


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device
