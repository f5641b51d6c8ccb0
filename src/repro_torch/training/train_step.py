"""Training step builder: CE loss, grad-accumulation microbatching, remat,
optional pod-level gradient compression.

Counterpart of ``repro.training.train_step``. The returned
``train_step(params, opt_state, batch)`` takes a batch of host arrays
(``tokens``, ``labels``), runs the forward and backward passes with plain
autograd over the parameter leaves on the params' device, and returns
``(new_params, new_opt_state, metrics)`` with the metrics as 0-dim fp32
tensors. Grads come out in the param dtype and are cast to fp32 before
the optimizer, as the reference's.

Attention runs as ``run.attn_impl`` says: training takes the reference's
default, ``"xla"`` (the plain torch attention). The flash kernel has no
backward pass, in the reference as here, so ``attn_impl="pallas"`` raises
under autograd.

Under a ``dist.context.Mesh`` with a "pod" axis and
``run.grad_compression`` other than "none", each rank takes its block of
the batch along dim 0 (its "pod" coordinate), computes its grads, sums
them over "pod" through ``dist.collectives.compress_psum`` and divides by
the pod count, and averages the metrics over "pod": the reference's
``shard_map`` over "pod" with every other axis left to GSPMD.

Under a mesh and a ``strategy`` ("tp", "fsdp", "fsdp_tp") the step runs
the planner's layout with explicit collectives where the reference's
pjit leaves them to GSPMD (:func:`make_train_step`): rows over the batch
axes, ZeRO-3 gathers of the params a layer at a time whose backward is a
reduce-scatter, Megatron's conjugate pairs around the "model" splits,
and the optimizer on each rank's shard.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.dist import collectives
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import compress_psum
from repro_torch.models.common import RunConfig, cross_entropy
from repro_torch.models.model_zoo import Model
from repro_torch.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                              tree_map_multi, tree_map_with_path,
                              tree_unflatten)

AUX_LOSS_WEIGHT = 0.01


def make_loss_fn(model: Model, run: RunConfig, share: float = 1.0
                 ) -> Callable:
    """``loss_fn(params, batch) -> (total, metrics)``: mean CE (and
    accuracy for a classifier head) plus ``AUX_LOSS_WEIGHT`` x aux. With
    ``share`` < 1 the batch is one rank's rows, that share of the whole
    batch: the CE enters the total times ``share`` (the ranks' totals then
    sum to the whole batch's), the aux loss, already the whole batch's
    (``models.moe``), once."""
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.forward(run, params, batch)
        labels = batch["labels"]
        loss = cross_entropy(logits, labels)
        if cfg.num_labels:  # encoder classifier (paper's case study)
            acc = torch.mean((torch.argmax(logits, -1) == labels)
                             .to(torch.float32))
            metrics = {"loss": loss, "accuracy": acc}
        else:
            metrics = {"loss": loss}
        total = (loss if share == 1.0 else share * loss) \
            + AUX_LOSS_WEIGHT * aux
        metrics["aux_loss"] = aux
        return total, metrics

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((total, metrics), grads): grads in each leaf's own dtype, zeros
    for a leaf the loss does not reach (as ``jax.value_and_grad``);
    metrics detached."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, metrics = loss_fn(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), tree_unflatten(params, grads)


def _microbatch_grads(loss_fn, params, batch, n_micro: int):
    """Sequential grad accumulation over ``n_micro`` microbatches.

    Accumulates fp32 grads; returns (grads, metrics) averaged over micros.
    """
    micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
             for k, v in batch.items()}
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    metrics = None
    for i in range(n_micro):
        (_, m), g = value_and_grad(loss_fn, params,
                                   {k: v[i] for k, v in micro.items()})
        grads = tree_map_multi(lambda a, g: a + g.to(torch.float32),
                               grads, g)
        if metrics is None:
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=v.device) for k, v in m.items()}
        metrics = {k: metrics[k] + m[k] / n_micro for k in metrics}
    grads = tree_map(lambda g: g / n_micro, grads)
    return grads, metrics


def _on_device(batch, device) -> dict:
    """Host arrays (or tensors) -> tensors on ``device``: ids and labels
    as long, float inputs (embeddings, an encoder's frames) as they
    are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v if isinstance(v, torch.Tensor)
                            else np.asarray(v))
        out[k] = t.to(device=device, dtype=None if t.is_floating_point()
                      else torch.long)
    return out


def _n_micro(run: RunConfig, batch) -> int:
    if not run.microbatch:
        return 1
    return max(tree_leaves(batch)[0].shape[0] // run.microbatch, 1)


def _rank_rows(batch, n_micro: int, n: int, index: int) -> dict:
    """This rank's rows: block ``index`` of ``n`` of each of the
    ``n_micro`` microbatches, in microbatch order (the reference keeps the
    microbatch dim cut over the data axes, so each rank holds its block of
    every microbatch)."""
    out = {}
    for k, v in batch.items():
        mb = v.shape[0] // n_micro
        if v.shape[0] % n_micro or mb % n:
            raise ValueError(f"a batch of {v.shape[0]} rows in {n_micro} "
                             f"microbatches does not split over {n} ranks")
        b = mb // n
        micro = v.reshape((n_micro, mb) + tuple(v.shape[1:]))
        out[k] = micro[:, index * b:(index + 1) * b].reshape(
            (n_micro * b,) + tuple(v.shape[1:]))
    return out


def make_train_step(model: Model, run: RunConfig, optimizer,
                    mesh=None, strategy: Optional[str] = None) -> Callable:
    """``train_step(params, opt_state, batch)``.

    Without ``strategy`` the step computes the whole batch (under a "pod"
    mesh with compression, the pod path of the module's docstring). With
    ``mesh`` and ``strategy`` ("tp", "fsdp" or "fsdp_tp", the planner's
    layouts) ``params`` and ``opt_state`` are this rank's shards
    (``dist.sharding.param_shardings`` / ``state_shardings``) and:

      * the rows are cut over the batch axes (the data axes; every axis
        under "fsdp", as the reference's pure-FSDP cells set them), each
        rank taking its block, of every microbatch under ``microbatch``;
      * each rank's loss enters its total times its share of the rows, so
        the totals sum to the whole batch's mean (the MoE aux loss is the
        whole batch's on every rank);
      * params cut over the data axes are gathered a layer at a time in
        the forward pass, and the gather's backward sums their grads over
        those ranks and keeps the rank's block; the grads of leaves the
        layout leaves whole over a batch axis
        (``dist.sharding.whole_over_data``) are summed over it here;
      * the optimizer updates the rank's shard with the whole grad's norm;
        the metrics are the whole batch's.
    """
    if mesh is None or strategy is None:
        return _make_step(model, run, optimizer, mesh)
    if strategy not in ("tp", "fsdp", "fsdp_tp"):
        raise ValueError(f"unknown strategy {strategy!r}")
    shd.check_layout(model.cfg, mesh, strategy)
    shardings = shd.param_shardings(model.param_specs, strategy, mesh)
    axes = (dctx.fsdp_batch_axes(mesh) if strategy == "fsdp"
            else tuple(a for a in mesh.axis_names if a != "model"))
    n = int(np.prod([mesh.shape[a] for a in axes] or [1]))
    sums = shd.whole_over_data(shardings, axes, mesh)
    share_loss = make_loss_fn(model, run, share=1.0 / n)
    zero = any(sh.zero for sh in tree_leaves(shardings))

    def train_step(params, opt_state, batch):
        batch = _on_device(batch, tree_leaves(params)[0].device)
        n_micro = _n_micro(run, batch)
        with dctx.mesh_context(mesh), dctx.batch_axes(axes), \
                dctx.param_layout(shardings if zero else None):
            index = dctx.line_index(mesh, axes)
            local = _rank_rows(batch, n_micro, n, index)
            with dctx.row_shard(n, index):
                grads, metrics = _grads(share_loss, params, local, n_micro)
            grads = _sum_whole_leaves(grads, sums)
            names = sorted(metrics)
            totals = collectives.sum_over(
                [metrics[k] / n for k in names], axes)
            metrics = dict(zip(names, totals))
            new_params, new_opt, stats = optimizer.update(
                grads, opt_state, params, shardings=shardings)
        return new_params, new_opt, dict(metrics, **stats)

    return train_step


def _sum_whole_leaves(grads, sums: dict):
    """``grads`` with each leaf of ``sums`` (path -> axes) summed over its
    axes, the leaves of one set of axes in one all_reduce."""
    if not sums:
        return grads
    flat = dict(tree_leaves_with_path(grads))
    by_axes = {}
    for path, axes in sums.items():
        by_axes.setdefault(axes, []).append(path)
    for axes, paths in by_axes.items():
        for path, g in zip(paths, collectives.sum_over(
                [flat[p] for p in paths], axes)):
            flat[path] = g
    return tree_map_with_path(lambda p, _: flat[p], grads)


def _grads(loss_fn, params, batch, n_micro: int):
    """(fp32 grads, metrics) of ``batch``, over ``n_micro``
    microbatches."""
    if n_micro > 1:
        return _microbatch_grads(loss_fn, params, batch, n_micro)
    (_, metrics), grads = value_and_grad(loss_fn, params, batch)
    return tree_map(lambda g: g.to(torch.float32), grads), metrics


def _make_step(model: Model, run: RunConfig, optimizer, mesh) -> Callable:
    """The step without a layout: the whole batch on this rank, or the
    "pod" path."""
    loss_fn = make_loss_fn(model, run)

    def train_step(params, opt_state, batch):
        batch = _on_device(batch, tree_leaves(params)[0].device)
        n_micro = _n_micro(run, batch)
        if (run.grad_compression != "none" and mesh is not None
                and "pod" in mesh.axis_names):
            # per-pod grads + compressed reduction over "pod"
            n_pod = mesh.shape["pod"]
            r = mesh.coord("pod")
            local = {}
            for k, v in batch.items():
                if v.shape[0] % n_pod:
                    raise ValueError(f"batch of {v.shape[0]} does not "
                                     f"split over {n_pod} pods")
                b = v.shape[0] // n_pod
                local[k] = v[r * b:(r + 1) * b]
            grads, metrics = _grads(loss_fn, params, local,
                                    _n_micro(run, local))
            grads = tree_map(
                lambda g: compress_psum(g, "pod", run.grad_compression,
                                        mesh) / n_pod, grads)
            metrics = {k: compress_psum(m, "pod", "none", mesh) / n_pod
                       for k, m in metrics.items()}
        else:
            grads, metrics = _grads(loss_fn, params, batch, n_micro)
        new_params, new_opt, stats = optimizer.update(grads, opt_state,
                                                      params)
        metrics = dict(metrics, **stats)
        return new_params, new_opt, metrics

    return train_step
