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
``shard_map`` over "pod" with every other axis left to GSPMD. Other mesh
layouts compute the whole batch on every rank.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.dist.collectives import compress_psum
from repro_torch.models.common import RunConfig, cross_entropy
from repro_torch.models.model_zoo import Model
from repro_torch.tree import (tree_leaves, tree_map, tree_map_multi,
                              tree_unflatten)

AUX_LOSS_WEIGHT = 0.01


def make_loss_fn(model: Model, run: RunConfig) -> Callable:
    """``loss_fn(params, batch) -> (total, metrics)``: mean CE (and
    accuracy for a classifier head) plus ``AUX_LOSS_WEIGHT`` x aux."""
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
        total = loss + AUX_LOSS_WEIGHT * aux
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
    """Host arrays (or tensors) -> long tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device=device, dtype=torch.long)
        for k, v in batch.items()}


def make_train_step(model: Model, run: RunConfig, optimizer,
                    mesh=None) -> Callable:
    loss_fn = make_loss_fn(model, run)

    def compute_grads(params, batch):
        if run.microbatch:
            gb = tree_leaves(batch)[0].shape[0]
            n_micro = max(gb // run.microbatch, 1)
            if n_micro > 1:
                return _microbatch_grads(loss_fn, params, batch, n_micro)
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        return grads, metrics

    def train_step(params, opt_state, batch):
        batch = _on_device(batch, tree_leaves(params)[0].device)
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
            grads, metrics = compute_grads(params, local)
            grads = tree_map(
                lambda g: compress_psum(g, "pod", run.grad_compression,
                                        mesh) / n_pod, grads)
            metrics = {k: compress_psum(m, "pod", "none", mesh) / n_pod
                       for k, m in metrics.items()}
        else:
            grads, metrics = compute_grads(params, batch)
        new_params, new_opt, stats = optimizer.update(grads, opt_state,
                                                      params)
        metrics = dict(metrics, **stats)
        return new_params, new_opt, metrics

    return train_step
