"""Dense MLP sublayer: gated (SwiGLU-family) or classic 2-matrix variants.

Counterpart of ``repro.models.mlp``. Under a "model" axis the planner cuts
``w1``/``w3`` (and ``b1``) by columns and ``w2`` by rows over d_ff (the
Megatron split): each rank computes its d_ff block, the partial outputs
are summed over "model" (``dist.collectives.model_sum``) and ``b2``,
which the planner leaves whole, is added once after the sum. A rank
holding the whole d_ff computes it whole, with no sum. Under autograd the
input enters the split through ``collectives.model_copy`` (its grad
summed over "model" in the backward) and the sum's backward is the
identity: Megatron's conjugate pair, so a "tp" train step gets whole
grads.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.dist import collectives
from repro_torch.models.common import AxSpec, ModelConfig, act_fn


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None,
              d_in: Optional[int] = None):
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    p = {
        "w1": AxSpec((d, f), ("d_model", "d_ff")),
        "w2": AxSpec((f, d), ("d_ff", "d_model")),
    }
    if cfg.gated_mlp:
        p["w3"] = AxSpec((d, f), ("d_model", "d_ff"))
    if cfg.mlp_bias:
        p["b1"] = AxSpec((f,), ("d_ff",), "zeros")
        p["b2"] = AxSpec((d,), ("d_model",), "zeros")
    return p


def mlp_apply(cfg: ModelConfig, p, x, d_ff: Optional[int] = None,
              reduce: bool = True):
    """The MLP of ``x``. ``d_ff`` is the whole width (default
    ``cfg.d_ff``): a ``w1`` narrower than it is this rank's d_ff block,
    whose output is summed over "model" (``reduce=False`` returns the
    partial sum, ``b2`` not added, for a caller that sums it itself)."""
    split = p["w1"].shape[1] < (d_ff or cfg.d_ff)
    y = _mlp_partial(cfg, p, collectives.model_copy(x) if split else x)
    if split:
        if not reduce:
            return y
        y = collectives.model_sum(y)
    if "b2" in p:
        y = y + p["b2"].to(y.dtype)
    return y


def _mlp_partial(cfg: ModelConfig, p, x):
    act = act_fn(cfg.act)
    h = x @ p["w1"].to(x.dtype)
    if "b1" in p:
        h = h + p["b1"].to(h.dtype)
    h = act(h)
    if "w3" in p:
        h = h * (x @ p["w3"].to(x.dtype))
    return h @ p["w2"].to(x.dtype)
