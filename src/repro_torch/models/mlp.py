"""Dense MLP sublayer: gated (SwiGLU-family) or classic 2-matrix variants.

Counterpart of ``repro.models.mlp``.
"""
from __future__ import annotations

from typing import Optional

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


def mlp_apply(cfg: ModelConfig, p, x):
    act = act_fn(cfg.act)
    h = x @ p["w1"].to(x.dtype)
    if "b1" in p:
        h = h + p["b1"].to(h.dtype)
    h = act(h)
    if "w3" in p:
        h = h * (x @ p["w3"].to(x.dtype))
    y = h @ p["w2"].to(x.dtype)
    if "b2" in p:
        y = y + p["b2"].to(y.dtype)
    return y
