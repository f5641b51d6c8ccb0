"""Transformer over a block pattern: the full-sequence (``forward``) path.

Counterpart of the ``forward`` half of ``repro.models.transformer``. The
reference stacks each pattern position's parameters along a leading
"layers" axis and scans over layer groups; here ``params["blocks"]`` is a
tuple of ``n_layers`` per-layer trees (layer ``l`` runs pattern position
``l % period``) and the layers run in a Python loop.

Ported so far: attention mixers ("attn", "attn_local") with dense MLPs.
SSM mixers, MoE MLPs and sandwich norms raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (AxSpec, LayerSpec, ModelConfig,
                                       RunConfig, apply_norm, norm_spec,
                                       softcap)

_QUEUE = "ROADMAP.md Queue 1 #7 (remaining model families)"


def _check_ported(cfg: ModelConfig, spec: LayerSpec):
    if not spec.mixer.startswith("attn"):
        raise NotImplementedError(
            f"{cfg.name}: mixer {spec.mixer!r} is not ported yet ({_QUEUE})")
    if spec.mlp not in ("dense", "none"):
        raise NotImplementedError(
            f"{cfg.name}: mlp {spec.mlp!r} is not ported yet ({_QUEUE})")
    if cfg.sandwich_norms:
        raise NotImplementedError(
            f"{cfg.name}: sandwich norms are not ported yet ({_QUEUE})")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _position_specs(cfg: ModelConfig, spec: LayerSpec):
    _check_ported(cfg, spec)
    p: dict = {"norm1": norm_spec(cfg), "attn": attn_lib.attn_specs(cfg)}
    if spec.mlp == "dense":
        p["norm2"] = norm_spec(cfg)
        p["mlp"] = mlp_lib.mlp_specs(cfg)
    return p


def lm_specs(cfg: ModelConfig):
    period = cfg.period
    specs = {
        "embed": AxSpec((cfg.vocab_size, cfg.d_model), ("vocab", "d_model"),
                        "embed"),
        "blocks": tuple(_position_specs(cfg, cfg.pattern[layer % period])
                        for layer in range(cfg.n_groups * period)),
        "final_norm": norm_spec(cfg),
    }
    if cfg.num_labels:
        specs["cls_head"] = AxSpec((cfg.d_model, cfg.num_labels),
                                   ("d_model", None))
    elif not cfg.tie_embeddings:
        specs["lm_head"] = AxSpec((cfg.d_model, cfg.vocab_size),
                                  ("d_model", "vocab"))
    if cfg.pos == "learned":
        specs["pos_embed"] = AxSpec((cfg.max_position, cfg.d_model),
                                    ("vocab", "d_model"), "embed")
    return specs


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_block_position(cfg: ModelConfig, run: RunConfig, spec: LayerSpec,
                          p, x, positions):
    """One pattern position (mixer + mlp with residuals); full-seq path."""
    h = apply_norm(cfg, p["norm1"], x)
    h = attn_lib.attn_forward(
        cfg, p["attn"], h, mixer=spec.mixer, positions=positions,
        impl=run.attn_impl,
        mask_kind="bidir" if cfg.bidirectional else "causal")
    x = x + h
    if spec.mlp != "none":
        h = apply_norm(cfg, p["norm2"], x)
        x = x + mlp_lib.mlp_apply(cfg, p["mlp"], h)
    return x


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed_in(cfg: ModelConfig, params, tokens=None, embeddings=None,
              positions=None):
    if embeddings is not None:
        x = embeddings.to(torch.bfloat16)
    else:
        x = params["embed"].to(torch.bfloat16)[tokens.long()]
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(x.dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][positions].to(x.dtype)
    return x


def _lm_head(cfg: ModelConfig, params, x):
    if cfg.num_labels:
        return (x @ params["cls_head"].to(x.dtype)).float()
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    return softcap(logits.float(), cfg.final_softcap)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, run: RunConfig, params, *, tokens=None,
            embeddings=None):
    """Full-sequence logits. Returns (logits_fp32, aux_loss)."""
    ref = tokens if tokens is not None else embeddings
    if cfg.pos == "learned" and ref.shape[1] > cfg.max_position:
        raise ValueError(f"{cfg.name}: sequence of {ref.shape[1]} exceeds "
                         f"the {cfg.max_position} learned positions")
    positions = torch.arange(ref.shape[1], device=ref.device)[None, :]
    x = _embed_in(cfg, params, tokens, embeddings, positions)
    for layer, p in enumerate(params["blocks"]):
        x = _apply_block_position(cfg, run, cfg.pattern[layer % cfg.period],
                                  p, x, positions)
    # no MoE layers are ported, so the load-balancing aux loss is zero
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.num_labels:  # encoder classifier: pool at [CLS] position 0
        return _lm_head(cfg, params, x[:, 0]), aux
    return _lm_head(cfg, params, x), aux
