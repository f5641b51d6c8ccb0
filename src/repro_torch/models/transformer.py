"""Transformer over a block pattern: full-sequence, prefill and decode.

Counterpart of ``repro.models.transformer`` for dense caches. The
reference stacks each pattern position's parameters along a leading
"layers" axis and scans over layer groups; here ``params["blocks"]`` is a
tuple of ``n_layers`` per-layer trees (layer ``l`` runs pattern position
``l % period``) and the layers run in a Python loop. The decode cache
follows the params: ``Cache.layers`` is a tuple of per-layer
``{"k", "v"}`` dicts of (B, T, KV, hd) where the reference stacks
(G, B, T, KV, hd) per pattern position.

Entry points:
  * forward      — full-sequence logits (training / eval / classify)
  * prefill      — full-sequence pass that also builds the decode cache
  * decode_step  — one token per row in, logits out; the cache is
                   updated IN PLACE (the reference donates it)

Ported so far: attention mixers ("attn", "attn_local") with dense MLPs
and bf16 dense caches. SSM mixers, MoE MLPs and sandwich norms raise
``NotImplementedError`` (Queue 1 #7), as do int8 and paged caches
(Queue 1 #5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (AxSpec, LayerSpec, ModelConfig,
                                       RunConfig, apply_norm, norm_spec,
                                       softcap)

_QUEUE = "ROADMAP.md Queue 1 #7 (remaining model families)"
_KV_QUEUE = "ROADMAP.md Queue 1 #5 (int8 and paged KV caches)"


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


def _mlp_residual(cfg: ModelConfig, spec: LayerSpec, p, x):
    if spec.mlp != "none":
        h = apply_norm(cfg, p["norm2"], x)
        x = x + mlp_lib.mlp_apply(cfg, p["mlp"], h)
    return x


def _apply_block_position(cfg: ModelConfig, run: RunConfig, spec: LayerSpec,
                          p, x, positions, prefill: bool = False):
    """One pattern position (mixer + mlp with residuals); full-seq path.
    ``prefill`` masks causally, as the reference's prefill does for every
    model, and also hands back the attention's (k, v) for a cache."""
    h = apply_norm(cfg, p["norm1"], x)
    h, kv = attn_lib.attn_forward(
        cfg, p["attn"], h, mixer=spec.mixer, positions=positions,
        impl=run.attn_impl,
        mask_kind="bidir" if cfg.bidirectional and not prefill else "causal",
        return_kv=True)
    x = _mlp_residual(cfg, spec, p, x + h)
    return (x, kv) if prefill else x


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


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cache:
    """Decode cache: per-layer KV tensors + per-row lengths.

    ``lengths`` is (B,) int32: each batch row tracks its own number of
    valid tokens, so one shared batched cache holds requests at different
    decode depths (ragged continuous batching). A free row is a row whose
    length the serving layer reset to 0; the per-row masks make it inert
    until the next admission overwrites the row.
    """

    layers: tuple  # per layer: {"k": (B,T,KV,hd), "v": (B,T,KV,hd)}
    lengths: torch.Tensor  # (B,) int32

    def tensors(self):
        """Every tensor of the cache: k and v of each layer, then lengths."""
        return [t for layer in self.layers for t in layer.values()] + [
            self.lengths]


def _check_kv_dtype(kv_dtype: str):
    if kv_dtype == "int8":
        raise NotImplementedError(f"int8 KV caches are not ported yet "
                                  f"({_KV_QUEUE})")
    if kv_dtype != "bf16":
        raise ValueError(f"kv_dtype={kv_dtype!r} not in ('bf16', 'int8')")


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                kv_dtype: str = "bf16") -> Cache:
    """The cache's shapes and dtypes, on the meta device (allocates
    nothing): the counterpart of the reference's ShapeDtypeStruct tree."""
    return init_cache(cfg, batch, max_len, kv_dtype, device="meta")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype: str = "bf16", device="cuda") -> Cache:
    """An empty cache (zeros, all lengths 0) on ``device``."""
    _check_kv_dtype(kv_dtype)
    for spec in cfg.pattern:
        _check_ported(cfg, spec)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)

    def zeros():
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)

    return Cache(layers=tuple({"k": zeros(), "v": zeros()}
                              for _ in range(cfg.n_layers)),
                 lengths=torch.zeros(batch, dtype=torch.int32,
                                     device=device))


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, run: RunConfig, params, *, tokens=None,
            embeddings=None, max_len: Optional[int] = None):
    """Returns (last-token logits (B,V), populated Cache of capacity
    ``max_len``, default the prompt length + ``run.cache_pad``)."""
    _check_kv_dtype(run.kv_dtype)
    ref = tokens if tokens is not None else embeddings
    b, s = ref.shape[0], ref.shape[1]
    if max_len is None:
        max_len = s + run.cache_pad
    if max_len < s:
        raise ValueError(
            f"max_len={max_len} cannot hold the {s}-token prompt")
    positions = torch.arange(s, device=ref.device)[None, :]
    x = _embed_in(cfg, params, tokens, embeddings, positions)
    layers = []
    for layer, p in enumerate(params["blocks"]):
        x, (k, v) = _apply_block_position(
            cfg, run, cfg.pattern[layer % cfg.period], p, x, positions,
            prefill=True)
        pad = (0, 0, 0, 0, 0, max_len - s)  # zeros past the prompt
        layers.append({"k": F.pad(k.to(torch.bfloat16), pad),
                       "v": F.pad(v.to(torch.bfloat16), pad)})
    x_last = apply_norm(cfg, params["final_norm"], x[:, -1])
    logits = _lm_head(cfg, params, x_last)
    return logits, Cache(layers=tuple(layers),
                         lengths=torch.full((b,), s, dtype=torch.int32,
                                            device=ref.device))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, run: RunConfig, params, cache: Cache,
                token=None, embedding=None):
    """One decode step. token: (B,1) int (or embedding (B,1,D)).

    Returns (logits (B,V), ``cache``) with the new k/v written and every
    row's length advanced by 1, IN PLACE. The batch is RAGGED: row b
    embeds, writes and attends at its own position ``cache.lengths[b]``,
    so one call serves continuous-batching slots at different depths.
    Free rows advance too (the reference does the same); once a row's
    length passes the cache's end its write lands on the last position
    (``attention.write_kv_rows``) and it attends every position, as in
    the reference, and the serving layer discards its token.
    """
    _check_kv_dtype(run.kv_dtype)
    lengths = cache.lengths
    pos = lengths[:, None].long()  # (B,1): per-row positions
    x = _embed_in(cfg, params, token, embedding, pos)
    for layer, p in enumerate(params["blocks"]):
        spec = cfg.pattern[layer % cfg.period]
        c = cache.layers[layer]
        h = apply_norm(cfg, p["norm1"], x)
        h, _, _ = attn_lib.attn_decode_layer(
            cfg, p["attn"], h, c["k"], c["v"], lengths, mixer=spec.mixer,
            impl=run.attn_impl)
        x = _mlp_residual(cfg, spec, p, x + h)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = _lm_head(cfg, params, x[:, 0])
    cache.lengths.add_(1)
    return logits, cache
