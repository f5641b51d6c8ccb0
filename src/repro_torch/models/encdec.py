"""Whisper-style encoder-decoder backbone.

Counterpart of ``repro.models.encdec``. The conv/mel frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings
(B, S_enc, enc_d_model). Encoder: bidirectional self-attention, sinusoidal
positions, pre-LN. Decoder: causal self-attention + cross-attention,
learned positions, LM head tied to the token embedding.

The reference stacks the layers' params along a leading axis and scans;
here ``params["enc_blocks"]`` and ``params["dec_blocks"]`` are tuples of
per-layer trees, and ``EncDecCache`` holds tuples of per-layer tensors
where the reference stacks (L, ...). Under ``RunConfig(attn_impl=
"pallas")`` every attention runs on the hand kernels: the encoder and the
decoder prefill on the flash kernel (cross-attention too, at S = 1 in a
decode step), the decoder's self-attention in a decode step on the
decode kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (AxSpec, ModelConfig, RunConfig,
                                       apply_norm, norm_spec,
                                       sinusoidal_positions)

# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _enc_layer_specs(cfg: ModelConfig):
    return {
        "norm1": norm_spec(cfg),
        "attn": attn_lib.attn_specs(cfg),
        "norm2": norm_spec(cfg),
        "mlp": mlp_lib.mlp_specs(cfg),
    }


def _dec_layer_specs(cfg: ModelConfig):
    return {
        "norm1": norm_spec(cfg),
        "self_attn": attn_lib.attn_specs(cfg),
        "norm_x": norm_spec(cfg),
        "cross_attn": attn_lib.attn_specs(cfg, cross=True),
        "norm2": norm_spec(cfg),
        "mlp": mlp_lib.mlp_specs(cfg),
    }


def encdec_specs(cfg: ModelConfig):
    """Param specs; whisper ties the LM head to the token embedding."""
    return {
        "embed": AxSpec((cfg.vocab_size, cfg.d_model), ("vocab", "d_model"),
                        "embed"),
        "dec_pos": AxSpec((cfg.max_position, cfg.d_model),
                          ("vocab", "d_model"), "embed"),
        "enc_blocks": tuple(_enc_layer_specs(cfg)
                            for _ in range(cfg.n_enc_layers)),
        "dec_blocks": tuple(_dec_layer_specs(cfg)
                            for _ in range(cfg.n_layers)),
        "enc_final_norm": norm_spec(cfg),
        "final_norm": norm_spec(cfg),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, run: RunConfig, params, frame_embeds):
    """frame_embeds: (B, S_enc, D), precomputed by the stubbed frontend."""
    _, s, d = frame_embeds.shape
    x = frame_embeds.to(torch.bfloat16)
    x = x + sinusoidal_positions(s, d, x.device)[None].to(x.dtype)
    positions = torch.arange(s, device=x.device)[None, :]
    for p in params["enc_blocks"]:
        h = apply_norm(cfg, p["norm1"], x)
        x = x + attn_lib.attn_forward(cfg, p["attn"], h, mixer="attn",
                                      positions=positions,
                                      impl=run.attn_impl, mask_kind="bidir")
        h = apply_norm(cfg, p["norm2"], x)
        x = x + mlp_lib.mlp_apply(cfg, p["mlp"], h)
    return apply_norm(cfg, params["enc_final_norm"], x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _dec_embed(params, tokens, positions):
    x = params["embed"].to(torch.bfloat16)[tokens.long()]
    return x + params["dec_pos"][positions].to(x.dtype)


def _dec_head(params, x):
    return (x @ params["embed"].to(x.dtype).T).float()


def _cross_mlp(cfg: ModelConfig, run: RunConfig, p, x, ek, ev):
    """Cross-attention and MLP halves of a decoder layer, with residuals."""
    h = apply_norm(cfg, p["norm_x"], x)
    x = x + attn_lib.cross_attn_forward(cfg, p["cross_attn"], h, ek, ev,
                                        impl=run.attn_impl)
    h = apply_norm(cfg, p["norm2"], x)
    return x + mlp_lib.mlp_apply(cfg, p["mlp"], h)


def dec_forward(cfg: ModelConfig, run: RunConfig, params, tokens, enc_out):
    """Teacher-forced decoder logits over the full sequence."""
    x, _ = _dec_prefill(cfg, run, params, tokens, enc_out)
    return _dec_head(params, apply_norm(cfg, params["final_norm"], x))


def _dec_prefill(cfg: ModelConfig, run: RunConfig, params, tokens, enc_out):
    """The decoder over the full sequence: (hidden state, per layer the
    self-attention's unpadded (k, v) and the cross (k, v))."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _dec_embed(params, tokens, positions)
    kvs = []
    for p in params["dec_blocks"]:
        h = apply_norm(cfg, p["norm1"], x)
        h, (k, v) = attn_lib.attn_forward(
            cfg, p["self_attn"], h, mixer="attn", positions=positions,
            impl=run.attn_impl, return_kv=True)
        x = x + h
        ek, ev = attn_lib.cross_kv(cfg, p["cross_attn"], enc_out)
        x = _cross_mlp(cfg, run, p, x, ek, ev)
        kvs.append((k, v, ek, ev))
    return x, kvs


def forward(cfg: ModelConfig, run: RunConfig, params, *, enc_embeds, tokens):
    """Full encoder-decoder forward. Returns (logits, aux = 0)."""
    enc_out = encode(cfg, run, params, enc_embeds)
    return (dec_forward(cfg, run, params, tokens, enc_out),
            torch.zeros((), dtype=torch.float32, device=enc_out.device))


# ---------------------------------------------------------------------------
# Prefill / decode with self + cross caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EncDecCache:
    """Per decoder layer: self-attention K/V (B, max_len, KV, hd) and the
    encoder's cross K/V (B, S_enc, KV, hd), bf16; ``lengths`` (B,) int32,
    the per-row number of valid decoder tokens."""

    self_k: tuple
    self_v: tuple
    cross_k: tuple
    cross_v: tuple
    lengths: torch.Tensor

    def tensors(self):
        return [*self.self_k, *self.self_v, *self.cross_k, *self.cross_v,
                self.lengths]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               device="cuda") -> EncDecCache:
    """An empty cache (zeros, all lengths 0) on ``device``."""
    def zeros(t):
        return tuple(torch.zeros((batch, t, cfg.n_kv_heads, cfg.head_dim),
                                 dtype=torch.bfloat16, device=device)
                     for _ in range(cfg.n_layers))
    return EncDecCache(zeros(max_len), zeros(max_len), zeros(enc_len),
                       zeros(enc_len),
                       torch.zeros(batch, dtype=torch.int32, device=device))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                enc_len: int) -> EncDecCache:
    """The cache's shapes and dtypes on the meta device."""
    return init_cache(cfg, batch, max_len, enc_len, device="meta")


def prefill(cfg: ModelConfig, run: RunConfig, params, *, enc_embeds, tokens,
            max_len: Optional[int] = None):
    """Encode + teacher-forced decoder prefill. Returns (logits_last,
    cache of capacity ``max_len``, default the prompt + ``run.cache_pad``)."""
    b, s = tokens.shape
    max_len = max_len or (s + run.cache_pad)
    enc_out = encode(cfg, run, params, enc_embeds)
    x, kvs = _dec_prefill(cfg, run, params, tokens, enc_out)
    pad = (0, 0, 0, 0, 0, max_len - s)
    sk, sv, ck, cv = (tuple(t.to(torch.bfloat16) for t in leaves)
                      for leaves in zip(*kvs))
    x = apply_norm(cfg, params["final_norm"], x)
    logits = _dec_head(params, x[:, -1])
    return logits, EncDecCache(
        tuple(F.pad(k, pad) for k in sk), tuple(F.pad(v, pad) for v in sv),
        ck, cv, torch.full((b,), s, dtype=torch.int32, device=tokens.device))


def decode_step(cfg: ModelConfig, run: RunConfig, params, cache: EncDecCache,
                token):
    """One ragged decode step (row b at its own ``lengths[b]``): returns
    (logits (B,V), ``cache``) with the new self-attention k/v written and
    every length advanced by 1, IN PLACE."""
    lengths = cache.lengths
    x = _dec_embed(params, token, lengths[:, None].long())
    for layer, p in enumerate(params["dec_blocks"]):
        h = apply_norm(cfg, p["norm1"], x)
        h = attn_lib.attn_decode_layer(
            cfg, p["self_attn"], h, cache.self_k[layer], cache.self_v[layer],
            lengths, mixer="attn", impl=run.attn_impl)[0]
        x = _cross_mlp(cfg, run, p, x + h, cache.cross_k[layer],
                       cache.cross_v[layer])
    x = apply_norm(cfg, params["final_norm"], x)
    logits = _dec_head(params, x[:, 0])
    cache.lengths.add_(1)
    return logits, cache
