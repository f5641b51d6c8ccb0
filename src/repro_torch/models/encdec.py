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

Under a mesh the layers split as the decoder-only ones do
(``models.attention``, ``models.mlp``): under "model" each rank computes
its heads of the encoder's self-attention and the decoder's self- and
cross-attention and its d_ff block of the GELU MLP, the partial outputs
summed over "model" before ``bo`` and ``b2``; the tied token embedding,
its LM head and the learned decoder positions are vocab-parallel
(``transformer.vocab_lookup``, the logits gathered whole). Under "fsdp"
and "fsdp_tp" every encoder layer, decoder layer, the embedding, the
positions and each final norm is a unit gathered at its use
(``dist.collectives.gathered``). The batch's rows, frame embeddings
included, are cut over the data axes by the engine
(``EncDecCache.row_shards``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import transformer
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
    for layer, p in enumerate(params["enc_blocks"]):
        p = collectives.gathered(p, "enc_blocks", layer)
        h = apply_norm(cfg, p["norm1"], x)
        x = x + attn_lib.attn_forward(cfg, p["attn"], h, mixer="attn",
                                      positions=positions,
                                      impl=run.attn_impl, mask_kind="bidir")
        h = apply_norm(cfg, p["norm2"], x)
        x = x + mlp_lib.mlp_apply(cfg, p["mlp"], h)
    return apply_norm(cfg, _use(params, "enc_final_norm"), x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _use(params, name: str):
    """Top-level leaf ``name`` ready to use (``collectives.gathered``)."""
    return collectives.gathered(params[name], name)


def _dec_embed(cfg: ModelConfig, params, tokens, positions):
    x = transformer.vocab_lookup(_use(params, "embed").to(torch.bfloat16),
                                 tokens, cfg.vocab_size)
    return x + transformer.vocab_lookup(_use(params, "dec_pos"), positions,
                                        cfg.max_position).to(x.dtype)


def _dec_head(cfg: ModelConfig, params, x):
    """Logits (fp32) of the decoder's final-normed ``x`` through the tied
    embedding; a vocab-split table's blocks are gathered whole over
    "model" (``x`` entering the split through ``model_copy``)."""
    x = apply_norm(cfg, _use(params, "final_norm"), x)
    w = _use(params, "embed")
    if w.shape[0] < cfg.vocab_size:
        x = collectives.model_copy(x)
    logits = (x @ w.to(x.dtype).T).float()
    if logits.shape[-1] < cfg.vocab_size:
        logits = collectives.model_gather(logits, dim=-1)
    return logits


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
    return _dec_head(cfg, params, x)


def _dec_prefill(cfg: ModelConfig, run: RunConfig, params, tokens, enc_out):
    """The decoder over the full sequence: (hidden state, per layer the
    self-attention's unpadded (k, v) and the cross (k, v))."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _dec_embed(cfg, params, tokens, positions)
    kvs = []
    for layer, p in enumerate(params["dec_blocks"]):
        p = collectives.gathered(p, "dec_blocks", layer)
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
    the per-row number of valid decoder tokens. Under a mesh each leaf
    holds this rank's kv heads where "model" cuts them and, with
    ``row_shards`` = D > 1, its B / D rows over the data axes."""

    self_k: tuple
    self_v: tuple
    cross_k: tuple
    cross_v: tuple
    lengths: torch.Tensor
    row_shards: int = 1

    def tensors(self):
        return [*self.self_k, *self.self_v, *self.cross_k, *self.cross_v,
                self.lengths]

    def kv_capacity(self) -> int:
        """Positions of the decoder's self-attention cache."""
        return self.self_k[0].shape[1]


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
    logits = _dec_head(cfg, params, x[:, -1])
    return logits, EncDecCache(
        tuple(F.pad(k, pad) for k in sk), tuple(F.pad(v, pad) for v in sv),
        ck, cv, torch.full((b,), s, dtype=torch.int32, device=tokens.device))


def decode_step(cfg: ModelConfig, run: RunConfig, params, cache: EncDecCache,
                token):
    """One ragged decode step (row b at its own ``lengths[b]``): returns
    (logits (B,V), ``cache``) with the new self-attention k/v written and
    every length advanced by 1, IN PLACE."""
    lengths = cache.lengths
    x = _dec_embed(cfg, params, token, lengths[:, None].long())
    for layer, p in enumerate(params["dec_blocks"]):
        p = collectives.gathered(p, "dec_blocks", layer)
        h = apply_norm(cfg, p["norm1"], x)
        h = attn_lib.attn_decode_layer(
            cfg, p["self_attn"], h, cache.self_k[layer], cache.self_v[layer],
            lengths, mixer="attn", impl=run.attn_impl)[0]
        x = _cross_mlp(cfg, run, p, x + h, cache.cross_k[layer],
                       cache.cross_v[layer])
    logits = _dec_head(cfg, params, x[:, 0])
    cache.lengths.add_(1)
    return logits, cache
