"""Config -> Model dispatch + per-(arch x shape) input specs.

Counterpart of ``repro.models.model_zoo``: ``build(cfg)`` returns a
``Model`` facade whose methods close over the family's implementation
(decoder LM or encoder classifier in ``transformer``, encoder-decoder in
``encdec``). ``input_specs`` gives meta tensors (shapes and dtypes) for
every model input of a named shape cell of ``SHAPES``, and ``abstract``
this rank's params as empty tensors: the compile-only dry run
(``launch.dryrun``) traces against them under a ``FakeTensorMode``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.common import (ModelConfig, RunConfig,
                                       abstract_params, init_params,
                                       param_count)

# shape-cell registry: name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

I32 = torch.int32
BF16 = torch.bfloat16


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skip) for an (arch x shape) cell."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention at 500k context is "
                       "architecturally infeasible (see DESIGN.md)")
    if cfg.bidirectional and shape in ("decode_32k", "long_500k"):
        return False, "encoder-only model has no decode step"
    return True, ""


class SkipCell(Exception):
    """Raised when an (arch x shape) cell is architecturally inapplicable."""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_specs: Any
    active_param_count: int

    # -- params ---------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda",
             shardings=None):
        """Random params on ``device``; ``"meta"`` allocates nothing.
        ``shardings`` (``Engine.params_sharding``) keeps this rank's
        slice of each leaf as it is drawn."""
        return init_params(self.param_specs, generator, device, shardings)

    def abstract(self, shardings=None):
        """Empty CPU tensors of the params (``shardings``: this rank's
        local leaves), drawing no random numbers; made under the caller's
        ``FakeTensorMode`` they allocate nothing (``launch.dryrun``)."""
        return abstract_params(self.param_specs, shardings)

    @property
    def n_params(self) -> int:
        return param_count(self.param_specs)

    # -- compute --------------------------------------------------------
    def forward(self, run: RunConfig, params, batch):
        """batch dict -> (logits, aux). Used by serving and eval."""
        if self.cfg.encdec:
            return encdec.forward(self.cfg, run, params,
                                  enc_embeds=batch["enc_embeds"],
                                  tokens=batch["tokens"])
        return transformer.forward(self.cfg, run, params,
                                   tokens=batch.get("tokens"),
                                   embeddings=batch.get("embeddings"))

    def prefill(self, run: RunConfig, params, batch,
                max_len: Optional[int] = None, seq_shards: int = 1,
                shard: int = 0):
        """batch dict -> (last-token logits (B,V), populated Cache; block
        ``shard`` of ``seq_shards`` along the sequence). An encoder-decoder
        batch holds ``enc_embeds`` and ``tokens`` and yields an
        ``EncDecCache``."""
        if self.cfg.encdec:
            if seq_shards != 1:
                raise ValueError("encoder-decoder caches are not "
                                 "sequence-sharded")
            return encdec.prefill(self.cfg, run, params,
                                  enc_embeds=batch["enc_embeds"],
                                  tokens=batch["tokens"], max_len=max_len)
        return transformer.prefill(self.cfg, run, params,
                                   tokens=batch.get("tokens"),
                                   embeddings=batch.get("embeddings"),
                                   max_len=max_len, seq_shards=seq_shards,
                                   shard=shard)

    def decode_step(self, run: RunConfig, params, cache, batch):
        """One RAGGED decode step on a dense or paged cache: row b
        embeds/writes/attends at its own ``cache.lengths[b]`` and every
        row's length advances by 1; the cache is updated in place and
        returned."""
        if self.cfg.encdec:
            return encdec.decode_step(self.cfg, run, params, cache,
                                      batch["token"])
        return transformer.decode_step(self.cfg, run, params, cache,
                                       token=batch.get("token"),
                                       embedding=batch.get("embedding"))

    # -- cache ----------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int, kv_dtype: str = "bf16",
                    seq_shards: int = 1, *, enc_len: Optional[int] = None):
        """The cache on the meta device (shapes and dtypes only)."""
        return self.init_cache(batch, max_len, kv_dtype, device="meta",
                               seq_shards=seq_shards, enc_len=enc_len)

    def init_cache(self, batch: int, max_len: int, kv_dtype: str = "bf16",
                   device="cuda", seq_shards: int = 1, *,
                   enc_len: Optional[int] = None):
        """An empty cache on ``device``; an encoder-decoder model's holds
        ``enc_len`` (default ``max_len``) cross-attention positions and
        is bf16 only."""
        if self.cfg.encdec:
            if kv_dtype != "bf16":
                raise ValueError(
                    "encoder-decoder models have no int8 KV layout "
                    "(cross-attn caches stay bf16)")
            return encdec.init_cache(self.cfg, batch, max_len,
                                     enc_len or max_len, device=device)
        return transformer.init_cache(self.cfg, batch, max_len, kv_dtype,
                                      device=device, seq_shards=seq_shards)

    def paged_cache_specs(self, batch: int, n_pages: int, page_size: int,
                          max_pages: int, kv_dtype: str = "bf16"):
        """Block-paged cache on the meta device (decoder-only,
        attention-only patterns; raises ValueError otherwise: those stay
        on the dense cache)."""
        self._check_decoder_only()
        return transformer.paged_cache_specs(self.cfg, batch, n_pages,
                                             page_size, max_pages, kv_dtype)

    def init_paged_cache(self, batch: int, n_pages: int, page_size: int,
                         max_pages: int, kv_dtype: str = "bf16",
                         device="cuda"):
        self._check_decoder_only()
        return transformer.init_paged_cache(self.cfg, batch, n_pages,
                                            page_size, max_pages, kv_dtype,
                                            device=device)

    def extend_row(self, run: RunConfig, params, cache, row: int, tokens):
        """Chunked prefill-with-history of one paged row (cold admission at
        start 0 or warm continuation past a shared prefix), one call
        either way. Returns (last-token logits (1,V), cache), written in
        place."""
        if self.cfg.encdec:
            raise ValueError("extend_row requires a PagedCache "
                             "(decoder-only models)")
        return transformer.extend_paged(self.cfg, run, params, cache, row,
                                        tokens)

    # -- dry-run inputs ---------------------------------------------------
    def input_specs(self, shape: str, run: RunConfig = RunConfig()):
        """(kind, batch inputs, cache or None) for the shape cell, the
        whole batch's, as meta tensors with the reference's names, shapes
        and dtypes; decode's cache holds ``seq + run.cache_pad``
        positions. Raises :class:`SkipCell` for an inapplicable cell."""
        cfg = self.cfg
        seq, gb, kind = SHAPES[shape]
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            raise SkipCell(why)
        frames = {"enc_embeds": _spec((gb, seq, cfg.enc_d_model
                                       or cfg.d_model), BF16)}
        if kind == "train":
            if cfg.encdec:
                inputs = dict(frames, tokens=_spec((gb, seq), I32),
                              labels=_spec((gb, seq), I32))
            elif cfg.input_mode == "embeddings":
                inputs = {"embeddings": _spec((gb, seq, cfg.d_model), BF16),
                          "labels": _spec((gb, seq), I32)}
            elif cfg.bidirectional:
                inputs = {"tokens": _spec((gb, seq), I32),
                          "labels": _spec((gb,), I32)}
            else:
                inputs = {"tokens": _spec((gb, seq), I32),
                          "labels": _spec((gb, seq), I32)}
            return kind, inputs, None
        if kind == "prefill":
            if cfg.encdec:
                inputs = dict(frames, tokens=_spec((gb, seq), I32))
            elif cfg.input_mode == "embeddings":
                inputs = {"embeddings": _spec((gb, seq, cfg.d_model), BF16)}
            else:
                inputs = {"tokens": _spec((gb, seq), I32)}
            return kind, inputs, None
        # decode: one new token against a cache of length `seq`
        cache = self.cache_specs(gb, seq + run.cache_pad, enc_len=seq)
        return kind, {"token": _spec((gb, 1), I32)}, cache

    def _check_decoder_only(self):
        if self.cfg.encdec:
            raise ValueError("encoder-decoder models have no paged cache "
                             "layout (cross-attn KV is per-request dense)")


def _active_params(cfg: ModelConfig, specs) -> int:
    """Parameter count on the active path (MoE: top_k + shared only)."""
    total = param_count(specs)
    if cfg.moe is None:
        return total
    mc = cfg.moe
    n_moe_layers = cfg.n_groups * sum(
        1 for s in cfg.pattern if s.mlp == "moe")
    n_mats = 3 if cfg.gated_mlp else 2
    routed_all = n_moe_layers * mc.num_experts * n_mats * cfg.d_model \
        * mc.expert_ff
    routed_active = n_moe_layers * mc.top_k * n_mats * cfg.d_model \
        * mc.expert_ff
    return total - routed_all + routed_active


def build(cfg: ModelConfig) -> Model:
    specs = (encdec.encdec_specs(cfg) if cfg.encdec
             else transformer.lm_specs(cfg))
    return Model(cfg=cfg, param_specs=specs,
                 active_param_count=_active_params(cfg, specs))
