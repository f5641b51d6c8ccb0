"""Config -> Model dispatch.

Counterpart of ``repro.models.model_zoo`` for the decoder / encoder
families the port runs so far (``build`` raises ``NotImplementedError``
for the rest).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.common import (ModelConfig, RunConfig, init_params,
                                       param_count)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_specs: Any
    active_param_count: int

    # -- params ---------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda"):
        """Random params on ``device``; ``"meta"`` allocates nothing."""
        return init_params(self.param_specs, generator, device)

    @property
    def n_params(self) -> int:
        return param_count(self.param_specs)

    # -- compute --------------------------------------------------------
    def forward(self, run: RunConfig, params, batch):
        """batch dict -> (logits, aux). Used by serving and eval."""
        return transformer.forward(self.cfg, run, params,
                                   tokens=batch.get("tokens"),
                                   embeddings=batch.get("embeddings"))

    def prefill(self, run: RunConfig, params, batch,
                max_len: Optional[int] = None, seq_shards: int = 1,
                shard: int = 0):
        """batch dict -> (last-token logits (B,V), populated Cache; block
        ``shard`` of ``seq_shards`` along the sequence)."""
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
        return transformer.decode_step(self.cfg, run, params, cache,
                                       token=batch.get("token"),
                                       embedding=batch.get("embedding"))

    # -- cache ----------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int, kv_dtype: str = "bf16",
                    seq_shards: int = 1):
        """The cache on the meta device (shapes and dtypes only)."""
        return transformer.cache_specs(self.cfg, batch, max_len, kv_dtype,
                                       seq_shards=seq_shards)

    def init_cache(self, batch: int, max_len: int, kv_dtype: str = "bf16",
                   device="cuda", seq_shards: int = 1):
        return transformer.init_cache(self.cfg, batch, max_len, kv_dtype,
                                      device=device, seq_shards=seq_shards)

    def paged_cache_specs(self, batch: int, n_pages: int, page_size: int,
                          max_pages: int, kv_dtype: str = "bf16"):
        """Block-paged cache on the meta device (decoder-only,
        attention-only patterns; raises ValueError otherwise: those stay
        on the dense cache)."""
        return transformer.paged_cache_specs(self.cfg, batch, n_pages,
                                             page_size, max_pages, kv_dtype)

    def init_paged_cache(self, batch: int, n_pages: int, page_size: int,
                         max_pages: int, kv_dtype: str = "bf16",
                         device="cuda"):
        return transformer.init_paged_cache(self.cfg, batch, n_pages,
                                            page_size, max_pages, kv_dtype,
                                            device=device)

    def extend_row(self, run: RunConfig, params, cache, row: int, tokens):
        """Chunked prefill-with-history of one paged row (cold admission at
        start 0 or warm continuation past a shared prefix), one call
        either way. Returns (last-token logits (1,V), cache), written in
        place."""
        return transformer.extend_paged(self.cfg, run, params, cache, row,
                                        tokens)


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
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP.md Queue 1 #5, remaining model families)")
    specs = transformer.lm_specs(cfg)
    return Model(cfg=cfg, param_specs=specs,
                 active_param_count=_active_params(cfg, specs))
