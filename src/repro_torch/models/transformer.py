"""Transformer over a block pattern: full-sequence, prefill and decode.

Counterpart of ``repro.models.transformer``. The reference stacks each
pattern position's parameters along a leading "layers" axis and scans
over layer groups; here ``params["blocks"]`` is a tuple of ``n_layers``
per-layer trees (layer ``l`` runs pattern position ``l % period``) and
the layers run in a Python loop. The decode caches follow the params:
``Cache.layers`` is a tuple of per-layer dicts: ``{"k", "v"}`` of
(B, T, KV, hd), plus fp32 ``k_scale``/``v_scale`` (B, T, KV, 1) beside
int8 k/v, for an attention layer, and ``{"conv_x", "conv_B", "conv_C",
"state"}`` (bf16 conv windows, fp32 SSD state: ``models.ssm.ssm_cache``)
for an SSM layer; ``PagedCache.layers`` holds per-layer pools
(P, ps, KV, hd) (and (P, ps, KV, 1) scale pools) where the reference
stacks (G, ...) per pattern position.

Every block pattern of the reference runs: attention ("attn",
"attn_local") or Mamba-2 ("ssm") mixers, dense or MoE (``models.moe``)
MLPs, and gemma2's sandwich norms (a norm after the mixer and after the
MLP). int8 KV touches attention layers only; paged caches take
attention-only patterns, as in the reference.

Entry points:
  * forward      — full-sequence logits (training / eval / classify) and
                   the MoE load-balancing loss averaged over layers
  * prefill      — full-sequence pass that also builds the decode cache
  * decode_step  — one token per row in, logits out, on a dense or paged
                   cache; the cache is updated IN PLACE (the reference
                   donates it)
  * extend_paged — chunked prefill-with-history of one paged row, in place

Under a sequence-sharded mesh (``serving.Engine(mesh=, seq_shard=True)``)
a dense cache holds one rank's block of every attention layer's sequence
dim, (B, max_len / M, KV, hd) for M blocks over "model", with ``lengths``
global (``Cache.seq_shards`` = M); prefill computes the whole prompt on
every rank and keeps the rank's slice of its K/V.

Under a layout that cuts params over the data axes ("fsdp", "fsdp_tp":
``dist.context.param_layout``), each layer's leaves are gathered at the
head of its step of the loop and dropped after it, and the embedding,
final norm and head where they are used (``dist.collectives.gathered``):
at most one gathered layer is alive outside autograd. Under autograd
the gathered leaves a layer saves for its backward live until it runs,
unless ``remat`` recomputes the layer, gather included, in the backward
(FSDP's free-after-forward).

``forward`` honours ``RunConfig.remat`` under autograd, as the
reference's ``_maybe_remat``: "full" recomputes each layer in the backward
pass (``torch.utils.checkpoint``), "dots" keeps only the outputs of the
layer's matmuls without batch dims (the reference's
``dots_with_no_batch_dims_saveable``: ``mm``/``addmm`` kept, attention's
batched ``bmm`` recomputed).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.dist import collectives
from repro_torch.dist import context as dctx
from repro_torch.kernels.decode_attention.quant import (KV_DTYPES,
                                                        quantize_kv)
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (AxSpec, LayerSpec, ModelConfig,
                                       RunConfig, apply_norm, norm_spec,
                                       softcap)

# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _position_specs(cfg: ModelConfig, spec: LayerSpec):
    p: dict = {"norm1": norm_spec(cfg)}
    if spec.mixer.startswith("attn"):
        p["attn"] = attn_lib.attn_specs(cfg)
    elif spec.mixer == "ssm":
        p["ssm"] = ssm_lib.ssm_specs(cfg, cfg.ssm)
    else:
        raise ValueError(spec.mixer)
    if cfg.sandwich_norms:
        p["post_norm1"] = norm_spec(cfg)
    if spec.mlp == "dense":
        p["norm2"] = norm_spec(cfg)
        p["mlp"] = mlp_lib.mlp_specs(cfg)
    elif spec.mlp == "moe":
        p["norm2"] = norm_spec(cfg)
        p["moe"] = moe_lib.moe_specs(cfg, cfg.moe)
    elif spec.mlp != "none":
        raise ValueError(spec.mlp)
    if cfg.sandwich_norms and spec.mlp != "none":
        p["post_norm2"] = norm_spec(cfg)
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


def _post_norm(cfg: ModelConfig, p, name: str, h):
    """gemma2's sandwich norm on a sublayer's output, else ``h``."""
    return apply_norm(cfg, p[name], h) if cfg.sandwich_norms else h


def _mixer_residual(cfg: ModelConfig, p, x, h):
    return x + _post_norm(cfg, p, "post_norm1", h)


def _mlp_residual(cfg: ModelConfig, run: RunConfig, spec: LayerSpec, p, x):
    """The MLP half of a block with its residual. Returns (x, the MoE
    load-balancing loss of this layer, 0 for a dense MLP)."""
    if spec.mlp == "none":
        return x, 0.0
    h = apply_norm(cfg, p["norm2"], x)
    if spec.mlp == "moe":
        h, aux = moe_lib.moe_apply(cfg, cfg.moe, p["moe"], h,
                                   impl=run.moe_impl)
        lb = aux["lb_loss"]
    else:
        h, lb = mlp_lib.mlp_apply(cfg, p["mlp"], h), 0.0
    return x + _post_norm(cfg, p, "post_norm2", h), lb


def _apply_block_position(cfg: ModelConfig, run: RunConfig, spec: LayerSpec,
                          p, x, positions, prefill: bool = False):
    """One pattern position (mixer + mlp with residuals); full-seq path.
    Returns (x, the layer's MoE load-balancing loss, its decode-cache
    leaves or None). ``prefill`` masks causally, as the reference's prefill
    does for every model, and hands back the attention's unpadded (k, v)
    or the SSM's state leaves."""
    h = apply_norm(cfg, p["norm1"], x)
    if spec.mixer.startswith("attn"):
        h = attn_lib.attn_forward(
            cfg, p["attn"], h, mixer=spec.mixer, positions=positions,
            impl=run.attn_impl,
            mask_kind="bidir" if cfg.bidirectional and not prefill
            else "causal",
            return_kv=prefill)
    else:
        h = ssm_lib.ssm_forward(cfg, cfg.ssm, p["ssm"], h,
                                return_state=prefill)
    h, layer_cache = h if prefill else (h, None)
    x, lb = _mlp_residual(cfg, run, spec, p, _mixer_residual(cfg, p, x, h))
    return x, lb, layer_cache


# matmuls without batch dims: what "dots" remat keeps for the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _maybe_remat(fn, run: RunConfig):
    """``fn`` as is ("none"), recomputed whole in the backward ("full"), or
    recomputed but for its matmuls without batch dims ("dots"). The
    recomputation runs under this thread's ``dist.context`` (mesh, rows,
    param layout), restored on the backward's thread."""
    if run.remat == "none" or not torch.is_grad_enabled():
        return fn
    if run.remat not in ("full", "dots"):
        raise ValueError(
            f"remat={run.remat!r} not in ('none', 'dots', 'full')")
    state = dctx.snapshot()

    def contexts():
        fwd, rec = (ckpt.create_selective_checkpoint_contexts(_dots_policy)
                    if run.remat == "dots" else
                    (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _both(rec, dctx.restored(state))
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                      context_fn=contexts)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _use(params, name: str):
    """Top-level leaf ``name`` ready to use (``collectives.gathered``)."""
    return collectives.gathered(params[name], name)


def _use_block(p, layer: int):
    """Layer ``layer``'s leaves ready to use: gathered at the head of the
    layer and dropped after it, the unit of a ZeRO-3 gather."""
    return collectives.gathered(p, "blocks", layer)


def vocab_lookup(table, ids, n_rows: int):
    """``table[ids]`` for a table of ``n_rows`` rows of which this rank may
    hold one block over "model" (the vocab-parallel embedding): ids
    outside the block look up zeros and the blocks' lookups are summed
    over "model", which is exact (one term is non-zero)."""
    ids = ids.long()
    rows = table.shape[0]
    if rows == n_rows:
        return table[ids]
    lo = dctx.get_mesh().coord("model") * rows
    local = ids - lo
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    return collectives.model_sum(x)


def _embed_in(cfg: ModelConfig, params, tokens=None, embeddings=None,
              positions=None):
    if embeddings is not None:
        x = embeddings.to(torch.bfloat16)
    else:
        x = vocab_lookup(_use(params, "embed").to(torch.bfloat16), tokens,
                         cfg.vocab_size)
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(x.dtype)
    if cfg.pos == "learned":
        x = x + vocab_lookup(_use(params, "pos_embed"), positions,
                             cfg.max_position).to(x.dtype)
    return x


def _lm_head(cfg: ModelConfig, params, x):
    """Logits (fp32) of the final-normed ``x``. A vocab-split head's
    blocks (each softcapped: the cap is elementwise) are gathered over
    "model" into the whole vocabulary; ``x`` enters the split through
    ``collectives.model_copy``."""
    x = apply_norm(cfg, _use(params, "final_norm"), x)
    if cfg.num_labels:
        return (x @ _use(params, "cls_head").to(x.dtype)).float()
    w = (_use(params, "embed").T if cfg.tie_embeddings
         else _use(params, "lm_head"))
    if w.shape[-1] < cfg.vocab_size:
        x = collectives.model_copy(x)
    logits = softcap((x @ w.to(x.dtype)).float(), cfg.final_softcap)
    if logits.shape[-1] < cfg.vocab_size:
        logits = collectives.model_gather(logits, dim=-1)
    return logits


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, run: RunConfig, params, *, tokens=None,
            embeddings=None):
    """Full-sequence logits. Returns (logits_fp32, aux_loss): the MoE
    layers' load-balancing losses summed and divided by the layer count,
    as the reference's scan does (0 without MoE layers)."""
    ref = tokens if tokens is not None else embeddings
    if cfg.pos == "learned" and ref.shape[1] > cfg.max_position:
        raise ValueError(f"{cfg.name}: sequence of {ref.shape[1]} exceeds "
                         f"the {cfg.max_position} learned positions")
    positions = torch.arange(ref.shape[1], device=ref.device)[None, :]
    x = _embed_in(cfg, params, tokens, embeddings, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, p in enumerate(params["blocks"]):
        spec = cfg.pattern[layer % cfg.period]
        block = _maybe_remat(
            lambda x, p, spec=spec, layer=layer: _apply_block_position(
                cfg, run, spec, _use_block(p, layer), x, positions)[:2],
            run)
        x, lb = block(x, p)
        aux = aux + lb
    aux = aux / max(cfg.n_layers, 1)
    if cfg.num_labels:  # encoder classifier: pool at [CLS] position 0
        return _lm_head(cfg, params, x[:, 0]), aux
    return _lm_head(cfg, params, x), aux


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cache:
    """Decode cache: per-layer KV or SSM-state tensors + per-row lengths.

    ``lengths`` is (B,) int32: each batch row tracks its own number of
    valid tokens, so one shared batched cache holds requests at different
    decode depths (ragged continuous batching). A free row is a row whose
    length the serving layer reset to 0; the per-row masks make it inert
    until the next admission overwrites the row (an SSM layer's state
    rows are overwritten whole by the admission's prefill).

    ``seq_shards`` is the number of blocks the sequence dim is cut into
    over the mesh's "model" axis: with M > 1 the KV leaves hold this
    rank's positions [r * T / M, (r + 1) * T / M) (T the whole cache's
    capacity) and ``lengths`` stay global. ``row_shards`` is the number
    of blocks the batch's rows are cut into over the data axes: with D >
    1 every leaf, ``lengths`` too, holds this rank's B / D rows.
    """

    layers: tuple  # per layer: {"k", "v"[, scales]} or the SSM leaves
    lengths: torch.Tensor  # (B,) int32
    seq_shards: int = 1
    row_shards: int = 1

    def tensors(self):
        """Every tensor of the cache: each layer's leaves, then lengths."""
        return [t for layer in self.layers for t in layer.values()] + [
            self.lengths]

    def kv_capacity(self) -> Optional[int]:
        """Positions of the whole sequence dim (all ``seq_shards`` blocks)
        of the first attention layer; None for an attention-free model."""
        for layer in self.layers:
            if "k" in layer:
                return layer["k"].shape[1] * self.seq_shards
        return None


def _check_kv_dtype(kv_dtype: str):
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r} not in {KV_DTYPES}")


def _kv_layer(shape, kv_dtype: str, device) -> dict:
    """One attention layer's zeroed KV leaves: bf16 k/v, or int8 k/v with
    fp32 (..., 1) scales beside them."""
    if kv_dtype == "int8":
        scale = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(scale, dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                kv_dtype: str = "bf16", seq_shards: int = 1) -> Cache:
    """The cache's shapes and dtypes, on the meta device (allocates
    nothing): the counterpart of the reference's ShapeDtypeStruct tree.
    ``kv_dtype="int8"`` stores int8 k/v and per-token fp32
    ``k_scale``/``v_scale`` of shape (B, max_len, KV, 1) in attention
    layers; SSM layers are untouched."""
    return init_cache(cfg, batch, max_len, kv_dtype, device="meta",
                      seq_shards=seq_shards)


def _block_len(max_len: int, seq_shards: int) -> int:
    if seq_shards < 1 or max_len % seq_shards:
        raise ValueError(f"a cache of {max_len} positions does not cut "
                         f"into {seq_shards} equal sequence blocks")
    return max_len // seq_shards


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype: str = "bf16", device="cuda",
               seq_shards: int = 1) -> Cache:
    """An empty cache (zeros, all lengths 0) on ``device``; with
    ``seq_shards`` = M > 1, one rank's block of max_len / M positions of
    every attention layer."""
    _check_kv_dtype(kv_dtype)
    shape = (batch, _block_len(max_len, seq_shards), cfg.n_kv_heads,
             cfg.head_dim)
    layers = tuple(
        _kv_layer(shape, kv_dtype, device)
        if cfg.pattern[layer % cfg.period].mixer.startswith("attn")
        else ssm_lib.ssm_cache(cfg, cfg.ssm, batch, device)
        for layer in range(cfg.n_layers))
    return Cache(layers=layers,
                 lengths=torch.zeros(batch, dtype=torch.int32,
                                     device=device),
                 seq_shards=seq_shards)


@dataclasses.dataclass
class PagedCache:
    """Block-paged decode cache: shared physical page pools + per-row page
    tables.

    KV leaves are (n_pages, page_size, KV, hd) per layer: a POOL of
    physical pages with no batch dim. ``page_table`` (B, max_pages) int32
    maps row b's logical page i to a physical page, so rows only hold the
    pages they use and rows sharing a prompt prefix can map their leading
    logical pages to ONE physical copy (``serving.paged.PageAllocator``
    owns the mapping and the refcounts).

    Physical page 0 is the reserved NULL page: it is never allocated, and
    a freed row's table is all zeros, so its inert per-round decode writes
    land in page 0 instead of a page another row now owns.

    ``page_size`` takes part in the engine's shape key, as it rides in the
    reference's treedef.
    """

    layers: tuple            # per layer: {"k", "v"[, "k_scale", "v_scale"]}
    page_table: torch.Tensor  # (B, max_pages) int32
    lengths: torch.Tensor    # (B,) int32
    page_size: int = 16

    def tensors(self):
        """Every tensor of the cache: each layer's pools, then the page
        table and lengths."""
        return [t for layer in self.layers for t in layer.values()] + [
            self.page_table, self.lengths]


def paged_cache_specs(cfg: ModelConfig, batch: int, n_pages: int,
                      page_size: int, max_pages: int,
                      kv_dtype: str = "bf16") -> PagedCache:
    """The PagedCache's shapes and dtypes on the meta device. ``n_pages``
    physical pages per layer pool (page 0 reserved as null); each row
    addresses up to ``max_pages`` logical pages (max_pages * page_size =
    the row's max_len). ``kv_dtype="int8"`` adds fp32 scale pools
    (n_pages, page_size, KV, 1) that page exactly like the data. Only
    attention-only patterns page, as in the reference: SSM state is O(1)
    per row, nothing to page."""
    return init_paged_cache(cfg, batch, n_pages, page_size, max_pages,
                            kv_dtype, device="meta")


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, max_pages: int,
                     kv_dtype: str = "bf16", device="cuda") -> PagedCache:
    """An empty paged cache on ``device``: zeroed pools, all-null page
    tables, all lengths 0."""
    for spec in cfg.pattern:
        if not spec.mixer.startswith("attn"):
            raise ValueError(
                f"paged KV caches require an attention-only pattern; mixer "
                f"{spec.mixer!r} has no paged layout (use the dense cache)")
    _check_kv_dtype(kv_dtype)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return PagedCache(
        layers=tuple(_kv_layer(shape, kv_dtype, device)
                     for _ in range(cfg.n_layers)),
        page_table=torch.zeros((batch, max_pages), dtype=torch.int32,
                               device=device),
        lengths=torch.zeros(batch, dtype=torch.int32, device=device),
        page_size=page_size)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _kv_leaves(run: RunConfig, k, v, max_len: int, lo: int, block: int):
    """An attention layer's cache leaves from its prompt k/v: int8 with
    scales or bf16, zeros past the prompt, positions [lo, lo + block)."""
    if run.kv_dtype == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        leaves = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        leaves = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    pad = (0, 0, 0, 0, 0, max_len - k.shape[1])
    return {n: F.pad(t, pad)[:, lo:lo + block].contiguous()
            for n, t in leaves.items()}


def prefill(cfg: ModelConfig, run: RunConfig, params, *, tokens=None,
            embeddings=None, max_len: Optional[int] = None,
            seq_shards: int = 1, shard: int = 0):
    """Returns (last-token logits (B,V), populated Cache of capacity
    ``max_len``, default the prompt length + ``run.cache_pad``). With
    ``run.kv_dtype="int8"`` the cache holds each attention layer's k/v
    quantized per token (int8 values, fp32 scales). With ``seq_shards`` =
    M > 1 each attention layer keeps block ``shard`` of M along the
    sequence: positions [shard * max_len / M, (shard + 1) * max_len / M).
    A model with SSM layers needs a prompt of at most one SSD chunk or a
    whole number of chunks (``ssm.check_prefill_len``)."""
    _check_kv_dtype(run.kv_dtype)
    ref = tokens if tokens is not None else embeddings
    b, s = ref.shape[0], ref.shape[1]
    if max_len is None:
        max_len = s + run.cache_pad
    if max_len < s:
        raise ValueError(
            f"max_len={max_len} cannot hold the {s}-token prompt")
    block = _block_len(max_len, seq_shards)
    lo = shard * block
    positions = torch.arange(s, device=ref.device)[None, :]
    x = _embed_in(cfg, params, tokens, embeddings, positions)
    layers = []
    for layer, p in enumerate(params["blocks"]):
        spec = cfg.pattern[layer % cfg.period]
        x, _, layer_cache = _apply_block_position(
            cfg, run, spec, _use_block(p, layer), x, positions, prefill=True)
        if spec.mixer.startswith("attn"):
            layer_cache = _kv_leaves(run, *layer_cache, max_len, lo, block)
        layers.append(layer_cache)
    logits = _lm_head(cfg, params, x[:, -1])
    return logits, Cache(layers=tuple(layers),
                         lengths=torch.full((b,), s, dtype=torch.int32,
                                            device=ref.device),
                         seq_shards=seq_shards)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, run: RunConfig, params, cache,
                token=None, embedding=None):
    """One decode step on a ``Cache`` or a ``PagedCache``. token: (B,1)
    int (or embedding (B,1,D)).

    Returns (logits (B,V), ``cache``) with the new k/v (and int8 scales)
    and SSM states written and every row's length advanced by 1, IN
    PLACE. The batch is RAGGED: row b embeds, writes and attends at its
    own position ``cache.lengths[b]``, so one call serves
    continuous-batching slots at different depths. Free rows advance too
    (the reference does the same). On a dense cache, once a row's length
    passes the cache's end its write lands on the last position
    (``attention.write_kv_rows``) and it attends every position; on a
    paged cache a free row's zeroed table routes its write to the null
    page 0. The serving layer discards free rows' tokens. Under
    ``run.attn_impl="seq_shard"`` each attention layer's write and
    attention go through ``dist.collectives`` over the cache's
    ``seq_shards`` blocks, ``lengths`` unchanged (global). MoE layers
    route every row of the call together: under a capacity-bound dispatch
    a row's output depends on the others (``models.moe``).
    """
    _check_kv_dtype(run.kv_dtype)
    paged = isinstance(cache, PagedCache)
    lengths = cache.lengths
    pos = lengths[:, None].long()  # (B,1): per-row positions
    x = _embed_in(cfg, params, token, embedding, pos)
    for layer, p in enumerate(params["blocks"]):
        spec = cfg.pattern[layer % cfg.period]
        c = cache.layers[layer]
        p = _use_block(p, layer)
        h = apply_norm(cfg, p["norm1"], x)
        if spec.mixer == "ssm":
            h, new = ssm_lib.ssm_decode(cfg, cfg.ssm, p["ssm"], h, c)
            for name, t in new.items():
                c[name].copy_(t)
        elif paged:
            h = attn_lib.attn_decode_layer_paged(
                cfg, p["attn"], h, c["k"], c["v"], cache.page_table,
                lengths, mixer=spec.mixer, page_size=cache.page_size,
                impl=run.attn_impl, k_scale=c.get("k_scale"),
                v_scale=c.get("v_scale"))[0]
        else:
            h = attn_lib.attn_decode_layer(
                cfg, p["attn"], h, c["k"], c["v"], lengths,
                mixer=spec.mixer, impl=run.attn_impl,
                seq_shards=cache.seq_shards, k_scale=c.get("k_scale"),
                v_scale=c.get("v_scale"))[0]
        x, _ = _mlp_residual(cfg, run, spec, p,
                             _mixer_residual(cfg, p, x, h))
    logits = _lm_head(cfg, params, x[:, 0])
    cache.lengths.add_(1)
    return logits, cache


def extend_paged(cfg: ModelConfig, run: RunConfig, params, cache: PagedCache,
                 row: int, tokens):
    """Chunked prefill-with-history for ONE row of a PagedCache.

    tokens: (1, L) occupying logical positions ``start .. start+L-1``,
    where ``start = cache.lengths[row]``. The single admission primitive
    of the paged serving path, whether the row is cold (start 0, the full
    prompt) or warm (start = the shared-prefix length, the divergent
    suffix): the chunk's queries attend causally over [history ++ chunk],
    so a warm admission reads the shared prefix pages instead of
    recomputing them. The row's pages must already be installed. Writes
    the pools in place and sets ``lengths[row] = start + L``; returns
    (last-token logits (1, V), ``cache``).
    """
    _check_kv_dtype(run.kv_dtype)
    L = tokens.shape[1]
    start = int(cache.lengths[row])
    table_row = cache.page_table[row]
    positions = start + torch.arange(L, device=tokens.device)[None]
    x = _embed_in(cfg, params, tokens, None, positions)
    for layer, p in enumerate(params["blocks"]):
        spec = cfg.pattern[layer % cfg.period]
        c = cache.layers[layer]
        p = _use_block(p, layer)
        h = apply_norm(cfg, p["norm1"], x)
        h = attn_lib.attn_extend_layer_paged(
            cfg, p["attn"], h, c["k"], c["v"], table_row, start,
            mixer=spec.mixer, page_size=cache.page_size,
            k_scale=c.get("k_scale"), v_scale=c.get("v_scale"))[0]
        x, _ = _mlp_residual(cfg, run, spec, p,
                             _mixer_residual(cfg, p, x, h))
    logits = _lm_head(cfg, params, x[:, -1])
    cache.lengths[row] = start + L
    return logits, cache
