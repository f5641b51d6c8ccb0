"""GQA attention: full-sequence (train / prefill / classification),
single-token decode, chunked paged prefill and encoder-decoder
cross-attention paths.

Counterpart of ``repro.models.attention``: grouped-query attention,
causal / bidirectional / sliding-window masks, logit softcapping, QKV /
output biases, RoPE or external positions, ragged batched decode over a
shared cache, dense or block-paged, with bf16 or int8 (per-token-scaled)
KV.

``impl`` dispatch:
  * "xla"    — plain torch path (``_attend_dense``, the reference's
               einsum path, query-chunked past 2 * Q_CHUNK; for decode
               the decode kernels' plain versions, int8 dequantized first)
  * "pallas" — the hand-written CUDA kernels (``kernels/flash_attention``
               for full sequences, ``kernels/decode_attention`` for
               decode, dense, paged and int8), which take the role of the
               reference's Pallas kernels
  * "seq_shard" — decode over a KV cache whose SEQUENCE dim is cut over
               the "model" axis of the ambient mesh
               (``dist.collectives.seq_sharded_*``: each rank's block
               through the partials kernel on CUDA tensors, merged with
               one all_reduce MAX and one SUM); the caller passes how many
               blocks the cache is cut into (``seq_shards``, the
               ``transformer.Cache`` field). Full-sequence attention takes
               the plain path, as the reference's does. An int8 or a
               paged cache raises the reference's ``ValueError``.

Under a "model" axis the planner cuts wq/bq and wo by heads and wk/wv/bk/bv
by kv heads where the axis divides them (the Megatron split): each rank
projects and attends its own heads, and the output projection's partial
sums are summed over "model" (``dist.collectives.model_sum``), ``bo``
added once after. Where the q heads are cut but the kv heads are not (M
does not divide them), every rank computes and caches the whole k/v and
its q heads attend the kv heads they map onto (:func:`kv_slice`); a
layout in which they map onto no uniform group raises.

The projections are single matmuls over the flattened head dims, so q, k
and v come out contiguous, as the kernels want them. Decode and paged
prefill write the new k/v (and scales) into the caller's cache or pools
IN PLACE (the reference donates the cache buffer to the same effect).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dist import collectives
from repro_torch.dist import context as dctx
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.quant import (dequantize_kv,
                                                        quantize_kv)
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      gather_pages,
                                                      row_lengths)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import AxSpec, ModelConfig, apply_rope, softcap

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig, *, cross: bool = False,
               d_in: Optional[int] = None):
    d = d_in or cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": AxSpec((d, h, hd), ("d_model", "heads", "head_dim")),
        "wk": AxSpec((d, kv, hd), ("d_model", "kv_heads", "head_dim")),
        "wv": AxSpec((d, kv, hd), ("d_model", "kv_heads", "head_dim")),
        "wo": AxSpec((h, hd, d), ("heads", "head_dim", "d_model")),
    }
    if cfg.qkv_bias:
        p["bq"] = AxSpec((h, hd), ("heads", "head_dim"), "zeros")
        p["bk"] = AxSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
        p["bv"] = AxSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.attn_out_bias:
        p["bo"] = AxSpec((d,), ("d_model",), "zeros")
    if cross:
        # cross-attention keys/values come from the encoder stream
        p["wk"] = AxSpec((cfg.enc_d_model or d, kv, hd),
                         ("d_model", "kv_heads", "head_dim"))
        p["wv"] = AxSpec((cfg.enc_d_model or d, kv, hd),
                         ("d_model", "kv_heads", "head_dim"))
    return p


def _project(x, w):
    """x (B,S,D) @ w (D,H,hd) -> (B,S,H,hd), one matmul."""
    d, h, hd = w.shape
    y = x @ w.to(x.dtype).reshape(d, h * hd)
    return y.reshape(*x.shape[:-1], h, hd)


def project_qkv(cfg: ModelConfig, p, x, kv_x=None):
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,T,KV,hd). An input entering
    projections split over "model" passes ``collectives.model_copy``,
    whose backward sums its grad over the ranks' heads."""
    q_split = p["wq"].shape[1] < cfg.n_heads
    kv_split = p["wk"].shape[1] < cfg.n_kv_heads
    xq = collectives.model_copy(x) if q_split else x
    if kv_x is None and q_split and kv_split:
        kv_x = xq
    else:
        kv_x = x if kv_x is None else kv_x
        kv_x = collectives.model_copy(kv_x) if kv_split else kv_x
    q = _project(xq, p["wq"])
    k = _project(kv_x, p["wk"])
    v = _project(kv_x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return q, k, v


def out_proj(cfg: ModelConfig, p, o):
    """o (..., H, hd) -> (..., D); a rank holding a block of the heads
    sums its partial output over "model" before ``bo`` is added."""
    h, hd, d = p["wo"].shape
    y = o.reshape(*o.shape[:-2], h * hd) @ p["wo"].to(o.dtype).reshape(
        h * hd, d)
    if h < cfg.n_heads:
        y = collectives.model_sum(y)
    if "bo" in p:
        y = y + p["bo"].to(y.dtype)
    return y


def kv_slice(cfg: ModelConfig, p) -> Optional[Tuple[int, int]]:
    """(first kv head, kv heads) that this rank's q heads attend when the
    planner cut the q heads over "model" but left the kv heads whole;
    None when the rank's k/v heads are exactly the ones its q heads use
    (no cut, or both cut). The rank's q heads must map onto whole kv
    heads with one uniform group; other layouts raise."""
    hl, kvl = p["wq"].shape[1], p["wk"].shape[1]
    if hl == cfg.n_heads or kvl < cfg.n_kv_heads:
        return None
    return kv_group(cfg, hl, dctx.get_mesh().coord("model"))


def kv_group(cfg: ModelConfig, hl: int, index: int) -> Tuple[int, int]:
    """(first kv head, kv heads) of whole kv heads that q-head block
    ``index`` of ``hl`` heads attends; raises where they map onto no
    uniform group."""
    g = cfg.n_heads // cfg.n_kv_heads
    first = index * hl
    if hl % g == 0:
        return first // g, hl // g
    if g % hl == 0:
        return first // g, 1
    raise NotImplementedError(
        f"{cfg.name}: {hl} q heads a rank over {cfg.n_kv_heads} whole kv "
        f"heads (groups of {g}) map onto no uniform group; this GQA layout "
        f"is not served (ROADMAP.md Queue 3, differences by design)")


def _kv_view(t, sel, contiguous: bool):
    """The kv heads ``sel`` of a (..., KV, hd) tensor (all when None);
    copied where a kernel wants it contiguous. The whole k/v every rank
    computes enters the rank's heads here (``collectives.model_copy``:
    its grad is summed over "model" in the backward)."""
    if sel is None:
        return t
    t = collectives.model_copy(t[..., sel[0]:sel[0] + sel[1], :])
    return t.contiguous() if contiguous else t


# ---------------------------------------------------------------------------
# Core attention math (plain torch path)
# ---------------------------------------------------------------------------


def _mask_full(sq: int, st: int, mask_kind: str, window: Optional[int],
               q_offset=0, device=None):
    """(sq, st) boolean mask. q position i attends kv position j."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(st, device=device)[None, :]
    if mask_kind == "bidir":
        m = torch.ones((sq, st), dtype=torch.bool, device=device)
    else:
        m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m


def _attend_dense(q, k, v, *, mask_kind, window, cap, q_offset=0):
    """Unfused reference attention for one q block vs full k/v."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    scale = 1.0 / (hd ** 0.5)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    logits = softcap(logits, cap)
    mask = _mask_full(sq, k.shape[1], mask_kind, window, q_offset, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


Q_CHUNK = 1024  # q-block size for the memory-bounded plain path


def attend_full(q, k, v, *, mask_kind: str = "causal",
                window: Optional[int] = None, cap: Optional[float] = None,
                impl: str = "xla"):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd). GQA-aware; returns (B,S,H,hd).

    The plain path chunks the query dimension (Q_CHUNK blocks) so logits
    never materialize at (S,T) past 2 * Q_CHUNK queries.
    """
    if impl == "pallas":
        return fa_ops.flash_attention(
            q, k, v, causal=(mask_kind == "causal"), window=window,
            softcap=cap)
    s = q.shape[1]
    if s <= 2 * Q_CHUNK or s % Q_CHUNK:
        return _attend_dense(q, k, v, mask_kind=mask_kind, window=window,
                             cap=cap)
    return torch.cat([
        _attend_dense(q[:, off:off + Q_CHUNK], k, v, mask_kind=mask_kind,
                      window=window, cap=cap, q_offset=off)
        for off in range(0, s, Q_CHUNK)], dim=1)


def _check_seq_shard_int8(quant: bool):
    if quant:
        raise ValueError(
            "int8 KV caches do not support attn_impl='seq_shard' — use "
            "kv_dtype='bf16' with sequence sharding (see serving/README.md)")


def attend_decode(q, k_cache, v_cache, lengths, *, k_scale=None,
                  v_scale=None, window: Optional[int] = None,
                  cap: Optional[float] = None, impl: str = "xla",
                  seq_shards: int = 1):
    """Single-token decode. q: (B,1,H,hd); caches: (B,Smax,KV,hd).

    ``lengths`` (int32, scalar or (B,)) = per-row index of the current
    token; row b attends kv positions j <= lengths[b] (the new token's
    k/v must already be written). A (B,) vector makes the batch RAGGED:
    one call serves every continuous-batching slot at its own position.
    ``k_scale``/``v_scale`` ((B,Smax,KV,1) fp32, both or neither) mark the
    caches as int8: the kernel dequantizes in the tile, the plain path
    dequantizes first. Under ``impl="seq_shard"`` the caches are this
    rank's block of a cache cut into ``seq_shards`` blocks over "model"
    (``collectives.seq_sharded_decode``).
    """
    if impl == "seq_shard":
        _check_seq_shard_int8(k_scale is not None)
        return collectives.seq_sharded_decode(
            q, k_cache, v_cache, lengths, window=window, cap=cap,
            seq_shards=seq_shards)
    lengths = row_lengths(lengths, q.shape[0], q.device)
    if impl == "pallas":
        return da_ops.decode_attention(
            q[:, 0], k_cache, v_cache, lengths, k_scale=k_scale,
            v_scale=v_scale, window=window, softcap=cap)[:, None]
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale)
        v_cache = dequantize_kv(v_cache, v_scale)
    return decode_attention_ref(q[:, 0], k_cache, v_cache, lengths,
                                window=window, softcap=cap)[:, None]


# ---------------------------------------------------------------------------
# Layer-level wrappers used by the transformer block
# ---------------------------------------------------------------------------


def attn_forward(cfg: ModelConfig, p, x, *, mixer: str, positions,
                 impl: str = "xla", mask_kind: str = "causal",
                 return_kv: bool = False):
    """Full-sequence attention sublayer (no residual/norm — block handles).
    ``return_kv`` hands back the unpadded (k, v)."""
    q, k, v = project_qkv(cfg, p, x)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if mixer == "attn_local" else None
    sel = kv_slice(cfg, p)
    kernel = impl == "pallas"
    o = attend_full(q, _kv_view(k, sel, kernel), _kv_view(v, sel, kernel),
                    mask_kind=mask_kind, window=window,
                    cap=cfg.attn_softcap, impl=impl)
    y = out_proj(cfg, p, o)
    return (y, (k, v)) if return_kv else y


def write_kv_rows(cache, new, lengths):
    """Write ``new`` (B,1,KV,hd) into ``cache`` (B,Smax,KV,hd) IN PLACE at
    each row's own position ``lengths[b]``; returns ``cache``.

    The position is clamped to [0, Smax - 1], as the reference's
    ``dynamic_update_slice`` clamps its start index: a free row whose
    length has run past the cache's end overwrites its last position
    instead of raising (on CUDA an index past the end would be a
    device-side assert).
    """
    b, smax = cache.shape[0], cache.shape[1]
    pos = row_lengths(lengths, b, cache.device).clamp(0, smax - 1).long()
    cache[torch.arange(b, device=cache.device), pos] = new[:, 0].to(
        cache.dtype)
    return cache


def _project_decode(cfg: ModelConfig, p, x, lengths):
    """q, k, v of one token per row, RoPE'd at each row's own index."""
    q, k, v = project_qkv(cfg, p, x)  # q, k, v: (B,1,.,hd)
    if cfg.pos == "rope":
        pos = lengths[:, None]  # (B,1): each row rotates at its own index
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def attn_decode_layer(cfg: ModelConfig, p, x, k_cache, v_cache, lengths, *,
                      mixer: str, impl: str = "xla", k_scale=None,
                      v_scale=None, seq_shards: int = 1):
    """Decode sublayer: project, write the new k/v at each row's
    ``lengths[b]`` (in place), attend.

    Returns (y, k_cache, v_cache), the caches being the ones passed in.
    ``lengths`` is scalar or (B,): per-row positions let one shared
    batched cache serve rows at different decode depths. RoPE rotates
    each row at its own (unclamped) index. With ``k_scale``/``v_scale``
    ((B,Smax,KV,1) fp32) the caches are int8: the new token's post-RoPE
    k/v are quantized per token, values and scales are written at the
    same clamped position, and the return is the 5-tuple
    (y, k_cache, v_cache, k_scale, v_scale). Under ``impl="seq_shard"``
    the caches are this rank's block of a cache cut into ``seq_shards``
    blocks over "model": the write lands only in the block that owns the
    row's position (``collectives.seq_sharded_write_decode``: a position
    past the cache's end is written nowhere, where the dense path clamps).
    """
    quant = k_scale is not None
    lengths = row_lengths(lengths, x.shape[0], x.device)
    q, k, v = _project_decode(cfg, p, x, lengths)
    window = cfg.window if mixer == "attn_local" else None
    if impl == "seq_shard":
        _check_seq_shard_int8(quant)
        o, k_cache, v_cache = collectives.seq_sharded_write_decode(
            q, k, v, k_cache, v_cache, lengths, window=window,
            cap=cfg.attn_softcap, seq_shards=seq_shards)
        return out_proj(cfg, p, o), k_cache, v_cache
    if quant:
        k, ks_new = quantize_kv(k)  # (B,1,KV,hd) int8, (B,1,KV,1) fp32
        v, vs_new = quantize_kv(v)
        write_kv_rows(k_scale, ks_new, lengths)
        write_kv_rows(v_scale, vs_new, lengths)
    write_kv_rows(k_cache, k, lengths)
    write_kv_rows(v_cache, v, lengths)
    sel = kv_slice(cfg, p)
    kernel = impl == "pallas"
    o = attend_decode(q, _kv_view(k_cache, sel, kernel),
                      _kv_view(v_cache, sel, kernel), lengths,
                      k_scale=k_scale, v_scale=v_scale, window=window,
                      cap=cfg.attn_softcap, impl=impl)
    if quant:
        return out_proj(cfg, p, o), k_cache, v_cache, k_scale, v_scale
    return out_proj(cfg, p, o), k_cache, v_cache


# ---------------------------------------------------------------------------
# Block-paged KV cache layers (page-table indirection; serving/paged.py owns
# the physical pages and their refcounts)
# ---------------------------------------------------------------------------


def write_kv_pages(pool, new, page_table, lengths, page_size: int):
    """Write ``new`` (B,1,KV,hd) into the shared page pool IN PLACE at each
    row's own logical position ``lengths[b]``, resolved through its page
    table; returns ``pool``.

    pool: (P, page_size, KV, hd). The logical page slot is clipped to
    ``Pmax - 1`` and the offset is ``lengths[b] % page_size``, as in the
    reference (not the dense clamp to T - 1). The serving layer's
    copy-on-write barrier keeps two ACTIVE rows from resolving to one
    physical slot; free rows, whose tables are all zeros, all write into
    the reserved null page 0 (several may hit one slot in a round: which
    write lands there is undefined, as in the reference, and no active
    row reads page 0).
    """
    b = new.shape[0]
    lengths = row_lengths(lengths, b, pool.device).long()
    pmax = page_table.shape[1]
    slot = torch.clamp(lengths // page_size, 0, pmax - 1)
    pages = page_table.long().gather(1, slot[:, None])[:, 0]
    pool[pages, lengths % page_size] = new[:, 0].to(pool.dtype)
    return pool


def attend_decode_paged(q, k_pages, v_pages, page_table, lengths, *,
                        k_scale=None, v_scale=None,
                        window: Optional[int] = None,
                        cap: Optional[float] = None, impl: str = "xla"):
    """Single-token decode through a paged KV cache. q: (B,1,H,hd);
    pools: (P, ps, KV, hd); page_table: (B, Pmax) int32.

    ``impl="pallas"`` reads KV through the page table inside the kernel (no
    dense view materializes); the plain path gathers each row's logical
    view first. ``k_scale``/``v_scale`` ((P, ps, KV, 1) fp32 scale pools,
    both or neither) mark the pools as int8; scale pages ride the same
    table. ``seq_shard`` raises, as in the reference.
    """
    if impl == "seq_shard":
        raise ValueError(
            "paged KV caches do not support attn_impl='seq_shard' — the "
            "serving layer uses the dense shared cache under seq-shard "
            "(see serving/README.md)")
    lengths = row_lengths(lengths, q.shape[0], q.device)
    if impl == "pallas":
        return da_ops.paged_decode_attention(
            q[:, 0], k_pages, v_pages, lengths, page_table,
            k_scale=k_scale, v_scale=v_scale, window=window,
            softcap=cap)[:, None]
    if k_scale is not None:
        k_pages = dequantize_kv(k_pages, k_scale)
        v_pages = dequantize_kv(v_pages, v_scale)
    return decode_attention_ref(q[:, 0], gather_pages(k_pages, page_table),
                                gather_pages(v_pages, page_table), lengths,
                                window=window, softcap=cap)[:, None]


def attn_decode_layer_paged(cfg: ModelConfig, p, x, k_pages, v_pages,
                            page_table, lengths, *, mixer: str,
                            page_size: int, impl: str = "xla",
                            k_scale=None, v_scale=None):
    """Paged counterpart of :func:`attn_decode_layer`: project, write the
    new k/v through each row's page table (in place), attend through the
    same table. Returns (y, k_pages, v_pages), or with scale pools (int8)
    the 5-tuple (y, k_pages, v_pages, k_scale, v_scale): the new token's
    post-RoPE k/v are quantized and the scales written through the SAME
    table, so copy-on-write copies and shared prefixes carry them."""
    quant = k_scale is not None
    lengths = row_lengths(lengths, x.shape[0], x.device)
    q, k, v = _project_decode(cfg, p, x, lengths)
    window = cfg.window if mixer == "attn_local" else None
    if quant:
        k, ks_new = quantize_kv(k)
        v, vs_new = quantize_kv(v)
        write_kv_pages(k_scale, ks_new, page_table, lengths, page_size)
        write_kv_pages(v_scale, vs_new, page_table, lengths, page_size)
    write_kv_pages(k_pages, k, page_table, lengths, page_size)
    write_kv_pages(v_pages, v, page_table, lengths, page_size)
    o = attend_decode_paged(q, k_pages, v_pages, page_table, lengths,
                            k_scale=k_scale, v_scale=v_scale, window=window,
                            cap=cfg.attn_softcap, impl=impl)
    if quant:
        return out_proj(cfg, p, o), k_pages, v_pages, k_scale, v_scale
    return out_proj(cfg, p, o), k_pages, v_pages


def attn_extend_layer_paged(cfg: ModelConfig, p, x, k_pages, v_pages,
                            table_row, start: int, *, mixer: str,
                            page_size: int, k_scale=None, v_scale=None):
    """Chunked prefill-with-history for ONE paged row.

    x: (1, L, D), the chunk at logical positions ``start .. start+L-1`` of
    the row whose page table is ``table_row`` (Pmax,); positions < start
    already hold valid KV (possibly SHARED prefix pages written by an
    earlier request: reading them is what lets a warm admission skip the
    prefix). Writes the chunk's KV (int8 pools: quantized per token, with
    its scales) through the table in place, then attends the L queries
    over [history ++ chunk] causally (``q_offset=start``) on the plain
    path: the reference has no kernel here either (a gather plus
    ``_attend_dense``). Returns (y (1,L,D), k_pages, v_pages), or the
    5-tuple with the scale pools appended.
    """
    quant = k_scale is not None
    L = x.shape[1]
    pos = start + torch.arange(L, device=x.device)
    q, k, v = project_qkv(cfg, p, x)
    if cfg.pos == "rope":
        q = apply_rope(q, pos[None], cfg.rope_theta)
        k = apply_rope(k, pos[None], cfg.rope_theta)
    pmax = table_row.shape[0]
    pages = table_row.long()[torch.clamp(pos // page_size, 0, pmax - 1)]
    offs = pos % page_size
    if quant:
        k, ks_new = quantize_kv(k)  # (1,L,KV,hd) int8, (1,L,KV,1) fp32
        v, vs_new = quantize_kv(v)
        k_scale[pages, offs] = ks_new[0]
        v_scale[pages, offs] = vs_new[0]
    k_pages[pages, offs] = k[0].to(k_pages.dtype)
    v_pages[pages, offs] = v[0].to(v_pages.dtype)
    kr = gather_pages(k_pages, table_row[None])  # (1, Pmax*ps, KV, hd)
    vr = gather_pages(v_pages, table_row[None])
    if quant:  # gathered rows dequantized: the same values as the
        # reference's dequantize-then-gather
        kr = dequantize_kv(kr, gather_pages(k_scale, table_row[None]))
        vr = dequantize_kv(vr, gather_pages(v_scale, table_row[None]))
    window = cfg.window if mixer == "attn_local" else None
    o = _attend_dense(q, kr.to(q.dtype), vr.to(q.dtype), mask_kind="causal",
                      window=window, cap=cfg.attn_softcap, q_offset=start)
    if quant:
        return out_proj(cfg, p, o), k_pages, v_pages, k_scale, v_scale
    return out_proj(cfg, p, o), k_pages, v_pages


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attn_forward(cfg: ModelConfig, p, x, enc_k, enc_v, *,
                       impl: str = "xla"):
    """Decoder cross-attention of x (B,S,D) against precomputed encoder
    K/V (B,T,KV,hd), bidirectional. Under "pallas" it runs the flash
    kernel, at S = 1 in a decode step; "seq_shard" takes the plain path,
    as the reference's does. Under "model" the rank's q heads attend its
    kv heads of ``enc_k``/``enc_v`` (:func:`cross_kv` cut them by the
    same plan; :func:`kv_slice` where only the q heads are cut), x enters
    the split through ``collectives.model_copy`` and :func:`out_proj`
    sums the heads' partial outputs over "model" before ``bo``."""
    q_split = p["wq"].shape[1] < cfg.n_heads
    q = _project(collectives.model_copy(x) if q_split else x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    sel = kv_slice(cfg, p)
    kernel = impl == "pallas"
    o = attend_full(q, _kv_view(enc_k, sel, kernel),
                    _kv_view(enc_v, sel, kernel), mask_kind="bidir",
                    cap=cfg.attn_softcap,
                    impl="xla" if impl == "seq_shard" else impl)
    return out_proj(cfg, p, o)


def cross_kv(cfg: ModelConfig, p, enc_out):
    """The encoder output's K/V for one decoder layer's cross-attention:
    the rank's kv heads where the planner cut wk/wv over "model" (the
    encoder output entering the split through ``collectives.model_copy``),
    every kv head otherwise."""
    if p["wk"].shape[1] < cfg.n_kv_heads:
        enc_out = collectives.model_copy(enc_out)
    k = _project(enc_out, p["wk"])
    v = _project(enc_out, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return k, v
