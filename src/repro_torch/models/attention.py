"""GQA attention: full-sequence (train / prefill / classification) and
single-token decode paths.

Counterpart of ``repro.models.attention`` for dense caches: grouped-query
attention, causal / bidirectional / sliding-window masks, logit
softcapping, QKV / output biases, RoPE or external positions, and ragged
batched decode over a shared cache.

``impl`` dispatch:
  * "xla"    — plain torch path (``_attend_dense``, the reference's
               einsum path, query-chunked past 2 * Q_CHUNK; for decode
               the decode kernel's plain version, ``decode_attention_ref``)
  * "pallas" — the hand-written CUDA kernels (``kernels/flash_attention``
               for full sequences, ``kernels/decode_attention`` for
               decode), which take the role of the reference's Pallas
               kernels
  * "seq_shard" and int8 KV caches are not ported yet: they raise
    ``NotImplementedError`` (ROADMAP Queue 1 #8 and #5).

The projections are single matmuls over the flattened head dims, so q, k
and v come out contiguous, as the kernels want them. Decode writes the
new token's k/v into the caller's cache IN PLACE (the reference donates
the cache buffer to the same effect).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
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
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,T,KV,hd)."""
    kv_x = x if kv_x is None else kv_x
    q = _project(x, p["wq"])
    k = _project(kv_x, p["wk"])
    v = _project(kv_x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return q, k, v


def out_proj(p, o):
    h, hd, d = p["wo"].shape
    y = o.reshape(*o.shape[:-2], h * hd) @ p["wo"].to(o.dtype).reshape(
        h * hd, d)
    if "bo" in p:
        y = y + p["bo"].to(y.dtype)
    return y


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


def _not_ported(impl: str, quant: bool):
    if impl == "seq_shard":
        raise NotImplementedError(
            "attn_impl='seq_shard' (sequence-sharded decode) is not ported "
            "yet (ROADMAP.md Queue 1 #8)")
    if quant:
        raise NotImplementedError(
            "int8 KV caches are not ported yet (ROADMAP.md Queue 1 #5)")


def attend_decode(q, k_cache, v_cache, lengths, *, k_scale=None,
                  v_scale=None, window: Optional[int] = None,
                  cap: Optional[float] = None, impl: str = "xla"):
    """Single-token decode. q: (B,1,H,hd); caches: (B,Smax,KV,hd).

    ``lengths`` (int32, scalar or (B,)) = per-row index of the current
    token; row b attends kv positions j <= lengths[b] (the new token's
    k/v must already be written). A (B,) vector makes the batch RAGGED:
    one call serves every continuous-batching slot at its own position.
    """
    _not_ported(impl, k_scale is not None or v_scale is not None)
    lengths = row_lengths(lengths, q.shape[0], q.device)
    if impl == "pallas":
        return da_ops.decode_attention(
            q[:, 0], k_cache, v_cache, lengths, window=window,
            softcap=cap)[:, None]
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
    o = attend_full(q, k, v, mask_kind=mask_kind, window=window,
                    cap=cfg.attn_softcap, impl=impl)
    y = out_proj(p, o)
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


def attn_decode_layer(cfg: ModelConfig, p, x, k_cache, v_cache, lengths, *,
                      mixer: str, impl: str = "xla", k_scale=None,
                      v_scale=None):
    """Decode sublayer: project, write the new k/v at each row's
    ``lengths[b]`` (in place), attend.

    Returns (y, k_cache, v_cache), the caches being the ones passed in.
    ``lengths`` is scalar or (B,): per-row positions let one shared
    batched cache serve rows at different decode depths. RoPE rotates
    each row at its own (unclamped) index.
    """
    _not_ported(impl, k_scale is not None or v_scale is not None)
    lengths = row_lengths(lengths, x.shape[0], x.device)
    q, k, v = project_qkv(cfg, p, x)  # q, k, v: (B,1,.,hd)
    if cfg.pos == "rope":
        pos = lengths[:, None]  # (B,1): each row rotates at its own index
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    window = cfg.window if mixer == "attn_local" else None
    write_kv_rows(k_cache, k, lengths)
    write_kv_rows(v_cache, v, lengths)
    o = attend_decode(q, k_cache, v_cache, lengths, window=window,
                      cap=cfg.attn_softcap, impl=impl)
    return out_proj(p, o), k_cache, v_cache
