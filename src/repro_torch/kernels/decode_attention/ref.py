"""Plain torch versions of the decode-attention kernels (no custom kernel).

Counterpart of ``repro.kernels.decode_attention.ref``, op for op:
``decode_attention_ref``, ``decode_attention_partials_ref`` (one sequence
shard's unnormalised softmax state), ``gather_pages`` and
``paged_decode_attention_ref``, plus the int8 plain versions, which
dequantize and then call the bf16 ones (what the reference's wrappers and
its "xla" path do, ``ops.py:55-59,104-107``). The CPU tests run them, and
``chip_smoke.py`` holds each CUDA kernel against its plain version on the
card. ``lengths`` may be a scalar or a ``(B,)`` int32 vector: a vector
makes the batch RAGGED, each row attending up to its own current index.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.quant import dequantize_kv

NEG_INF = -1e30


def row_lengths(lengths, b: int, device=None):
    """Normalize a scalar-or-(B,) ``lengths`` to a (B,) int32 tensor."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return torch.broadcast_to(lengths, (b,))


def decode_attention_ref(q, k_cache, v_cache, lengths, *,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None):
    """q: (B,H,D); caches: (B,T,KV,D); lengths: () or (B,) int32.

    Row b attends kv positions j <= lengths[b] (and j > lengths[b] -
    window if windowed). Returns (B,H,D). Computes in fp32, or in float64
    when q is float64.
    """
    b, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    lengths = row_lengths(lengths, b, q.device)
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, kv, g, d).to(ct)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.to(ct)) / (d ** 0.5)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(t, device=q.device)
    mask = pos[None, :] <= lengths[:, None]  # (B, T)
    if window is not None:
        mask &= pos[None, :] > (lengths[:, None] - window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(ct))
    return o.reshape(b, h, d).to(q.dtype)


def decode_attention_partials_ref(q, k_blk, v_blk, lengths, *, offset=0,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None):
    """Flash-decode partials over one KV block (plain torch).

    q: (B,H,D); k_blk/v_blk: (B,Sl,KV,D); the global kv position of local
    row t is ``offset + t`` (one scalar per block: the sequence shard's
    offset). ``lengths`` is () or (B,) int32. Returns fp32 ``(num
    (B,KV,G,D), den (B,KV,G), m (B,KV,G))`` such that softmax attention
    over the union of blocks is ``sum_i(num_i e^{m_i-M}) /
    sum_i(den_i e^{m_i-M})`` with ``M = max_i(m_i)``. Masked
    probabilities are zeroed, so a row with no visible position in the
    block gives ``num = 0``, ``den = 0`` and ``m = -1e30``.
    """
    b, h, d = q.shape
    kv = k_blk.shape[2]
    g = h // kv
    lengths = row_lengths(lengths, b, q.device)
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, kv, g, d).to(ct)
    logits = torch.einsum("bkgh,btkh->bkgt", qg, k_blk.to(ct)) / (d ** 0.5)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = offset + torch.arange(k_blk.shape[1], device=q.device)
    mask = pos[None, :] <= lengths[:, None]  # (B, Sl)
    if window is not None:
        mask = mask & (pos[None, :] > (lengths[:, None] - window))
    mask = mask[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)  # (B,KV,G); NEG_INF on all-masked rows
    p = torch.exp(logits - m[..., None])
    p = torch.where(mask, p, 0.0)  # all-masked row: exp(0) = 1, zero it
    den = p.sum(dim=-1)
    num = torch.einsum("bkgt,btkh->bkgh", p, v_blk.to(ct))
    return num, den, m


def decode_attention_quant_ref(q, k_cache, v_cache, k_scale, v_scale,
                               lengths, *, window: Optional[int] = None,
                               softcap: Optional[float] = None):
    """int8 caches (B,T,KV,D) with fp32 scales (B,T,KV,1): dequantize,
    then :func:`decode_attention_ref`."""
    return decode_attention_ref(q, dequantize_kv(k_cache, k_scale),
                                dequantize_kv(v_cache, v_scale), lengths,
                                window=window, softcap=softcap)


def gather_pages(pages, page_table):
    """Materialize the dense per-row KV view of a paged pool.

    pages: (P, ps, KV, D) physical page pool; page_table: (B, Pmax) int32
    mapping row b's logical page i to physical page ``page_table[b, i]``.
    Returns (B, Pmax*ps, KV, D): row b's KV laid out contiguously, the
    array a dense cache would hold.
    """
    b, pmax = page_table.shape
    ps = pages.shape[1]
    flat = pages[page_table.reshape(-1).long()]
    return flat.reshape(b, pmax * ps, *pages.shape[2:])


def paged_decode_attention_ref(q, k_pages, v_pages, lengths, page_table, *,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None):
    """Gather through the page table, then the dense ragged version.
    q: (B,H,D); pools: (P, ps, KV, D); page_table: (B, Pmax) int32; row b
    attends LOGICAL positions j <= lengths[b]. Returns (B,H,D)."""
    return decode_attention_ref(q, gather_pages(k_pages, page_table),
                                gather_pages(v_pages, page_table), lengths,
                                window=window, softcap=softcap)


def paged_decode_attention_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                                     lengths, page_table, *,
                                     window: Optional[int] = None,
                                     softcap: Optional[float] = None):
    """int8 pools (P, ps, KV, D) with fp32 scale pools (P, ps, KV, 1):
    dequantize, then :func:`paged_decode_attention_ref`."""
    return paged_decode_attention_ref(q, dequantize_kv(k_pages, k_scale),
                                      dequantize_kv(v_pages, v_scale),
                                      lengths, page_table, window=window,
                                      softcap=softcap)
