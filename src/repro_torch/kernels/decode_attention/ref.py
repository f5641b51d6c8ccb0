"""Plain torch version of the decode-attention kernel (no custom kernel).

Counterpart of ``repro.kernels.decode_attention.ref.decode_attention_ref``,
op for op. The CPU tests run it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card. ``lengths`` may be a scalar or a ``(B,)``
int32 vector: a vector makes the batch RAGGED, each row attending up to
its own current index.
"""
from __future__ import annotations

from typing import Optional

import torch

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
