"""Plain torch version of the flash-attention kernel (no custom kernel).

Counterpart of ``repro.kernels.flash_attention.ref.flash_attention_ref``,
op for op. The CPU tests run it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """q: (B,S,H,D); k,v: (B,T,KV,D) with H % KV == 0. Returns (B,S,H,D)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / (d ** 0.5)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(b, s, h, d).to(q.dtype)
