"""int8 KV-cache quantization: symmetric per-token-per-kv-head scales.

Counterpart of ``repro.kernels.decode_attention.quant``, with the same
math. K/V are stored as int8 with one fp32 scale per cached token per kv
head, in the same layout family as the data:

  * dense ``Cache``  - kv (B, T, KV, hd) int8, scales (B, T, KV, 1) fp32
  * ``PagedCache``   - kv pools (P, ps, KV, hd) int8, scale pools
                       (P, ps, KV, 1) fp32 (each physical page carries its
                       own scale rows, so copy-on-write page copies and
                       shared prefix pages move scales with their data)

The decode kernels dequantize in the tile (``float(int8) * scale``), so
the bytes read from device memory are the int8 values plus the scales:
``(hd + 4) / (2 * hd)`` of bf16, 0.516x at head_dim 128.
"""
from __future__ import annotations

import torch

KV_DTYPES = ("bf16", "int8")

SCALE_EPS = 1e-8  # all-zero tokens quantize to scale eps, not a NaN


def quantize_kv(x):
    """x (..., hd) -> (int8 values (..., hd), fp32 scales (..., 1)).

    Symmetric round-to-nearest over the trailing head_dim axis:
    ``scale = max|x| / 127`` (clamped at ``SCALE_EPS``),
    ``q = clip(round(x / scale), -127, 127)``; ``torch.round`` rounds half
    to even, as ``jnp.round`` does.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=SCALE_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale):
    """(int8 (..., hd), fp32 (..., 1)) -> fp32 (..., hd)."""
    return q.float() * scale


def kv_dtype_of(cache_layer) -> str:
    """"int8" iff a cache layer dict carries quantization scales."""
    return "int8" if (isinstance(cache_layer, dict)
                      and "k_scale" in cache_layer) else "bf16"
