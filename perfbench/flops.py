"""Operations and bytes counted from shapes, and the chip's peaks.

These are the yardstick of the roofline and MFU readers: what the work
needs, counted once (each input byte read once, each output byte written
once, causal attention over the pairs it keeps), never what a kernel
happens to do.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def flash_flops(b, s, t, h, d, causal: bool) -> float:
    """QK^T and PV over the (query, key) pairs the mask keeps; causal
    attention is over its own prompt (s == t)."""
    pairs = s * (s + 1) / 2 if causal else s * t
    return 4.0 * b * h * d * pairs


def flash_bytes(b, s, t, h, kv, d) -> float:
    """q and o of every query head, k and v of every kv head, in bf16."""
    return BF16 * b * d * (2 * s * h + 2 * t * kv)


def least_s(flops: float, nbytes: float) -> float:
    """The least time a call needs on the chip: bound by operations or by
    memory, whichever is larger."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def matmul_params(cfg) -> int:
    """Weights one token multiplies by in the blocks (no embedding, no
    head), from a ``ModelConfig``."""
    d, f = cfg.d_model, cfg.d_ff
    q = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    mlp = (3 if cfg.gated_mlp else 2) * d * f
    return cfg.n_layers * (2 * d * q + 2 * d * kv + mlp)


def attn_flops(cfg, pairs: float) -> float:
    """QK^T and PV of every layer over ``pairs`` (query, key) pairs."""
    return 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * pairs


def classify_flops(cfg, s: int) -> float:
    """One item through the encoder classifier: every token through the
    blocks, bidirectional attention, the head on [CLS]."""
    return (2.0 * matmul_params(cfg) * s + attn_flops(cfg, s * s)
            + 2.0 * cfg.d_model * cfg.num_labels)


def generate_flops(cfg, s: int, n_new: int) -> float:
    """One request: one prefill of ``s`` prompt tokens (causal, the head
    at the last position), then ``n_new - 1`` decode steps, step ``g``
    attending ``s + g`` positions, each with the head."""
    head = 2.0 * cfg.d_model * cfg.vocab_size
    prefill = (2.0 * matmul_params(cfg) * s + attn_flops(cfg, s * (s + 1) / 2)
               + head)
    steps = n_new - 1
    positions = steps * s + steps * (steps + 1) / 2
    decode = (steps * (2.0 * matmul_params(cfg) + head)
              + attn_flops(cfg, positions))
    return prefill + decode


def flash_call(args, kwargs):
    """(b, s, t, h, kv, d, causal) of a ``flash_attention(q, k, v, ...)``
    call: q (B, S, H, D), k and v (B, T, KV, D)."""
    q, k = args[0], args[1]
    b, s, h, d = q.shape
    return (b, s, k.shape[1], h, k.shape[2], d,
            bool(kwargs.get("causal", True)))
