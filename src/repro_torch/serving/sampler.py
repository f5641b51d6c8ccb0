"""Token sampler over (B, V) logits: the HOST sampling path.

Counterpart of ``repro.serving.sampler``: a separate step on the logits a
decode round returned. The filter math is
``kernels.decode_attention.fused_sampling.apply_filters``, shared with the
fused epilogue (``Engine.decode_sample``), so the two paths draw the same
token from the same noise. ``jax.random`` keys become a
``torch.Generator``; ``noise=`` takes the Gumbel noise directly (the seam
the tests use to feed the reference's noise).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.fused_sampling import (
    apply_filters, gumbel_noise)


def sample(logits, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: Optional[int] = None,
           top_p: Optional[float] = None, noise=None):
    """logits: (B, V) fp32 -> (B,) int32.

    ``temperature <= 0`` is greedy argmax (no draw). Otherwise the token
    is ``argmax(apply_filters(logits) + gumbel)``, the Gumbel-max form of
    a categorical draw, with the noise drawn from ``generator`` on the
    logits' device unless ``noise`` is given. Filters compose k then p.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    filtered = apply_filters(logits.float(), temperature=temperature,
                             top_k=top_k, top_p=top_p)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(filtered + noise, dim=-1).to(torch.int32)
