"""Decode-time kernels: ragged decode attention and the sampling epilogue
(counterpart of ``repro.kernels.decode_attention``, dense non-quantized
entries)."""
from repro_torch.kernels.decode_attention.fused_sampling import (  # noqa: F401
    apply_filters, fused_sample, fused_sample_kernel, fused_sample_ref,
    nucleus_cutoff)
from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention)
from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    decode_attention_ref)
