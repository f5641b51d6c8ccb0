"""Pixtral-12B — VLM backbone (Mistral-Nemo-style decoder); ViT STUBBED.

[hf:mistralai/Pixtral-12B-2409; unverified] 40L, d_model=5120, 32H (GQA
kv=8), d_ff=14336, vocab=131072. Per the assignment the Pixtral-ViT
frontend is a stub: ``input_specs()`` feeds precomputed patch embeddings
for prefill/train; decode consumes token ids.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    pattern=(LayerSpec("attn", "dense"),),
    act="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    input_mode="embeddings",
)
