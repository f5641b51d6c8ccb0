"""Command-R 35B — dense GQA decoder, no biases, tied embeddings.

[hf:CohereForAI/c4ai-command-r-v01; unverified] 40L, d_model=8192,
64H (GQA kv=8), d_ff=22528, vocab=256000.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    pattern=(LayerSpec("attn", "dense"),),
    act="silu",
    gated_mlp=True,
    rope_theta=8_000_000.0,
    norm="layernorm",
    tie_embeddings=True,
)
