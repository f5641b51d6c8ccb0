"""Qwen2-7B — dense GQA decoder with QKV biases.

[arXiv:2407.10671; hf] 28L, d_model=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    pattern=(LayerSpec("attn", "dense"),),
    act="silu",
    gated_mlp=True,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
)
