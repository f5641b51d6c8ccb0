"""Qwen1.5-MoE-A2.7B — fine-grained MoE: 60 routed top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L, d_model=2048, 16H (GQA kv=16),
expert d_ff=1408, vocab=151936. Shared-expert width 4×1408=5632, gated.
"""
from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    pattern=(LayerSpec("attn", "moe"),),
    act="silu",
    gated_mlp=True,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    moe=MoEConfig(num_experts=60, top_k=4, expert_ff=1408, num_shared=4,
                  shared_ff=5632),
)
