"""Jamba-1.5-Large (398B total / ~94B active) — hybrid Mamba+attention MoE.

[arXiv:2403.19887; hf] 72L, d_model=8192, 64H (GQA kv=8), d_ff=24576,
vocab=65536, MoE 16 experts top-2. Mamba:attention 7:1 interleave (one
attention layer per 8-layer Jamba block), MoE every second layer.
No positional embeddings (the Mamba layers carry position).
"""
from repro_torch.models.common import (LayerSpec, ModelConfig, MoEConfig,
                                       SSMConfig)

# 8-layer Jamba block: attention at position 3, Mamba elsewhere;
# MoE replaces the dense MLP on odd positions.
PATTERN = tuple(
    LayerSpec("attn" if i == 3 else "ssm", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=PATTERN,
    act="silu",
    gated_mlp=True,
    pos="none",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=24576),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=128),
)
