"""Grok-1 314B — MoE decoder: 8 experts top-2, logit softcaps.

[hf:xai-org/grok-1; unverified] 64L, d_model=6144, 48H (GQA kv=8),
expert d_ff=32768, vocab=131072.
"""
from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=(LayerSpec("attn", "moe"),),
    act="gelu_tanh",
    gated_mlp=True,
    attn_softcap=30.0,
    final_softcap=30.0,
    norm="rmsnorm",
    emb_scale=True,
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=32768),
)
