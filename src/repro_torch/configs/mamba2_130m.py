"""Mamba-2 130M — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified] 24L, d_model=768, vocab=50280, ssm_state=128.
"""
from repro_torch.models.common import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,        # unused (attention-free); kept for API uniformity
    n_kv_heads=24,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec("ssm", "none"),),
    pos="none",
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=128),
)
