"""Gemma-2 27B — alternating local(4096-window)/global attention, softcaps.

[arXiv:2408.00118; hf] 46L, d_model=4608, 32H (GQA kv=16), d_ff=36864,
vocab=256000. Attention-logit softcap 50, final-logit softcap 30,
sandwich (pre+post) RMSNorms, GeGLU, tied embeddings, sqrt(d) emb scaling.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=(LayerSpec("attn_local", "dense"), LayerSpec("attn", "dense")),
    act="gelu_tanh",
    gated_mlp=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    window=4096,
    sandwich_norms=True,
    norm="rmsnorm",
    tie_embeddings=True,
    emb_scale=True,
)
