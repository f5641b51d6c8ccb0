"""Whisper-base — encoder-decoder audio backbone (conv frontend STUBBED).

[arXiv:2212.04356; unverified] 6L enc + 6L dec, d_model=512, 8H, d_ff=2048,
vocab=51865. Per the assignment the mel/conv frontend is a stub:
``input_specs()`` feeds precomputed frame embeddings to the encoder.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,          # decoder layers
    n_enc_layers=6,
    enc_d_model=512,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    pattern=(LayerSpec("attn", "dense"),),
    act="gelu",
    gated_mlp=False,
    qkv_bias=True,
    attn_out_bias=True,
    mlp_bias=True,
    norm="layernorm",
    pos="learned",
    encdec=True,
    input_mode="embeddings",
    tie_embeddings=True,
)
