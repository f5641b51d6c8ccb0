"""DistilBERT-base sentiment classifier — the paper's own case-study model.

66M params, 6L, d_model=768, 12H, d_ff=3072, vocab=30522; encoder-only,
2-way classification head (IMDb positive/negative). Drives the Fig-2
reproduction benchmarks; not one of the 40 assigned dry-run cells.
"""
from repro_torch.models.common import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="distilbert-imdb",
    family="encoder",
    n_layers=6,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30522,
    pattern=(LayerSpec("attn", "dense"),),
    act="gelu",
    gated_mlp=False,
    qkv_bias=True,
    attn_out_bias=True,
    mlp_bias=True,
    norm="layernorm",
    pos="learned",
    max_position=512,
    bidirectional=True,
    num_labels=2,
)
