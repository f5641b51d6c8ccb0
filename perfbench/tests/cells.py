"""What the benchmark's tests share: each cell cut to a size the CPU runs
in seconds."""
from __future__ import annotations

from perfbench.harness import load_json, ROOT

TINY = {
    "distilbert-imdb": dict(n_layers=2, dim=64, n_heads=4, hidden_dim=96,
                            vocab_size=512, max_position_embeddings=64),
    "qwen2-7b": dict(num_hidden_layers=2, hidden_size=64,
                     num_attention_heads=4, num_key_value_heads=2,
                     intermediate_size=96, vocab_size=512),
}
TINY_TRAFFIC = {
    "offline-512": dict(seq_len=32, items_per_job=64, chunk_items=8,
                        check_items=32),
    "dag-label-4k": dict(prompt_len=24, max_new_tokens=8, items_per_job=8,
                         shard_items=4, slots=4, warmup_items=5,
                         check_requests=6),
}


def tiny(cell: str) -> dict:
    """``run_cell`` keywords that run ``cell`` on the CPU at a tiny size
    (the same code paths; head_dim 16), skipping the look for a chip."""
    spec = load_json(ROOT / "BENCHMARK.json")
    w = {c["name"]: c for c in spec["workloads"]}[cell]
    file = {c["name"]: c for c in spec["configs"]}[w["config"]]["file"]
    port = dict(load_json(ROOT / file)["port"], head_dim=16)
    return dict(device="cpu", require_chip=False,
                config_over=dict(TINY[w["config"]], port=port),
                traffic_over=TINY_TRAFFIC[w["traffic"]])

