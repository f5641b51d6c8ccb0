"""Paper Fig. 2 reproduction: monolithic (a) vs parallel (b) batch sweep.

Counterpart of the repository's ``benchmarks/fig2.py``. Two layers of
evidence:
  1. REAL measurement: the full-width DistilBERT-IMDb engine classifies
     synthetic IMDb batches on the engine's device (the hand-written
     flash-attention kernel on a GPU); the measured per-item time is a
     candidate for the simulator's compute term.
  2. CALIBRATED sweep at paper scale (25k items, batch sizes 50..1000)
     through the port's Orchestrator / MonolithicRunner, with the paper's
     platform constants (``core/simulator.py``).

Validated claims (``validate``):
  C1  mono cost & time ~flat, slightly decreasing with batch size
  C2  parallel @ bs=50 ~1 min via ~500 concurrent functions, peak cost
  C3  parallel cost stabilizes at mid batch sizes, time < ~13 min
  C4  >95 % execution-time reduction at comparable cost
  C5  RAM ~constant across modes (no backprop state)

``bench`` also runs the sweep with the measured per-item time in place of
the paper's 0.801 s and reports which claims hold there, without gating.

    python -m repro_torch.benchmarks.fig2              # on the GPU
    python -m repro_torch.benchmarks.fig2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.core.simulator import (PAPER_BATCH_SIZES, CaseStudyConfig,
                                        run_monolithic, run_parallel)
from repro_torch.data import imdb_reviews
from repro_torch.models import RunConfig, build
from repro_torch.models.common import ModelConfig
from repro_torch.serving import Engine

# the paper's own Lambda figures (Fig. 2), not measurements of this port
PAPER = {
    "mono_time_min_bs50": 363.5, "mono_cost_bs50": 0.2408,
    "mono_time_min_bs1000": 336.5, "mono_cost_bs1000": 0.2229,
    "par_time_min_bs50": 1.01, "par_cost_bs50": 0.3454,
    "par_cost_mid": 0.1838, "par_time_max_min": 12.79,
}


def measure_real_per_item(n_items: int = 64, batch: int = 32,
                          seq_len: int = 128, device="cuda",
                          cfg: Optional[ModelConfig] = None) -> float:
    """Measured DistilBERT-IMDb classification seconds per item.

    ``cfg`` defaults to the full-width ``distilbert-imdb``; the engine runs
    the hand-written attention kernel (``attn_impl="pallas"``, as
    ``launch.serve.run_offline`` does) on random weights from seed 0. One
    warm call, then ``n_items`` items in batches of ``batch``, timed on the
    host clock between two device synchronisations.
    """
    cfg = cfg or configs.get("distilbert-imdb")
    device = torch.device(device)
    model = build(cfg)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device=device)
    params = engine.place_params(
        model.init(torch.Generator().manual_seed(0), device))
    tokens, _ = imdb_reviews(n=n_items, seq_len=seq_len,
                             vocab=cfg.vocab_size)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    engine.classify(params, tokens[:batch])  # first call: kernel build
    sync()
    t0 = time.perf_counter()
    for i in range(0, n_items, batch):
        engine.classify(params, tokens[i:i + batch])
    sync()
    return (time.perf_counter() - t0) / n_items


def rows(cs: CaseStudyConfig, batch_sizes=PAPER_BATCH_SIZES):
    out = []
    for bs in batch_sizes:
        mono = run_monolithic(cs, bs)
        par = run_parallel(cs, bs)
        out.append({
            "batch_size": bs,
            "mono_time_min": mono.wall_time_s / 60,
            "mono_cost_usd": mono.cost_usd,
            "mono_chains": mono.n_invocations,
            "par_time_min": par.wall_time_s / 60,
            "par_cost_usd": par.cost_usd,
            "par_functions": par.n_invocations,
            "reduction_pct": 100 * (1 - par.wall_time_s / mono.wall_time_s),
            "ram_mb": cs.ram_mb,
        })
    return out


def validate(rs) -> dict:
    by_bs = {r["batch_size"]: r for r in rs}
    mid = [r for r in rs if r["batch_size"] in (500, 625)]
    checks = {
        "C1_mono_flat_decreasing":
            by_bs[1000]["mono_time_min"] < by_bs[50]["mono_time_min"]
            and by_bs[1000]["mono_cost_usd"] < by_bs[50]["mono_cost_usd"]
            and by_bs[1000]["mono_time_min"]
            > 0.8 * by_bs[50]["mono_time_min"],
        "C2_par_bs50_about_1min":
            0.5 <= by_bs[50]["par_time_min"] <= 1.6
            and by_bs[50]["par_cost_usd"] == max(r["par_cost_usd"]
                                                 for r in rs),
        "C3_par_time_under_14min":
            all(r["par_time_min"] < 14.0 for r in rs),
        "C4_over_95pct_reduction":
            all(r["reduction_pct"] > 95.0 for r in rs),
        "C4_cost_comparable_at_mid":
            all(0.5 <= r["par_cost_usd"] / r["mono_cost_usd"] <= 1.5
                for r in mid),
        "C5_ram_constant": len({r["ram_mb"] for r in rs}) == 1,
    }
    return checks


def _sweep_rows(tag: str, rs) -> list:
    out = []
    for r in rs:
        out.append((f"{tag}a/mono_bs{r['batch_size']}",
                    r["mono_time_min"] * 60e6 / 25_000,
                    f"time={r['mono_time_min']:.1f}min "
                    f"cost=${r['mono_cost_usd']:.4f}"))
    for r in rs:
        out.append((f"{tag}b/par_bs{r['batch_size']}",
                    r["par_time_min"] * 60e6 / 25_000,
                    f"time={r['par_time_min']:.2f}min "
                    f"cost=${r['par_cost_usd']:.4f} "
                    f"fns={r['par_functions']} "
                    f"reduction={r['reduction_pct']:.1f}%"))
    for name, ok in validate(rs).items():
        out.append((f"{tag}/check_{name}", 0.0, "PASS" if ok else "FAIL"))
    return out


def bench(device="cuda") -> list:
    """Returns CSV rows (name, us_per_call, derived): the measured per-item
    time, the paper-constant sweep and its claims, then the same sweep at
    the measured per-item time (labelled ``fig2_measured``)."""
    per_item = measure_real_per_item(device=device)
    out = [("fig2/real_distilbert_per_item", per_item * 1e6,
            f"measured={per_item:.6f}s/item on {device}")]
    cs = CaseStudyConfig()
    out += _sweep_rows("fig2", rows(cs))
    out += _sweep_rows("fig2_measured",
                       rows(dataclasses.replace(cs, per_item_s=per_item)))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='where the model runs ("cuda" or "cpu")')
    args = ap.parse_args(argv)
    out = bench(args.device)
    for name, us, derived in out:
        print(f"{name},{us:.2f},{derived}")
    return out


if __name__ == "__main__":
    main()
