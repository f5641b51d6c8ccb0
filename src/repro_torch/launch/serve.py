"""Serving driver, offline mode: the paper's parallel batch inference.

Counterpart of the default (offline) mode of ``repro.launch.serve``. It
stands up the EFS-analogue store, publishes a model, decomposes a batch
job, and runs it monolithically AND in parallel through the orchestrator
with real inference on the engine's device — then prints the comparison
the paper's Fig. 2 makes, plus fault-tolerance statistics if faults are
injected.

Usage:
  python -m repro_torch.launch.serve --n-items 256 --batch-size 32 \
      --concurrency 8 --crash-prob 0.1
  python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.core import (ArtifactStore, BatchJob, FaultInjector,
                              LatencyModel, MonolithicConfig,
                              MonolithicRunner, Orchestrator,
                              OrchestratorConfig, ServerlessFunction,
                              decompose, merge)
from repro_torch.data import imdb_reviews
from repro_torch.data.pipeline import DatasetRef
from repro_torch.models import RunConfig, build
from repro_torch.models.common import ModelConfig
from repro_torch.serving import Engine


def run_offline(cfg: ModelConfig, *, n_items: int = 256, seq_len: int = 64,
                batch_size: int = 32, concurrency: int = 8,
                crash_prob: float = 0.0, straggler_prob: float = 0.0,
                seed: int = 0, device="cuda",
                run: RunConfig = RunConfig(attn_impl="pallas"),
                per_item_s: Optional[float] = None, params=None) -> dict:
    """Run one batch job monolithically, then in parallel, and compare.

    ``params`` defaults to a random init from ``seed``; ``per_item_s`` set
    switches the workers to modeled compute (no inference, no predictions).
    Returns the two ``summary()`` dicts under "mono"/"par", the reports,
    the host seconds each run took, the engine and its placed params, every
    worker created, the labels, and — with real compute — the merged
    predictions of both runs and the parallel accuracy.
    """
    model = build(cfg)
    engine = Engine(model, run, device=device)
    if params is None:
        params = model.init(torch.Generator().manual_seed(seed), device)
    params = engine.place_params(params)

    tokens, labels = imdb_reviews(n=n_items, seq_len=seq_len,
                                  vocab=cfg.vocab_size, seed=seed)
    store = ArtifactStore()
    store.put_tree("models/clf", params)
    job = BatchJob("serve", DatasetRef("imdb", n_items, seq_len,
                                       cfg.vocab_size),
                   "models/clf", batch_size)
    chunks = decompose(job)
    lat = LatencyModel(cold_start_s=0.2, per_item_s=per_item_s)
    injector = FaultInjector(seed=seed, crash_prob=crash_prob,
                             straggler_prob=straggler_prob)
    workers = []

    def factory(st):
        def mk(i):
            w = ServerlessFunction(i, st, lat, engine=engine,
                                   params_ref="models/clf")
            workers.append(w)
            return w
        return mk

    data = {"tokens": tokens}
    print(f"== job: {n_items} items, batch_size={batch_size}, "
          f"{len(chunks)} chunks ==")

    t0 = time.perf_counter()
    mono = MonolithicRunner(store, MonolithicConfig(),
                            injector=injector).run(job, chunks,
                                                   factory(store), data=data)
    mono_host_s = time.perf_counter() - t0
    print(f"monolithic: wall={mono.wall_time_s:.1f}s "
          f"cost=${mono.cost_usd:.6f} chains={mono.n_invocations} "
          f"crashes={mono.n_crashes}")

    store2 = ArtifactStore()
    store2.put_tree("models/clf", params)
    orch = Orchestrator(
        store2,
        OrchestratorConfig(max_concurrency=concurrency,
                           retry_max_attempts=6, speculation_factor=3.0),
        injector=FaultInjector(seed=seed + 1, crash_prob=crash_prob,
                               straggler_prob=straggler_prob))
    t0 = time.perf_counter()
    par = orch.run(job, chunks, factory(store2), data=data)
    par_host_s = time.perf_counter() - t0
    print(f"parallel:   wall={par.wall_time_s:.1f}s "
          f"cost=${par.cost_usd:.6f} fns={par.n_invocations} "
          f"retries={par.n_retries} spec={par.n_speculative} "
          f"crashes={par.n_crashes}")
    out = {"mono": mono.summary(), "par": par.summary(),
           "mono_report": mono, "par_report": par,
           "host_s": {"mono": mono_host_s, "par": par_host_s},
           "engine": engine, "params": params, "workers": workers,
           "labels": labels}
    line = (f"speedup: {mono.wall_time_s / par.wall_time_s:.1f}x | "
            f"cost ratio {par.cost_usd / max(mono.cost_usd, 1e-12):.2f} | "
            f"items/s {n_items / mono.wall_time_s:.1f} -> "
            f"{n_items / par.wall_time_s:.1f}")
    if per_item_s is None:
        out["mono_predictions"] = merge(store, job, chunks)
        out["predictions"] = preds = merge(store2, job, chunks)
        out["accuracy"] = float((preds == labels).mean())
        line += (f" | predictions merged exactly-once, "
                 f"acc={out['accuracy']:.3f}")
    print(line)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="distilbert-imdb")
    ap.add_argument("--n-items", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--crash-prob", type=float, default=0.0)
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help='where the model runs ("cuda" or "cpu")')
    args = ap.parse_args(argv)
    out = run_offline(configs.smoke(args.arch), n_items=args.n_items,
                      seq_len=args.seq_len, batch_size=args.batch_size,
                      concurrency=args.concurrency,
                      crash_prob=args.crash_prob,
                      straggler_prob=args.straggler_prob, seed=args.seed,
                      device=args.device)
    return {"mono": out["mono"], "par": out["par"]}


if __name__ == "__main__":
    main()
