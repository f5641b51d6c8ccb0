"""Quickstart: decompose a monolithic inference job into parallel
serverless-style functions and compare — the paper's idea in 40 lines.

Counterpart of the repository's ``examples/quickstart.py``, on a reduced
DistilBERT classifier with random weights, through the hand-written
attention kernel on the GPU (its plain version on the CPU).

    python -m repro_torch.examples.quickstart               # on the GPU
    python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core import (ArtifactStore, BatchJob, LatencyModel,
                              MonolithicConfig, MonolithicRunner,
                              Orchestrator, OrchestratorConfig,
                              ServerlessFunction, decompose, merge)
from repro_torch.data import imdb_reviews
from repro_torch.data.pipeline import DatasetRef
from repro_torch.models import RunConfig, build
from repro_torch.serving import Engine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='where the model runs ("cuda" or "cpu")')
    args = ap.parse_args(argv)

    # 1. a real model (reduced DistilBERT classifier) + real data
    cfg = configs.smoke("distilbert-imdb")
    model = build(cfg)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device=args.device)
    params = model.init(torch.Generator().manual_seed(0), engine.device)
    tokens, labels = imdb_reviews(n=128, seq_len=32, vocab=cfg.vocab_size)

    # 2. publish the model to the shared store (the EFS analogue)
    store = ArtifactStore()
    store.put_tree("models/clf", params)

    # 3. define the batch job and decompose it into chunks
    job = BatchJob("quickstart", DatasetRef("imdb", 128, 32, cfg.vocab_size),
                   "models/clf", batch_size=16)
    chunks = decompose(job)
    lat = LatencyModel(cold_start_s=0.5, per_item_s=None)  # real compute

    def make_worker(i):
        return ServerlessFunction(i, store, lat, engine=engine,
                                  params_ref="models/clf")

    # 4. monolithic baseline (one function, sequential batches)
    mono = MonolithicRunner(store, MonolithicConfig()).run(
        job, chunks, make_worker, data={"tokens": tokens})

    # 5. parallel functions via the Step-Functions-analogue orchestrator
    par = Orchestrator(store, OrchestratorConfig(max_concurrency=8)).run(
        job, chunks, make_worker, data={"tokens": tokens})
    preds = merge(store, job, chunks)
    accuracy = float((preds == labels).mean())

    print(f"monolithic: {mono.wall_time_s:6.1f}s  ${mono.cost_usd:.6f}")
    print(f"parallel:   {par.wall_time_s:6.1f}s  ${par.cost_usd:.6f}  "
          f"({par.n_invocations} functions)")
    print(f"speedup {mono.wall_time_s / par.wall_time_s:.1f}x at "
          f"{par.cost_usd / mono.cost_usd:.2f}x cost; "
          f"accuracy={accuracy:.3f}")
    return {"mono": mono.summary(), "par": par.summary(),
            "predictions": preds, "accuracy": accuracy}


if __name__ == "__main__":
    main()
