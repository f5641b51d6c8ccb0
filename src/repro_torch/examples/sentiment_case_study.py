"""The paper's case study, end to end (serving example):

  1. TRAIN the DistilBERT-family classifier on synthetic IMDb — not yet
     in the port (training is ROADMAP Queue 1 #3), so this example serves
     the initialised params and says so;
  2. serve the held-out set monolithically vs in parallel with REAL
     inference through the orchestrator, and check that the merged
     predictions equal one ``Engine.classify`` over the whole set;
  3. reproduce the paper-scale Fig. 2 sweep with the calibrated simulator.

Counterpart of the repository's ``examples/sentiment_case_study.py``
(parts 2 and 3), through the hand-written attention kernel on the GPU
(its plain version on the CPU).

    python -m repro_torch.examples.sentiment_case_study               # GPU
    python -m repro_torch.examples.sentiment_case_study --device cpu
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core import (ArtifactStore, BatchJob, LatencyModel,
                              MonolithicConfig, MonolithicRunner,
                              Orchestrator, OrchestratorConfig,
                              ServerlessFunction, decompose, merge)
from repro_torch.core.simulator import (CaseStudyConfig, run_monolithic,
                                        run_parallel)
from repro_torch.data import imdb_reviews
from repro_torch.data.pipeline import DatasetRef
from repro_torch.models import RunConfig, build
from repro_torch.serving import Engine

RUN = RunConfig(attn_impl="pallas")
SWEEP_BATCH_SIZES = (50, 100, 250, 500, 1000)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help='where the model runs ("cuda" or "cpu")')
    args = ap.parse_args(argv)

    # --- 1. the classifier: initialised params (training not ported) ----
    print("== sentiment classifier: initialised params (the port has no "
          "training yet; accuracy is chance) ==")
    cfg = configs.smoke("distilbert-imdb")
    model = build(cfg)
    tokens, labels = imdb_reviews(n=512, seq_len=48, vocab=cfg.vocab_size,
                                  signal_frac=0.15)
    engine = Engine(model, RUN, device=args.device)
    params = engine.place_params(
        model.init(torch.Generator().manual_seed(0), engine.device))
    test_tokens, test_labels = tokens[384:], labels[384:]
    whole = engine.classify(params, test_tokens)
    acc = float((whole == test_labels).mean())
    print(f"  held-out accuracy: {acc:.3f}")

    # --- 2. monolithic vs parallel on REAL inference ---------------------
    print("\n== real serving: monolithic vs parallel (128 held-out items) ==")
    store = ArtifactStore()
    store.put_tree("models/clf", params)
    job = BatchJob("case", DatasetRef("imdb", len(test_tokens), 48,
                                      cfg.vocab_size), "models/clf", 16)
    chunks = decompose(job)
    lat = LatencyModel(cold_start_s=0.5, per_item_s=None)

    def mk(i):
        return ServerlessFunction(i, store, lat, engine=engine,
                                  params_ref="models/clf")

    data = {"tokens": test_tokens}
    mono = MonolithicRunner(store, MonolithicConfig()).run(job, chunks, mk,
                                                           data=data)
    par = Orchestrator(store, OrchestratorConfig(max_concurrency=8)).run(
        job, chunks, mk, data=data)
    preds = merge(store, job, chunks)
    assert (preds == whole).all(), \
        "parallel decomposition must preserve monolithic semantics"
    print(f"  monolithic {mono.wall_time_s:5.1f}s ${mono.cost_usd:.6f} | "
          f"parallel {par.wall_time_s:5.1f}s ${par.cost_usd:.6f} | "
          f"speedup {mono.wall_time_s/par.wall_time_s:.1f}x, semantics exact")
    out = {"accuracy": acc, "mono": mono.summary(), "par": par.summary(),
           "predictions": preds}

    # --- 3. paper-scale calibrated sweep (Fig 2) -------------------------
    print("\n== paper-scale sweep (25k reviews, calibrated platform) ==")
    cs = CaseStudyConfig()
    print(f"{'bs':>5} {'mono_min':>9} {'mono_$':>8} {'par_min':>8} "
          f"{'par_$':>8} {'fns':>5} {'reduction':>9}")
    sweep = []
    for bs in SWEEP_BATCH_SIZES:
        m = run_monolithic(cs, bs)
        p = run_parallel(cs, bs)
        sweep.append((bs, m.summary(), p.summary()))
        print(f"{bs:>5} {m.wall_time_s/60:>9.1f} {m.cost_usd:>8.4f} "
              f"{p.wall_time_s/60:>8.2f} {p.cost_usd:>8.4f} "
              f"{p.n_invocations:>5} "
              f"{100*(1-p.wall_time_s/m.wall_time_s):>8.1f}%")
    print("\npaper claims: >95% time reduction at comparable cost — "
          "repro_torch.benchmarks.fig2.validate checks them")
    out["sweep"] = sweep
    return out


if __name__ == "__main__":
    main()
