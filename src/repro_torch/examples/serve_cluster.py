"""Generative serving over a sequence-sharded mesh, with fault injection.

Counterpart of ``examples/serve_cluster.py``: a mesh-aware engine drives
LM generation — continuous batching over one shared ragged KV cache whose
sequence dim is cut over the mesh's "model" axis — and then an
orchestrated generation job whose workers run ``Engine.generate`` while
crashes and stragglers are injected, showing retries, speculation,
elastic concurrency and exactly-once commits on a generative workload.

As in the reference, the mesh is ``(1, n)`` ("data", "model") over every
rank and the engine runs with ``seq_shard=True``: each rank holds its
block of the cache, decode attention runs the partials kernel on it and
the ranks merge with all_reduce (``dist.collectives``). Launched plainly
it is one rank (the one-block path: the partials kernel over the whole
cache). ``--ranks M`` spawns M ranks (``launch.mesh.spawn_ranks``, gloo
when they share one card) and so does ``torchrun --nproc-per-node M``;
rank 0 alone prints. The generation job runs on rank 0 on its own
single-device engine: its workers' calls follow a measured clock, which
ranks would not share.

On ``--device cpu`` it runs ``configs.smoke("qwen2-7b")`` at the
reference example's sizes. On the card (the default) it runs the
full-width ``qwen2-7b`` on random weights drawn from ``SEED``:
continuous batching of 24 requests (prompts of 64-512 tokens, 16-64 new
tokens) over 8 slots of a 1024-position cache, greedy and then sampled
through the sampling kernel; and the generation job at full width but
``JOB_LAYERS`` layers, because every cold function loads its own copy of
the params onto the card.

Usage:
  python -m repro_torch.examples.serve_cluster            # one GPU
  python -m repro_torch.examples.serve_cluster --ranks 2  # 2 ranks, 1 GPU
  python -m repro_torch.examples.serve_cluster --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import (ArtifactStore, BatchJob, ElasticPolicy,
                              FaultInjector, LatencyModel, Orchestrator,
                              OrchestratorConfig, ServerlessFunction,
                              decompose, merge)
from repro_torch.core.job import InvokeOutcome
from repro_torch.data.pipeline import DatasetRef
from repro_torch.launch.mesh import (init_from_env, make_host_mesh, rank_env,
                                     spawn_ranks)
from repro_torch.models import RunConfig, build
from repro_torch.serving import ContinuousBatcher, Engine, Request

# sampled pass of the continuous-batching part
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)


@dataclasses.dataclass(frozen=True)
class Sizes:
    n_requests: int
    n_slots: int
    prompt_len: tuple        # [lo, hi) tokens
    new_tokens: tuple        # [lo, hi) tokens
    max_len: Optional[int]   # None: longest prompt + cache_pad
    job_prompts: int
    job_prompt_len: int
    job_batch: int           # prompts per function invocation
    job_new_tokens: int
    job_concurrency: int
    job_max_concurrency: int


CPU_SIZES = Sizes(24, 4, (8, 9), (4, 12), None, 96, 8, 12, 4, 4, 16)
CARD_SIZES = Sizes(24, 8, (64, 513), (16, 65), 1024, 96, 64, 12, 8, 4, 8)
# Every cold function loads its own copy of the params onto the device (a
# full-width qwen2-7b copy is 15.2 GB), so on the card the job's model
# keeps qwen2-7b's widths and is cut to JOB_LAYERS layers: about 4 GB a
# copy, job_max_concurrency copies at most.
JOB_LAYERS = 4
SEED = 0  # weights, requests and prompts
RUN = RunConfig(attn_impl="pallas", cache_pad=64)
# the serving engine's knobs under the mesh (attn_impl becomes "seq_shard")
MESH_RUN = RunConfig(cache_pad=64)


@dataclasses.dataclass(frozen=True)
class PrefixSizes:
    """A workload whose requests come in groups that share a prompt prefix
    (a shared system prompt), for the paged cache's prefix sharing."""
    n_groups: int
    group_size: int
    prefix_len: int          # shared tokens, whole pages
    suffix_len: tuple        # [lo, hi) tokens after the prefix
    new_tokens: tuple        # [lo, hi) tokens
    n_slots: int
    max_len: int
    page_size: int


# On the card: 24 requests in three groups of eight, each group sharing a
# 448-token prefix (28 full pages of 16), over 8 slots of 1024 positions.
PAGED_CARD_SIZES = PrefixSizes(3, 8, 448, (16, 65), (16, 65), 8, 1024, 16)


def make_requests(vocab: int, n: int, prompt_len: tuple, new_tokens: tuple,
                  seed: int = 0) -> List[Request]:
    """``n`` requests of random prompts, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(*prompt_len)))
        reqs.append(Request(rid, prompt.astype(np.int32),
                            max_new_tokens=int(rng.integers(*new_tokens))))
    return reqs


def make_prefix_requests(vocab: int, sizes: PrefixSizes,
                         seed: int = 0) -> List[Request]:
    """``sizes.n_groups`` groups of ``sizes.group_size`` requests, drawn
    from a numpy seed: each group's prompts share one random prefix and
    go on with a random suffix of their own."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(sizes.n_groups):
        prefix = rng.integers(0, vocab, sizes.prefix_len)
        for _ in range(sizes.group_size):
            suffix = rng.integers(0, vocab,
                                  int(rng.integers(*sizes.suffix_len)))
            reqs.append(Request(
                len(reqs), np.concatenate([prefix, suffix]).astype(np.int32),
                max_new_tokens=int(rng.integers(*sizes.new_tokens))))
    return reqs


def serve(engine: Engine, params, requests: List[Request], *, n_slots: int,
          max_len: Optional[int] = None,
          on_round: Optional[Callable] = None, **batcher_kw) -> dict:
    """Continuous batching of ``requests``: rounds until all complete.
    ``on_round(batcher)`` runs after every round. Returns the batcher,
    the completed requests, the host seconds and the time buckets."""
    batcher = ContinuousBatcher(engine, params, n_slots=n_slots,
                                max_len=max_len, **batcher_kw)
    batcher.submit_many(requests)
    t0 = time.perf_counter()
    while not batcher.scheduler.idle:
        batcher.step()
        if on_round is not None:
            on_round(batcher)
    wall_s = time.perf_counter() - t0
    return {"batcher": batcher, "completed": batcher.scheduler.completed,
            "wall_s": wall_s, "bucket_s": batcher.take_bucket_s(),
            "tokens": sum(len(r.generated) for r in requests)}


def job_setup(cfg, dev: torch.device, sizes: Sizes):
    """The generation job's engine, params and prompts. On the CPU the
    model is ``cfg``; elsewhere ``cfg`` cut to ``JOB_LAYERS`` layers."""
    if dev.type != "cpu":
        cfg = dataclasses.replace(cfg, n_layers=JOB_LAYERS)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 1),
                        dev)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(sizes.job_prompts, sizes.job_prompt_len)
    ).astype(np.int32)
    return Engine(model, RUN, device=dev), params, prompts


class GenWorker(ServerlessFunction):
    """A worker whose payload is generation, not classification: greedy
    ``Engine.generate`` over its chunk's prompts."""

    def __init__(self, *args, max_new_tokens: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_new_tokens = max_new_tokens

    def invoke(self, job, chunk, data=None) -> InvokeOutcome:
        lat = self.latency
        self.invocations += 1
        cold = not self.warm
        start_s = lat.cold_start_s if cold else lat.warm_start_s
        load_s = self._cold_load() if cold else 0.0
        self.warm = True
        t0 = time.perf_counter()
        out = self.engine.generate(self._params,
                                   data["prompts"][chunk.start:chunk.end],
                                   max_new_tokens=self.max_new_tokens)
        compute_s = time.perf_counter() - t0  # ends in a copy to the host
        new = out[:, -self.max_new_tokens:]
        return InvokeOutcome(
            duration_s=lat.invoke_overhead_s + start_s + load_s + compute_s
            + lat.result_write_s,
            payload={"predictions": new.sum(-1), "tokens": new},  # digest
            cold_start=cold, max_ram_mb=self.ram_mb, compute_s=compute_s,
            load_s=load_s)


def run_generation_job(engine: Engine, params, prompts: np.ndarray, *,
                       batch_size: int, max_new_tokens: int,
                       concurrency: int, max_concurrency: int,
                       crash_prob: float = 0.15,
                       straggler_prob: float = 0.1, seed: int = 7) -> dict:
    """The orchestrated generation job under injected faults. Returns the
    report, the orchestrator, every worker created, the job's chunks and
    the generated tokens merged in prompt order."""
    store = ArtifactStore()
    store.put_tree("models/lm", params)
    job = BatchJob("gen", DatasetRef("prompts", len(prompts),
                                     prompts.shape[1],
                                     engine.model.cfg.vocab_size),
                   "models/lm", batch_size)
    chunks = decompose(job)
    lat = LatencyModel(cold_start_s=0.3, per_item_s=None)
    workers = []

    def make_worker(i):
        w = GenWorker(i, store, lat, engine=engine, params_ref="models/lm",
                      max_new_tokens=max_new_tokens)
        workers.append(w)
        return w

    orch = Orchestrator(
        store,
        OrchestratorConfig(max_concurrency=concurrency, retry_max_attempts=5,
                           speculation_factor=3.0,
                           elastic=ElasticPolicy(
                               min_concurrency=concurrency,
                               max_concurrency=max_concurrency,
                               scale_step=concurrency)),
        injector=FaultInjector(seed=seed, crash_prob=crash_prob,
                               straggler_prob=straggler_prob,
                               straggler_factor=8.0))
    report = orch.run(job, chunks, make_worker, data={"prompts": prompts})
    merge(store, job, chunks)  # raises unless every chunk committed once
    tokens = np.concatenate([
        pickle.loads(store.get(f"job/{job.job_id}/result/{c.chunk_id}")
                     )["tokens"] for c in chunks])
    return {"report": report, "orch": orch, "workers": workers,
            "chunks": chunks, "tokens": tokens}


def spawn(argv, ranks: int, timeout: float = 3600.0) -> int:
    """This example as ``ranks`` processes joined by a file rendezvous;
    relays rank 0's output. Returns the first non-zero exit code, or 0."""
    with tempfile.TemporaryDirectory() as tmp:
        done = spawn_ranks(["-m", "repro_torch.examples.serve_cluster",
                            *argv], ranks,
                           store_path=os.path.join(tmp, "store"),
                           timeout=timeout)
    print(done[0].stdout, end="")
    for r in done:
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
    return 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help='where the model runs ("cuda" or "cpu")')
    ap.add_argument("--ranks", type=int, default=1,
                    help="spawn this many ranks on a (1, ranks) mesh")
    args = ap.parse_args(argv)
    if args.ranks > 1 and rank_env()[1] == 1:
        code = spawn(["--device", args.device], args.ranks)
        if code:
            raise SystemExit(code)
        return {}
    dev = init_from_env(args.device)
    return run(dev, configs.smoke("qwen2-7b") if dev.type == "cpu"
               else configs.get("qwen2-7b"))


def run(dev, cfg) -> dict:
    """The example on this rank's ``dev`` for model ``cfg``: continuous
    batching, greedy then fused-sampled, over the seq-sharded shared cache
    of the ranks' (1, ranks) mesh, then (rank 0) the orchestrated
    generation job. Returns each run's results by name."""
    rank, world = rank_env()
    say = print if rank == 0 else (lambda *a, **k: None)
    sizes = CPU_SIZES if dev.type == "cpu" else CARD_SIZES

    # --- continuous batching over one seq-sharded shared ragged cache ---
    mesh = make_host_mesh((1, world), ("data", "model"))
    model = build(cfg)
    engine = Engine(model, MESH_RUN, device=dev, mesh=mesh, seq_shard=True)
    params = engine.shard_params(model.init(
        torch.Generator(device=dev).manual_seed(SEED), dev))
    out = {}
    for mode, kw in (("greedy", {}),
                     ("sampled", dict(fused_sampling=True, **SAMPLING))):
        reqs = make_requests(cfg.vocab_size, sizes.n_requests,
                             sizes.prompt_len, sizes.new_tokens, SEED)
        res = serve(engine, params, reqs, n_slots=sizes.n_slots,
                    max_len=sizes.max_len, seed=SEED, **kw)
        res["requests"] = reqs
        b = res["batcher"]
        say(f"== continuous batching ({mode}, mesh {mesh.shape}, cache "
            f"block {tuple(b.cache.layers[0]['k'].shape)} a rank): "
            f"{len(res['completed'])} requests over {sizes.n_slots} slots: "
            f"{b.decode_steps} slot-steps of decode in "
            f"{b.decode_dispatches} batched decode calls ({b.rounds} "
            f"rounds, one shared ragged cache), {b.sampler_dispatches} "
            f"host-sampler steps, {engine.compile_count} shape buckets, "
            f"{res['tokens'] / res['wall_s']:.1f} tokens/s")
        out[mode] = res
    del params, engine
    if rank != 0:
        return out

    # --- orchestrated generation job under faults -----------------------
    job_engine, job_params, prompts = job_setup(cfg, dev, sizes)
    print(f"\n== orchestrated generation job with injected faults "
          f"({job_engine.model.cfg.n_layers} layers) ==")
    job = run_generation_job(job_engine, job_params, prompts,
                             batch_size=sizes.job_batch,
                             max_new_tokens=sizes.job_new_tokens,
                             concurrency=sizes.job_concurrency,
                             max_concurrency=sizes.job_max_concurrency)
    report = job["report"]
    print(f"  chunks committed: {report.extra['committed']}/"
          f"{len(job['chunks'])}")
    print(f"  crashes={report.n_crashes} retries={report.n_retries} "
          f"speculative={report.n_speculative} "
          f"final_concurrency={report.extra['final_concurrency']} "
          f"workers={len(job['workers'])}")
    print(f"  wall={report.wall_time_s:.1f}s "
          f"billed={report.total_billed_s:.1f}s cost=${report.cost_usd:.6f}")
    if report.extra["committed"] != len(job["chunks"]):
        raise RuntimeError("the generation job did not complete")
    out["job"] = job
    return out


if __name__ == "__main__":
    main()
