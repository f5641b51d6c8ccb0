"""Serving entry point: the paper's parallel batch inference, end to end.

Counterpart of ``repro.launch.serve``. Every mode runs on ``cuda`` unless
given ``--device cpu``, with the hand-written attention and sampling
kernels on the card.

OFFLINE mode (default) stands up the EFS-analogue store, publishes a
model, decomposes a batch job, and runs it monolithically AND in
parallel through the orchestrator with real inference on the engine's
device — then prints the comparison the paper's Fig. 2 makes, plus
fault-tolerance statistics if faults are injected.

ONLINE mode (``--router``) puts LIVE traffic on the batched serving
stack instead: a synthetic arrival process (``--traffic
poisson|bursty|diurnal``) hits the ``repro_torch.router`` arrival queue,
and each autoscaling policy in turn drives a replica pool of
``ContinuousBatcher`` instances over one shared engine — cold starts,
optional crashes, and per-policy TTFT/TPOT/goodput/cost on one line each.

CALIBRATE mode (``--calibrate``) times prefill and decode rounds on the
engine, fits the router's round-time model to them
(``router/calibrate.py``) and saves the artifact to ``--calibration``;
with ``--router`` the run then uses it.

HTTP mode (``--http``) is the real front door: an asyncio event loop
(``repro_torch.router.frontdoor``) serves streaming clients over HTTP/1.1
— ``POST /v1/generate`` streams NDJSON token chunks as the shared batched
cache decodes them, TTFT/TPOT measured at real first-token/per-token
events. ``--trace PATH`` records per-request spans for
``python -m repro_torch.tools.trace_report PATH``.

BATCH-DAG mode (``--batch-dag``) runs the offline job as an explicit
shard→prefill→decode→reduce DAG (``repro_torch.batch``) on cloud-profiled
replica pools — heterogeneous spot/on-demand placement, preemptions
survived with bit-identical outputs, optional ``--chaos`` ladder.

Mesh mode: ``--mesh DxM`` lays a ("data", "model") mesh under the
engine, as the reference's: params in the planner's layout ("tp": heads,
d_ff, experts and vocabulary cut over "model"), the batch's rows cut over
"data", and with ``--seq-shard`` the decode KV cache's sequence over
"model". PyTorch runs one process a rank: with D * M > 1 this command
spawns D * M ranks of itself (``launch.mesh.spawn_ranks``, gloo where
they share a card or run on the CPU, NCCL where each has a GPU), every
rank runs the same job on the same inputs, and rank 0's report is the
one printed. A multi-rank mesh serves the offline mode, ``--router``
(modeled, calibrated or ``--measured-time`` clock) and ``--calibrate``:
each measured time is the slowest rank's (``Engine.agree``) or the
source rank's (``router.events``), so every rank takes the same
decisions. ``--mesh DxM --mesh-slices n`` cuts the mesh into ``n``
disjoint slices (``dist.sharding.slice_meshes``), one replica a slice
(``router.pool.SlicePool``), the launcher checking the cut before it
spawns; without ``--mesh`` the ``n`` slices are one-rank engines.
``--http --mesh DxM`` serves the front door from rank 0, which binds the
port and prints it, and feeds every rank's router one broadcast tick a
pass (``router.frontdoor.EventRouter``): every rank's report is the same
(``--http`` takes no ``--mesh-slices``).

Usage:
  python -m repro_torch.launch.serve --n-items 256 --batch-size 32 \
      --concurrency 8 --crash-prob 0.1
  python -m repro_torch.launch.serve --batch-dag --dag-workers 6 \
      --spot-workers 4 --preempt-rate 0.25 --chaos
  python -m repro_torch.launch.serve --router --traffic bursty --rate 24
  python -m repro_torch.launch.serve --calibrate      # fit + save
  python -m repro_torch.launch.serve --router --calibration calibration.json
  python -m repro_torch.launch.serve --http --port 8765   # live front door
      # curl -N -d '{"prompt": [3,1,4,1,5], "max_new_tokens": 8}' \
      #     http://127.0.0.1:8765/v1/generate
  python -m repro_torch.launch.serve --router --device cpu
  python -m repro_torch.launch.serve --mesh 2x2 --device cpu  # 4 ranks
  python -m repro_torch.launch.serve --router --mesh 2x2 --mesh-slices 2 \
      --device cpu    # 4 ranks, two replicas on (1, 2) slices
  python -m repro_torch.launch.serve --http --mesh 2x2 --port 8765 \
      --serve-seconds 60 --device cpu    # the front door on rank 0 of 4
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time
from typing import Awaitable, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.batch import (BatchDagRunner, BatchDataset, DagReport,
                               PlacementPolicy, chaos_ladder, inference_dag,
                               make_dataset, make_group)
from repro_torch.core import (ArtifactStore, BatchJob, FaultInjector,
                              LatencyModel, MonolithicConfig,
                              MonolithicRunner, Orchestrator,
                              OrchestratorConfig, ServerlessFunction,
                              decompose, merge)
from repro_torch.data import imdb_reviews
from repro_torch.data.pipeline import DatasetRef
from repro_torch.models import RunConfig, build
from repro_torch.dist.context import Mesh
from repro_torch.dist.sharding import slice_meshes
from repro_torch.launch.mesh import (init_from_env, make_host_mesh, rank_env,
                                     spawn_ranks)
from repro_torch.models.common import ModelConfig
from repro_torch.obs import Observability, TraceRecorder
from repro_torch.router import (TRAFFIC, CalibratedLatencyModel,
                                EventRouter, HttpFrontDoor, QueueConfig,
                                QueueDepthPolicy, ReplicaConfig,
                                ReplicaPool, Router, RouterConfig,
                                WallClock, default_policies,
                                fit_round_model, make_requests,
                                measure_round_samples)
from repro_torch.router.cloud import ON_DEMAND, spot_profile
from repro_torch.router.events import TickClock, VirtualClock
from repro_torch.serving import Engine


def run_offline(cfg: ModelConfig, *, n_items: int = 256, seq_len: int = 64,
                batch_size: int = 32, concurrency: int = 8,
                crash_prob: float = 0.0, straggler_prob: float = 0.0,
                seed: int = 0, device="cuda",
                run: RunConfig = RunConfig(attn_impl="pallas"),
                per_item_s: Optional[float] = None, params=None,
                mesh=None, seq_shard: bool = False) -> dict:
    """Run one batch job monolithically, then in parallel, and compare.

    ``params`` (whole) defaults to a random init from ``seed``; under a
    ``mesh`` the engine keeps this rank's shard of them. ``per_item_s``
    set switches the workers to modeled compute (no inference, no
    predictions).
    Returns the two ``summary()`` dicts under "mono"/"par", the reports,
    the host seconds each run took, the engine and its placed params, every
    worker created, the labels, and — with real compute — the merged
    predictions of both runs and the parallel accuracy.
    """
    model = build(cfg)
    engine = Engine(model, run, device=device, mesh=mesh,
                    seq_shard=seq_shard)
    if params is None:
        params = model.init(torch.Generator().manual_seed(seed), device,
                            shardings=engine.params_sharding)
    else:
        params = engine.shard_params(params)
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


# ---------------------------------------------------------------------------
# Online modes: the router, its calibration and the HTTP front door
# ---------------------------------------------------------------------------


def lm_engine(cfg: ModelConfig, *, seed: int = 0, device="cuda",
              kv_dtype: str = "bf16", mesh=None, seq_shard: bool = False,
              params=None, cache_pad: int = 16, slices: bool = False):
    """(engine, placed params) for the generative modes: the hand kernels
    (``attn_impl="pallas"``; the engine makes it "seq_shard" under a mesh
    with ``seq_shard``), ``cache_pad`` 16 as the reference's online modes
    (its batch DAG takes 8). ``params`` defaults to a random init from
    ``seed`` on the engine's device. With ``slices`` the engine is the
    template of a mesh-sliced pool and the params come back as a
    function of a slice's engine (``SlicePool``): each slice draws (or
    cuts) its own, so no rank holds the template's."""
    model = build(cfg)
    engine = Engine(model, RunConfig(attn_impl="pallas", cache_pad=cache_pad,
                                     kv_dtype=kv_dtype),
                    device=device, mesh=mesh, seq_shard=seq_shard)

    def place(eng):
        if params is None:  # this rank's slices, drawn leaf by leaf
            return model.init(
                torch.Generator(device=eng.device).manual_seed(seed),
                eng.device, shardings=eng.params_sharding)
        return eng.shard_params(params)
    return engine, (place if slices else place(engine))


def calibrate(engine: Engine, params, *, prompt_len: int = 16,
              max_new_tokens: int = 8,
              slot_counts: Sequence[int] = (1, 2, 4, 8),
              n_steps: int = 8, repeats: int = 1,
              path: Optional[str] = "calibration.json",
              source: str = "launch.serve --calibrate"
              ) -> CalibratedLatencyModel:
    """Time prefill rounds (prompts of ``prompt_len`` and twice that) and
    decode rounds (``slot_counts`` active slots, each the mean of
    ``n_steps`` calls) on ``engine``, every shape ``repeats`` times, and
    keep the fastest sample of each shape: a shared host slows down in
    bursts of seconds, and the fastest round is the one it disturbed
    least. Fit the round model to those samples alone, and save it to
    ``path``."""
    runs = [measure_round_samples(
        engine, params, slot_counts=slot_counts,
        prompt_lens=(prompt_len, 2 * prompt_len), n_steps=n_steps,
        max_len=prompt_len * 2 + max_new_tokens + 8)
        for _ in range(repeats)]
    samples = [min(shape, key=lambda s: s.seconds) for shape in zip(*runs)]
    print("== round samples: " + ", ".join(
        f"{s.source.removeprefix('measured:')} {s.seconds!r} s"
        + (f" (of {[r.seconds for r in shape]!r})" if repeats > 1 else "")
        for s, shape in zip(samples, zip(*runs))) + " ==")
    dev = engine.device
    cal = fit_round_model(
        samples, backend=dev.type,
        device_count=torch.cuda.device_count() if dev.type == "cuda" else 1,
        source=source)
    if path and rank_env()[0] == 0:  # every rank fitted the same model
        cal.save(path)
    print(f"== calibrated round model -> {path}: {cal.summary()} ==")
    return cal


def replica_config(*, n_slots: int = 4, prompt_len: int = 16,
                   max_new_tokens: int = 8, paged: bool = False,
                   fused_sampling: bool = False,
                   sampling: Optional[dict] = None) -> ReplicaConfig:
    """Every replica's cache covers prompt + new tokens + 8, as the
    reference's; ``sampling`` (temperature, top_k, top_p) makes every
    replica sample instead of taking the argmax."""
    return ReplicaConfig(n_slots=n_slots,
                         max_len=prompt_len + max_new_tokens + 8,
                         paged=paged, fused_sampling=fused_sampling,
                         **(sampling or {}))


def run_router(cfg: ModelConfig, *, engine: Optional[Engine] = None,
               params=None, seed: int = 0, device="cuda",
               kv_dtype: str = "bf16", mesh=None, seq_shard: bool = False,
               traffic: str = "poisson", rate: float = 12.0,
               horizon: float = 8.0, prompt_len: int = 16,
               max_new_tokens: int = 8, n_slots: int = 4,
               max_replicas: int = 8, deadline: Optional[float] = None,
               queue_cap: Optional[int] = None, cold_start: float = 0.5,
               per_token_s: float = 0.02, measured_time: bool = False,
               calibration: Optional[CalibratedLatencyModel] = None,
               crash_prob: float = 0.0, straggler_prob: float = 0.0,
               budget_usd: float = 1.0, fused_sampling: bool = False,
               paged: bool = False, sampling: Optional[dict] = None,
               policies=None, store: bool = True,
               mesh_slices: Optional[int] = None) -> Dict[str, dict]:
    """Online mode: one ``Router`` run per policy on the same traffic.

    ``engine``/``params`` default to :func:`lm_engine` over ``cfg``;
    ``policies`` to ``default_policies``. With ``store`` the params are
    published to an ``ArtifactStore`` and every cold start pays their
    fetch, as the reference does (the fetch time follows the pickled
    size, which differs between the packages; params given as a function
    of a slice's engine are not published). ``mesh_slices`` puts each
    replica on its own slice of the engine's mesh (``SlicePool``).
    Returns, per policy name, its ``summary``, ``report`` and ``router``
    (whose ``completed`` holds the served requests).
    """
    if engine is None:
        engine, params = lm_engine(cfg, seed=seed, device=device,
                                   kv_dtype=kv_dtype, mesh=mesh,
                                   seq_shard=seq_shard,
                                   slices=bool(mesh_slices))
    artifacts = None
    if store and not callable(params):
        artifacts = ArtifactStore()
        artifacts.put_tree("models/lm", params)
    if calibration is not None and measured_time:
        raise SystemExit(
            "--measured-time conflicts with --calibrate/--calibration: "
            "the calibrated clock replaces measured wall time — drop one")

    arrivals = TRAFFIC[traffic](rate, horizon, seed)
    if calibration is not None:
        # calibrated mode: the artifact carries the round constants —
        # LatencyModel.per_item_s must stay None (Router errors loudly
        # if both are supplied)
        lat = calibration.to_latency_model(cold_start_s=cold_start)
        router_cfg = calibration.to_router_config()
        per_token_s = calibration.per_item_s
    else:
        lat = LatencyModel(cold_start_s=cold_start,
                           per_item_s=None if measured_time
                           else per_token_s)
        router_cfg = RouterConfig()
    rcfg = replica_config(n_slots=n_slots, prompt_len=prompt_len,
                          max_new_tokens=max_new_tokens, paged=paged,
                          fused_sampling=fused_sampling, sampling=sampling)
    if policies is None:
        # one replica retires ~1/per_token_s tokens of work per second
        # (the work-conserving time model)
        policies = default_policies(slots_per_replica=n_slots,
                                    max_replicas=max_replicas,
                                    tokens_per_s_per_replica=1.0
                                    / max(per_token_s, 1e-6),
                                    budget_usd=budget_usd)
    print(f"== router: {len(arrivals)} requests over {horizon:.0f}s "
          f"({traffic} at {rate:.0f} rps), "
          f"prompt {prompt_len} + {max_new_tokens} new tokens, "
          f"{n_slots} slots/replica"
          + (f", {mesh_slices} mesh slices" if mesh_slices else "")
          + " ==")
    out = {}
    for policy in policies:
        reqs = make_requests(arrivals, prompt_len=prompt_len,
                             max_new_tokens=max_new_tokens,
                             vocab=cfg.vocab_size, seed=seed,
                             deadline_s=deadline)
        pool = ReplicaPool(
            engine, params, rcfg, lat=lat,
            injector=FaultInjector(seed=seed, crash_prob=crash_prob,
                                   straggler_prob=straggler_prob),
            store=artifacts, params_ref="models/lm",
            mesh_slices=mesh_slices)
        router = Router(pool, policy, reqs,
                        queue_cfg=QueueConfig(max_depth=queue_cap,
                                              default_deadline_s=deadline),
                        cfg=router_cfg, traffic_name=traffic)
        report = router.run()
        print(report.format_line())
        out[policy.name] = {"summary": report.summary(), "report": report,
                            "router": router}
    return out


def http_router(engine: Engine, params, *, seed: int = 0,
                prompt_len: int = 16, max_new_tokens: int = 8,
                n_slots: int = 4, max_replicas: int = 8,
                deadline: Optional[float] = None,
                queue_cap: Optional[int] = None, cold_start: float = 0.5,
                crash_prob: float = 0.0, straggler_prob: float = 0.0,
                fused_sampling: bool = False,
                sampling: Optional[dict] = None,
                trace: bool = False) -> EventRouter:
    """The event-driven router the HTTP front door serves: queue-depth
    autoscaling on the wall clock (rank 0's, ticked to every rank, where
    several ranks run it), measured round times, observability on (with a
    ``TraceRecorder`` when ``trace``); ``sampling`` (temperature, top_k,
    top_p) makes every replica sample instead of taking the argmax."""
    pool = ReplicaPool(
        engine, params,
        replica_config(n_slots=n_slots, prompt_len=prompt_len,
                       max_new_tokens=max_new_tokens,
                       fused_sampling=fused_sampling, sampling=sampling),
        # wall-clock serving measures time; modeled round constants are
        # the virtual harness's business (EventRouter raises on both)
        lat=LatencyModel(cold_start_s=cold_start, per_item_s=None),
        injector=FaultInjector(seed=seed, crash_prob=crash_prob,
                               straggler_prob=straggler_prob))
    obs = Observability(tracer=TraceRecorder() if trace else None)
    return EventRouter(
        pool, QueueDepthPolicy(max_replicas=max_replicas),
        clock=TickClock() if _world() > 1 else WallClock(),
        queue_cfg=QueueConfig(max_depth=queue_cap,
                              default_deadline_s=deadline),
        traffic_name="http", obs=obs)


def _world() -> int:
    """Ranks in the default process group (1 without one)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def run_http(cfg: ModelConfig, *, engine: Optional[Engine] = None,
             params=None, seed: int = 0, device="cuda",
             kv_dtype: str = "bf16", mesh=None, seq_shard: bool = False,
             host: str = "127.0.0.1", port: int = 8765,
             trace: Optional[str] = None,
             serve_seconds: Optional[float] = None,
             clients: Optional[Callable[[int], Awaitable]] = None,
             **router_kw) -> dict:
    """Live HTTP mode: the asyncio front door over the event-driven
    router (wall clock, measured TTFT). Serves until interrupted, for
    ``serve_seconds``, or, given ``clients`` (an async function of the
    bound port), until those clients are done; a serve loop that fails
    first raises its error. Then drains, prints the report and dumps the
    trace to ``trace``. Returns the port, the report's summary, the
    router and what ``clients`` returned. ``router_kw`` goes to
    :func:`http_router`.

    Where several ranks run (a multi-rank mesh), every rank calls this
    alike: rank 0 serves as above and ticks the others' routers, which
    follow it (``EventRouter.follow``) and return no port, nothing from
    ``clients`` (rank 0's alone run) and the same report."""
    if engine is None:
        engine, params = lm_engine(cfg, seed=seed, device=device,
                                   kv_dtype=kv_dtype, mesh=mesh,
                                   seq_shard=seq_shard)
    router = http_router(engine, params, seed=seed, trace=bool(trace),
                         **router_kw)
    if _world() > 1 and torch.distributed.get_rank() != 0:
        router.follow()
        print(router.report().format_line())
        return {"port": None, "report": router.report().summary(),
                "router": router, "clients": None}
    door = HttpFrontDoor(router, host=host, port=port)

    async def _serve():
        await door.start()
        print(f"== serving on http://{host}:{door.port} — "
              f"POST /v1/generate, GET /healthz, GET /metrics "
              f"(Prometheus), GET /metrics.json ==")
        try:
            if clients is not None:
                return await door.until(clients(door.port))
            if serve_seconds is None:
                await asyncio.Event().wait()      # until Ctrl-C
            else:
                await asyncio.sleep(serve_seconds)
        finally:
            await door.close()
            print(router.report().format_line())
            if trace:
                n = router.obs.tracer.dump(trace)
                print(f"== trace: {n} events -> {trace} (analyze: python "
                      f"-m repro_torch.tools.trace_report {trace}) ==")

    served = None
    try:
        served = asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
    return {"port": door.port, "report": router.report().summary(),
            "router": router, "clients": served}


# ---------------------------------------------------------------------------
# Batch-DAG mode: the offline job as a shard→prefill→decode→reduce DAG
# ---------------------------------------------------------------------------


def dag_groups(engine: Engine, params, rcfg: ReplicaConfig, n_workers: int,
               *, spot_workers: int = 0, preempt_rate: float = 0.25,
               seed: int = 0, kills: Optional[dict] = None) -> list:
    """The worker pools of one DAG run: ``n_workers - spot_workers``
    on-demand replicas (group 0 when there are any), then ``spot_workers``
    from a spot market preempting at ``preempt_rate`` per worker-second
    (seed ``seed + 3``, as the reference). ``kills`` maps a group's index
    to the chaos harness's explicit kills."""
    kills = kills or {}
    n_od = max(n_workers - spot_workers, 0)
    out = []
    if n_od:
        out.append(make_group(engine, params, ON_DEMAND, n_od, cfg=rcfg,
                              extra_kills=kills.get(0, ())))
    if n_workers - n_od:
        sp = spot_profile(preempt_rate_per_s=preempt_rate, seed=seed + 3)
        out.append(make_group(engine, params, sp, n_workers - n_od,
                              cfg=rcfg, extra_kills=kills.get(len(out), ())))
    return out


def run_dag(data: BatchDataset, shard_size: int, groups: list, *,
            per_token_s: float = 0.02,
            calibration: Optional[CalibratedLatencyModel] = None
            ) -> DagReport:
    """One DAG run of ``data`` in shards of ``shard_size`` rows on
    ``groups``, on a fresh ``VirtualClock`` and store. Rounds take the
    reference's modeled time (``per_token_s`` a token, 0.02 s a host task)
    or, with ``calibration``, the fitted round-time model."""
    if calibration is None:
        times = dict(per_item_s=per_token_s)
    else:
        times = dict(per_item_s=calibration.per_item_s,
                     prefill_token_factor=calibration.prefill_token_factor,
                     round_overhead_s=calibration.round_overhead_s)
    dag = inference_dag(data.n_items, shard_size)
    return BatchDagRunner(dag, data, groups, clock=VirtualClock(),
                          store=ArtifactStore(),
                          placement=PlacementPolicy(),
                          task_overhead_s=0.02, **times).run()


def run_batch_dag(cfg: ModelConfig, *, engine: Optional[Engine] = None,
                  params=None, seed: int = 0, device="cuda",
                  dag_items: int = 48, dag_shard_size: int = 8,
                  dag_workers: int = 6, spot_workers: int = 0,
                  preempt_rate: float = 0.25, prompt_len: int = 16,
                  max_new_tokens: int = 8, n_slots: int = 4,
                  per_token_s: float = 0.02, chaos: bool = False) -> dict:
    """Batch-DAG mode: the offline job as an explicit
    shard→prefill→decode→reduce DAG on cloud-profiled replica pools —
    monolithic (one on-demand worker) vs parallel (``dag_workers``, of
    them ``spot_workers`` spot), spot preemptions survived with
    bit-identical outputs, and with ``chaos`` the chaos ladder on the
    parallel run's pools.

    ``engine``/``params`` default to :func:`lm_engine` over ``cfg`` with
    ``cache_pad=8``, as the reference. Returns the two summaries under
    "mono"/"par", "outputs_identical", and with ``chaos`` the ladder's
    kills and parity, as the reference."""
    if engine is None:
        engine, params = lm_engine(cfg, seed=seed, device=device,
                                   cache_pad=8)
    data = make_dataset(dag_items, prompt_len=prompt_len,
                        vocab=cfg.vocab_size,
                        max_new_tokens=max_new_tokens, seed=seed)
    rcfg = ReplicaConfig(n_slots=n_slots,
                         max_len=prompt_len + max_new_tokens)

    def groups(n_workers, kills=None, spot=spot_workers):
        return dag_groups(engine, params, rcfg, n_workers,
                          spot_workers=spot, preempt_rate=preempt_rate,
                          seed=seed, kills=kills)

    def run(shard_size, gs):
        return run_dag(data, shard_size, gs, per_token_s=per_token_s)

    print(f"== batch DAG: {dag_items} items, shard={dag_shard_size}, "
          f"{dag_workers} workers ({spot_workers} spot at "
          f"{preempt_rate}/s) ==")
    # the baseline is always one ON-DEMAND worker: the paper's "rent one
    # big box" reference point is never preemptible
    mono = run(dag_items, groups(1, spot=0))
    print(f"monolithic: wall={mono.wall_s:.2f}s busy={mono.busy_s:.2f}s "
          f"cost=${mono.cost_usd:.6f} tasks={mono.n_tasks}")
    par = run(dag_shard_size, groups(dag_workers))
    print(f"parallel:   wall={par.wall_s:.2f}s busy={par.busy_s:.2f}s "
          f"cost=${par.cost_usd:.6f} tasks={par.n_tasks} "
          f"preemptions={par.n_preemptions} spawns={par.n_spawns}")
    match = par.digest == mono.digest
    print(f"speedup: {mono.wall_s / par.wall_s:.2f}x | cost ratio "
          f"{par.cost_usd / max(mono.cost_usd, 1e-12):.3f} | outputs "
          f"{'identical' if match else 'DIVERGED'} | "
          f"compiles {mono.compile_count}->{par.compile_count}")
    out = {"mono": mono.summary(), "par": par.summary(),
           "outputs_identical": match}
    if chaos:
        reports, kills = chaos_ladder(
            lambda k: run(dag_shard_size, groups(dag_workers, k)))
        # output parity only: with live spot pools the Poisson process
        # adds its own preemptions, so the exact fired-kill count
        # (n_preemptions == k) holds on on-demand pools only
        parity = all(r.digest == reports[0].digest for r in reports)
        print(f"chaos ladder: {len(kills)} stage-boundary kills, "
              f"preemptions per rung "
              f"{[r.n_preemptions for r in reports]}, "
              f"parity={'OK' if parity else 'VIOLATED'} "
              f"(dup commits: "
              f"{max(r.n_duplicate_commits for r in reports)})")
        out["chaos"] = {"kills": len(kills), "parity": parity}
    return out


def parse_mesh(spec: Optional[str]) -> Optional[tuple]:
    """``--mesh DxM`` as the (D, M) shape of a ("data", "model") mesh."""
    if spec is None:
        return None
    try:
        shape = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise SystemExit(f"--mesh {spec}: want DxM, e.g. 2x2")
    return shape


def check_layout(cfg: ModelConfig, shape: tuple, *, seq_shard: bool,
                 kv_dtype: str = "bf16", mesh_slices: Optional[int] = None):
    """Raise ``SystemExit`` before any rank starts when the engine would
    refuse ``cfg`` on a ``shape`` mesh (the layout rank 0 would plan), or
    on each of its ``mesh_slices`` slices."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    try:
        mesh = Mesh(grid, ("data", "model"))
        if mesh_slices:
            mesh = slice_meshes(mesh, mesh_slices)[0]
        Engine(build(cfg), RunConfig(kv_dtype=kv_dtype), device="cpu",
               mesh=mesh, seq_shard=seq_shard)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(f"--mesh {'x'.join(map(str, shape))}"
                         + (f" --mesh-slices {mesh_slices}" if mesh_slices
                            else "") + f": {e}")


def spawn_mesh(argv: Sequence[str], ranks: int, timeout: float, *,
               every_rank: bool = False) -> dict:
    """This command as ``ranks`` processes (``launch.mesh.spawn_ranks``):
    relays rank 0's output and returns its result (``--result``); with
    ``every_rank``, under ``"ranks"``, every rank's result too."""
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.json")
        done = spawn_ranks(["-m", "repro_torch.launch.serve", *argv,
                            "--result", result], ranks,
                           store_path=os.path.join(tmp, "store"),
                           timeout=timeout)
        print(done[0].stdout, end="")
        for r, p in enumerate(done):
            if p.returncode:
                print(p.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"rank {r} of {ranks} exited "
                                 f"{p.returncode}")
        with open(result) as f:
            out = json.load(f)
        if every_rank:
            out["ranks"] = [out] + [_load(f"{result}.rank{r}")
                                    for r in range(1, ranks)]
        return out


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def main(argv=None, *, rank_timeout: float = 3600.0):
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
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help='("data", "model") mesh shape; D * M > 1 spawns '
                         "that many ranks of this command")
    ap.add_argument("--full-width", action="store_true",
                    help="serve --arch at its published width "
                         "(configs.get) instead of its smoke config")
    ap.add_argument("--result", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-shard decode KV caches over 'model'")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=("bf16", "int8"),
                    help="decode KV cache dtype; int8 stores per-token "
                         "quantization scales alongside (conflicts with "
                         "--mesh)")
    ap.add_argument("--fused-sampling", action="store_true",
                    help="draw each round's tokens inside the decode "
                         "call (zero separate sampler steps); same token "
                         "streams as the host sampler at a fixed seed")
    # -- online mode (repro_torch.router) --------------------------------
    ap.add_argument("--router", action="store_true",
                    help="online mode: live traffic through the "
                         "autoscaling router (ignores the offline "
                         "batch-job flags)")
    ap.add_argument("--traffic", default="poisson",
                    choices=("poisson", "bursty", "diurnal"))
    ap.add_argument("--rate", type=float, default=12.0,
                    help="arrival rate (requests/s; burst/peak rate for "
                         "bursty/diurnal)")
    ap.add_argument("--horizon", type=float, default=8.0,
                    help="traffic horizon in virtual seconds")
    ap.add_argument("--router-arch", default="qwen2-7b",
                    help="decoder LM for online generation (smoke-sized)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--max-replicas", type=int, default=8)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request SLO seconds (goodput denominator)")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="admission control: reject past this depth")
    ap.add_argument("--cold-start", type=float, default=0.5,
                    help="replica cold-start seconds on the virtual clock")
    ap.add_argument("--per-token-s", type=float, default=0.02,
                    help="modeled seconds per decode token per slot")
    ap.add_argument("--measured-time", action="store_true",
                    help="advance the virtual clock by measured host "
                         "wall time instead of the token model")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure round samples on this engine, fit the "
                         "round-time model (router/calibrate.py) and save "
                         "the artifact to --calibration; with --router "
                         "the run then uses it")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="CalibratedLatencyModel JSON to load for the "
                         "router run (written here by --calibrate; "
                         "default path calibration.json)")
    ap.add_argument("--mesh-slices", type=int, default=None,
                    help="replica-per-mesh-slice mode: cut the --mesh "
                         "into this many disjoint slices, one replica "
                         "each (without --mesh: one-rank engines)")
    ap.add_argument("--budget-usd", type=float, default=1.0,
                    help="cost-cap policy budget")
    # -- batch-DAG mode (repro_torch.batch) ------------------------------
    ap.add_argument("--batch-dag", action="store_true",
                    help="offline batch job as an explicit shard/prefill/"
                         "decode/reduce DAG on cloud-profiled pools "
                         "(repro_torch.batch): monolithic vs parallel, spot "
                         "preemptions survived with identical outputs")
    ap.add_argument("--dag-items", type=int, default=48,
                    help="batch-DAG dataset rows")
    ap.add_argument("--dag-shard-size", type=int, default=8,
                    help="rows per DAG shard (one prefill+decode chain "
                         "per shard)")
    ap.add_argument("--dag-workers", type=int, default=6,
                    help="total replicas for the parallel DAG run")
    ap.add_argument("--spot-workers", type=int, default=0,
                    help="of --dag-workers, how many come from a spot "
                         "pool (cheaper, preemptible)")
    ap.add_argument("--preempt-rate", type=float, default=0.25,
                    help="spot-pool preemption rate (kills per "
                         "worker-second of the Poisson process)")
    ap.add_argument("--chaos", action="store_true",
                    help="after the comparison, run the chaos ladder "
                         "(one deterministic kill per DAG stage "
                         "boundary; asserts output parity)")
    # -- HTTP front door (repro_torch.router.frontdoor) ------------------
    ap.add_argument("--http", action="store_true",
                    help="live serving mode: asyncio HTTP front door "
                         "over the event-driven router (wall clock, "
                         "measured TTFT); POST /v1/generate streams "
                         "NDJSON token chunks")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765,
                    help="HTTP front-door port (0 = ephemeral)")
    ap.add_argument("--serve-seconds", type=float, default=None,
                    help="with --http: stop serving after this many "
                         "seconds (default: until interrupted)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-request trace spans (repro_torch.obs "
                         "JSONL) and write them here on shutdown; analyze "
                         "with python -m repro_torch.tools.trace_report")
    args = ap.parse_args(argv)

    if args.http and args.mesh_slices:
        raise SystemExit("--http takes no --mesh-slices: the front door "
                         "serves one replica pool over the whole mesh")
    if args.batch_dag:
        return run_batch_dag(
            configs.smoke(args.router_arch), seed=args.seed,
            device=args.device, dag_items=args.dag_items,
            dag_shard_size=args.dag_shard_size,
            dag_workers=args.dag_workers, spot_workers=args.spot_workers,
            preempt_rate=args.preempt_rate, prompt_len=args.prompt_len,
            max_new_tokens=args.max_new_tokens, n_slots=args.n_slots,
            per_token_s=args.per_token_s, chaos=args.chaos)
    online = args.http or args.router or args.calibrate
    arch = args.router_arch if online else args.arch
    cfg = configs.get(arch) if args.full_width else configs.smoke(arch)
    shape = parse_mesh(args.mesh)
    mesh = None
    if shape is not None:
        ranks = int(np.prod(shape))
        if ranks > 1 and rank_env()[1] == 1:  # the launcher: start ranks
            check_layout(cfg, shape, seq_shard=args.seq_shard,
                         kv_dtype=args.kv_dtype,
                         mesh_slices=args.mesh_slices)
            argv = list(argv if argv is not None else sys.argv[1:])
            return spawn_mesh(argv, ranks, rank_timeout,
                              every_rank=args.http)
        device = init_from_env(args.device)
        args.device = str(device)
        mesh = make_host_mesh(shape, ("data", "model"))
    if online:
        engine, params = lm_engine(cfg, seed=args.seed, device=args.device,
                                   kv_dtype=args.kv_dtype, mesh=mesh,
                                   seq_shard=args.seq_shard,
                                   slices=bool(args.mesh_slices
                                               and args.router))
        common = dict(prompt_len=args.prompt_len,
                      max_new_tokens=args.max_new_tokens,
                      n_slots=args.n_slots, max_replicas=args.max_replicas,
                      deadline=args.deadline, queue_cap=args.queue_cap,
                      cold_start=args.cold_start,
                      crash_prob=args.crash_prob,
                      straggler_prob=args.straggler_prob,
                      fused_sampling=args.fused_sampling)
    if args.http:
        out = run_http(cfg, engine=engine, params=params, seed=args.seed,
                       host=args.host, port=args.port, trace=args.trace,
                       serve_seconds=args.serve_seconds, **common)
        _result(args, {"port": out["port"], "report": out["report"]})
        return out
    if online:
        cal = None
        cal_path = args.calibration or "calibration.json"
        if args.calibrate:
            cal = calibrate(engine, params, prompt_len=args.prompt_len,
                            max_new_tokens=args.max_new_tokens,
                            path=cal_path)
            if not args.router:
                return _result(args, {"calibration": cal.to_json()})
        elif args.calibration:
            cal = CalibratedLatencyModel.load(cal_path)
            print(f"== loaded calibration {cal_path}: {cal.summary()} ==")
        runs = run_router(cfg, engine=engine, params=params, seed=args.seed,
                          traffic=args.traffic, rate=args.rate,
                          horizon=args.horizon,
                          per_token_s=args.per_token_s,
                          measured_time=args.measured_time,
                          calibration=cal, budget_usd=args.budget_usd,
                          mesh_slices=args.mesh_slices, **common)
        return _result(args, {name: run["summary"]
                              for name, run in runs.items()})
    out = run_offline(cfg, n_items=args.n_items, seq_len=args.seq_len,
                      batch_size=args.batch_size,
                      concurrency=args.concurrency,
                      crash_prob=args.crash_prob,
                      straggler_prob=args.straggler_prob, seed=args.seed,
                      device=args.device, mesh=mesh,
                      seq_shard=args.seq_shard)
    return _result(args, {"mono": out["mono"], "par": out["par"],
                          "predictions": out["predictions"],
                          "accuracy": out["accuracy"]})


def _result(args, result: dict) -> dict:
    """``result``, written as JSON to ``--result`` by rank 0 (rank r > 0
    of several to ``--result`` + ``.rank{r}``)."""
    if args.result:
        rank = rank_env()[0]
        with open(args.result + (f".rank{rank}" if rank else ""),
                  "w") as f:
            json.dump(_jsonable(result), f)
    return result


if __name__ == "__main__":
    main()
