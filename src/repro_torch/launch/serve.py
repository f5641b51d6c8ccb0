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

Not in the port yet: ``--batch-dag`` (the batch DAG is the next slice),
``--mesh-slices`` (ROADMAP Queue 1 #4.3), and meshes one process cannot
form: ``--mesh 1x1 --seq-shard`` runs here, more ranks run through
``python -m repro_torch.examples.serve_cluster --ranks M``.

Usage:
  python -m repro_torch.launch.serve --n-items 256 --batch-size 32 \
      --concurrency 8 --crash-prob 0.1
  python -m repro_torch.launch.serve --router --traffic bursty --rate 24
  python -m repro_torch.launch.serve --calibrate      # fit + save
  python -m repro_torch.launch.serve --router --calibration calibration.json
  python -m repro_torch.launch.serve --http --port 8765   # live front door
      # curl -N -d '{"prompt": [3,1,4,1,5], "max_new_tokens": 8}' \
      #     http://127.0.0.1:8765/v1/generate
  python -m repro_torch.launch.serve --router --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import time
from typing import Awaitable, Callable, Dict, Optional, Sequence

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
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import ModelConfig
from repro_torch.obs import Observability, TraceRecorder
from repro_torch.router import (TRAFFIC, CalibratedLatencyModel,
                                EventRouter, HttpFrontDoor, QueueConfig,
                                QueueDepthPolicy, ReplicaConfig,
                                ReplicaPool, Router, RouterConfig,
                                WallClock, default_policies,
                                fit_round_model, make_requests,
                                measure_round_samples)
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


# ---------------------------------------------------------------------------
# Online modes: the router, its calibration and the HTTP front door
# ---------------------------------------------------------------------------


def lm_engine(cfg: ModelConfig, *, seed: int = 0, device="cuda",
              kv_dtype: str = "bf16", mesh=None, seq_shard: bool = False,
              params=None):
    """(engine, placed params) for the online modes: the hand kernels
    (``attn_impl="pallas"``; the engine makes it "seq_shard" under a mesh
    with ``seq_shard``), ``cache_pad=16`` as the reference. ``params``
    defaults to a random init from ``seed`` on the engine's device."""
    model = build(cfg)
    engine = Engine(model, RunConfig(attn_impl="pallas", cache_pad=16,
                                     kv_dtype=kv_dtype),
                    device=device, mesh=mesh, seq_shard=seq_shard)
    if params is None:
        params = model.init(
            torch.Generator(device=engine.device).manual_seed(seed),
            engine.device)
    return engine, engine.shard_params(params)


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
    if path:
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
               policies=None, store: bool = True) -> Dict[str, dict]:
    """Online mode: one ``Router`` run per policy on the same traffic.

    ``engine``/``params`` default to :func:`lm_engine` over ``cfg``;
    ``policies`` to ``default_policies``. With ``store`` the params are
    published to an ``ArtifactStore`` and every cold start pays their
    fetch, as the reference does (the fetch time follows the pickled
    size, which differs between the packages). Returns, per policy name,
    its ``summary``, ``report`` and ``router`` (whose ``completed`` holds
    the served requests).
    """
    if engine is None:
        engine, params = lm_engine(cfg, seed=seed, device=device,
                                   kv_dtype=kv_dtype, mesh=mesh,
                                   seq_shard=seq_shard)
    artifacts = None
    if store:
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
          f"{n_slots} slots/replica ==")
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
            store=artifacts, params_ref="models/lm")
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
                trace: bool = False) -> EventRouter:
    """The event-driven router the HTTP front door serves: queue-depth
    autoscaling on the wall clock, measured round times, observability
    on (with a ``TraceRecorder`` when ``trace``)."""
    pool = ReplicaPool(
        engine, params,
        replica_config(n_slots=n_slots, prompt_len=prompt_len,
                       max_new_tokens=max_new_tokens,
                       fused_sampling=fused_sampling),
        # wall-clock serving measures time; modeled round constants are
        # the virtual harness's business (EventRouter raises on both)
        lat=LatencyModel(cold_start_s=cold_start, per_item_s=None),
        injector=FaultInjector(seed=seed, crash_prob=crash_prob,
                               straggler_prob=straggler_prob))
    obs = Observability(tracer=TraceRecorder() if trace else None)
    return EventRouter(
        pool, QueueDepthPolicy(max_replicas=max_replicas),
        clock=WallClock(),
        queue_cfg=QueueConfig(max_depth=queue_cap,
                              default_deadline_s=deadline),
        traffic_name="http", obs=obs)


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
    :func:`http_router`."""
    if engine is None:
        engine, params = lm_engine(cfg, seed=seed, device=device,
                                   kv_dtype=kv_dtype, mesh=mesh,
                                   seq_shard=seq_shard)
    router = http_router(engine, params, seed=seed, trace=bool(trace),
                         **router_kw)
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


def parse_mesh(spec: Optional[str], seq_shard: bool):
    """``--mesh DxM`` as a mesh this one process can form: ``1x1``. Other
    shapes need one process a rank."""
    if spec is None:
        return None
    shape = tuple(int(x) for x in spec.lower().split("x"))
    if shape != (1, 1):
        raise SystemExit(
            f"--mesh {spec}: one process forms only a 1x1 mesh; run more "
            f"ranks with python -m repro_torch.examples.serve_cluster "
            f"--ranks M (a (1, M) sequence-sharded mesh)")
    if not seq_shard:
        raise SystemExit("--mesh 1x1 serves sequence-sharded decode: add "
                         "--seq-shard")
    return make_host_mesh(shape, ("data", "model"))


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
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help='("data", "model") mesh shape of the online '
                         'modes; one process forms "1x1" (with '
                         "--seq-shard), more ranks run through "
                         "repro_torch.examples.serve_cluster --ranks")
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
                    help="replica-per-mesh-slice mode (not in the port "
                         "yet: ROADMAP Queue 1 #4.3)")
    ap.add_argument("--budget-usd", type=float, default=1.0,
                    help="cost-cap policy budget")
    ap.add_argument("--batch-dag", action="store_true",
                    help="offline batch job as a shard/prefill/decode/"
                         "reduce DAG (not in the port yet)")
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

    if args.batch_dag:
        raise SystemExit("--batch-dag: the batch DAG (repro.batch) is not "
                         "ported yet; it is the port's next slice")
    if args.mesh_slices:
        raise SystemExit("--mesh-slices needs Engine.for_mesh and "
                         "slice_meshes, not ported yet (ROADMAP Queue 1 "
                         "#4.3)")
    online = args.http or args.router or args.calibrate
    if args.mesh and not online:
        raise SystemExit("--mesh applies to --router, --calibrate and "
                         "--http in the port")
    mesh = parse_mesh(args.mesh, args.seq_shard)
    if online:
        cfg = configs.smoke(args.router_arch)
        engine, params = lm_engine(cfg, seed=args.seed, device=args.device,
                                   kv_dtype=args.kv_dtype, mesh=mesh,
                                   seq_shard=args.seq_shard)
        common = dict(prompt_len=args.prompt_len,
                      max_new_tokens=args.max_new_tokens,
                      n_slots=args.n_slots, max_replicas=args.max_replicas,
                      deadline=args.deadline, queue_cap=args.queue_cap,
                      cold_start=args.cold_start,
                      crash_prob=args.crash_prob,
                      straggler_prob=args.straggler_prob,
                      fused_sampling=args.fused_sampling)
    if args.http:
        return run_http(cfg, engine=engine, params=params, seed=args.seed,
                        host=args.host, port=args.port, trace=args.trace,
                        serve_seconds=args.serve_seconds, **common)
    if online:
        cal = None
        cal_path = args.calibration or "calibration.json"
        if args.calibrate:
            cal = calibrate(engine, params, prompt_len=args.prompt_len,
                            max_new_tokens=args.max_new_tokens,
                            path=cal_path)
            if not args.router:
                return {"calibration": cal.to_json()}
        elif args.calibration:
            cal = CalibratedLatencyModel.load(cal_path)
            print(f"== loaded calibration {cal_path}: {cal.summary()} ==")
        runs = run_router(cfg, engine=engine, params=params, seed=args.seed,
                          traffic=args.traffic, rate=args.rate,
                          horizon=args.horizon,
                          per_token_s=args.per_token_s,
                          measured_time=args.measured_time,
                          calibration=cal, budget_usd=args.budget_usd,
                          **common)
        return {name: run["summary"] for name, run in runs.items()}
    out = run_offline(configs.smoke(args.arch), n_items=args.n_items,
                      seq_len=args.seq_len, batch_size=args.batch_size,
                      concurrency=args.concurrency,
                      crash_prob=args.crash_prob,
                      straggler_prob=args.straggler_prob, seed=args.seed,
                      device=args.device)
    return {"mono": out["mono"], "par": out["par"]}


if __name__ == "__main__":
    main()
