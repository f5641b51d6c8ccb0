"""Calibrated case-study simulator: the paper's Fig. 2 at its own scale.

Counterpart of ``repro.core.simulator``. The paper's absolute numbers
imply these platform constants (from the monolithic row pair):

    total_mono(bs) = n_items·per_item + n_batches(bs)·per_batch + chains·start
    363.5 min @ bs=50  and  336.5 min @ bs=1000  (n_items = 25 000)
      ->  per_batch ≈ 3.4 s   (EFS batch fetch + result write)
      ->  per_item  ≈ 0.80 s  (DistilBERT CPU inference at Lambda ~850 MB)
    parallel @ bs=50 runs 500 concurrent functions in ~1.01 min
      ->  cold_start ≈ 12 s   (container + runtime from EFS)

These are the paper's Lambda figures. ``benchmarks/fig2.py`` in this
package can swap ``per_item_s`` for a measurement of the port's engine
on its device and keep the platform constants, so a sweep mixes real
compute with the paper's platform calibration, labelled as such.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.decompose import decompose
from repro_torch.core.faults import NO_FAULTS, FaultInjector
from repro_torch.core.job import BatchJob, JobReport
from repro_torch.core.monolithic import MonolithicConfig, MonolithicRunner
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig
from repro_torch.core.store import ArtifactStore
from repro_torch.core.worker import LatencyModel, ServerlessFunction
from repro_torch.data.pipeline import DatasetRef

PAPER_BATCH_SIZES = [50, 100, 125, 200, 250, 333, 500, 625, 1000]


@dataclasses.dataclass(frozen=True)
class CaseStudyConfig:
    n_items: int = 25_000
    ram_mb: float = 848.0
    per_item_s: float = 0.801
    per_batch_overhead_s: float = 3.4   # EFS batch fetch + result write
    cold_start_s: float = 12.0          # ML runtime cold start via EFS
    model_bytes: int = 265_000_000      # DistilBERT fp32 on the store
    store_read_mbps: float = 300.0
    parallel_concurrency: Optional[int] = None  # None -> n_chunks (paper)


def _latency(cs: CaseStudyConfig) -> LatencyModel:
    return LatencyModel(
        cold_start_s=cs.cold_start_s,
        warm_start_s=0.01,
        invoke_overhead_s=0.05,
        result_write_s=cs.per_batch_overhead_s,  # per-chunk store IO
        per_item_s=cs.per_item_s,
    )


def make_job(cs: CaseStudyConfig, batch_size: int,
             mode: str) -> BatchJob:
    ds = DatasetRef(name="imdb-25k", n_items=cs.n_items, seq_len=256,
                    vocab=30_522)
    return BatchJob(job_id=f"{mode}-bs{batch_size}", dataset=ds,
                    model_ref="models/distilbert", batch_size=batch_size,
                    ram_mb=int(cs.ram_mb))


def _store(cs: CaseStudyConfig) -> ArtifactStore:
    store = ArtifactStore(read_bandwidth_mbps=cs.store_read_mbps)
    store.put("models/distilbert", b"\0" * 1024)  # placeholder blob
    # size accounting for load-time modeling uses model_bytes explicitly:
    store._mem["models/distilbert"] = b"\0" * 1024
    return store


def run_monolithic(cs: CaseStudyConfig, batch_size: int,
                   injector: FaultInjector = NO_FAULTS) -> JobReport:
    store = _store(cs)
    job = make_job(cs, batch_size, "mono")
    chunks = decompose(job)
    lat = _latency(cs)

    def mk(i: int) -> ServerlessFunction:
        w = ServerlessFunction(i, store, lat, params_ref="", ram_mb=cs.ram_mb)
        w._cold_load = lambda: cs.model_bytes / (cs.store_read_mbps * 1e6)
        return w

    runner = MonolithicRunner(store, MonolithicConfig(), injector)
    return runner.run(job, chunks, mk)


def run_parallel(cs: CaseStudyConfig, batch_size: int,
                 injector: FaultInjector = NO_FAULTS,
                 orch_cfg: Optional[OrchestratorConfig] = None) -> JobReport:
    store = _store(cs)
    job = make_job(cs, batch_size, "par")
    chunks = decompose(job)
    lat = _latency(cs)

    def mk(i: int) -> ServerlessFunction:
        w = ServerlessFunction(i, store, lat, params_ref="", ram_mb=cs.ram_mb)
        # model the EFS model read on cold start explicitly:
        w._cold_load = lambda: cs.model_bytes / (cs.store_read_mbps * 1e6)
        return w

    if orch_cfg is None:
        conc = cs.parallel_concurrency or len(chunks)
        orch_cfg = OrchestratorConfig(max_concurrency=conc)
    orch = Orchestrator(store, orch_cfg, injector)
    return orch.run(job, chunks, mk)


def run_sweep(cs: CaseStudyConfig = CaseStudyConfig(),
              batch_sizes: List[int] = PAPER_BATCH_SIZES
              ) -> List[Dict]:
    rows = []
    for bs in batch_sizes:
        mono = run_monolithic(cs, bs)
        par = run_parallel(cs, bs)
        rows.append({
            "batch_size": bs,
            "mono_time_min": mono.wall_time_s / 60,
            "mono_cost_usd": mono.cost_usd,
            "mono_invocations": mono.n_invocations,
            "par_time_min": par.wall_time_s / 60,
            "par_cost_usd": par.cost_usd,
            "par_functions": par.n_invocations,
            "time_reduction_pct":
                100 * (1 - par.wall_time_s / mono.wall_time_s),
            "ram_mb": cs.ram_mb,
        })
    return rows
