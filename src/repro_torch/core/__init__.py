"""The paper's contribution: serverless-style parallel batch inference.

Counterpart of ``repro.core`` (all of it but the calibrated simulator).

Public API:
  decompose / merge            — monolithic -> parallel transformation
  Orchestrator                 — Step-Functions analogue (retries,
                                 speculation, elastic concurrency,
                                 exactly-once commits, resume)
  MonolithicRunner             — the paper's baseline (time-budget chaining)
  ServerlessFunction           — Lambda analogue over the serving engine
  ArtifactStore                — EFS analogue with IO accounting
  AWSPriceBook / TPUPriceBook  — Eq (1)/(2) + chip-seconds
"""
from repro_torch.core.cost_model import AWSPriceBook, TPUPriceBook, price_report  # noqa: F401
from repro_torch.core.decompose import coverage_ok, decompose, merge  # noqa: F401
from repro_torch.core.faults import NO_FAULTS, FaultInjector  # noqa: F401
from repro_torch.core.job import BatchJob, Chunk, InvokeOutcome, JobReport  # noqa: F401
from repro_torch.core.monolithic import MonolithicConfig, MonolithicRunner  # noqa: F401
from repro_torch.core.orchestrator import (ElasticPolicy, Orchestrator,  # noqa: F401
                                           OrchestratorConfig)
from repro_torch.core.store import ArtifactStore  # noqa: F401
from repro_torch.core.worker import LatencyModel, ServerlessFunction  # noqa: F401
