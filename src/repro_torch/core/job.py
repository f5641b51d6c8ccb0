"""Job/chunk/result datatypes for serverless-style batch inference."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from repro_torch.data.pipeline import DatasetRef


@dataclasses.dataclass(frozen=True)
class BatchJob:
    """A batch-inference job over a dataset stored in the artifact store.

    ``batch_size`` is the paper's central knob: items per function
    invocation. Monolithic processing = one function consuming all batches
    sequentially; parallel = one function per batch.
    """

    job_id: str
    dataset: DatasetRef
    model_ref: str
    batch_size: int
    ram_mb: int = 848  # paper: both modes use 830-850 MB


@dataclasses.dataclass(frozen=True)
class Chunk:
    chunk_id: int
    start: int
    end: int

    @property
    def n_items(self) -> int:
        return self.end - self.start


@dataclasses.dataclass
class InvokeOutcome:
    """What one function invocation reports back to the orchestrator."""

    duration_s: float
    payload: Any = None
    crashed: bool = False
    cold_start: bool = False
    max_ram_mb: float = 848.0
    compute_s: float = 0.0   # pure inference time (no start/load overhead)
    load_s: float = 0.0      # store read (EFS analogue) time


@dataclasses.dataclass
class TaskRecord:
    """One scheduled attempt of one chunk (including speculative copies)."""

    chunk: Chunk
    attempt: int
    worker_id: int
    start_time: float
    finish_time: float
    outcome: InvokeOutcome
    speculative: bool = False
    cancelled: bool = False
    billed_s: float = 0.0

    @property
    def duration_s(self) -> float:
        return self.finish_time - self.start_time


@dataclasses.dataclass
class JobReport:
    mode: str
    job: BatchJob
    wall_time_s: float
    total_billed_s: float
    n_invocations: int
    n_requests: int
    n_transitions: int
    n_retries: int
    n_speculative: int
    n_crashes: int
    max_ram_mb: float
    cost_usd: float = 0.0
    tpu_cost_usd: float = 0.0
    tasks: List[TaskRecord] = dataclasses.field(default_factory=list)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def summary(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "batch_size": self.job.batch_size,
            "wall_time_min": self.wall_time_s / 60.0,
            "cost_usd": self.cost_usd,
            "n_invocations": self.n_invocations,
            "n_retries": self.n_retries,
            "n_speculative": self.n_speculative,
            "n_crashes": self.n_crashes,
            "total_billed_s": self.total_billed_s,
            "max_ram_mb": self.max_ram_mb,
        }
