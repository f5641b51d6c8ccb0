"""Cost models: the paper's AWS equations (1)-(2) + a TPU analogue.

AWS price book (us-east-1, x86, the era of the paper's experiments):
  * Lambda compute: $0.0000166667 per GB-second, billed per 1 ms,
    RAM billed at the *allocated* tier.
  * Lambda requests: $0.20 per 1M invocations.
  * Step Functions (standard): $0.025 per 1k state transitions.

Eq (1):  cost_parallel  = Σ_i duration_i × price(RAM_i) + SF transitions
Eq (2):  cost_monolithic = duration_ms × price-per-1ms-at-RAM   (per chained
         invocation; the chain sum is the job cost)

TPU analogue: chip-seconds × $/chip-hour. The paper's "cost ≈ constant
under decomposition" claim becomes chip-second conservation — see
EXPERIMENTS.md §Fig2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List

from repro_torch.core.job import JobReport, TaskRecord


@dataclasses.dataclass(frozen=True)
class AWSPriceBook:
    gb_second: float = 0.0000166667
    per_request: float = 0.0000002
    per_transition: float = 0.000025
    transitions_per_task: int = 2     # Map-state enter/exit per invocation
    base_transitions: int = 5         # state-machine start/stop overhead
    billing_quantum_ms: float = 1.0

    def billed_seconds(self, duration_s: float) -> float:
        q = self.billing_quantum_ms / 1000.0
        return math.ceil(max(duration_s, 0.0) / q) * q

    def compute_cost(self, duration_s: float, ram_mb: float) -> float:
        return self.billed_seconds(duration_s) * (ram_mb / 1024.0) \
            * self.gb_second

    # -- Eq (2) ----------------------------------------------------------
    def cost_monolithic(self, invocation_durations_s: Iterable[float],
                        ram_mb: float) -> float:
        durs = list(invocation_durations_s)
        return sum(self.compute_cost(d, ram_mb) for d in durs) \
            + len(durs) * self.per_request

    # -- Eq (1) ----------------------------------------------------------
    def cost_parallel(self, tasks: List[TaskRecord], ram_mb: float) -> float:
        compute = sum(self.compute_cost(t.billed_s, ram_mb) for t in tasks)
        n = len(tasks)
        step_fn = (self.base_transitions
                   + self.transitions_per_task * n) * self.per_transition
        return compute + n * self.per_request + step_fn


@dataclasses.dataclass(frozen=True)
class TPUPriceBook:
    """v5e on-demand-ish pricing for the pod-scale cost accounting."""

    chip_hour: float = 1.20

    def cost(self, chip_seconds: float) -> float:
        return chip_seconds * self.chip_hour / 3600.0


def price_report(report: JobReport, aws: AWSPriceBook = AWSPriceBook(),
                 tpu: TPUPriceBook = TPUPriceBook(),
                 n_chips: int = 0) -> JobReport:
    """Fill in cost fields of a JobReport in place (returns it)."""
    ram = report.max_ram_mb
    if report.mode == "monolithic":
        durs = [t.billed_s for t in report.tasks]
        report.cost_usd = aws.cost_monolithic(durs, ram)
    else:
        report.cost_usd = aws.cost_parallel(report.tasks, ram)
    if n_chips:
        report.tpu_cost_usd = tpu.cost(report.wall_time_s * n_chips)
    return report
