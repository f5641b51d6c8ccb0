"""Cloud profiles: price book + cold-start distribution + preemption.

Counterpart of ``repro.router.cloud``.

One ``CloudProfile`` describes the market a replica pool is bought from
— the missing ingredient between ``AWSPriceBook`` (what a busy second
costs), ``LatencyModel`` (how long a cold start takes), and
``FaultInjector`` (when a worker dies). A *spot* profile discounts the
busy-second price and carries a preemption process: a deterministic
per-worker Poisson kill-time sampler whose draws become time-keyed
``FaultInjector.crash_at_s`` entries, so spot kills land mid-round on
the same virtual/wall clock every other event uses.

Everything is a pure function of ``seed`` + worker index, so a chaos
run replays bit-identically (the batch DAG parity tests depend on it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.cost_model import AWSPriceBook
from repro_torch.core.faults import FaultInjector
from repro_torch.router.policy import aws_replica_price_s

ON_DEMAND_KIND = "on_demand"
SPOT_KIND = "spot"


@dataclasses.dataclass(frozen=True)
class CloudProfile:
    """One market to buy replicas from.

    ``price_multiplier`` scales the on-demand busy-second price from
    the book (spot ≈ 0.3× is the classic AWS discount);
    ``preempt_rate_per_s`` is the per-worker Poisson kill rate (0 =
    never preempted — the on-demand contract); cold starts are
    ``cold_start_s`` + a deterministic per-spawn jitter in
    ``[0, cold_start_jitter_s)``.
    """

    name: str = "on-demand"
    kind: str = ON_DEMAND_KIND
    price_multiplier: float = 1.0
    cold_start_s: float = 0.5
    cold_start_jitter_s: float = 0.0
    preempt_rate_per_s: float = 0.0
    seed: int = 0
    book: AWSPriceBook = dataclasses.field(default_factory=AWSPriceBook)

    def __post_init__(self):
        if self.kind not in (ON_DEMAND_KIND, SPOT_KIND):
            raise ValueError(f"unknown cloud kind {self.kind!r}")
        if self.kind == ON_DEMAND_KIND and self.preempt_rate_per_s:
            raise ValueError("on-demand pools are never preempted; "
                             "use kind='spot' for a kill process")

    # -- price ---------------------------------------------------------

    def price_per_replica_s(self, ram_mb: float = 848.0) -> float:
        """USD per fully-busy replica-second in THIS market."""
        return aws_replica_price_s(self.book, ram_mb) * self.price_multiplier

    # -- cold-start distribution --------------------------------------

    def cold_start(self, spawn_idx: int) -> float:
        """Cold start for the pool's ``spawn_idx``-th spawn (runtime
        init only — the pool adds the model-fetch store read on top)."""
        if self.cold_start_jitter_s <= 0.0:
            return self.cold_start_s
        rng = np.random.default_rng(
            (self.seed * 7_368_787 + spawn_idx * 131 + 17) % 2**63)
        return self.cold_start_s + self.cold_start_jitter_s * rng.random()

    # -- preemption process -------------------------------------------

    def kill_times(self, worker_id: int, horizon_s: float
                   ) -> List[float]:
        """Deterministic Poisson kill times for one worker in
        ``[0, horizon_s)`` — exponential inter-arrival gaps at
        ``preempt_rate_per_s``, keyed by (seed, worker_id)."""
        if self.preempt_rate_per_s <= 0.0 or horizon_s <= 0.0:
            return []
        rng = np.random.default_rng(
            (self.seed * 9_576_890_767 + worker_id * 1_299_709 + 7) % 2**63)
        times, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / self.preempt_rate_per_s)
            if t >= horizon_s:
                return times
            times.append(t)

    def preemption_schedule(self, n_workers: int, horizon_s: float
                            ) -> Tuple[Tuple[int, float], ...]:
        """The whole pool's kill schedule as ``crash_at_s`` entries.

        ``n_workers`` should over-provision for churn: a replacement
        replica gets the next id from the pool, and ids beyond the
        sampled range would be un-killable."""
        sched = []
        for w in range(n_workers):
            sched.extend((w, t) for t in self.kill_times(w, horizon_s))
        return tuple(sched)

    def injector(self, n_workers: int, horizon_s: float,
                 extra_kills: Tuple[Tuple[int, float], ...] = ()
                 ) -> FaultInjector:
        """A ``FaultInjector`` carrying this profile's spot kills (plus
        any explicit ``extra_kills`` a chaos harness schedules)."""
        return FaultInjector(
            seed=self.seed,
            crash_at_s=self.preemption_schedule(n_workers, horizon_s)
            + tuple(extra_kills))


# The two standard markets the batch runner/bench compose. Spot: 70%
# discount (the classic Lambda/EC2 spot spread), slower + noisier cold
# starts, and a kill process the caller sizes via preempt_rate_per_s.
ON_DEMAND = CloudProfile(name="on-demand", kind=ON_DEMAND_KIND)


def spot_profile(preempt_rate_per_s: float = 0.0, seed: int = 0,
                 price_multiplier: float = 0.3) -> CloudProfile:
    """A spot market: discounted, preemptible, jittery cold starts."""
    return CloudProfile(name="spot", kind=SPOT_KIND,
                        price_multiplier=price_multiplier,
                        cold_start_s=0.7, cold_start_jitter_s=0.2,
                        preempt_rate_per_s=preempt_rate_per_s, seed=seed)
