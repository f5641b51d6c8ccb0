"""Pluggable autoscaling policies: queue depth, token throughput, cost cap.

Counterpart of ``repro.router.policy``, price-book arithmetic kept as
the reference has it.

Every policy maps a ``PoolSnapshot`` (what the router observes each
scheduling round) to a TARGET number of serving replicas; the pool's
``scale_to`` handles the mechanics (cold starts, draining, reinstating).
Policies are pure functions of the snapshot — deterministic, unit-
testable without an engine.

The cost-capped policy closes the loop with the paper's cost model: it
wraps any inner policy and refuses to provision capacity the budget
can't pay for over its lookahead window, priced via ``AWSPriceBook``
(GB-seconds at the replica's RAM tier) or the TPU chip-second analogue.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.core.cost_model import AWSPriceBook, TPUPriceBook


@dataclasses.dataclass(frozen=True)
class PoolSnapshot:
    """What a policy sees each round (assembled by the router)."""

    clock: float
    queue_depth: int
    oldest_wait_s: float
    n_ready: int
    n_starting: int
    n_draining: int
    active_slots: int          # occupied slots across ready replicas
    slots_per_replica: int
    arrival_rate_rps: float    # windowed estimate
    tokens_per_s: float        # windowed output throughput
    avg_request_tokens: float  # mean decode tokens per request
    cost_usd: float            # accrued spend so far
    slice_capacity: Optional[int] = None  # mesh-slice pool: max replicas
    #                                       (None = shared-engine mode,
    #                                        unbounded)


@dataclasses.dataclass
class AutoscalePolicy:
    """Base: clamps every decision into [min_replicas, max_replicas]."""

    min_replicas: int = 1
    max_replicas: int = 8
    name: str = "base"

    def target(self, s: PoolSnapshot) -> int:
        n = self.clamp(self.want(s))
        if s.slice_capacity is not None:
            # a mesh-sliced pool cannot serve more replicas than it has
            # disjoint slices — wanting more would just spin spawn/deny
            n = min(n, s.slice_capacity)
        return n

    def want(self, s: PoolSnapshot) -> int:
        raise NotImplementedError

    def clamp(self, n: int) -> int:
        return max(self.min_replicas, min(self.max_replicas, n))


@dataclasses.dataclass
class FixedReplicas(AutoscalePolicy):
    """The provisioned baseline: never scales. ``fixed-1`` is the
    single-replica strawman the router benchmarks beat on p99 TTFT."""

    n: int = 1

    def __post_init__(self):
        self.name = f"fixed-{self.n}"

    def want(self, s: PoolSnapshot) -> int:
        return self.n


@dataclasses.dataclass
class QueueDepthPolicy(AutoscalePolicy):
    """Provision slots for the work that is HERE: queued + running
    requests, divided by slots per replica. Reacts within one round of
    a burst landing; scales back as the queue drains."""

    name: str = "queue-depth"

    def want(self, s: PoolSnapshot) -> int:
        demand = s.queue_depth + s.active_slots
        return math.ceil(demand / max(s.slots_per_replica, 1))


@dataclasses.dataclass
class ThroughputPolicy(AutoscalePolicy):
    """Provision for the OFFERED token rate: arrival rate × tokens per
    request vs one replica's token throughput. Smoother than queue
    depth (no reaction to a single burst round) but lags rate changes
    by the estimation window — the classic rate-vs-backlog trade."""

    tokens_per_s_per_replica: float = 100.0
    name: str = "throughput"

    def want(self, s: PoolSnapshot) -> int:
        demand_tok_s = s.arrival_rate_rps * s.avg_request_tokens
        return math.ceil(demand_tok_s / self.tokens_per_s_per_replica)


@dataclasses.dataclass
class CostCapPolicy(AutoscalePolicy):
    """Budget governor around any inner policy: caps the target at what
    the remaining budget can afford for ``window_s`` more seconds of
    fully-busy replicas. Degrades toward ``min_replicas`` as spend
    approaches ``budget_usd`` — latency is sacrificed, never the cap."""

    inner: AutoscalePolicy = dataclasses.field(
        default_factory=QueueDepthPolicy)
    budget_usd: float = 1.0
    price_per_replica_s: float = 1.35e-5   # 848 MB Lambda, per busy second
    window_s: float = 30.0
    name: str = "cost-cap"

    def want(self, s: PoolSnapshot) -> int:
        want = self.inner.target(s)
        remaining = self.budget_usd - s.cost_usd
        affordable = int(remaining
                         / max(self.price_per_replica_s * self.window_s,
                               1e-12))
        return min(want, max(affordable, self.min_replicas))


def aws_replica_price_s(book: AWSPriceBook = AWSPriceBook(),
                        ram_mb: float = 848.0) -> float:
    """USD per fully-busy replica-second at the Lambda RAM tier."""
    return book.gb_second * ram_mb / 1024.0


def tpu_replica_price_s(book: TPUPriceBook = TPUPriceBook(),
                        chips: int = 1) -> float:
    """USD per replica-second for the TPU chip-second analogue."""
    return book.chip_hour * chips / 3600.0


def default_policies(*, slots_per_replica: int = 4, max_replicas: int = 8,
                     tokens_per_s_per_replica: float = 100.0,
                     budget_usd: float = 1.0, ram_mb: float = 848.0,
                     book: AWSPriceBook = AWSPriceBook()
                     ) -> List[AutoscalePolicy]:
    """The comparison set serve --router and router_bench run."""
    return [
        FixedReplicas(n=1, max_replicas=max_replicas),
        QueueDepthPolicy(max_replicas=max_replicas),
        ThroughputPolicy(
            max_replicas=max_replicas,
            tokens_per_s_per_replica=tokens_per_s_per_replica),
        CostCapPolicy(
            inner=QueueDepthPolicy(max_replicas=max_replicas),
            budget_usd=budget_usd,
            price_per_replica_s=aws_replica_price_s(book, ram_mb),
            max_replicas=max_replicas),
    ]
