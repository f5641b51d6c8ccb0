"""Online request router: serverless elasticity over the serving stack.

Counterpart of ``repro.router``, with the same exports but
``SlicePool``. The layer that puts LIVE traffic on the batched engine:
an arrival queue with admission control and priority classes, a replica
pool (each replica = one ``ContinuousBatcher(batched=True)``, dense or
block-paged, over one shared ``Engine``) with cold starts and
fault-injected crashes, pluggable autoscaling policies,
TTFT/TPOT/goodput/cost metrics, and a measured round-time calibration
(``calibrate.py``). Two loops share one event core (``events.py``):
the synchronous-round virtual-clock ``Router`` (deterministic harness)
and the event-driven ``EventRouter`` + ``HttpFrontDoor``
(``frontdoor.py`` — live asyncio serving with streamed tokens).
"""
from repro_torch.router.calibrate import (  # noqa: F401
    CalibratedLatencyModel, RoundSample, fit_round_model,
    measure_round_samples, samples_from_bench)
from repro_torch.router.cloud import (  # noqa: F401
    ON_DEMAND, CloudProfile, spot_profile)
from repro_torch.router.events import (  # noqa: F401
    EventQueue, RouterCore, VirtualClock, WallClock)
from repro_torch.router.frontdoor import (  # noqa: F401
    EventRouter, HttpFrontDoor)
from repro_torch.router.metrics import (  # noqa: F401
    RouterReport, billing, percentile, request_latencies)
from repro_torch.router.policy import (  # noqa: F401
    AutoscalePolicy, CostCapPolicy, FixedReplicas, PoolSnapshot,
    QueueDepthPolicy, ThroughputPolicy, aws_replica_price_s,
    default_policies, tpu_replica_price_s)
from repro_torch.router.pool import (  # noqa: F401
    Replica, ReplicaConfig, ReplicaPool)
from repro_torch.router.queue import ArrivalQueue, QueueConfig  # noqa: F401
from repro_torch.router.router import Router, RouterConfig  # noqa: F401
from repro_torch.router.traffic import (  # noqa: F401
    TRAFFIC, bursty_arrivals, diurnal_arrivals, make_requests,
    poisson_arrivals)
