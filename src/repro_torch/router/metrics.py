"""Online-serving metrics: TTFT/TPOT/goodput/utilization and cost.

Counterpart of ``repro.router.metrics``.

All times are clock seconds — virtual under the deterministic harness,
real under the wall-clock event loop (see router/events.py):

  * TTFT — ``first_token_t - arrival_t``: queue wait + cold starts +
    prefill. The metric autoscaling policies move. Stamped by
    ``record_first_token`` at the FIRST-TOKEN EVENT (the prefill that
    produced it, mid-round), exactly once per request — never at the
    round boundary, and never re-stamped when a crash-requeued request
    re-earns its first token (the client already saw the original).
  * TPOT — ``(finish_t - first_token_t) / (n_tokens - 1)``: steady
    decode cadence; policy-insensitive unless replicas are overloaded.
  * goodput — completed-within-deadline / submitted. Rejected (queue
    cap) and expired (deadline passed in queue) requests count against
    it; with no deadlines it is simply the completion rate.
  * utilization — busy replica-seconds / ready replica-seconds: how
    much of the warm (post-cold-start) capacity actually did work.

Cost mirrors ``core.cost_model`` with serverless billing: busy
replica-seconds at the Lambda GB-second rate (Eq 1's compute term) +
per-request fees, and the TPU chip-second analogue. Cold starts and
idle warm time cost latency, not dollars — which is exactly why the
paper's "same cost, a fraction of the wall time" carries over to
autoscaling: total busy seconds are work-conserving across policies,
so scaling out moves TTFT, not the bill.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.cost_model import AWSPriceBook, TPUPriceBook
from repro_torch.serving.batching import Request


def percentile(xs: List[float], q: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


@dataclasses.dataclass
class RouterReport:
    """One (policy × traffic) router run, fully accounted."""

    policy: str
    traffic: str
    wall_time_s: float
    n_submitted: int
    n_completed: int
    n_rejected: int
    n_expired: int
    n_requeued: int
    n_crashes: int
    n_spawns: int
    peak_replicas: int
    tokens_out: int
    ttft_s: List[float]
    tpot_s: List[float]
    goodput: float
    utilization: float
    busy_replica_s: float
    provisioned_replica_s: float
    cost_usd: float
    tpu_cost_usd: float
    time_model: str = "modeled"     # measured | modeled | calibrated
    n_slices: Optional[int] = None  # mesh-slice pool capacity (None =
    #                                 shared-engine mode)
    n_cancelled: int = 0            # client disconnects (event loop)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / max(self.wall_time_s, 1e-12)

    @property
    def cost_per_1k_tokens(self) -> float:
        return self.cost_usd / max(self.tokens_out / 1000.0, 1e-12)

    def summary(self) -> Dict:
        return {
            "policy": self.policy,
            "traffic": self.traffic,
            "time_model": self.time_model,
            "n_slices": self.n_slices,
            "wall_time_s": round(self.wall_time_s, 4),
            "n_submitted": self.n_submitted,
            "n_completed": self.n_completed,
            "n_rejected": self.n_rejected,
            "n_expired": self.n_expired,
            "n_requeued": self.n_requeued,
            "n_cancelled": self.n_cancelled,
            "n_crashes": self.n_crashes,
            "n_spawns": self.n_spawns,
            "peak_replicas": self.peak_replicas,
            "tokens_out": self.tokens_out,
            "tokens_per_s": round(self.tokens_per_s, 2),
            "ttft_p50_s": round(percentile(self.ttft_s, 50), 4),
            "ttft_p95_s": round(percentile(self.ttft_s, 95), 4),
            "ttft_p99_s": round(percentile(self.ttft_s, 99), 4),
            "tpot_p50_s": round(percentile(self.tpot_s, 50), 4),
            "goodput": round(self.goodput, 4),
            "utilization": round(self.utilization, 4),
            "busy_replica_s": round(self.busy_replica_s, 4),
            "provisioned_replica_s": round(self.provisioned_replica_s, 4),
            "cost_usd": round(self.cost_usd, 8),
            "tpu_cost_usd": round(self.tpu_cost_usd, 8),
            "cost_per_1k_tokens": round(self.cost_per_1k_tokens, 8),
        }

    def derived(self) -> str:
        """Comma-free one-liner for the benchmark CSV derived column."""
        return (f"{self.tokens_per_s:.0f} tok/s"
                f" p50TTFT {percentile(self.ttft_s, 50) * 1e3:.0f}ms"
                f" p99TTFT {percentile(self.ttft_s, 99) * 1e3:.0f}ms"
                f" goodput {self.goodput:.2f}"
                f" peak {self.peak_replicas} replicas"
                f" ${self.cost_per_1k_tokens:.5f}/1k-tok")

    def format_line(self) -> str:
        """Human-readable row for ``launch.serve --router`` output."""
        return (f"{self.policy:<12} {self.traffic:<8}"
                f" done {self.n_completed}/{self.n_submitted}"
                f" | {self.tokens_per_s:7.0f} tok/s"
                f" | TTFT p50 {percentile(self.ttft_s, 50) * 1e3:6.0f}ms"
                f" p99 {percentile(self.ttft_s, 99) * 1e3:6.0f}ms"
                f" | TPOT p50 {percentile(self.tpot_s, 50) * 1e3:5.1f}ms"
                f" | goodput {self.goodput:.2f}"
                f" | util {self.utilization:.2f}"
                f" | peak {self.peak_replicas}"
                f" | ${self.cost_usd:.6f} (${self.cost_per_1k_tokens:.5f}"
                f"/1k-tok)")


def record_first_token(req: Request, t: float) -> bool:
    """Stamp TTFT at the first-token EVENT, exactly once.

    Returns True when this call recorded the stamp. False means the
    request already had one — a crash-requeued request keeps its
    original ``first_token_t`` through ``reset_for_retry`` (the client
    saw that token on the stream), so the re-serve's prefill event must
    NOT move it. Centralizing the stamp here is what keeps "exactly
    once" true across the sync-round and event loops.
    """
    if req.first_token_t is not None:
        return False
    req.first_token_t = t
    return True


def request_latencies(completed: List[Request]
                      ) -> Dict[str, List[float]]:
    """TTFT/TPOT samples from finished requests (router-stamped)."""
    ttft, tpot = [], []
    for r in completed:
        if r.arrival_t is None or r.first_token_t is None:
            continue
        ttft.append(r.first_token_t - r.arrival_t)
        if r.finish_t is not None and len(r.generated) > 1:
            tpot.append((r.finish_t - r.first_token_t)
                        / (len(r.generated) - 1))
    return {"ttft": ttft, "tpot": tpot}


def billing(busy_replica_s: float, n_completed: int, *,
            ram_mb: float = 848.0, chips_per_replica: int = 1,
            aws: AWSPriceBook = AWSPriceBook(),
            tpu: TPUPriceBook = TPUPriceBook()) -> Dict[str, float]:
    """Serverless bill: busy seconds at the RAM tier + one request fee
    per served request (Eq 1's shape), plus the TPU chip-second
    analogue. One aggregate ``compute_cost`` call — the ms billing
    quantum applies once, not per scheduling round."""
    return {
        "cost_usd": (aws.compute_cost(busy_replica_s, ram_mb)
                     + n_completed * aws.per_request),
        "tpu_cost_usd": tpu.cost(busy_replica_s * chips_per_replica),
    }
