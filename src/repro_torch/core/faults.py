"""Fault injection: crashes, stragglers, cold-start spikes.

Deterministic given the seed + (chunk_id, attempt) so tests are exactly
reproducible. The orchestrator consults the injector for every attempt;
the router consults it once per replica round with ``chunk_id`` =
replica id and ``attempt`` = round index.

Three independent crash sources, checked in this order:

1. **Round-keyed schedule** (``crash_rounds``): explicit
   ``(worker, round)`` pairs. The matching round is truncated at
   ``crash_at_frac`` of its duration, exactly like a probabilistic hit.
2. **Time-keyed schedule** (``crash_at_s``): explicit ``(worker, t)``
   pairs on the caller's clock. A kill fires during the first round of
   that worker whose window ``[now, now + duration)`` covers ``t`` —
   this is how spot preemption is expressed as a wall/virtual-time
   process (see router/cloud.py). Requires the caller to pass ``now=``;
   entries fire at most once. The round is truncated at ``t - now``, so
   a time-keyed kill placed at ``now + crash_at_frac * duration`` is
   indistinguishable from a round-keyed kill of the same round (pinned
   by tests/test_batch_dag.py).
3. **Probabilistic** (``crash_prob``): rng keyed by
   ``(seed, worker, attempt)`` as before.

``max_crashes`` budgets only the probabilistic source — explicit
schedules are explicit intent. All sources count into ``n_crashes``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FaultInjector:
    seed: int = 0
    crash_prob: float = 0.0           # per-attempt crash probability
    crash_at_frac: float = 0.5        # crash happens this far into the run
    straggler_prob: float = 0.0       # per-attempt probability
    straggler_factor: float = 5.0     # duration multiplier when straggling
    max_crashes: Optional[int] = None  # stop PROBABILISTIC kills after N
    crash_rounds: Tuple[Tuple[int, int], ...] = ()   # (worker, round)
    crash_at_s: Tuple[Tuple[int, float], ...] = ()   # (worker, clock t)

    def __post_init__(self):
        self._crashes = 0
        self._round_kills = set(self.crash_rounds)
        # per-worker sorted kill times; consumed (popped) once fired so
        # a retry round re-covering the same window doesn't die twice
        self._time_kills = {}
        for worker, t in sorted(self.crash_at_s, key=lambda wt: wt[1]):
            self._time_kills.setdefault(worker, []).append(float(t))

    @property
    def n_crashes(self) -> int:
        return self._crashes

    def _rng(self, chunk_id: int, attempt: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + chunk_id * 101 + attempt) % 2**63)

    def perturb(self, chunk_id: int, attempt: int, duration_s: float,
                now: Optional[float] = None) -> Tuple[float, bool]:
        """Returns (possibly inflated/truncated duration, crashed).

        ``now`` is the clock at the start of the attempt; without it the
        time-keyed schedule cannot fire (round/probabilistic sources are
        unaffected, so pre-existing callers keep their behavior).
        """
        rng = self._rng(chunk_id, attempt)
        if self.straggler_prob and rng.random() < self.straggler_prob:
            duration_s *= self.straggler_factor
        if (chunk_id, attempt) in self._round_kills:
            self._round_kills.discard((chunk_id, attempt))
            self._crashes += 1
            return duration_s * self.crash_at_frac, True
        if now is not None:
            pending = self._time_kills.get(chunk_id)
            if pending and now <= pending[0] < now + duration_s:
                t_kill = pending.pop(0)
                self._crashes += 1
                return max(t_kill - now, 0.0), True
        if (self.crash_prob and rng.random() < self.crash_prob
                and (self.max_crashes is None
                     or self._crashes < self.max_crashes)):
            self._crashes += 1
            return duration_s * self.crash_at_frac, True
        return duration_s, False


NO_FAULTS = FaultInjector()
