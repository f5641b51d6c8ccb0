"""The synchronous-round router: the deterministic test/bench harness.

Counterpart of ``repro.router.router``.

Drives live traffic onto the batched serving stack with the same
discipline as ``core/orchestrator.py``: REAL inference on this host
(every scheduling round runs true prefill/decode through the shared
``Engine``), while the schedule itself — queue waits, cold starts,
concurrent replicas, crashes — is evaluated on a deterministic virtual
clock, so a 8-replica bursty scenario reproduces faithfully on one CPU.

All the mechanics live in ``router/events.py``'s ``RouterCore`` — the
"one event core" both this loop and the event-driven ``EventRouter``
(``router/frontdoor.py``) share, which is what makes the two paths
provably equivalent (the parity suite in tests/test_torch_event_router.py).
This class contributes only the synchronous-round loop:

Time model (one round = one ``ContinuousBatcher.step`` per replica):

  * measured (``LatencyModel.per_item_s is None``, no calibration) —
    the round's virtual duration is its measured host wall time;
  * modeled (``per_item_s`` set) — the duration is
    ``round_overhead_s + per_item_s × (prefill_tokens × prefill_token_factor
    + active_slots)``. Because every request contributes a fixed prompt
    and ``max_new_tokens`` commits no matter which replica serves it,
    TOTAL busy seconds are work-conserving across policies (with zero
    round overhead, exactly equal) — the online restatement of the
    paper's "same cost" claim; only TTFT moves.
  * calibrated (``RouterConfig.calibration`` set) — the same formula,
    but with all three constants FITTED from measured serving rows by
    ``router/calibrate.py`` instead of hand-set. The fitted
    ``round_overhead_s`` is nonzero on real hardware (a decode round is
    closer to flat-latency per dispatch), so busy seconds are only
    approximately work-conserving. Supplying a
    calibration AND hand-set round params (or a pool
    ``LatencyModel.per_item_s``) raises: the two would silently
    disagree.

Replicas within a round run concurrently: the clock advances by the
slowest stepped replica (synchronous rounds — the same simplification
the orchestrator's event loop makes per event).

Crash semantics: the fault injector rolls per (replica, round); a
crashed round's work is lost — its in-flight requests (including any
that "finished" during the doomed round) are reset and re-queued at the
queue front, the dead replica is billed to the crash point, and the
policy replaces it with a fresh cold start on the next round.

TTFT is stamped at the FIRST-TOKEN EVENT (the admission prefill that
produced it, mid-round), exactly once per request — see
``RouterCore._step_replica`` and ``metrics.record_first_token``.
"""
from __future__ import annotations

from repro_torch.router.events import (RouterConfig,  # noqa: F401  (re-export)
                                 RouterCore)
from repro_torch.router.metrics import RouterReport


class Router(RouterCore):
    """One policy × one traffic trace → a fully-accounted RouterReport,
    driven as synchronous rounds on the virtual clock."""

    def run(self) -> RouterReport:
        pool, cfg = self.pool, self.cfg
        rounds = 0
        while True:
            rounds += 1
            if rounds > cfg.max_rounds:
                raise RuntimeError(
                    f"router did not drain in {cfg.max_rounds} rounds")

            # 1. arrivals up to the current clock
            while (self._pending
                   and self._pending[0].arrival_t <= self.clock + 1e-12):
                self._admit_arrival(self._pending.popleft())

            # 2-3. autoscale, surface finished cold starts, dispatch
            self._control()

            # 4. step every replica that has work (concurrent replicas:
            #    the clock advances by the slowest round)
            durations = self._step_all()

            if durations:
                # advance to the round boundary BEFORE retiring drained
                # replicas: a replica finishing its last slot this round
                # was provisioned through the round, so its busy seconds
                # stay within its ready window (utilization <= 1)
                self._clock.advance_to(self.clock + max(durations))
                pool.retire_drained(self.clock)
                continue

            # 5. idle: jump to the next event (arrival or cold start)
            if not self._pending and self._drained():
                break
            self._idle_advance(self._pending[0].arrival_t
                               if self._pending else None)

        pool.retire_all(self.clock)
        return self._report()
