"""Two clocks, one event core: the shared mechanics behind both routers.

Counterpart of ``repro.router.events``.

The synchronous-round ``Router`` (deterministic virtual-clock harness)
and the event-driven ``EventRouter`` (virtual event queue for parity
tests, real asyncio loop behind the HTTP front door) are thin loops
over ONE ``RouterCore``: arrivals → admission → replica rounds →
autoscaling → accounting all live here, parameterized only by a
``Clock``. Because every piece of float math the schedule depends on
(round durations, idle jumps, first-token offsets, estimator windows)
executes in core methods shared by both loops, the two paths produce
BIT-IDENTICAL token streams and metrics at the same seed — which is
what ``tests/test_torch_event_router.py``'s parity suite asserts, and what
makes the wall-clock serving path trustworthy without cloud hardware.

Pieces:

  * ``VirtualClock`` / ``WallClock`` — the clock source. Virtual time
    is advanced explicitly by the loop; wall time advances itself
    (``time.monotonic`` since construction) and ``advance_to`` is a
    no-op. A wall clock REQUIRES the measured time model (modeled /
    calibrated round constants on a real clock would let billed time
    and observed time silently disagree — construction raises).
  * ``EventQueue`` — a heap of ``(t, seq, kind, payload)``. ``seq`` is
    a monotone push counter, so events at equal ``t`` pop in push
    order: deterministic FIFO tie-break.
  * ``RouterCore`` — everything the old ``Router`` owned, minus the
    outer loop, plus the per-token event path: each replica round
    installs a ``_RoundLog`` as the batcher's ``on_token`` callback,
    and after the crash roll the collected events are committed —
    first tokens stamped at their PREFILL event time (mid-round, via
    ``metrics.record_first_token``, exactly once), every token handed
    to ``_emit_round`` for streaming. A crashed round's events are
    DISCARDED (rollback): nothing streamed, no stamps — matching
    ``Request.reset_for_retry``'s from-scratch semantics.

First-token event times within a round starting at ``t0``:

  * modeled/calibrated — admissions prefill serially before the round's
    single decode dispatch, so request *i*'s first token lands at
    ``t0 + per_item_s × prefill_token_factor × (prompt tokens prefilled
    through i)``; the flat ``round_overhead_s`` is attributed to the
    decode dispatch at the round boundary.
  * measured/wall — the host ``perf_counter`` offset of the actual
    callback, clamped into the round.

Decode tokens become visible at the round boundary (``t0 + round_s``)
under a virtual clock — they are committed by the one batched dispatch
the round ends with — and at their measured offsets on a wall clock.

Several ranks (one process a rank) run the same core over the same pool
and must take the same decisions. The modeled and calibrated clocks read
token counts only, which every rank has, also for a replica whose mesh
slice it is not in (``pool._Shadow``); the slices' tokens reach every
rank when the run ends (``ReplicaPool.share_streams``). The measured
clock reads a host clock: after each round the replica's source rank
(``ReplicaPool.round_source``: its slice's first rank, or rank 0 of a
shared mesh) broadcasts the round's seconds, each token's offset into
it and the tokens over the world group (:func:`_from_source`), which
makes every rank wait for that round: the slices then take turns.
Behind the HTTP front door rank 0 alone takes requests: it broadcasts one
tick a pass (the new submissions, the cancellations, the stop flag and
its clock reading, :class:`TickClock`) and every rank applies it before
the same control step and rounds (``frontdoor.EventRouter``).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import AWSPriceBook, TPUPriceBook
from repro_torch.router.metrics import (RouterReport, billing,
                                        record_first_token,
                                        request_latencies)
from repro_torch.router.policy import AutoscalePolicy, PoolSnapshot
from repro_torch.router.pool import ReplicaPool
from repro_torch.router.queue import ArrivalQueue, QueueConfig
from repro_torch.serving.batching import Request

_DEFAULT_PREFILL_FACTOR = 0.125
_DEFAULT_ROUND_OVERHEAD_S = 0.0

# EventQueue event kinds
ARRIVAL = "arrival"


class VirtualClock:
    """Deterministic simulated time: advances only when told to."""

    virtual = True

    def __init__(self, t: float = 0.0):
        self._t = t

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        if t < self._t - 1e-9:
            raise ValueError(f"virtual clock moved backwards: "
                             f"{self._t} -> {t}")
        self._t = max(self._t, t)


class WallClock:
    """Real time, in seconds since construction (monotonic). The event
    loop's serving clock: arrivals, first tokens, and billing all read
    the same origin, so TTFT/TPOT are MEASURED, not modeled."""

    virtual = False

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def advance_to(self, t: float) -> None:
        pass                      # wall time advances itself


class TickClock:
    """The wall clock of a router that several ranks run in step (the
    HTTP front door on a multi-rank mesh): rank 0 reads its own
    :class:`WallClock` (``wall``) once a pass and broadcasts the reading
    with the pass's tick (``frontdoor.EventRouter``); every rank, rank 0
    included, then runs the pass at that time (:meth:`tick`), so their
    decisions agree. Rank 0 stamps arrivals on ``wall``."""

    virtual = False

    def __init__(self):
        self.wall = WallClock()
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        pass                      # moved by the ticks only

    def tick(self, t: float) -> None:
        self._t = max(self._t, t)


class EventQueue:
    """Min-heap of timed events with a deterministic FIFO tie-break:
    pops come back ordered by ``(t, push order)``."""

    def __init__(self):
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._seq = 0

    def push(self, t: float, kind: str, payload: Any = None) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, payload))
        self._seq += 1

    def pop(self) -> Tuple[float, str, Any]:
        t, _, kind, payload = heapq.heappop(self._heap)
        return t, kind, payload

    def peek_t(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Round-time knobs. Two ways to drive the modeled clock:

      * hand-set — ``round_overhead_s``/``prefill_token_factor`` here
        plus ``LatencyModel.per_item_s`` on the pool (the serial
        token-work model; the ``0.0`` overhead default keeps busy
        seconds exactly work-conserving across policies);
      * calibrated — ``calibration=CalibratedLatencyModel`` carries all
        three constants, fitted from measured serving rows by
        ``router/calibrate.py``.

    Supplying BOTH raises ``ValueError`` here (hand-set round params)
    or in ``RouterCore`` (a pool ``per_item_s``): silent disagreement
    between a fitted artifact and hand-set numbers is exactly the bug
    calibration exists to remove.
    """

    prefill_token_factor: float = _DEFAULT_PREFILL_FACTOR
    round_overhead_s: float = _DEFAULT_ROUND_OVERHEAD_S
    rate_window_s: float = 4.0           # arrival/throughput estimators
    idle_step_s: float = 0.05            # clock floor when nothing runs
    max_rounds: int = 200_000
    calibration: Optional[Any] = None    # CalibratedLatencyModel

    def __post_init__(self):
        if self.calibration is None:
            return
        if (self.round_overhead_s != _DEFAULT_ROUND_OVERHEAD_S
                or self.prefill_token_factor != _DEFAULT_PREFILL_FACTOR):
            raise ValueError(
                "RouterConfig got BOTH a calibration artifact and "
                "hand-set round_overhead_s/prefill_token_factor — the "
                "calibration supplies those; drop the hand-set values "
                "or the calibration")


@dataclasses.dataclass
class _TokenEvent:
    """One committed token inside a round (from the batcher callback)."""

    req: Request
    tok: int
    prefill: bool            # True = this request's admission prefill
    host_t: float            # perf_counter at the commit
    cum_prefill_tokens: int  # prompt tokens prefilled through this event
    index: int               # the token's position in ``req.generated``


class _RoundLog:
    """Collects the batcher's per-token callbacks for ONE round.
    Installed as ``batcher.on_token`` around ``Replica.step`` and torn
    down after — the batcher never holds router state across rounds."""

    __slots__ = ("events", "host_t0", "_cum_ptok")

    def __init__(self):
        self.events: List[_TokenEvent] = []
        self.host_t0 = time.perf_counter()
        self._cum_ptok = 0

    def __call__(self, req: Request, tok: int, prefill: bool) -> None:
        if prefill:
            self._cum_ptok += len(req.prompt)
        self.events.append(_TokenEvent(req, tok, prefill,
                                       time.perf_counter(),
                                       self._cum_ptok,
                                       len(req.generated) - 1))


def _from_source(src: int, wall_s: float, log: _RoundLog) -> float:
    """The round's measured seconds as rank ``src`` read them, with its
    token events' offsets and tokens written into ``log`` (and into the
    requests' streams), on every rank: one broadcast over the world group
    (float64: seconds, offsets, tokens). Returns the seconds."""
    dist = torch.distributed
    n = len(log.events)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.zeros(1 + 2 * n, dtype=torch.float64, device=device)
    if dist.get_rank() == src:
        t[:] = torch.tensor(
            [wall_s] + [ev.host_t - log.host_t0 for ev in log.events]
            + [float(ev.tok) for ev in log.events], dtype=torch.float64)
    dist.broadcast(t, src=src)
    got = t.cpu().tolist()
    for i, ev in enumerate(log.events):
        ev.host_t = log.host_t0 + got[1 + i]
        ev.tok = int(got[1 + n + i])
        ev.req.generated[ev.index] = ev.tok
    return got[0]


class RouterCore:
    """Shared router mechanics (see module docstring). Loops:
    ``router.Router`` (synchronous rounds), ``frontdoor.EventRouter``
    (virtual event queue / asyncio wall-clock loop)."""

    def __init__(self, pool: ReplicaPool, policy: AutoscalePolicy,
                 traffic: Sequence[Request] = (),
                 queue_cfg: QueueConfig = QueueConfig(),
                 cfg: RouterConfig = RouterConfig(),
                 aws: AWSPriceBook = AWSPriceBook(),
                 tpu: TPUPriceBook = TPUPriceBook(),
                 traffic_name: str = "",
                 clock: Optional[Any] = None,
                 obs: Optional[Any] = None):
        self.pool = pool
        self.policy = policy
        self.queue = ArrivalQueue(queue_cfg)
        self.cfg = cfg
        self.aws = aws
        self.tpu = tpu
        self.traffic_name = traffic_name
        self._clock = clock if clock is not None else VirtualClock()
        # observability is OPT-IN and inert: obs=None (the default) skips
        # every hook; with an Observability attached the hooks only READ
        # state the round already computed — token streams and summaries
        # are bit-identical either way (tests/test_torch_event_router.py).
        self.obs = None
        self._n_rej_obs = 0            # terminal-outcome diff cursors
        self._n_exp_obs = 0
        self._prev_disp: dict = {}     # replica_id -> counter snapshot
        self._prev_compiles = self._compile_count()
        if obs is not None:
            self.attach_obs(obs)
        # resolve the round-time mode ONCE (see the module docstring):
        # calibrated > modeled (hand-set per_item_s) > measured.
        cal = cfg.calibration
        if cal is not None:
            if pool.lat.per_item_s is not None:
                raise ValueError(
                    "both RouterConfig.calibration and a hand-set "
                    "LatencyModel.per_item_s were supplied — the "
                    "calibration carries per_item_s; build the pool's "
                    "LatencyModel via calibration.to_latency_model()")
            self._overhead_s = cal.round_overhead_s
            self._per_item_s = cal.per_item_s
            self._prefill_factor = cal.prefill_token_factor
            self.time_model = "calibrated"
        else:
            self._overhead_s = cfg.round_overhead_s
            self._per_item_s = pool.lat.per_item_s
            self._prefill_factor = cfg.prefill_token_factor
            self.time_model = ("modeled" if pool.lat.per_item_s is not None
                               else "measured")
        if not self._clock.virtual and self.time_model != "measured":
            raise ValueError(
                "a wall-clock router measures time — modeled/calibrated "
                "round constants would let billed and observed time "
                "disagree; build the pool with "
                "LatencyModel(per_item_s=None) and drop the calibration")
        for r in traffic:           # hand-built tests may omit arrival_t
            if r.arrival_t is None:
                r.arrival_t = 0.0
        self._pending = deque(sorted(traffic, key=lambda r: r.arrival_t))
        self._req_tok_sum = sum(r.max_new_tokens
                                + len(r.prompt) * self._prefill_factor
                                for r in traffic)
        self._req_count = len(traffic)
        self.completed: List[Request] = []
        self.peak_replicas = 0
        self.n_cancelled = 0
        self._arrivals = deque()       # recent arrival times
        self._tok_events = deque()     # (t, n) recent token production
        self.events: List[dict] = []   # observability, orchestrator-style
        self._served: List[Tuple[Request, Any]] = []  # (request, replica)

    def attach_obs(self, obs: Any) -> Any:
        """Attach an ``Observability`` (registry + optional tracer) to
        this core and its pool. The HTTP front door calls this when the
        router was built without one, so ``GET /metrics`` always has a
        registry behind it."""
        self.obs = obs
        if getattr(self.pool, "obs", None) is None:
            self.pool.obs = obs
        return obs

    # -- the clock -------------------------------------------------------

    @property
    def clock(self) -> float:
        return self._clock.now()

    @clock.setter
    def clock(self, t: float) -> None:
        self._clock.advance_to(t)

    # -- observability --------------------------------------------------

    def _log(self, kind: str, **kw):
        self.events.append({"t": round(self.clock, 4), "kind": kind, **kw})

    def _compile_count(self) -> int:
        """Shape buckets the pool's engines have made (this rank's slice
        engines in mesh-slice mode)."""
        slices = getattr(self.pool, "slices", None)
        return (slices.compile_count() if slices is not None
                else self.pool.engine.compile_count)

    def _obs_sync(self) -> None:
        """Gauge refresh + terminal-outcome diff. Rejections and
        expiries land in the queue's append-only lists from several
        code paths (submit refusal, deadline pops, capacity rejections,
        crash requeues) — diffing those lists here is what keeps the
        ``repro_requests_total`` partition exactly equal to
        ``RouterReport``'s counts (the property-test law)."""
        obs = self.obs
        if obs is None:
            return
        q = self.queue
        while self._n_rej_obs < len(q.rejected):
            req = q.rejected[self._n_rej_obs]
            obs.m_requests.inc(outcome="rejected")
            obs.trace("reject", self.clock, rid=req.rid)
            self._n_rej_obs += 1
        while self._n_exp_obs < len(q.expired):
            req = q.expired[self._n_exp_obs]
            obs.m_requests.inc(outcome="expired")
            obs.trace("expire", self.clock, rid=req.rid)
            self._n_exp_obs += 1
        obs.m_queue_depth.set(q.depth)
        obs.m_clock_s.set(self.clock)
        obs.m_cost_usd.set(self._cost_so_far())
        counts: dict = {}
        for r in self.pool.replicas:
            counts[r.state] = counts.get(r.state, 0) + 1
        for state in ("starting", "ready", "draining", "dead", "retired"):
            obs.m_replicas.set(counts.get(state, 0), state=state)
        for r in self.pool.replicas:
            if r.state not in ("starting", "ready", "draining"):
                continue
            alloc = getattr(r.batcher, "allocator", None)
            if alloc is not None:
                obs.m_pages.set(alloc.n_free, state="free")
                obs.m_pages.set(alloc.n_live, state="live")
                break

    # -- estimators / snapshot ------------------------------------------

    @property
    def _avg_request_tokens(self) -> float:
        return self._req_tok_sum / max(self._req_count, 1)

    def _rate_rps(self) -> float:
        w = self.cfg.rate_window_s
        while self._arrivals and self._arrivals[0] < self.clock - w:
            self._arrivals.popleft()
        return len(self._arrivals) / w

    def _tokens_per_s(self) -> float:
        w = self.cfg.rate_window_s
        while self._tok_events and self._tok_events[0][0] < self.clock - w:
            self._tok_events.popleft()
        return sum(n for _, n in self._tok_events) / w

    def _cost_so_far(self) -> float:
        return billing(self.pool.busy_seconds(), len(self.completed),
                       ram_mb=self.pool.cfg.ram_mb,
                       chips_per_replica=self.pool.cfg.chips_per_replica,
                       aws=self.aws, tpu=self.tpu)["cost_usd"]

    def snapshot(self) -> PoolSnapshot:
        pool = self.pool
        live = pool.live()
        return PoolSnapshot(
            clock=self.clock,
            queue_depth=self.queue.depth,
            oldest_wait_s=self.queue.oldest_wait_s(self.clock),
            n_ready=sum(1 for r in live if r.state == "ready"),
            n_starting=sum(1 for r in live if r.state == "starting"),
            n_draining=sum(1 for r in live if r.state == "draining"),
            active_slots=sum(r.n_inflight for r in pool.ready()),
            slots_per_replica=pool.cfg.n_slots,
            arrival_rate_rps=self._rate_rps(),
            tokens_per_s=self._tokens_per_s(),
            avg_request_tokens=self._avg_request_tokens,
            cost_usd=self._cost_so_far(),
            slice_capacity=pool.capacity(),
        )

    # -- admission + control (shared by every loop) ---------------------

    def _admit_arrival(self, req: Request) -> None:
        """One request crosses the front door (from the pre-generated
        trace or a live ``submit``)."""
        self._arrivals.append(req.arrival_t)
        if not self.queue.submit(req, self.clock):
            self._log("reject", rid=req.rid)
        elif self.obs is not None:
            self.obs.trace("queued", req.arrival_t, rid=req.rid)

    def _control(self) -> None:
        """One control step: autoscale on the current snapshot, surface
        finished cold starts, dispatch queued requests into free slots."""
        pool, queue = self.pool, self.queue
        target = self.policy.target(self.snapshot())
        before = len(pool.live())
        pool.scale_to(target, self.clock)
        after = len(pool.live())
        if after != before:
            self._log("scale", target=target, live=after)
            if self.obs is not None:
                self.obs.m_scale_events.inc(
                    direction="up" if after > before else "down")
                self.obs.trace("scale", self.clock, target=target,
                               live=after)
        pool.poll_ready(self.clock)
        self.peak_replicas = max(self.peak_replicas, len(pool.live()))
        for r in pool.ready():
            while r.free_slots > 0:
                req = queue.pop(self.clock)
                if req is None:
                    break
                r.batcher.submit(req)
                if self.obs is not None:
                    self.obs.m_admitted.inc()
                    self.obs.trace("admitted", self.clock, rid=req.rid,
                                   replica=r.replica_id)
        self._obs_sync()

    # -- one replica round ----------------------------------------------

    def _round_seconds(self, wall_s: float, n_prefill_tokens: int,
                       n_active: int) -> float:
        if self._per_item_s is None:      # measured mode
            return self._overhead_s + wall_s
        return (self._overhead_s
                + self._per_item_s * (n_prefill_tokens
                                      * self._prefill_factor + n_active))

    def _event_offset(self, ev: _TokenEvent, log: _RoundLog,
                      round_s: float) -> float:
        """Seconds into the round at which ``ev`` became visible."""
        if self._per_item_s is None:      # measured / wall clock
            return min(max(ev.host_t - log.host_t0, 0.0), round_s)
        if not ev.prefill:                # decode: the round's one
            return round_s                # dispatch commits at the end
        return min(self._per_item_s * self._prefill_factor
                   * ev.cum_prefill_tokens, round_s)

    def _step_replica(self, r) -> float:
        """Run one round on replica ``r``; returns its virtual duration
        (post fault perturbation). Handles crash rollback + re-queue."""
        pre_inflight = r.inflight()
        n_prefill_tokens = sum(len(q.prompt) for q in r.sched.queue)
        pre_tokens = sum(len(q.generated) for q in pre_inflight)

        t0 = self.clock
        log = _RoundLog()
        r.batcher.on_token = log
        try:
            wall_s = r.step()
        finally:
            r.batcher.on_token = None
        src = (self.pool.round_source(r) if self._per_item_s is None
               else None)
        if src is not None:  # every rank takes the source rank's clock
            wall_s = _from_source(src, wall_s, log)

        round_s = self._round_seconds(wall_s, n_prefill_tokens,
                                      len(pre_inflight))
        round_s, crashed = self.pool.injector.perturb(
            r.replica_id, r.rounds, round_s, now=t0)
        r.busy_s += round_s            # crashed rounds are billed too
        done_now = r.drain_completed()

        obs = self.obs
        if obs is not None:
            obs.m_busy_s.inc(round_s)
            obs.m_round.observe(round_s)
            bucket_s = r.batcher.take_bucket_s()
            for b, s in bucket_s.items():
                if s > 0.0:
                    obs.m_bucket_s.inc(s, bucket=b)
            dd, sd = r.batcher.decode_dispatches, r.batcher.sampler_dispatches
            oe = r.batcher.on_token_errors
            pd, ps, po = self._prev_disp.get(r.replica_id, (0, 0, 0))
            obs.m_decode_dispatches.inc(dd - pd)
            obs.m_sampler_dispatches.inc(sd - ps)
            if oe > po:
                obs.m_on_token_errors.inc(oe - po)
            self._prev_disp[r.replica_id] = (dd, sd, oe)
            cc = self._compile_count()
            if cc > self._prev_compiles:
                obs.m_compile_misses.inc(cc - self._prev_compiles)
            self._prev_compiles = cc
            # the per-round trace event: measured wall buckets only ride
            # on a wall clock — a VirtualClock trace stays a pure
            # function of the seed (bit-deterministic), so it carries
            # modeled round_s and no host-measured numbers
            extra = ({"buckets": {b: round(s, 9)
                                  for b, s in bucket_s.items()}}
                     if not self._clock.virtual else {})
            obs.trace("round", t0, replica=r.replica_id,
                      round_s=round(round_s, 9), n_active=len(pre_inflight),
                      crashed=crashed, rids=[q.rid for q in pre_inflight],
                      **extra)

        # a request the replica's cache can never hold is rejected at
        # admission (the batcher keeps the round alive — see
        # ContinuousBatcher); count it with the queue's rejections. This
        # drains BEFORE the crash branch: a rejection stands even when
        # the round that made it crashes (retrying it would just reject
        # again — every replica shares the same cache capacity).
        rejected_now = r.batcher.take_rejected()
        for q in rejected_now:
            self.queue.rejected.append(q)
            self._log("reject", rid=q.rid, replica=r.replica_id,
                      reason="capacity")

        if crashed:
            # the round's work is lost: everything that was in flight
            # (or finished during the doomed round) restarts from scratch
            # — except requests already past their deadline, which the
            # queue counts as EXPIRED (once, not also retried), and
            # requests the round REJECTED, which stay rejected. The
            # round's token events are discarded with it: nothing is
            # streamed and no first-token stamps land (a request that
            # streamed a first token in an EARLIER round keeps its stamp
            # through reset_for_retry — the client saw it).
            lost = [q for q in pre_inflight
                    if not any(q is rj for rj in rejected_now)]
            self.pool.crash(r, t0 + round_s)
            n_req = self.queue.requeue(lost, t0 + round_s)
            self._log("crash", replica=r.replica_id, requeued=n_req,
                      expired=len(lost) - n_req)
            if obs is not None:
                obs.trace("replica_crash", t0 + round_s,
                          replica=r.replica_id, requeued=n_req,
                          expired=len(lost) - n_req)
            return round_s

        t_visible = t0 + round_s
        # first tokens are stamped at their PREFILL event (mid-round),
        # exactly once — not at the round boundary
        timed = []
        decode_rids: List[int] = []
        for ev in log.events:
            t_ev = t0 + self._event_offset(ev, log, round_s)
            if ev.prefill:
                stamped = record_first_token(ev.req, t_ev)
                if obs is not None:
                    obs.trace("prefill", t_ev, rid=ev.req.rid,
                              replica=r.replica_id)
                    if stamped:
                        obs.m_ttft.observe(t_ev - ev.req.arrival_t)
                        obs.trace("first_token", t_ev, rid=ev.req.rid)
            elif obs is not None and ev.req.rid not in decode_rids:
                decode_rids.append(ev.req.rid)
            timed.append((ev.req, ev.tok, t_ev, ev.prefill))
        produced = (sum(len(q.generated) for q in r.inflight())
                    + sum(len(q.generated) for q in done_now)
                    - pre_tokens)
        r.tokens_out += produced
        if produced:
            self._tok_events.append((t_visible, produced))
        for q in r.inflight() + done_now:
            if q.first_token_t is None and q.generated:
                # fallback for batchers driven without the callback
                if record_first_token(q, t_visible) and obs is not None:
                    obs.m_ttft.observe(t_visible - q.arrival_t)
                    obs.trace("first_token", t_visible, rid=q.rid)
        if obs is not None:
            if produced:
                obs.m_tokens.inc(produced)
            for rid in decode_rids:
                obs.trace("decode_round", t_visible, rid=rid,
                          replica=r.replica_id)
        for q in done_now:
            q.finish_t = t_visible
            self.completed.append(q)
            self._served.append((q, r))
            if obs is not None:
                obs.m_requests.inc(outcome="completed")
                obs.trace("finish", t_visible, rid=q.rid,
                          n_tokens=len(q.generated))
                if q.first_token_t is not None and len(q.generated) > 1:
                    obs.m_tpot.observe((t_visible - q.first_token_t)
                                       / (len(q.generated) - 1))
        self._emit_round(timed)
        return round_s

    def _emit_round(self, timed: List[Tuple[Request, int, float, bool]]
                    ) -> None:
        """Streaming hook: every token the round committed, with its
        event timestamp, in commit order. No-op here; the event-driven
        front door forwards them to per-request subscriber queues."""

    def _step_all(self) -> List[float]:
        """Step every replica that has work — draining replicas keep
        decoding until their last slot empties."""
        return [self._step_replica(r) for r in self.pool.live()
                if r.state in ("ready", "draining") and r.n_inflight > 0]

    def _drained(self) -> bool:
        """Queue empty and nothing in flight (the loops add their own
        pending-arrivals condition)."""
        return (self.queue.depth == 0
                and all(r.n_inflight == 0 for r in self.pool.live()))

    def _idle_advance(self, next_arrival_t: Optional[float]) -> None:
        """Nothing ran: jump the clock to the next event — an arrival
        or a cold start finishing — or tick by ``idle_step_s``."""
        horizon = [r.ready_t for r in self.pool.live()
                   if r.state == "starting"]
        if next_arrival_t is not None:
            horizon.append(next_arrival_t)
        self._clock.advance_to(
            max(self.clock + 1e-9,
                min(horizon) if horizon else self.clock
                + self.cfg.idle_step_s))

    # -- final accounting -----------------------------------------------

    def _report(self) -> RouterReport:
        self._obs_sync()     # terminal diffs through the final round
        share = getattr(self.pool, "share_streams", None)
        if share is not None:  # a mesh slice's tokens onto every rank
            share(self._served)
        lats = request_latencies(self.completed)
        n_sub = self.queue.n_submitted
        good = sum(
            1 for r in self.completed
            if r.deadline_s is None
            or (r.finish_t - r.arrival_t) <= r.deadline_s)
        busy = self.pool.busy_seconds()
        ready_s = sum(
            max((r.retire_t if r.retire_t is not None else self.clock)
                - r.ready_t, 0.0) for r in self.pool.replicas)
        bill = billing(busy, len(self.completed),
                       ram_mb=self.pool.cfg.ram_mb,
                       chips_per_replica=self.pool.cfg.chips_per_replica,
                       aws=self.aws, tpu=self.tpu)
        return RouterReport(
            policy=self.policy.name,
            traffic=self.traffic_name,
            wall_time_s=self.clock,
            n_submitted=n_sub,
            n_completed=len(self.completed),
            n_rejected=len(self.queue.rejected),
            n_expired=len(self.queue.expired),
            n_requeued=self.queue.n_requeued,
            n_crashes=self.pool.n_crashes,
            n_spawns=self.pool.n_spawns,
            peak_replicas=self.peak_replicas,
            tokens_out=self.pool.tokens_out(),
            ttft_s=lats["ttft"],
            tpot_s=lats["tpot"],
            goodput=good / max(n_sub, 1),
            utilization=busy / max(ready_s, 1e-12),
            busy_replica_s=busy,
            provisioned_replica_s=self.pool.provisioned_seconds(self.clock),
            time_model=self.time_model,
            n_slices=self.pool.capacity(),
            n_cancelled=self.n_cancelled,
            **bill,
        )
