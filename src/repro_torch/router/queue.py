"""Arrival queue: admission control, priority classes, deadlines.

Counterpart of ``repro.router.queue``.

The front door of the online router. Requests arrive on the router's
clock (virtual trace or live ``EventRouter.submit``), get stamped with
``arrival_t``, and wait FIFO *within their priority class* until a
replica has a free decode slot — lower ``Request.priority`` numbers
dispatch first, and class 0 is the default, so single-class traffic
behaves exactly like the plain FIFO it used to be. Admission-control
levers:

  * ``max_depth`` — bounded queue: submissions past the cap are REJECTED
    immediately (the client sees a 429, not an unbounded wait).
  * deadlines — a request whose SLO has already expired by the time it
    would be dispatched is dropped as EXPIRED instead of burning replica
    time on an answer nobody is waiting for.

Expiry is EXACTLY-ONCE and terminal: an identity set guards every path
that can expire a request (``pop`` lazily, ``requeue`` at crash time),
so no interleaving of admit/crash/complete/expire events double-counts
one, and ``requeue`` never resurrects a request that already expired.

Crash re-queue (``requeue``) puts a dead replica's in-flight requests
back at the FRONT of their class — oldest work first, mirroring the
orchestrator's retry-before-new-work ordering — after
``Request.reset_for_retry()`` discards the lost tokens (the paper's
retry-from-scratch semantics).

``cancel`` removes a specific waiting request by identity (the event
loop's client-disconnect path); a request already dispatched to a
replica is cancelled there instead (``ContinuousBatcher.cancel``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional

from repro_torch.serving.batching import Request


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    max_depth: Optional[int] = None          # None -> unbounded
    default_deadline_s: Optional[float] = None  # applied when req has none
    drop_expired: bool = True                # expire on pop vs serve late


class ArrivalQueue:
    """Priority-class FIFO arrival queue with admission control (see
    module docstring).

    All mutation happens through ``submit`` / ``pop`` / ``requeue`` /
    ``cancel`` so the rejected/expired/requeued accounting the metrics
    layer reads is always consistent with what replicas actually served.
    """

    def __init__(self, cfg: QueueConfig = QueueConfig()):
        self.cfg = cfg
        self._q: Dict[int, Deque[Request]] = {}   # priority -> FIFO
        self.rejected: List[Request] = []
        self.expired: List[Request] = []
        self.n_submitted = 0
        self.n_requeued = 0
        self._expired_ids: set = set()   # id(req) — exactly-once guard

    # -- expiry (exactly-once, terminal) --------------------------------

    def _deadline_passed(self, req: Request, now: Optional[float]) -> bool:
        return (now is not None and self.cfg.drop_expired
                and req.deadline_s is not None
                and req.arrival_t is not None
                and now - req.arrival_t > req.deadline_s)

    def _expire(self, req: Request) -> bool:
        """Move ``req`` to the expired partition; False when it already
        expired once (no double count, whatever path re-sees it)."""
        if id(req) in self._expired_ids:
            return False
        self._expired_ids.add(id(req))
        self.expired.append(req)
        return True

    # -- admission / dispatch -------------------------------------------

    def submit(self, req: Request, now: float) -> bool:
        """Admit ``req`` at time ``now``; False = rejected (queue full)."""
        self.n_submitted += 1
        if req.arrival_t is None:
            req.arrival_t = now
        if req.deadline_s is None:
            req.deadline_s = self.cfg.default_deadline_s
        if (self.cfg.max_depth is not None
                and self.depth >= self.cfg.max_depth):
            self.rejected.append(req)
            return False
        self._class_of(req).append(req)
        return True

    def _class_of(self, req: Request) -> Deque[Request]:
        pri = req.priority
        if pri not in self._q:
            self._q[pri] = deque()
        return self._q[pri]

    def requeue(self, reqs: Iterable[Request],
                now: Optional[float] = None) -> int:
        """Crash re-queue at the FRONT of each request's class (in
        original order); returns the number actually requeued.

        When ``now`` (the crash time) is given and expiry applies, a
        request whose deadline has ALREADY passed in flight goes
        straight to ``expired`` — counted exactly ONCE, with no
        ``reset_for_retry`` and no ``n_requeued`` tick. Re-queuing it
        would only burn a front-of-queue slot before ``pop`` expired it
        anyway, while inflating the retry accounting the report reads.
        A request that expired EARLIER is never resurrected: it is
        skipped outright (and not re-counted)."""
        requeued = []
        for req in reqs:
            if id(req) in self._expired_ids:
                continue             # never resurrect an expired request
            if self._deadline_passed(req, now):
                self._expire(req)
                continue
            requeued.append(req)
        for req in reversed(requeued):
            req.reset_for_retry()
            self._class_of(req).appendleft(req)
        self.n_requeued += len(requeued)
        return len(requeued)

    def pop(self, now: float) -> Optional[Request]:
        """Next dispatchable request — lowest priority class first, FIFO
        within the class — dropping expired ones on the way."""
        for pri in sorted(self._q):
            dq = self._q[pri]
            while dq:
                req = dq.popleft()
                if self._deadline_passed(req, now):
                    self._expire(req)
                    continue
                return req
        return None

    def cancel(self, req: Request) -> bool:
        """Remove a waiting request by IDENTITY (client disconnect).
        Not counted as rejected/expired — the caller accounts it."""
        for dq in self._q.values():
            for i, q in enumerate(dq):
                if q is req:
                    del dq[i]
                    return True
        return False

    @property
    def depth(self) -> int:
        return sum(len(dq) for dq in self._q.values())

    def oldest_wait_s(self, now: float) -> float:
        fronts = [dq[0].arrival_t for dq in self._q.values()
                  if dq and dq[0].arrival_t is not None]
        if not fronts:
            return 0.0
        return now - min(fronts)
