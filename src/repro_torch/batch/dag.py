"""The batch-inference task DAG: specs, states, and the scheduler.

Counterpart of ``repro.batch.dag``, copied whole: it is pure Python with
no clock, engine or device.

A ``TaskDag`` is a small explicit-dependency graph — for the paper's
case study: shard the dataset, prefill each shard, decode each shard,
reduce the outputs. The scheduler here is deliberately tiny and pure
(no clocks, no replicas, no I/O): it validates the graph, tracks each
task through the state machine below, and answers "what is ready
now?". Execution lives in runner.py; the split is what lets hypothesis
drive the scheduler through random ready-set pops and preemption
interleavings (tests/test_property_invariants.py) without touching an
engine.

State machine::

    PENDING ──deps done──▶ READY ──start──▶ RUNNING ──complete──▶ DONE
                             ▲                  │
                             └──retry_at due────┤ preempt
                                                ▼
                                            PREEMPTED (retrying)

Invariants the tests pin:
- the five states partition the task set at every step (conservation);
- ``start`` refuses a task whose deps aren't all DONE (topological
  execution under ANY ready-set pop order);
- ``complete`` is idempotent-hostile: completing a task twice raises —
  exactly-once effects are the runner's job (ArtifactStore first-writer
  -wins commits), the scheduler's job is to make a double-complete loud.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

PENDING = "pending"
READY = "ready"
RUNNING = "running"
DONE = "done"
PREEMPTED = "preempted"          # retrying: waits out retry_at
STATES = (PENDING, READY, RUNNING, DONE, PREEMPTED)

# The canonical inference pipeline's stage names (runner.py executes
# them; anything else in a TaskSpec.stage is rejected there, not here —
# the scheduler is workload-agnostic).
SHARD, PREFILL, DECODE, REDUCE = "shard", "prefill", "decode", "reduce"


@dataclasses.dataclass
class TaskSpec:
    """One node: immutable identity + payload, mutable runtime state."""

    task_id: str
    stage: str
    deps: Tuple[str, ...] = ()
    payload: Any = None
    # -- runtime state (owned by TaskDag) --
    state: str = PENDING
    attempts: int = 0            # times started (1 + preemptions survived)
    preemptions: int = 0
    retry_at: float = 0.0        # earliest restart time after a preempt
    worker: Optional[Tuple[int, int]] = None   # (group, replica) placed on
    started_t: Optional[float] = None
    finished_t: Optional[float] = None


class TaskDag:
    """Validated DAG + state tracking. Raises ``ValueError`` on
    duplicate ids, unknown deps, or cycles — at construction, loudly."""

    def __init__(self, tasks: List[TaskSpec],
                 retry_backoff_s: float = 0.05):
        self.tasks: Dict[str, TaskSpec] = {}
        for t in tasks:
            if t.task_id in self.tasks:
                raise ValueError(f"duplicate task id {t.task_id!r}")
            self.tasks[t.task_id] = t
        for t in tasks:
            for d in t.deps:
                if d not in self.tasks:
                    raise ValueError(
                        f"task {t.task_id!r} depends on unknown {d!r}")
        self._check_acyclic()
        self.retry_backoff_s = retry_backoff_s
        self.order = [t.task_id for t in tasks]   # deterministic listing

    def _check_acyclic(self):
        """Kahn's algorithm; leftovers = a cycle."""
        indeg = {tid: len(t.deps) for tid, t in self.tasks.items()}
        out: Dict[str, List[str]] = {tid: [] for tid in self.tasks}
        for t in self.tasks.values():
            for d in t.deps:
                out[d].append(t.task_id)
        frontier = [tid for tid, n in indeg.items() if n == 0]
        seen = 0
        while frontier:
            tid = frontier.pop()
            seen += 1
            for nxt in out[tid]:
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    frontier.append(nxt)
        if seen != len(self.tasks):
            cyc = sorted(tid for tid, n in indeg.items() if n > 0)
            raise ValueError(f"dependency cycle through {cyc}")

    # -- queries -------------------------------------------------------

    def __len__(self) -> int:
        return len(self.tasks)

    def counts(self) -> Dict[str, int]:
        """Tasks per state — MUST sum to ``len(self)`` (partition law)."""
        c = {s: 0 for s in STATES}
        for t in self.tasks.values():
            c[t.state] += 1
        return c

    @property
    def all_done(self) -> bool:
        return all(t.state == DONE for t in self.tasks.values())

    def _deps_done(self, t: TaskSpec) -> bool:
        return all(self.tasks[d].state == DONE for d in t.deps)

    def refresh(self, now: float) -> None:
        """Promote PENDING→READY (deps done) and PREEMPTED→READY
        (backoff elapsed). Deterministic: insertion order."""
        for tid in self.order:
            t = self.tasks[tid]
            if t.state == PENDING and self._deps_done(t):
                t.state = READY
            elif t.state == PREEMPTED and now + 1e-12 >= t.retry_at:
                t.state = READY

    def ready(self, now: float) -> List[TaskSpec]:
        self.refresh(now)
        return [self.tasks[tid] for tid in self.order
                if self.tasks[tid].state == READY]

    def next_retry_t(self) -> Optional[float]:
        """Earliest backoff expiry among PREEMPTED tasks (idle-advance
        target for the runner's clock)."""
        ts = [t.retry_at for t in self.tasks.values()
              if t.state == PREEMPTED]
        return min(ts) if ts else None

    # -- transitions ---------------------------------------------------

    def start(self, task_id: str, now: float,
              worker: Optional[Tuple[int, int]] = None) -> TaskSpec:
        t = self.tasks[task_id]
        if t.state != READY:
            raise ValueError(f"start({task_id!r}): state {t.state}, "
                             "not ready")
        if not self._deps_done(t):      # belt over the READY braces:
            raise ValueError(           # topological order is a LAW
                f"start({task_id!r}): unfinished deps "
                f"{[d for d in t.deps if self.tasks[d].state != DONE]}")
        t.state = RUNNING
        t.attempts += 1
        t.worker = worker
        if t.started_t is None:
            t.started_t = now
        return t

    def complete(self, task_id: str, now: float) -> TaskSpec:
        t = self.tasks[task_id]
        if t.state != RUNNING:
            raise ValueError(f"complete({task_id!r}): state {t.state}, "
                             "not running")
        t.state = DONE
        t.finished_t = now
        return t

    def preempt(self, task_id: str, now: float) -> TaskSpec:
        """Spot kill mid-task: back off exponentially, then retry."""
        t = self.tasks[task_id]
        if t.state != RUNNING:
            raise ValueError(f"preempt({task_id!r}): state {t.state}, "
                             "not running")
        t.state = PREEMPTED
        t.preemptions += 1
        t.worker = None
        t.retry_at = now + self.retry_backoff_s * (2 ** (t.preemptions - 1))
        return t


def inference_dag(n_items: int, shard_size: int,
                  retry_backoff_s: float = 0.05) -> TaskDag:
    """The paper's pipeline: shard → per-shard prefill → per-shard
    decode → reduce. Payloads carry ``(start, end)`` row ranges."""
    if n_items <= 0 or shard_size <= 0:
        raise ValueError("n_items and shard_size must be positive")
    ranges = [(lo, min(lo + shard_size, n_items))
              for lo in range(0, n_items, shard_size)]
    tasks = [TaskSpec("shard", SHARD, payload=(0, n_items))]
    decode_ids = []
    for i, (lo, hi) in enumerate(ranges):
        tasks.append(TaskSpec(f"prefill/{i}", PREFILL, deps=("shard",),
                              payload=(lo, hi)))
        tasks.append(TaskSpec(f"decode/{i}", DECODE,
                              deps=(f"prefill/{i}",), payload=(lo, hi)))
        decode_ids.append(f"decode/{i}")
    tasks.append(TaskSpec("reduce", REDUCE, deps=tuple(decode_ids),
                          payload=(0, n_items)))
    return TaskDag(tasks, retry_backoff_s=retry_backoff_s)
