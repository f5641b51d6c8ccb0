"""BatchDagRunner: execute an inference TaskDag on heterogeneous pools.

Counterpart of ``repro.batch.runner``. The engine behind every replica is
the port's ``serving.Engine``; with ``RunConfig(attn_impl="pallas")`` on a
CUDA device the prefill stage and every admission run the flash kernel and
every decode round the decode-attention kernel. The prefill stage's first
tokens are the argmax of ``Engine.prefill``'s logits; the decode stage
holds each row's first token, made by ``Engine.prefill_into`` on admission,
to them exactly (both calls attend over the same (1, S) prompt, so on one
device they agree bit for bit). A row's tokens do not depend on which slot
it sits in or on its neighbours: the decode call always carries all
``n_slots`` rows, so the digest is one across placements, kills and pools.

This is the paper's case study run end-to-end: an offline dataset is
sharded, each shard prefilled and decoded by serverless-style replica
workers, and the shard outputs reduced — a DAG of tasks placed across
heterogeneous spot/on-demand ``ReplicaPool``s, on the same clocks and
round-time model the online router uses (``VirtualClock`` for
deterministic runs, ``WallClock`` for smoke).

Execution model (mirrors ``Router.run``'s synchronous rounds):

- one tick = every busy worker runs ONE round; the clock then advances
  by the longest round (workers are concurrent, rounds are synchronous);
- a *decode* round is a real ``ContinuousBatcher.step()`` — the whole
  shard is admitted up front via ``submit_many`` and continuous
  batching drains it; *shard*/*prefill*/*reduce* tasks are single-round
  (prefill runs real per-row ``Engine.prefill`` dispatches);
- modeled round seconds use the router's formula:
  ``overhead + per_item_s * (prefill_tokens * factor + active_rows)``,
  so busy-seconds (and therefore cost) are work-conserving — the
  parallel DAG and the monolithic baseline burn the same billable
  seconds, they just overlap them (BENCH_10's equal-cost claim).

Fault tolerance (the chaos harness's subject):

- every round consults the pool's ``FaultInjector`` with ``now=`` so
  time-keyed spot kills (``CloudProfile.preemption_schedule``) land
  mid-round; a kill crashes the replica, loses the round, and preempts
  the task (exponential backoff, retry on a surviving worker);
- task outputs commit to the ``ArtifactStore`` exactly once
  (``put(..., overwrite=False)`` — first writer wins), and the reduce
  reads only committed outputs: retries can never duplicate a reduce
  contribution, and a preempted task resumes from the DAG checkpoint
  (done tasks stay done) instead of restarting the job;
- a preempted task's in-flight rows are reset exactly once per
  preemption (identity-guarded, same discipline as the arrival queue's
  ``_expired_ids``) and resubmitted wholesale on the retry.

Because every token is computed greedily by the same engine, ANY
prefix of kills replays to bit-identical reduce outputs — the chaos
parity invariant tests/test_torch_batch_dag.py pins via chaos.py.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.batch.dag import (DECODE, PREFILL, REDUCE, SHARD, TaskDag,
                                   TaskSpec)
from repro_torch.core.store import ArtifactStore
from repro_torch.router.cloud import ON_DEMAND_KIND, CloudProfile
from repro_torch.router.events import VirtualClock
from repro_torch.router.pool import STARTING, ReplicaConfig, ReplicaPool
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import Engine


@dataclasses.dataclass
class BatchDataset:
    """The offline workload: fixed-length prompts + a decode budget.
    One prompt length = one prefill bucket = flat compile_count."""

    tokens: np.ndarray          # (N, S) int32
    max_new_tokens: int

    @property
    def n_items(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[1])


def make_dataset(n_items: int, prompt_len: int = 16, vocab: int = 128,
                 max_new_tokens: int = 8, seed: int = 0) -> BatchDataset:
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, size=(n_items, prompt_len),
                        dtype=np.int32)
    return BatchDataset(tokens=toks, max_new_tokens=max_new_tokens)


@dataclasses.dataclass
class WorkerGroup:
    """One cloud pool: the market it's bought from, its replicas, and
    the target size the runner keeps it scaled to (respawn-on-kill)."""

    profile: CloudProfile
    pool: ReplicaPool
    n_workers: int


def make_group(engine: Engine, params: Any, profile: CloudProfile,
               n_workers: int, cfg: ReplicaConfig = ReplicaConfig(),
               horizon_s: float = 3600.0,
               extra_kills: Tuple[Tuple[int, float], ...] = (),
               spare_ids: int = 8) -> WorkerGroup:
    """Build a pool in ``profile``'s market. The spot-kill schedule is
    sampled over ``n_workers + spare_ids`` replica ids so replacement
    replicas (which take fresh ids) stay killable; ``extra_kills`` is
    the chaos harness's hook for explicit boundary kills."""
    inj = profile.injector(n_workers + spare_ids, horizon_s,
                           extra_kills=extra_kills)
    pool = ReplicaPool(engine, params, cfg, injector=inj, profile=profile)
    return WorkerGroup(profile=profile, pool=pool, n_workers=n_workers)


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """Spread DAG tasks across heterogeneous pools: cheapest market
    first (spot), but a task preempted ``pin_to_on_demand_after`` times
    must land on an on-demand worker (guaranteed progress) — unless the
    mix has no on-demand pool, in which case pinning is moot."""

    pin_to_on_demand_after: int = 2

    def eligible(self, task: TaskSpec, groups: List[WorkerGroup]
                 ) -> List[int]:
        order = sorted(range(len(groups)),
                       key=lambda g: (groups[g].profile.price_multiplier, g))
        if task.preemptions >= self.pin_to_on_demand_after:
            pinned = [g for g in order
                      if groups[g].profile.kind == ON_DEMAND_KIND]
            if pinned:
                return pinned
        return order


@dataclasses.dataclass
class DagReport:
    """What one DAG run measured. ``summary()`` is the JSON-able core
    (benchmarks); ``timeline`` feeds the chaos harness."""

    wall_s: float
    busy_s: float
    cost_usd: float
    busy_by_group: Dict[str, float]
    cost_by_group: Dict[str, float]
    stage_busy_s: Dict[str, float]
    n_tasks: int
    attempts_total: int
    n_preemptions: int
    n_spawns: int
    n_rows: int
    n_tokens: int
    compile_count: int
    n_duplicate_commits: int
    digest: str
    outputs: Dict[int, List[int]]
    timeline: List[Dict[str, Any]]

    def summary(self) -> Dict[str, Any]:
        return {
            "wall_s": round(self.wall_s, 6),
            "busy_s": round(self.busy_s, 6),
            "cost_usd": round(self.cost_usd, 10),
            "busy_by_group": {k: round(v, 6)
                              for k, v in self.busy_by_group.items()},
            "cost_by_group": {k: round(v, 10)
                              for k, v in self.cost_by_group.items()},
            "stage_busy_s": {k: round(v, 6)
                             for k, v in self.stage_busy_s.items()},
            "n_tasks": self.n_tasks,
            "attempts_total": self.attempts_total,
            "n_preemptions": self.n_preemptions,
            "n_spawns": self.n_spawns,
            "n_rows": self.n_rows,
            "n_tokens": self.n_tokens,
            "compile_count": self.compile_count,
            "n_duplicate_commits": self.n_duplicate_commits,
            "digest": self.digest,
        }


class BatchDagRunner:
    """Drive one ``TaskDag`` over ``WorkerGroup``s to completion."""

    def __init__(self, dag: TaskDag, dataset: BatchDataset,
                 groups: List[WorkerGroup], *,
                 clock=None, store: Optional[ArtifactStore] = None,
                 placement: PlacementPolicy = PlacementPolicy(),
                 per_item_s: float = 0.02,
                 prefill_token_factor: float = 0.125,
                 round_overhead_s: float = 0.0,
                 task_overhead_s: float = 0.05,
                 run_id: str = "dag", obs=None):
        if not groups:
            raise ValueError("need at least one WorkerGroup")
        need = dataset.prompt_len + dataset.max_new_tokens
        for g in groups:
            if g.pool.cfg.max_len < need:
                raise ValueError(
                    f"group {g.profile.name!r} max_len={g.pool.cfg.max_len}"
                    f" cannot hold prompt+new={need}")
        self.dag = dag
        self.dataset = dataset
        self.groups = groups
        self.clock = clock if clock is not None else VirtualClock()
        self.store = store if store is not None else ArtifactStore()
        self.placement = placement
        self.per_item_s = per_item_s
        self.prefill_token_factor = prefill_token_factor
        self.round_overhead_s = round_overhead_s
        self.task_overhead_s = task_overhead_s
        self.run_id = run_id
        self.obs = obs
        for g in groups:
            g.pool.obs = obs
        self.timeline: List[Dict[str, Any]] = []
        self.n_preemptions = 0
        self.n_duplicate_commits = 0
        self.stage_busy_s: Dict[str, float] = {}
        # (group, replica_id) -> task_id for busy workers
        self._assigned: Dict[Tuple[int, int], str] = {}
        # decode task_id -> its persistent Request rows (survive retries)
        self._rows: Dict[str, List[Request]] = {}

    # -- keys / small helpers -----------------------------------------

    def _key(self, task_id: str) -> str:
        return f"{self.run_id}/{task_id}"

    def _commit(self, task_id: str, payload: Dict[str, Any]) -> None:
        """Exactly-once task effect: first writer wins; a duplicate is
        counted, never re-written (the reduce only ever sees one copy)."""
        blob = json.dumps(payload, sort_keys=True).encode()
        if not self.store.put(self._key(task_id), blob, overwrite=False):
            self.n_duplicate_commits += 1

    def _read(self, task_id: str) -> Dict[str, Any]:
        return json.loads(self.store.get(self._key(task_id)).decode())

    def _log(self, kind: str, t: float, **fields) -> None:
        rec = {"kind": kind, "t": round(float(t), 9)}
        rec.update(fields)
        self.timeline.append(rec)

    def _engine(self) -> Engine:
        return self.groups[0].pool.engine

    def compile_count(self) -> int:
        return sum({id(g.pool.engine): g.pool.engine.compile_count
                    for g in self.groups}.values())

    # -- task bodies ---------------------------------------------------

    def _task_rows(self, task: TaskSpec) -> List[Request]:
        """The decode task's persistent rows: built once, reset (exactly
        once) on preemption, resubmitted wholesale on retry."""
        rows = self._rows.get(task.task_id)
        if rows is None:
            lo, hi = task.payload
            rows = [Request(rid=i, prompt=self.dataset.tokens[i],
                            max_new_tokens=self.dataset.max_new_tokens)
                    for i in range(lo, hi)]
            self._rows[task.task_id] = rows
        return rows

    def _host_round_s(self, task: TaskSpec) -> float:
        """Modeled duration of a single-round (non-decode) task — pure,
        so it can be computed BEFORE the crash decision; the effect
        (compute + commit) only runs on the success path."""
        if task.stage == PREFILL:
            lo, hi = task.payload
            n_tok = (hi - lo) * self.dataset.prompt_len
            return (self.task_overhead_s
                    + self.per_item_s * self.prefill_token_factor * n_tok)
        return self.task_overhead_s

    def _run_shard(self, task: TaskSpec, now: float) -> None:
        n = self.dataset.n_items
        size = max(t.payload[1] - t.payload[0]
                   for t in self.dag.tasks.values() if t.stage == PREFILL)
        ranges = [[lo, min(lo + size, n)] for lo in range(0, n, size)]
        self._commit(task.task_id, {"ranges": ranges})

    def _run_prefill(self, task: TaskSpec, now: float) -> None:
        """Real per-row prefill dispatches; commits each row's greedy
        first token. Row-by-row (B=1) keeps ONE executable bucket and
        matches the batcher's per-row admission math bit-for-bit, so
        the decode stage can assert handoff integrity."""
        lo, hi = task.payload
        eng, params = self._engine(), self.groups[0].pool.params
        firsts = []
        for i in range(lo, hi):
            logits, _ = eng.prefill(params, self.dataset.tokens[i][None])
            firsts.append(int(torch.argmax(logits[0])))
        self._commit(task.task_id,
                     {"rids": list(range(lo, hi)), "first": firsts})

    def _finish_decode(self, task: TaskSpec) -> None:
        rows = self._rows[task.task_id]
        shard_idx = task.task_id.split("/")[1]
        ck = self._read(f"prefill/{shard_idx}")
        firsts = dict(zip(ck["rids"], ck["first"]))
        for q in rows:
            if q.generated[0] != firsts[q.rid]:
                raise RuntimeError(
                    f"stage handoff violated: row {q.rid} first token "
                    f"{q.generated[0]} != prefill checkpoint {firsts[q.rid]}")
        self._commit(task.task_id,
                     {"rids": [q.rid for q in rows],
                      "tokens": [[int(t) for t in q.generated]
                                 for q in rows]})

    def _run_reduce(self, task: TaskSpec, now: float) -> None:
        out: Dict[int, List[int]] = {}
        for t in self.dag.tasks.values():
            if t.stage != DECODE:
                continue
            part = self._read(t.task_id)
            for rid, toks in zip(part["rids"], part["tokens"]):
                out[rid] = toks
        rids = sorted(out)
        self._commit(task.task_id,
                     {"rids": rids, "tokens": [out[r] for r in rids],
                      "n_rows": len(rids),
                      "n_tokens": sum(len(out[r]) for r in rids)})

    # -- round execution ----------------------------------------------

    def _round(self, g: int, r, task: TaskSpec, now: float
               ) -> Tuple[float, bool]:
        """One round of ``task`` on replica ``r``; returns
        (billed round seconds, still_running)."""
        pool = self.groups[g].pool
        if task.stage == DECODE:
            # The whole shard sits in the batcher's queue (submit_many),
            # so — unlike the router, which dispatches lazily — only the
            # rows ADMITTED this round may be charged prefill tokens,
            # and only occupied slots are active. Each row then pays its
            # prompt exactly once plus one active-slot item per emitted
            # token, regardless of shard composition: busy seconds are
            # work-conserving between the monolithic and parallel DAGs.
            pre_occ = sum(1 for s in r.sched.slots if s is not None)
            queue = list(r.sched.queue)
            n_admit = min(r.batcher.n_slots - pre_occ, len(queue))
            admit_tok = sum(len(q.prompt) for q in queue[:n_admit])
            r.step()
            round_s = (self.round_overhead_s + self.per_item_s
                       * (admit_tok * self.prefill_token_factor
                          + pre_occ + n_admit))
        else:
            r.rounds += 1          # host-side task: still one attempt key
            round_s = self._host_round_s(task)
        round_s, crashed = pool.injector.perturb(
            r.replica_id, r.rounds, round_s, now=now)
        r.busy_s += round_s        # crashed rounds are billed too
        self.stage_busy_s[task.stage] = (
            self.stage_busy_s.get(task.stage, 0.0) + round_s)
        obs = self.obs
        if obs is not None:
            obs.m_busy_s.inc(round_s)
            obs.m_round.observe(round_s)
            obs.m_stage_s.inc(round_s, stage=task.stage)
        self._log("round", now, worker=[g, r.replica_id],
                  task=task.task_id, stage=task.stage,
                  round_s=round(round_s, 9), crashed=crashed)

        if crashed:
            # the attempt dies mid-round: the replica is gone, the
            # round's work (including a host task's would-be commit —
            # non-decode bodies only commit on the success path below)
            # is lost, and the task backs off then retries elsewhere.
            lost = pool.crash(r, now + round_s)
            rows = self._rows.get(task.task_id, ())
            row_ids = {id(q) for q in rows}
            assert all(id(q) in row_ids for q in lost), \
                "crash returned rows the task does not own"
            reset = set()          # identity guard: exactly once per kill
            for q in rows:
                if id(q) not in reset:
                    reset.add(id(q))
                    q.reset_for_retry()
            self.dag.preempt(task.task_id, now + round_s)
            self.n_preemptions += 1
            if obs is not None:
                obs.m_preemptions.inc()
                obs.trace("dag_preempt", now + round_s,
                          task=task.task_id, replica=r.replica_id)
            self._log("preempt", now + round_s, worker=[g, r.replica_id],
                      task=task.task_id, retry_at=round(
                          self.dag.tasks[task.task_id].retry_at, 9))
            return round_s, False

        if task.stage == DECODE:
            r.drain_completed()
            rows = self._rows[task.task_id]
            if not all(q.done for q in rows):
                return round_s, True       # keep decoding next tick
            self._finish_decode(task)
        else:
            {SHARD: self._run_shard, PREFILL: self._run_prefill,
             REDUCE: self._run_reduce}[task.stage](task, now)
        self.dag.complete(task.task_id, now + round_s)
        self._log("task_done", now + round_s, task=task.task_id,
                  stage=task.stage, attempts=task.attempts)
        if obs is not None:
            obs.trace("dag_task_done", now + round_s, task=task.task_id,
                      attempts=task.attempts)
        return round_s, False

    # -- the drive loop ------------------------------------------------

    def _place(self, now: float) -> None:
        ready = self.dag.ready(now)
        if not ready:
            return
        free: Dict[int, List[Any]] = {}
        for g, grp in enumerate(self.groups):
            free[g] = [r for r in grp.pool.ready()
                       if (g, r.replica_id) not in self._assigned]
        for task in ready:
            for g in self.placement.eligible(task, self.groups):
                if free[g]:
                    r = free[g].pop(0)
                    self.dag.start(task.task_id, now,
                                   worker=(g, r.replica_id))
                    self._assigned[(g, r.replica_id)] = task.task_id
                    if task.stage == DECODE:
                        r.batcher.submit_many(self._task_rows(task))
                    self._log("task_start", now, task=task.task_id,
                              stage=task.stage, attempt=task.attempts,
                              worker=[g, r.replica_id])
                    if self.obs is not None:
                        self.obs.trace("dag_task_start", now,
                                       task=task.task_id,
                                       attempt=task.attempts,
                                       replica=r.replica_id)
                    break

    def _sync_gauges(self, now: float) -> None:
        obs = self.obs
        if obs is None:
            return
        for state, n in self.dag.counts().items():
            obs.m_dag_tasks.set(n, state=state)
        obs.m_clock_s.set(now)
        obs.m_cost_usd.set(self._cost()[0])

    def _cost(self) -> Tuple[float, Dict[str, float], Dict[str, float]]:
        busy_by, cost_by = {}, {}
        for grp in self.groups:
            name = grp.profile.name
            b = grp.pool.busy_seconds()
            busy_by[name] = busy_by.get(name, 0.0) + b
            cost_by[name] = (cost_by.get(name, 0.0)
                             + b * grp.profile.price_per_replica_s(
                                 grp.pool.cfg.ram_mb))
        return sum(cost_by.values()), busy_by, cost_by

    def run(self, max_ticks: int = 100_000) -> DagReport:
        clock = self.clock
        for grp in self.groups:
            grp.pool.scale_to(grp.n_workers, clock.now())
        ticks = 0
        while not self.dag.all_done:
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"DAG did not finish in {max_ticks} "
                                   f"ticks: {self.dag.counts()}")
            now = clock.now()
            for grp in self.groups:
                grp.pool.scale_to(grp.n_workers, now)   # respawn kills
                grp.pool.poll_ready(now)
            self._place(now)

            durations = []
            for (g, rid), task_id in sorted(self._assigned.items()):
                r = self.groups[g].pool.replicas[rid]
                task = self.dag.tasks[task_id]
                round_s, running = self._round(g, r, task, now)
                durations.append(round_s)
                if not running:
                    del self._assigned[(g, rid)]
            if durations:
                clock.advance_to(now + max(durations))
            else:
                # idle: wait for a cold start or a retry backoff
                targets = [r.ready_t for grp in self.groups
                           for r in grp.pool.replicas
                           if r.state == STARTING]
                nxt = self.dag.next_retry_t()
                if nxt is not None:
                    targets.append(nxt)
                if not targets:
                    raise RuntimeError(
                        f"DAG stalled: {self.dag.counts()}")
                clock.advance_to(max(now, min(targets)) + 1e-9)
            self._sync_gauges(clock.now())

        final = self._read("reduce")
        digest = hashlib.sha256(json.dumps(
            final, sort_keys=True).encode()).hexdigest()
        cost, busy_by, cost_by = self._cost()
        return DagReport(
            wall_s=clock.now(),
            busy_s=sum(busy_by.values()),
            cost_usd=cost,
            busy_by_group=busy_by, cost_by_group=cost_by,
            stage_busy_s=dict(self.stage_busy_s),
            n_tasks=len(self.dag),
            attempts_total=sum(t.attempts
                               for t in self.dag.tasks.values()),
            n_preemptions=self.n_preemptions,
            n_spawns=sum(grp.pool.n_spawns for grp in self.groups),
            n_rows=final["n_rows"], n_tokens=final["n_tokens"],
            compile_count=self.compile_count(),
            n_duplicate_commits=self.n_duplicate_commits,
            digest=digest,
            outputs={r: t for r, t in zip(final["rids"],
                                          final["tokens"])},
            timeline=self.timeline)
