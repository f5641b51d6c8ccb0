"""Replica pool: serverless elasticity over the batched serving stack.

Counterpart of ``repro.router.pool``. Each replica is one "serverless
function instance" of the serving layer: a
``ContinuousBatcher(batched=True)`` with its own (n_slots, max_len, ...)
ragged KV cache and one decode call per round. Every replica's batcher
wraps the SAME ``Engine``, modeling the platform's warm container pool on
one host: every replica has the same cache/prompt shape buckets, so
spawning replica N hits the buckets replica 1 made and
``engine.compile_count`` stays flat per replica.

The reference's second placement, ``mesh_slices=n`` (each replica its
own ``Engine`` on a disjoint slice of the device mesh), needs
``Engine.for_mesh`` and ``dist.sharding.slice_meshes``, which the port
does not have yet: ``ReplicaPool(mesh_slices=...)`` raises
``NotImplementedError`` (ROADMAP Queue 1 #4.3).

Elasticity semantics (what the policies drive through ``scale_to``):

  * SCALE UP pays a cold start on the virtual clock —
    ``LatencyModel.cold_start_s`` plus the params fetch from the
    ``ArtifactStore`` (EFS analogue) when one is attached, exactly the
    cold-load ``core/worker.py`` charges. A starting replica serves
    nothing until ``ready_t``.
  * SCALE DOWN drains: the replica stops admitting and retires once its
    last slot finishes. Scaling up again reinstates draining replicas
    first (free) before paying for a new cold start.
  * CRASH (``core.faults.FaultInjector``, keyed by (replica_id, round)
    so runs are reproducible) kills the replica mid-round: the round's
    work is lost and its in-flight requests are handed back to the
    caller for re-queueing — the paper's retry semantics at row
    granularity.

Billing is serverless (Lambda on-demand semantics): only BUSY
replica-seconds are billed — idle warm time and cold-start init cost
latency, not dollars. ``provisioned_seconds`` is also tracked for
anyone who wants reserved-capacity accounting.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

from repro_torch.core.faults import NO_FAULTS, FaultInjector
from repro_torch.core.store import ArtifactStore
from repro_torch.core.worker import LatencyModel
from repro_torch.serving.batching import ContinuousBatcher, Request
from repro_torch.serving.engine import Engine

STARTING, READY, DRAINING, DEAD, RETIRED = (
    "starting", "ready", "draining", "dead", "retired")


@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    """Shape of one replica. ``max_len`` is fixed up front so every
    replica allocates the identical cache bucket (flat compile_count);
    it must cover ``prompt_len + max_new_tokens`` for every request.

    ``paged=True`` gives every replica a block-paged KV cache
    (``ContinuousBatcher(paged=True)`` — page pools, prefix sharing,
    COW). Single-host batched mode only: with a mesh the batcher falls
    back to the dense shared cache, as the reference's does."""

    n_slots: int = 4
    max_len: int = 64
    ram_mb: float = 848.0        # the paper's Lambda sizing
    chips_per_replica: int = 1   # chip-seconds accounting (TPUPriceBook)
    paged: bool = False          # block-paged KV cache per replica
    page_size: int = 16
    n_pages: Optional[int] = None  # physical pool size; None = worst case
    fused_sampling: bool = False   # draw tokens inside the decode dispatch
    # the port's addition: how every replica's batcher draws its tokens
    # (the reference's replicas are greedy); 0 = greedy
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None


class Replica:
    """One serving instance: state machine + its batcher + accounting."""

    def __init__(self, replica_id: int, batcher: ContinuousBatcher,
                 spawn_t: float, ready_t: float):
        self.replica_id = replica_id
        self.batcher = batcher
        self.state = STARTING
        self.spawn_t = spawn_t
        self.ready_t = ready_t
        self.retire_t: Optional[float] = None
        self.rounds = 0
        self.busy_s = 0.0            # billed virtual seconds
        self.busy_slot_rounds = 0
        self.slot_rounds = 0
        self.tokens_out = 0
        self._n_done_drained = 0

    @property
    def sched(self):
        return self.batcher.scheduler

    @property
    def n_inflight(self) -> int:
        return len(self.sched.active) + len(self.sched.queue)

    @property
    def free_slots(self) -> int:
        """Slots this replica can accept NOW (draining accepts none)."""
        if self.state != READY:
            return 0
        return self.batcher.n_slots - self.n_inflight

    def poll_ready(self, now: float):
        if self.state == STARTING and now + 1e-12 >= self.ready_t:
            self.state = READY

    def inflight(self) -> List[Request]:
        return ([r for r in self.sched.slots if r is not None]
                + list(self.sched.queue))

    def step(self) -> float:
        """One scheduling round (admissions + ONE decode call); returns
        measured host seconds. The round ends with its tokens copied to
        the host, which waits for the device, so the time covers the
        round's device work."""
        self.rounds += 1
        t0 = time.perf_counter()
        self.batcher.step()
        return time.perf_counter() - t0

    def drain_completed(self) -> List[Request]:
        """Requests that finished since the last call."""
        done = self.sched.completed[self._n_done_drained:]
        self._n_done_drained = len(self.sched.completed)
        return done


class ReplicaPool:
    """Spawns/retires/crashes replicas against one shared Engine."""

    def __init__(self, engine: Engine, params: Any,
                 cfg: ReplicaConfig = ReplicaConfig(),
                 lat: LatencyModel = LatencyModel(),
                 injector: FaultInjector = NO_FAULTS,
                 store: Optional[ArtifactStore] = None,
                 params_ref: str = "",
                 mesh_slices: Optional[int] = None,
                 profile: Optional[Any] = None):
        self.engine = engine
        self.params = params
        self.cfg = cfg
        self.lat = lat
        self.injector = injector
        self.store = store
        self.params_ref = params_ref
        # optional CloudProfile (router/cloud.py): prices this pool's
        # busy seconds and draws its per-spawn cold-start jitter. None
        # keeps the flat LatencyModel cold start — bare pools unchanged.
        self.profile = profile
        if mesh_slices:
            raise NotImplementedError(
                "ReplicaPool(mesh_slices=...) needs Engine.for_mesh and "
                "dist.sharding.slice_meshes, which the port does not have "
                "yet (ROADMAP Queue 1 #4.3); replicas share one engine")
        self.replicas: List[Replica] = []   # every replica ever (billing)
        self.n_spawns = 0
        self.n_crashes = 0
        # set by RouterCore when an Observability is attached; the pool
        # only ever reads it behind `is not None` guards, so a bare pool
        # (tests, benchmarks) stays exactly as before
        self.obs = None

    def capacity(self) -> Optional[int]:
        """Max live replicas: ``None``, unbounded (shared-engine mode)."""
        return None

    # -- lifecycle ------------------------------------------------------

    def cold_start_s(self) -> float:
        """Scale-up latency: runtime init + model fetch (EFS analogue).

        With a CloudProfile attached the runtime-init part comes from
        the profile's cold-start distribution (deterministic per spawn
        index), not the flat LatencyModel constant."""
        if self.profile is not None:
            s = self.profile.cold_start(self.n_spawns)
        else:
            s = self.lat.cold_start_s
        if (self.store is not None and self.params_ref
                and self.store.exists(self.params_ref)):
            s += self.store.read_time_s(self.store.size(self.params_ref))
        return s

    def spawn(self, now: float) -> Replica:
        """Start a new replica on the shared engine."""
        batcher = ContinuousBatcher(self.engine, self.params,
                                    n_slots=self.cfg.n_slots,
                                    max_len=self.cfg.max_len, batched=True,
                                    paged=self.cfg.paged,
                                    page_size=self.cfg.page_size,
                                    n_pages=self.cfg.n_pages,
                                    fused_sampling=self.cfg.fused_sampling,
                                    temperature=self.cfg.temperature,
                                    top_k=self.cfg.top_k,
                                    top_p=self.cfg.top_p)
        r = Replica(len(self.replicas), batcher, spawn_t=now,
                    ready_t=now + self.cold_start_s())
        self.replicas.append(r)
        self.n_spawns += 1
        if self.obs is not None:
            self.obs.m_cold_starts.inc()
            self.obs.trace("replica_start", now, replica=r.replica_id,
                           ready_t=round(r.ready_t, 9))
        return r

    def poll_ready(self, now: float):
        for r in self.replicas:
            was = r.state
            r.poll_ready(now)
            if (self.obs is not None and was == STARTING
                    and r.state == READY):
                self.obs.trace("replica_ready", now, replica=r.replica_id)

    def live(self) -> List[Replica]:
        return [r for r in self.replicas
                if r.state in (STARTING, READY, DRAINING)]

    def ready(self) -> List[Replica]:
        return [r for r in self.replicas if r.state == READY]

    def scale_to(self, target: int, now: float):
        """Move the pool toward ``target`` serving replicas
        (ready + starting; draining don't count — they're on the way
        out unless reinstated here)."""
        serving = [r for r in self.replicas if r.state in (STARTING, READY)]
        n = len(serving)
        if n < target:
            # reinstate draining replicas first — no cold start to pay
            for r in self.replicas:
                if n >= target:
                    break
                if r.state == DRAINING:
                    r.state = READY
                    n += 1
            while n < target:
                self.spawn(now)
                n += 1
        elif n > target:
            # cancel still-cold replicas first, then drain idle-most
            for r in sorted(serving, key=lambda r: (r.state != STARTING,
                                                    r.n_inflight)):
                if n <= target:
                    break
                if r.state == STARTING:
                    self._retire(r, now)
                else:
                    r.state = DRAINING
                n -= 1
        self.retire_drained(now)

    def _retire(self, r: Replica, now: float, state: str = RETIRED):
        """Terminal transition: mark ``r`` retired/dead."""
        r.state = state
        r.retire_t = now
        if self.obs is not None:
            self.obs.trace("replica_retire", now, replica=r.replica_id,
                           state=state)

    def retire_drained(self, now: float):
        for r in self.replicas:
            if r.state == DRAINING and r.n_inflight == 0:
                self._retire(r, now)

    def retire_all(self, now: float):
        for r in self.live():
            self._retire(r, now)

    def crash(self, r: Replica, now: float) -> List[Request]:
        """Kill ``r``; returns its in-flight requests (the caller
        re-queues them — tokens already lost via reset_for_retry)."""
        reqs = r.inflight()
        self._retire(r, now, state=DEAD)
        self.n_crashes += 1
        if self.obs is not None:
            self.obs.m_crashes.inc()
        return reqs

    # -- accounting -----------------------------------------------------

    def busy_seconds(self) -> float:
        return sum(r.busy_s for r in self.replicas)

    def provisioned_seconds(self, now: float) -> float:
        return sum((r.retire_t if r.retire_t is not None else now)
                   - r.spawn_t for r in self.replicas)

    def tokens_out(self) -> int:
        return sum(r.tokens_out for r in self.replicas)
