"""Replica pool: serverless elasticity over the batched serving stack.

Counterpart of ``repro.router.pool``. Each replica is one "serverless
function instance" of the serving layer: a
``ContinuousBatcher(batched=True)`` with its own (n_slots, max_len, ...)
ragged KV cache and one decode call per round. Two compute placements:

  * shared engine (default) — every replica's batcher wraps the SAME
    ``Engine``, modeling the platform's warm container pool on one host:
    every replica has the same cache/prompt shape buckets, so spawning
    replica N hits the buckets replica 1 made and
    ``engine.compile_count`` stays flat per replica.
  * ``mesh_slices=n`` — replicas stop sharing compute: ``SlicePool``
    partitions the engine's mesh into ``n`` disjoint sub-meshes
    (``dist.sharding.slice_meshes``, each with its own process groups)
    and each replica holds its own ``Engine(mesh=slice)`` with params in
    that slice's layout. Scale-up acquires a free slice (none free: the
    pool is at capacity and ``spawn`` declines), retirement and crashes
    hand it back, and each slice's engine and params are built once and
    cached, so churn makes no new shape buckets. A meshless template
    gives ``n`` independent one-rank engines.

PyTorch runs one process a rank, and every rank runs the same router
over the same pool. Only a slice's ranks compute its replica's rounds;
a rank outside the slice steps the replica's scheduler through a
stand-in engine (:class:`_Shadow`: no params, no cache, placeholder
tokens), since under the modeled and calibrated clocks the schedule
reads token counts, never token values (the batcher has no stop token:
a request ends at its ``max_new_tokens``). Slices therefore compute
concurrently, each on its own ranks; the tokens a slice produced reach
every rank at the end of the run (:meth:`ReplicaPool.share_streams`).
Under the measured clock the round's seconds come from the slice's
first rank (``router.events``).

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

import numpy as np
import torch

from repro_torch.core.faults import NO_FAULTS, FaultInjector
from repro_torch.core.store import ArtifactStore
from repro_torch.core.worker import LatencyModel
from repro_torch.dist.sharding import slice_meshes
from repro_torch.serving.batching import ContinuousBatcher, Request
from repro_torch.serving.engine import Engine

STARTING, READY, DRAINING, DEAD, RETIRED = (
    "starting", "ready", "draining", "dead", "retired")


def _world() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


class SlicePool:
    """Disjoint per-replica mesh slices, each with its own ``Engine``.

    Built from a template engine: ``slice_meshes(engine.mesh, n)``
    partitions the mesh into ``n`` disjoint sub-meshes (a meshless
    template gives ``n`` independent meshless engines). Per slice, the
    engine and its params are built lazily once, on the slice's ranks
    only, and cached for the pool's lifetime, so releasing a slice and
    acquiring it again reuses every shape bucket.

    ``params`` is the whole param tree, cut for each slice by
    ``Engine.shard_params``, or a function of a slice's engine that
    returns its params (``lambda e: model.init(g, e.device,
    shardings=e.params_sharding)`` draws each leaf's slice without the
    whole tree ever living on a rank).

    Invariant: a slice is held by at most one live replica at a time
    (``acquire`` hands out free indices only, ``release`` raises on a
    double release), and the sub-meshes are disjoint by construction.
    """

    def __init__(self, engine: Engine, params: Any, n_slices: int):
        self.template = engine
        self._base_params = params
        if engine.mesh is not None:
            self.meshes = slice_meshes(engine.mesh, n_slices)
        else:
            self.meshes = [None] * n_slices
        self.n_slices = n_slices
        self._built: dict = {}               # idx -> (engine, params)
        self._free: List[int] = list(range(n_slices))
        self._held: set = set()

    def acquire(self) -> Optional[int]:
        """Claim a free slice index, or ``None`` at capacity."""
        if not self._free:
            return None
        idx = self._free.pop(0)
        self._held.add(idx)
        return idx

    def release(self, idx: int) -> None:
        if idx not in self._held:
            raise ValueError(f"slice {idx} released while not held — a "
                             f"replica retired twice or never acquired it")
        self._held.remove(idx)
        self._free.append(idx)

    def member(self, idx: int) -> bool:
        """Whether this rank computes slice ``idx`` (always, meshless)."""
        mesh = self.meshes[idx]
        return mesh is None or mesh.coords is not None

    def engine_for(self, idx: int):
        """(engine, slice-placed params) for slice ``idx``, built once;
        raises on a rank outside the slice."""
        if not self.member(idx):
            raise ValueError(f"rank {self.meshes[idx].rank} is not in "
                             f"slice {idx} ({self.devices_of(idx)})")
        if idx not in self._built:
            eng = self.template.for_mesh(self.meshes[idx])
            params = (self._base_params(eng) if callable(self._base_params)
                      else eng.shard_params(self._base_params))
            self._built[idx] = (eng, params)
        return self._built[idx]

    def compile_count(self) -> int:
        """Shape buckets made across this rank's slice engines."""
        return sum(e.compile_count for e, _ in self._built.values())

    def held(self) -> List[int]:
        return sorted(self._held)

    def devices_of(self, idx: int) -> List:
        """The ranks slice ``idx`` owns (empty for meshless slices)."""
        mesh = self.meshes[idx]
        return [] if mesh is None else [int(r) for r in mesh.devices.flat]

    def source_of(self, idx: int) -> Optional[int]:
        """The rank whose results stand for slice ``idx`` on every rank
        (its first), or None for a meshless slice."""
        ranks = self.devices_of(idx)
        return ranks[0] if ranks else None


class _Shadow:
    """The stand-in for a slice's engine on a rank outside the slice: it
    holds no params and no cache and computes nothing, answering each
    call with placeholder tokens (0) of the shapes the batcher reads, so
    the replica's scheduler, admissions, evictions and token counts step
    exactly as on the slice's ranks."""

    def __init__(self, template: Engine, mesh):
        self.run = template.run
        self.mesh = mesh  # the slice's: the batcher's paged rule reads it
        self.device = torch.device("cpu")
        self.compile_count = 0

    def new_cache(self, batch: int, max_len: int, enc_len=None):
        return batch  # the batcher passes it back; its row count

    def free_row(self, cache, row: int):
        return cache

    def prefill_into(self, params, cache, row, tokens, **kw):
        return torch.zeros((1, 1)), cache

    def prefill_into_sample(self, params, cache, row, tokens, generator,
                            **kw):
        return torch.zeros((1,), dtype=torch.int32), cache

    def decode(self, params, cache, token):
        return torch.zeros((cache, 1)), cache

    def decode_sample(self, params, cache, token, generator, **kw):
        return torch.zeros((cache,), dtype=torch.int32), cache


class _ShadowBatcher(ContinuousBatcher):
    """A batcher over :class:`_Shadow`: its host sampler draws nothing."""

    def _sample_host(self, logits) -> np.ndarray:
        self.sampler_dispatches += 1
        return np.zeros((logits.shape[0],), np.int32)


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
                 spawn_t: float, ready_t: float,
                 slice_idx: Optional[int] = None, computes: bool = True):
        self.replica_id = replica_id
        self.batcher = batcher
        self.state = STARTING
        self.spawn_t = spawn_t
        self.ready_t = ready_t
        self.slice_idx = slice_idx    # mesh-slice mode: which slice it holds
        self.computes = computes      # this rank runs its rounds
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
    """Spawns/retires/crashes replicas against one shared Engine, or
    (``mesh_slices=n``) each on its own disjoint mesh slice."""

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
        self.slices = (SlicePool(engine, params, mesh_slices)
                       if mesh_slices else None)
        self.replicas: List[Replica] = []   # every replica ever (billing)
        self.n_spawns = 0
        self.n_crashes = 0
        # set by RouterCore when an Observability is attached; the pool
        # only ever reads it behind `is not None` guards, so a bare pool
        # (tests, benchmarks) stays exactly as before
        self.obs = None

    def capacity(self) -> Optional[int]:
        """Max live replicas (``None`` = unbounded shared-engine mode)."""
        return None if self.slices is None else self.slices.n_slices

    def round_source(self, r: "Replica") -> Optional[int]:
        """The rank whose clock times ``r``'s rounds for every rank where
        several ranks run this router (the slice's first rank; rank 0 of a
        shared multi-rank mesh); None on one rank."""
        if _world() <= 1:
            return None
        if self.slices is not None:
            return self.slices.source_of(r.slice_idx)
        mesh = self.engine.mesh
        return None if mesh is None else int(mesh.devices.flat[0])

    def share_streams(self, served) -> None:
        """Give every rank the tokens of the requests a slice computed:
        ``served`` lists (request, replica) of the run's completions; the
        slice's first rank holds the real tokens, the others the
        placeholders of :class:`_Shadow`. One all_gather_object over the
        world; a no-op without slices or on one rank."""
        if self.slices is None or _world() <= 1:
            return
        rank = torch.distributed.get_rank()
        mine = {req.rid: list(req.generated) for req, r in served
                if self.slices.source_of(r.slice_idx) == rank}
        every = [None] * _world()
        torch.distributed.all_gather_object(every, mine)
        tokens = {rid: toks for part in every for rid, toks in part.items()}
        for req, _ in served:
            req.generated = tokens[req.rid]

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

    def spawn(self, now: float) -> Optional[Replica]:
        """Start a new replica; ``None`` when every mesh slice is held
        (shared-engine mode never declines). On a rank outside the
        slice the replica's batcher runs on :class:`_Shadow`."""
        slice_idx, computes = None, True
        engine, params, make = self.engine, self.params, ContinuousBatcher
        if self.slices is not None:
            slice_idx = self.slices.acquire()
            if slice_idx is None:
                return None
            computes = self.slices.member(slice_idx)
            if computes:
                engine, params = self.slices.engine_for(slice_idx)
            else:
                engine = _Shadow(self.engine, self.slices.meshes[slice_idx])
                params = None
                make = _ShadowBatcher
        batcher = make(engine, params,
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
                    ready_t=now + self.cold_start_s(), slice_idx=slice_idx,
                    computes=computes)
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
                if self.spawn(now) is None:   # mesh slices all held
                    break
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
        """Terminal transition: mark ``r`` retired/dead and hand its mesh
        slice (if any) back to the free pool."""
        r.state = state
        r.retire_t = now
        if self.slices is not None and r.slice_idx is not None:
            self.slices.release(r.slice_idx)
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
        re-queues them — tokens already lost via reset_for_retry). The
        dead replica's mesh slice returns to the free pool, so the
        replacement the policy spawns reuses its engine."""
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
