"""Continuous batching: slot-based admission over a SHARED batched cache.

Counterpart of ``repro.serving.batching``, on one device or, through a
mesh-aware ``Engine(mesh=...)``, on every rank of a mesh: each rank runs
the same batcher on the same requests (admission, eviction, rounds) over
its own part of the shared cache (its rows over the data axes, its kv
heads or sequence block over "model") and takes the same decisions,
since the engine hands every rank the whole batch's logits or tokens:
an admission prefills on the ranks that own the slot's row and its first
token is broadcast from them, and a decode round's tokens are gathered
over the data axes. Ranks whose host state parted would block in a
collective, so every spawn of ranks carries a timeout
(``launch.mesh.spawn_ranks``). A fixed
number of decode slots map onto the rows of ONE batched KV cache; the
cache's per-row ``lengths`` make the batch ragged, so each scheduling
round issues exactly **one** ``Engine.decode`` call however many slots
are active.

Three layers:
  * ``SlotScheduler`` — pure bookkeeping (which slot serves which
    request); no tensors, no device state.
  * ``ContinuousBatcher`` (``batched=True``, default) — one
    (n_slots, max_len, ...) cache; admission = ``Engine.prefill_into``
    writes row *b*, eviction = ``Engine.free_row`` zeroes row *b*'s
    length, and every round is ONE batched decode call. The cache-shape
    bucket is stable, so ``engine.compile_count`` stays flat across
    admit/evict churn.
  * ``batched=False`` — the per-slot path (one batch-1 cache and one
    decode call per active slot per round), the baseline the batched
    mode is measured against.

``paged=True`` keeps the batched mode's one decode call a round over a
block-paged cache: a ``PageAllocator`` maps rows onto one physical pool
with prefix sharing and copy-on-write.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.engine import Engine
from repro_torch.serving.paged import PageAllocator, PagesExhausted
from repro_torch.serving.sampler import sample

# Where a scheduling round's wall time goes (the reference's names).
BUCKETS = ("prefill", "decode_attention", "sampler", "host_scheduler")


@dataclasses.dataclass
class Request:
    """One generation request. The core fields drive the batcher; the
    timestamp/SLO fields are stamped by an online router on its virtual
    clock and stay ``None`` for offline workloads."""

    rid: int
    prompt: np.ndarray      # (S,) int32
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    arrival_t: Optional[float] = None       # entered the arrival queue
    deadline_s: Optional[float] = None      # SLO: finish this soon after
    first_token_t: Optional[float] = None   # first streamed token (TTFT)
    finish_t: Optional[float] = None        # last token committed
    n_retries: int = 0
    priority: int = 0       # arrival-queue class: lower dispatches first
    # the port's addition: an encoder-decoder model's (S_enc, D) frame
    # embeddings, encoded at admission (None for a decoder-only model)
    enc_embeds: Optional[np.ndarray] = None

    def reset_for_retry(self):
        """Crash re-queue: in-flight work is lost and the request re-runs
        from scratch. ``first_token_t`` is kept — the client already saw
        that token on the stream."""
        self.generated = []
        self.done = False
        self.n_retries += 1


def _frames(req: Request) -> dict:
    """The admission's frame embeddings as ``Engine.prefill_into`` takes
    them (none for a decoder-only request)."""
    return ({} if req.enc_embeds is None
            else {"enc_embeds": req.enc_embeds[None]})


@dataclasses.dataclass
class SlotScheduler:
    """Tracks which decode slot serves which request.

    Admission protocol (what ``ContinuousBatcher`` drives):
      1. ``submit(req)`` queues a request (FIFO).
      2. ``admit()`` fills every free slot from the queue, lowest slot
         first, and returns the newly-admitted slot ids.
      3. per decode round, ``step_done(slot, token)`` appends one token;
         a request reaching ``max_new_tokens`` completes and frees its
         slot (the caller frees that slot's cache row).
      4. ``idle`` when the queue is empty and every slot is free.
    """

    n_slots: int

    def __post_init__(self):
        self.slots: List[Optional[Request]] = [None] * self.n_slots
        self.queue: List[Request] = []
        self.completed: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def admit(self) -> List[int]:
        """Fill free slots from the queue; returns newly-admitted slot ids."""
        admitted = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.pop(0)
                admitted.append(i)
        return admitted

    def step_done(self, slot: int, token: int):
        req = self.slots[slot]
        if req is None:
            return
        req.generated.append(int(token))
        if len(req.generated) >= req.max_new_tokens:
            req.done = True
            self.completed.append(req)
            self.slots[slot] = None

    @property
    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)


@dataclasses.dataclass
class ContinuousBatcher:
    """Slot-level continuous batching over an ``Engine``.

    ``batched=True`` (default): slots are the rows of ONE shared decode
    cache, allocated at first admission with capacity ``max_len`` — or,
    when unset, the longest prompt then visible (slots + queue) plus
    ``run.cache_pad``. Admission prefills into a free row, each round
    issues one ragged batched decode call for ALL slots (free rows masked
    by ``cache.lengths``), and completion zeroes the row's length.

    A request whose prompt + max_new_tokens exceeds the capacity is
    REJECTED at admission (``rejected`` / :meth:`take_rejected`); the
    round and every other slot in it go on.

    Sampling: greedy by default (``temperature=0``); ``temperature`` /
    ``top_k`` / ``top_p`` / ``seed`` configure the draw. With
    ``fused_sampling=False`` each round's tokens come from one HOST
    sampler step over the (B, V) logits; ``fused_sampling=True`` (batched
    mode only) draws them inside the decode call
    (``Engine.decode_sample`` / ``prefill_into_sample``), with zero
    sampler steps. Both modes draw their noise from one ``torch.Generator``
    seeded with ``seed``, one draw per admission and one per round, so at
    the same seed they emit the same token streams (on the card up to
    top-p cutoff near-ties).

    ``batched=False``: per-slot mode — each slot owns a batch-1 cache and
    every active slot costs one greedy decode call per round.

    ``paged=True`` (batched mode without a mesh only: with
    ``batched=False`` or under a mesh it falls back to the dense cache, as
    the reference does): slots are rows of a
    block-PAGED cache of ``page_size``-token pages. A
    ``serving.paged.PageAllocator`` maps each row's logical pages onto a
    shared pool of ``n_pages`` physical pages (default: the worst case,
    every slot at full capacity, plus the null page), admission is
    ``assign_row_pages`` + ``extend_row`` (one call, cold or warm: a
    prompt sharing a registered prefix maps its leading pages to the
    existing physical copy and only computes the suffix), each round runs
    the allocator's copy-on-write barrier and then the same single ragged
    decode call, and completion returns the row's pages. A request the
    pool cannot hold now is requeued at the front (pages free as rows
    complete); one it can never hold is rejected. ``kv_dtype="int8"``
    engines page int8 pools with their scale pools.

    Counters: ``decode_dispatches`` = decode calls (1 per round batched),
    ``decode_steps`` = slot-steps of decode work (equal between modes for
    the same workload), ``sampler_dispatches`` = host-sampler steps (0
    under ``fused_sampling``), ``rounds`` = scheduling rounds driven.

    Streaming-callback contract: when ``on_token`` is set, every token
    COMMIT calls ``on_token(req, token, prefill)`` — ``prefill=True``
    exactly once per admission, ``False`` for decode-round tokens — in
    commit order, after the scheduler bookkeeping for that token. Free
    rows riding in the decode call never fire it. A raising callback is
    counted in ``on_token_errors`` and does not disturb the batcher.
    """

    engine: Engine
    params: Any
    n_slots: int = 4
    max_len: Optional[int] = None
    batched: bool = True
    paged: bool = False             # block-paged cache (batched mode)
    page_size: int = 16
    n_pages: Optional[int] = None   # physical pool size; default worst case
    on_token: Optional[Any] = None  # callback(req, token, prefill) per commit
    fused_sampling: bool = False    # draw tokens inside the decode call
    temperature: float = 0.0        # 0 = greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0                   # noise stream for temperature sampling

    def __post_init__(self):
        if self.fused_sampling and not self.batched:
            raise ValueError(
                "fused_sampling requires batched=True — the per-slot path "
                "keeps the host sampler (it is the dispatch-overhead "
                "baseline)")
        self.scheduler = SlotScheduler(self.n_slots)
        self.cache: Any = None                # shared batched cache
        self._tokens = np.zeros((self.n_slots, 1), np.int32)
        self.caches: Dict[int, Any] = {}      # per-slot mode: slot -> cache
        self._last_tok: Dict[int, Any] = {}   # per-slot mode: slot -> (1,1)
        self.decode_steps = 0
        self.decode_dispatches = 0
        self.sampler_dispatches = 0   # host-sampler steps (0 fused)
        self.rounds = 0
        self.on_token_errors = 0      # subscriber faults contained
        self._bucket_s = {b: 0.0 for b in BUCKETS}
        self._gen: Optional[torch.Generator] = None
        self.rejected: List[Request] = []
        if self.paged and (self.engine.mesh is not None
                           or not self.batched):
            # paged serving is single-host batched mode only: the per-slot
            # path keeps its dense caches, and a mesh (seq_shard needs a
            # contiguous sequence dim to cut) the dense shared cache
            self.paged = False
        self.allocator: Optional[PageAllocator] = None
        self._host_len: Dict[int, int] = {}   # paged: row -> current length

    def submit(self, req: Request):
        self.scheduler.submit(req)

    def submit_many(self, reqs: Sequence[Request]) -> int:
        """Queue a whole shard in order; returns the number queued."""
        for req in reqs:
            self.scheduler.submit(req)
        return len(reqs)

    def take_rejected(self) -> List[Request]:
        """Drain requests rejected at admission (capacity they can never
        fit)."""
        out, self.rejected = self.rejected, []
        return out

    def _reject(self, slot: int):
        req = self.scheduler.slots[slot]
        self.scheduler.slots[slot] = None
        self.rejected.append(req)

    def take_bucket_s(self) -> Dict[str, float]:
        """Drain the per-round wall-time attribution (``BUCKETS`` keys).
        Host-clock windows around each call: device time surfaces in
        whichever window waits for the device (the token copy to the
        host). Sums to the measured ``step()`` seconds;
        ``host_scheduler`` is the residual."""
        out, self._bucket_s = self._bucket_s, {b: 0.0 for b in BUCKETS}
        return out

    def _fire_on_token(self, req: Request, tok: int, prefill: bool):
        if self.on_token is None or req is None:
            return
        try:
            self.on_token(req, tok, prefill)
        except Exception:
            self.on_token_errors += 1

    # -- sampling seams (the same draws in both modes) ------------------

    def _generator(self) -> torch.Generator:
        """The noise stream: one generator on the engine's device, seeded
        from ``seed``. Each admission and each round draws from it once
        when sampling (the reference splits one PRNG key per admission
        and per round)."""
        if self._gen is None:
            self._gen = torch.Generator(
                device=self.engine.device).manual_seed(self.seed)
        return self._gen

    def _sample_host(self, logits) -> np.ndarray:
        """The HOST sampling path: one extra step on the (B, V) logits the
        call returned; ``fused_sampling=True`` never calls this."""
        self.sampler_dispatches += 1
        t0 = time.perf_counter()
        out = sample(logits, self._generator(), temperature=self.temperature,
                     top_k=self.top_k, top_p=self.top_p).cpu().numpy()
        self._bucket_s["sampler"] += time.perf_counter() - t0
        return out

    def _fused_kw(self) -> dict:
        return dict(temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p)

    def step(self) -> List[int]:
        """One scheduling round: admit (prefill) + decode. Returns the
        slot ids newly admitted this round."""
        t0 = time.perf_counter()
        attributed0 = sum(self._bucket_s.values())
        admitted = self.scheduler.admit()
        if self.paged:
            self._step_paged(admitted)
        elif self.batched:
            self._step_batched(admitted)
        else:
            self._step_per_slot(admitted)
        self.rounds += 1
        attributed = sum(self._bucket_s.values()) - attributed0
        self._bucket_s["host_scheduler"] += max(
            0.0, time.perf_counter() - t0 - attributed)
        return admitted

    # -- batched: one shared cache, one decode call per round -----------

    def _step_batched(self, admitted: List[int]):
        for slot in admitted:
            req = self.scheduler.slots[slot]
            if self.cache is None:
                if self.max_len is None:
                    known = [r for r in self.scheduler.slots
                             if r is not None] + self.scheduler.queue
                    self.max_len = max(
                        len(r.prompt) for r in known
                    ) + self.engine.run.cache_pad
                self.cache = self.engine.new_cache(
                    self.n_slots, self.max_len, **(
                        {} if req.enc_embeds is None
                        else {"enc_len": len(req.enc_embeds)}))
            if len(req.prompt) + req.max_new_tokens > self.max_len:
                self._reject(slot)  # can never fit this cache
                continue
            t_pf = time.perf_counter()
            if self.fused_sampling:
                toks, self.cache = self.engine.prefill_into_sample(
                    self.params, self.cache, slot, req.prompt[None],
                    self._generator(), max_len=self.max_len,
                    **self._fused_kw(), **_frames(req))
                tok = int(toks[0])
                self._bucket_s["prefill"] += time.perf_counter() - t_pf
            else:
                logits, self.cache = self.engine.prefill_into(
                    self.params, self.cache, slot, req.prompt[None],
                    max_len=self.max_len, **_frames(req))
                self._bucket_s["prefill"] += time.perf_counter() - t_pf
                tok = int(self._sample_host(logits)[0])
            self._tokens[slot, 0] = tok
            self._commit_batched(slot, tok, prefill=True)
        if not self.scheduler.active:
            return
        toks = self._decode_round()
        for slot in list(self.scheduler.active):
            self._commit_batched(slot, int(toks[slot]))

    def _decode_round(self) -> np.ndarray:
        """The round's ONE decode call over every slot (free rows ride
        along, masked by their lengths); returns the (n_slots,) tokens."""
        t_dec = time.perf_counter()
        if self.fused_sampling:
            toks, self.cache = self.engine.decode_sample(
                self.params, self.cache, self._tokens, self._generator(),
                **self._fused_kw())
            toks = toks.cpu().numpy()
            self._bucket_s["decode_attention"] += (
                time.perf_counter() - t_dec)
        else:
            logits, self.cache = self.engine.decode(self.params, self.cache,
                                                    self._tokens)
            self._bucket_s["decode_attention"] += (
                time.perf_counter() - t_dec)
            toks = self._sample_host(logits)
        self.decode_dispatches += 1
        self.decode_steps += len(self.scheduler.active)
        self._tokens[:, 0] = toks
        return toks

    def _commit_batched(self, slot: int, tok: int, prefill: bool = False):
        req = self.scheduler.slots[slot]
        self.scheduler.step_done(slot, tok)
        if self.scheduler.slots[slot] is None:  # completed -> free the row
            self.cache = self.engine.free_row(self.cache, slot)
        self._fire_on_token(req, tok, prefill)

    # -- paged: shared physical pool, prefix sharing, COW, 1 call --------

    def _init_paged(self):
        if self.max_len is None:
            known = [r for r in self.scheduler.slots
                     if r is not None] + self.scheduler.queue
            self.max_len = max(
                len(r.prompt) for r in known) + self.engine.run.cache_pad
        max_pages = -(-self.max_len // self.page_size)
        self.max_len = max_pages * self.page_size  # whole pages
        if self.n_pages is None:
            # worst case (every slot at full capacity) plus null page 0; a
            # smaller pool serves more slots at equal KV bytes, since rows
            # only hold the pages they use
            self.n_pages = 1 + self.n_slots * max_pages
        self.allocator = PageAllocator(self.n_pages, self.page_size,
                                       max_pages)
        self.cache = self.engine.new_paged_cache(
            self.n_slots, self.n_pages, self.page_size, max_pages)

    def _step_paged(self, admitted: List[int]):
        for slot in admitted:
            req = self.scheduler.slots[slot]
            if self.cache is None:
                self._init_paged()
            need = len(req.prompt) + req.max_new_tokens
            if need > self.max_len:
                self._reject(slot)   # can never fit a row
                continue
            try:
                plan = self.allocator.admit(slot, req.prompt,
                                            req.max_new_tokens)
            except PagesExhausted:
                if self.allocator.rows and \
                        -(-need // self.page_size) <= self.n_pages - 1:
                    # transient: active rows return pages as they complete
                    self.scheduler.slots[slot] = None
                    self.scheduler.queue.insert(0, req)
                else:
                    self._reject(slot)  # no active row will ever free one
                continue
            t_pf = time.perf_counter()
            self.cache = self.engine.assign_row_pages(
                self.cache, slot, plan.pages, plan.start_len)
            if self.fused_sampling:
                toks, self.cache = self.engine.extend_row_sample(
                    self.params, self.cache, slot, plan.suffix[None],
                    self._generator(), **self._fused_kw())
                tok = int(toks[0])
                self._bucket_s["prefill"] += time.perf_counter() - t_pf
            else:
                logits, self.cache = self.engine.extend_row(
                    self.params, self.cache, slot, plan.suffix[None])
                self._bucket_s["prefill"] += time.perf_counter() - t_pf
                tok = int(self._sample_host(logits)[0])
            self._host_len[slot] = len(req.prompt)
            self._tokens[slot, 0] = tok
            self._commit_paged(slot, tok, prefill=True)
        if not self.scheduler.active:
            return
        for slot in list(self.scheduler.active):
            # copy-on-write barrier: the page this row writes this round
            # must be exclusively owned (only forked rows ever trip it)
            cow = self.allocator.writable_page(slot, self._host_len[slot])
            if cow is not None:
                self.cache = self.engine.cow_copy_page(self.cache, *cow)
                self.cache = self.engine.assign_row_pages(
                    self.cache, slot, self.allocator.rows[slot],
                    self._host_len[slot])
        toks = self._decode_round()
        for slot in list(self.scheduler.active):
            self._host_len[slot] += 1
            self._commit_paged(slot, int(toks[slot]))

    def _commit_paged(self, slot: int, tok: int, prefill: bool = False):
        req = self.scheduler.slots[slot]
        self.scheduler.step_done(slot, tok)
        if self.scheduler.slots[slot] is None:  # completed -> free pages
            self.allocator.free(slot)
            self._host_len.pop(slot, None)
            self.cache = self.engine.free_row(self.cache, slot)
        self._fire_on_token(req, tok, prefill)

    # -- per-slot: one cache + one decode call per active slot ----------

    def _step_per_slot(self, admitted: List[int]):
        for slot in admitted:
            req = self.scheduler.slots[slot]
            t_pf = time.perf_counter()
            logits, cache = self.engine.prefill(self.params,
                                                req.prompt[None])
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            self._bucket_s["prefill"] += time.perf_counter() - t_pf
            self.caches[slot] = cache
            self._last_tok[slot] = tok
            self._commit_per_slot(slot, tok, prefill=True)
        for slot in list(self.scheduler.active):
            t_dec = time.perf_counter()
            logits, cache = self.engine.decode(
                self.params, self.caches[slot], self._last_tok[slot])
            self._bucket_s["decode_attention"] += (
                time.perf_counter() - t_dec)
            self.decode_dispatches += 1
            self.decode_steps += 1
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            self.caches[slot] = cache
            self._last_tok[slot] = tok
            self._commit_per_slot(slot, tok)

    def _commit_per_slot(self, slot: int, tok, prefill: bool = False):
        req = self.scheduler.slots[slot]
        token = int(tok[0, 0])
        self.scheduler.step_done(slot, token)
        if self.scheduler.slots[slot] is None:  # completed -> evict
            self.caches.pop(slot, None)
            self._last_tok.pop(slot, None)
        self._fire_on_token(req, token, prefill)

    # -- mid-flight cancellation (client disconnect) --------------------

    def cancel(self, req: Request) -> bool:
        """Evict ``req`` by IDENTITY: drop it from the queue, or free its
        slot and cache row (and, paged, its pages). Called between rounds.
        Returns True when found."""
        for i, q in enumerate(self.scheduler.queue):
            if q is req:
                del self.scheduler.queue[i]
                return True
        for slot, q in enumerate(self.scheduler.slots):
            if q is not req:
                continue
            self.scheduler.slots[slot] = None
            if self.paged:
                if self.allocator is not None:
                    self.allocator.free(slot)
                self._host_len.pop(slot, None)
                if self.cache is not None:
                    self.cache = self.engine.free_row(self.cache, slot)
            elif self.batched:
                if self.cache is not None:
                    self.cache = self.engine.free_row(self.cache, slot)
            else:
                self.caches.pop(slot, None)
                self._last_tok.pop(slot, None)
            return True
        return False

    def run(self, max_rounds: int = 10_000) -> List[Request]:
        """Drive rounds until every submitted request completes."""
        rounds = 0
        while not self.scheduler.idle:
            self.step()
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError("ContinuousBatcher did not drain")
        return self.scheduler.completed
