"""Event-driven serving front door: ``EventRouter`` + asyncio HTTP.

Counterpart of ``repro.router.frontdoor``.

The second loop over ``router/events.py``'s ``RouterCore`` (the
synchronous-round ``Router`` is the first). Two modes, one core:

  * ``run_events()`` — VIRTUAL clock. Arrivals become timed events in
    an ``EventQueue`` and the loop alternates deliver-due-events →
    control → replica rounds, recreating the synchronous round barrier
    exactly. Because every mechanic is a shared ``RouterCore`` method,
    this path is bit-identical to ``Router.run()`` at the same seed —
    the parity proof (tests/test_torch_event_router.py) that lets the wall
    path below reuse the same policies, ``FaultInjector`` crashes, and
    metrics with confidence.
  * ``serve()`` — WALL clock, asyncio. Rounds run in the event loop's
    thread; if one raises (a failed kernel launch, say), ``serve``
    ends every open stream and re-raises, so no client waits on a
    token that will not come. Live callers ``submit()``
    requests (no traffic generator) and read their tokens back from a
    per-request stream as rounds commit them; TTFT/TPOT come from REAL
    timestamps at first-token/per-token events. Between rounds the
    loop yields to the event loop so the HTTP handlers flush streams;
    when idle it sleeps on a wake event (new submission) or the next
    cold-start deadline.

``HttpFrontDoor`` is the thin serving layer on top: a stdlib-only
HTTP/1.1 server (``asyncio.start_server`` — no extra dependencies)
streaming NDJSON token events over chunked transfer encoding.

  * ``POST /v1/generate``   body ``{"prompt": [ints], "max_new_tokens":
    n, "priority": p, "deadline_s": s}`` → one chunk per token
    ``{"token", "t", "prefill", "done"}`` + a final
    ``{"event": "end", ...}`` stats chunk.
  * ``GET /healthz`` — liveness + READINESS (false until a serving
    replica exists and its engine is warm — see
    ``EventRouter.readiness``).
  * ``GET /metrics`` — Prometheus text exposition rendered from the
    ``repro_torch.obs`` registry (the catalog is ``obs.Observability``).
  * ``GET /metrics.json`` — the legacy JSON counter blob, now served
    O(1) from live state + registry histograms (``live_stats``).

A mid-flight client disconnect cancels its request —
``EventRouter.cancel`` frees the slot's cache row via
``ContinuousBatcher.cancel`` between rounds, so the round (and every
other client in it) survives; the freed row is simply re-admitted
from the queue next round. Cancels are counted (``n_cancelled``), not
billed as failures.

Launch: ``python -m repro_torch.launch.serve --http`` (see launch/serve.py).
"""
from __future__ import annotations

import asyncio
import json
from collections import deque
from typing import Any, Awaitable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import AWSPriceBook, TPUPriceBook
from repro_torch.obs import Observability
from repro_torch.router.events import (ARRIVAL, EventQueue, RouterConfig,
                                       RouterCore, VirtualClock)
from repro_torch.router.metrics import RouterReport
from repro_torch.router.policy import AutoscalePolicy
from repro_torch.router.pool import ReplicaPool
from repro_torch.router.queue import QueueConfig
from repro_torch.serving.batching import Request


class EventRouter(RouterCore):
    """Event-driven router: virtual event-queue trace loop for parity
    tests and benchmarks, asyncio wall-clock loop for live serving."""

    def __init__(self, pool: ReplicaPool, policy: AutoscalePolicy,
                 traffic=(), queue_cfg: QueueConfig = QueueConfig(),
                 cfg: RouterConfig = RouterConfig(),
                 aws: AWSPriceBook = AWSPriceBook(),
                 tpu: TPUPriceBook = TPUPriceBook(),
                 traffic_name: str = "",
                 clock: Optional[Any] = None,
                 obs: Optional[Observability] = None):
        super().__init__(pool, policy, traffic, queue_cfg, cfg, aws, tpu,
                         traffic_name, clock=clock or VirtualClock(),
                         obs=obs)
        self._intake: deque = deque()        # live submissions, pre-queue
        self._streams: Dict[int, asyncio.Queue] = {}   # id(req) -> stream
        self._rid_seq = len(traffic)
        self._wake: Optional[asyncio.Event] = None
        self._stopping = False
        self._n_exp_seen = 0
        self._n_rej_seen = 0

    # -- virtual trace mode (the parity/bench harness) -------------------

    def run_events(self) -> RouterReport:
        """Drive the pre-generated trace through the event loop on the
        virtual clock; returns the same fully-accounted report as
        ``Router.run`` — identically, at the same seed."""
        eq = EventQueue()
        while self._pending:
            req = self._pending.popleft()
            eq.push(req.arrival_t, ARRIVAL, req)
        rounds = 0
        while True:
            rounds += 1
            if rounds > self.cfg.max_rounds:
                raise RuntimeError(
                    f"event router did not drain in "
                    f"{self.cfg.max_rounds} rounds")
            # deliver every event due at the current clock
            while eq and eq.peek_t() <= self.clock + 1e-12:
                _, kind, payload = eq.pop()
                if kind == ARRIVAL:
                    self._admit_arrival(payload)
            self._control()
            durations = self._step_all()
            if durations:
                self._clock.advance_to(self.clock + max(durations))
                self.pool.retire_drained(self.clock)
                continue
            if not eq and self._drained():
                break
            self._idle_advance(eq.peek_t())
        self.pool.retire_all(self.clock)
        return self._report()

    # -- live wall-clock mode --------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               deadline_s: Optional[float] = None
               ) -> Tuple[Request, asyncio.Queue]:
        """Live intake: returns the request and its token stream — one
        ``{"token", "t", "prefill", "done"}`` item per committed token,
        then a ``None`` sentinel (completion, cancellation, expiry, or
        rejection)."""
        req = Request(rid=self._rid_seq,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=int(max_new_tokens),
                      arrival_t=self.clock, deadline_s=deadline_s,
                      priority=int(priority))
        self._rid_seq += 1
        stream: asyncio.Queue = asyncio.Queue()
        self._streams[id(req)] = stream
        self._intake.append(req)
        # fold live requests into the avg-token estimator the trace
        # modes precompute from the full trace
        self._req_tok_sum += (req.max_new_tokens
                              + len(req.prompt) * self._prefill_factor)
        self._req_count += 1
        if self._wake is not None:
            self._wake.set()
        return req, stream

    def cancel(self, req: Request) -> bool:
        """Client went away: remove ``req`` wherever it is — intake,
        arrival queue, or a replica slot (freeing its cache row without
        touching the round). Returns True when found."""
        n_before = len(self._intake)
        self._intake = deque(q for q in self._intake if q is not req)
        found = len(self._intake) != n_before
        found = self.queue.cancel(req) or found
        if not found:
            for r in self.pool.live():
                if r.batcher.cancel(req):
                    found = True
                    break
        if found:
            self.n_cancelled += 1
            self._log("cancel", rid=req.rid)
            if self.obs is not None:
                self.obs.m_requests.inc(outcome="cancelled")
                self.obs.trace("cancel", self.clock, rid=req.rid)
            self._close_stream(req)
            if self._wake is not None:
                self._wake.set()
        return found

    def request_stop(self) -> None:
        """Ask ``serve`` to exit once intake + queue + slots drain."""
        self._stopping = True
        if self._wake is not None:
            self._wake.set()

    async def serve(self) -> None:
        """The wall-clock event loop: admit live intake, run control +
        replica rounds while there is work, sleep on the wake event
        (next submission) or the next cold start otherwise. Exits after
        ``request_stop()`` once fully drained."""
        if self._clock.virtual:
            raise RuntimeError(
                "serve() is the wall-clock path — construct the "
                "EventRouter with clock=WallClock() (run_events() "
                "drives virtual-clock traces)")
        self._wake = asyncio.Event()
        try:
            while True:
                while self._intake:
                    self._admit_arrival(self._intake.popleft())
                self._control()
                self._close_terminal_streams()
                durations = self._step_all()
                if durations:
                    self.pool.retire_drained(self.clock)
                    # let the HTTP handlers flush this round's tokens
                    await asyncio.sleep(0)
                    continue
                if self._stopping and not self._intake and self._drained():
                    break
                waits = [max(r.ready_t - self.clock, 0.0)
                         for r in self.pool.live()
                         if r.state == "starting"]
                timeout = min(waits) + 1e-3 if waits \
                    else self.cfg.idle_step_s
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout)
                except asyncio.TimeoutError:
                    pass
                self._wake.clear()
        finally:
            self.pool.retire_all(self.clock)
            self._close_terminal_streams()
            for req_id in list(self._streams):
                self._streams.pop(req_id).put_nowait(None)

    def report(self) -> RouterReport:
        """Accounting so far (wall mode: call after ``serve`` returns
        for final numbers; mid-flight snapshots are fine too)."""
        return self._report()

    def live_stats(self) -> Dict[str, Any]:
        """The legacy JSON scrape shape (``GET /metrics.json``), served
        in O(1) from live counters and registry histograms — NOT from
        ``_report()``, which walks every completed request and runs
        exact percentile math per call (the hot-path bug this replaces).
        The p50s are the registry's bucket-boundary estimates; exact
        percentiles still come from ``report()`` at end of run."""
        obs = self.obs if self.obs is not None else self.attach_obs(
            Observability())
        return {
            "clock_s": round(self.clock, 4),
            "queue_depth": self.queue.depth,
            "n_replicas": len(self.pool.live()),
            "n_completed": len(self.completed),
            "n_cancelled": self.n_cancelled,
            "n_rejected": len(self.queue.rejected),
            "n_expired": len(self.queue.expired),
            "tokens_out": self.pool.tokens_out(),
            "ttft_p50_s": round(obs.m_ttft.quantile(0.5), 4),
            "tpot_p50_s": round(obs.m_tpot.quantile(0.5), 4),
            "cost_usd": round(self._cost_so_far(), 8),
        }

    def readiness(self) -> Dict[str, Any]:
        """``GET /healthz`` body: liveness (``ok``) plus READINESS —
        false through the cold-start window, true once the pool has a
        replica in a serving state AND that replica's engine has at
        least one executable bucket compiled (``Engine.warm``): the
        next request is served without a spawn or first-compile stall."""
        serving = [r for r in self.pool.live()
                   if r.state in ("ready", "draining")]
        warm = any(getattr(r.batcher.engine, "warm", False)
                   for r in serving)
        return {"ok": True, "ready": warm,
                "n_replicas": len(self.pool.live()),
                "n_ready": len(serving)}

    # -- streaming plumbing ----------------------------------------------

    def _emit_round(self, timed) -> None:
        if not self._streams:
            return
        last = {}
        for i, (req, _tok, _t, _prefill) in enumerate(timed):
            last[id(req)] = i
        for i, (req, tok, t, prefill) in enumerate(timed):
            stream = self._streams.get(id(req))
            if stream is None:
                continue
            done = req.done and last[id(req)] == i
            stream.put_nowait({"token": tok, "t": t,
                               "prefill": prefill, "done": done})
            if done:
                self._close_stream(req)

    def _close_stream(self, req: Request) -> None:
        stream = self._streams.pop(id(req), None)
        if stream is not None:
            stream.put_nowait(None)

    def _close_terminal_streams(self) -> None:
        """Requests that will never produce tokens (expired in queue,
        rejected at admission/capacity) must still end their streams."""
        for q in self.queue.expired[self._n_exp_seen:]:
            self._close_stream(q)
        self._n_exp_seen = len(self.queue.expired)
        for q in self.queue.rejected[self._n_rej_seen:]:
            self._close_stream(q)
        self._n_rej_seen = len(self.queue.rejected)


class HttpFrontDoor:
    """Stdlib-asyncio HTTP/1.1 server over an ``EventRouter`` (wall
    clock). Streams NDJSON token chunks; see the module docstring for
    the routes. ``port=0`` binds an ephemeral port (tests)."""

    def __init__(self, router: EventRouter, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        # the front door always serves Prometheus text, so a router
        # built without observability gets a metrics-only one here
        if router.obs is None:
            router.attach_obs(Observability())
        self.obs = router.obs
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._serve_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._serve_task = asyncio.create_task(self.router.serve())

    async def until(self, work: Awaitable) -> Any:
        """Serve until ``work`` (a set of clients, say) finishes; return
        its result. If the serve loop ends first, its error is raised
        here: clients of a dead loop would wait forever."""
        task = asyncio.ensure_future(work)
        done, _ = await asyncio.wait({task, self._serve_task},
                                     return_when=asyncio.FIRST_COMPLETED)
        if task in done:
            return task.result()
        task.cancel()
        self._serve_task.result()
        raise RuntimeError("the serve loop ended before its work did")

    async def close(self) -> None:
        """Stop accepting, drain the router, join its loop."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.router.request_stop()
        if self._serve_task is not None:
            await self._serve_task

    # -- request handling ------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.obs.m_http_inflight.inc()
        try:
            line = await reader.readline()
            if not line:
                return
            parts = line.decode("latin-1").split(" ")
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            if method == "GET" and path == "/healthz":
                await self._json(writer, 200, self.router.readiness())
            elif method == "GET" and path == "/metrics":
                await self._text(writer, 200,
                                 self.obs.registry.render())
            elif method == "GET" and path == "/metrics.json":
                await self._json(writer, 200, self.router.live_stats())
            elif method == "POST" and path == "/v1/generate":
                await self._generate(reader, writer, headers)
            else:
                await self._json(writer, 404, {"error": "not found"})
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            self.obs.m_http_inflight.dec()
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _generate(self, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter,
                        headers: Dict[str, str]) -> None:
        n = int(headers.get("content-length", "0"))
        body = await reader.readexactly(n) if n else b"{}"
        try:
            spec = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            await self._json(writer, 400, {"error": "bad json"})
            return
        prompt = spec.get("prompt") or []
        req, stream = self.router.submit(
            prompt, int(spec.get("max_new_tokens", 16)),
            priority=int(spec.get("priority", 0)),
            deadline_s=spec.get("deadline_s"))
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        # the request body is fully read, so any further read resolving
        # means the client went away (EOF / reset) -> cancel mid-flight
        watchdog = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                getter = asyncio.ensure_future(stream.get())
                await asyncio.wait({getter, watchdog},
                                   return_when=asyncio.FIRST_COMPLETED)
                if getter.done():
                    item = getter.result()
                    if item is None:
                        break
                    self._chunk(writer, item)
                    await writer.drain()
                else:                      # client disconnected
                    getter.cancel()
                    self.obs.m_http_disconnects.inc()
                    self.router.cancel(req)
                    return
            self._chunk(writer, {
                "event": "end", "rid": req.rid,
                "n_tokens": len(req.generated), "done": req.done,
                "ttft_s": (None if req.first_token_t is None
                           or req.arrival_t is None
                           else req.first_token_t - req.arrival_t),
                "n_retries": req.n_retries,
            })
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            self.obs.m_http_disconnects.inc()
            self.router.cancel(req)
        finally:
            watchdog.cancel()

    # -- wire helpers ----------------------------------------------------

    @staticmethod
    def _chunk(writer: asyncio.StreamWriter, obj: Any) -> None:
        data = (json.dumps(obj) + "\n").encode()
        writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    @staticmethod
    async def _json(writer: asyncio.StreamWriter, status: int,
                    obj: Any) -> None:
        body = (json.dumps(obj) + "\n").encode()
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found"}.get(
            status, "")
        writer.write(f"HTTP/1.1 {status} {reason}\r\n"
                     f"Content-Type: application/json\r\n"
                     f"Content-Length: {len(body)}\r\n"
                     f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()

    @staticmethod
    async def _text(writer: asyncio.StreamWriter, status: int,
                    text: str) -> None:
        """Prometheus text exposition (``GET /metrics``)."""
        body = text.encode()
        writer.write(
            f"HTTP/1.1 {status} OK\r\n"
            f"Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()
