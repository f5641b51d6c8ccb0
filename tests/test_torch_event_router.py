"""The port's event-driven router and HTTP front door.

  * PARITY IN THE PORT — ``EventRouter.run_events()`` and ``Router.run()``
    drive one ``RouterCore``, so at the same seed they give bit-identical
    streams, timestamps and summaries: every traffic shape, dense and
    paged, under crashes, with deadlines and a queue cap; the event path
    reuses the sync path's shape buckets.
  * AGAINST THE REFERENCE — the port's event router gives the reference's
    summaries and, with observability on, the reference's trace JSONL
    byte for byte and its counters (virtual clock, modeled time); streams
    equal up to the documented bf16 near-ties.
  * INERT — obs on vs off changes nothing, sync and event, dense and paged.
  * HTTP — the asyncio front door on the CPU: eight concurrent streaming
    clients, cancel on disconnect, capacity reject, readiness, the O(1)
    JSON scrape, and a serve loop that raises ends every stream;
    ``launch.serve.run_http`` serves the clients it is given and raises
    the error of a serve loop that fails under them.

Event-loop tests run under a per-test ``signal.alarm`` guard, so a stuck
loop fails instead of hanging the suite.
"""
import asyncio
import json
import signal

import numpy as np
import pytest

from repro import obs as jobs
from repro import router as jr
from repro.core import LatencyModel as JLatencyModel
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.serving import Engine as JEngine
from repro_torch import obs as pobs
from repro_torch import router as pr
from repro_torch.core import FaultInjector, LatencyModel
from repro_torch.launch import serve
from repro_torch.models import RunConfig, build
from repro_torch.obs import (TERMINAL_EVENTS, Observability, TraceRecorder,
                             lint_prometheus)
from repro_torch.serving import Engine, Request
from test_torch_decode import _assert_streams_match, qwen  # noqa: F401

PROMPT, NEW, SLOTS, MAXLEN = 8, 4, 2, 16
LAT = LatencyModel(cold_start_s=0.3, per_item_s=0.05)
WALL_LAT = LatencyModel(cold_start_s=0.01, per_item_s=None)
# metrics measured on the host clock even under a virtual clock, or
# counting each package's own shape buckets: left out of the comparison
HOST_METRICS = ("repro_round_bucket_seconds_total",
                "repro_compile_misses_total")


@pytest.fixture(autouse=True)
def per_test_timeout():
    def on_alarm(signum, frame):
        raise TimeoutError("test exceeded the 180s per-test guard")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(180)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def stack(qwen):  # noqa: F811
    return dict(qwen, engine=Engine(build(qwen["cfg"]), RunConfig(cache_pad=8),
                                    device="cpu"))


def _pool(stack, *, paged=False, injector=None, lat=LAT, max_len=MAXLEN,
          n_slots=SLOTS):
    return pr.ReplicaPool(stack["engine"], stack["params"],
                          pr.ReplicaConfig(n_slots=n_slots, max_len=max_len,
                                           paged=paged),
                          lat=lat, injector=injector or FaultInjector())


def _reqs(arrivals, cfg, pkg=pr, **kw):
    return pkg.make_requests(arrivals, prompt_len=PROMPT, max_new_tokens=NEW,
                             vocab=cfg.vocab_size, seed=0, **kw)


def _stream_map(router):
    return {r.rid: (list(r.generated), r.first_token_t, r.finish_t)
            for r in router.completed}


def _assert_parity(sync, event, rep_s, rep_e):
    assert rep_s.summary() == rep_e.summary()
    assert _stream_map(sync) == _stream_map(event)
    for router in (sync, event):
        for r in router.pool.replicas:
            if r.batcher.rounds:
                assert r.batcher.decode_dispatches == r.batcher.rounds


# ---------------------------------------------------------------------------
# Clocks and the event queue
# ---------------------------------------------------------------------------


def test_event_queue_and_clocks_behave_as_reference():
    for pkg in (pr, jr):
        eq = pkg.EventQueue()
        for t, kind in ((1.0, "a"), (0.5, "b"), (1.0, "c"), (0.5, "d")):
            eq.push(t, kind, kind)
        assert [eq.pop()[1] for _ in range(4)] == ["b", "d", "a", "c"]
        assert not eq and eq.peek_t() is None
        clk = pkg.VirtualClock()
        clk.advance_to(2.0)
        with pytest.raises(ValueError, match="backwards"):
            clk.advance_to(1.0)
        wall = pkg.WallClock()
        t = wall.now()
        wall.advance_to(0.0)
        assert not wall.virtual and wall.now() >= t >= 0.0


def test_wall_clock_requires_measured_time_and_serve_a_wall_clock(stack):
    with pytest.raises(ValueError, match="measures time"):
        pr.EventRouter(_pool(stack), pr.FixedReplicas(n=1),
                       clock=pr.WallClock())
    router = pr.EventRouter(_pool(stack, lat=WALL_LAT), pr.FixedReplicas(n=1))
    with pytest.raises(RuntimeError, match="wall-clock"):
        asyncio.run(router.serve())


# ---------------------------------------------------------------------------
# Sync and event loops in the port: bit-identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("traffic", ["bursty", "diurnal", "poisson"])
def test_event_and_sync_paths_bit_identical(stack, traffic, paged):
    engine, cfg = stack["engine"], stack["cfg"]
    arrivals = pr.TRAFFIC[traffic](10.0, 2.5, seed=9)
    assert arrivals.size > 0
    policy = pr.QueueDepthPolicy(max_replicas=3)
    sync = pr.Router(_pool(stack, paged=paged), policy, _reqs(arrivals, cfg),
                     traffic_name=traffic)
    rep_s = sync.run()
    compiles = engine.compile_count
    event = pr.EventRouter(_pool(stack, paged=paged), policy,
                           _reqs(arrivals, cfg), traffic_name=traffic)
    rep_e = event.run_events()
    assert engine.compile_count == compiles
    assert rep_e.n_completed == arrivals.size
    _assert_parity(sync, event, rep_s, rep_e)


def test_parity_under_crashes_and_with_deadlines(stack):
    cfg = stack["cfg"]
    arrivals = pr.poisson_arrivals(8.0, 2.0, seed=11)
    burst = np.zeros(10)
    setups = [
        (lambda: _pool(stack, injector=FaultInjector(seed=5, crash_prob=1.0,
                                                     max_crashes=1)),
         lambda: pr.QueueDepthPolicy(max_replicas=2),
         lambda: _reqs(arrivals, cfg), pr.QueueConfig()),
        (lambda: _pool(stack), lambda: pr.FixedReplicas(n=1),
         lambda: _reqs(burst, cfg, deadline_s=0.8),
         pr.QueueConfig(max_depth=6, default_deadline_s=0.8)),
    ]
    for pool, policy, reqs, qcfg in setups:
        sync = pr.Router(pool(), policy(), reqs(), queue_cfg=qcfg)
        rep_s = sync.run()
        event = pr.EventRouter(pool(), policy(), reqs(), queue_cfg=qcfg)
        rep_e = event.run_events()
        assert rep_s.n_crashes or rep_s.n_rejected or rep_s.n_expired
        _assert_parity(sync, event, rep_s, rep_e)


# ---------------------------------------------------------------------------
# Against the reference: summaries, traces, counters
# ---------------------------------------------------------------------------


def _event_run(pkg, engine, params, cfg, obs_pkg, *, paged):
    arrivals = pkg.poisson_arrivals(10.0, 2.0, seed=13)
    lat = (LatencyModel if pkg is pr else JLatencyModel)(
        cold_start_s=0.3, per_item_s=0.05)
    pool = pkg.ReplicaPool(engine, params,
                           pkg.ReplicaConfig(n_slots=SLOTS, max_len=MAXLEN,
                                             paged=paged), lat=lat)
    obs = obs_pkg.Observability(tracer=obs_pkg.TraceRecorder())
    router = pkg.EventRouter(pool, pkg.QueueDepthPolicy(max_replicas=2),
                             _reqs(arrivals, cfg, pkg), traffic_name="obs",
                             obs=obs)
    return router, router.run_events(), obs


def _model_metrics(obs) -> list:
    return [line for line in obs.registry.render().splitlines()
            if not any(name in line for name in HOST_METRICS)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_event_router_equals_reference(stack, paged):
    jengine = JEngine(jbuild(stack["jcfg"]), JRunConfig(cache_pad=8))
    router, rep, obs = _event_run(pr, stack["engine"], stack["params"],
                                  stack["cfg"], pobs, paged=paged)
    jrouter, jrep, jo = _event_run(jr, jengine, stack["jparams"],
                                   stack["jcfg"], jobs, paged=paged)
    assert rep.summary() == jrep.summary()
    assert obs.tracer.dumps() == jo.tracer.dumps()
    assert _model_metrics(obs) == _model_metrics(jo)
    got = {r.rid: r for r in router.completed}
    want = {r.rid: r for r in jrouter.completed}
    rids = sorted(want)
    assert sorted(got) == rids
    assert [(got[i].first_token_t, got[i].finish_t) for i in rids] == \
        [(want[i].first_token_t, want[i].finish_t) for i in rids]
    _assert_streams_match(stack, [want[i].prompt for i in rids],
                          [want[i].generated for i in rids],
                          [got[i].generated for i in rids])


# ---------------------------------------------------------------------------
# Observability is inert
# ---------------------------------------------------------------------------


def _obs_run(stack, router_cls, method, *, paged, obs):
    arrivals = pr.poisson_arrivals(10.0, 2.0, seed=13)
    router = router_cls(_pool(stack, paged=paged),
                        pr.QueueDepthPolicy(max_replicas=2),
                        _reqs(arrivals, stack["cfg"]), traffic_name="obs",
                        obs=obs)
    return router, getattr(router, method)()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("router_cls,method",
                         [(pr.Router, "run"), (pr.EventRouter, "run_events")],
                         ids=["sync", "event"])
def test_obs_on_vs_off_bit_identical(stack, router_cls, method, paged):
    off, rep_off = _obs_run(stack, router_cls, method, paged=paged,
                            obs=None)
    obs = Observability(tracer=TraceRecorder())
    on, rep_on = _obs_run(stack, router_cls, method, paged=paged, obs=obs)
    assert rep_off.summary() == rep_on.summary()
    assert _stream_map(off) == _stream_map(on)
    c = obs.m_requests
    assert c.value(outcome="completed") == rep_on.n_completed
    assert obs.m_tokens.value() == sum(len(r.generated)
                                       for r in on.completed)
    assert obs.m_ttft.count() == len(rep_on.ttft_s)
    assert obs.m_cold_starts.value() == on.pool.n_spawns
    spans = obs.tracer.spans()
    for r in on.completed:
        names = [e["event"] for e in spans[r.rid]]
        assert names[0] == "queued" and names[-1] == "finish"
        assert sum(n in TERMINAL_EVENTS for n in names) == 1
    assert lint_prometheus(obs.registry.render()) == []


def test_readiness_and_live_stats(stack):
    cold = Engine(build(stack["cfg"]), RunConfig(cache_pad=8), device="cpu")
    pool = pr.ReplicaPool(cold, stack["params"],
                          pr.ReplicaConfig(n_slots=SLOTS, max_len=MAXLEN),
                          lat=LAT)
    router = pr.EventRouter(pool, pr.FixedReplicas(n=1))
    assert router.readiness() == {"ok": True, "ready": False,
                                  "n_replicas": 0, "n_ready": 0}
    pool.spawn(0.0)
    pool.poll_ready(0.5)
    assert router.readiness()["ready"] is False and not cold.warm
    rep = pool.ready()[0]
    rep.batcher.submit(Request(0, np.ones(PROMPT, np.int32),
                               max_new_tokens=1))
    rep.batcher.step()
    assert cold.warm and router.readiness()["ready"] is True

    router, rep = _obs_run(stack, pr.EventRouter, "run_events", paged=False,
                           obs=Observability())

    def boom():
        raise AssertionError("live_stats called _report()")

    router._report = boom
    ls = router.live_stats()
    assert ls["n_completed"] == rep.n_completed
    assert ls["cost_usd"] == pytest.approx(rep.cost_usd, abs=1e-8)
    assert ls["ttft_p50_s"] > 0


# ---------------------------------------------------------------------------
# HTTP front door (wall clock, measured TTFT/TPOT)
# ---------------------------------------------------------------------------


async def _generate(port, i, n_new=5, disconnect_after=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"prompt": [1 + (i % 7)] * PROMPT,
                       "max_new_tokens": n_new})
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
    await writer.drain()
    status = await reader.readline()
    assert b"200" in status, status
    while (await reader.readline()) not in (b"\r\n", b"\n"):
        pass
    chunks = []
    while True:
        size = int((await reader.readline()).strip() or b"0", 16)
        if size == 0:
            break
        chunks.append(json.loads(await reader.readexactly(size)))
        await reader.readexactly(2)
        if disconnect_after is not None and len(chunks) >= disconnect_after:
            writer.close()
            return chunks
    writer.close()
    return chunks


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while (h := await reader.readline()) not in (b"\r\n", b"\n", b""):
        k, _, v = h.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    body = await reader.readexactly(int(headers["content-length"]))
    writer.close()
    return status, headers, body.decode()


def _door(stack, **pool_kw):
    router = pr.EventRouter(_pool(stack, lat=WALL_LAT, n_slots=4, **pool_kw),
                            pr.QueueDepthPolicy(max_replicas=2),
                            clock=pr.WallClock(), traffic_name="http")
    return router, pr.HttpFrontDoor(router, port=0)


def test_http_streams_eight_concurrent_clients(stack):
    n_clients, n_new = 8, 5

    async def main():
        router, door = _door(stack)
        await door.start()
        status, _, health = await _get(door.port, "/healthz")
        assert status == 200 and json.loads(health)["ok"] is True
        streams = await asyncio.wait_for(asyncio.gather(
            *(_generate(door.port, i, n_new=n_new)
              for i in range(n_clients))), 120)
        status, _, stats = await _get(door.port, "/metrics.json")
        assert status == 200
        assert json.loads(stats)["n_completed"] == n_clients
        status, headers, text = await _get(door.port, "/metrics")
        assert status == 200 and "version=0.0.4" in headers["content-type"]
        assert lint_prometheus(text) == []
        assert "repro_requests_total" in text
        status, _, health = await _get(door.port, "/healthz")
        assert json.loads(health)["ready"] is True
        assert (await _get(door.port, "/nope"))[0] == 404
        await door.close()
        return router, streams

    router, streams = asyncio.run(main())
    for i, chunks in enumerate(streams):
        toks, end = chunks[:-1], chunks[-1]
        assert len(toks) == n_new
        assert [c["prefill"] for c in toks] == [True] + [False] * (n_new - 1)
        assert [c["done"] for c in toks] == [False] * (n_new - 1) + [True]
        assert all(c0["t"] <= c1["t"] for c0, c1 in zip(toks, toks[1:]))
        assert end["event"] == "end" and end["done"]
        assert end["n_tokens"] == n_new and end["ttft_s"] > 0
        # the stream is the request's greedy continuation
        req = next(r for r in router.completed if r.rid == end["rid"])
        assert [c["token"] for c in toks] == list(req.generated)
        assert list(req.prompt) == [1 + (i % 7)] * PROMPT
    rep = router.report()
    assert rep.time_model == "measured"
    assert rep.n_completed == n_clients and rep.n_cancelled == 0
    assert len(rep.tpot_s) == n_clients and all(t > 0 for t in rep.tpot_s)


def test_http_disconnect_cancels_and_frees_row_mid_round(stack):
    async def main():
        router, door = _door(stack, max_len=48)
        await door.start()
        long_c, short_c = await asyncio.wait_for(asyncio.gather(
            _generate(door.port, 0, n_new=40, disconnect_after=2),
            _generate(door.port, 1, n_new=6)), 120)
        await asyncio.sleep(0.3)
        await door.close()
        return router, long_c, short_c

    router, long_c, short_c = asyncio.run(main())
    assert len(long_c) == 2
    assert len(short_c) == 7 and short_c[-1]["event"] == "end"
    assert short_c[-1]["n_tokens"] == 6 and short_c[-1]["done"]
    rep = router.report()
    assert rep.n_cancelled == 1 and rep.n_completed == 1
    for r in router.pool.replicas:
        assert all(s is None for s in r.batcher.scheduler.slots)


def test_http_capacity_reject_ends_stream_cleanly(stack):
    async def main():
        router, door = _door(stack)
        await door.start()
        chunks = await asyncio.wait_for(
            _generate(door.port, 0, n_new=64), 120)      # 8 + 64 > 16
        await door.close()
        return router, chunks

    router, chunks = asyncio.run(main())
    assert len(chunks) == 1
    end = chunks[0]
    assert end["event"] == "end" and not end["done"]
    assert end["n_tokens"] == 0 and end["ttft_s"] is None
    assert router.report().n_rejected == 1


def test_http_failed_round_ends_streams_and_raises(stack):
    """A round that raises (a failed kernel launch, say) must not leave a
    client waiting: the serve loop ends every open stream, and closing
    the door re-raises the error."""
    async def main():
        router, door = _door(stack)
        engine = stack["engine"]

        def broken(*a, **kw):
            raise RuntimeError("kernel launch failed")

        engine.prefill_into = broken
        try:
            await door.start()
            chunks = await asyncio.wait_for(_generate(door.port, 0), 60)
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                await door.close()
        finally:
            del engine.prefill_into
        return chunks

    chunks = asyncio.run(main())
    assert len(chunks) == 1 and chunks[0]["event"] == "end"
    assert chunks[0]["n_tokens"] == 0 and not chunks[0]["done"]


def test_run_http_serves_the_clients_it_is_given(stack, tmp_path):
    """``launch.serve.run_http(clients=)``: the entry point's own start,
    drain, report and trace dump around five clients, more than one
    replica's slots."""
    n_clients, n_new, trace = 5, 4, tmp_path / "trace.jsonl"

    async def clients(port):
        return await asyncio.gather(
            *(_generate(port, i, n_new=n_new) for i in range(n_clients)))

    out = serve.run_http(None, engine=stack["engine"], params=stack["params"],
                         port=0, trace=str(trace), clients=clients,
                         prompt_len=PROMPT, max_new_tokens=n_new, n_slots=2,
                         max_replicas=3, cold_start=0.01)
    router = out["router"]
    assert out["port"] > 0 and out["report"]["n_completed"] == n_clients
    by_rid = {r.rid: list(r.generated) for r in router.completed}
    for chunks in out["clients"]:
        end = chunks[-1]
        assert end["event"] == "end" and end["done"]
        assert [c["token"] for c in chunks[:-1]] == by_rid[end["rid"]]
    events = [json.loads(line) for line in trace.read_text().splitlines()]
    assert sum(e["event"] == "finish" for e in events) == n_clients


def test_run_http_raises_a_serve_loop_that_fails_under_its_clients(stack):
    """Clients that would wait forever do not hang ``run_http``: the serve
    loop's error ends the run."""
    engine = stack["engine"]

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    async def clients(port):
        await _generate(port, 0)
        await asyncio.Event().wait()

    engine.prefill_into = broken
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            serve.run_http(None, engine=engine, params=stack["params"],
                           port=0, clients=clients, prompt_len=PROMPT,
                           max_new_tokens=4, n_slots=2, cold_start=0.01)
    finally:
        del engine.prefill_into
