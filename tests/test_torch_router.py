"""The port's online router and calibration against the reference.

Both packages serve the same traffic on qwen2-7b smoke with the same
params (``models.convert.from_reference``), each through its own shared
engine. Under modeled round times a ``RouterReport`` depends only on token
counts (no request stops early), so summaries must be EQUAL: under every
default policy, with crashes, with deadlines and a queue cap, and on a
calibrated clock. Token streams are equal up to the documented bf16
near-ties (``test_torch_decode._assert_streams_match``). Besides: traffic
and policies equal the reference's, ``compile_count`` stays flat per
replica, the calibration fit and ``samples_from_bench`` equal the
reference's, the artifact round-trips, the loud errors fire, cloud
profiles (prices, cold-start draws, spot kill schedules) equal the
reference's and so does a router whose pool is bought from a spot
profile, and the two differences by design are pinned: ``mesh_slices=``
raises, and a pool with an ``ArtifactStore`` charges a params fetch whose
size is the pickle's, which differs between the packages.
"""
import dataclasses
import inspect
import json
import pathlib

import numpy as np
import pytest

from repro import router as jr
from repro.core import ArtifactStore as JStore
from repro.core import FaultInjector as JFaultInjector
from repro.core import LatencyModel as JLatencyModel
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import router as pr
from repro_torch.core import ArtifactStore, FaultInjector, LatencyModel
from repro_torch.launch import serve
from repro_torch.models import RunConfig, build
from repro_torch.serving import Engine, Request
from test_torch_decode import _assert_streams_match, qwen  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPT, NEW, SLOTS, MAXLEN = 8, 4, 2, 16
LAT = dict(cold_start_s=0.3, per_item_s=0.05)
POLICIES = ["fixed-1", "queue-depth", "throughput", "cost-cap"]
SPOT_KILLS = (8, 10.0)       # kill schedules for 8 workers over 10 s


@pytest.fixture(scope="module")
def stacks(qwen):  # noqa: F811
    return dict(
        qwen, jengine=JEngine(jbuild(qwen["jcfg"]), JRunConfig(cache_pad=8)),
        engine=Engine(build(qwen["cfg"]), RunConfig(cache_pad=8),
                      device="cpu"))


def _side(stacks, port: bool):
    """(router package, engine, params, FaultInjector, LatencyModel)."""
    if port:
        return (pr, stacks["engine"], stacks["params"], FaultInjector,
                LatencyModel)
    return (jr, stacks["jengine"], stacks["jparams"], JFaultInjector,
            JLatencyModel)


def _policy(pkg, name, max_replicas=3):
    return {p.name: p for p in pkg.default_policies(
        slots_per_replica=SLOTS, max_replicas=max_replicas,
        tokens_per_s_per_replica=1.0 / LAT["per_item_s"])}[name]


def _run(stacks, port, policy, arrivals, *, injector=None,
         queue_cfg=None, lat=LAT, cfg=None, deadline_s=None,
         paged=False, profile=None):
    """One router run; ``profile``, a function of the package, gives the
    pool a CloudProfile and, with it, the profile's spot kills."""
    pkg, engine, params, fi, lm = _side(stacks, port)
    cloud = profile(pkg) if profile else None
    pool = pkg.ReplicaPool(engine, params,
                           pkg.ReplicaConfig(n_slots=SLOTS, max_len=MAXLEN,
                                             paged=paged),
                           lat=lm(**lat),
                           injector=(cloud.injector(*SPOT_KILLS) if cloud
                                     else fi(**(injector or {}))),
                           profile=cloud)
    reqs = pkg.make_requests(arrivals, prompt_len=PROMPT, max_new_tokens=NEW,
                             vocab=stacks["cfg"].vocab_size, seed=0,
                             deadline_s=deadline_s)
    router = pkg.Router(pool, policy(pkg), reqs,
                        queue_cfg=pkg.QueueConfig(**(queue_cfg or {})),
                        cfg=cfg(pkg) if cfg else pkg.RouterConfig(),
                        traffic_name="test")
    return router.run(), router


def _assert_same(stacks, both):
    """Equal summaries; streams equal up to near-ties; port timestamps
    equal the reference's."""
    (rep, router), (jrep, jrouter) = both
    assert rep.summary() == jrep.summary()
    assert rep.ttft_s == jrep.ttft_s and rep.tpot_s == jrep.tpot_s
    got = {r.rid: r for r in router.completed}
    want = {r.rid: r for r in jrouter.completed}
    assert sorted(got) == sorted(want)
    rids = sorted(want)
    for i in rids:
        assert (got[i].first_token_t, got[i].finish_t, got[i].n_retries) \
            == (want[i].first_token_t, want[i].finish_t, want[i].n_retries)
    _assert_streams_match(stacks, [want[i].prompt for i in rids],
                          [want[i].generated for i in rids],
                          [got[i].generated for i in rids])


def _both(stacks, *args, **kw):
    return [_run(stacks, port, *args, **kw) for port in (True, False)]


# ---------------------------------------------------------------------------
# Traffic, queue and policies: pure host code, equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["poisson", "bursty", "diurnal"])
def test_traffic_equals_reference(name):
    for rate, horizon, seed in ((12.0, 4.0, 0), (3.0, 10.0, 7),
                                (0.0, 5.0, 1), (5.0, 0.0, 1)):
        got = pr.TRAFFIC[name](rate, horizon, seed)
        np.testing.assert_array_equal(got, jr.TRAFFIC[name](rate, horizon,
                                                            seed))
    arrivals = pr.TRAFFIC[name](12.0, 4.0, 3)
    got = pr.make_requests(arrivals, prompt_len=16, max_new_tokens=8,
                           vocab=256, seed=3, deadline_s=1.5)
    want = jr.make_requests(arrivals, prompt_len=16, max_new_tokens=8,
                            vocab=256, seed=3, deadline_s=1.5)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.rid, a.max_new_tokens, a.arrival_t, a.deadline_s) == \
            (b.rid, b.max_new_tokens, b.arrival_t, b.deadline_s)


def test_policies_and_prices_equal_reference():
    assert pr.aws_replica_price_s() == jr.aws_replica_price_s()
    assert pr.tpu_replica_price_s() == jr.tpu_replica_price_s()
    rng = np.random.default_rng(0)
    for _ in range(200):
        kw = dict(clock=float(rng.uniform(0, 10)),
                  queue_depth=int(rng.integers(0, 40)),
                  oldest_wait_s=float(rng.uniform(0, 3)),
                  n_ready=int(rng.integers(0, 5)),
                  n_starting=int(rng.integers(0, 3)),
                  n_draining=int(rng.integers(0, 2)),
                  active_slots=int(rng.integers(0, 16)),
                  slots_per_replica=4,
                  arrival_rate_rps=float(rng.uniform(0, 30)),
                  tokens_per_s=float(rng.uniform(0, 500)),
                  avg_request_tokens=float(rng.uniform(4, 40)),
                  cost_usd=float(rng.uniform(0, 2)),
                  slice_capacity=[None, 2][int(rng.integers(0, 2))])
        for p, q in zip(pr.default_policies(), jr.default_policies(),
                        strict=True):
            assert p.name == q.name
            assert p.target(pr.PoolSnapshot(**kw)) == \
                q.target(jr.PoolSnapshot(**kw))


def test_queue_admission_deadlines_requeue_equal_reference():
    def drive(pkg, Req):
        q = pkg.ArrivalQueue(pkg.QueueConfig(max_depth=4,
                                             default_deadline_s=1.0))
        reqs = [Req(i, np.ones(3, np.int32), 2, priority=i % 2)
                for i in range(6)]
        log = [q.submit(r, 0.1 * i) for i, r in enumerate(reqs)]
        log.append([getattr(q.pop(0.5), "rid", None) for _ in range(2)])
        log.append(q.requeue(reqs[:2], 0.6))
        log.append([getattr(q.pop(1.3), "rid", None) for _ in range(4)])
        log.append((q.depth, q.n_submitted, q.n_requeued,
                    [r.rid for r in q.rejected], [r.rid for r in q.expired]))
        return log

    assert drive(pr, Request) == drive(jr, JRequest)


# ---------------------------------------------------------------------------
# Router runs: summaries equal, streams equal up to near-ties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", POLICIES)
def test_router_under_each_default_policy_equals_reference(stacks, name):
    arrivals = pr.bursty_arrivals(10.0, 2.5, seed=9)
    assert arrivals.size > 0
    both = _both(stacks, lambda pkg: _policy(pkg, name), arrivals)
    _assert_same(stacks, both)
    assert both[0][0].n_completed == arrivals.size


def test_router_with_crashes_equals_reference(stacks):
    arrivals = pr.poisson_arrivals(6.0, 2.0, seed=3)
    for injector in (dict(seed=5, crash_prob=1.0, max_crashes=1),
                     dict(seed=1, crash_prob=0.2, straggler_prob=0.2)):
        both = _both(stacks, lambda pkg: pkg.QueueDepthPolicy(
            max_replicas=2), arrivals, injector=injector)
        _assert_same(stacks, both)
        rep = both[0][0]
        assert rep.n_crashes >= 1 and rep.n_requeued >= 1
        assert rep.n_completed == arrivals.size


def test_router_with_deadlines_and_queue_cap_equals_reference(stacks):
    burst = np.zeros(10)
    both = _both(stacks, lambda pkg: pkg.FixedReplicas(n=1), burst,
                 queue_cfg=dict(max_depth=6, default_deadline_s=0.8),
                 deadline_s=0.8)
    _assert_same(stacks, both)
    rep = both[0][0]
    assert rep.n_rejected > 0 and rep.n_expired > 0
    assert rep.n_completed + rep.n_rejected + rep.n_expired == 10


def test_paged_router_equals_reference(stacks):
    arrivals = pr.poisson_arrivals(8.0, 2.0, seed=4)
    _assert_same(stacks, _both(stacks, lambda pkg: pkg.QueueDepthPolicy(
        max_replicas=3), arrivals, paged=True))


def test_compile_count_flat_per_replica(stacks):
    engine = stacks["engine"]
    _run(stacks, True, lambda pkg: pkg.FixedReplicas(n=1),
         pr.poisson_arrivals(4.0, 1.0, seed=2))
    warm = engine.compile_count
    rep, router = _run(stacks, True,
                       lambda pkg: pkg.QueueDepthPolicy(max_replicas=3),
                       np.zeros(10))
    assert rep.peak_replicas >= 2 and rep.n_completed == 10
    assert engine.compile_count == warm
    assert all(r.state == "retired" for r in router.pool.replicas)


def test_queue_depth_beats_fixed1_at_equal_cost(stacks):
    burst = np.zeros(12)
    fixed, _ = _run(stacks, True, lambda pkg: pkg.FixedReplicas(n=1), burst)
    auto, _ = _run(stacks, True,
                   lambda pkg: pkg.QueueDepthPolicy(max_replicas=4), burst)
    assert np.percentile(auto.ttft_s, 99) < \
        0.5 * np.percentile(fixed.ttft_s, 99)
    assert auto.busy_replica_s == pytest.approx(fixed.busy_replica_s,
                                                rel=1e-9)


def test_measured_time_mode_runs(stacks):
    arrivals = pr.poisson_arrivals(4.0, 1.0, seed=4)
    rep, _ = _run(stacks, True, lambda pkg: pkg.FixedReplicas(n=1),
                  arrivals, lat=dict(cold_start_s=0.01, per_item_s=None))
    assert rep.time_model == "measured"
    assert rep.n_completed == arrivals.size and rep.busy_replica_s > 0


def test_replica_sampling_settings_reach_the_batcher(stacks):
    pool = pr.ReplicaPool(stacks["engine"], stacks["params"],
                          pr.ReplicaConfig(n_slots=SLOTS, max_len=MAXLEN,
                                           fused_sampling=True,
                                           temperature=0.8, top_k=5,
                                           top_p=0.9))
    b = pool.spawn(0.0).batcher
    assert (b.fused_sampling, b.temperature, b.top_k, b.top_p) == \
        (True, 0.8, 5, 0.9)
    fields = {f.name for f in dataclasses.fields(pr.ReplicaConfig)}
    assert fields - {f.name for f in dataclasses.fields(jr.ReplicaConfig)} \
        == {"temperature", "top_k", "top_p"}


# ---------------------------------------------------------------------------
# Cloud profiles: the market a pool is bought from
# ---------------------------------------------------------------------------


def _profiles(pkg, seed):
    return [pkg.ON_DEMAND, pkg.spot_profile(seed=seed),
            pkg.spot_profile(preempt_rate_per_s=0.7, seed=seed,
                             price_multiplier=0.45)]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_cloud_profiles_equal_reference(seed):
    n_kills = 0
    for p, q in zip(_profiles(pr, seed), _profiles(jr, seed), strict=True):
        assert dataclasses.asdict(p) == dataclasses.asdict(q)
        for ram_mb in (128.0, 848.0, 3008.0):
            assert p.price_per_replica_s(ram_mb) == q.price_per_replica_s(
                ram_mb)
        assert [p.cold_start(i) for i in range(20)] == \
            [q.cold_start(i) for i in range(20)]
        for w in range(6):
            assert p.kill_times(w, 30.0) == q.kill_times(w, 30.0)
        sched = p.preemption_schedule(6, 30.0)
        assert sched == q.preemption_schedule(6, 30.0)
        n_kills += len(sched)
        extra = ((1, 0.25), (4, 2.5))
        inj, jinj = p.injector(6, 30.0, extra), q.injector(6, 30.0, extra)
        assert (inj.seed, inj.crash_at_s) == (jinj.seed, jinj.crash_at_s)
    assert n_kills > 0


@pytest.mark.parametrize("kw", [dict(kind="reserved"),
                                dict(preempt_rate_per_s=0.5)])
def test_cloud_profile_errors_equal_reference(kw):
    with pytest.raises(ValueError) as got:
        pr.CloudProfile(**kw)
    with pytest.raises(ValueError) as want:
        jr.CloudProfile(**kw)
    assert str(got.value) == str(want.value)


def test_router_on_a_spot_profile_equals_reference(stacks):
    """The pool's ``profile=`` hook: every spawn's cold start drawn from
    the spot profile, replicas killed on its preemption schedule."""
    arrivals = pr.poisson_arrivals(6.0, 2.0, seed=6)
    spot = lambda pkg: pkg.spot_profile(preempt_rate_per_s=0.8,  # noqa: E731
                                        seed=0)
    both = _both(stacks, lambda pkg: pkg.QueueDepthPolicy(max_replicas=3),
                 arrivals, profile=spot)
    _assert_same(stacks, both)
    rep, router = both[0]
    assert rep.n_crashes >= 1 and rep.n_completed == arrivals.size
    profile = spot(pr)
    for i, r in enumerate(router.pool.replicas):
        assert r.ready_t - r.spawn_t == pytest.approx(profile.cold_start(i),
                                                      abs=1e-12)


# ---------------------------------------------------------------------------
# Differences by design
# ---------------------------------------------------------------------------


def test_mesh_slices_raise_naming_the_roadmap_item(stacks):
    with pytest.raises(NotImplementedError, match="Queue 1 #4.3"):
        pr.ReplicaPool(stacks["engine"], stacks["params"], mesh_slices=2)
    assert not hasattr(pr, "SlicePool")


def test_store_fetch_time_follows_each_package_pickle(stacks):
    """A pool with a store charges ``read_time_s(size)`` at every spawn.
    The port pickles its own leaf records where the reference pickles a
    jax treedef, so the sizes, and with them the cold starts, differ by
    design; the router parity tests therefore run without a store."""
    store, jstore = ArtifactStore(), JStore()
    store.put_tree("models/lm", stacks["params"])
    jstore.put_tree("models/lm", stacks["jparams"])
    size, jsize = store.size("models/lm"), jstore.size("models/lm")
    assert size != jsize
    pool = pr.ReplicaPool(stacks["engine"], stacks["params"],
                          lat=LatencyModel(**LAT), store=store,
                          params_ref="models/lm")
    jpool = jr.ReplicaPool(stacks["jengine"], stacks["jparams"],
                           lat=JLatencyModel(**LAT), store=jstore,
                           params_ref="models/lm")
    assert pool.cold_start_s() - jpool.cold_start_s() == pytest.approx(
        (size - jsize) / (store.read_bandwidth_mbps * 1e6), rel=1e-9)
    assert abs(pool.cold_start_s() - jpool.cold_start_s()) < 1e-3


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _samples(pkg):
    def truth(p, a):
        return 0.004 + 0.02 * (p * 0.125 + a)
    return [pkg.RoundSample(p, a, truth(p, a) * (1 + 0.01 * (i % 3 - 1)))
            for i, (p, a) in enumerate([(0, 1), (0, 4), (64, 0), (128, 0),
                                        (32, 2), (0, 8)])]


def test_fit_round_model_equals_reference():
    got = pr.fit_round_model(_samples(pr), backend="cuda", device_count=1,
                             source="t")
    want = jr.fit_round_model(_samples(jr), backend="cuda", device_count=1,
                              source="t")
    assert got.to_json() == want.to_json()
    exact = pr.fit_round_model([pr.RoundSample(p, a, 0.004 + 0.02 * (
        p * 0.125 + a)) for p, a in [(0, 1), (0, 4), (64, 0), (16, 2)]])
    assert exact.round_overhead_s == pytest.approx(0.004)
    assert exact.per_item_s == pytest.approx(0.02)
    assert exact.prefill_token_factor == pytest.approx(0.125)


def test_samples_from_bench_equal_reference():
    record = json.loads((ROOT / "BENCH_3.json").read_text())
    got, want = pr.samples_from_bench(record), jr.samples_from_bench(record)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert len(got) >= 3
    assert pr.fit_round_model(got).to_json() == \
        jr.fit_round_model(want).to_json()


def test_calibration_artifact_round_trips(tmp_path):
    cal = pr.fit_round_model(_samples(pr), backend="cuda", device_count=1)
    path = tmp_path / "cal.json"
    cal.save(str(path))
    assert pr.CalibratedLatencyModel.load(str(path)) == cal
    # the reference reads the port's artifact and vice versa
    assert jr.CalibratedLatencyModel.load(str(path)).to_json() == \
        cal.to_json()
    assert cal.summary() == jr.CalibratedLatencyModel.from_json(
        cal.to_json()).summary()


def test_calibration_loud_errors(stacks):
    cal = pr.fit_round_model(_samples(pr))
    with pytest.raises(ValueError, match="need >= 3"):
        pr.fit_round_model(_samples(pr)[:2])
    with pytest.raises(ValueError, match="BOTH"):
        pr.RouterConfig(calibration=cal, round_overhead_s=0.01)
    with pytest.raises(ValueError, match="supplied by the calibration"):
        cal.to_latency_model(per_item_s=0.02)
    pool = pr.ReplicaPool(stacks["engine"], stacks["params"],
                          lat=LatencyModel(**LAT))
    with pytest.raises(ValueError, match="both RouterConfig.calibration"):
        pr.Router(pool, pr.FixedReplicas(n=1), [],
                  cfg=cal.to_router_config())
    wall = pr.ReplicaPool(stacks["engine"], stacks["params"],
                          lat=cal.to_latency_model())
    with pytest.raises(ValueError, match="wall-clock router"):
        pr.EventRouter(wall, pr.FixedReplicas(n=1),
                       cfg=cal.to_router_config(), clock=pr.WallClock())


def test_calibrated_router_equals_reference(stacks):
    arrivals = pr.poisson_arrivals(6.0, 2.0, seed=5)
    cal = pr.fit_round_model(_samples(pr))
    jcal = jr.fit_round_model(_samples(jr))
    both = []
    for port, c in ((True, cal), (False, jcal)):
        pkg, engine, params, _, lm = _side(stacks, port)
        pool = pkg.ReplicaPool(engine, params, pkg.ReplicaConfig(
            n_slots=SLOTS, max_len=MAXLEN),
            lat=c.to_latency_model(cold_start_s=0.3))
        reqs = pkg.make_requests(arrivals, prompt_len=PROMPT,
                                 max_new_tokens=NEW,
                                 vocab=stacks["cfg"].vocab_size, seed=0)
        router = pkg.Router(pool, pkg.QueueDepthPolicy(max_replicas=3),
                            reqs, cfg=c.to_router_config(),
                            traffic_name="cal")
        both.append((router.run(), router))
    assert both[0][0].time_model == "calibrated"
    _assert_same(stacks, both)


def test_calibrate_fits_the_fastest_sample_of_each_shape(stacks,
                                                        monkeypatch):
    """``launch.serve.calibrate(repeats=)`` measures every shape
    ``repeats`` times and fits the fastest sample of each."""
    rng = np.random.default_rng(5)
    runs = [[dataclasses.replace(s, seconds=s.seconds * (1 + rng.random()))
             for s in _samples(pr)] for _ in range(3)]
    calls = iter(runs)
    monkeypatch.setattr(serve, "measure_round_samples",
                        lambda *a, **kw: next(calls))
    cal = serve.calibrate(stacks["engine"], stacks["params"], repeats=3,
                          path=None, source="test")
    fastest = [min(shape, key=lambda s: s.seconds) for shape in zip(*runs)]
    assert cal == pr.fit_round_model(fastest, backend="cpu", device_count=1,
                                     source="test")


def test_measure_round_samples_on_the_engine(stacks):
    samples = pr.measure_round_samples(stacks["engine"], stacks["params"],
                                       slot_counts=(1, 2),
                                       prompt_lens=(8, 16), n_steps=2,
                                       max_len=40)
    assert [s.source for s in samples] == [
        "measured:prefill_b4_s8", "measured:prefill_b4_s16",
        "measured:decode_step_b1", "measured:decode_step_b2"]
    assert all(s.seconds > 0 for s in samples)
    assert [(s.prefill_tokens, s.active_slots) for s in samples] == \
        [(32, 0), (64, 0), (0, 1), (0, 2)]


# ---------------------------------------------------------------------------
# launch.serve's online modes on the CPU
# ---------------------------------------------------------------------------


def test_serve_router_mode_runs_every_default_policy():
    out = serve.main(["--router", "--device", "cpu", "--horizon", "1.5"])
    assert sorted(out) == sorted(POLICIES)
    for s in out.values():
        assert s["n_completed"] == s["n_submitted"] > 0
        assert s["time_model"] == "modeled"


def test_serve_calibrate_then_route_on_the_artifact(tmp_path):
    path = str(tmp_path / "cal.json")
    out = serve.main(["--calibrate", "--device", "cpu", "--calibration",
                      path])
    cal = pr.CalibratedLatencyModel.load(path)
    assert out["calibration"] == cal.to_json()
    assert cal.backend == "cpu" and cal.n_samples == 6
    runs = serve.main(["--router", "--device", "cpu", "--calibration",
                       path, "--horizon", "1.0"])
    assert {s["time_model"] for s in runs.values()} == {"calibrated"}


def test_serve_http_mode_serves_drains_and_traces(tmp_path, capsys):
    trace = tmp_path / "trace.jsonl"
    out = serve.main(["--http", "--port", "0", "--device", "cpu",
                      "--serve-seconds", "0.5", "--trace", str(trace)])
    assert out["port"] > 0 and out["report"]["n_submitted"] == 0
    events = [json.loads(line) for line in trace.read_text().splitlines()]
    assert [e["event"] for e in events][:1] == ["replica_start"]
    assert "== serving on http://127.0.0.1:" in capsys.readouterr().out


def test_serve_one_rank_seq_shard_mesh_runs():
    out = serve.main(["--router", "--device", "cpu", "--horizon", "1.0",
                      "--mesh", "1x1", "--seq-shard"])
    assert all(s["n_completed"] == s["n_submitted"] for s in out.values())


@pytest.mark.parametrize("argv,match", [
    (["--router", "--mesh", "1x2", "--seq-shard"], "serve_cluster --ranks"),
    (["--router", "--mesh", "1x1"], "--seq-shard"),
    (["--router", "--mesh-slices", "2"], "Queue 1 #4.3"),
    (["--batch-dag"], "next slice"),
    (["--mesh", "1x1", "--seq-shard"], "--router, --calibrate and --http"),
])
def test_serve_modes_not_ported_raise(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(argv + ["--device", "cpu"])


def test_serve_defaults_to_the_card():
    for fn in (serve.run_router, serve.run_http, serve.lm_engine):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
