"""Replicas on disjoint mesh slices: ``SlicePool`` and
``ReplicaPool(mesh_slices=)``, against the reference's (CPU).

* Bookkeeping (``SlicePool``, one process): a third acquire of two
  slices returns None, a double release raises, a freed slice is
  reused, a meshless template gives ``n`` meshless engines; and a
  ``Router`` over ``ReplicaPool(mesh_slices=2)`` on a meshless engine
  equals the reference's run (summaries, stamps, streams).
* Four gloo ranks (``launch.mesh.spawn_ranks``), a ("data", "model")
  mesh of (2, 2) and of (4, 1), each cut into 2 slices ((1, 2) and
  (2, 1) slices; the second needs a "data" group of its own), a
  ``Router`` over ``ReplicaPool(mesh_slices=2)`` with
  ``QueueDepthPolicy(max_replicas=8)`` on a burst of requests, against
  the reference's ``ReplicaPool(mesh_slices=2)`` on a JAX host mesh of
  the same shape (4 host devices) with the same params and requests:
  ``n_completed``, ``n_slices``, ``peak_replicas`` (at most 2), the
  summaries and the greedy streams equal the reference's (streams up to
  the near-ties of ``test_torch_decode``); the report is equal on every
  rank; no slice is held by two live replicas at once (the reference's
  ``_assert_slice_lifetimes_disjoint``); every slice is free at the end;
  ``compile_count`` stays flat over three scale-to-0 / scale-up cycles.
  The same run under the measured clock finishes with equal reports on
  every rank.
"""
import os
import pickle
import textwrap

import numpy as np
import pytest
import torch

from conftest import SRC, run_in_subprocess
from repro import router as jr
from repro.core import LatencyModel as JLatencyModel
from repro_torch import router as pr
from repro_torch.core import LatencyModel
from repro_torch.launch.mesh import spawn_ranks
from test_torch_decode import _assert_streams_match, qwen  # noqa: F401
from test_torch_router import stacks  # noqa: F401

RANK_TIMEOUT_S = 120
PROMPT, NEW, SLOTS, MAXLEN = 8, 4, 2, 16
LAT = dict(cold_start_s=0.3, per_item_s=0.05)
SHAPES = [(2, 2), (4, 1)]
N_REQUESTS = 12


def _assert_slice_lifetimes_disjoint(spans):
    """No slice may be held by two replicas with overlapping lifetimes;
    ``spans`` lists each replica's (slice, spawn_t, retire_t)."""
    by_slice = {}
    for idx, start, end in spans:
        assert idx is not None
        by_slice.setdefault(idx, []).append(
            (start, float("inf") if end is None else end))
    for s in by_slice.values():
        s.sort()
        for (s0, e0), (s1, e1) in zip(s, s[1:]):
            assert e0 <= s1 + 1e-9, "slice held by two live replicas"


def test_slice_pool_bookkeeping(stacks):  # noqa: F811
    sp = pr.SlicePool(stacks["engine"], stacks["params"], 2)
    a, b = sp.acquire(), sp.acquire()
    assert {a, b} == {0, 1} and sp.held() == [0, 1]
    assert sp.acquire() is None          # at capacity
    sp.release(a)
    with pytest.raises(ValueError, match="released"):
        sp.release(a)                    # a double release is a fault
    assert sp.acquire() == a             # a freed slice is reused
    engines = [sp.engine_for(i)[0] for i in (0, 1)]
    assert all(e.mesh is None for e in engines)
    assert engines[0] is not engines[1] is not stacks["engine"]
    assert sp.engine_for(0)[0] is engines[0]  # built once
    assert sp.devices_of(0) == [] and sp.member(1)


def _run(stacks, port: bool, arrivals, n_slices=2):  # noqa: F811
    pkg = pr if port else jr
    engine = stacks["engine"] if port else stacks["jengine"]
    params = stacks["params"] if port else stacks["jparams"]
    pool = pkg.ReplicaPool(engine, params,
                           pkg.ReplicaConfig(n_slots=SLOTS, max_len=MAXLEN),
                           lat=(LatencyModel if port else JLatencyModel)(
                               **LAT), mesh_slices=n_slices)
    reqs = pkg.make_requests(arrivals, prompt_len=PROMPT, max_new_tokens=NEW,
                             vocab=stacks["cfg"].vocab_size, seed=0)
    router = pkg.Router(pool, pkg.QueueDepthPolicy(max_replicas=8), reqs,
                        traffic_name="test")
    return router.run(), router, pool


def test_meshless_slices_equal_reference(stacks):  # noqa: F811
    arrivals = np.concatenate([np.zeros(8), np.full(4, 2.0)])
    (rep, router, pool), (jrep, jrouter, _) = [
        _run(stacks, port, arrivals) for port in (True, False)]
    assert rep.summary() == jrep.summary()
    assert rep.n_slices == 2 and rep.peak_replicas <= 2
    assert pool.slices.held() == []
    _assert_slice_lifetimes_disjoint(
        [(r.slice_idx, r.spawn_t, r.retire_t) for r in pool.replicas])
    got = {r.rid: r for r in router.completed}
    want = {r.rid: r for r in jrouter.completed}
    assert sorted(got) == sorted(want)
    rids = sorted(want)
    _assert_streams_match(stacks, [want[i].prompt for i in rids],
                          [want[i].generated for i in rids],
                          [got[i].generated for i in rids])


_JAX = """
import pickle
import jax, numpy as np
from repro import configs
from repro.core import LatencyModel
from repro.models import RunConfig, build
from repro.router import (QueueDepthPolicy, ReplicaConfig, ReplicaPool,
                          Router, make_requests)
from repro.serving import Engine
spec = pickle.load(open(%(spec)r, "rb"))
cfg = configs.smoke("qwen2-7b")
model = build(cfg)
params = jax.jit(model.init)(jax.random.PRNGKey(0))
out = {}
for shape in spec["shapes"]:
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    engine = Engine(model, RunConfig(cache_pad=8), mesh=mesh)
    pool = ReplicaPool(engine, params, ReplicaConfig(
        n_slots=spec["slots"], max_len=spec["max_len"]),
        lat=LatencyModel(**spec["lat"]), mesh_slices=2)
    reqs = make_requests(spec["arrivals"], prompt_len=spec["prompt"],
                         max_new_tokens=spec["new"], vocab=cfg.vocab_size,
                         seed=0)
    router = Router(pool, QueueDepthPolicy(max_replicas=8), reqs,
                    traffic_name="test")
    rep = router.run()
    out[shape] = {"summary": rep.summary(), "n_slices": rep.n_slices,
                  "streams": {r.rid: (list(map(int, r.prompt)),
                                      [int(t) for t in r.generated])
                              for r in router.completed}}
pickle.dump(out, open(%(out)r, "wb"))
"""

_RANK = """
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_from_env, make_host_mesh, rank_env
init_from_env("cpu")
rank, world = rank_env()
from repro_torch import configs
from repro_torch.core import LatencyModel
from repro_torch.models import RunConfig, build
from repro_torch.router import (QueueDepthPolicy, ReplicaConfig, ReplicaPool,
                                Router, make_requests)
from repro_torch.serving import Engine, Request
spec = pickle.load(open(sys.argv[1], "rb"))
cfg = configs.smoke("qwen2-7b")
params = torch.load(spec["params"])
out = {}


def run(engine, measured=False):
    lat = dict(spec["lat"], per_item_s=None) if measured else spec["lat"]
    pool = ReplicaPool(engine, params, ReplicaConfig(
        n_slots=spec["slots"], max_len=spec["max_len"]),
        lat=LatencyModel(**lat), mesh_slices=2)
    reqs = make_requests(spec["arrivals"], prompt_len=spec["prompt"],
                         max_new_tokens=spec["new"], vocab=cfg.vocab_size,
                         seed=0)
    router = Router(pool, QueueDepthPolicy(max_replicas=8), reqs,
                    traffic_name="test")
    rep = router.run()
    return {"summary": rep.summary(), "n_slices": rep.n_slices,
            "peak": rep.peak_replicas, "held": pool.slices.held(),
            "spans": [(r.slice_idx, r.spawn_t, r.retire_t)
                      for r in pool.replicas],
            "computes": [r.computes for r in pool.replicas],
            "streams": {r.rid: [int(t) for t in r.generated]
                        for r in router.completed}}


def churn(engine):
    # three scale-up -> drain cycles: each slice's engine built once
    pool = ReplicaPool(engine, params, ReplicaConfig(
        n_slots=spec["slots"], max_len=spec["max_len"]),
        lat=LatencyModel(**spec["lat"]), mesh_slices=2)
    counts = []
    for cycle in range(3):
        now = float(cycle * 10)
        pool.scale_to(2, now)
        pool.poll_ready(now + 1.0)
        for i, r in enumerate(pool.ready()):
            r.batcher.submit(Request(cycle * 10 + i,
                                     np.ones(spec["prompt"], np.int32),
                                     max_new_tokens=spec["new"]))
            while r.n_inflight:
                r.step()
        counts.append(pool.slices.compile_count())
        pool.scale_to(0, now + 9.0)
    return {"counts": counts, "held": pool.slices.held()}


for shape in spec["shapes"]:
    mesh = make_host_mesh(shape)
    engine = Engine(build(cfg), RunConfig(cache_pad=8, attn_impl="pallas"),
                    device="cpu", mesh=mesh)
    out[shape] = {"modeled": run(engine), "measured": run(engine, True),
                  "churn": churn(engine)}
pickle.dump(out, open(spec["out"] + f"/rank{rank}.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, qwen):  # noqa: F811
    """(reference results, each rank's results) by mesh shape."""
    tmp = tmp_path_factory.mktemp("slices")
    torch.save(qwen["params"], tmp / "params.pt")
    spec = dict(shapes=SHAPES, slots=SLOTS, max_len=MAXLEN, lat=LAT,
                prompt=PROMPT, new=NEW, arrivals=np.zeros(N_REQUESTS),
                params=str(tmp / "params.pt"), out=str(tmp))
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    run_in_subprocess(textwrap.dedent(_JAX % dict(
        spec=str(tmp / "spec.pkl"), out=str(tmp / "jax.pkl"))),
        n_devices=4)
    with open(tmp / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    (tmp / "rank.py").write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    done = spawn_ranks([str(tmp / "rank.py"), str(tmp / "spec.pkl")], 4,
                       store_path=str(tmp / "store"),
                       timeout=RANK_TIMEOUT_S, env=env)
    failed = [(r, p.returncode, p.stderr[-3000:])
              for r, p in enumerate(done) if p.returncode]
    assert not failed, failed
    got = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return want, got


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_slices_on_gloo_ranks_equal_reference(runs, qwen, shape):  # noqa: F811
    want, got = runs
    ref = want[shape]
    res = [g[shape]["modeled"] for g in got]
    for r in res[1:]:  # every rank reports the same run
        assert r["summary"] == res[0]["summary"]
        assert r["streams"] == res[0]["streams"]
        assert r["spans"] == res[0]["spans"]
    mine = res[0]
    assert mine["summary"] == ref["summary"]
    assert mine["n_slices"] == ref["n_slices"] == 2
    assert mine["summary"]["n_completed"] == N_REQUESTS
    assert mine["peak"] <= 2
    assert all(r["held"] == [] for r in res)
    _assert_slice_lifetimes_disjoint(mine["spans"])
    # each rank computed the replicas of its own slice only, and both
    # slices served
    for rank, r in enumerate(res):  # slice 0 holds ranks 0 and 1
        assert all(c == (s == (0 if rank < 2 else 1))
                   for c, (s, _, _) in zip(r["computes"], r["spans"]))
    assert {s for s, _, _ in mine["spans"]} == {0, 1}
    rids = sorted(ref["streams"])
    assert sorted(mine["streams"]) == rids
    _assert_streams_match(qwen, [ref["streams"][i][0] for i in rids],
                          [ref["streams"][i][1] for i in rids],
                          [mine["streams"][i] for i in rids])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_slice_churn_keeps_compile_counts_flat(runs, shape):
    _, got = runs
    for g in got:
        counts = g[shape]["churn"]["counts"]
        assert counts[0] > 0 and counts[1:] == [counts[0]] * 2, counts
        assert g[shape]["churn"]["held"] == []


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_measured_clock_on_slices_agrees_on_every_rank(runs, shape):
    _, got = runs
    res = [g[shape]["measured"] for g in got]
    for r in res[1:]:
        assert r["summary"] == res[0]["summary"]
        assert r["streams"] == res[0]["streams"]
    summary = res[0]["summary"]
    assert summary["time_model"] == "measured"
    assert summary["n_completed"] == N_REQUESTS
