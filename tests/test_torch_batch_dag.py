"""The port's batch DAG (``repro_torch.batch``) against the reference.

Every case of ``tests/test_batch_dag.py`` runs here on the port with the
same constants (N, PROMPT, NEW, SHARD_SIZE, SLOTS, MAXLEN), and wherever
a case makes DAG runs, the same run is made in the reference on the same
params (``models.convert.from_reference``) and ``make_dataset`` seed:

  * SUMMARIES AND TIMELINES EQUAL — ``DagReport.summary()`` (wall, busy
    and cost by group and stage, attempts, preemptions, spawns, rows,
    tokens, ``compile_count``, duplicate commits, ``digest``) and the
    whole timeline equal the reference's, for the monolithic and parallel
    runs, every rung of the chaos ladder, a spot mix and all-spot. Round
    times are modeled from token counts, so nothing here is a tolerance;
    the port's engine is the launch path's (``attn_impl="pallas"``, whose
    CPU tensors take the kernels' plain versions) and its greedy tokens
    equal the reference's ``xla`` path's on these inputs (no bf16
    near-tie parts them, so ``digest`` is equal too). Both packages count
    four shape buckets: ``compile_count`` is equal.
  * THE SCHEDULER IN LOCKSTEP — hypothesis drives the port's and the
    reference's ``TaskDag`` through the same random pops and preemptions
    (the laws of ``tests/test_property_invariants.py``): equal states,
    attempts and backoffs at every step.
  * THE ENTRY POINT — ``launch.serve --batch-dag --chaos --device cpu``
    prints identical outputs and parity OK.
"""
import json
import os
import subprocess
import sys
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import SRC
from repro import batch as jbatch
from repro import core as jcore
from repro import obs as jobs
from repro import router as jrouter
from repro.batch import dag as jdag
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.router import cloud as jcloud
from repro.router import events as jevents
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import batch as pbatch
from repro_torch import core as pcore
from repro_torch import obs as pobs
from repro_torch import router as prouter
from repro_torch.batch import dag as pdag
from repro_torch.launch import serve
from repro_torch.models import RunConfig, build
from repro_torch.router import cloud as pcloud
from repro_torch.router import events as pevents
from repro_torch.serving import ContinuousBatcher, Engine, Request
from test_torch_decode import qwen  # noqa: F401

N, PROMPT, NEW, SHARD_SIZE, SLOTS, MAXLEN = 12, 8, 4, 4, 2, 16
STAGES = (pdag.SHARD, pdag.PREFILL, pdag.DECODE, pdag.REDUCE)


@pytest.fixture(scope="module")
def sides(qwen):  # noqa: F811
    """One namespace per package: its modules, engine, params, data."""
    vocab = qwen["cfg"].vocab_size
    port = types.SimpleNamespace(
        batch=pbatch, core=pcore, obs=pobs, router=prouter, cloud=pcloud,
        events=pevents, Batcher=ContinuousBatcher, Request=Request,
        engine=Engine(build(qwen["cfg"]),
                      RunConfig(attn_impl="pallas", cache_pad=8),
                      device="cpu"),
        params=qwen["params"],
        data=pbatch.make_dataset(N, prompt_len=PROMPT, vocab=vocab,
                                 max_new_tokens=NEW, seed=0))
    ref = types.SimpleNamespace(
        batch=jbatch, core=jcore, obs=jobs, router=jrouter, cloud=jcloud,
        events=jevents, Batcher=JBatcher, Request=JRequest,
        engine=JEngine(jbuild(qwen["jcfg"]), JRunConfig(cache_pad=8)),
        params=qwen["jparams"],
        data=jbatch.make_dataset(N, prompt_len=PROMPT, vocab=vocab,
                                 max_new_tokens=NEW, seed=0))
    return {"port": port, "ref": ref}


def _cfg(s):
    return s.router.ReplicaConfig(n_slots=SLOTS, max_len=MAXLEN)


def _run(s, kills=None, workers=3, mono=False, groups=None, obs=None,
         clock=None, placement=None):
    """The reference test's ``_run`` for either package ``s``."""
    kills = kills or {}
    dag = s.batch.inference_dag(N, N if mono else SHARD_SIZE)
    if groups is None:
        groups = [s.batch.make_group(s.engine, s.params, s.cloud.ON_DEMAND,
                                     1 if mono else workers, cfg=_cfg(s),
                                     extra_kills=kills.get(0, ()))]
    runner = s.batch.BatchDagRunner(
        dag, s.data, groups, clock=clock or s.events.VirtualClock(),
        store=s.core.ArtifactStore(), task_overhead_s=0.02, obs=obs,
        placement=placement or s.batch.PlacementPolicy())
    return runner, runner.run()


def _assert_same(rep, jrep):
    """The port's report equals the reference's: summary, outputs and the
    whole timeline."""
    assert rep.summary() == jrep.summary()
    assert rep.outputs == jrep.outputs
    assert rep.timeline == jrep.timeline


def _both(sides, fn):
    """``fn(package)`` on the port, then on the reference."""
    return fn(sides["port"]), fn(sides["ref"])


# ---------------------------------------------------------------------------
# DAG validation + transitions
# ---------------------------------------------------------------------------


def test_dag_validation_raises():
    with pytest.raises(ValueError, match="duplicate"):
        pbatch.TaskDag([pbatch.TaskSpec("a", "s"), pbatch.TaskSpec("a", "s")])
    with pytest.raises(ValueError, match="unknown"):
        pbatch.TaskDag([pbatch.TaskSpec("a", "s", deps=("ghost",))])
    with pytest.raises(ValueError, match="cycle"):
        pbatch.TaskDag([pbatch.TaskSpec("a", "s", deps=("b",)),
                        pbatch.TaskSpec("b", "s", deps=("a",))])
    with pytest.raises(ValueError):
        pbatch.inference_dag(0, 4)


def test_dag_transitions_are_guarded():
    dag = pbatch.TaskDag([pbatch.TaskSpec("a", "s"),
                          pbatch.TaskSpec("b", "s", deps=("a",))])
    with pytest.raises(ValueError, match="not ready"):
        dag.start("b", 0.0)
    dag.ready(0.0)
    dag.start("a", 0.0)
    with pytest.raises(ValueError, match="not running"):
        dag.complete("b", 0.0)
    dag.complete("a", 0.0)
    with pytest.raises(ValueError, match="not running"):
        dag.complete("a", 0.0)
    with pytest.raises(ValueError, match="not running"):
        dag.preempt("a", 0.0)


def test_inference_dag_shape():
    dag = pbatch.inference_dag(10, 4)
    stages = [t.stage for t in dag.tasks.values()]
    assert stages.count(pdag.SHARD) == 1 and stages.count(pdag.REDUCE) == 1
    assert stages.count(pdag.PREFILL) == 3 and stages.count(pdag.DECODE) == 3
    assert dag.tasks["reduce"].deps == ("decode/0", "decode/1", "decode/2")
    assert dag.tasks["decode/2"].payload == (8, 10)
    want = jbatch.inference_dag(10, 4)
    assert [(t.task_id, t.stage, t.deps, t.payload)
            for t in dag.tasks.values()] == [
        (t.task_id, t.stage, t.deps, t.payload) for t in want.tasks.values()]


# ---------------------------------------------------------------------------
# FaultInjector: round-keyed vs time-keyed schedules
# ---------------------------------------------------------------------------


def test_injector_round_and_time_keyed_equivalence_pure():
    fi = pcore.FaultInjector
    d, t0 = 0.8, 12.25
    by_round = fi(crash_rounds=((5, 3),))
    by_time = fi(crash_at_s=((5, t0 + 0.5 * d),))
    ra = by_round.perturb(5, 3, d, now=t0)
    rb = by_time.perturb(5, 3, d, now=t0)
    assert ra == (0.5 * d, True)
    assert rb[1] and rb[0] == pytest.approx(0.5 * d)
    assert by_round.perturb(5, 4, d, now=t0 + d) == (d, False)
    assert by_time.perturb(5, 4, d, now=t0 + d) == (d, False)
    assert by_round.n_crashes == by_time.n_crashes == 1
    inj = fi(max_crashes=0, crash_rounds=((1, 1),), crash_at_s=((2, 0.5),))
    assert inj.perturb(1, 1, 1.0) == (0.5, True)
    assert inj.perturb(2, 1, 1.0, now=0.0) == (0.5, True)
    inj2 = fi(crash_at_s=((0, 0.5),))
    assert inj2.perturb(0, 1, 1.0) == (1.0, False)
    # the same schedule in the reference gives the same answers
    jrb = jcore.FaultInjector(crash_at_s=((5, t0 + 0.5 * d),))
    assert jrb.perturb(5, 3, d, now=t0) == rb


def _skeleton(report):
    return [(e["kind"], e.get("task"), e.get("stage"))
            for e in report.timeline]


def test_round_vs_time_keyed_schedule_same_round_identical(sides):
    def case(s):
        _, base = _run(s)
        ev = next(e for e in base.timeline
                  if e["kind"] == "round" and e["stage"] == pdag.DECODE)
        g, w = ev["worker"]
        assert g == 0
        round_idx = sum(1 for e in base.timeline
                        if e["kind"] == "round" and e["worker"] == [g, w]
                        and e["t"] <= ev["t"] + 1e-12)

        def run_with(inj):
            pool = s.router.ReplicaPool(s.engine, s.params, _cfg(s),
                                        injector=inj,
                                        profile=s.cloud.ON_DEMAND)
            groups = [s.batch.WorkerGroup(s.cloud.ON_DEMAND, pool, 3)]
            return _run(s, groups=groups)[1]

        a = run_with(s.core.FaultInjector(crash_rounds=((w, round_idx),)))
        b = run_with(s.core.FaultInjector(
            crash_at_s=((w, ev["t"] + 0.5 * ev["round_s"]),)))
        assert a.n_preemptions == b.n_preemptions == 1
        assert a.digest == b.digest == base.digest
        assert _skeleton(a) == _skeleton(b)
        assert a.wall_s == pytest.approx(b.wall_s, abs=1e-6)
        assert a.busy_s == pytest.approx(b.busy_s, abs=1e-6)
        return base, a, b

    for got, want in zip(*_both(sides, case)):
        _assert_same(got, want)


# ---------------------------------------------------------------------------
# Chaos parity
# ---------------------------------------------------------------------------


def test_chaos_ladder_any_kill_prefix_reproduces_outputs(sides):
    def case(s):
        reports, kills = s.batch.chaos_ladder(
            lambda k: _run(s, kills=k)[1])
        base = reports[0]
        assert len(kills) == 4
        for k, rep in enumerate(reports):
            assert rep.n_preemptions == k
            assert rep.digest == base.digest
            assert rep.n_duplicate_commits == 0
            assert rep.attempts_total == base.attempts_total + k
            assert rep.n_rows == N
            assert rep.compile_count == base.compile_count
            if k:
                assert rep.n_spawns > base.n_spawns
        killed = set()
        for rep in reports[1:]:
            killed.update(e["stage"] for e in rep.timeline
                          if e["kind"] == "round" and e["crashed"])
        assert killed == set(STAGES)
        return reports, kills

    (reports, kills), (jreports, jkills) = _both(sides, case)
    assert kills == jkills
    assert len(reports) == len(jreports) == 5
    for rep, jrep in zip(reports, jreports):
        _assert_same(rep, jrep)


def test_preempted_rows_requeued_exactly_once(sides):
    def case(s):
        _, base = _run(s)
        stage, kill = s.batch.next_boundary_kill(
            base.timeline, -1.0, {pdag.SHARD, pdag.PREFILL, pdag.REDUCE})
        assert stage == pdag.DECODE
        killed_task = next(e["task"] for e in base.timeline
                           if e["kind"] == "round"
                           and e["stage"] == pdag.DECODE
                           and e["worker"] == [kill[0], kill[1]])
        runner, rep = _run(s, kills=s.batch.kills_by_group([kill]))
        assert rep.n_preemptions == 1 and rep.digest == base.digest
        for task_id, rows in runner._rows.items():
            want = 1 if task_id == killed_task else 0
            assert all(q.n_retries == want for q in rows), task_id
            assert all(q.done and len(q.generated) == NEW for q in rows)
        assert runner.dag.tasks[killed_task].attempts == 2
        assert runner.dag.tasks[killed_task].preemptions == 1
        return rep, {t: [q.n_retries for q in rows]
                     for t, rows in runner._rows.items()}

    (rep, retries), (jrep, jretries) = _both(sides, case)
    _assert_same(rep, jrep)
    assert retries == jretries


# ---------------------------------------------------------------------------
# Cloud profiles + heterogeneous placement
# ---------------------------------------------------------------------------


def test_cloud_profile_validation_and_determinism():
    with pytest.raises(ValueError, match="never preempted"):
        pcloud.CloudProfile(kind="on_demand", preempt_rate_per_s=0.1)
    with pytest.raises(ValueError, match="unknown cloud kind"):
        pcloud.CloudProfile(kind="gpu_spot")
    sp = pcloud.spot_profile(preempt_rate_per_s=2.0, seed=7)
    a, b = sp.kill_times(3, 5.0), sp.kill_times(3, 5.0)
    assert a == b and a == sorted(a)
    assert all(0.0 < t < 5.0 for t in a)
    assert sp.kill_times(4, 5.0) != a
    assert pcloud.ON_DEMAND.kill_times(0, 100.0) == []
    assert sp.price_per_replica_s(848.0) == pytest.approx(
        0.3 * pcloud.ON_DEMAND.price_per_replica_s(848.0))
    cs = [sp.cold_start(i) for i in range(4)]
    assert cs == [sp.cold_start(i) for i in range(4)]
    assert all(sp.cold_start_s <= c < sp.cold_start_s + 0.2 for c in cs)
    jsp = jcloud.spot_profile(preempt_rate_per_s=2.0, seed=7)
    assert a == jsp.kill_times(3, 5.0)
    assert cs == [jsp.cold_start(i) for i in range(4)]


def test_spot_mix_and_all_spot_reproduce_on_demand_outputs(sides):
    def case(s):
        _, base = _run(s)
        sp = s.cloud.spot_profile(preempt_rate_per_s=0.3, seed=3)
        mixed = [s.batch.make_group(s.engine, s.params, s.cloud.ON_DEMAND,
                                    1, cfg=_cfg(s)),
                 s.batch.make_group(s.engine, s.params, sp, 2, cfg=_cfg(s))]
        _, rep_mix = _run(s, groups=mixed)
        assert rep_mix.digest == base.digest
        allspot = [s.batch.make_group(s.engine, s.params, sp, 3,
                                      cfg=_cfg(s))]
        _, rep_spot = _run(s, groups=allspot)
        assert rep_spot.digest == base.digest
        assert rep_spot.cost_by_group.keys() == {"spot"}
        assert (rep_spot.cost_usd / rep_spot.busy_s) == pytest.approx(
            0.3 * base.cost_usd / base.busy_s)
        return base, rep_mix, rep_spot

    for got, want in zip(*_both(sides, case)):
        _assert_same(got, want)


def test_placement_pins_to_on_demand_after_repeated_preemptions(sides):
    s = sides["port"]
    groups = [pbatch.make_group(s.engine, s.params, pcloud.ON_DEMAND, 1,
                                cfg=_cfg(s)),
              pbatch.make_group(s.engine, s.params,
                                pcloud.spot_profile(seed=1), 1,
                                cfg=_cfg(s))]
    pol = pbatch.PlacementPolicy(pin_to_on_demand_after=2)
    task = pbatch.TaskSpec("t", pdag.DECODE)
    assert pol.eligible(task, groups) == [1, 0]
    task.preemptions = 2
    assert pol.eligible(task, groups) == [0]
    assert pol.eligible(task, groups[1:]) == [0]


# ---------------------------------------------------------------------------
# Conservation: monolithic vs parallel
# ---------------------------------------------------------------------------


def test_monolithic_vs_parallel_same_outputs_same_busy_seconds(sides):
    def case(s):
        _, mono = _run(s, mono=True)
        _, par = _run(s)
        assert par.digest == mono.digest
        assert par.wall_s < mono.wall_s / 1.5
        assert par.busy_s == pytest.approx(mono.busy_s, rel=0.10)
        assert par.n_tokens == mono.n_tokens == N * NEW
        return mono, par

    for got, want in zip(*_both(sides, case)):
        _assert_same(got, want)


# ---------------------------------------------------------------------------
# serving: whole-shard admission
# ---------------------------------------------------------------------------


def test_submit_many_matches_sequential_submit(sides):
    def case(s):
        def reqs():
            return [s.Request(rid=i, prompt=s.data.tokens[i],
                              max_new_tokens=NEW) for i in range(6)]

        one = s.Batcher(s.engine, s.params, n_slots=SLOTS, max_len=MAXLEN,
                        batched=True)
        for q in reqs():
            one.submit(q)
        many = s.Batcher(s.engine, s.params, n_slots=SLOTS, max_len=MAXLEN,
                         batched=True)
        assert many.submit_many(reqs()) == 6
        a = {q.rid: q.generated for q in one.run()}
        b = {q.rid: q.generated for q in many.run()}
        assert a == b
        return a

    got, want = _both(sides, case)
    assert got == want


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------


def test_dag_metrics_register_lint_and_match_report(sides):
    def case(s):
        obs = s.obs.Observability()
        kill = s.batch.next_boundary_kill(
            _run(s)[1].timeline, -1.0,
            {pdag.SHARD, pdag.PREFILL, pdag.REDUCE})[1]
        _, rep = _run(s, kills=s.batch.kills_by_group([kill]), obs=obs)
        text = obs.registry.render()
        assert s.obs.lint_prometheus(text) == []
        for name in ("repro_dag_tasks", "repro_preemptions_total",
                     "repro_dag_stage_seconds_total"):
            assert name in text
        assert obs.m_preemptions.value() == rep.n_preemptions == 1
        assert obs.m_dag_tasks.value(state=pdag.DONE) == rep.n_tasks
        assert obs.m_dag_tasks.value(state=pdag.READY) == 0
        stage_sum = sum(obs.m_stage_s.value(stage=st_) for st_ in STAGES)
        assert stage_sum == pytest.approx(rep.busy_s)
        assert obs.m_crashes.value() == 1
        assert obs.m_cold_starts.value() == rep.n_spawns
        return rep, text

    (rep, text), (jrep, jtext) = _both(sides, case)
    _assert_same(rep, jrep)
    # the same Prometheus text, but for the series that count each
    # package's own shape buckets
    def keep(t):
        return [ln for ln in t.splitlines() if "compile" not in ln]
    assert keep(text) == keep(jtext)


def test_obs_on_off_bit_identical_for_dag_runner(sides):
    def case(s):
        _, off = _run(s)
        obs = s.obs.Observability(tracer=s.obs.TraceRecorder())
        _, on = _run(s, obs=obs)
        assert on.digest == off.digest
        assert on.wall_s == off.wall_s and on.busy_s == off.busy_s
        assert on.timeline == off.timeline
        assert on.outputs == off.outputs
        obs2 = s.obs.Observability(tracer=s.obs.TraceRecorder())
        _run(s, obs=obs2)

        def dump(tr):
            return "\n".join(json.dumps(e, sort_keys=True)
                             for e in tr.events)
        assert dump(obs.tracer) == dump(obs2.tracer)
        return on, dump(obs.tracer)

    (rep, trace), (jrep, jtrace) = _both(sides, case)
    _assert_same(rep, jrep)
    assert trace == jtrace


# ---------------------------------------------------------------------------
# WallClock smoke
# ---------------------------------------------------------------------------


def test_wallclock_smoke_same_digest(sides):
    def case(s):
        warm = s.cloud.CloudProfile(name="local", cold_start_s=0.0)
        groups = [s.batch.make_group(s.engine, s.params, warm, 3,
                                     cfg=_cfg(s))]
        _, base = _run(s)
        _, rep = _run(s, groups=groups, clock=s.events.WallClock())
        assert rep.digest == base.digest
        assert rep.n_rows == N and rep.wall_s > 0.0
        return rep.digest

    got, want = _both(sides, case)
    assert got == want


# ---------------------------------------------------------------------------
# The scheduler in lockstep with the reference's
# ---------------------------------------------------------------------------


def _random_dags(data, n):
    """The same random acyclic graph in both packages."""
    specs = []
    for i in range(n):
        deps = ()
        if i:
            k = data.draw(st.integers(0, min(i, 3)), label=f"ndeps[{i}]")
            deps = tuple(
                f"t{d}" for d in data.draw(
                    st.lists(st.integers(0, i - 1), min_size=k,
                             max_size=k, unique=True),
                    label=f"deps[{i}]"))
        specs.append((f"t{i}", deps))
    return (pdag.TaskDag([pdag.TaskSpec(t, "stage", deps=d)
                          for t, d in specs], retry_backoff_s=0.25),
            jdag.TaskDag([jdag.TaskSpec(t, "stage", deps=d)
                          for t, d in specs], retry_backoff_s=0.25))


def _state(dag):
    return [(tid, t.state, t.attempts, t.preemptions, t.retry_at,
             t.started_t, t.finished_t) for tid, t in dag.tasks.items()]


@given(data=st.data())
@settings(deadline=None, max_examples=50)
def test_dag_lockstep_with_reference_under_random_pops_and_kills(data):
    """The reference's three laws (partition, topological order,
    exactly-once commits) on the port's scheduler, and the port's state
    equal to the reference's after every transition of one random
    script of pops and preemptions."""
    n = data.draw(st.integers(1, 12), label="n")
    dag, jd = _random_dags(data, n)
    store = pcore.ArtifactStore()
    now, accepted, duplicates = 0.0, 0, 0
    completed_order = []
    for _ in range(10_000):
        counts = dag.counts()
        assert counts == jd.counts()
        assert set(counts) == set(pdag.STATES)
        assert sum(counts.values()) == n
        if dag.all_done:
            break
        ready = dag.ready(now)
        assert [t.task_id for t in ready] == [t.task_id
                                              for t in jd.ready(now)]
        if not ready:
            nxt = dag.next_retry_t()
            assert nxt == jd.next_retry_t()
            assert nxt is not None and counts[pdag.PREEMPTED] > 0
            now = max(now, nxt)
            continue
        pick = data.draw(st.sampled_from(sorted(t.task_id for t in ready)),
                         label="pick")
        dag.start(pick, now)
        jd.start(pick, now)
        if (dag.tasks[pick].preemptions < 2
                and data.draw(st.booleans(), label="kill")):
            dag.preempt(pick, now)
            jd.preempt(pick, now)
            assert _state(dag) == _state(jd)
            now += 1e-3
            continue
        assert all(dag.tasks[d].state == pdag.DONE
                   for d in dag.tasks[pick].deps)
        if store.put(pick, b"contribution", overwrite=False):
            accepted += 1
        else:
            duplicates += 1
        dag.complete(pick, now)
        jd.complete(pick, now)
        assert _state(dag) == _state(jd)
        completed_order.append(pick)
        now += 1e-3
    assert dag.all_done and jd.all_done
    assert accepted == n and duplicates == 0
    pos = {tid: i for i, tid in enumerate(completed_order)}
    for t in dag.tasks.values():
        assert t.attempts == t.preemptions + 1
        for d in t.deps:
            assert pos[d] < pos[t.task_id]


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


def test_batch_dag_entry_point_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--batch-dag",
         "--chaos", "--device", "cpu", "--dag-items", "24"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "outputs identical" in out.stdout
    assert "parity=OK" in out.stdout
    assert "preemptions per rung [0, 1, 2, 3, 4]" in out.stdout


def test_run_batch_dag_equals_reference_cli_summaries(sides, qwen):  # noqa
    """``run_batch_dag`` at the CLI's defaults but smaller: its mono,
    parallel (two of six workers spot) and chaos summaries equal the
    reference's ``run_batch_dag`` on the same params."""
    import argparse

    from repro.launch import serve as jserve

    # a fresh engine: compile_count counts the buckets one engine saw
    engine = Engine(build(qwen["cfg"]),
                    RunConfig(attn_impl="pallas", cache_pad=8), device="cpu")
    kw = dict(dag_items=16, dag_shard_size=4, dag_workers=4,
              spot_workers=2, preempt_rate=0.25, prompt_len=PROMPT,
              max_new_tokens=NEW, n_slots=SLOTS, per_token_s=0.02)
    out = serve.run_batch_dag(qwen["cfg"], engine=engine,
                              params=sides["port"].params, chaos=True, **kw)
    # the reference builds its own engine from the seed: the same params
    # as the port's (qwen's fixture inits the reference at key 0)
    args = argparse.Namespace(router_arch="qwen2-7b", seed=0, chaos=True,
                              **kw)
    want = jserve.run_batch_dag(args)
    assert out["outputs_identical"] and want["outputs_identical"]
    assert out["mono"] == want["mono"] and out["par"] == want["par"]
    assert out["chaos"]["kills"] == want["chaos"]["kills"]
    assert out["chaos"]["parity"] and want["chaos"]["parity"]
