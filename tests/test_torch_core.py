"""Port's orchestration, store, data and offline driver against the reference.

The reference's core is numpy-only apart from its store; run on the same
inputs, the port must give the same reports field for field, the same data
token for token, and the same predictions as the reference's
``Engine.classify`` (except at documented near-ties of the bf16 logits).
Two subprocess tests pin what the port imports: no jax, no ml_dtypes and
nothing of ``repro``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro import data as jdata
from repro.data.pipeline import DatasetRef as JDatasetRef
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.serving import Engine as JEngine
from repro_torch import configs, core, data
from repro_torch.core.store import ArtifactStore
from repro_torch.launch.serve import run_offline
from repro_torch.models.convert import from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE = 0.05  # as in test_torch_models.py: bf16 logit gap


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def smoke():
    """Smoke distilbert-imdb: JAX params and the same params in the port."""
    jcfg = jconfigs.smoke("distilbert-imdb")
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), jparams)
    cfg = configs.smoke("distilbert-imdb")
    return jcfg, jparams, cfg, from_reference(params_np, cfg, device="cpu")


def _run_python(code: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


# ---------------------------------------------------------------------------
# What the port imports
# ---------------------------------------------------------------------------


def test_port_imports_no_jax_and_nothing_of_repro():
    out = _run_python("""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
assert not bad, bad
print(len(names))
""")
    assert int(out.split()[-1]) >= 25  # every module of the port was loaded


def test_store_round_trips_bf16_tree_without_ml_dtypes():
    _run_python("""
import sys, torch
from repro_torch.core.store import ArtifactStore
g = torch.Generator().manual_seed(0)
tree = {"w": torch.randn(3, 4, generator=g).bfloat16(),
        "blocks": ({"b": torch.randn(5, generator=g)},
                   [torch.arange(4, dtype=torch.int32), torch.tensor(2.5)])}
store = ArtifactStore()
store.put_tree("params", tree)
back = store.get_tree("params")
assert isinstance(back["blocks"], tuple) and isinstance(back["blocks"][1],
                                                        list)
pairs = [(tree["w"], back["w"]),
         (tree["blocks"][0]["b"], back["blocks"][0]["b"]),
         (tree["blocks"][1][0], back["blocks"][1][0]),
         (tree["blocks"][1][1], back["blocks"][1][1])]
for a, b in pairs:
    assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
    assert torch.equal(a, b)
assert "ml_dtypes" not in sys.modules
""")


def test_store_spills_to_disk_and_commits_first_writer(tmp_path):
    store = ArtifactStore(root=str(tmp_path))
    assert store.put("job/x/result/0", b"a", overwrite=False)
    assert not store.put("job/x/result/0", b"b", overwrite=False)
    store.put_tree("models/m", {"w": torch.ones(2, dtype=torch.bfloat16)})
    fresh = ArtifactStore(root=str(tmp_path))
    assert fresh.get("job/x/result/0") == b"a"
    assert torch.equal(fresh.get_tree("models/m")["w"],
                       torch.ones(2, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# Data and orchestration parity
# ---------------------------------------------------------------------------


def test_data_matches_reference():
    for kw in (dict(n=40, seq_len=16, vocab=256, seed=3),
               dict(n=7, seq_len=64, vocab=30_522, seed=0)):
        for a, b in zip(data.imdb_reviews(**kw), jdata.imdb_reviews(**kw)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(data.lm_tokens(500, 97, seed=2),
                                  jdata.lm_tokens(500, 97, seed=2))
    assert data.chunk_ranges(103, 25) == jdata.chunk_ranges(103, 25)


def _reports(pkg, dataset_ref, per_item_s, fault_kw, orch_kw):
    """Monolithic + parallel reports of one modeled job through ``pkg``."""
    job = pkg.BatchJob("t", dataset_ref("d", 900, 16, 100), "", 50)
    chunks = pkg.decompose(job)
    lat = pkg.LatencyModel(cold_start_s=0.5, per_item_s=per_item_s)
    reports = []
    for seed, runner in (
            (5, lambda st, inj: pkg.MonolithicRunner(
                st, pkg.MonolithicConfig(function_budget_s=60.0),
                injector=inj)),
            (6, lambda st, inj: pkg.Orchestrator(
                st, pkg.OrchestratorConfig(**orch_kw), injector=inj))):
        store = pkg.ArtifactStore()
        reports.append(runner(store, pkg.FaultInjector(seed=seed, **fault_kw))
                       .run(job, chunks, lambda i, st=store:
                            pkg.ServerlessFunction(i, st, lat)))
    return reports


@pytest.mark.parametrize("fault_kw", [
    {},
    {"crash_prob": 0.25, "straggler_prob": 0.2},
], ids=["no-faults", "crashes-and-stragglers"])
def test_modeled_reports_match_reference(fault_kw):
    orch_kw = dict(max_concurrency=6, retry_max_attempts=8,
                   speculation_factor=2.0)
    want = _reports(jcore, JDatasetRef, 0.05, fault_kw, orch_kw)
    got = _reports(core, data.DatasetRef, 0.05, fault_kw, orch_kw)
    for g, w in zip(got, want):
        assert g.summary() == w.summary()
        assert g.extra == w.extra
        assert [(t.chunk.chunk_id, t.attempt, t.start_time, t.finish_time,
                 t.billed_s) for t in g.tasks] == [
            (t.chunk.chunk_id, t.attempt, t.start_time, t.finish_time,
             t.billed_s) for t in w.tasks]


# ---------------------------------------------------------------------------
# The offline driver (the slice end to end)
# ---------------------------------------------------------------------------

OFFLINE = dict(n_items=96, seq_len=32, batch_size=16, concurrency=4,
               crash_prob=0.2, straggler_prob=0.2, seed=0)


def _reference_offline(per_item_s, params_blob):
    """``repro.launch.serve``'s offline flow (serve.py:433-482) with the
    reference's own classes, modeled compute, and a store holding the
    port's params blob (the modeled load time is bytes / bandwidth)."""
    o = OFFLINE
    tokens, _ = jdata.imdb_reviews(n=o["n_items"], seq_len=o["seq_len"],
                                   vocab=256, seed=o["seed"])
    job = jcore.BatchJob("serve", JDatasetRef("imdb", o["n_items"],
                                              o["seq_len"], 256),
                         "models/clf", o["batch_size"])
    chunks = jcore.decompose(job)
    lat = jcore.LatencyModel(cold_start_s=0.2, per_item_s=per_item_s)
    summaries = []
    for runner_seed, make_runner in (
            (o["seed"], lambda st, inj: jcore.MonolithicRunner(
                st, jcore.MonolithicConfig(), injector=inj)),
            (o["seed"] + 1, lambda st, inj: jcore.Orchestrator(
                st, jcore.OrchestratorConfig(
                    max_concurrency=o["concurrency"], retry_max_attempts=6,
                    speculation_factor=3.0), injector=inj))):
        store = jcore.ArtifactStore()
        store.put("models/clf", params_blob)
        inj = jcore.FaultInjector(seed=runner_seed,
                                  crash_prob=o["crash_prob"],
                                  straggler_prob=o["straggler_prob"])
        report = make_runner(store, inj).run(
            job, chunks, lambda i, st=store: jcore.ServerlessFunction(
                i, st, lat, params_ref="models/clf"),
            data={"tokens": tokens})
        summaries.append(report.summary())
    return summaries


def test_run_offline_modeled_summaries_match_reference(smoke):
    _, _, cfg, params = smoke
    out = run_offline(cfg, device="cpu", params=params, per_item_s=0.01,
                      **OFFLINE)
    blob_store = ArtifactStore()
    blob_store.put_tree("models/clf", out["params"])
    mono, par = _reference_offline(0.01, blob_store.get("models/clf"))
    assert out["mono"] == mono
    assert out["par"] == par
    assert "predictions" not in out  # modeled compute predicts nothing


def test_run_offline_predictions_match_reference_engine(smoke):
    jcfg, jparams, cfg, params = smoke
    out = run_offline(cfg, device="cpu", params=params, **OFFLINE)
    preds = out["predictions"]
    np.testing.assert_array_equal(preds, out["mono_predictions"])
    assert out["par"]["n_crashes"] > 0  # retries really ran
    engine = out["engine"]
    assert engine.compile_count == 1 and engine.warm
    tokens, labels = data.imdb_reviews(n=OFFLINE["n_items"],
                                       seq_len=OFFLINE["seq_len"],
                                       vocab=cfg.vocab_size, seed=0)
    np.testing.assert_array_equal(out["labels"], labels)
    ref_engine = JEngine(jbuild(jcfg), JRunConfig())
    ref_logits = ref_engine.classify_logits(jparams, tokens)
    ref_preds = ref_logits.argmax(-1)
    gap = np.abs(ref_logits[:, 0] - ref_logits[:, 1])
    decided = gap >= NEAR_TIE
    np.testing.assert_array_equal(preds[decided], ref_preds[decided])
    assert decided.mean() > 0.8
    assert all(w.params["embed"].device.type == "cpu"
               for w in out["workers"])
