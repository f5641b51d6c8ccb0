"""Tensor-parallel params and a data axis on gloo ranks, against the JAX
reference on the same host mesh (CPU).

The reference runs in one subprocess over 4 host devices
(``--xla_force_host_platform_device_count``), GSPMD laying out its params
by its planner; the port runs the same layouts as 2 and 4 gloo processes
(``launch.mesh.spawn_ranks``, one spawn per world size, every layout in
turn), each rank holding its shard (``Engine.shard_params``):

* smoke qwen2-7b through ``ContinuousBatcher`` on (1, 2), (1, 4), (2, 1),
  (2, 2) and (2, 2) with ``seq_shard``: greedy streams equal the
  reference's up to near-ties (``_assert_parted_at_near_ties``, the
  ``NEAR_TIE`` rule of ``test_torch_decode``) and first-round logits
  within ``LOGIT_REL_TOL``; every rank's streams are equal. On (1, 4) the
  planner cuts the 4 q heads but not the 2 kv heads: each rank's q head
  reads its kv head of a whole cache.
* smoke qwen2-moe: the scatter dispatch on (2, 1), grouped per data shard
  (a (4, 8) prefill: 32 tokens, two groups of 16) and falling back to one
  group (a (2, 3) prefill: 6 tokens), and the expert split on (1, 2).
* smoke distilbert-imdb: the offline job of ``launch.serve`` on (2, 2)
  (``run_offline`` fed the reference's params) against the reference's
  mesh classifier and its printed report; and ``launch.serve --mesh 2x2``
  itself, spawning its ranks, against the one-rank command.
"""
import os
import pickle
import re
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC, run_in_subprocess
from repro import configs as jconfigs
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.convert import from_reference
from test_torch_decode import LOGIT_REL_TOL, NEAR_TIE

RANK_TIMEOUT_S = 240
QWEN = [((1, 2), False), ((1, 4), False), ((2, 1), False), ((2, 2), False),
        ((2, 2), True)]
ARCHS = {"qwen": "qwen2-7b", "moe": "qwen2-moe-a2.7b",
         "distilbert": "distilbert-imdb"}
N_ITEMS, BATCH = 64, 16


def _jobs():
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, 256, n).tolist(), m)
                for n, m in [(8, 5), (16, 6), (8, 4), (16, 5), (8, 6),
                             (16, 4)]]
    prefill = [rng.integers(0, 256, (4, 8)).tolist()]
    jobs = [dict(kind="lm", arch="qwen", shape=s, seq=q,
                 name=f"qwen{s}{'seq' if q else ''}", prefill=prefill)
            for s, q in QWEN]
    jobs += [dict(kind="lm", arch="moe", shape=(2, 1), moe_impl="scatter",
                  name="moe(2, 1)", prefill=prefill + [
                      rng.integers(0, 256, (2, 3)).tolist()]),
             dict(kind="lm", arch="moe", shape=(1, 2), name="moe(1, 2)",
                  prefill=prefill),
             dict(kind="clf", arch="distilbert", shape=(2, 2),
                  name="distilbert(2, 2)")]
    return jobs, requests


_JAX = """
import contextlib, io, pickle
import jax, numpy as np
from repro import configs
from repro.data import imdb_reviews
from repro.launch import serve
from repro.models import RunConfig, build
from repro.serving import ContinuousBatcher, Engine, Request
spec = pickle.load(open(%(spec)r, "rb"))
out = {}
for job in spec["jobs"]:
    shape = tuple(job["shape"])
    cfg = configs.smoke(spec["archs"][job["arch"]])
    model = build(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    if job["kind"] == "lm":
        eng = Engine(model, RunConfig(cache_pad=56, moe_impl=job.get(
            "moe_impl", "auto")), mesh=mesh, seq_shard=job.get("seq", False))
        sp = eng.shard_params(params)
        b = ContinuousBatcher(eng, sp, n_slots=4, max_len=64)
        reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=n)
                for i, (p, n) in enumerate(spec["requests"])]
        b.submit_many(reqs)
        b.run()
        res = {"streams": [[int(t) for t in r.generated] for r in reqs],
               "logits": [np.asarray(eng.prefill(sp, np.asarray(
                   t, np.int32))[0], np.float32) for t in job["prefill"]]}
    else:
        eng = Engine(model, RunConfig(), mesh=mesh)
        sp = eng.shard_params(params)
        tokens, _ = imdb_reviews(n=spec["n_items"], seq_len=64,
                                 vocab=cfg.vocab_size, seed=0)
        n = spec["batch"]
        res = {"logits": np.concatenate([np.asarray(eng.classify_logits(
            sp, tokens[i:i + n]), np.float32)
            for i in range(0, len(tokens), n)])}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--mesh", "x".join(map(str, shape)), "--n-items",
                        str(spec["n_items"]), "--batch-size", str(n)])
        res["report"] = buf.getvalue()
    out[job["name"]] = res
pickle.dump(out, open(%(out)r, "wb"))
"""

_RANK = """
import json, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_from_env, make_host_mesh, rank_env
init_from_env("cpu")
rank, world = rank_env()
from repro_torch import configs
from repro_torch.data import imdb_reviews
from repro_torch.dist import collectives
from repro_torch.launch import serve
from repro_torch.models import RunConfig, build
from repro_torch.serving import ContinuousBatcher, Engine, Request
spec = pickle.load(open(sys.argv[1], "rb"))
out = {}
for job in spec["jobs"]:
    shape = tuple(job["shape"])
    if int(np.prod(shape)) != world:
        continue
    mesh = make_host_mesh(shape)
    cfg = configs.smoke(spec["archs"][job["arch"]])
    params = torch.load(spec["params"][job["arch"]])
    collectives.reset_stats()
    if job["kind"] == "lm":
        eng = Engine(build(cfg), RunConfig(cache_pad=56, attn_impl="pallas",
                                           moe_impl=job.get("moe_impl",
                                                            "auto")),
                     device="cpu", mesh=mesh, seq_shard=job.get("seq", False))
        sp = eng.shard_params(params)
        b = ContinuousBatcher(eng, sp, n_slots=4, max_len=64)
        reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=n)
                for i, (p, n) in enumerate(spec["requests"])]
        b.submit_many(reqs)
        b.run()
        res = {"streams": [r.generated for r in reqs],
               "block": list(b.cache.layers[0]["k"].shape),
               "logits": [eng.prefill(sp, np.asarray(t))[0].float().numpy()
                          for t in job["prefill"]]}
    else:
        res = serve.run_offline(cfg, params=params, mesh=mesh, device="cpu",
                                n_items=spec["n_items"],
                                batch_size=spec["batch"])
        eng, sp = res["engine"], res["params"]
        tokens, _ = imdb_reviews(n=spec["n_items"], seq_len=64,
                                 vocab=cfg.vocab_size, seed=0)
        n = spec["batch"]
        res = {"predictions": res["predictions"].tolist(),
               "accuracy": res["accuracy"],
               "logits": np.concatenate([eng.classify_logits(
                   sp, tokens[i:i + n]) for i in range(0, len(tokens), n)])}
    res["stats"] = {k: v[0] for k, v in collectives.STATS.items()}
    out[job["name"]] = res
pickle.dump(out, open(spec["out"] + f"/{world}-rank{rank}.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, {rank-count: [each rank's results]}) of every
    job, the reference's and the port's ranks run once for the module."""
    tmp = tmp_path_factory.mktemp("tp")
    jobs, requests = _jobs()
    params = {}
    for key, arch in ARCHS.items():
        jparams = jax.jit(jbuild(jconfigs.smoke(arch)).init)(
            jax.random.PRNGKey(0))
        params[key] = str(tmp / f"{key}.pt")
        torch.save(from_reference(
            jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
            configs.smoke(arch), device="cpu"), params[key])
    spec = dict(jobs=jobs, requests=requests, archs=ARCHS, params=params,
                n_items=N_ITEMS, batch=BATCH, out=str(tmp))
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    run_in_subprocess(textwrap.dedent(_JAX % dict(
        spec=str(tmp / "spec.pkl"), out=str(tmp / "jax.pkl"))),
        n_devices=4)
    with open(tmp / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    (tmp / "rank.py").write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    got = {}
    for world in (2, 4):
        done = spawn_ranks([str(tmp / "rank.py"), str(tmp / "spec.pkl")],
                           world, store_path=str(tmp / f"store{world}"),
                           timeout=RANK_TIMEOUT_S, env=env)
        failed = [(r, p.returncode, p.stderr[-3000:])
                  for r, p in enumerate(done) if p.returncode]
        assert not failed, failed
        assert all("backend gloo" in p.stdout for p in done)
        got[world] = []
        for r in range(world):
            with open(tmp / f"{world}-rank{r}.pkl", "rb") as f:
                got[world].append(pickle.load(f))
    return want, got, requests


@pytest.fixture(scope="module")
def references():
    out = {}
    for key, arch in ARCHS.items():
        jcfg = jconfigs.smoke(arch)
        out[key] = (jcfg, jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0)))
    return out


_forward = jax.jit(jtransformer.forward, static_argnums=(0, 1))


def _assert_parted_at_near_ties(jcfg, jparams, prompts, want, got) -> int:
    """Equal token for token, or parted where both tokens lie within
    ``NEAR_TIE`` of the reference's best logit; at most a third part."""
    parted = 0
    for prompt, a, b in zip(prompts, want, got):
        assert len(a) == len(b)
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        seq = np.concatenate([np.asarray(prompt), a[:i]])[None]
        logits = np.asarray(_forward(jcfg, JRunConfig(), jparams, tokens=(
            jnp.asarray(seq, jnp.int32)))[0], np.float32)[0, -1]
        gaps = (logits.max() - logits[a[i]], logits.max() - logits[b[i]])
        assert max(gaps) <= NEAR_TIE, (i, a[i], b[i], gaps)
        parted += 1
    assert parted <= len(want) // 3, f"{parted} of {len(want)} parted"
    return parted


def _logits_close(got, want):
    np.testing.assert_allclose(got, want,
                               atol=LOGIT_REL_TOL * np.abs(want).max())


def _ranks(got, name, shape):
    ranks = got[int(np.prod(shape))]
    res = [r[name] for r in ranks]
    for r in res[1:]:  # every rank hands back the whole batch's results
        if "streams" in r:
            assert r["streams"] == res[0]["streams"]
        for a, b in zip(r["logits"], res[0]["logits"]):
            np.testing.assert_array_equal(a, b)
    return res


@pytest.mark.parametrize("shape,seq", QWEN, ids=lambda x: str(x))
def test_qwen_layouts_match_jax_on_the_same_mesh(runs, references, shape,
                                                 seq):
    want, got, requests = runs
    name = f"qwen{shape}{'seq' if seq else ''}"
    res = _ranks(got, name, shape)
    jcfg, jparams = references["qwen"]
    _assert_parted_at_near_ties(jcfg, jparams, [p for p, _ in requests],
                                want[name]["streams"], res[0]["streams"])
    _logits_close(res[0]["logits"][0], want[name]["logits"][0])
    d, m = shape
    cfg = configs.smoke("qwen2-7b")
    kv = (cfg.n_kv_heads if seq or cfg.n_kv_heads % m
          else cfg.n_kv_heads // m)
    t = 64 // m if seq else 64
    assert res[0]["block"] == [4 // d, t, kv, cfg.head_dim]
    stats = res[0]["stats"]
    if m > 1 and not seq:  # wo and w2 a layer, a vocab-split head gathered
        assert stats["all_reduce"] > 0 and stats["all_gather_model"] > 0
    if d > 1:
        assert stats["all_gather_data"] > 0 and stats["broadcast"] > 0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=str)
def test_moe_dispatch_matches_jax_on_the_same_mesh(runs, references, shape):
    want, got, requests = runs
    name = f"moe{shape}"
    res = _ranks(got, name, shape)
    jcfg, jparams = references["moe"]
    _assert_parted_at_near_ties(jcfg, jparams, [p for p, _ in requests],
                                want[name]["streams"], res[0]["streams"])
    # (2, 1): the grouped (4, 8) prefill and the one-group (2, 3) fallback
    for g, w in zip(res[0]["logits"], want[name]["logits"]):
        _logits_close(g, w)
    if shape == (1, 2):  # the router's expert blocks gathered
        assert res[0]["stats"]["all_gather_model"] > 0


def test_distilbert_offline_job_matches_jax_on_a_2x2_mesh(runs):
    want, got, _ = runs
    name = "distilbert(2, 2)"
    res = _ranks(got, name, (2, 2))
    logits, ref = res[0]["logits"], want[name]["logits"]
    _logits_close(logits, ref)
    margin = np.abs(ref[:, 0] - ref[:, 1])
    flips = np.argmax(logits, -1) != np.argmax(ref, -1)
    assert (margin[flips] <= NEAR_TIE).all()
    np.testing.assert_array_equal(res[0]["predictions"],
                                  np.argmax(logits, -1))
    acc = float(re.search(r"acc=([0-9.]+)", want[name]["report"]).group(1))
    assert abs(res[0]["accuracy"] - acc) <= flips.mean() + 1e-3
    assert "4 chunks" in want[name]["report"]


def test_serve_mesh_2x2_spawns_ranks_and_equals_one_rank(capsys):
    argv = ["--device", "cpu", "--n-items", str(N_ITEMS), "--batch-size",
            str(BATCH)]
    mesh = serve.main(argv + ["--mesh", "2x2"], rank_timeout=RANK_TIMEOUT_S)
    printed = capsys.readouterr().out
    assert "rank 0 of 4: process group backend gloo" in printed
    assert "predictions merged exactly-once" in printed
    one = serve.main(argv)
    assert mesh["predictions"] == one["predictions"].tolist()
    assert mesh["accuracy"] == one["accuracy"]
    assert mesh["par"]["n_invocations"] == one["par"]["n_invocations"]
