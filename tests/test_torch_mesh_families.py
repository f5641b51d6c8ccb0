"""SSM and encoder-decoder models under a mesh, on gloo ranks, against the
JAX reference on the same host mesh (CPU).

The reference runs in one subprocess over 4 host devices
(``--xla_force_host_platform_device_count``), GSPMD laying out its params
by its planner; the port runs the same layouts as one 2-rank and one
4-rank spawn (``launch.mesh.spawn_ranks``), each rank holding its shard:

* whisper-base (smoke) under "tp" on (2, 1), (1, 2) and (2, 2) and under
  "fsdp_tp" on (2, 2); mamba2-130m under "tp" on (1, 2) and "fsdp_tp" on
  (2, 2); jamba under "tp" on (1, 2), at smoke width and one period of
  its pattern (8 layers: attention, SSM, dense and MoE; the smoke config
  has two, and the reference compiles each).
* Serving, through ``Engine`` and ``ContinuousBatcher`` (whisper's
  requests carry their frame embeddings, encoded at admission): greedy
  streams equal the reference's token for token, the whole batch's
  prefill logits within LOGIT_RTOL, every rank's streams equal, and each
  rank's param bytes equal to the planner's count. The reference's
  engine cannot take frame embeddings, so whisper's reference streams are
  its model's prefill and decode steps, jitted over params laid out on
  the same mesh; mamba2's and jamba's are its engine and batcher on the
  mesh.
* Training: one AdamW step against the reference's loss and grads on the
  same mesh: loss and grad norm within LOSS_RTOL, every grad leaf
  gathered whole within GRAD_RTOL relative RMS (a leaf whose true grad is
  zero but for rounding, against the tree's RMS); where the reference's
  own one-device and mesh steps, or the port's one rank and the
  reference's one device, already part by more, within NOISE times that
  spread (``_training``: whisper's grad norm and jamba's grads).
* Planted faults that must break the training bounds: an SSM's per-head
  leaves gathered with the "model" blocks in the wrong order
  (``ssm_heads_swapped``, mamba2 on (1, 2)), and a rank's cross-attention
  heads read in the wrong order (``cross_heads_permuted``, whisper on
  (1, 2)).

Both packages compute in fp32 (``jnp.bfloat16`` and ``torch.bfloat16``
read as fp32, as ``test_torch_families._fp32_everywhere`` does): the
smoke whisper and jamba amplify bf16 rounding by 16-123% RMS, past any
useful bound, while a mesh's split is exact up to fp32 summation order.
The params stay as drawn (bf16 leaves hold the reference's bf16 values).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from conftest import SRC
from repro import configs as jconfigs
from repro.models import build as jbuild
from repro_torch import configs
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.convert import from_reference
from repro_torch.tree import tree_leaves_with_path
from test_torch_train_families import _port_grads

RANK_TIMEOUT_S = 120
REF_TIMEOUT_S = 600
LOGIT_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
NOISE = 2
ROWS, SEQ, FRAMES = 4, 16, 12
MAX_LEN = 32
ARCHS = {"whisper": "whisper-base", "mamba": "mamba2-130m",
         "jamba": "jamba-1.5-large-398b"}
# (name, arch, mesh, strategy): each served and trained
JOBS = [("whisper-tp(2, 1)", "whisper", (2, 1), "tp"),
        ("whisper-tp(1, 2)", "whisper", (1, 2), "tp"),
        ("whisper-tp(2, 2)", "whisper", (2, 2), "tp"),
        ("whisper-fsdp_tp(2, 2)", "whisper", (2, 2), "fsdp_tp"),
        ("mamba-tp(1, 2)", "mamba", (1, 2), "tp"),
        ("mamba-fsdp_tp(2, 2)", "mamba", (2, 2), "fsdp_tp"),
        ("jamba-tp(1, 2)", "jamba", (1, 2), "tp")]
# arch key -> layers, where the smoke config is cut further
LAYERS = {"jamba": 8}
# fault -> the job it is planted in (training only)
FAULTS = {"ssm_heads_swapped": "mamba-tp(1, 2)",
          "cross_heads_permuted": "whisper-tp(1, 2)"}


def smoke(pkg, key):
    """``pkg.configs.smoke`` of ``ARCHS[key]``, cut to ``LAYERS``."""
    cfg = pkg.smoke(ARCHS[key])
    if key in LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=LAYERS[key])
    return cfg


def _inputs(cfg):
    """The training batch, the served requests (prompts of one SSD chunk,
    8 tokens: one shape bucket a reference engine compiles) and the
    prefill batch, numpy, from seeds."""
    rng = np.random.default_rng(1)
    t = rng.integers(0, cfg.vocab_size, (ROWS, SEQ + 1)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    frames = None
    if cfg.encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (ROWS, FRAMES, cfg.enc_d_model)).astype(np.float32)
        frames = rng.standard_normal(
            (6, FRAMES, cfg.enc_d_model)).astype(np.float32)
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, 256, 8).tolist(), m)
                for m in (5, 6, 4, 5, 6, 4)]
    prefill = np.random.default_rng(2).integers(0, 256, (ROWS, 8))
    return batch, requests, frames, prefill.tolist()


_JAX = """
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.dist import context as dctx, sharding as shd
from repro.models import RunConfig, build
from repro.serving import ContinuousBatcher, Engine, Request
from repro.training.train_step import make_loss_fn
spec = pickle.load(open(%(spec)r, "rb"))
out = {}

def smoke(key):
    cfg = configs.smoke(spec["archs"][key])
    if key in spec["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"][key])
    return cfg

def f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x,
                        tree)

def npy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)

bf16 = jnp.bfloat16

def step_grads(model, params, batch):
    (_, m), grads = jax.jit(jax.value_and_grad(
        make_loss_fn(model, RunConfig()), has_aux=True))(params, batch)
    grads = npy(grads)
    return {"grads": grads, "metrics": {
        "loss": float(m["loss"]), "grad_norm": float(np.sqrt(sum(
            np.sum(g.astype(np.float64) ** 2)
            for g in jax.tree.leaves(grads))))}}

for arch in spec["archs"]:  # each model on one device
    model = build(smoke(arch))
    params = f32(jax.jit(model.init)(jax.random.PRNGKey(0)))
    jnp.bfloat16 = jnp.float32
    jax.clear_caches()
    out["one:" + arch] = step_grads(model, params, {
        k: jnp.asarray(v) for k, v in spec["inputs"][arch]["batch"].items()})
    jnp.bfloat16 = bf16
    jax.clear_caches()
for name, arch, shape, strategy in spec["jobs"]:
    cfg = smoke(arch)
    model = build(cfg)
    params = f32(jax.jit(model.init)(jax.random.PRNGKey(0)))
    jnp.bfloat16 = jnp.float32
    jax.clear_caches()
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    inp = spec["inputs"][arch]
    res = {}
    with dctx.mesh_context(mesh):
        p_sh = shd.param_shardings(model.param_specs, strategy, mesh)
        sp = jax.device_put(params, p_sh)
        # serving
        if cfg.encdec:  # every request at once: one prefill, then
            # greedy decode steps (the prompts share their length)
            run = RunConfig()
            b = {"enc_embeds": jnp.asarray(inp["frames"]),
                 "tokens": jnp.asarray([p for p, _ in inp["requests"]],
                                       jnp.int32)}
            logits, cache = jax.jit(lambda p, b: model.prefill(
                run, p, b, max_len=spec["max_len"]))(sp, b)
            step = jax.jit(lambda p, c, t: model.decode_step(
                run, p, c, {"token": t}))
            toks = [np.asarray(jnp.argmax(logits, -1))]
            for _ in range(max(n for _, n in inp["requests"]) - 1):
                out_, cache = step(sp, cache, jnp.asarray(toks[-1][:, None]))
                toks.append(np.asarray(jnp.argmax(out_, -1)))
            streams = [[int(t[i]) for t in toks[:n]]
                       for i, (_, n) in enumerate(inp["requests"])]
        else:
            eng = Engine(model, RunConfig(cache_pad=8), mesh=mesh,
                         strategy=strategy)
            esp = eng.shard_params(params)
            bat = ContinuousBatcher(eng, esp, n_slots=4,
                                    max_len=spec["max_len"])
            reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=n)
                    for i, (p, n) in enumerate(inp["requests"])]
            bat.submit_many(reqs)
            bat.run()
            streams = [[int(t) for t in r.generated] for r in reqs]
            logits = eng.prefill(esp, np.asarray(inp["prefill"],
                                                 np.int32))[0]
        res["streams"] = streams
        res["logits"] = np.asarray(logits, np.float32)
        # the grads and grad norm of one step
        batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
        batch = jax.device_put(batch, shd.input_shardings(batch, mesh))
        res.update(step_grads(model, sp, batch))
    jnp.bfloat16 = bf16
    jax.clear_caches()
    out[name] = res
pickle.dump(out, open(%(out)r, "wb"))
"""

_RANK = """
import dataclasses, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_from_env, make_host_mesh, rank_env
init_from_env("cpu")
rank, world = rank_env()
from repro_torch import configs
from repro_torch.dist import collectives, sharding as shd, context as dctx
from repro_torch.models import RunConfig, attention, build, ssm
from repro_torch.serving import ContinuousBatcher, Engine, Request
from repro_torch.training import optimizer, train_step
from repro_torch.tree import tree_leaves, tree_map, tree_map_multi
spec = pickle.load(open(sys.argv[1], "rb"))
BF16 = torch.bfloat16


class Recording:
    # the optimizer, keeping the grads of the first update
    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, shardings=None):
        if self.grads is None:
            self.grads = grads
        return self.opt.update(grads, state, params, shardings=shardings)


def planted(fault):
    # a patch that breaks the layout as ``fault`` says, and its undoing
    if fault == "ssm_heads_swapped":  # the two "model" blocks swapped
        whole = ssm._whole_heads
        def swapped(sc, d, p):
            h = sc.n_heads(d)
            return dict(whole(sc, d, p), **{
                k: whole(sc, d, p)[k].roll(h // 2, dims=-1)
                for k in ssm._HEAD_LEAVES})
        ssm._whole_heads = swapped
        return lambda: setattr(ssm, "_whole_heads", whole)
    if fault == "cross_heads_permuted":
        kv = attention.cross_kv
        attention.cross_kv = lambda cfg, p, enc: tuple(
            t.flip(-2) for t in kv(cfg, p, enc))
        return lambda: setattr(attention, "cross_kv", kv)
    return lambda: None


def serve(model, mesh, strategy, params, inp):
    eng = Engine(model, RunConfig(cache_pad=8, attn_impl="pallas"),
                 device="cpu", mesh=mesh, strategy=strategy)
    sp = eng.shard_params(params)
    frames = inp["frames"]
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=n,
                    enc_embeds=None if frames is None else frames[i])
            for i, (p, n) in enumerate(inp["requests"])]
    b = ContinuousBatcher(eng, sp, n_slots=4, max_len=spec["max_len"])
    b.submit_many(reqs)
    b.run()
    if frames is None:
        logits = eng.prefill(sp, np.asarray(inp["prefill"]))[0]
    else:  # the requests' own batch, as the reference's streams start
        logits = eng.prefill(sp, np.asarray([p for p, _ in inp["requests"]]),
                             max_len=spec["max_len"], enc_embeds=frames)[0]
    return {"streams": [r.generated for r in reqs],
            "logits": logits.float().numpy(),
            "bytes": sum(t.numel() * t.element_size()
                         for t in tree_leaves(sp)),
            "planned": shd.rank_param_bytes(eng.model.param_specs,
                                            strategy, mesh)}


def train(model, mesh, strategy, params, inp, fault=None):
    # one step on the mesh, or on this rank alone (mesh None)
    sh = (None if mesh is None else
          shd.param_shardings(model.param_specs, strategy, mesh))
    local = tree_map_multi(lambda t, s: s.slice(t).float().clone(),
                           params, sh) if sh else tree_map(
                               lambda t: t.float(), params)
    rec = Recording(optimizer.AdamW(schedule=optimizer.constant(1e-3)))
    undo = planted(fault)
    try:
        step = train_step.make_train_step(model, RunConfig(), rec,
                                          mesh=mesh, strategy=strategy)
        _, _, m = step(local, rec.init(local), inp["batch"])
    finally:
        undo()
    grads = tree_map(lambda t: t.float().numpy(), rec.grads)
    if sh:
        with dctx.mesh_context(mesh):
            grads = tree_map_multi(
                lambda t, s: collectives.whole(t, s).float().numpy(),
                rec.grads, sh)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": grads}


out = {}
# the params and specs before bf16 reads as fp32 (a spec built under it
# would count a bf16 leaf's bytes as fp32)
params = {k: torch.load(v) for k, v in spec["params"].items()}
def smoke(key):
    cfg = configs.smoke(spec["archs"][key])
    if key in spec["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"][key])
    return cfg


models = {k: build(smoke(k)) for k in spec["archs"]}
torch.bfloat16 = torch.float32
if world == 2 and rank == 0:  # each model's step on one rank
    for arch in spec["archs"]:
        out[f"one:{arch}"] = train(models[arch], None, None, params[arch],
                                   spec["inputs"][arch])
for name, arch, shape, strategy in spec["jobs"]:
    if int(np.prod(shape)) != world:
        continue
    mesh = make_host_mesh(tuple(shape))
    inp = spec["inputs"][arch]
    collectives.reset_stats()
    out[name] = serve(models[arch], mesh, strategy, params[arch], inp)
    out[name]["stats"] = {k: v[0] for k, v in collectives.STATS.items()}
    out[name].update(train(models[arch], mesh, strategy, params[arch], inp))
    for fault, job in spec["faults"].items():
        if job == name:
            out[f"{name}:{fault}"] = train(models[arch], mesh, strategy,
                                           params[arch], inp, fault)
torch.bfloat16 = BF16
pickle.dump(out, open(spec["out"] + f"/{world}-rank{rank}.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, {job: [each rank's results]}), run once for
    the module."""
    tmp = tmp_path_factory.mktemp("mesh_families")
    params, inputs = {}, {}
    for key in ARCHS:
        cfg = smoke(configs, key)
        jparams = jax.jit(jbuild(smoke(jconfigs, key)).init)(
            jax.random.PRNGKey(0))
        params[key] = str(tmp / f"{key}.pt")
        torch.save(from_reference(
            jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
            cfg, device="cpu"), params[key])
        batch, requests, frames, prefill = _inputs(cfg)
        inputs[key] = dict(batch=batch, requests=requests, frames=frames,
                           prefill=prefill)
    spec = dict(jobs=JOBS, archs=ARCHS, layers=LAYERS, params=params,
                inputs=inputs, faults=FAULTS, max_len=MAX_LEN, out=str(tmp))
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    # the reference's subprocess runs while the port's ranks do
    jax_env = dict(os.environ, PYTHONPATH=SRC, XLA_FLAGS=os.environ.get(
        "XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX % dict(
            spec=str(tmp / "spec.pkl"), out=str(tmp / "jax.pkl")))],
        env=jax_env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    (tmp / "rank.py").write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    got = {}
    for world in (2, 4):
        done = spawn_ranks([str(tmp / "rank.py"), str(tmp / "spec.pkl")],
                           world, store_path=str(tmp / f"store{world}"),
                           timeout=RANK_TIMEOUT_S, env=env)
        failed = [(r, p.returncode, p.stderr[-3000:])
                  for r, p in enumerate(done) if p.returncode]
        if failed:
            ref.kill()
        assert not failed, failed
        ranks = []
        for r in range(world):
            with open(tmp / f"{world}-rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        for name in ranks[0]:
            got[name] = [x[name] for x in ranks if name in x]
    try:
        _, err = ref.communicate(timeout=REF_TIMEOUT_S)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    return want, got


def _rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _step(res, cfg, reference: bool) -> tuple:
    """(metrics, flat {path: grad}) of a step's results, the reference's
    stacked grads laid out as the port's leaves."""
    grads = (_port_grads(res["grads"], cfg) if reference
             else dict(tree_leaves_with_path(res["grads"])))
    return res["metrics"], grads


def _errors(got, want) -> dict:
    """Relative errors of step ``got`` against step ``want``: loss, grad
    norm and the worst grad leaf (a leaf zero but for rounding against
    the tree's RMS)."""
    (gm, gg), (wm, wg) = got, want
    out = {k: abs(gm[k] - wm[k]) / max(abs(wm[k]), 1e-30)
           for k in ("loss", "grad_norm")}
    assert gg.keys() == wg.keys()
    tree_rms = np.sqrt(np.mean(np.concatenate(
        [w.reshape(-1) ** 2 for w in wg.values()])))
    errs = {}
    for path, w in wg.items():
        scale = np.sqrt(np.mean(w ** 2))
        if scale < 1e-3 * tree_rms:
            scale = tree_rms
        errs[path] = float(np.sqrt(np.mean((gg[path] - w) ** 2)) / scale)
    out["grads"] = max(errs.values())
    return out


def _training(runs, job, fault=None) -> tuple:
    """(errors of the port's step on the mesh against the reference's on
    the same mesh, their bounds). A bound is the stated one (LOSS_RTOL,
    LOSS_RTOL, GRAD_RTOL), or NOISE times the larger of two spreads the
    mesh cannot be held under, where that is larger: the reference's own
    (its one-device step against its step on this mesh; jamba's grads
    spread by 5e-4) and the port's one rank against the reference's one
    device (whisper's grad norm by 1.3e-5)."""
    want, got = runs
    name, arch = job[0], job[1]
    cfg = smoke(configs, arch)
    ref = _step(want[name], cfg, True)
    res = got[name if fault is None else f"{name}:{fault}"][0]
    errs = _errors(_step(res, cfg, False), ref)
    one = _step(want["one:" + arch], cfg, True)
    spreads = (_errors(ref, one),
               _errors(_step(got["one:" + arch][0], cfg, False), one))
    bounds = {k: max(tol, NOISE * max(sp[k] for sp in spreads))
              for k, tol in (("loss", LOSS_RTOL), ("grad_norm", LOSS_RTOL),
                             ("grads", GRAD_RTOL))}
    return errs, bounds


@pytest.mark.parametrize("job", JOBS, ids=lambda j: j[0])
def test_served_on_the_mesh_matches_jax(runs, job):
    want, got = runs
    name, arch, shape, strategy = job
    ranks, ref = got[name], want[name]
    for r in ranks[1:]:  # every rank hands back the whole batch's results
        assert r["streams"] == ranks[0]["streams"]
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
    res = ranks[0]
    assert res["streams"] == ref["streams"]
    assert _rel_rms(res["logits"], ref["logits"]) <= LOGIT_RTOL
    for r in ranks:
        assert r["bytes"] == r["planned"]
    d, m = shape
    stats = res["stats"]
    if m > 1:  # heads, d_ff and the vocabulary split over "model"
        assert stats["all_reduce"] > 0 and stats["all_gather_model"] > 0
    if d > 1:  # rows over "data"
        assert stats["all_gather_data"] > 0 and stats["broadcast"] > 0
    if strategy == "fsdp_tp" and d > 1:
        assert stats["all_gather_param"] > 0


@pytest.mark.parametrize("job", JOBS, ids=lambda j: j[0])
def test_train_step_on_the_mesh_matches_jax(runs, job):
    _, got = runs
    ranks = got[job[0]]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    errs, bounds = _training(runs, job)
    assert all(errs[k] <= bounds[k] for k in errs), (errs, bounds)
    assert bounds["grads"] <= 10 * GRAD_RTOL, bounds


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_breaks_the_training_bounds(runs, fault):
    job = next(j for j in JOBS if j[0] == FAULTS[fault])
    errs, bounds = _training(runs, job, fault)
    assert errs["grads"] > 10 * bounds["grads"], (errs, bounds)
