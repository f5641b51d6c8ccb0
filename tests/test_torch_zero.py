"""The ZeRO-3 layouts ("fsdp", "fsdp_tp") on gloo ranks, against the JAX
reference on the same host mesh (CPU).

The reference runs in one subprocess over 4 host devices
(``--xla_force_host_platform_device_count``): its train step jitted on
params, state and batch laid out by its planner (GSPMD inserts the
collectives), and its engine under ``strategy="fsdp_tp"`` and ``"fsdp"``.
The port runs the same layouts as one 2-rank and one 4-rank spawn
(``launch.mesh.spawn_ranks``), each rank holding its shards and running
``make_train_step(mesh=, strategy=)`` or ``Engine(strategy=)``.

Training runs in fp32 in both packages (``jnp.bfloat16`` and
``torch.bfloat16`` read as fp32 inside the job, as
``test_torch_families._fp32_everywhere`` does; the smoke models amplify
bf16 rounding past any useful bound), so the bounds are tight:

* loss, aux loss and grad norm of each step (bounds below);
* the first step's grads, every leaf gathered whole from the ranks,
  within GRAD_RTOL (1e-4) relative RMS of the reference's
  ``jax.value_and_grad`` on the mesh, leaf by leaf (a leaf whose true
  grad is zero, the key biases of a model without RoPE, against the
  tree's RMS instead);
* params, AdamW's m and v (or Adafactor's factored statistics) after the
  steps, leaf by leaf (bounds below).

AdamW's first step is nearly invariant to a constant grad scale, so the
params alone cannot show a grad summed too few or too many times over the
data axes: the grad norm and the grads do, and each planted fault (grads
not summed over the data axes, the whole-over-data leaves summed twice,
a replicated leaf counted on every rank in the norm) must break its bound.

Serving: smoke qwen2-7b through ``ContinuousBatcher`` under "fsdp_tp" on
(2, 2) and under "fsdp" on (2, 2) and (1, 2), as served (bf16), against
the reference's engine on the same mesh and layout: greedy streams up to near-ties (``test_torch_tp``'s rule), prefill
logits within ``LOGIT_REL_TOL``, the layer gathers counted, and each
rank's param bytes equal to the planner's count.

Checkpoint: a (2, 1) "fsdp" run saved at step 2 and resumed equals an
uninterrupted run bit for bit, and the file restores on one rank.
Microbatches: under ``microbatch`` each rank takes its block of every
microbatch, and the (2, 1) "fsdp" step equals one process's.

Bounds, measured against these: the first step's loss, aux loss and
grad norm within LOSS_RTOL (1e-5) relative, the second step's within
TRAJ_RTOL (2e-4: the reference's own layouts spread its grad norm by
2.5e-5 there); the update (params after the steps less the init)
within UPDATE_RTOL (1e-2) relative RMS a leaf, since AdamW's first step
is lr x sign(g) and an element whose grad is within rounding of 0 may
step either way; AdamW's m and v and Adafactor's statistics within
STATE_RTOL (1e-3). Adafactor is held to the reference's optimizer run
on the port's per-layer tree with the reference's grads: the reference
factors a stacked (layers, d) norm leaf that the port keeps whole.
"""
import os
import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC, run_in_subprocess
from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.training.optimizer import Adafactor as JAdafactor
from repro.training.optimizer import constant as jconstant
from repro_torch import configs
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import build, convert
from repro_torch.models.common import is_axspec
from repro_torch.models.convert import from_reference
from repro_torch.training import checkpoint, optimizer
from repro_torch.tree import tree_leaves_with_path
from test_torch_decode import LOGIT_REL_TOL
from test_torch_tp import _assert_parted_at_near_ties
from test_torch_training import to_port

RANK_TIMEOUT_S = 240
LOSS_RTOL = 1e-5
TRAJ_RTOL = 2e-4
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-2
STATE_RTOL = 1e-3
ROWS, SEQ = 8, 16
ARCHS = {"qwen": "qwen2-7b", "moe": "qwen2-moe-a2.7b",
         "mamba": "mamba2-130m"}
# (name, arch, mesh, strategy, optimizer, steps)
TRAIN = [("qwen-fsdp_tp(2, 2)", "qwen", (2, 2), "fsdp_tp", "adamw", 2),
         ("qwen-fsdp(2, 1)", "qwen", (2, 1), "fsdp", "adamw", 2),
         ("qwen-fsdp(2, 2)", "qwen", (2, 2), "fsdp", "adamw", 2),
         ("qwen-adafactor-fsdp_tp(2, 2)", "qwen", (2, 2), "fsdp_tp",
          "adafactor", 1),
         ("moe-fsdp(2, 1)", "moe", (2, 1), "fsdp", "adamw", 2),
         ("mamba-fsdp(2, 1)", "mamba", (2, 1), "fsdp", "adamw", 2)]
FAULTS = ["not_summed", "summed_twice", "norm_counts_replicas"]
# job name -> (strategy, mesh) of the served runs
SERVE = {"serve": ("fsdp_tp", (2, 2)), "serve-fsdp(2, 2)": ("fsdp", (2, 2)),
         "serve-fsdp(1, 2)": ("fsdp", (1, 2))}
FAULT_CASE = "qwen-fsdp_tp(2, 2)"


def _batch(cfg):
    t = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                          (ROWS, SEQ + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _requests():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 256, n).tolist(), m)
            for n, m in [(8, 5), (16, 6), (8, 4), (16, 5), (8, 6), (16, 4)]]


_JAX = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.dist import context as dctx, sharding as shd
from repro.models import RunConfig, build
from repro.serving import ContinuousBatcher, Engine, Request
from repro.training import optimizer as opt_lib
from repro.training.train_step import make_loss_fn, make_train_step
spec = pickle.load(open(%(spec)r, "rb"))
out = {}
bf16 = jnp.bfloat16

def f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x,
                        tree)

def npy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)

for name, arch, shape, strategy, which, steps in spec["train"]:
    cfg = configs.smoke(spec["archs"][arch])
    model = build(cfg)
    params = f32(jax.jit(model.init)(jax.random.PRNGKey(0)))
    jnp.bfloat16 = jnp.float32
    jax.clear_caches()
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    opt = (opt_lib.AdamW(schedule=opt_lib.constant(1e-3))
           if which == "adamw" else
           opt_lib.Adafactor(schedule=opt_lib.constant(1e-2),
                             weight_decay=0.01))
    batch = {k: jnp.asarray(v) for k, v in spec["batch"][arch].items()}
    with dctx.mesh_context(mesh):
        dctx.set_batch_axes(("data", "model") if strategy == "fsdp"
                            else None)
        p_sh = shd.param_shardings(model.param_specs, strategy, mesh)
        params = jax.device_put(params, p_sh)
        state = jax.jit(opt.init)(params)
        if which == "adamw":
            state = jax.device_put(state, {"m": p_sh, "v": p_sh,
                                           "master": p_sh,
                                           "step": NamedSharding(mesh, P())})
        batch = jax.device_put(batch, shd.input_shardings(batch, mesh))
        (_, _), grads = jax.jit(jax.value_and_grad(
            make_loss_fn(model, RunConfig()), has_aux=True))(params, batch)
        step = jax.jit(make_train_step(model, RunConfig(), opt))
        metrics = []
        for _ in range(steps):
            params, state, m = step(params, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        dctx.set_batch_axes(None)
    jnp.bfloat16 = bf16
    jax.clear_caches()
    out[name] = {"metrics": metrics, "grads": npy(grads),
                 "params": npy(params),
                 "state": npy({k: v for k, v in state.items()
                               if k != "step"})}

cfg = configs.smoke(spec["archs"]["qwen"])
model = build(cfg)
params = jax.jit(model.init)(jax.random.PRNGKey(0))
for name, (strategy, shape) in spec["serve"].items():
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=jax.devices()[:int(np.prod(shape))],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    eng = Engine(model, RunConfig(cache_pad=56), mesh=mesh,
                 strategy=strategy)
    sp = eng.shard_params(params)
    b = ContinuousBatcher(eng, sp, n_slots=4, max_len=64)
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=n)
            for i, (p, n) in enumerate(spec["requests"])]
    b.submit_many(reqs)
    b.run()
    out[name] = {"streams": [[int(t) for t in r.generated] for r in reqs],
                 "logits": np.asarray(eng.prefill(sp, np.asarray(
                     spec["prefill"], np.int32))[0], np.float32)}
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
from repro_torch.dist import collectives, sharding as shd, context as dctx
from repro_torch.models import RunConfig, build
from repro_torch.serving import ContinuousBatcher, Engine, Request
from repro_torch.training import checkpoint, optimizer, train_step
from repro_torch.tree import tree_leaves, tree_map, tree_map_multi
spec = pickle.load(open(sys.argv[1], "rb"))
out = {}
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
    # a patch that breaks the step as ``fault`` says, and its undoing
    if fault == "not_summed":
        rs, sw = collectives._reduce_scatter, train_step._sum_whole_leaves
        collectives._reduce_scatter = lambda g, group, index, n: \\
            g[index].clone()
        train_step._sum_whole_leaves = lambda grads, sums: grads
        def undo():
            collectives._reduce_scatter = rs
            train_step._sum_whole_leaves = sw
    elif fault == "summed_twice":
        sw = train_step._sum_whole_leaves
        train_step._sum_whole_leaves = lambda grads, sums: sw(
            sw(grads, sums), sums)
        def undo():
            train_step._sum_whole_leaves = sw
    elif fault == "norm_counts_replicas":
        once = shd.Sharding.counted_here
        shd.Sharding.counted_here = lambda self, mesh: True
        def undo():
            shd.Sharding.counted_here = once
    else:
        return lambda: None
    return undo


def whole(tree, shardings):
    return tree_map_multi(lambda t, s: collectives.whole(t, s).float().numpy(),
                          tree, shardings)


def train(arch, shape, strategy, which, steps, fault=None):
    cfg = configs.smoke(spec["archs"][arch])
    model = build(cfg)
    mesh = make_host_mesh(shape)
    plan = shd.param_specs_tree(model.param_specs, strategy, mesh)
    sh = shd.param_shardings(model.param_specs, strategy, mesh)
    params = tree_map_multi(lambda t, s: s.slice(t).float().clone(),
                            torch.load(spec["params"][arch]), sh)
    opt = (optimizer.AdamW(schedule=optimizer.constant(1e-3))
           if which == "adamw" else
           optimizer.Adafactor(schedule=optimizer.constant(1e-2),
                               weight_decay=0.01))
    rec = Recording(opt)
    torch.bfloat16 = torch.float32
    undo = planted(fault)
    try:
        step = train_step.make_train_step(model, RunConfig(), rec,
                                          mesh=mesh, strategy=strategy)
        state = rec.init(params)
        metrics = []
        for _ in range(steps):
            params, state, m = step(params, state, spec["batch"][arch])
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        undo()
        torch.bfloat16 = BF16
    st_sh = shd.state_shardings(opt.state_specs(plan), mesh, strategy)
    with dctx.mesh_context(mesh):
        return {"metrics": metrics, "grads": whole(rec.grads, sh),
                "params": whole(params, sh),
                "state": {k: whole(v, st_sh[k]) for k, v in state.items()
                          if k != "step"}}


def serve(strategy, shape):
    cfg = configs.smoke(spec["archs"]["qwen"])
    mesh = make_host_mesh(tuple(shape))
    eng = Engine(build(cfg), RunConfig(cache_pad=56, attn_impl="pallas"),
                 device="cpu", mesh=mesh, strategy=strategy)
    sp = eng.shard_params(torch.load(spec["serve_params"]))
    collectives.reset_stats()
    b = ContinuousBatcher(eng, sp, n_slots=4, max_len=64)
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=n)
            for i, (p, n) in enumerate(spec["requests"])]
    b.submit_many(reqs)
    b.run()
    stats = {k: v[0] for k, v in collectives.STATS.items()}
    return {"streams": [r.generated for r in reqs], "stats": stats,
            "bytes": sum(t.numel() * t.element_size()
                         for t in tree_leaves(sp)),
            "logits": eng.prefill(sp, np.asarray(spec["prefill"]))[0]
            .float().numpy()}


def resume(tmp):
    # (2, 1) "fsdp": 4 steps straight, and 2 + save + restore + 2
    cfg = configs.smoke(spec["archs"]["qwen"])
    model = build(cfg)
    mesh = make_host_mesh((2, 1))
    plan = shd.param_specs_tree(model.param_specs, "fsdp", mesh)
    sh = shd.param_shardings(model.param_specs, "fsdp", mesh)
    opt = optimizer.AdamW(schedule=optimizer.constant(1e-3))
    st_sh = shd.state_shardings(opt.state_specs(plan), mesh, "fsdp")
    step = train_step.make_train_step(model, RunConfig(), opt, mesh=mesh,
                                      strategy="fsdp")
    start = tree_map_multi(lambda t, s: s.slice(t).clone(),
                           torch.load(spec["serve_params"]), sh)
    batch = spec["batch"]["qwen"]
    p, s = start, opt.init(start)
    for _ in range(4):
        p, s, _ = step(p, s, batch)
    q, t = start, opt.init(start)
    for _ in range(2):
        q, t, _ = step(q, t, batch)
    shardings = {"params": sh, "opt": st_sh}
    with dctx.mesh_context(mesh):
        checkpoint.save(tmp, 2, {"params": q, "opt": t},
                        shardings=shardings)
    fresh = {"params": tree_map(torch.zeros_like, start),
             "opt": opt.init(start)}
    with dctx.mesh_context(mesh):
        got, manifest = checkpoint.restore(tmp, fresh, shardings=shardings)
    q, t = got["params"], got["opt"]
    for _ in range(2):
        q, t, _ = step(q, t, batch)
    with dctx.mesh_context(mesh):
        return {"straight": whole(p, sh), "resumed": whole(q, sh),
                "saved": whole(got["params"], sh),
                "step": int(manifest["step"])}


def micro():
    # (2, 1) "fsdp" with microbatches of 4 rows against the same step on
    # this process alone, both in fp32
    cfg = configs.smoke(spec["archs"]["qwen"])
    model = build(cfg)
    mesh = make_host_mesh((2, 1))
    sh = shd.param_shardings(model.param_specs, "fsdp", mesh)
    start = tree_map(lambda t: t.float(), torch.load(spec["params"]["qwen"]))
    opt = optimizer.AdamW(schedule=optimizer.constant(1e-3))
    run = RunConfig(microbatch=4)
    batch = spec["batch"]["qwen"]
    torch.bfloat16 = torch.float32
    try:
        one, _, m1 = train_step.make_train_step(model, run, opt)(
            start, opt.init(start), batch)
        local = tree_map_multi(lambda t, s: s.slice(t).clone(), start, sh)
        got, _, m2 = train_step.make_train_step(
            model, run, opt, mesh=mesh, strategy="fsdp")(
                local, opt.init(local), batch)
    finally:
        torch.bfloat16 = BF16
    with dctx.mesh_context(mesh):
        return {"one": {k: float(v) for k, v in m1.items()},
                "mesh": {k: float(v) for k, v in m2.items()},
                "params": whole(got, sh),
                "one_params": tree_map(lambda t: t.numpy(), one)}


for job in spec["jobs"]:
    if job["world"] != world:
        continue
    if job["kind"] == "micro":
        out[job["name"]] = micro()
        continue
    if job["kind"] == "train":
        out[job["name"]] = train(*job["args"], fault=job.get("fault"))
    elif job["kind"] == "serve":
        out[job["name"]] = serve(*job["args"])
    else:
        out[job["name"]] = resume(spec["ckpt"])
pickle.dump(out, open(spec["out"] + f"/{world}-rank{rank}.pkl", "wb"))
"""


def _jobs():
    jobs = [dict(kind="train", name=name, world=int(np.prod(shape)),
                 args=(arch, shape, strategy, which, steps))
            for name, arch, shape, strategy, which, steps in TRAIN]
    fault_case = next(c for c in TRAIN if c[0] == FAULT_CASE)
    jobs += [dict(kind="train", name=f"{FAULT_CASE}:{fault}", world=4,
                  args=fault_case[1:], fault=fault) for fault in FAULTS]
    jobs += [dict(kind="serve", name=name, world=int(np.prod(shape)),
                  args=(strategy, shape))
             for name, (strategy, shape) in SERVE.items()]
    jobs += [dict(kind="resume", name="resume", world=2),
             dict(kind="micro", name="micro", world=2)]
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, {rank count: [each rank's results]}), run once
    for the module."""
    tmp = tmp_path_factory.mktemp("zero")
    params, batches = {}, {}
    for key, arch in ARCHS.items():
        cfg = configs.smoke(arch)
        jparams = jax.jit(jbuild(jconfigs.smoke(arch)).init)(
            jax.random.PRNGKey(0))
        params[key] = str(tmp / f"{key}.pt")
        torch.save(from_reference(
            jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
            cfg, device="cpu"), params[key])
        batches[key] = _batch(cfg)
    spec = dict(jobs=_jobs(), train=TRAIN, serve=SERVE, archs=ARCHS,
                params=params,
                serve_params=params["qwen"], batch=batches,
                requests=_requests(),
                prefill=np.random.default_rng(2).integers(
                    0, 256, (4, 8)).tolist(),
                ckpt=str(tmp / "ckpt"), out=str(tmp))
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
        got[world] = []
        for r in range(world):
            with open(tmp / f"{world}-rank{r}.pkl", "rb") as f:
                got[world].append(pickle.load(f))
    return want, got, spec


def _rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _port_tree(tree, cfg):
    """A reference tree (stacked layers) as the port's flat {path: array}."""
    return {p: t.numpy() for p, t in tree_leaves_with_path(
        to_port(tree, cfg, torch.float32))}


def _flat(tree) -> dict:
    return dict(tree_leaves_with_path(tree))


def _tree_errors(got: dict, want: dict, floor_to_tree: bool = True) -> dict:
    """path -> relative RMS; a leaf whose reference RMS is under 1e-3 of
    the tree's (a grad that is zero but for rounding) against the tree's
    RMS."""
    tree_rms = np.sqrt(np.mean(np.concatenate(
        [w.reshape(-1) ** 2 for w in want.values()])))
    out = {}
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        scale = np.sqrt(np.mean(w ** 2))
        if floor_to_tree and scale < 1e-3 * tree_rms:
            scale = tree_rms
        out[path] = float(np.sqrt(np.mean((g - w) ** 2)) / scale)
    return out


def _check_training(res, want, cfg):
    """The bounds on the metrics and the first step's grads; raises
    AssertionError."""
    for i, (g, w) in enumerate(zip(res["metrics"], want["metrics"])):
        tol = LOSS_RTOL if i == 0 else TRAJ_RTOL
        for key in ("loss", "aux_loss", "grad_norm"):
            assert abs(g[key] - w[key]) <= tol * max(abs(w[key]), 1.0), \
                (i, key, g[key], w[key])
    errs = _tree_errors(_flat(res["grads"]),
                        _port_tree(want["grads"], cfg))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, ("grads", worst, errs[worst])


@pytest.fixture(scope="module")
def by_name(runs):
    _, got, _ = runs
    out = {}
    for world, ranks in got.items():
        for name in ranks[0]:
            out[name] = [r[name] for r in ranks]
    return out


@pytest.mark.parametrize("case", TRAIN, ids=lambda c: c[0])
def test_train_step_matches_jax_sharded_step(runs, by_name, case):
    want, _, spec = runs
    name, arch, shape, strategy, which, steps = case
    cfg = configs.smoke(ARCHS[arch])
    ranks = by_name[name]
    for r in ranks[1:]:  # every rank gathered the same whole trees
        assert r["metrics"] == ranks[0]["metrics"]
    res, ref = ranks[0], want[name]
    assert len(res["metrics"]) == steps
    _check_training(res, ref, cfg)
    init = {p: t.float().numpy() for p, t in tree_leaves_with_path(
        torch.load(spec["params"][arch]))}
    if which == "adamw":
        params = _port_tree(ref["params"], cfg)
        states = {k: _port_tree(ref["state"][k], cfg) for k in ("m", "v")}
    else:  # the reference's optimizer on the port's per-layer tree, fed
        # the reference's grads: Adafactor factors a stacked (layers, d)
        # norm leaf that the port's per-layer leaf keeps whole
        jopt = JAdafactor(schedule=jconstant(1e-2), weight_decay=0.01)
        jparams = {p: jnp.asarray(v) for p, v in init.items()}
        jgrads = {p: jnp.asarray(v) for p, v in
                  _port_tree(ref["grads"], cfg).items()}
        new, jstate, _ = jopt.update(jgrads, jopt.init(jparams), jparams)
        params = {p: np.asarray(v) for p, v in new.items()}
        states = {"factored": {p + (k,): np.asarray(v)
                               for p, f in jstate["factored"].items()
                               for k, v in f.items()}}
    got = _flat(res["params"])
    errs = {p: _rel_rms(got[p] - init[p], w - init[p])
            for p, w in params.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_RTOL, ("update", worst, errs[worst])
    for key, want_state in states.items():
        errs = _tree_errors(_flat(res["state"][key]), want_state)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= STATE_RTOL, (key, worst, errs[worst])
    if ARCHS[arch] == "qwen2-moe-a2.7b":  # the lb loss is in the total
        assert all(m["aux_loss"] > 0.5 for m in res["metrics"])


def test_microbatched_step_keeps_each_ranks_block_of_every_microbatch(
        runs, by_name):
    """Under ``microbatch`` each rank takes its block of every microbatch
    (the reference keeps the microbatch dim cut over the data axes): the
    (2, 1) "fsdp" step equals the one-process microbatched step, in fp32,
    within the module's bounds."""
    _, _, spec = runs
    res = by_name["micro"][0]
    for key in ("loss", "grad_norm"):
        assert abs(res["mesh"][key] - res["one"][key]) <= \
            LOSS_RTOL * abs(res["one"][key]), key
    init = {p: t.float().numpy() for p, t in tree_leaves_with_path(
        torch.load(spec["params"]["qwen"]))}
    got, want = _flat(res["params"]), _flat(res["one_params"])
    errs = {p: _rel_rms(got[p] - init[p], want[p] - init[p]) for p in init}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_breaks_its_bound(runs, by_name, fault):
    want, _, _ = runs
    cfg = configs.smoke("qwen2-7b")
    res = by_name[f"{FAULT_CASE}:{fault}"][0]
    with pytest.raises(AssertionError):
        _check_training(res, want[FAULT_CASE], cfg)


def _check_served(runs, by_name, name):
    """The served job ``name`` against the reference's engine on the same
    mesh and layout: every rank's streams and logits equal, greedy streams
    parted only at near-ties, prefill logits within LOGIT_REL_TOL, layers
    gathered, and each rank's param bytes the planner's."""
    want, _, spec = runs
    strategy, shape = SERVE[name]
    ranks = by_name[name]
    for r in ranks[1:]:
        assert r["streams"] == ranks[0]["streams"]
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
    res = ranks[0]
    jcfg = jconfigs.smoke("qwen2-7b")
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    _assert_parted_at_near_ties(jcfg, jparams, [p for p, _ in
                                                spec["requests"]],
                                want[name]["streams"], res["streams"])
    np.testing.assert_allclose(
        res["logits"], want[name]["logits"],
        atol=LOGIT_REL_TOL * np.abs(want[name]["logits"]).max())
    # every layer's leaves gathered, in one all_gather a layer and unit
    assert res["stats"]["all_gather_param"] > 0
    mesh = dctx.Mesh(np.arange(int(np.prod(shape))).reshape(shape),
                     ("data", "model"))
    planned = shd.rank_param_bytes(build(configs.smoke("qwen2-7b"))
                                   .param_specs, strategy, mesh)
    assert all(r["bytes"] == planned for r in ranks)


def test_engine_and_batcher_fsdp_tp_match_jax_on_the_same_mesh(runs,
                                                              by_name):
    _check_served(runs, by_name, "serve")


@pytest.mark.parametrize("name", ["serve-fsdp(2, 2)", "serve-fsdp(1, 2)"])
def test_engine_and_batcher_fsdp_match_jax_on_the_same_mesh(runs, by_name,
                                                            name):
    """Under "fsdp" every leaf is gathered whole, so the kv heads of the
    cache stay whole over "model" (a rank attends every head)."""
    _check_served(runs, by_name, name)


def test_checkpoint_under_a_mesh_resumes_bit_exact_and_restores_on_one_rank(
        runs, by_name):
    _, _, spec = runs
    ranks = by_name["resume"]
    res = ranks[0]
    assert res["step"] == 2
    for a, b in zip(tree_leaves_with_path(res["straight"]),
                    tree_leaves_with_path(res["resumed"])):
        np.testing.assert_array_equal(a[1], b[1], err_msg=str(a[0]))
    # the file a mesh run wrote restores on one rank: the whole leaves
    cfg = configs.smoke("qwen2-7b")
    model = build(cfg)
    like = {"params": torch.load(spec["serve_params"]),
            "opt": optimizer.AdamW(schedule=optimizer.constant(1e-3)).init(
                torch.load(spec["serve_params"]))}
    got, manifest = checkpoint.restore(spec["ckpt"], like, step=2)
    for (path, g), (_, w) in zip(tree_leaves_with_path(got["params"]),
                                 tree_leaves_with_path(res["saved"])):
        np.testing.assert_array_equal(g.float().numpy(), w,
                                      err_msg=str(path))
    assert set(dict(tree_leaves_with_path(model.param_specs))) == \
        set(dict(tree_leaves_with_path(got["params"])))


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b",
                                  "mamba2-130m", "gemma2-27b"])
@pytest.mark.parametrize("shape,strategy", [((2, 2), "fsdp_tp"),
                                            ((2, 1), "fsdp"),
                                            ((2, 2), "fsdp")], ids=str)
def test_rank_bytes_are_the_planners_and_the_state_is_cut_alike(
        arch, shape, strategy):
    """On every rank of a (group-less) mesh: the bytes of the rank's
    shards are ``rank_param_bytes``, the same on every rank, less than
    the whole model's and at least its share; AdamW's state shardings
    (``state_specs``) cut m, v and master as the params, ``step``
    whole."""
    specs = build(configs.smoke(arch)).param_specs
    leaves = [s for _, s in tree_leaves_with_path(specs, is_axspec)]
    whole_bytes = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                      for s in leaves)
    opt = optimizer.AdamW(schedule=optimizer.constant(1e-3))
    n = int(np.prod(shape))
    totals = []
    for rank in range(n):
        mesh = dctx.Mesh(np.arange(n).reshape(shape), ("data", "model"),
                         rank=rank)
        sh = shd.param_shardings(specs, strategy, mesh)
        cuts = [c for _, c in tree_leaves_with_path(
            sh, lambda x: isinstance(x, shd.Sharding))]
        got = sum(int(np.prod(c.local_shape(s.shape))) * s.dtype.itemsize
                  for c, s in zip(cuts, leaves))
        assert got == shd.rank_param_bytes(specs, strategy, mesh)
        state = shd.state_shardings(opt.state_specs(
            shd.param_specs_tree(specs, strategy, mesh)), mesh, strategy)
        for key in ("m", "v", "master"):
            assert [c for _, c in tree_leaves_with_path(
                state[key], lambda x: isinstance(x, shd.Sharding))] == cuts
        assert state["step"].replicated
        totals.append(got)
    assert len(set(totals)) == 1
    assert whole_bytes / n <= totals[0] < whole_bytes


@pytest.mark.parametrize("strategy", ["fsdp_tp", "fsdp"])
def test_reference_params_cut_to_zero_shards_and_back(strategy):
    """``models.convert.from_reference(shardings=)`` gives each rank of a
    (2, 2) mesh its ZeRO shard (the planner's local shapes), and
    ``gather_shards`` puts the four back into the whole tree bit for
    bit."""
    cfg = configs.smoke("qwen2-7b")
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), jax.jit(
        jbuild(jconfigs.smoke("qwen2-7b")).init)(jax.random.PRNGKey(0)))
    whole = from_reference(params_np, cfg, device="cpu")
    specs = dict(tree_leaves_with_path(build(cfg).param_specs, is_axspec))
    shards, plans = [], []
    for rank in range(4):
        mesh = dctx.Mesh(np.arange(4).reshape(2, 2), ("data", "model"),
                         rank=rank)
        sh = shd.param_shardings(build(cfg).param_specs, strategy, mesh)
        shard = from_reference(params_np, cfg, device="cpu", shardings=sh)
        cuts = dict(tree_leaves_with_path(
            sh, lambda x: isinstance(x, shd.Sharding)))
        for path, t in tree_leaves_with_path(shard):
            assert tuple(t.shape) == cuts[path].local_shape(
                specs[path].shape), path
        shards.append(shard)
        plans.append(sh)
    assert any(c.zero for c in cuts.values())
    for (path, a), (_, b) in zip(
            tree_leaves_with_path(convert.gather_shards(shards, plans)),
            tree_leaves_with_path(whole)):
        assert torch.equal(a, b), path
