"""The port's compile-only dry run (``repro_torch.launch.dryrun``,
``launch.hlo_analysis``, ``model_zoo``'s shape cells) against the
reference's, on the CPU. About 60 s serially.

* SHAPE CELLS — ``SHAPES``, ``shape_applicable`` (reasons included) and
  ``input_specs`` (names, shapes and dtypes; decode's cache leaf by leaf,
  the reference's stacked layers unstacked) equal the reference's for
  every ``ASSIGNED`` arch x shape, as do ``active_param_count`` and
  ``model_flops_analytic``.
* FLOPS — on one rank, the op-stream analysis's ``flops`` for a smoke
  forward, prefill and train step of qwen2-7b, gemma2-27b, mamba2-130m
  and whisper-base lie within ``FLOP_RTOL`` (2%) of the reference's
  ``hlo_analysis.analyze_hlo(...).flops`` for the same function jitted on
  one device (measured gap: 0 on every case but mamba2-130m's train
  step, -0.10%).
* COLLECTIVES — on a fake (2, 2) mesh, rank 0's collective instances by
  type equal what ``collectives.STATS`` counts on four real gloo ranks
  running the same smoke cell: prefill and a decode step under "tp", a
  train step under "fsdp_tp".
* SPLITS — on a fake (1, 4) "tp" mesh a dense model's per-rank flops x 4
  lie within 2% of one rank's.
* PARAM BYTES — a rank's ``Model.abstract`` leaves hold
  ``dist.sharding.rank_param_bytes`` for every ``ASSIGNED`` arch on
  (16, 16).
* CELLS — qwen2-7b, mamba2-130m and whisper-base on (16, 16) over all
  four shapes, and one (2, 16, 16) cell, come out "ok" or "skip" exactly
  where the reference's ``shape_applicable`` says, with the card never
  initialised. They run at one pattern period of depth (every code path
  of a cell, at a tier-1 cost); the full-depth records come from the
  command line (PERF.md).
"""
import dataclasses
import json
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import SRC
from repro import configs as jconfigs
from repro.launch import hlo_analysis as jhlo
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.models import model_zoo as jzoo
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import configs
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.dist.context import Mesh
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_host_mesh, spawn_ranks
from repro_torch.models import RunConfig, build
from repro_torch.models import model_zoo

FLOP_RTOL = 0.02
RANK_TIMEOUT_S = 240
FLOP_ARCHS = ["qwen2-7b", "gemma2-27b", "mamba2-130m", "whisper-base"]
# the reference's collective types of the port's counted kinds
STAT_TYPES = {"all_reduce": "all-reduce", "all_gather_model": "all-gather",
              "all_gather_data": "all-gather", "all_gather_param": "all-gather",
              "reduce_scatter_param": "reduce-scatter",
              "broadcast": "broadcast"}


def _reference_dryrun():
    """``repro.launch.dryrun`` imported without its XLA_FLAGS edit
    outliving the import (this process's JAX is already up; subprocesses
    of later tests inherit the environment)."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return jdryrun


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _cells():
    return [(a, s) for a in configs.ASSIGNED for s in model_zoo.SHAPES]


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


def test_shapes_and_applicability_equal_the_reference():
    assert model_zoo.SHAPES == jzoo.SHAPES
    for arch, shape in _cells():
        assert (model_zoo.shape_applicable(configs.get(arch), shape)
                == jzoo.shape_applicable(jconfigs.get(arch), shape))


def _assert_cache_specs_equal(got, want, cfg):
    assert _dtype(got.lengths) == str(want.lengths.dtype)
    assert tuple(got.lengths.shape) == tuple(want.lengths.shape)
    if cfg.encdec:
        for name in ("self_k", "self_v", "cross_k", "cross_v"):
            ref = getattr(want, name)
            assert len(getattr(got, name)) == ref.shape[0]
            for t in getattr(got, name):
                assert tuple(t.shape) == tuple(ref.shape[1:])
                assert _dtype(t) == str(ref.dtype)
        return
    assert len(got.layers) == cfg.n_layers
    for layer, leaves in enumerate(got.layers):
        ref = want.layers[layer % cfg.period]
        assert sorted(leaves) == sorted(ref)
        for name, t in leaves.items():
            assert tuple(t.shape) == tuple(ref[name].shape[1:]), name
            assert _dtype(t) == str(ref[name].dtype)


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_input_specs_and_analytic_flops_equal_the_reference(arch):
    jdryrun = _reference_dryrun()
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    model, jmodel = build(cfg), jbuild(jcfg)
    assert model.active_param_count == jmodel.active_param_count
    for shape in model_zoo.SHAPES:
        assert (dryrun.model_flops_analytic(model, shape)
                == jdryrun.model_flops_analytic(jmodel, shape))
        if not model_zoo.shape_applicable(cfg, shape)[0]:
            with pytest.raises(model_zoo.SkipCell):
                model.input_specs(shape)
            continue
        kind, inputs, cache = model.input_specs(shape)
        jkind, jinputs, jcache = jmodel.input_specs(shape)
        assert kind == jkind
        assert list(inputs) == list(jinputs)
        for name, t in inputs.items():
            assert tuple(t.shape) == tuple(jinputs[name].shape), name
            assert _dtype(t) == str(jinputs[name].dtype), name
        assert (cache is None) == (jcache is None)
        if cache is not None:
            _assert_cache_specs_equal(cache, jcache, cfg)


# ---------------------------------------------------------------------------
# FLOPs on one rank against the reference's HLO analysis
# ---------------------------------------------------------------------------


def _batch(cfg, b=2, s=16):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.encdec:
        out["enc_embeds"] = rng.standard_normal(
            (b, s, cfg.enc_d_model or cfg.d_model)).astype(np.float32)
    return out


def _reference_flops(arch, kind, batch):
    jcfg = jconfigs.smoke(arch)
    jmodel = jbuild(jcfg)
    run = JRunConfig()
    p = jmodel.abstract()
    jb = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else None)
          for k, v in batch.items()}
    if kind == "forward":
        fn, args = (lambda p, b: jmodel.forward(run, p, b)), (p, jb)
    elif kind == "prefill":
        fn, args = (lambda p, b: jmodel.prefill(run, p, b)), (p, jb)
    else:
        opt = jopt.AdamW(schedule=jopt.constant(1e-4))
        fn = jts.make_train_step(jmodel, run, opt)
        labels = {"labels": jb["tokens"]}
        args = (p, jax.eval_shape(opt.init, p), dict(jb, **labels))
    text = jax.jit(fn).lower(*args).compile().as_text()
    return jhlo.analyze_hlo(text).flops


def _port_flops(arch, kind, batch):
    cfg = configs.smoke(arch)
    model = build(cfg)
    inputs = {k: torch.empty(v.shape, dtype=torch.int32 if v.dtype == np.int32
                             else torch.bfloat16, device="meta")
              for k, v in batch.items()}
    if kind == "train":
        inputs["labels"] = inputs["tokens"]
    if kind in ("prefill", "train"):
        an, _, _, _ = dryrun.trace_step(model, kind, RunConfig(), None, None,
                                        inputs)
        return an.flops
    an = hlo_analysis.Analysis()
    with FakeTensorMode():
        params = model.abstract()
        fake = {k: torch.zeros(v.shape, dtype=v.dtype)
                for k, v in inputs.items()}
        with hlo_analysis.AnalysisMode(an):
            model.forward(RunConfig(), params, fake)
    return an.flops


@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_one_rank_flops_equal_the_reference_hlo(arch):
    batch = _batch(configs.smoke(arch))
    for kind in ("forward", "prefill", "train"):
        got = _port_flops(arch, kind, batch)
        want = _reference_flops(arch, kind, batch)
        assert want > 0
        assert abs(got - want) <= FLOP_RTOL * want, (kind, got, want)


# ---------------------------------------------------------------------------
# Collectives on a fake (2, 2) mesh against four gloo ranks
# ---------------------------------------------------------------------------

# the smoke cells: (name, arch, kind, strategy, run, whole-batch shapes)
COLL_CELLS = [
    ("prefill_tp", "qwen2-7b", "prefill", "tp",
     dict(attn_impl="xla"), (4, 16)),
    ("decode_tp", "qwen2-7b", "decode", "tp",
     dict(attn_impl="seq_shard", cache_pad=16), (4, 16)),
    ("train_fsdp_tp", "qwen2-7b", "train", "fsdp_tp",
     dict(attn_impl="xla"), (4, 16)),
]


def _cell_inputs(model, kind, run, rows, seq):
    """(inputs, cache) meta specs of a smoke cell, shaped as
    ``Model.input_specs`` shapes a production one."""
    i32 = torch.int32
    if kind == "decode":
        return ({"token": torch.empty((rows, 1), dtype=i32, device="meta")},
                model.cache_specs(rows, seq + run.cache_pad))
    inputs = {"tokens": torch.empty((rows, seq), dtype=i32, device="meta")}
    if kind == "train":
        inputs["labels"] = inputs["tokens"]
    return inputs, None


_GLOO = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.dist import collectives
from repro_torch.launch.mesh import init_from_env, make_host_mesh, rank_env
from repro_torch.models import RunConfig, build
sys.path.insert(0, %(tests)r)
from test_torch_dryrun import COLL_CELLS, _cell_inputs
from repro_torch.launch import dryrun
init_from_env("cpu")
rank, world = rank_env()
mesh = make_host_mesh((2, 2))
collectives.set_fused_partials(False)
out = {}
for name, arch, kind, strategy, run, (rows, seq) in COLL_CELLS:
    model = build(configs.smoke(arch))
    run = RunConfig(**run)
    inputs, cache = _cell_inputs(model, kind, run, rows, seq)
    fn, _, _ = dryrun.build_step(model, kind, run, mesh, strategy, inputs,
                                 cache)
    collectives.reset_stats()
    with torch.no_grad() if kind != "train" else torch.enable_grad():
        fn()
    out[name] = {k: v[0] for k, v in collectives.STATS.items()}
json.dump(out, open(%(out)r + f"/rank{rank}.json", "w"))
"""


@pytest.fixture(scope="module")
def gloo_stats(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_gloo")
    script = tmp / "rank.py"
    script.write_text(textwrap.dedent(_GLOO % dict(
        tests=os.path.dirname(__file__), out=str(tmp))))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    done = spawn_ranks([str(script)], 4, store_path=str(tmp / "store"),
                       timeout=RANK_TIMEOUT_S, env=env)
    failed = [(r, p.returncode, p.stderr[-3000:])
              for r, p in enumerate(done) if p.returncode]
    assert not failed, failed
    with open(tmp / "rank0.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", COLL_CELLS, ids=lambda c: c[0])
def test_fake_mesh_collectives_equal_gloo_ranks(gloo_stats, cell):
    name, arch, kind, strategy, run, (rows, seq) = cell
    model = build(configs.smoke(arch))
    run = RunConfig(**run)
    inputs, cache = _cell_inputs(model, kind, run, rows, seq)
    collectives.set_fused_partials(False)
    try:
        with dryrun.fake_world(4, 0):
            an, _, _, _ = dryrun.trace_step(
                model, kind, run, make_host_mesh((2, 2)), strategy, inputs,
                cache)
    finally:
        collectives.set_fused_partials(None)
    want = {}
    for kind_, n in gloo_stats[name].items():
        want[STAT_TYPES[kind_]] = want.get(STAT_TYPES[kind_], 0) + n
    assert dict(an.collective_instances) == want
    assert want  # the cell runs collectives at all


def test_tp_split_flops_add_up_to_one_rank():
    cfg = dataclasses.replace(configs.smoke("qwen2-7b"), n_kv_heads=4)
    model = build(cfg)
    for kind in ("prefill", "train"):
        inputs, _ = _cell_inputs(model, kind, RunConfig(), 2, 16)
        one, _, _, _ = dryrun.trace_step(model, kind, RunConfig(), None,
                                         None, inputs)
        with dryrun.fake_world(4, 0):
            split, _, _, _ = dryrun.trace_step(
                model, kind, RunConfig(), make_host_mesh((1, 4)), "tp",
                inputs)
        assert abs(4 * split.flops - one.flops) <= FLOP_RTOL * one.flops


# ---------------------------------------------------------------------------
# Param bytes a rank on the production mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_rank_param_bytes_on_the_production_mesh(arch):
    mesh = Mesh(np.arange(256).reshape(16, 16), ("data", "model"))
    model = build(configs.get(arch))
    for strategy in ("tp", "fsdp", "fsdp_tp"):
        shardings = shd.param_shardings(model.param_specs, strategy, mesh)
        with FakeTensorMode():
            held = dryrun._nbytes(model.abstract(shardings))
        assert held == shd.rank_param_bytes(model.param_specs, strategy,
                                            mesh)


# ---------------------------------------------------------------------------
# Production cells
# ---------------------------------------------------------------------------


@pytest.fixture
def one_period(monkeypatch):
    """``configs.get`` cut to one pattern period (one encoder layer)."""
    real = configs.get

    def cut(name):
        c = real(name)
        return dataclasses.replace(c, n_layers=c.period,
                                   n_enc_layers=min(c.n_enc_layers, 1))
    monkeypatch.setattr(dryrun.configs, "get", cut)


@pytest.mark.parametrize("arch,shapes,multi_pod", [
    ("qwen2-7b", list(model_zoo.SHAPES), False),
    ("mamba2-130m", list(model_zoo.SHAPES), False),
    ("whisper-base", list(model_zoo.SHAPES), False),
    ("mamba2-130m", ["decode_32k"], True),
])
def test_production_cells_ok_or_skip_as_the_reference(one_period, arch,
                                                      shapes, multi_pod,
                                                      tmp_path):
    for shape in shapes:
        rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                              verbose=False)
        ok, why = jzoo.shape_applicable(jconfigs.get(arch), shape)
        assert rec["status"] == ("ok" if ok else "skip"), rec.get("error")
        assert rec["chips"] == (512 if multi_pod else 256)
        if ok:
            assert rec["ops"]["flops_per_chip"] > 0
            cfg = configs.get(arch)  # cut by ``one_period``
            assert rec["ops"]["layers_traced"] == cfg.n_layers + (
                cfg.n_enc_layers if rec["kind"] != "decode" else 0)
            assert rec["memory"]["param_bytes"] > 0
        else:
            assert rec["skip_reason"] == why
        assert rec["cuda_initialized"] is False
        path = dryrun.save_artifact(rec, str(tmp_path))
        assert os.path.basename(path) == (
            f"{arch}__{shape}__pod{2 if multi_pod else 1}.json")
    assert not torch.cuda.is_initialized()
