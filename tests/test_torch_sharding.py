"""The port's sharding planner (``dist/sharding.py``, ``dist/context.py``)
against the JAX reference's, entry for entry, and its rank shards against
JAX's addressable shards, bit for bit (CPU).

* Planner parity: every arch of ``configs.ARCHS`` at full width (specs
  only, nothing allocated) on the meshes (16, 16), (2, 4), (4, 2), (1, 2),
  (1, 4), (2, 2) and (2, 1): ``param_specs_tree`` under "tp", "fsdp" and
  "fsdp_tp" (a port leaf is one layer of the reference's stacked leaf:
  its spec is the reference's without the "layers" entry, which must be
  None), ``pick_strategy`` at two ``hbm_bytes``, ``input_shardings`` and
  ``cache_shardings`` with and without ``seq_shard``. JAX runs on an
  ``AbstractMesh``. ``sanitize_spec`` is held under hypothesis;
  ``set_batch_axes``/``dp_axes`` and ``slice_meshes`` on the same meshes.
* Shard parity: smoke qwen2-7b and qwen2-moe, JAX's params put on 4 host
  devices by ``param_shardings`` (a subprocess), each device's
  addressable shards equal the port's rank shard
  (``convert.from_reference(..., shardings=)``) bit for bit; ``gather_shards`` of
  the ranks' shards gives the whole tree back.
"""
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh

from conftest import run_in_subprocess
from repro import configs as jconfigs
from repro.dist import context as jctx
from repro.dist import sharding as jshd
from repro.models import build as jbuild
from repro_torch import configs
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.models import build
from repro_torch.models.convert import (from_reference, gather_shards,
                                        reference_path)
from repro_torch.tree import tree_leaves_with_path

MESHES = [(16, 16), (2, 4), (4, 2), (1, 2), (1, 4), (2, 2), (2, 1)]
AXES = ("data", "model")
STRATEGIES = ("tp", "fsdp", "fsdp_tp")
ARCHS = sorted(configs.ARCHS)


def _meshes(shape, rank=0):
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    return (AbstractMesh(shape, AXES),
            dctx.Mesh(grid, AXES, rank=rank))


def _jax_leaf_specs(tree):
    """path -> tuple spec for a JAX spec tree (dicts/tuples of specs)."""
    out = {}

    def walk(x, path):
        if isinstance(x, (jax.sharding.PartitionSpec,
                          jax.sharding.NamedSharding)):
            out[path] = tuple(getattr(x, "spec", x))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (k,))
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, path + (i,))
        else:
            raise TypeError(type(x))
    walk(tree, ())
    return out


def _port_leaf_specs(tree):
    return {path: tuple(s) for path, s in tree_leaves_with_path(
        tree, lambda x: isinstance(x, shd.PartitionSpec))}


def _assert_param_specs_equal(cfg, port, want):
    assert len(port) == sum(
        cfg.n_layers // cfg.period if p[0] == "blocks" else 1
        for p in want) or cfg.encdec
    for path, spec in port.items():
        rpath, group = reference_path(cfg, path)
        ref = want[rpath]
        if group is not None:  # the stacked "layers" entry is never cut
            assert ref[0] is None, (path, ref)
            ref = ref[1:]
        assert spec == ref, (cfg.name, path, spec, ref)


# ---------------------------------------------------------------------------
# Planner parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_tree_matches_jax(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    port_specs, jax_specs = build(cfg).param_specs, jbuild(jcfg).param_specs
    for shape in MESHES:
        jmesh, mesh = _meshes(shape)
        for strategy in STRATEGIES:
            _assert_param_specs_equal(
                cfg, _port_leaf_specs(shd.param_specs_tree(
                    port_specs, strategy, mesh)),
                _jax_leaf_specs(jshd.param_specs_tree(
                    jax_specs, strategy, jmesh)))


@pytest.mark.parametrize("arch", ARCHS)
def test_pick_strategy_matches_jax(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    port_specs, jax_specs = build(cfg).param_specs, jbuild(jcfg).param_specs
    for shape in MESHES:
        _, mesh = _meshes(shape)
        jmesh = types.SimpleNamespace(shape=dict(zip(AXES, shape)),
                                      devices=np.empty(shape),
                                      axis_names=AXES)
        for hbm in (16 * 2 ** 30, shd.HBM_BYTES):
            for kind in ("train", "infer"):
                assert shd.pick_strategy(port_specs, mesh, kind, hbm) == \
                    jshd.pick_strategy(jax_specs, jmesh, kind, hbm)


def _cache_pairs(cfg, jcfg, batch, max_len):
    """(port cache specs, reference cache specs) of the whole batch."""
    if cfg.encdec:
        return (build(cfg).cache_specs(batch, max_len, enc_len=32),
                jbuild(jcfg).cache_specs(batch, max_len, 32))
    return (build(cfg).cache_specs(batch, max_len),
            jbuild(jcfg).cache_specs(batch, max_len))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_shardings_match_jax(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for shape in MESHES:
        jmesh, mesh = _meshes(shape)
        for b in (1, 2, 16):
            inputs = {"tokens": np.zeros((b, 24), np.int32),
                      "lengths": np.zeros((b,), np.int32),
                      "step": np.zeros((), np.int32)}
            port = shd.input_shardings(inputs, mesh)
            want = jshd.input_shardings(
                {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in inputs.items()}, jmesh)
            assert {k: tuple(v) for k, v in port.items()} == \
                {k: tuple(v.spec) for k, v in want.items()}
        port_cache, jax_cache = _cache_pairs(cfg, jcfg, 16, 1024)
        for seq_shard in (False, True):
            port = shd.cache_shardings(port_cache, cfg, mesh,
                                       seq_shard=seq_shard)
            want = jshd.cache_shardings(jax_cache, jcfg, jmesh,
                                        seq_shard=seq_shard)
            if cfg.encdec:
                for field, specs in port.items():
                    ref = tuple(getattr(want, field).spec)
                    leaves = ((specs,) if isinstance(specs, shd.PartitionSpec)
                              else specs)
                    for s in leaves:
                        assert tuple(s) == (ref[1:] if field != "lengths"
                                            else ref), (field, s, ref)
                continue
            assert tuple(port.lengths) == tuple(want.lengths.spec)
            for layer, leaves in enumerate(port.layers):
                ref = want.layers[layer % cfg.period]
                for name, s in leaves.items():
                    r = tuple(ref[name].spec)
                    assert r[0] is None and tuple(s) == r[1:], (
                        arch, shape, seq_shard, layer, name, s, r)


@settings(max_examples=200, deadline=None)
@given(shape=st.lists(st.integers(1, 64), min_size=0, max_size=4),
       entries=st.lists(st.one_of(
           st.none(), st.sampled_from(["data", "model", "pod"]),
           st.lists(st.sampled_from(["data", "model", "pod"]),
                    min_size=1, max_size=3).map(tuple)),
           min_size=0, max_size=5),
       mesh_i=st.integers(0, len(MESHES) - 1))
def test_sanitize_spec_matches_jax(shape, entries, mesh_i):
    jmesh, mesh = _meshes(MESHES[mesh_i])
    got = shd.sanitize_spec(shd.P(*entries), tuple(shape), mesh)
    want = jshd.sanitize_spec(jax.sharding.PartitionSpec(*entries),
                              tuple(shape), jmesh)
    assert tuple(got) == tuple(want)
    assert got == shd.P(*tuple(want))


@pytest.mark.parametrize("axes", [None, ("data",), ("data", "model"),
                                  ("pod", "data", "model"), ()])
def test_batch_axes_match_jax(axes):
    try:
        shd_axes = []
        for shape in MESHES:
            jmesh, mesh = _meshes(shape)
            jctx.set_batch_axes(axes)
            dctx.set_batch_axes(axes)
            shd_axes.append((dctx.dp_axes(mesh), dctx.dp_axes(None)))
            assert dctx.dp_axes(mesh) == jctx.dp_axes(jmesh)
            assert dctx.dp_axes(None) == jctx.dp_axes(None)
            with dctx.mesh_context(mesh):
                assert dctx.dp_axes() == dctx.dp_axes(mesh)
                assert dctx.dp_size() == int(np.prod(
                    [mesh.shape[a] for a in dctx.dp_axes(mesh)] or [1]))
    finally:
        jctx.set_batch_axes(None)
        dctx.set_batch_axes(None)
    assert dctx.dp_axes(_meshes((2, 4))[1]) == ("data",)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_slice_meshes_match_jax(monkeypatch, n):
    # JAX's Mesh needs real devices: the reference cuts an id grid here
    monkeypatch.setattr(jshd.jax.sharding, "Mesh",
                        lambda devices, names: (np.asarray(devices), names))
    for shape in MESHES:
        grid = np.arange(int(np.prod(shape))).reshape(shape)
        jmesh = types.SimpleNamespace(devices=grid, axis_names=AXES,
                                      shape=dict(zip(AXES, shape)))
        for rank in (0, grid.size - 1):
            mesh = dctx.Mesh(grid, AXES, rank=rank)
            try:
                want = jshd.slice_meshes(jmesh, n)
            except ValueError:
                with pytest.raises(ValueError, match="disjoint slices"):
                    shd.slice_meshes(mesh, n)
                continue
            got = shd.slice_meshes(mesh, n)
            if n == 1:
                assert got == [mesh] and want == [jmesh]
                continue
            assert len(got) == len(want) == n
            for g, (devices, names) in zip(got, want):
                np.testing.assert_array_equal(g.devices, devices)
                assert g.axis_names == tuple(names) and g.rank == rank
            mine = [g for g in got if rank in g.devices]
            assert len(mine) == 1 and mine[0].coords is not None


# ---------------------------------------------------------------------------
# Shard parity with JAX's addressable shards
# ---------------------------------------------------------------------------

SHARD_MESHES = [(1, 4), (2, 2), (4, 1)]

_JAX_SHARDS = """
import pickle
import jax, numpy as np
from repro import configs
from repro.dist import sharding as shd
from repro.models import build
out = {}
for arch in ("qwen2-7b", "qwen2-moe-a2.7b"):
    cfg = configs.smoke(arch)
    model = build(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    out[arch] = {"whole": jax.tree.map(
        lambda x: np.asarray(x, np.float32), params)}
    for shape in %(meshes)r:
        mesh = jax.make_mesh(shape, ("data", "model"),
                             devices=jax.devices()[:4],
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        placed = jax.device_put(
            params, shd.param_shardings(model.param_specs, "tp", mesh))
        grid = mesh.devices
        ranks = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
            key = tuple(getattr(k, "key", getattr(k, "idx", None))
                        for k in path)
            for s in leaf.addressable_shards:
                r = int(np.flatnonzero(grid.reshape(-1) == s.device)[0])
                ranks.setdefault(r, {})[key] = np.asarray(s.data,
                                                          np.float32)
        out[arch][shape] = ranks
with open(%(path)r, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    import pickle
    path = str(tmp_path_factory.mktemp("shards") / "shards.pkl")
    run_in_subprocess(textwrap.dedent(_JAX_SHARDS % dict(
        meshes=SHARD_MESHES, path=path)), n_devices=4)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("shape", SHARD_MESHES, ids=str)
@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b"])
def test_rank_shards_equal_jax_addressable_shards(jax_shards, arch, shape):
    cfg = configs.smoke(arch)
    specs = build(cfg).param_specs
    whole_tree = jax_shards[arch]["whole"]
    whole = dict(tree_leaves_with_path(whole_tree))
    full = dict(tree_leaves_with_path(build(cfg).init(torch.Generator(),
                                                      "meta")))
    shards, plans = [], []
    for rank in range(4):
        mesh = dctx.Mesh(np.arange(4).reshape(shape), AXES, rank=rank)
        plan = shd.param_shardings(specs, "tp", mesh)
        mine = from_reference(whole_tree, cfg, "cpu", shardings=plan)
        want = jax_shards[arch][shape][rank]
        n_cut = 0
        for path, t in tree_leaves_with_path(mine):
            rpath, group = reference_path(cfg, path)
            ref = want[rpath] if group is None else want[rpath][group]
            np.testing.assert_array_equal(t.float().numpy(), ref,
                                          err_msg=str(path))
            n_cut += t.numel() < full[path].numel()
        assert n_cut > 0 or shape[1] == 1
        shards.append(mine)
        plans.append(plan)
    back = gather_shards(shards, plans)
    for path, t in tree_leaves_with_path(back):
        rpath, group = reference_path(cfg, path)
        ref = whole[rpath] if group is None else whole[rpath][group]
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(ref))
