"""The port's ``dist/`` against the JAX reference (CPU), and real ranks.

* The cache's sequence blocks (``sharding.seq_blocks``) follow the
  reference planner's ``cache_shardings(seq_shard=True)``: the sequence
  dim is cut over "model" exactly where the reference cuts it, for
  qwen2-7b at (1, 1), (1, 2), (1, 4), (2, 4) and (16, 16) and capacities
  that the axis does and does not divide, and each rank of the grid
  holds the block of its "model" coordinate.
* Ranks: 2 and 4 processes under gloo, joined through a ``FileStore`` in
  ``tmp_path`` (no ports, so xdist workers never collide), each with its
  own timeout (``RANK_TIMEOUT_S``). Every rank's merged
  ``seq_sharded_write_decode`` output matches JAX's ``decode_attention_ref``
  over the whole written cache (1e-5, fp32) and the blocks together equal
  the written cache bit for bit; the M-rank batcher's greedy streams are
  the same on every rank and equal the one-rank engine's under
  ``_assert_streams_match``'s near-tie rule.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from conftest import SRC
from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.kernels.decode_attention import ref as jref
from repro.models import build as jbuild
from repro_torch import configs
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, n_chips, spawn_ranks
from repro_torch.models import RunConfig, build
from repro_torch.serving import ContinuousBatcher, Engine, Request
from test_torch_decode import _assert_streams_match, _requests, qwen  # noqa

MESHES = [(1, 1), (1, 2), (1, 4), (2, 4), (16, 16)]
RANK_TIMEOUT_S = 120
OUT_TOL = 1e-5


# ---------------------------------------------------------------------------
# The cache's sequence blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len", [1024, 1000, 96])
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_seq_blocks_match_jax_cache_shardings(shape, max_len):
    cfg = jconfigs.get("qwen2-7b")
    want = jshd.cache_shardings(
        jbuild(cfg).cache_specs(16, max_len), cfg,
        AbstractMesh(shape, ("data", "model")), seq_shard=True)
    cut = [tuple(layer["k"].spec)[2] == "model" for layer in want.layers]
    assert len(set(cut)) == 1  # every layer's K the same way
    grid = np.arange(shape[0] * shape[1]).reshape(shape)
    for rank in (0, grid.size - 1):
        mesh = dctx.Mesh(grid, ("data", "model"), rank=rank)
        m, index = shd.seq_blocks(mesh, max_len)
        assert m == (shape[1] if cut[0] else 1)
        assert index == (mesh.coord("model") if cut[0] else 0)
    assert shd.seq_blocks(None, max_len) == (1, 0)


def test_mesh_context_and_constrain():
    mesh = make_host_mesh((1, 1))
    assert n_chips(mesh) == 1 and mesh.coord("model") == 0
    assert mesh.group("model") is None  # one rank: no process group
    assert dctx.dp_axes() == () and dctx.axis_size("model") == 1
    with dctx.mesh_context(mesh):
        assert dctx.get_mesh() is mesh and dctx.dp_axes() == ("data",)
        with pytest.raises(RuntimeError):
            with dctx.mesh_context(None):
                raise RuntimeError
        assert dctx.get_mesh() is mesh
    assert dctx.get_mesh() is None
    with pytest.raises(ValueError, match="needs 8 ranks"):
        make_host_mesh((2, 4))


def test_unported_layouts_name_their_roadmap_item(qwen):
    """The layout the port still refuses, naming its ROADMAP entry: a
    GQA layout whose q-head blocks map onto no uniform kv group (6 q
    heads over 2 kv heads on 3 ranks: 2 a rank, groups of 3). Rows cut
    over two data axes, once refused here, are served: over ("pod",
    "data") taken together where their 4 ranks divide the rows, whole
    where only a prefix of the axes would (the port's all-or-none rule),
    in the cache as in the inputs. An SSM model under "model" and an
    encoder-decoder model on several ranks, once refused here, are now
    laid out: mamba2's per-head leaves cut by "heads" and its
    "ssm_inner" leaves whole, as the reference's planner leaves them;
    whisper's ``EncDecCache`` with its self and cross K/V rows over
    "data" and kv heads over "model". (The ZeRO layouts "fsdp" and
    "fsdp_tp" are served: ``test_torch_zero.py``; the families served on
    gloo ranks: ``test_torch_mesh_families.py``.)"""
    def mesh(shape):
        return dctx.Mesh(np.arange(int(np.prod(shape))).reshape(shape),
                         ("data", "model"))
    gqa = dataclasses.replace(qwen["cfg"], n_heads=6, n_kv_heads=2,
                              name="gqa-6-2")
    with pytest.raises(NotImplementedError,
                       match=r"Queue 3, differences by design"):
        Engine(build(gqa), RunConfig(), device="cpu", mesh=mesh((1, 3)))
    grid = dctx.Mesh(np.arange(4).reshape(2, 2, 1), ("pod", "data", "model"))
    eng = Engine(build(qwen["cfg"]), RunConfig(), device="cpu", mesh=grid)
    for rows, local in ((4, 1), (8, 2), (2, 2)):
        assert eng.shard_inputs({"tokens": np.zeros((rows, 8), np.int32)}
                                )["tokens"].shape == (local, 8)
        cache = eng.new_cache(rows, 16)
        assert cache.row_shards == rows // local
        assert cache.lengths.shape == (local,)

    cfg = configs.smoke("mamba2-130m")
    eng = Engine(build(cfg), RunConfig(), device="cpu", mesh=mesh((1, 2)))
    assert eng.strategy == "tp"
    ssm = eng.params_sharding["blocks"][0]["ssm"]
    assert ssm["wdt"].spec == (None, "model")
    assert ssm["A_log"].spec == ("model",) and ssm["D"].spec == ("model",)
    assert all(ssm[k].replicated for k in ("wx", "wz", "out_proj",
                                           "norm_scale", "conv_wx"))
    cache = eng.new_cache(4, 16)
    assert cache.layers[0]["state"].shape[0] == 4  # batch-only rule

    cfg = configs.smoke("whisper-base")
    for shape, rows, kv in (((2, 1), 2, cfg.n_kv_heads),
                            ((1, 2), 4, cfg.n_kv_heads // 2),
                            ((2, 2), 2, cfg.n_kv_heads // 2)):
        eng = Engine(build(cfg), RunConfig(), device="cpu",
                     mesh=mesh(shape))
        cache = eng.new_cache(4, 16, enc_len=12)
        assert cache.row_shards == 4 // rows
        assert cache.cross_k[0].shape == (rows, 12, kv, cfg.head_dim)
        assert cache.self_v[-1].shape == (rows, 16, kv, cfg.head_dim)
        assert cache.lengths.shape == (rows,)
        frames = eng.shard_inputs({"enc_embeds": np.zeros((4, 12, 64)),
                                   "tokens": np.zeros((4, 8), np.int32)})
        assert frames["enc_embeds"].shape == (rows, 12, 64)
        assert frames["tokens"].shape == (rows, 8)


# ---------------------------------------------------------------------------
# Ranks under gloo
# ---------------------------------------------------------------------------

_HEADER = """
import sys, json
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_from_env, make_host_mesh, rank_env
init_from_env("cpu")
rank, world = rank_env()
mesh = make_host_mesh((1, world))
"""

WRITE_DECODE = _HEADER + """
from repro_torch.dist import collectives, mesh_context
spec = json.loads(sys.argv[1])
rng = np.random.default_rng(0)
x = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
     for n, s in (("q", (4, 1, 8, 32)), ("kn", (4, 1, 2, 32)),
                  ("vn", (4, 1, 2, 32)), ("kc", (4, 128, 2, 32)),
                  ("vc", (4, 128, 2, 32)))}
sl = 128 // world
kb = x["kc"][:, rank * sl:(rank + 1) * sl].clone()
vb = x["vc"][:, rank * sl:(rank + 1) * sl].clone()
collectives.set_fused_partials(spec["fused"])
with mesh_context(mesh):
    o, kb, vb = collectives.seq_sharded_write_decode(
        x["q"], x["kn"], x["vn"], kb, vb,
        torch.tensor(spec["lengths"], dtype=torch.int32),
        window=spec["window"], cap=spec["cap"], seq_shards=world)
np.savez(spec["out"] + f"/rank{rank}.npz", o=o.numpy(), k=kb.numpy(),
         v=vb.numpy())
"""

BATCHER = _HEADER + """
from repro_torch import configs
from repro_torch.models import RunConfig, build
from repro_torch.serving import ContinuousBatcher, Engine, Request
spec = json.loads(sys.argv[1])
cfg = configs.smoke("qwen2-7b")
params = torch.load(spec["params"])
engine = Engine(build(cfg), RunConfig(cache_pad=56), device="cpu",
                mesh=mesh, seq_shard=True)
b = ContinuousBatcher(engine, params, n_slots=3, max_len=64)
reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=n)
        for i, (p, n) in enumerate(spec["requests"])]
b.submit_many(reqs)
b.run()
json.dump({"streams": [r.generated for r in reqs],
           "block": list(b.cache.layers[0]["k"].shape),
           "rounds": b.rounds, "decode_dispatches": b.decode_dispatches},
          open(spec["out"] + f"/rank{rank}.json", "w"))
"""


def _run_ranks(tmp_path, script, world, spec):
    path = tmp_path / "rank.py"
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    done = spawn_ranks([str(path), json.dumps(spec)], world,
                       store_path=str(tmp_path / "store"),
                       timeout=RANK_TIMEOUT_S, env=env)
    failed = [(r, p.returncode, p.stderr[-3000:])
              for r, p in enumerate(done) if p.returncode]
    assert not failed, failed
    assert all("backend gloo" in p.stdout for p in done)
    return done


@pytest.mark.parametrize("fused", [True, False], ids=["wrapper", "plain"])
@pytest.mark.parametrize("world", [2, 4])
def test_write_decode_across_ranks_matches_jax(tmp_path, world, fused):
    lengths = [0, 31, 64, 100]  # shard boundaries at 32 (4 ranks), 64 (2)
    window, cap = (24, 30.0) if fused else (None, None)
    _run_ranks(tmp_path, WRITE_DECODE, world,
               dict(lengths=lengths, window=window, cap=cap, fused=fused,
                    out=str(tmp_path)))
    rng = np.random.default_rng(0)
    q, kn, vn, kc, vc = (rng.standard_normal(s).astype(np.float32) for s in (
        (4, 1, 8, 32), (4, 1, 2, 32), (4, 1, 2, 32), (4, 128, 2, 32),
        (4, 128, 2, 32)))
    rows = np.arange(4)
    kc[rows, lengths], vc[rows, lengths] = kn[:, 0], vn[:, 0]
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q[:, 0]), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths, jnp.int32), window=window, softcap=cap))
    outs = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for out in outs:
        np.testing.assert_allclose(out["o"][:, 0], want, atol=OUT_TOL)
        np.testing.assert_array_equal(out["o"], outs[0]["o"])
    np.testing.assert_array_equal(
        np.concatenate([o["k"] for o in outs], axis=1), kc)
    np.testing.assert_array_equal(
        np.concatenate([o["v"] for o in outs], axis=1), vc)


@pytest.mark.parametrize("world", [2, 4])
def test_batcher_across_ranks_matches_one_rank(tmp_path, qwen, world):
    reqs = _requests(Request, qwen["cfg"].vocab_size)
    one = Engine(build(qwen["cfg"]), RunConfig(cache_pad=56), device="cpu",
                 mesh=make_host_mesh((1, 1)), seq_shard=True)
    b = ContinuousBatcher(one, qwen["params"], n_slots=3, max_len=64)
    b.submit_many(reqs)
    b.run()
    torch.save(qwen["params"], tmp_path / "params.pt")
    _run_ranks(tmp_path, BATCHER, world, dict(
        params=str(tmp_path / "params.pt"), out=str(tmp_path),
        requests=[(r.prompt.tolist(), r.max_new_tokens) for r in reqs]))
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]
    assert all(o["streams"] == outs[0]["streams"] for o in outs)
    assert outs[0]["block"] == [3, 64 // world, 2, 16]
    assert outs[0]["decode_dispatches"] == outs[0]["rounds"] == b.rounds
    _assert_streams_match(qwen, [r.prompt for r in reqs],
                          [r.generated for r in reqs], outs[0]["streams"])
