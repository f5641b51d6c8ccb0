"""The production mesh (``launch.mesh.make_production_mesh``) and rows cut
over two data axes, against the reference, on the CPU. About 40 s
serially.

* The rank grid of (16, 16) and (2, 16, 16) equals the device ids of
  JAX's ``make_production_mesh`` (a subprocess over 512 host devices).
* Under the dry run's "fake" backend one process plays a rank of 512:
  its line groups hold 16 ("data"), 16 ("model"), 2 ("pod") and 32
  ("pod" and "data" together) ranks; a world of another size raises.
* Smoke qwen2-7b served on a ("pod", "data", "model") (2, 2, 1) mesh of
  four gloo ranks, rows cut over "pod" x "data", against the reference's
  engine on the same three-axis host mesh: prefill logits within
  ``LOGIT_REL_TOL`` and greedy ``ContinuousBatcher`` streams equal up to
  near-ties (``test_torch_tp``'s rule); every rank's are equal.
"""
import os
import pickle
import textwrap

import jax
import numpy as np
import pytest
import torch

from conftest import SRC, run_in_subprocess
from repro import configs as jconfigs
from repro.models import build as jbuild
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, spawn_ranks
from repro_torch.models.convert import from_reference
from test_torch_tp import _assert_parted_at_near_ties, _logits_close

RANK_TIMEOUT_S = 240
ARCH = "qwen2-7b"
AXES = ("pod", "data", "model")

_JAX = """
import pickle
import jax, numpy as np
from repro import configs
from repro.launch.mesh import make_production_mesh
from repro.models import RunConfig, build
from repro.serving import ContinuousBatcher, Engine, Request
spec = pickle.load(open(%(spec)r, "rb"))
out = {"grid": {mp: np.vectorize(lambda d: d.id)(
    make_production_mesh(multi_pod=mp).devices) for mp in (False, True)}}
cfg = configs.smoke(spec["arch"])
model = build(cfg)
params = jax.jit(model.init)(jax.random.PRNGKey(0))
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                     devices=jax.devices()[:4],
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
eng = Engine(model, RunConfig(cache_pad=56), mesh=mesh)
sp = eng.shard_params(params)
b = ContinuousBatcher(eng, sp, n_slots=4, max_len=64)
reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=n)
        for i, (p, n) in enumerate(spec["requests"])]
b.submit_many(reqs)
b.run()
out["streams"] = [[int(t) for t in r.generated] for r in reqs]
out["logits"] = np.asarray(eng.prefill(sp, np.asarray(
    spec["prefill"], np.int32))[0], np.float32)
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
from repro_torch.dist import collectives
from repro_torch.models import RunConfig, build
from repro_torch.serving import ContinuousBatcher, Engine, Request
spec = pickle.load(open(sys.argv[1], "rb"))
mesh = make_host_mesh((2, 2, 1), ("pod", "data", "model"))
eng = Engine(build(configs.smoke(spec["arch"])),
             RunConfig(cache_pad=56, attn_impl="pallas"), device="cpu",
             mesh=mesh)
sp = eng.shard_params(torch.load(spec["params"]))
b = ContinuousBatcher(eng, sp, n_slots=4, max_len=64)
reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=n)
        for i, (p, n) in enumerate(spec["requests"])]
collectives.reset_stats()
b.submit_many(reqs)
b.run()
out = {"streams": [r.generated for r in reqs],
       "row_shards": b.cache.row_shards,
       "rows": int(b.cache.lengths.shape[0]),
       "stats": {k: v[0] for k, v in collectives.STATS.items()},
       "logits": eng.prefill(sp, np.asarray(spec["prefill"]))[0]
       .float().numpy()}
pickle.dump(out, open(spec["out"] + f"/rank{rank}.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("production_mesh")
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, 256, n).tolist(), m)
                for n, m in [(8, 5), (16, 6), (8, 4), (16, 5), (8, 6)]]
    jparams = jax.jit(jbuild(jconfigs.smoke(ARCH)).init)(
        jax.random.PRNGKey(0))
    torch.save(from_reference(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
        configs.smoke(ARCH), device="cpu"), tmp / "params.pt")
    spec = dict(arch=ARCH, requests=requests, out=str(tmp),
                params=str(tmp / "params.pt"),
                prefill=rng.integers(0, 256, (4, 8)).tolist())
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    run_in_subprocess(textwrap.dedent(_JAX % dict(
        spec=str(tmp / "spec.pkl"), out=str(tmp / "jax.pkl"))),
        n_devices=512)
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
    return want, got, requests, jparams


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rank_grid_equals_jax_devices(runs, multi_pod):
    want = runs[0]["grid"][multi_pod]
    with dryrun.fake_world(512 if multi_pod else 256, 5):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.axis_names == (AXES if multi_pod else AXES[1:])
        np.testing.assert_array_equal(mesh.devices, want)
        assert mesh.rank == 5 and mesh.coord("model") == 5


def test_line_groups_under_the_fake_backend():
    dist = torch.distributed
    with dryrun.fake_world(512, 37):
        mesh = make_production_mesh(multi_pod=True)
        sizes = {axes: dist.get_world_size(mesh.group(axes))
                 for axes in ("data", "model", "pod", ("pod", "data"))}
        assert sizes == {"data": 16, "model": 16, "pod": 2,
                         ("pod", "data"): 32}
        # rank 37 = (pod 0, data 2, model 5): its data line runs down column
        # 5 of pod 0, its pod line across the two pods
        assert dist.get_process_group_ranks(mesh.group("data")) == list(
            range(5, 256, 16))
        assert dist.get_process_group_ranks(mesh.group("pod")) == [37, 293]


@pytest.mark.parametrize("world,multi_pod", [(8, False), (256, True)])
def test_wrong_world_size_raises(world, multi_pod):
    with dryrun.fake_world(world, 0):
        with pytest.raises(ValueError, match=f"needs {512 if multi_pod else 256} "
                           f"ranks; the process group has {world}"):
            make_production_mesh(multi_pod=multi_pod)


def test_rows_over_pod_and_data_match_jax_on_the_same_mesh(runs):
    want, got, requests, jparams = runs
    for r in got[1:]:  # every rank hands back the whole batch's results
        assert r["streams"] == got[0]["streams"]
        np.testing.assert_array_equal(r["logits"], got[0]["logits"])
    # four slots cut over "pod" x "data": one row a rank
    assert got[0]["row_shards"] == 4 and got[0]["rows"] == 1
    assert got[0]["stats"]["all_gather_data"] > 0
    assert got[0]["stats"]["broadcast"] > 0
    _logits_close(got[0]["logits"], want["logits"])
    _assert_parted_at_near_ties(jconfigs.smoke(ARCH), jparams,
                                [p for p, _ in requests], want["streams"],
                                got[0]["streams"])
