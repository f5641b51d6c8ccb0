"""The port's training substrate (``repro_torch.training``) against the
reference, on the CPU at smoke size.

* OPTIMIZERS — the schedules, ``global_norm`` and ``AdamW`` /
  ``Adafactor.update`` fed the same fp32 grads equal JAX's within fp32
  rounding (rtol 1e-6; both optimizers run on the port's per-layer
  leaves, the reference's functions being generic over trees).
* GRADS — per leaf against ``jax.value_and_grad`` of the reference's loss
  on the same params (``models.convert.from_reference``) and batch, for
  the classifier and the LM: relative RMS error at most ``GRAD_RTOL``
  (0.1; bf16 forwards that differ by a few ulps between the frameworks,
  0.055 the worst leaf measured). Without rotary positions the key bias's
  grad is zero by symmetry (softmax over keys ignores ``q . bk``), so
  there the port is held to rounding noise instead.
* TRAJECTORY — ten AdamW steps: locked to the reference's state at every
  step, the loss within ``LOSS_RTOL`` and the share of master weights off
  by more than lr/2 at most ``SHARE_OFF`` (AdamW moves every element by
  about lr, so elementwise closeness is not the measure); free-running on
  the LM, every loss within 2%.
* REMAT AND MICROBATCHING — ``remat="full"`` and ``"dots"`` equal the
  plain step bit for bit on the CPU, "dots" recomputes no ``mm`` and
  "full" recomputes every one; ``microbatch`` accumulates to the plain
  step's grads within bf16 rounding. ``attn_impl="pallas"`` raises under
  autograd and does not fall back.
* CHECKPOINTS — round trip, retention, ``latest_step``, the loader
  cursor (``tests/test_end_to_end.py``'s cases), the reference's own
  ``restore`` reading a checkpoint the port wrote, and ``launch.train
  --crash-at-step`` resuming to the uninterrupted run's params bit for
  bit.
* POD — ``compress_psum`` ("none", "bf16", "int8", an unknown method) on
  2 and 4 gloo ranks against the numpy formula, and the "pod" branch of
  the train step with int8 compression against the same step emulated in
  one process (bit for bit) and the one-process step (within int8
  quantization).
* THE CASE STUDY — its trained classifier beats chance on the CPU.
"""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC
from repro import configs as jconfigs
from repro.data import TrainLoader as JTrainLoader
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.training import checkpoint as jcheckpoint
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import configs
from repro_torch.data import TrainLoader, imdb_reviews
from repro_torch.dist.collectives import compress_psum
from repro_torch.examples import sentiment_case_study
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import RunConfig, build
from repro_torch.models.common import is_axspec
from repro_torch.models.convert import from_reference, reference_path
from repro_torch.models.transformer import lm_specs
from repro_torch.training import checkpoint, optimizer, train_step
from repro_torch.tree import (tree_leaves, tree_leaves_with_path,
                              tree_map, tree_map_with_path, tree_unflatten)

GRAD_RTOL = 0.1
LOSS_RTOL = 1e-2
SHARE_OFF = 0.02
LR = 1e-3
RANK_TIMEOUT_S = 120
ARCHS = ["distilbert-imdb", "qwen2-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def to_port(tree, cfg, dtype=None):
    """A reference tree in the reference's stacked layout -> the port's
    per-layer tree of CPU tensors (``dtype``, default each leaf's spec)."""
    ref = dict(tree_leaves_with_path(_np32(tree)))

    def conv(path, spec):
        rpath, group = reference_path(cfg, path)
        arr = ref[rpath] if group is None else ref[rpath][group]
        return torch.tensor(arr).to(dtype or spec.dtype)
    return tree_map_with_path(conv, lm_specs(cfg), is_axspec)


@pytest.fixture(scope="module", params=ARCHS)
def model_pair(request):
    arch = request.param
    jcfg, cfg = jconfigs.smoke(arch), configs.smoke(arch)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=from_reference(_np32(jparams), cfg, device="cpu"))


def _data(cfg, n=64, seq=32):
    """(tokens, labels): planted-signal reviews for the classifier, a
    next-token task for the LM."""
    if cfg.num_labels:
        return imdb_reviews(n=n, seq_len=seq, vocab=cfg.vocab_size,
                            signal_frac=0.15)
    t = np.random.default_rng(0).integers(0, cfg.vocab_size, (n, seq + 1))
    t = t.astype(np.int32)
    return t[:, :-1], t[:, 1:]


def _bk_grad_is_zero(cfg) -> bool:
    """Without rotary positions a key bias adds ``q . bk`` to every logit
    of a query's row, which softmax ignores: its grad is zero but for
    rounding. RoPE rotates the bias by position, so there it is real."""
    return cfg.pos != "rope"


def _torch_batch(batch):
    return {k: torch.as_tensor(np.asarray(v)).long() for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def test_schedules_equal_jax():
    for steps in (np.arange(0, 120), np.arange(0, 5)):
        for pf, jf in ((optimizer.warmup_cosine(3e-4, 10, 100),
                        jopt.warmup_cosine(3e-4, 10, 100)),
                       (optimizer.warmup_cosine(1e-3, 0, 50, 0.2),
                        jopt.warmup_cosine(1e-3, 0, 50, 0.2)),
                       (optimizer.constant(3e-3), jopt.constant(3e-3))):
            got = np.array([float(pf(torch.tensor(s, dtype=torch.int32)))
                            for s in steps])
            want = np.array([float(jf(jnp.int32(s))) for s in steps])
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def _port_tree_np(params, seed):
    """Random fp32 arrays shaped as the port's param tree (numpy)."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: rng.standard_normal(tuple(p.shape))
                    .astype(np.float32), params)


def _assert_tree_close(got, want, rtol=1e-6, atol=1e-7):
    g = dict(tree_leaves_with_path(got))
    w = dict(tree_leaves_with_path(_np32(want)))
    assert g.keys() == w.keys()
    for path in g:
        np.testing.assert_allclose(g[path].float().numpy(), w[path],
                                   rtol=rtol, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_equals_jax(model_pair, clip):
    params = model_pair["params"]
    jparams = tree_map(lambda p: jnp.asarray(p.float().numpy()).astype(
        jnp.bfloat16 if p.dtype == torch.bfloat16 else jnp.float32), params)
    popt_ = optimizer.AdamW(schedule=optimizer.warmup_cosine(1e-3, 2, 10),
                            clip_norm=clip)
    jopt_ = jopt.AdamW(schedule=jopt.warmup_cosine(1e-3, 2, 10),
                       clip_norm=clip)
    state, jstate = popt_.init(params), jopt_.init(jparams)
    for i in range(3):  # three updates: moments and bias corrections move
        g = _port_tree_np(params, i)
        params, state, stats = popt_.update(
            tree_map(torch.from_numpy, g), state, params)
        jparams, jstate, jstats = jopt_.update(
            tree_map(jnp.asarray, g), jstate, jparams)
    for key in ("m", "v", "master"):
        _assert_tree_close(state[key], jstate[key])
    assert int(state["step"]) == int(jstate["step"]) == 3
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(stats["lr"]), float(jstats["lr"]),
                               rtol=1e-6)
    # params are the master weights cast to the param dtype
    for p, m in zip(tree_leaves(params), tree_leaves(state["master"])):
        assert torch.equal(p, m.to(p.dtype))


def test_adafactor_update_equals_jax(model_pair):
    params = model_pair["params"]
    jparams = tree_map(lambda p: jnp.asarray(p.float().numpy()), params)
    params = tree_map(lambda p: p.float(), params)
    popt_ = optimizer.Adafactor(schedule=optimizer.constant(1e-2),
                                weight_decay=0.01)
    jopt_ = jopt.Adafactor(schedule=jopt.constant(1e-2), weight_decay=0.01)
    state, jstate = popt_.init(params), jopt_.init(jparams)
    for i in range(3):
        g = _port_tree_np(params, 10 + i)
        params, state, stats = popt_.update(
            tree_map(torch.from_numpy, g), state, params)
        jparams, jstate, jstats = jopt_.update(
            tree_map(jnp.asarray, g), jstate, jparams)
    _assert_tree_close(params, jparams, rtol=2e-6, atol=1e-7)
    _assert_tree_close(state["factored"], jstate["factored"], rtol=2e-6)
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)


def test_global_norm_equals_jax(model_pair):
    g = _port_tree_np(model_pair["params"], 3)
    np.testing.assert_allclose(
        float(optimizer.global_norm(tree_map(torch.from_numpy, g))),
        float(jopt.global_norm(tree_map(jnp.asarray, g))), rtol=1e-6)


# ---------------------------------------------------------------------------
# Grads against jax.value_and_grad
# ---------------------------------------------------------------------------


def test_grads_match_jax_value_and_grad(model_pair):
    cfg, jcfg = model_pair["cfg"], model_pair["jcfg"]
    tokens, labels = _data(cfg, n=8)
    batch = {"tokens": tokens, "labels": labels}
    (jl, _), jg = jax.value_and_grad(
        jts.make_loss_fn(jbuild(jcfg), JRunConfig()), has_aux=True)(
        model_pair["jparams"], {k: jnp.asarray(v) for k, v in batch.items()})
    (pl, metrics), pg = train_step.value_and_grad(
        train_step.make_loss_fn(build(cfg), RunConfig()),
        model_pair["params"], _torch_batch(batch))
    np.testing.assert_allclose(float(pl), float(jl), rtol=LOSS_RTOL)
    assert set(metrics) == ({"loss", "accuracy", "aux_loss"}
                            if cfg.num_labels else {"loss", "aux_loss"})
    want = to_port(jg, cfg, torch.float32)
    symmetric = _bk_grad_is_zero(cfg)
    ref_bq = {}
    for (path, g), (_, w), p in zip(tree_leaves_with_path(pg),
                                    tree_leaves_with_path(want),
                                    tree_leaves(model_pair["params"])):
        assert g.dtype == p.dtype  # grads in the param dtype
        g, w = g.float().numpy(), w.numpy()
        rms = float(np.sqrt(np.mean(w ** 2)))
        if path[-1] == "bq":
            ref_bq[path[:-1]] = rms
        if symmetric and path[-1] == "bk":  # rounding noise only
            continue
        err = float(np.sqrt(np.mean((g - w) ** 2)))
        assert err <= GRAD_RTOL * rms, (path, err, rms)
    for path, g in tree_leaves_with_path(pg):
        if symmetric and path[-1] == "bk":
            noise = float(g.float().pow(2).mean().sqrt())
            assert noise <= 1e-2 * ref_bq[path[:-1]], (path, noise)


# ---------------------------------------------------------------------------
# Ten steps against the reference
# ---------------------------------------------------------------------------


def _share_off(got, want, tol):
    off = tot = 0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        d = (g.float() - w.float()).abs()
        off += int((d > tol).sum())
        tot += d.numel()
    return off / tot


def test_ten_steps_locked_to_the_reference(model_pair):
    cfg, jcfg = model_pair["cfg"], model_pair["jcfg"]
    tokens, labels = _data(cfg, n=128)
    jo = jopt.AdamW(schedule=jopt.constant(LR))
    po = optimizer.AdamW(schedule=optimizer.constant(LR))
    jstep = jax.jit(jts.make_train_step(jbuild(jcfg), JRunConfig(), jo))
    pstep = train_step.make_train_step(build(cfg), RunConfig(), po)
    jparams = model_pair["jparams"]
    jstate = jo.init(jparams)
    loader = JTrainLoader(tokens, labels, batch=16)
    for i in range(10):
        batch = loader.next_batch()
        params = to_port(jparams, cfg)
        state = {k: to_port(jstate[k], cfg, torch.float32)
                 for k in ("m", "v", "master")}
        state["step"] = torch.tensor(int(jstate["step"]), dtype=torch.int32)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        params, state, pm = pstep(params, state, batch)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        share = _share_off(state["master"],
                           to_port(jstate["master"], cfg, torch.float32),
                           LR / 2)
        assert share <= SHARE_OFF, (i, share)


def test_lm_trajectory_free_running_tracks_the_reference():
    jcfg, cfg = jconfigs.smoke("qwen2-7b"), configs.smoke("qwen2-7b")
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    params = from_reference(_np32(jparams), cfg, device="cpu")
    tokens, labels = _data(cfg, n=128)
    jo = jopt.AdamW(schedule=jopt.constant(LR))
    po = optimizer.AdamW(schedule=optimizer.constant(LR))
    jstep = jax.jit(jts.make_train_step(jbuild(jcfg), JRunConfig(), jo))
    pstep = train_step.make_train_step(build(cfg), RunConfig(), po)
    jstate, state = jo.init(jparams), po.init(params)
    loader = TrainLoader(tokens, labels, batch=16)
    got, want = [], []
    for _ in range(10):
        batch = loader.next_batch()
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        params, state, pm = pstep(params, state, batch)
        got.append(float(pm["loss"]))
        want.append(float(jm["loss"]))
    np.testing.assert_allclose(got, want, rtol=0.02)
    assert got[-1] < got[0] and want[-1] < want[0]


# ---------------------------------------------------------------------------
# Remat, microbatching, and the kernel under autograd
# ---------------------------------------------------------------------------


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts ``aten.mm`` calls (forward, recompute and backward)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _one_step(model, run, params, batch):
    opt = optimizer.AdamW(schedule=optimizer.constant(LR))
    return train_step.make_train_step(model, run, opt)(
        params, opt.init(params), batch)


def test_remat_full_and_dots_equal_the_plain_step(model_pair):
    cfg = model_pair["cfg"]
    model = build(cfg)
    tokens, labels = _data(cfg, n=8)
    batch = {"tokens": tokens, "labels": labels}
    plain = _one_step(model, RunConfig(), model_pair["params"], batch)
    loss_fn = train_step.make_loss_fn
    counts = {}
    for remat in ("none", "full", "dots"):
        run = RunConfig(remat=remat)
        if remat != "none":
            got = _one_step(model, run, model_pair["params"], batch)
            for a, b in zip(tree_leaves(got[:2]), tree_leaves(plain[:2])):
                assert torch.equal(a, b), remat
            assert float(got[2]["loss"]) == float(plain[2]["loss"])
        with _CountMM() as mode:
            train_step.value_and_grad(loss_fn(model, run),
                                      model_pair["params"],
                                      _torch_batch(batch))
        counts[remat] = mode.n
    # "dots" keeps every mm output: nothing recomputed; "full" recomputes
    # each layer's forward mms once more
    assert counts["dots"] == counts["none"]
    assert counts["full"] > counts["none"]


def test_microbatching_accumulates_the_plain_grads(model_pair):
    cfg = model_pair["cfg"]
    model = build(cfg)
    tokens, labels = _data(cfg, n=32)
    batch = _torch_batch({"tokens": tokens, "labels": labels})
    loss_fn = train_step.make_loss_fn(model, RunConfig())
    (_, m_plain), g_plain = train_step.value_and_grad(
        loss_fn, model_pair["params"], batch)
    g_micro, m_micro = train_step._microbatch_grads(
        loss_fn, model_pair["params"], batch, 4)
    np.testing.assert_allclose(float(m_micro["loss"]),
                               float(m_plain["loss"]), rtol=1e-3)
    for (path, a), b in zip(tree_leaves_with_path(g_micro),
                            tree_leaves(g_plain)):
        assert a.dtype == torch.float32
        b = b.float()
        if _bk_grad_is_zero(cfg) and path[-1] == "bk":
            continue  # rounding noise only (see the grads test)
        err = float((a - b).pow(2).mean().sqrt())
        assert err <= 0.02 * float(b.pow(2).mean().sqrt()), path
    # and the step built with microbatch=8 takes that path
    step = _one_step(model, RunConfig(microbatch=8), model_pair["params"],
                     {"tokens": tokens, "labels": labels})
    np.testing.assert_allclose(float(step[2]["loss"]),
                               float(m_micro["loss"]), rtol=1e-6)


def test_flash_kernel_under_autograd_raises(model_pair):
    cfg = model_pair["cfg"]
    tokens, labels = _data(cfg, n=4)
    with pytest.raises(NotImplementedError, match="no backward"):
        _one_step(build(cfg), RunConfig(attn_impl="pallas"),
                  model_pair["params"], {"tokens": tokens, "labels": labels})
    # without autograd the same params classify / prefill through it
    with torch.no_grad():
        logits, _ = build(cfg).forward(RunConfig(attn_impl="pallas"),
                                       model_pair["params"],
                                       {"tokens": torch.as_tensor(tokens)})
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# Checkpoints and the training driver
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg = configs.smoke("qwen2-7b")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = optimizer.AdamW(schedule=optimizer.constant(1e-3))
    opt_state = opt.init(params)
    loader = TrainLoader(np.zeros((64, 8), np.int32),
                         np.zeros((64, 8), np.int32), batch=8, seed=3)
    loader.next_batch(), loader.next_batch()
    path = checkpoint.save(str(tmp_path), 2,
                           {"params": params, "opt": opt_state},
                           extra={"loader": loader.state()})
    assert os.path.exists(path)
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    like = {"params": tree_map(torch.zeros_like, params),
            "opt": tree_map(torch.zeros_like, opt_state)}
    state, manifest = checkpoint.restore(str(tmp_path), like)
    assert manifest["step"] == 2
    assert set(manifest) >= {"step", "n_leaves", "treedef", "dtypes",
                             "extra"}
    for a, b in zip(tree_leaves(state), tree_leaves(
            {"params": params, "opt": opt_state})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    l2 = TrainLoader(np.zeros((64, 8), np.int32),
                     np.zeros((64, 8), np.int32), batch=8, seed=3)
    l2.restore(manifest["extra"]["loader"])
    assert l2.cursor == loader.cursor
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(tmp_path), {"params": params})


def test_checkpoint_retention(tmp_path):
    state = {"x": torch.ones((4,))}
    for s in range(6):
        checkpoint.save(str(tmp_path), s, state, keep=3)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 3
    assert checkpoint.latest_step(str(tmp_path)) == 5
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), state)


def test_reference_restores_a_checkpoint_the_port_wrote(tmp_path):
    """Same layout: leaf order, bf16 bytes and the dtype manifest let the
    reference's ``restore`` read the port's checkpoint into the same tree
    of jax arrays."""
    cfg = configs.smoke("distilbert-imdb")
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    opt = optimizer.AdamW(schedule=optimizer.constant(1e-3))
    state = {"params": params, "opt": opt.init(params)}
    checkpoint.save(str(tmp_path), 7, state, extra={"note": "port"})
    like = tree_map(lambda t: jnp.zeros(tuple(t.shape), {
        torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
        torch.int32: jnp.int32}[t.dtype]), state)
    back, manifest = jcheckpoint.restore(str(tmp_path), like)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "port"}
    got = dict(tree_leaves_with_path(_np32(back)))
    for path, t in tree_leaves_with_path(state):
        np.testing.assert_array_equal(got[path], t.float().numpy())


def test_train_driver_crash_resume_is_bit_exact(tmp_path):
    common = ["--smoke", "--device", "cpu", "--steps", "12",
              "--ckpt-every", "4", "--log-every", "4"]
    crashed = train_launch.main(common + [
        "--ckpt-dir", str(tmp_path / "a"), "--crash-at-step", "6"])
    straight = train_launch.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert crashed["steps_run"] == 8 and straight["steps_run"] == 12
    assert crashed["final_loss"] == straight["final_loss"]
    for a, b in zip(tree_leaves(crashed["params"]),
                    tree_leaves(straight["params"])):
        assert torch.equal(a, b)
    assert not torch.are_deterministic_algorithms_enabled()


class _GivenInit:
    """A ``build(cfg)`` facade whose ``init`` hands back given params (in
    the port, the reference's converted: its own init draws other
    numbers; in fp32, the same in both packages)."""

    def __init__(self, model, params):
        self._model, self._params = model, params

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init(self, *args, **kwargs):
        return self._params


def _outcome(main, argv):
    """("trained", (first, final loss)) or ("raised", exception type)."""
    try:
        out = main(argv)
    except Exception as e:  # the reference's own failure is the outcome
        return "raised", type(e)
    return "trained", (out["first_loss"], out["final_loss"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b", "whisper-base",
                                  "distilbert-imdb"])
def test_train_cli_per_family_matches_the_reference(arch, tmp_path,
                                                       monkeypatch):
    """``launch.train --arch`` on the reference's params: 3 steps of its
    loader's next-token batches, first and final loss within
    ``LOSS_RTOL``. The smoke jamba amplifies bf16 rounding (grad norms
    250-310, a final loss 1.0% apart in bf16), so it trains in fp32 in
    both packages (``test_torch_families._fp32_everywhere``). Two archs
    take batches the reference's loader does not make, and both packages
    raise the same exception type: whisper-base needs frame embeddings (a
    ``KeyError``), distilbert-imdb's classifier one label a row (a
    ``ValueError``)."""
    from repro.launch import train as jtrain
    from test_torch_families import _fp32_everywhere
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
            "--seq-len", "16", "--log-every", "1"]
    jcfg, cfg = jconfigs.smoke(arch), configs.smoke(arch)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    params = from_reference(_np32(jparams), cfg, device="cpu")
    fp32 = arch.startswith("jamba")
    if fp32:
        jparams = jax.tree.map(lambda x: x.astype(jnp.float32), jparams)
        params = tree_map(lambda t: t.float(), params)
        monkeypatch.setattr(jtrain, "build",
                            lambda c: _GivenInit(jbuild(c), jparams))
    monkeypatch.setattr(train_launch, "build",
                        lambda c: _GivenInit(build(c), params))
    with _fp32_everywhere() if fp32 else contextlib.nullcontext():
        want = _outcome(jtrain.main,
                        argv + ["--ckpt-dir", str(tmp_path / "ref")])
        got = _outcome(train_launch.main, argv + [
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    assert got[0] == want[0], (got, want)
    if want[0] == "raised":
        assert got[1] is want[1]
        assert arch in ("whisper-base", "distilbert-imdb")
        return
    np.testing.assert_allclose(got[1], want[1], rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# compress_psum and the pod step on gloo ranks
# ---------------------------------------------------------------------------

_HEADER = """
import sys, json
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_from_env, make_host_mesh, rank_env
init_from_env("cpu")
rank, world = rank_env()
mesh = make_host_mesh((world,), ("pod",))
spec = json.loads(sys.argv[1])
"""

COMPRESS = _HEADER + """
from repro_torch.dist.collectives import compress_psum
x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
    (64, 32)).astype(np.float32) * (rank + 1))
out = {m: compress_psum(x, "pod", m, mesh).numpy()
       for m in ("none", "bf16", "int8")}
try:
    compress_psum(x, "pod", "fp4", mesh)
    out["raised"] = np.array(False)
except ValueError:
    out["raised"] = np.array(True)
np.savez(spec["out"] + f"/rank{rank}.npz", **out)
"""

POD = _HEADER + """
from repro_torch import configs
from repro_torch.data import imdb_reviews
from repro_torch.models import RunConfig, build
from repro_torch.training import optimizer, train_step
from repro_torch.tree import tree_leaves
cfg = configs.smoke("distilbert-imdb")
model = build(cfg)
params = model.init(torch.Generator().manual_seed(0), "cpu")
tokens, labels = imdb_reviews(n=16, seq_len=32, vocab=cfg.vocab_size,
                              signal_frac=0.15)
opt = optimizer.AdamW(schedule=optimizer.constant(1e-3))
step = train_step.make_train_step(
    model, RunConfig(grad_compression=spec["method"]), opt, mesh=mesh)
new, state, m = step(params, opt.init(params),
                     {"tokens": tokens, "labels": labels})
np.savez(spec["out"] + f"/rank{rank}.npz",
         loss=m["loss"].numpy(), accuracy=m["accuracy"].numpy(),
         **{f"leaf_{i}": t.float().numpy()
            for i, t in enumerate(tree_leaves(state["master"]))})
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
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


def _int8_formula(xs):
    """The reference's int8 compressed sum, in numpy (fp32)."""
    amax = np.float32(max(np.abs(x).max() for x in xs))
    scale = np.maximum(amax, np.float32(1e-30)) / np.float32(127.0)
    qs = [np.clip(np.round(x / scale), -127, 127).astype(np.int8)
          for x in xs]
    return sum(q.astype(np.int32) for q in qs).astype(np.float32) * scale


@pytest.mark.parametrize("world", [2, 4])
def test_compress_psum_on_ranks_matches_the_formula(tmp_path, world):
    outs = _run_ranks(tmp_path, COMPRESS, world, dict(out=str(tmp_path)))
    xs = [np.random.default_rng(r).standard_normal((64, 32)).astype(
        np.float32) * (r + 1) for r in range(world)]
    bf = [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
    for out in outs:
        for m in ("none", "bf16", "int8"):  # every rank the same
            np.testing.assert_array_equal(out[m], outs[0][m])
            assert out[m].dtype == np.float32
        assert bool(out["raised"])
        # none: an fp32 sum (the order of a 4-way sum may differ)
        np.testing.assert_allclose(out["none"], sum(xs), rtol=1e-6,
                                   atol=1e-6)
        # bf16: each payload rounded to bf16, summed in bf16 (world - 1
        # roundings of the running sum)
        np.testing.assert_allclose(
            out["bf16"], sum(bf), rtol=0,
            atol=(world - 1) * 2.0 ** -8 * np.abs(sum(np.abs(b) for b in bf)
                                                  ).max())
        # int8: exactly the formula
        np.testing.assert_array_equal(out["int8"], _int8_formula(xs))


def test_compress_psum_on_one_rank_and_unknown_method():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (256, 64)).astype(np.float32))
    assert torch.equal(compress_psum(x, "pod", "none"), x)
    np.testing.assert_array_equal(compress_psum(x, "pod", "int8").numpy(),
                                  _int8_formula([x.numpy()]))
    assert torch.equal(compress_psum(x, "pod", "bf16"),
                       x.bfloat16().float())
    # the reference's one-device error bounds hold
    amax = float(x.abs().max())
    assert float((compress_psum(x, "pod", "int8") - x).abs().max()) <= \
        amax / 127.0 / 2 + 1e-7
    with pytest.raises(ValueError, match="unknown grad compression"):
        compress_psum(x, "pod", "fp4")


@pytest.mark.parametrize("world", [2, 4])
def test_pod_step_on_ranks_matches_one_process(tmp_path, world):
    outs = _run_ranks(tmp_path, POD, world,
                      dict(out=str(tmp_path), method="int8"))
    cfg = configs.smoke("distilbert-imdb")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens, labels = imdb_reviews(n=16, seq_len=32, vocab=cfg.vocab_size,
                                  signal_frac=0.15)
    opt = optimizer.AdamW(schedule=optimizer.constant(1e-3))
    loss_fn = train_step.make_loss_fn(model, RunConfig())
    b = 16 // world
    locals_ = [train_step.value_and_grad(
        loss_fn, params, _torch_batch({"tokens": tokens[r * b:(r + 1) * b],
                                       "labels": labels[r * b:(r + 1) * b]}))
        for r in range(world)]
    # the pod step emulated in one process: each rank's fp32 grads, the
    # int8 formula over ranks, divided by the pod count
    per_rank = [tree_leaves(tree_map(lambda g: g.float(), g_))
                for _, g_ in locals_]
    grads = [torch.from_numpy(_int8_formula([pr[i].numpy()
                                             for pr in per_rank]) / world)
             for i in range(len(per_rank[0]))]
    _, state, _ = opt.update(tree_unflatten(params, grads),
                             opt.init(params), params)
    want = tree_leaves(state["master"])
    loss = sum(float(m["loss"]) for (_, m), _ in locals_) / world
    for out in outs:
        for i, w in enumerate(want):  # every rank: bit for bit
            np.testing.assert_array_equal(out[f"leaf_{i}"], w.numpy())
        np.testing.assert_allclose(float(out["loss"]), loss, rtol=1e-6)
    # against the one-process step on the whole batch: int8 quantization
    # of the grads moves few master weights by more than lr/2
    _, whole, m = _one_step(model, RunConfig(), params,
                            {"tokens": tokens, "labels": labels})
    np.testing.assert_allclose(float(outs[0]["loss"]), float(m["loss"]),
                               rtol=1e-3)
    got = [torch.from_numpy(outs[0][f"leaf_{i}"]) for i in range(len(want))]
    assert _share_off(got, tree_leaves(whole["master"]), LR / 2) <= 0.2


# ---------------------------------------------------------------------------
# The case study
# ---------------------------------------------------------------------------


def test_case_study_trained_classifier_beats_chance():
    out = sentiment_case_study.main(["--device", "cpu"])
    assert out["losses"][-1] < out["losses"][0] * 0.9
    assert out["accuracy"] > 0.6
    assert (out["predictions"] >= 0).all()
