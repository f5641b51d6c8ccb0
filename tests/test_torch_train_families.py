"""Training every model family in the port, held to the reference (CPU).

* ``test_train_step_smoke``: the port of ``tests/test_arch_smoke.py::
  test_train_step_smoke`` for every arch of ``configs.ARCHS``: one AdamW
  step of ``make_train_step`` on the smoke config from the port's own
  init gives a finite loss and grad norm, ``step == 1``, and params that
  moved.
* ``test_grads_match_jax_value_and_grad``: the MoE (qwen2-moe, grok),
  SSM (mamba2), hybrid (jamba) and encoder-decoder (whisper) families'
  loss, load-balancing loss and grads against ``jax.value_and_grad`` of
  the reference's loss (``AUX_LOSS_WEIGHT`` x the lb loss in the total),
  on the reference's params, both packages in fp32
  (``test_torch_families._fp32_everywhere``): the smoke models amplify
  bf16 rounding past a useful bound. The total and CE loss within
  LOSS_RTOL (1e-5) relative, the lb loss within LB_TOL (1e-4), every
  grad leaf within GRAD_RTOL (1e-2) relative RMS (about 3e-3 at worst);
  a leaf whose true grad is zero (a key bias without RoPE: it adds a
  constant to a query's logits, which softmax ignores) against the
  tree's RMS instead.
* ``test_ssd_grads_are_finite_over_a_full_chunk``: the SSD scan's grads
  at mamba2's own chunk of 128 are finite.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.training import train_step as jts
from repro_torch import configs
from repro_torch.models import RunConfig, build
from repro_torch.models.common import is_axspec
from repro_torch.models.convert import reference_path
from repro_torch.training import optimizer, train_step
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map
from test_torch_families import _fp32_everywhere, _ref, _to_fp32

LOSS_RTOL = 1e-5
LB_TOL = 1e-4
GRAD_RTOL = 1e-2
B, S = 2, 16
FAMILIES = ["qwen2-moe-a2.7b", "grok-1-314b", "mamba2-130m",
            "jamba-1.5-large-398b", "whisper-base"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _batch(cfg, seed: int = 1) -> dict:
    """numpy inputs and labels, the same for both packages."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.encdec:
        batch = {"enc_embeds": rng.standard_normal(
            (B, S, cfg.enc_d_model)).astype(np.float32), "tokens": tokens}
    elif cfg.input_mode == "embeddings":
        batch = {"embeddings": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": tokens}
    batch["labels"] = (rng.integers(0, cfg.num_labels, (B,))
                       if cfg.num_labels else
                       rng.integers(0, cfg.vocab_size, (B, S))
                       ).astype(np.int32)
    return batch


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_train_step_smoke(arch):
    cfg = configs.smoke(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = optimizer.AdamW(schedule=optimizer.constant(1e-3))
    step = train_step.make_train_step(model, RunConfig(), opt)
    new_params, new_opt, metrics = step(params, opt.init(params),
                                        _batch(cfg))
    assert torch.isfinite(metrics["loss"]), f"{arch}: non-finite loss"
    assert torch.isfinite(metrics["grad_norm"])
    assert int(new_opt["step"]) == 1
    moved = any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(new_params)))
    assert moved, f"{arch}: train step was a no-op"


def _port_grads(jgrads, cfg) -> dict:
    """The reference's grads (stacked layers) as the port's flat
    {path: fp32 array}."""
    ref = dict(tree_leaves_with_path(jax.tree.map(
        lambda x: np.asarray(x, np.float32), jgrads)))
    out = {}
    for path, _ in tree_leaves_with_path(build(cfg).param_specs, is_axspec):
        rpath, layer = reference_path(cfg, path)
        out[path] = ref[rpath] if layer is None else ref[rpath][layer]
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_grads_match_jax_value_and_grad(arch):
    jcfg, jparams, cfg, params = _ref(arch)
    batch = _batch(cfg)
    with _fp32_everywhere():
        (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(
            jts.make_loss_fn(jbuild(jcfg), JRunConfig()), has_aux=True))(
            _to_fp32(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
        (total, metrics), grads = train_step.value_and_grad(
            train_step.make_loss_fn(build(cfg), RunConfig()),
            tree_map(lambda t: t.float(), params),
            {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
             else torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert abs(float(metrics["aux_loss"]) - float(jm["aux_loss"])) <= LB_TOL
    if cfg.moe is not None:  # the lb loss is in the total
        assert float(metrics["aux_loss"]) > 0.5
    want = _port_grads(jgrads, cfg)
    got = {p: g.numpy() for p, g in tree_leaves_with_path(grads)}
    assert got.keys() == want.keys()
    tree_rms = np.sqrt(np.mean(np.concatenate(
        [w.reshape(-1) ** 2 for w in want.values()])))
    for path, w in want.items():
        scale = np.sqrt(np.mean(w ** 2))
        if path[-1] == "bk" and cfg.pos != "rope":  # zero but for rounding
            scale = tree_rms
        err = np.sqrt(np.mean((got[path] - w) ** 2)) / max(scale, 1e-30)
        assert err <= GRAD_RTOL, (path, err)


def test_ssd_grads_are_finite_over_a_full_chunk():
    """mamba2-130m's widths at 2 layers, 256 tokens in two chunks of 128:
    above the diagonal the intra-chunk decay exponent overflows exp, and a
    mask applied after exp turns its zero grad into NaN (the reference's
    ``ssm.py`` exponentiates first; the port masks the exponent)."""
    cfg = dataclasses.replace(configs.get("mamba2-130m"), n_layers=2)
    assert cfg.ssm.chunk == 128
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    t = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 257))
    (loss, _), grads = train_step.value_and_grad(
        train_step.make_loss_fn(model, RunConfig()), params,
        {"tokens": torch.as_tensor(t[:, :-1]),
         "labels": torch.as_tensor(t[:, 1:])})
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g.float()).all())
               for g in tree_leaves(grads))
