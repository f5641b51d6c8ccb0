"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the JAX one.

The contracts of tests/test_models_parity.py re-run on the port (chunked
SSD against the token-by-token oracle ``ssm_forward_naive``, the prefill
state against the decode path), then ``ssm_forward`` (with and without
its state), ``ssm_decode`` and the conv helpers held to
``repro.models.ssm`` on the same numpy params and inputs, in fp32 where
the point is the algorithm (F32_TOL 1e-5 absolute), and the prompt-length
rule of an SSM prefill, in the model and behind the engine.

Tolerances against the oracle are the parity test's own: the chunked form
takes exp(cum_i - cum_j) where the recurrence multiplies exp() factors, so
the two differ by fp32 accumulation order (atol 1e-2, rtol 3e-3; the
state 2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.common import LayerSpec as JLayerSpec
from repro.models.common import ModelConfig as JModelConfig
from repro.models.common import SSMConfig as JSSMConfig
from repro.models.common import init_params
from repro_torch import configs
from repro_torch.models import RunConfig, build, common, ssm
from repro_torch.models.common import LayerSpec, ModelConfig, SSMConfig
from repro_torch.serving import Engine

F32_TOL = 1e-5


def _cfgs(chunk=8, n_groups=1):
    base = dict(name="t", family="ssm", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64)
    kw = dict(d_state=16, d_conv=4, expand=2, head_dim=8, chunk=chunk,
              n_groups=n_groups)
    return (JModelConfig(**base, ssm=JSSMConfig(**kw),
                         pattern=(JLayerSpec("ssm", "none"),)),
            ModelConfig(**base, ssm=SSMConfig(**kw),
                        pattern=(LayerSpec("ssm", "none"),)))


def _params(jcfg, f32=True):
    p = init_params(jax.random.PRNGKey(0), JS.ssm_specs(jcfg, jcfg.ssm))
    if f32:
        p = jax.tree.map(lambda x: x.astype(jnp.float32), p)
    return p, jax.tree.map(
        lambda x: torch.tensor(np.asarray(x, np.float32)).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32), p)


def _u(shape, seed=1):
    u = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.5
    return jnp.asarray(u), torch.tensor(u)


def _parity_u(shape):
    """tests/test_models_parity.py's own input: N(0, 0.25) from
    PRNGKey(1)."""
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), shape, jnp.float32) * 0.5))


@pytest.mark.parametrize("seq,chunk", [(16, 8), (24, 8), (32, 16)])
def test_ssd_chunked_matches_naive(seq, chunk):
    """The naive oracle keeps the conv windows in bf16, as the decode
    cache does; the chunked form convolves the fp32 inputs."""
    _, cfg = _cfgs(chunk)
    _, tp = _params(_cfgs(chunk)[0])
    u = _parity_u((2, seq, cfg.d_model))
    fast = ssm.ssm_forward(cfg, cfg.ssm, tp, u)
    slow = ssm.ssm_forward_naive(cfg, cfg.ssm, tp, u)
    np.testing.assert_allclose(fast.numpy(), slow.numpy(), atol=1e-2,
                               rtol=3e-3)


def test_prefill_state_matches_decode_path():
    jcfg, cfg = _cfgs()
    _, tp = _params(jcfg, f32=False)
    u = _parity_u((1, 16, cfg.d_model))
    _, cache = ssm.ssm_forward(cfg, cfg.ssm, tp, u, return_state=True)
    dc = ssm.ssm_cache(cfg, cfg.ssm, 1, device="cpu")
    for i in range(16):
        _, dc = ssm.ssm_decode(cfg, cfg.ssm, tp, u[:, i:i + 1], dc)
    np.testing.assert_allclose(cache["state"].numpy(), dc["state"].numpy(),
                               atol=2e-2, rtol=2e-2)
    for name in ("conv_x", "conv_B", "conv_C"):  # the last K - 1 inputs
        torch.testing.assert_close(cache[name], dc[name])


@pytest.mark.parametrize("seq,chunk,groups", [(16, 8, 1), (20, 8, 1),
                                              (32, 16, 2), (5, 8, 1)])
def test_ssm_forward_matches_jax(seq, chunk, groups):
    """Outputs (a ragged last chunk zero-padded as the reference pads it)
    and, where the prompt fills whole chunks, the returned state."""
    jcfg, cfg = _cfgs(chunk, groups)
    jp, tp = _params(jcfg)
    ju, tu = _u((2, seq, cfg.d_model))
    want = JS.ssm_forward(jcfg, jcfg.ssm, jp, ju)
    got = ssm.ssm_forward(cfg, cfg.ssm, tp, tu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    if seq % min(chunk, seq):
        return
    want, wcache = JS.ssm_forward(jcfg, jcfg.ssm, jp, ju, return_state=True)
    got, cache = ssm.ssm_forward(cfg, cfg.ssm, tp, tu, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    for name, leaf in wcache.items():
        assert cache[name].dtype == (torch.float32 if name == "state"
                                     else torch.bfloat16)
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(leaf, np.float32),
                                   atol=F32_TOL, err_msg=name)


def test_ssm_decode_and_naive_match_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    ju, tu = _u((3, 6, cfg.d_model))
    want = JS.ssm_forward_naive(jcfg, jcfg.ssm, jp, ju)
    got = ssm.ssm_forward_naive(cfg, cfg.ssm, tp, tu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          JS.ssm_cache_specs(jcfg, jcfg.ssm, 3))
    cache = ssm.ssm_cache(cfg, cfg.ssm, 3, device="cpu")
    for i in range(3):
        want, jcache = JS.ssm_decode(jcfg, jcfg.ssm, jp, ju[:, i:i + 1],
                                     jcache)
        got, cache = ssm.ssm_decode(cfg, cfg.ssm, tp, tu[:, i:i + 1], cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL)
    for name, leaf in jcache.items():
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(leaf, np.float32),
                                   atol=F32_TOL, err_msg=name)


def test_cache_specs_match_jax_and_allocate_nothing():
    jcfg, cfg = _cfgs(n_groups=2)
    want = JS.ssm_cache_specs(jcfg, jcfg.ssm, 5)
    got = ssm.ssm_cache_specs(cfg, cfg.ssm, 5)
    assert set(got) == set(want)
    for name, s in want.items():
        assert tuple(got[name].shape) == s.shape
        assert got[name].device.type == "meta"
        assert str(got[name].dtype).removeprefix("torch.") == \
            jnp.dtype(s.dtype).name


def test_conv_helpers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    np.testing.assert_allclose(
        ssm._conv_full(*map(torch.tensor, (x, w, b))).numpy(),
        np.asarray(JS._conv_full(*map(jnp.asarray, (x, w, b)))),
        atol=F32_TOL)
    win = x[:, :4]
    np.testing.assert_allclose(
        ssm._conv_step(*map(torch.tensor, (win, w, b))).numpy(),
        np.asarray(JS._conv_step(*map(jnp.asarray, (win, w, b)))),
        atol=F32_TOL)
    g = rng.standard_normal((2, 3, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        ssm._expand_groups(torch.tensor(g), 6).numpy(),
        np.asarray(JS._expand_groups(jnp.asarray(g), 6)))


def test_prompt_length_rule_matches_the_reference():
    """A difference by design kept from the reference (ROADMAP Queue 3): a
    prefill that keeps an SSM state takes a prompt of at most one chunk or
    a whole number of chunks; any other length raises the reference's
    ValueError, in the model and behind the engine (mamba2 smoke: chunk
    8). The full-sequence forward pads instead."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    ju, tu = _u((1, 12, cfg.d_model))
    with pytest.raises(ValueError, match="divisible by ssd chunk"):
        JS.ssm_forward(jcfg, jcfg.ssm, jp, ju, return_state=True)
    with pytest.raises(ValueError, match="divisible by ssd chunk"):
        ssm.ssm_forward(cfg, cfg.ssm, tp, tu, return_state=True)
    mcfg = configs.smoke("mamba2-130m")
    model = build(mcfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(model, RunConfig(), device="cpu")
    cache = eng.new_cache(2, 32)
    for n in (3, 8, 16, 24):  # one chunk at most, or whole chunks
        eng.prefill_into(params, cache, 0, np.zeros((1, n), np.int32))
    with pytest.raises(ValueError, match="divisible by ssd chunk"):
        eng.prefill_into(params, cache, 0, np.zeros((1, 12), np.int32))


def test_engine_serves_an_attention_free_cache():
    """mamba2's cache has no attention layer: an admission sizes nothing by
    positions (the capacity falls back to the prompt + cache_pad, as the
    reference's does), writes the row's state leaves whole, and a freed
    row's stale state is overwritten by the next admission."""
    mcfg = configs.smoke("mamba2-130m")
    model = build(mcfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(model, RunConfig(), device="cpu")
    cache = eng.new_cache(3, 16)
    assert cache.kv_capacity() is None
    assert set(cache.layers[0]) == {"conv_x", "conv_B", "conv_C", "state"}
    prompt = np.arange(8, dtype=np.int32)[None] + 5
    logits, _ = eng.prefill_into(params, cache, 1, prompt)
    solo_logits, solo = model.prefill(RunConfig(), params,
                                      {"tokens": torch.tensor(prompt)})
    torch.testing.assert_close(logits, solo_logits)
    for big, small in zip(cache.layers, solo.layers):
        for name, t in small.items():
            torch.testing.assert_close(big[name][1], t[0])
    eng.decode(params, cache, np.zeros((3, 1), np.int32))
    eng.free_row(cache, 1)
    eng.prefill_into(params, cache, 1, prompt)
    for big, small in zip(cache.layers, solo.layers):
        torch.testing.assert_close(big["state"][1], small["state"][0])


def test_triangle_cumsum_equals_cumsum():
    """The SSD scan's running sums as one product with a triangle of ones
    (what ``common.cumsum`` runs on a CUDA tensor under deterministic
    algorithms, where ``torch.cumsum`` raises) equal ``torch.cumsum``
    within fp32 rounding, on the scan's (B, Nc, Q, H) layout along Q, with
    the same grads."""
    x = (-torch.rand(2, 3, 64, 4, generator=torch.Generator().manual_seed(0))
         ).requires_grad_(True)
    got = common.triangle_cumsum(x, 2)
    want = torch.cumsum(x, 2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    g = torch.randn_like(want)
    (gx,) = torch.autograd.grad(got, x, g)
    (wx,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(gx, wx, rtol=1e-6, atol=1e-5)
    assert torch.equal(common.cumsum(x, 2), want)  # the CPU keeps cumsum
