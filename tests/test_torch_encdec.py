"""The port's encoder-decoder (``repro_torch.models.encdec``) and the
cross-attention half of ``models.attention`` against the JAX package, on
whisper-base's smoke config and the reference's own params.

Cross-attention and ``cross_kv`` are compared in fp32 where the point is
the algorithm, within F32_TOL (1e-5) of the largest reference entry (sums
taken in another order); ``encode`` and the teacher-forced decoder in
bf16, within LOGIT_REL_TOL (4%) of the largest reference entry (JAX
evaluates GELU op by op in bf16 where torch rounds once). The port runs
"xla" and "pallas" (the flash kernel's plain version on CPU tensors: the
decode step's cross-attention is the flash kernel at S = 1 on the card).
The whole model's forward, prefill and decode step are held to JAX in
tests/test_torch_families.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import RunConfig as JRunConfig
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import encdec as jencdec
from repro_torch import configs
from repro_torch.models import RunConfig, attention, build, encdec
from repro_torch.models.convert import cache_from_reference, from_reference
from repro_torch.serving import Engine

F32_TOL = 1e-5
LOGIT_REL_TOL = 0.04
ARCH = "whisper-base"


@pytest.fixture(scope="module")
def whisper():
    jcfg, cfg = jconfigs.smoke(ARCH), configs.smoke(ARCH)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), jparams)
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, 12, cfg.enc_d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params_np=params_np,
                params=from_reference(params_np, cfg, device="cpu"),
                enc=enc, tokens=tokens)


def _np(x):
    return np.asarray(x, np.float32)


def _f32_close(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want,
                               atol=F32_TOL * np.abs(want).max())


def _close(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want,
                               atol=LOGIT_REL_TOL * np.abs(want).max())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_cross_attention_and_cross_kv_match_jax_in_fp32(whisper, impl):
    """One decoder layer's cross K/V and cross-attention at S = 7 and at
    S = 1 (a decode step) over T = 12 encoder positions."""
    jcfg, cfg = whisper["jcfg"], whisper["cfg"]
    p_np = jax.tree.map(lambda x: x[0], whisper["params_np"]["dec_blocks"]
                        )["cross_attn"]
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = jax.tree.map(torch.tensor, p_np)
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jk, jv = jattn.cross_kv(jcfg, jp, jnp.asarray(enc))
    k, v = attention.cross_kv(cfg, tp, torch.tensor(enc))
    _f32_close(k, jk)
    _f32_close(v, jv)
    for s in (7, 1):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
        want = jattn.cross_attn_forward(jcfg, jp, jnp.asarray(x), jk, jv)
        got = attention.cross_attn_forward(cfg, tp, torch.tensor(x), k, v,
                                           impl=impl)
        _f32_close(got, want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_encode_and_teacher_forced_decoder_match_jax(whisper, impl):
    jcfg, cfg = whisper["jcfg"], whisper["cfg"]
    jenc = jax.jit(jencdec.encode, static_argnums=(0, 1))(
        jcfg, JRunConfig(), whisper["jparams"],
        jnp.asarray(whisper["enc"], jnp.bfloat16))
    run = RunConfig(attn_impl=impl)
    enc = encdec.encode(cfg, run, whisper["params"],
                        torch.tensor(whisper["enc"]).bfloat16())
    assert enc.dtype == torch.bfloat16 and enc.shape == jenc.shape
    _close(enc.float(), jenc)
    want = jax.jit(jencdec.dec_forward, static_argnums=(0, 1))(
        jcfg, JRunConfig(), whisper["jparams"],
        jnp.asarray(whisper["tokens"]), jenc)
    got = encdec.dec_forward(cfg, run, whisper["params"],
                             torch.tensor(whisper["tokens"]),
                             torch.tensor(_np(jenc)).bfloat16())
    assert got.dtype == torch.float32
    _close(got, want)


def test_decode_steps_from_a_bridged_cache_match_jax(whisper):
    """Three ragged decode steps from the reference's own prefill cache
    (``cache_from_reference`` unstacks its (L, ...) leaves); the cross K/V
    stay as prefill left them, the self K/V gain a row a step."""
    jcfg, cfg = whisper["jcfg"], whisper["cfg"]
    jmodel, model = jbuild(jcfg), build(cfg)
    batch = {"enc_embeds": jnp.asarray(whisper["enc"], jnp.bfloat16),
             "tokens": jnp.asarray(whisper["tokens"])}
    _, jcache = jax.jit(lambda p: jmodel.prefill(
        JRunConfig(), p, batch, max_len=12))(whisper["jparams"])
    cache = cache_from_reference(
        jax.tree.map(lambda x: np.asarray(x, np.float32)
                     if x.dtype == jnp.bfloat16 else np.asarray(x), jcache),
        cfg, device="cpu")
    assert isinstance(cache, encdec.EncDecCache)
    assert len(cache.self_k) == cfg.n_layers
    assert cache.self_k[0].shape == (2, 12, cfg.n_kv_heads, cfg.head_dim)
    assert cache.cross_k[0].shape == (2, 12, cfg.n_kv_heads, cfg.head_dim)
    cross = [t.clone() for t in cache.cross_k]
    step = jax.jit(lambda p, c, t: jmodel.decode_step(JRunConfig(), p, c,
                                                      {"token": t}))
    for tok in ([[5], [9]], [[1], [2]], [[3], [4]]):
        tok = np.asarray(tok, np.int32)
        want, jcache = step(whisper["jparams"], jcache, jnp.asarray(tok))
        got, cache = model.decode_step(RunConfig(attn_impl="pallas"),
                                       whisper["params"], cache,
                                       {"token": torch.tensor(tok)})
        _close(got, want)
    np.testing.assert_array_equal(cache.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    for layer in range(cfg.n_layers):
        _close(cache.self_k[layer].float(), jcache.self_k[layer])
        assert torch.equal(cache.cross_k[layer], cross[layer])


def test_cache_specs_and_the_reference_guards(whisper):
    cfg = whisper["cfg"]
    model = build(cfg)
    specs = model.cache_specs(3, 16, enc_len=40)
    assert all(t.device.type == "meta" for t in specs.tensors())
    assert specs.self_k[0].shape == (3, 16, cfg.n_kv_heads, cfg.head_dim)
    assert specs.cross_v[-1].shape == (3, 40, cfg.n_kv_heads, cfg.head_dim)
    assert model.init_cache(2, 8, device="cpu").cross_k[0].shape[1] == 8
    with pytest.raises(ValueError, match="int8"):
        model.cache_specs(3, 16, kv_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        Engine(model, RunConfig(kv_dtype="int8"), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        model.paged_cache_specs(2, 8, 4, 2)
    with pytest.raises(ValueError, match="PagedCache"):
        model.extend_row(RunConfig(), whisper["params"], None, 0,
                         torch.zeros(1, 2, dtype=torch.long))
