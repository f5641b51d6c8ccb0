"""Port's int8 KV cache against the JAX reference, on qwen2-7b smoke.

Quantization must equal JAX's bit for bit on equal fp32 inputs. The int8
decode-attention plain version and the wrapper's CPU path are held
against the JAX oracle (dequantize, then ``decode_attention_ref``) and the
interpret-mode Pallas kernel ``decode_attention_quant_kernel`` (T >= 64,
so the JAX wrapper would run it too) at 2e-5 in fp32 and 2e-2 in bf16,
the reference's own kernel tolerances. Model-level parity (the int8
write, prefill and ragged decode) starts from caches both sides share:
the K/V that quantize are bf16 activations, which differ between the two
frameworks by a bf16 ulp here and there (``test_torch_models.py``), so an
int8 value may land one step away near a rounding boundary, and two where
the token's max |x| (so its scale) moved by an ulp too. Int8 values are
compared within one step for at least 99% of entries, every dequantized
value within the bf16 cache tolerance of ``test_torch_decode.py`` (2% of
the largest entry) plus one step, and scales within 2%; logits within 4%
of the largest reference logit. The engine contract under teacher forcing
follows ``tests/test_kv_int8.py``: an argmax flip between int8 and bf16 is
allowed only where the bf16 top-2 gap is at most twice the round's largest
logit difference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.decode_attention import quant as jquant
from repro.kernels.decode_attention import ref as jax_ref
from repro.kernels.decode_attention.decode_attention import \
    decode_attention_quant_kernel
from repro.models import RunConfig as JRunConfig
from repro.models import attention as jattention
from repro.models import build as jbuild
from repro.models import transformer as jtransformer
from repro.serving import Engine as JEngine
from repro_torch import configs
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import quant
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_quant_ref
from repro_torch.models import RunConfig, attention, build, transformer
from repro_torch.models.convert import cache_from_reference
from repro_torch.models.model_zoo import Model
from repro_torch.serving import Engine
from test_torch_decode import (ARCH, _assert_logits_close, _np,  # noqa: F401
                               _to_numpy_cache, qwen)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCALE_REL_TOL = CACHE_REL_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _assert_int8_close(got, got_scale, want, want_scale):
    """int8 values and their scales against the reference's (see the
    module docstring)."""
    want, want_scale = np.asarray(want), np.asarray(want_scale, np.float32)
    steps = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert (steps > 1).mean() <= 0.01, f"{(steps > 1).sum()} entries apart"
    np.testing.assert_allclose(got_scale.numpy(), want_scale,
                               rtol=SCALE_REL_TOL, atol=1e-12)
    deq = want.astype(np.float32) * want_scale
    err = np.abs(got.float().numpy() * got_scale.numpy() - deq)
    assert (err <= CACHE_REL_TOL * np.abs(deq).max() + want_scale).all()


def assert_int8_cache_matches(cache, jcache, cfg):
    """Port's per-layer int8 cache against the reference's stacked one."""
    np.testing.assert_array_equal(cache.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    for layer, c in enumerate(cache.layers):
        ref = jcache.layers[layer % cfg.period]
        g = layer // cfg.period
        assert set(c) == {"k", "v", "k_scale", "v_scale"}
        for name in ("k", "v"):
            _assert_int8_close(c[name], c[f"{name}_scale"], ref[name][g],
                               ref[f"{name}_scale"][g])


# ---------------------------------------------------------------------------
# Quantization math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_equals_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 37, 2, 16)) * 3.0).astype(np.float32)
    x[0, :4] = 0.0                       # all-zero tokens: scale eps
    x[1, 5, 0] = [0.5, -0.5] * 8         # rounding ties at x / scale
    jq, js = jquant.quantize_kv(jnp.asarray(x, getattr(jnp, dtype)))
    q, s = quant.quantize_kv(torch.tensor(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quant.dequantize_kv(q, s).numpy(),
        np.asarray(jquant.dequantize_kv(jq, js)))
    assert (s[0, :4] > 0).all() and (q[0, :4] == 0).all()
    assert quant.SCALE_EPS == jquant.SCALE_EPS
    assert quant.KV_DTYPES == jquant.KV_DTYPES


def test_quantize_round_trip_error_bound():
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 37, 2, 16)).astype(np.float32) * 3).bfloat16()
    q, s = quant.quantize_kv(x)
    err = (x.float() - quant.dequantize_kv(q, s)).abs()
    # within half a step, up to the fp32 rounding of q * scale
    assert (err <= s / 2 + 2.0 ** -23 * x.float().abs() + 1e-7).all()


def test_kv_dtype_of_discriminates_layer_layout():
    kv, sc = torch.zeros(2, 8, 2, 4, dtype=torch.int8), torch.zeros(2, 8, 2, 1)
    assert quant.kv_dtype_of({"k": kv, "v": kv, "k_scale": sc,
                              "v_scale": sc}) == "int8"
    assert quant.kv_dtype_of({"k": kv, "v": kv}) == "bf16"
    assert quant.kv_dtype_of(torch.zeros(2, 3)) == "bf16"


# ---------------------------------------------------------------------------
# int8 decode attention: plain version and CPU wrapper vs the reference
# ---------------------------------------------------------------------------

# (b, h, kv, d, t, lengths, window, cap); lengths hold 0, T - 1 and past T
CASES = [
    (4, 4, 2, 32, 128, (0, 127, 128, 300), None, None),   # GQA 2, >= T
    (3, 8, 2, 16, 64, (5, 63, 40), 24, 20.0),             # window, softcap
    (2, 7, 1, 64, 192, (191, 77), None, None),            # GQA 7
]
IDS = [str(c[:5]) for c in CASES]


def _quant_inputs(case, dtype, seed=0):
    b, h, kv, d, t, lengths = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kv_f = [rng.standard_normal((b, t, kv, d)).astype(np.float32) * 2
            for _ in range(2)]
    kv_f[0][0, :3] = 0.0  # zero tokens: scale eps
    (kq, ks), (vq, vs) = (jquant.quantize_kv(jnp.asarray(x)) for x in kv_f)
    lens = np.asarray(lengths, np.int32)
    jx = (jnp.asarray(q, getattr(jnp, dtype)), kq, vq, ks, vs,
          jnp.asarray(lens))
    tx = (torch.tensor(q).to(getattr(torch, dtype)),
          *(torch.tensor(np.asarray(a)) for a in (kq, vq, ks, vs)),
          torch.tensor(lens))
    return jx, tx


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_ref_and_wrapper_match_jax(case, dtype):
    """Plain version vs JAX's dequantize-then-oracle; the wrapper's CPU
    path vs the interpret-mode Pallas quant kernel."""
    window, cap = case[6:]
    (jq, jk, jv, jks, jvs, jl), (tq, tk, tv, tks, tvs, tl) = \
        _quant_inputs(case, dtype)
    want = jax_ref.decode_attention_ref(
        jq, jquant.dequantize_kv(jk, jks), jquant.dequantize_kv(jv, jvs), jl,
        window=window, softcap=cap)
    got = decode_attention_quant_ref(tq, tk, tv, tks, tvs, tl,
                                     window=window, softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)
    kernel = decode_attention_quant_kernel(jq, jk, jv, jks, jvs, jl,
                                           window=window, softcap=cap,
                                           block_t=64, interpret=True)
    before = da_ops.quant_launches
    got = da_ops.decode_attention(tq, tk, tv, tl, k_scale=tks, v_scale=tvs,
                                  window=window, softcap=cap)
    assert da_ops.quant_launches == before  # CPU tensors never launch
    _close(got, kernel, dtype)


def test_quant_wrapper_rejects_bad_scales():
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 8, 2, 16, dtype=torch.int8)
    s = torch.zeros(2, 8, 2, 1)
    with pytest.raises(ValueError, match="together"):
        da_ops.decode_attention(q, k, k, 0, k_scale=s)
    with pytest.raises(ValueError, match="float32 of shape"):
        da_ops.decode_attention(q, k, k, 0, k_scale=s[..., :1, :],
                                v_scale=s)
    with pytest.raises(ValueError, match="float32 of shape"):
        da_ops.decode_attention(q, k, k, 0, k_scale=s.double(),
                                v_scale=s)
    with pytest.raises(ValueError, match="int8"):
        da_ops.decode_attention(q, k.float(), k.float(), 0, k_scale=s,
                                v_scale=s)


# ---------------------------------------------------------------------------
# Model level: the int8 write, prefill and ragged decode vs JAX
# ---------------------------------------------------------------------------


def _jint8_cache(qwen, rows, n_slots=4, max_len=64):
    """A reference int8 cache with prompts prefilled into ``rows`` (slot ->
    prompt length) and the other slots free."""
    jeng = JEngine(jbuild(qwen["jcfg"]), JRunConfig(kv_dtype="int8"))
    cache = jeng.new_cache(n_slots, max_len)
    rng = np.random.default_rng(7)
    for slot, n in rows.items():
        prompt = rng.integers(0, qwen["cfg"].vocab_size, (1, n))
        _, cache = jeng.prefill_into(qwen["jparams"], cache, slot,
                                     prompt.astype(np.int32))
    return cache


def test_int8_prefill_logits_and_cache_match_jax(qwen):
    tokens = np.random.default_rng(0).integers(
        0, qwen["cfg"].vocab_size, (2, 12)).astype(np.int32)
    want_logits, want_cache = jax.jit(
        jtransformer.prefill, static_argnums=(0, 1),
        static_argnames="max_len")(qwen["jcfg"], JRunConfig(kv_dtype="int8"),
                                   qwen["jparams"],
                                   tokens=jnp.asarray(tokens), max_len=20)
    logits, cache = build(qwen["cfg"]).prefill(
        RunConfig(kv_dtype="int8"), qwen["params"],
        {"tokens": torch.tensor(tokens)}, max_len=20)
    assert cache.layers[0]["k"].dtype == torch.int8
    assert cache.layers[0]["k_scale"].shape == (2, 20, 2, 1)
    _assert_logits_close(logits, want_logits)
    assert_int8_cache_matches(cache, want_cache, qwen["cfg"])


def test_int8_decode_layer_writes_and_attends_like_jax(qwen):
    """One int8 decode sublayer on the same int8 caches and hidden state:
    the quantized write (values and scales at each row's clamped position,
    a row past the end included) and the attention output."""
    cfg, jcfg = qwen["cfg"], qwen["jcfg"]
    jcache = _jint8_cache(qwen, {0: 5, 1: 63, 3: 20})
    cache = cache_from_reference(_to_numpy_cache(jcache), cfg, device="cpu")
    lengths = np.array([5, 63, 70, 20], np.int32)  # row 2 past the end
    x = np.random.default_rng(3).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], qwen["jparams"]["blocks"][0]["attn"])
    jl = jcache.layers[0]
    jy, jk, jv, jks, jvs = jattention.attn_decode_layer(
        jcfg, jp, jnp.asarray(x, jnp.bfloat16), jl["k"][0], jl["v"][0],
        jnp.asarray(lengths), mixer="attn", k_scale=jl["k_scale"][0],
        v_scale=jl["v_scale"][0])
    c = cache.layers[0]
    out = attention.attn_decode_layer(
        cfg, qwen["params"]["blocks"][0]["attn"],
        torch.tensor(x).bfloat16(), c["k"], c["v"], torch.tensor(lengths),
        mixer="attn", k_scale=c["k_scale"], v_scale=c["v_scale"])
    assert len(out) == 5 and out[1] is c["k"] and out[3] is c["k_scale"]
    _assert_int8_close(c["k"], c["k_scale"], jk, jks)
    _assert_int8_close(c["v"], c["v_scale"], jv, jvs)
    want = _np(jy)
    np.testing.assert_allclose(_np(out[0].float()), want,
                               atol=0.04 * np.abs(want).max())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_int8_decode_step_over_ragged_cache_matches_jax(qwen, impl):
    """Rows at 5, 0 (free), 63 (= T - 1) and 20 tokens of an int8 cache;
    JAX "pallas" runs the interpret-mode quant kernel (T = 64), the port's
    the kernel's plain version on the CPU."""
    jcache = _jint8_cache(qwen, {0: 5, 2: 63, 3: 20})
    cache = cache_from_reference(_to_numpy_cache(jcache), qwen["cfg"],
                                 device="cpu")
    assert_int8_cache_matches(cache, jcache, qwen["cfg"])
    token = np.array([[3], [7], [11], [200]], np.int32)
    run = dict(attn_impl=impl, kv_dtype="int8")
    want_logits, want_cache = jax.jit(
        jtransformer.decode_step, static_argnums=(0, 1))(
        qwen["jcfg"], JRunConfig(**run), qwen["jparams"], jcache,
        token=jnp.asarray(token))
    logits, out = transformer.decode_step(
        qwen["cfg"], RunConfig(**run), qwen["params"], cache,
        token=torch.tensor(token))
    assert out is cache
    _assert_logits_close(logits, want_logits)
    assert_int8_cache_matches(cache, want_cache, qwen["cfg"])


def test_engine_int8_prefill_into_and_free_row(qwen):
    eng = Engine(build(qwen["cfg"]), RunConfig(kv_dtype="int8"),
                 device="cpu")
    cache = eng.new_cache(3, 16)
    ptrs = [t.data_ptr() for t in cache.tensors()]
    tokens = np.arange(6, dtype=np.int32)[None] + 30
    jeng = JEngine(jbuild(qwen["jcfg"]), JRunConfig(kv_dtype="int8"))
    jl, jcache = jeng.prefill_into(qwen["jparams"], jeng.new_cache(3, 16), 1,
                                   tokens)
    logits, out = eng.prefill_into(qwen["params"], cache, 1, tokens)
    assert out is cache
    _assert_logits_close(logits, jl)
    assert_int8_cache_matches(cache, jcache, qwen["cfg"])
    eng.free_row(cache, 1)
    assert [t.data_ptr() for t in cache.tensors()] == ptrs
    np.testing.assert_array_equal(cache.lengths.numpy(), [0, 0, 0])


# ---------------------------------------------------------------------------
# Engine: int8 vs bf16 greedy decode (teacher-forced)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_int8_matches_bf16_teacher_forced_ragged(qwen, impl):
    """Rows admitted at mixed lengths into both engines; decode both on the
    bf16 tokens: every argmax flip is a near-tie (bf16 top-2 gap <= 2x the
    round's largest logit difference), and the int8 logits stay close."""
    model = build(qwen["cfg"])
    prompts = [np.random.default_rng(2).integers(0, 250, n).astype(np.int32)
               for n in (3, 9, 17)]
    engines, caches = {}, {}
    for kv in ("bf16", "int8"):
        eng = Engine(model, RunConfig(attn_impl=impl, cache_pad=16,
                                      kv_dtype=kv), device="cpu")
        cache = eng.new_cache(3, 48)
        for row, p in enumerate(prompts):
            eng.prefill_into(qwen["params"], cache, row, p[None])
        engines[kv], caches[kv] = eng, cache
    assert caches["int8"].layers[0]["k"].dtype == torch.int8
    assert caches["bf16"].layers[0]["k"].dtype == torch.bfloat16
    tok = np.zeros((3, 1), np.int32)
    for step in range(10):
        l16, _ = engines["bf16"].decode(qwen["params"], caches["bf16"], tok)
        l8, _ = engines["int8"].decode(qwen["params"], caches["int8"], tok)
        delta = float((l16 - l8).abs().max())
        assert delta <= 0.05 * float(l16.abs().max()) + 0.5
        for row in range(3):
            if int(l16[row].argmax()) != int(l8[row].argmax()):
                top2 = torch.topk(l16[row], 2).values
                gap = float(top2[0] - top2[1])
                assert gap <= 2 * delta, (step, row, gap, delta)
        tok[:, 0] = l16.argmax(-1).numpy()


# ---------------------------------------------------------------------------
# Guard rails and layouts
# ---------------------------------------------------------------------------


def test_unknown_kv_dtype_raises(qwen):
    with pytest.raises(ValueError, match="kv_dtype"):
        Engine(build(qwen["cfg"]), RunConfig(kv_dtype="fp4"), device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        build(qwen["cfg"]).cache_specs(2, 8, kv_dtype="fp4")


def test_int8_encdec_raises():
    """The port's encoder-decoder models are not ported (``build``
    raises), but an int8 engine over one is refused as the reference
    refuses it."""
    cfg = configs.smoke("whisper-base")
    model = Model(cfg=cfg, param_specs={}, active_param_count=0)
    with pytest.raises(ValueError, match="encoder-decoder"):
        Engine(model, RunConfig(kv_dtype="int8"), device="cpu")


def test_int8_seq_shard_raises_the_reference_error():
    q = torch.zeros(1, 1, 2, 4)
    k = torch.zeros(1, 8, 2, 4, dtype=torch.int8)
    sc = torch.zeros(1, 8, 2, 1)
    with pytest.raises(ValueError, match="seq_shard") as err:
        attention.attend_decode(q, k, k, 0, k_scale=sc, v_scale=sc,
                                impl="seq_shard")
    with pytest.raises(ValueError) as jerr:
        jattention.attend_decode(jnp.zeros((1, 1, 2, 4)),
                                 jnp.zeros((1, 8, 2, 4), jnp.int8),
                                 jnp.zeros((1, 8, 2, 4), jnp.int8),
                                 jnp.int32(0),
                                 k_scale=jnp.zeros((1, 8, 2, 1)),
                                 v_scale=jnp.zeros((1, 8, 2, 1)),
                                 impl="seq_shard")
    assert str(err.value) == str(jerr.value)


def test_cache_specs_int8_layout(qwen):
    jspecs = jbuild(qwen["jcfg"]).cache_specs(2, 32, kv_dtype="int8")
    specs = build(qwen["cfg"]).cache_specs(2, 32, kv_dtype="int8")
    assert all(t.device.type == "meta" for t in specs.tensors())
    for layer, c in enumerate(specs.layers):
        ref = jspecs.layers[layer % qwen["cfg"].period]
        assert set(c) == set(ref) == {"k", "v", "k_scale", "v_scale"}
        for name, t in c.items():
            assert (len(ref[name].shape),) + tuple(t.shape) == (
                5,) + tuple(ref[name].shape[1:])
            assert str(t.dtype).removeprefix("torch.") == \
                jnp.dtype(ref[name].dtype).name
    for c in build(qwen["cfg"]).cache_specs(2, 32).layers:
        assert set(c) == {"k", "v"} and c["k"].dtype == torch.bfloat16


def test_cache_from_reference_takes_int8_and_rejects_half_scales(qwen):
    jcache = _to_numpy_cache(_jint8_cache(qwen, {0: 4}, n_slots=2,
                                          max_len=8))
    cache = cache_from_reference(jcache, qwen["cfg"], device="cpu")
    assert cache.layers[0]["k"].dtype == torch.int8
    assert cache.layers[0]["v_scale"].dtype == torch.float32
    bad = dataclasses.replace(jcache, layers=tuple(
        {n: x for n, x in layer.items() if n != "v_scale"}
        for layer in jcache.layers))
    with pytest.raises(KeyError, match="k_scale and v_scale"):
        cache_from_reference(bad, qwen["cfg"], device="cpu")
