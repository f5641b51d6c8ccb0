"""Port's generative path against the JAX reference, on qwen2-7b smoke.

Prefill, ragged ``decode_step`` (JAX "xla" and "pallas" in interpret
mode), a row decoded past the cache's end, ``Engine.generate`` and
``ContinuousBatcher`` (batched and per-slot, through admit/evict churn),
with the reference's params bridged into the port
(``models.convert.from_reference``) and a reference cache bridged by
``cache_from_reference``.

Tolerances: logits within 4% of the largest reference logit and caches
within 2% of the largest reference entry (activations are bf16; JAX
evaluates SiLU op by op in bf16 where torch rounds once, so values differ
by a few bf16 ulps; see test_torch_models.py). Greedy tokens are compared
token for token; the smoke model's logits are bf16 values, which tie
exactly at vocab 256 now and then, so a stream may part from the
reference's at a near-tie and nowhere else: at the first differing token
both choices lie within NEAR_TIE of the reference's best logit there
(``_assert_streams_match``). Counters and shape buckets must be equal.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.models import transformer as jtransformer
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs
from repro_torch.models import RunConfig, attention, build, transformer
from repro_torch.models.convert import cache_from_reference, from_reference
from repro_torch.serving import ContinuousBatcher, Engine, Request

LOGIT_REL_TOL = 0.04
CACHE_REL_TOL = 0.02
NEAR_TIE = 0.05
ARCH = "qwen2-7b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def qwen():
    jcfg, cfg = jconfigs.smoke(ARCH), configs.smoke(ARCH)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), jparams)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=from_reference(params_np, cfg, device="cpu"))


_jax_forward = jax.jit(jtransformer.forward, static_argnums=(0, 1))


def _np(x):
    return np.asarray(x, np.float32)


def _assert_logits_close(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want,
                               atol=LOGIT_REL_TOL * np.abs(want).max())


def _assert_cache_matches(cache, jcache, cfg):
    """The port's per-layer cache against the reference's stacked one."""
    np.testing.assert_array_equal(cache.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    for layer, c in enumerate(cache.layers):
        ref = jcache.layers[layer % cfg.period]
        for name in ("k", "v"):
            want = _np(ref[name][layer // cfg.period])
            np.testing.assert_allclose(
                _np(c[name].float()), want,
                atol=CACHE_REL_TOL * max(np.abs(want).max(), 1e-6))


def _assert_streams_match(qwen, prompts, want, got) -> int:
    """Equal token for token, or parted at a near-tie (see the module
    docstring). Returns how many streams parted; at most a third may."""
    parted = 0
    for prompt, a, b in zip(prompts, want, got):
        a, b = [int(t) for t in a], [int(t) for t in b]
        assert len(a) == len(b)
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        seq = np.concatenate([np.asarray(prompt), a[:i]])[None]
        logits = _np(_jax_forward(qwen["jcfg"], JRunConfig(),
                                  qwen["jparams"],
                                  tokens=jnp.asarray(seq, jnp.int32))[0])
        best = logits[0, -1].max()
        gaps = (best - logits[0, -1, a[i]], best - logits[0, -1, b[i]])
        assert max(gaps) <= NEAR_TIE, (
            f"stream parts at token {i} ({a[i]} vs {b[i]}) with reference "
            f"logit gaps {gaps}: not a near-tie")
        parted += 1
    assert parted <= len(want) // 3, f"{parted} of {len(want)} parted"
    return parted


def _engines(qwen, impl="xla"):
    return (JEngine(jbuild(qwen["jcfg"]), JRunConfig(attn_impl=impl)),
            Engine(build(qwen["cfg"]), RunConfig(attn_impl=impl),
                   device="cpu"))


def _ragged_reference_cache(qwen, jeng, rows, n_slots=4, max_len=64):
    """A reference cache with prompts prefilled into ``rows`` (slot ->
    prompt length) and the other slots free."""
    cache = jeng.new_cache(n_slots, max_len)
    rng = np.random.default_rng(7)
    for slot, n in rows.items():
        prompt = rng.integers(0, qwen["cfg"].vocab_size, (1, n))
        _, cache = jeng.prefill_into(qwen["jparams"], cache, slot,
                                     prompt.astype(np.int32))
    return cache


def _to_numpy_cache(jcache):
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if x.dtype == jnp.bfloat16 else np.asarray(x),
                        jcache)


# ---------------------------------------------------------------------------
# Model level: prefill and ragged decode
# ---------------------------------------------------------------------------


def test_prefill_logits_and_cache_match_jax(qwen):
    tokens = np.random.default_rng(0).integers(
        0, qwen["cfg"].vocab_size, (2, 12)).astype(np.int32)
    want_logits, want_cache = jax.jit(
        jtransformer.prefill, static_argnums=(0, 1),
        static_argnames="max_len")(qwen["jcfg"], JRunConfig(),
                                   qwen["jparams"],
                                   tokens=jnp.asarray(tokens), max_len=20)
    logits, cache = build(qwen["cfg"]).prefill(
        RunConfig(), qwen["params"], {"tokens": torch.tensor(tokens)},
        max_len=20)
    assert logits.shape == (2, qwen["cfg"].vocab_size)
    assert logits.dtype == torch.float32
    assert cache.layers[0]["k"].shape == (2, 20, 2, 16)
    _assert_logits_close(logits, want_logits)
    _assert_cache_matches(cache, want_cache, qwen["cfg"])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_step_over_ragged_cache_matches_jax(qwen, impl):
    """Rows at 5, 0 (free), 63 (= T - 1) and 20 tokens; JAX "pallas" runs
    the Pallas kernel in interpret mode (T = 64 is past its oracle
    fallback), the port's runs the kernel's plain version on the CPU."""
    jeng, _ = _engines(qwen)
    jcache = _ragged_reference_cache(qwen, jeng, {0: 5, 2: 63, 3: 20})
    cache = cache_from_reference(_to_numpy_cache(jcache), qwen["cfg"],
                                 device="cpu")
    _assert_cache_matches(cache, jcache, qwen["cfg"])
    token = np.array([[3], [7], [11], [200]], np.int32)
    want_logits, want_cache = jax.jit(
        jtransformer.decode_step, static_argnums=(0, 1))(
        qwen["jcfg"], JRunConfig(attn_impl=impl), qwen["jparams"], jcache,
        token=jnp.asarray(token))
    logits, out = transformer.decode_step(
        qwen["cfg"], RunConfig(attn_impl=impl), qwen["params"], cache,
        token=torch.tensor(token))
    assert out is cache  # updated in place
    np.testing.assert_array_equal(cache.lengths.numpy(), [6, 1, 64, 21])
    _assert_logits_close(logits, want_logits)
    _assert_cache_matches(cache, want_cache, qwen["cfg"])


def test_row_decoded_past_max_len_matches_jax(qwen):
    """Free rows advance every round (the reference does so too), so a high
    slot can run past the cache's end. The reference's clamped write
    lands on the last position and the row then sees every position; the
    port clamps its write the same way instead of indexing out of range.
    Both sides are fed the same tokens (the reference's greedy ones)."""
    jeng, eng = _engines(qwen)
    jcache, cache = jeng.new_cache(2, 8), eng.new_cache(2, 8)
    prompt = np.arange(5, dtype=np.int32)[None] + 40
    jl, jcache = jeng.prefill_into(qwen["jparams"], jcache, 0, prompt)
    logits, cache = eng.prefill_into(qwen["params"], cache, 0, prompt)
    _assert_logits_close(logits, jl)
    tok = np.array([[int(np.argmax(jl[0]))], [0]], np.int32)
    for _ in range(12):
        jl, jcache = jeng.decode(qwen["jparams"], jcache, tok)
        logits, cache = eng.decode(qwen["params"], cache, tok)
        assert np.isfinite(logits.numpy()).all()
        _assert_logits_close(logits, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
    np.testing.assert_array_equal(cache.lengths.numpy(), [17, 12])
    _assert_cache_matches(cache, jcache, qwen["cfg"])


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_generate_greedy_matches_jax(qwen, impl):
    jeng, eng = _engines(qwen, impl)
    prompts = np.random.default_rng(1).integers(
        0, qwen["cfg"].vocab_size, (3, 10)).astype(np.int32)
    want = jeng.generate(qwen["jparams"], prompts, max_new_tokens=8)
    got = eng.generate(qwen["params"], prompts, max_new_tokens=8)
    assert got.shape == want.shape == (3, 18) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :10], prompts)
    _assert_streams_match(qwen, prompts, want[:, 10:], got[:, 10:])
    assert eng.compile_count == jeng.compile_count == 2  # prefill, decode


def test_generate_fused_and_host_sampling_agree(qwen):
    _, eng = _engines(qwen, "pallas")
    prompts = np.random.default_rng(2).integers(
        0, qwen["cfg"].vocab_size, (2, 6)).astype(np.int32)
    kw = dict(max_new_tokens=6, temperature=0.9, top_k=20, top_p=0.9,
              seed=5)
    host = eng.generate(qwen["params"], prompts, **kw)
    fused = eng.generate(qwen["params"], prompts, fused_sampling=True, **kw)
    np.testing.assert_array_equal(fused, host)
    other = eng.generate(qwen["params"], prompts, **dict(kw, seed=6))
    assert not np.array_equal(other, host)  # the seed drives the draw


def test_shared_cache_is_written_in_place(qwen):
    _, eng = _engines(qwen)
    cache = eng.new_cache(3, 16)
    ptrs = [t.data_ptr() for t in cache.tensors()]
    tokens = np.arange(6, dtype=np.int32)[None]
    _, out = eng.prefill_into(qwen["params"], cache, 1, tokens)
    assert out is cache
    _, out = eng.decode(qwen["params"], cache, np.zeros((3, 1), np.int32))
    out = eng.free_row(out, 1)
    assert out is cache and [t.data_ptr() for t in cache.tensors()] == ptrs
    np.testing.assert_array_equal(cache.lengths.numpy(), [1, 0, 1])


def test_prefill_into_checks_capacity(qwen):
    _, eng = _engines(qwen)
    cache = eng.new_cache(2, 8)
    with pytest.raises(ValueError, match="capacity"):
        eng.prefill_into(qwen["params"], cache, 0,
                         np.zeros((1, 9), np.int32))
    with pytest.raises(ValueError, match="capacity"):
        eng.prefill_into(qwen["params"], cache, 0,
                         np.zeros((1, 4), np.int32), max_len=9)
    with pytest.raises(ValueError, match="token ids"):
        eng.prefill_into(qwen["params"], cache, 0,
                         np.full((1, 4), 256, np.int32))


def test_cache_from_reference_rejects_other_layouts(qwen):
    jeng, _ = _engines(qwen)
    ref = _to_numpy_cache(jeng.new_cache(2, 8))
    bad = dataclasses.replace(ref, layers=tuple(
        {"k": x["k"][:, None], "v": x["v"]} for x in ref.layers))
    with pytest.raises(ValueError, match="shape"):
        cache_from_reference(bad, qwen["cfg"], device="cpu")
    quant = dataclasses.replace(ref, layers=tuple(
        dict(x, k_scale=x["k"]) for x in ref.layers))
    with pytest.raises(KeyError, match="k and v"):
        cache_from_reference(quant, qwen["cfg"], device="cpu")


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


def _requests(cls, vocab, n=10, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid, rng.integers(0, vocab, int(rng.integers(3, 9))
                                  ).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 7)))
            for rid in range(n)]


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "per_slot"])
def test_batcher_greedy_streams_and_counters_match_jax(qwen, batched):
    """10 requests over 3 slots: admit/evict churn. Streams, completion
    order, counters and the flat shape-bucket count match the
    reference's."""
    jeng, eng = _engines(qwen, "pallas")
    jb = JBatcher(jeng, qwen["jparams"], n_slots=3, batched=batched)
    pb = ContinuousBatcher(eng, qwen["params"], n_slots=3, batched=batched)
    jb.submit_many(_requests(JRequest, qwen["cfg"].vocab_size))
    reqs = _requests(Request, qwen["cfg"].vocab_size)
    pb.submit_many(reqs)
    want, got = jb.run(), pb.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    _assert_streams_match(qwen, [r.prompt for r in got],
                          [r.generated for r in want],
                          [r.generated for r in got])
    for name in ("decode_dispatches", "decode_steps", "sampler_dispatches",
                 "rounds"):
        assert getattr(pb, name) == getattr(jb, name), name
    assert eng.compile_count == jeng.compile_count
    n_shapes = len({len(r.prompt) for r in reqs})
    if batched:
        assert pb.decode_dispatches == pb.rounds  # one decode call a round
        assert eng.compile_count == n_shapes + 2  # + decode, free_row
    else:
        assert pb.decode_dispatches == pb.decode_steps
    assert set(pb.take_bucket_s()) == {"prefill", "decode_attention",
                                       "sampler", "host_scheduler"}


def test_batcher_fused_and_host_sampling_identical(qwen):
    _, eng = _engines(qwen, "pallas")
    kw = dict(temperature=0.8, top_k=5, top_p=0.9, seed=3)
    runs = []
    for fused in (False, True):
        b = ContinuousBatcher(eng, qwen["params"], n_slots=3,
                              fused_sampling=fused, **kw)
        b.submit_many(_requests(Request, qwen["cfg"].vocab_size, seed=1))
        runs.append((b, [r.generated for r in b.run()]))
    (host, host_streams), (fused, fused_streams) = runs
    assert fused_streams == host_streams
    assert fused.sampler_dispatches == 0 < host.sampler_dispatches
    assert fused.decode_dispatches == host.decode_dispatches == host.rounds


def test_batcher_rejects_request_that_can_never_fit(qwen):
    _, eng = _engines(qwen)
    b = ContinuousBatcher(eng, qwen["params"], n_slots=2, max_len=16)
    reqs = _requests(Request, qwen["cfg"].vocab_size, n=4)
    reqs[1].max_new_tokens = 16 - len(reqs[1].prompt) + 1
    b.submit_many(reqs)
    done = b.run()
    assert sorted(r.rid for r in done) == [0, 2, 3]
    assert [r.rid for r in b.take_rejected()] == [1]
    assert b.take_rejected() == []


def test_batcher_on_token_contract_and_cancel(qwen):
    _, eng = _engines(qwen)
    seen = []

    def on_token(req, tok, prefill):
        seen.append((req.rid, prefill, req.done))
        if req.rid == 2:
            raise RuntimeError("subscriber fault")

    b = ContinuousBatcher(eng, qwen["params"], n_slots=2, on_token=on_token)
    reqs = _requests(Request, qwen["cfg"].vocab_size, n=5)
    b.submit_many(reqs)
    b.step()
    assert b.scheduler.slots[1] is reqs[1]
    assert b.cancel(reqs[1]) and b.cancel(reqs[4])  # in a slot, queued
    assert not b.cancel(reqs[4])
    assert b.scheduler.slots[1] is None and int(b.cache.lengths[1]) == 0
    done = b.run()
    assert sorted(r.rid for r in done) == [0, 2, 3]
    for r in done:  # one prefill commit, then decode commits, last done
        mine = [(p, d) for rid, p, d in seen if rid == r.rid]
        assert [p for p, _ in mine] == [True] + [False] * (len(mine) - 1)
        assert len(mine) == r.max_new_tokens and mine[-1][1]
    assert b.on_token_errors == reqs[2].max_new_tokens


def test_unported_variants_raise(qwen):
    _, eng = _engines(qwen)
    with pytest.raises(ValueError, match="batched=True"):
        ContinuousBatcher(eng, qwen["params"], fused_sampling=True,
                          batched=False)
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        ContinuousBatcher(eng, qwen["params"], paged=True)
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        Engine(build(qwen["cfg"]), RunConfig(kv_dtype="int8"), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        build(qwen["cfg"]).cache_specs(2, 8, kv_dtype="int8")
    q = torch.zeros(1, 1, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        attention.attend_decode(q, kv, kv, 0, impl="seq_shard")
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        attention.attend_decode(q, kv, kv, 0, k_scale=kv, v_scale=kv)


def test_cache_specs_allocate_nothing(qwen):
    specs = build(configs.get(ARCH)).cache_specs(8, 1024)
    assert len(specs.layers) == 28
    assert all(t.device.type == "meta" for t in specs.tensors())
    assert specs.layers[0]["k"].shape == (8, 1024, 4, 128)
    assert specs.layers[0]["k"].dtype == torch.bfloat16


def test_serve_cluster_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_cluster",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="1"),
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "24 requests over 4 slots" in out.stdout
    assert "0 host-sampler steps" in out.stdout
    assert "chunks committed: 8/8" in out.stdout
