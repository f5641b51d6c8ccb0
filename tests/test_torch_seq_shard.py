"""Sequence-sharded decode in the port against the JAX reference (CPU).

The partials plain version against JAX's ``decode_attention_partials_ref``
and its interpret-mode Pallas kernel; ``seq_sharded_write_decode`` without
a mesh against JAX's in both ``set_fused_partials`` modes; the mismatches
the port keeps on purpose (a write past the cache's end lands nowhere, a
row with no visible key gives 0); the engine and the batcher on a one-rank
mesh against the reference's one-device-mesh engine; the guards.

Tolerances: partials 1e-4 absolute (the reference test's own, fp32 on both
sides); attention outputs 1e-5 (fp32); caches bit-equal. Model paths are
held like ``tests/test_torch_decode.py``'s: logits within 4% of the largest
reference logit, greedy streams equal but for near-ties
(``_assert_streams_match``), counters and shape buckets equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as jcollectives
from repro.kernels.decode_attention import ops as jops
from repro.kernels.decode_attention import ref as jref
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch.dist import collectives
from repro_torch.dist.context import Mesh
from repro_torch.kernels.decode_attention import fused_sampling as fs
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partials_ref, decode_attention_ref)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import RunConfig, attention, build
from repro_torch.models.convert import cache_from_reference
from repro_torch.serving import ContinuousBatcher, Engine, Request
from test_torch_decode import (_assert_logits_close, _assert_streams_match,
                               _requests, _to_numpy_cache, qwen)  # noqa: F401

PARTIALS_TOL = 1e-4
OUT_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _default_partials():
    yield
    collectives.set_fused_partials(None)


# ---------------------------------------------------------------------------
# The partials plain version vs the reference oracle and Pallas kernel
# ---------------------------------------------------------------------------

# the six cases of tests/test_serving_sharded.py, then qwen2's GQA 7
PARTIALS_CASES = [
    ((2, 8, 32), (2, 128, 2, 32), 100, 0, None, None),    # plain causal
    ((2, 8, 32), (2, 128, 2, 32), 100, 64, None, None),   # shard offset
    ((2, 8, 32), (2, 128, 2, 32), 10, 128, None, None),   # neutral element
    ((2, 8, 32), (2, 128, 2, 32), 300, 0, None, None),    # fully covered
    ((2, 8, 32), (2, 128, 2, 32), 37, 0, 16, 20.0),       # window + softcap
    ((2, 8, 32), (2, 128, 2, 32), 255, 128, 64, None),    # window crossing
    ((2, 14, 64), (2, 128, 2, 64), 90, 64, None, None),   # qwen2: GQA 7
]


@pytest.mark.parametrize("case", PARTIALS_CASES,
                         ids=[f"len{c[2]}-off{c[3]}-w{c[4]}-cap{c[5]}-h"
                              f"{c[0][1]}" for c in PARTIALS_CASES])
def test_partials_match_jax_ref_and_interpret_kernel(case):
    qs, ks, length, offset, window, cap = case
    rng = np.random.default_rng(0)
    q, kc, vc = _randn(rng, *qs), _randn(rng, *ks), _randn(rng, *ks)
    want_ref = jref.decode_attention_partials_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(length),
        offset=offset, window=window, softcap=cap)
    want_kernel = jops.decode_attention_partials(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(length),
        offset=jnp.int32(offset), window=window, softcap=cap, block_t=64,
        interpret=True)
    for got in (decode_attention_partials_ref(_t(q), _t(kc), _t(vc), length,
                                              offset=offset, window=window,
                                              softcap=cap),
                ops.decode_attention_partials(_t(q), _t(kc), _t(vc), length,
                                              offset=offset, window=window,
                                              softcap=cap)):
        for g, r, k in zip(got, want_ref, want_kernel):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       atol=PARTIALS_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(k),
                                       atol=PARTIALS_TOL)
    if offset > length:  # a shard wholly past the row: the neutral element
        num, den, m = got
        assert not num.any() and not den.any() and (m == -1e30).all()


def test_partials_wrapper_checks_its_inputs():
    q = torch.zeros(2, 8, 32)
    kv = torch.zeros(2, 64, 2, 32)
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention_partials(q, kv, kv, 3, window=0)
    with pytest.raises(ValueError, match="do not match"):
        ops.decode_attention_partials(q, kv[:1], kv[:1], 3)


# ---------------------------------------------------------------------------
# Write + decode without a mesh vs the reference's
# ---------------------------------------------------------------------------


def _write_decode_inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (_randn(rng, 2, 1, 8, 32), _randn(rng, 2, 1, 2, 32),
            _randn(rng, 2, 1, 2, 32), _randn(rng, 2, 128, 2, 32),
            _randn(rng, 2, 128, 2, 32))


def _jax_write_decode(inputs, lengths, window, cap):
    jcollectives.set_fused_partials(False)
    try:
        o, k, v = jcollectives.seq_sharded_write_decode(
            *map(jnp.asarray, inputs), jnp.asarray(lengths, jnp.int32),
            window=window, cap=cap)
    finally:
        jcollectives.set_fused_partials(None)
    return np.asarray(o), np.asarray(k), np.asarray(v)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "wrapper"])
@pytest.mark.parametrize("lengths", [77, [0, 127], [5, 100]],
                         ids=["scalar", "ragged-edge", "ragged-mid"])
@pytest.mark.parametrize("window,cap", [(None, None), (32, None),
                                        (None, 30.0)])
def test_write_decode_matches_jax(window, cap, lengths, fused):
    inputs = _write_decode_inputs()
    want_o, want_k, want_v = _jax_write_decode(inputs, lengths, window, cap)
    q, kn, vn, kc, vc = map(_t, inputs)
    collectives.set_fused_partials(fused)
    o, k, v = collectives.seq_sharded_write_decode(
        q, kn, vn, kc, vc, torch.tensor(lengths, dtype=torch.int32),
        window=window, cap=cap)
    assert k is kc and v is vc  # written in place
    np.testing.assert_allclose(o.numpy(), want_o, atol=OUT_TOL)
    np.testing.assert_array_equal(k.numpy(), want_k)
    np.testing.assert_array_equal(v.numpy(), want_v)
    for b, n in enumerate(np.broadcast_to(lengths, (2,))):
        np.testing.assert_array_equal(k[b, n].numpy(), inputs[1][b, 0])


def test_write_past_capacity_is_skipped_unlike_dense_clamp():
    """A free row whose length has reached S writes nowhere under
    seq_shard (``_write_at``'s range check, as the reference's), where the
    dense path's ``write_kv_rows`` clamps the write to position S - 1."""
    inputs = _write_decode_inputs(2)
    lengths = [5, 128]
    want_o, want_k, _ = _jax_write_decode(inputs, lengths, None, None)
    q, kn, vn, kc, vc = map(_t, inputs)
    before = kc.clone()
    o, k, _ = collectives.seq_sharded_write_decode(
        q, kn, vn, kc, vc, torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_array_equal(k.numpy(), want_k)
    np.testing.assert_allclose(o.numpy(), want_o, atol=OUT_TOL)
    assert torch.equal(k[1], before[1])  # row 1: nothing written
    dense = attention.write_kv_rows(before.clone(), kn, torch.tensor(lengths))
    assert torch.equal(dense[1, 127], kn[1, 0])  # the dense path clamps


def test_row_with_no_visible_key_gives_zero():
    """``_combine_local`` divides by max(den, 1e-30): a row that sees no
    key (a window wholly past the cache's end) gives 0, as the reference's
    seq-shard path does; the plain dense version averages v instead."""
    inputs = _write_decode_inputs(3)
    q, _, _, kc, vc = map(_t, inputs)
    lengths = torch.tensor([50, 400], dtype=torch.int32)
    o = collectives.seq_sharded_decode(q, kc, vc, lengths, window=16)
    jcollectives.set_fused_partials(False)
    try:
        want = jcollectives.seq_sharded_decode(
            *(jnp.asarray(x) for x in (inputs[0], inputs[3], inputs[4])),
            jnp.asarray(lengths.numpy()), window=16)
    finally:
        jcollectives.set_fused_partials(None)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=OUT_TOL)
    assert not o[1].any()
    dense = decode_attention_ref(q[:, 0], kc, vc, lengths, window=16)
    torch.testing.assert_close(dense[1], vc[1].mean(0).repeat_interleave(
        4, 0), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The engine and the batcher on a one-rank mesh
# ---------------------------------------------------------------------------


def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _mesh_engines(qwen, cache_pad=56):
    jeng = JEngine(jbuild(qwen["jcfg"]), JRunConfig(cache_pad=cache_pad),
                   mesh=_jax_mesh(), seq_shard=True)
    eng = Engine(build(qwen["cfg"]), RunConfig(cache_pad=cache_pad),
                 device="cpu", mesh=make_host_mesh((1, 1)), seq_shard=True)
    return jeng, eng


def test_engine_forces_seq_shard_and_plans_like_jax(qwen):
    """The forced ``attn_impl`` and the cache's layout: on a one-rank mesh
    the reference's planner keeps the sequence whole, and so does the
    port's cache."""
    jeng, eng = _mesh_engines(qwen)
    assert eng.run.attn_impl == jeng.run.attn_impl == "seq_shard"
    jspec = jeng.cache_sharding(jeng.new_cache(3, 64)).layers[0]["k"].spec
    assert tuple(jspec)[2] is None
    c = eng.new_cache(3, 64)
    assert c.seq_shards == 1 and c.layers[0]["k"].shape[1] == 64


def test_engine_generate_matches_jax_mesh_engine(qwen):
    jeng, eng = _mesh_engines(qwen)
    collectives.set_fused_partials(True)
    prompt = np.random.default_rng(4).integers(
        0, qwen["cfg"].vocab_size, (6, 8)).astype(np.int32)
    want = jeng.generate(jeng.shard_params(qwen["jparams"]), prompt,
                         max_new_tokens=6)
    got = eng.generate(eng.shard_params(qwen["params"]), prompt,
                       max_new_tokens=6)
    _assert_streams_match(qwen, prompt, want[:, 8:], got[:, 8:])
    assert eng.compile_count == jeng.compile_count


def test_prefill_into_decode_free_row_match_jax(qwen):
    jeng, eng = _mesh_engines(qwen)
    collectives.set_fused_partials(True)
    jp = jeng.shard_params(qwen["jparams"])
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, qwen["cfg"].vocab_size, (1, n)).astype(
        np.int32) for n in (5, 9, 7)]
    jc, c = jeng.new_cache(3, 64), eng.new_cache(3, 64)
    assert c.layers[0]["k"].shape == (3, 64, 2, 16) and c.seq_shards == 1
    for row, p in enumerate(prompts):
        jl, jc = jeng.prefill_into(jp, jc, row, p)
        pl, c = eng.prefill_into(qwen["params"], c, row, p)
        _assert_logits_close(pl, jl)
    ptrs = [t.data_ptr() for t in c.tensors()]
    tok = np.array([[1], [2], [3]], np.int32)
    for step in range(3):
        jl, jc = jeng.decode(jp, jc, tok)
        pl, c = eng.decode(qwen["params"], c, tok)
        _assert_logits_close(pl, jl)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        if step == 1:
            jc = jeng.free_row(jc, 1)
            c = eng.free_row(c, 1)
    np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(jc.lengths))
    assert [t.data_ptr() for t in c.tensors()] == ptrs  # in place
    assert eng.compile_count == jeng.compile_count


def test_batcher_on_one_rank_mesh_matches_jax(qwen):
    """10 requests over 3 slots through admit/evict churn: one decode call
    a round, flat shape buckets, streams and counters as the reference's
    one-device-mesh batcher."""
    jeng, eng = _mesh_engines(qwen)
    collectives.set_fused_partials(True)
    jb = JBatcher(jeng, jeng.shard_params(qwen["jparams"]), n_slots=3)
    pb = ContinuousBatcher(eng, eng.shard_params(qwen["params"]), n_slots=3)
    jb.submit_many(_requests(JRequest, qwen["cfg"].vocab_size))
    reqs = _requests(Request, qwen["cfg"].vocab_size)
    pb.submit_many(reqs)
    compiles = []
    while not pb.scheduler.idle:
        before = pb.decode_dispatches
        pb.step()
        compiles.append(eng.compile_count)
        assert pb.decode_dispatches == before + 1
    want = jb.run()
    got = pb.scheduler.completed
    assert [r.rid for r in got] == [r.rid for r in want]
    _assert_streams_match(qwen, [r.prompt for r in got],
                          [r.generated for r in want],
                          [r.generated for r in got])
    for name in ("decode_dispatches", "decode_steps", "sampler_dispatches",
                 "rounds"):
        assert getattr(pb, name) == getattr(jb, name), name
    n_shapes = len({len(r.prompt) for r in reqs})
    # + decode, free_row and, under a mesh, new_cache
    assert eng.compile_count == jeng.compile_count == n_shapes + 3
    assert compiles[-1] == max(compiles)  # flat once every shape was seen


def test_mesh_guards(qwen):
    """int8 and paged caches under a mesh raise as in the reference; the
    batcher turns paged off under a mesh; unported layouts name their
    ROADMAP item."""
    model = build(qwen["cfg"])
    mesh = make_host_mesh((1, 1))
    with pytest.raises(ValueError, match="single-host"):
        Engine(model, RunConfig(kv_dtype="int8"), device="cpu", mesh=mesh)
    eng = Engine(model, RunConfig(), device="cpu", mesh=mesh, seq_shard=True)
    with pytest.raises(ValueError, match="single-host"):
        eng.new_paged_cache(2, 9, 16, 4)
    assert not ContinuousBatcher(eng, qwen["params"], paged=True).paged
    q = torch.zeros(1, 1, 4, 16)
    kv = torch.zeros(1, 8, 2, 16, dtype=torch.int8)
    scale = torch.ones(1, 8, 2, 1)
    with pytest.raises(ValueError, match="seq_shard"):
        attention.attend_decode(q, kv, kv, 0, k_scale=scale, v_scale=scale,
                                impl="seq_shard")


def test_sampled_serving_under_a_mesh_runs_the_sampling_wrapper(
        qwen, monkeypatch):
    """Fused sampling under a mesh goes through the sampling kernel's
    wrapper once an admission and once a round, as without a mesh: the
    reference takes its plain epilogue there because its logits arrive
    split over the vocabulary, and the port's never do (on CPU tensors the
    wrapper runs the kernel's plain version). It draws what the host
    sampler draws, so fused and host streams agree."""
    _, eng = _mesh_engines(qwen)
    kernel, calls = fs.fused_sample_kernel, []

    def counted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **kwargs)

    monkeypatch.setattr(fs, "fused_sample_kernel", counted)
    kw = dict(temperature=0.8, top_k=5, top_p=0.9, seed=3)
    streams = []
    for fused in (False, True):
        calls.clear()
        b = ContinuousBatcher(eng, qwen["params"], n_slots=3,
                              fused_sampling=fused, **kw)
        reqs = _requests(Request, qwen["cfg"].vocab_size, seed=1)
        b.submit_many(reqs)
        streams.append([r.generated for r in b.run()])
        assert (b.sampler_dispatches == 0) == fused
        assert len(calls) == (len(reqs) + b.rounds if fused else 0)
    assert streams[0] == streams[1]


@pytest.mark.parametrize("world", [1, 2, 4, 3])
def test_cache_from_reference_gives_each_rank_its_block(qwen, world):
    """One reference cache, loaded into each rank of a (1, world) mesh:
    rank r holds positions [r T / M, (r + 1) T / M) of every layer (the
    whole cache where M does not divide T = 64, as the planner lays it
    out), and the blocks together are the reference cache."""
    jeng = JEngine(jbuild(qwen["jcfg"]), JRunConfig())
    jc = jeng.new_cache(2, 64)
    prompt = np.arange(9, dtype=np.int32)[None] % qwen["cfg"].vocab_size
    _, jc = jeng.prefill_into(qwen["jparams"], jc, 1, prompt)
    ref = _to_numpy_cache(jc)
    whole = cache_from_reference(ref, qwen["cfg"], device="cpu")
    blocks = [cache_from_reference(
        ref, qwen["cfg"], device="cpu",
        mesh=Mesh(np.arange(world).reshape(1, world), ("data", "model"),
                  rank=r)) for r in range(world)]
    shards = world if 64 % world == 0 else 1
    for c in blocks:
        assert c.seq_shards == shards
        assert torch.equal(c.lengths, whole.lengths)
    for layer, want in enumerate(whole.layers):
        for name in want:
            got = (torch.cat([c.layers[layer][name] for c in blocks], dim=1)
                   if shards > 1 else blocks[-1].layers[layer][name])
            assert torch.equal(got, want[name])
