"""Port's block-paged KV cache against the JAX reference, qwen2-7b smoke.

Kernel level: ``gather_pages``, the paged plain versions (bf16 and int8)
and the wrapper's CPU path against the JAX oracles and the interpret-mode
Pallas kernels ``paged_decode_attention_kernel`` and
``paged_decode_attention_quant_kernel``, on permuted tables with shared
pages, a free row's all-zero table, page sizes 8 and 16 and lengths 0,
capacity - 1 and past capacity; at least 64 logical positions, so the JAX
wrapper would run its kernels too. Tolerances are the reference kernel
tests': 2e-5 in fp32, 2e-2 in bf16.

Model and serving level, from shared caches (``paged_cache_from_reference``)
and the same params: the paged write, cold and warm ``extend_paged``,
ragged paged ``decode_step`` (active rows only: free rows all write the
null page 0, in an undefined order) and the batcher's greedy streams,
with ``test_torch_decode.py``'s tolerances and near-tie rule (int8 values
as in ``test_torch_kv_int8.py``). ``PageAllocator`` is driven by one
random script in both packages and must agree exactly. The serving
contracts of ``tests/test_paged_cache.py`` are held on the port itself.
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
from repro.kernels.decode_attention.decode_attention import (
    paged_decode_attention_kernel, paged_decode_attention_quant_kernel)
from repro.models import RunConfig as JRunConfig
from repro.models import attention as jattention
from repro.models import build as jbuild
from repro.models import transformer as jtransformer
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import Engine as JEngine
from repro.serving import PageAllocator as JPageAllocator
from repro.serving import PagesExhausted as JPagesExhausted
from repro.serving import Request as JRequest
from repro_torch import configs
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import quant
from repro_torch.kernels.decode_attention.ref import (
    gather_pages, paged_decode_attention_quant_ref,
    paged_decode_attention_ref)
from repro_torch.models import RunConfig, attention, build, transformer
from repro_torch.models.convert import paged_cache_from_reference
from repro_torch.serving import (ContinuousBatcher, Engine, PageAllocator,
                                 PagesExhausted, Request)
from repro_torch.serving.engine import _shape_key
from test_torch_decode import (_assert_logits_close,  # noqa: F401
                               _assert_streams_match, _np, _to_numpy_cache,
                               qwen)
from test_torch_kv_int8 import CACHE_REL_TOL, _assert_int8_close

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PS = 8  # small pages so short prompts span several


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# Paged decode attention: plain versions and CPU wrapper vs the reference
# ---------------------------------------------------------------------------

# (b, h, kv, d, ps, pmax, lengths, window, cap); row 1 shares row 0's
# first pages, the last row is free (all-zero table)
CASES = [
    (4, 4, 2, 32, 8, 8, (0, 63, 64, 300), None, None),   # cap-1, past cap
    (3, 8, 2, 16, 16, 4, (40, 63, 9), 24, 20.0),          # window, softcap
    (3, 7, 1, 64, 16, 8, (127, 77, 5), None, None),       # GQA 7
]
IDS = [str(c[:6]) for c in CASES]


def _table(rng, b, pmax, n_pages):
    perm = rng.permutation(np.arange(1, n_pages))[:b * pmax]
    table = perm.reshape(b, pmax).astype(np.int32)
    table[1, :pmax // 2] = table[0, :pmax // 2]   # shared prefix pages
    table[-1] = 0                                  # a free row
    return table


def _paged_inputs(case, dtype, int8, seed=0):
    b, h, kv, d, ps, pmax, lengths = case[:7]
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * pmax
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    pools = [rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32)
             for _ in range(2)]
    table = _table(rng, b, pmax, n_pages)
    lens = np.asarray(lengths, np.int32)
    jd = getattr(jnp, dtype)
    if int8:
        (kq, ks), (vq, vs) = (jquant.quantize_kv(jnp.asarray(p))
                              for p in pools)
        jx = (jnp.asarray(q, jd), kq, vq, ks, vs, lens, table)
    else:
        jx = (*(jnp.asarray(a, jd) for a in (q, *pools)), lens, table)
    jx = tuple(jnp.asarray(a) for a in jx)
    return jx, tuple(_to_torch(a) for a in jx)


def _to_torch(a):
    """A JAX array as a tensor of the same dtype (bf16 via fp32, exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).bfloat16()
    return torch.tensor(a)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((9, 4, 2, 8)).astype(np.float32)
    table = _table(rng, 3, 2, 9)
    want = jax_ref.gather_pages(jnp.asarray(pool), jnp.asarray(table))
    got = gather_pages(torch.tensor(pool), torch.tensor(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_ref_and_wrapper_match_jax(case, dtype):
    """bf16/fp32 pools: plain version vs the JAX oracle; the wrapper's CPU
    path vs the interpret-mode Pallas paged kernel."""
    window, cap = case[7:]
    (jq, jk, jv, jl, jt), (tq, tk, tv, tl, tt) = _paged_inputs(case, dtype,
                                                               False)
    want = jax_ref.paged_decode_attention_ref(jq, jk, jv, jl, jt,
                                              window=window, softcap=cap)
    got = paged_decode_attention_ref(tq, tk, tv, tl, tt, window=window,
                                     softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)
    kernel = paged_decode_attention_kernel(jq, jk, jv, jl, jt, window=window,
                                           softcap=cap, interpret=True)
    before = da_ops.paged_launches
    got = da_ops.paged_decode_attention(tq, tk, tv, tl, tt, window=window,
                                        softcap=cap)
    assert da_ops.paged_launches == before  # CPU tensors never launch
    _close(got, kernel, dtype)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_quant_ref_and_wrapper_match_jax(case, dtype):
    """int8 pools with scale pools through the same table: plain version
    vs JAX's dequantize-gather-oracle; the wrapper's CPU path vs the
    interpret-mode Pallas paged quant kernel."""
    window, cap = case[7:]
    (jq, jk, jv, jks, jvs, jl, jt), (tq, tk, tv, tks, tvs, tl, tt) = \
        _paged_inputs(case, dtype, True, seed=1)
    want = jax_ref.paged_decode_attention_ref(
        jq, jquant.dequantize_kv(jk, jks), jquant.dequantize_kv(jv, jvs), jl,
        jt, window=window, softcap=cap)
    got = paged_decode_attention_quant_ref(tq, tk, tv, tks, tvs, tl, tt,
                                           window=window, softcap=cap)
    _close(got, want, dtype)
    kernel = paged_decode_attention_quant_kernel(
        jq, jk, jv, jks, jvs, jl, jt, window=window, softcap=cap,
        interpret=True)
    before = da_ops.paged_quant_launches
    got = da_ops.paged_decode_attention(tq, tk, tv, tl, tt, k_scale=tks,
                                        v_scale=tvs, window=window,
                                        softcap=cap)
    assert da_ops.paged_quant_launches == before
    _close(got, kernel, dtype)


def test_paged_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(5, 8, 2, 16)
    with pytest.raises(ValueError, match="page_table"):
        da_ops.paged_decode_attention(q, pool, pool, 0,
                                      torch.zeros(3, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        da_ops.paged_decode_attention(q, torch.zeros(5, 8, 2, 32),
                                      torch.zeros(5, 8, 2, 32), 0,
                                      torch.zeros(2, 2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Paged write, extend and decode vs the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_free", [1, 2], ids=["one_free", "two_free"])
def test_write_kv_pages_matches_jax(n_free):
    """Rows at 5, 15 (a page's last slot) and past capacity (the logical
    slot clips to Pmax - 1, the offset is len % ps), plus free rows whose
    zero tables route their writes to page 0. With two free rows writing
    one slot of page 0, that slot's value is undefined in both packages:
    page 0 is left out of the comparison."""
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((9, 4, 2, 8)).astype(np.float32)
    table = rng.permutation(np.arange(1, 9)).reshape(2, 4).astype(np.int32)
    table = np.concatenate([table, np.zeros((n_free, 4), np.int32)])
    lengths = np.array([5, 15, 21][:2] + [3] * n_free, np.int32)
    lengths[1] = 21  # past capacity (4 pages x 4)
    new = rng.standard_normal((2 + n_free, 1, 2, 8)).astype(np.float32)
    want = np.asarray(jattention.write_kv_pages(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(table),
        jnp.asarray(lengths), 4))
    got = torch.tensor(pool)
    out = attention.write_kv_pages(got, torch.tensor(new),
                                   torch.tensor(table),
                                   torch.tensor(lengths), 4)
    assert out is got
    first = 0 if n_free == 1 else 1
    np.testing.assert_array_equal(got.numpy()[first:], want[first:])


def _jpaged_engine(qwen, kv_dtype="bf16", impl="xla"):
    return JEngine(jbuild(qwen["jcfg"]), JRunConfig(attn_impl=impl,
                                                    kv_dtype=kv_dtype))


def _engine(qwen, kv_dtype="bf16", impl="xla"):
    return Engine(build(qwen["cfg"]), RunConfig(attn_impl=impl,
                                                kv_dtype=kv_dtype),
                  device="cpu")


def assert_pools_match(cache, jcache, cfg, pages=None):
    """Port's per-layer pools against the reference's stacked ones, on
    physical ``pages`` (default all but the null page 0)."""
    np.testing.assert_array_equal(cache.page_table.numpy(),
                                  np.asarray(jcache.page_table))
    np.testing.assert_array_equal(cache.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    assert cache.page_size == jcache.page_size
    n = cache.layers[0]["k"].shape[0]
    pages = list(range(1, n)) if pages is None else list(pages)
    for layer, c in enumerate(cache.layers):
        ref = jcache.layers[layer % cfg.period]
        g = layer // cfg.period
        if "k_scale" in c:
            for name in ("k", "v"):
                _assert_int8_close(c[name][pages], c[f"{name}_scale"][pages],
                                   np.asarray(ref[name][g])[pages],
                                   np.asarray(ref[f"{name}_scale"][g])[pages])
            continue
        for name in ("k", "v"):
            want = _np(ref[name][g])[pages]
            np.testing.assert_allclose(
                _np(c[name][pages].float()), want,
                atol=CACHE_REL_TOL * max(np.abs(want).max(), 1e-6))


def _prompts(vocab, seed=5):
    """Two prompts sharing a 2-page prefix (PS = 8), and a third."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 2 * PS)
    return [np.concatenate([prefix, rng.integers(0, vocab, n)]).astype(
        np.int32) for n in (5, 3)] + [rng.integers(0, vocab, 11).astype(
            np.int32)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_extend_paged_cold_and_warm_match_jax(qwen, kv_dtype):
    """Row 0 cold (the full prompt), then row 1 warm (its suffix only,
    attending row 0's shared prefix pages): logits and pools vs JAX, each
    side from its own previous state."""
    jeng, eng = _jpaged_engine(qwen, kv_dtype), _engine(qwen, kv_dtype)
    prompts = _prompts(qwen["cfg"].vocab_size)
    alloc = JPageAllocator(n_pages=12, page_size=PS, max_pages=4)
    jcache = jeng.new_paged_cache(3, 12, PS, 4)
    cache = None
    for row, prompt in enumerate(prompts[:2]):
        plan = alloc.admit(row, prompt, 4)
        assert plan.n_shared == (2 if row else 0)
        jcache = jeng.assign_row_pages(jcache, row, plan.pages,
                                       plan.start_len)
        if cache is None:
            cache = paged_cache_from_reference(_to_numpy_cache(jcache),
                                               qwen["cfg"], device="cpu")
        else:
            out = eng.assign_row_pages(cache, row, plan.pages,
                                       plan.start_len)
            assert out is cache
        jl, jcache = jeng.extend_row(qwen["jparams"], jcache, row,
                                     plan.suffix[None])
        logits, out = eng.extend_row(qwen["params"], cache, row,
                                     plan.suffix[None])
        assert out is cache and logits.shape == (1, qwen["cfg"].vocab_size)
        _assert_logits_close(logits, jl)
        assert_pools_match(cache, jcache, qwen["cfg"])
    np.testing.assert_array_equal(cache.lengths.numpy(),
                                  [len(prompts[0]), len(prompts[1]), 0])


def _jpaged_ragged(qwen, kv_dtype):
    """A reference paged cache: rows 0 (cold) and 1 (warm) admitted, row 2
    free with its length past the row capacity; also the allocator."""
    jeng = _jpaged_engine(qwen, kv_dtype)
    alloc = JPageAllocator(n_pages=12, page_size=PS, max_pages=4)
    jcache = jeng.new_paged_cache(3, 12, PS, 4)
    for row, prompt in enumerate(_prompts(qwen["cfg"].vocab_size)[:2]):
        plan = alloc.admit(row, prompt, 4)
        jcache = jeng.assign_row_pages(jcache, row, plan.pages,
                                       plan.start_len)
        _, jcache = jeng.extend_row(qwen["jparams"], jcache, row,
                                    plan.suffix[None])
    return dataclasses.replace(
        jcache, lengths=jcache.lengths.at[2].set(4 * PS + 3)), alloc


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_paged_decode_step_matches_jax(qwen, kv_dtype, impl):
    """Two rounds of ragged paged decode on a shared cache: active rows'
    logits and the non-null pages vs JAX ("pallas": the interpret-mode
    paged kernels, 32 logical positions, as the JAX wrapper would take its
    oracle there; the kernels themselves are held above). Every row's
    length advances, the free row's too."""
    jcache, _ = _jpaged_ragged(qwen, kv_dtype)
    cache = paged_cache_from_reference(_to_numpy_cache(jcache), qwen["cfg"],
                                       device="cpu")
    run = dict(attn_impl=impl, kv_dtype=kv_dtype)
    step = jax.jit(jtransformer.decode_step, static_argnums=(0, 1))
    token = np.array([[3], [7], [11]], np.int32)
    for _ in range(2):
        jl, jcache = step(qwen["jcfg"], JRunConfig(**run), qwen["jparams"],
                          jcache, token=jnp.asarray(token))
        logits, out = transformer.decode_step(
            qwen["cfg"], RunConfig(**run), qwen["params"], cache,
            token=torch.tensor(token))
        assert out is cache
        _assert_logits_close(logits[:2], np.asarray(jl)[:2])
        assert_pools_match(cache, jcache, qwen["cfg"])
        token = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
    assert cache.lengths.tolist() == [len(p) + 2 for p in _prompts(
        qwen["cfg"].vocab_size)[:2]] + [4 * PS + 5]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_active_rows_never_read_the_null_page(qwen, kv_dtype):
    """Free rows write garbage into page 0; an active row's logits do not
    change when page 0 holds anything at all."""
    jcache, _ = _jpaged_ragged(qwen, kv_dtype)
    eng = _engine(qwen, kv_dtype, "pallas")
    token = np.array([[3], [7], [11]], np.int32)
    logits = []
    for poison in (False, True):
        cache = paged_cache_from_reference(_to_numpy_cache(jcache),
                                           qwen["cfg"], device="cpu")
        if poison:
            for layer in cache.layers:
                for t in layer.values():
                    t[0] = 99 if t.dtype == torch.int8 else 1e4
        logits.append(eng.decode(qwen["params"], cache, token)[0])
    assert torch.equal(logits[0][:2], logits[1][:2])
    assert not torch.equal(logits[0][2], logits[1][2])


# ---------------------------------------------------------------------------
# The host-side allocator: one random script through both packages
# ---------------------------------------------------------------------------


def _allocator_state(a):
    return (list(a.free_list), list(a.reclaimable), list(a.refcounts),
            {r: list(p) for r, p in a.rows.items()}, a.n_free, a.n_live)


def test_page_allocator_matches_jax_under_random_script():
    """300 random admit / fork / writable_page / free steps on both
    allocators: the same plans, copies, errors and state at every step."""
    rng = np.random.default_rng(11)
    prefixes = [rng.integers(0, 5, n) for n in (8, 12, 4)]
    allocs = [JPageAllocator(14, 4, 6), PageAllocator(14, 4, 6)]
    for _ in range(300):
        op = rng.choice(["admit", "admit", "fork", "write", "free"])
        row = int(rng.integers(0, 5))
        if op == "admit":
            prompt = np.concatenate([prefixes[rng.integers(0, 3)],
                                     rng.integers(0, 5, rng.integers(0, 6))
                                     ]).astype(np.int32)
            args = (row, prompt, int(rng.integers(1, 10)))
        elif op == "fork":
            args = (row, int(rng.integers(0, 5)))
        elif op == "write":
            args = (row, int(rng.integers(0, 24)))
        else:
            args = (row,)
        name = {"admit": "admit", "fork": "fork", "write": "writable_page",
                "free": "free"}[op]
        results = []
        for a in allocs:
            try:
                r = getattr(a, name)(*args)
                results.append(("ok", dataclasses.astuple(r)
                                if dataclasses.is_dataclass(r) else r))
            except (KeyError, ValueError, IndexError) as e:
                results.append((type(e).__name__, None))
            except (JPagesExhausted, PagesExhausted):
                results.append(("PagesExhausted", None))
        (jr, jv), (pr, pv) = results
        assert jr == pr, (op, args, results)
        if jv is not None and op == "admit":
            jv, pv = jv[:4] + (list(jv[4]),), pv[:4] + (list(pv[4]),)
        assert jv == pv, (op, args)
        assert _allocator_state(allocs[0]) == _allocator_state(allocs[1])


# ---------------------------------------------------------------------------
# Serving: the paged batcher against JAX's and against the dense one
# ---------------------------------------------------------------------------


def _requests(cls, vocab, seed=0):
    """Six requests: two groups sharing a 2-page prefix, then a loner."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(2):
        prefix = rng.integers(0, vocab, 2 * PS)
        for n in (3, 5, 3):
            prompt = np.concatenate([prefix, rng.integers(0, vocab, n)])
            reqs.append(cls(len(reqs), prompt.astype(np.int32),
                            max_new_tokens=int(rng.integers(2, 6))))
    return reqs


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_batcher_greedy_matches_jax_and_dense(qwen, kv_dtype):
    """Six requests over 3 slots, two shared-prefix groups: the port's
    paged batcher against JAX's paged batcher (streams by the near-tie
    rule, counters, completion order) and against the port's dense
    batcher (streams by the near-tie rule)."""
    vocab = qwen["cfg"].vocab_size
    jb = JBatcher(_jpaged_engine(qwen, kv_dtype, "pallas"), qwen["jparams"],
                  n_slots=3, paged=True, page_size=PS)
    jb.submit_many(_requests(JRequest, vocab))
    eng = _engine(qwen, kv_dtype, "pallas")
    pb = ContinuousBatcher(eng, qwen["params"], n_slots=3, paged=True,
                           page_size=PS)
    reqs = _requests(Request, vocab)
    pb.submit_many(reqs)
    dense = ContinuousBatcher(_engine(qwen, kv_dtype, "pallas"),
                              qwen["params"], n_slots=3)
    dense_reqs = _requests(Request, vocab)
    dense.submit_many(dense_reqs)
    want, got = jb.run(), pb.run()
    dense.run()
    assert pb.paged and isinstance(pb.cache, transformer.PagedCache)
    assert [r.rid for r in got] == [r.rid for r in want]
    assert all(r.done for r in reqs)
    _assert_streams_match(qwen, [r.prompt for r in got],
                          [r.generated for r in want],
                          [r.generated for r in got])
    _assert_streams_match(qwen, [r.prompt for r in reqs],
                          [r.generated for r in dense_reqs],
                          [r.generated for r in reqs])
    for name in ("decode_dispatches", "decode_steps", "sampler_dispatches",
                 "rounds"):
        assert getattr(pb, name) == getattr(jb, name), name
    assert pb.allocator.n_pages == jb.allocator.n_pages
    assert pb.cache.layers[0]["k"].dtype == (
        torch.int8 if kv_dtype == "int8" else torch.bfloat16)


def test_paged_compile_count_flat_and_one_decode_per_round(qwen):
    rng = np.random.default_rng(1)
    eng = _engine(qwen)
    b = ContinuousBatcher(eng, qwen["params"], n_slots=3, max_len=32,
                          paged=True, page_size=PS)

    def wave(base):
        return [Request(base + i, rng.integers(0, 250, n).astype(np.int32),
                        max_new_tokens=3) for i, n in enumerate((6, 10, 14))]

    b.submit_many(wave(0))
    b.run()
    warm, rounds0, calls0 = eng.compile_count, b.rounds, b.decode_dispatches
    assert calls0 == rounds0
    b.submit_many(wave(10))
    b.run()
    assert eng.compile_count == warm
    assert b.decode_dispatches - calls0 == b.rounds - rounds0
    assert len(b.scheduler.completed) == 6


def test_pages_exhausted_requeues_and_oversized_is_rejected(qwen):
    """A pool for one row at a time: the second request waits at the queue
    front and completes once pages return; a request that can never fit a
    row is rejected while the round goes on."""
    rng = np.random.default_rng(2)
    eng = _engine(qwen)
    b = ContinuousBatcher(eng, qwen["params"], n_slots=2, max_len=16,
                          paged=True, page_size=PS, n_pages=1 + 2)
    b.submit_many([Request(i, rng.integers(0, 250, 12).astype(np.int32),
                           max_new_tokens=3) for i in range(2)])
    b.run()
    assert sorted(r.rid for r in b.scheduler.completed) == [0, 1]
    assert b.take_rejected() == []
    b = ContinuousBatcher(eng, qwen["params"], n_slots=2, max_len=24,
                          paged=True, page_size=PS)
    b.submit(Request(0, rng.integers(0, 250, 6).astype(np.int32), 2))
    b.submit(Request(1, rng.integers(0, 250, 30).astype(np.int32), 20))
    b.run()
    assert [r.rid for r in b.scheduler.completed] == [0]
    assert [r.rid for r in b.take_rejected()] == [1]


def test_fork_cow_divergence_matches_independent_decodes(qwen):
    """Fork row 0 into row 1 (no KV copied), force a different first
    token, decode both in the same calls: the copy-on-write barrier copies
    the shared tail page (values only: the pools keep their addresses),
    and each branch equals its unforked decode."""
    eng = _engine(qwen, impl="pallas")
    prompt = np.random.default_rng(3).integers(0, 250, PS + 4).astype(
        np.int32)
    steps = 4
    alloc = PageAllocator(n_pages=9, page_size=PS, max_pages=3)
    cache = eng.new_paged_cache(2, 9, PS, 3)
    ptrs = [t.data_ptr() for t in cache.tensors()]
    plan = alloc.admit(0, prompt, steps + 1)
    eng.assign_row_pages(cache, 0, plan.pages, plan.start_len)
    logits, _ = eng.extend_row(qwen["params"], cache, 0, plan.suffix[None])
    t0 = int(logits[0].argmax())
    t1 = (t0 + 1) % 250
    alloc.fork(0, 1)
    assert eng.fork_row(cache, 0, 1) is cache
    assert cache.page_table[1].tolist() == cache.page_table[0].tolist()
    host_len, toks, out, cows = {0: len(prompt), 1: len(prompt)}, \
        np.array([[t0], [t1]], np.int32), {0: [t0], 1: [t1]}, 0
    for _ in range(steps):
        for row in (0, 1):
            cow = alloc.writable_page(row, host_len[row])
            if cow is not None:
                cows += 1
                assert eng.cow_copy_page(cache, *cow) is cache
                for layer in cache.layers:
                    assert torch.equal(layer["k"][cow[0]], layer["k"][cow[1]])
                eng.assign_row_pages(cache, row, alloc.rows[row],
                                     host_len[row])
        logits, _ = eng.decode(qwen["params"], cache, toks)
        nxt = logits.argmax(-1).numpy().astype(np.int32)
        for row in (0, 1):
            out[row].append(int(nxt[row]))
            host_len[row] += 1
        toks = nxt[:, None]
    assert cows == 1 and alloc.rows[0][1] != alloc.rows[1][1]
    assert alloc.rows[0][0] == alloc.rows[1][0]
    assert [t.data_ptr() for t in cache.tensors()] == ptrs
    ref0 = eng.generate(qwen["params"], prompt[None],
                        max_new_tokens=steps + 1)
    forced = np.concatenate([prompt, [t1]]).astype(np.int32)
    ref1 = eng.generate(qwen["params"], forced[None], max_new_tokens=steps)
    _assert_streams_match(qwen, [prompt, forced],
                          [ref0[0, len(prompt):], ref1[0, len(forced):]],
                          [out[0], out[1][1:]])


def test_cow_copy_page_moves_int8_scales_too(qwen):
    eng = _engine(qwen, kv_dtype="int8")
    cache = eng.new_paged_cache(2, 4, PS, 2)
    for layer in cache.layers:
        layer["k"][1] = 5
        layer["v_scale"][1] = 0.25
    eng.cow_copy_page(cache, 1, 3)
    for layer in cache.layers:
        assert (layer["k"][3] == 5).all() and (layer["v_scale"][3] == 0.25
                                               ).all()


def test_cancel_frees_the_rows_pages(qwen):
    eng = _engine(qwen)
    b = ContinuousBatcher(eng, qwen["params"], n_slots=2, paged=True,
                          page_size=PS, max_len=32)
    reqs = _requests(Request, qwen["cfg"].vocab_size)[:3]
    b.submit_many(reqs)
    b.step()
    live = b.allocator.n_live
    assert b.cancel(reqs[1]) and b.cancel(reqs[2])  # in a slot, queued
    assert 1 not in b.allocator.rows and b.allocator.n_live < live
    assert int(b.cache.lengths[1]) == 0
    assert b.cache.page_table[1].tolist() == [0] * 4
    b.run()
    assert [r.rid for r in b.scheduler.completed] == [0]


def test_paged_fused_sampling_equals_host_sampling(qwen):
    kw = dict(temperature=0.8, top_k=5, top_p=0.9, seed=3, paged=True,
              page_size=PS)
    runs = []
    for fused in (False, True):
        b = ContinuousBatcher(_engine(qwen, "int8", "pallas"),
                              qwen["params"], n_slots=3,
                              fused_sampling=fused, **kw)
        reqs = _requests(Request, qwen["cfg"].vocab_size, seed=1)
        b.submit_many(reqs)
        b.run()
        runs.append((b, [r.generated for r in reqs]))
    (host, host_streams), (fused, fused_streams) = runs
    assert fused_streams == host_streams
    assert fused.sampler_dispatches == 0 < host.sampler_dispatches
    assert fused.decode_dispatches == fused.rounds


# ---------------------------------------------------------------------------
# Layouts, buckets and guard rails
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_cache_specs_layout_matches_jax(qwen, kv_dtype):
    jspecs = jbuild(qwen["jcfg"]).paged_cache_specs(2, 9, PS, 4,
                                                    kv_dtype=kv_dtype)
    specs = build(qwen["cfg"]).paged_cache_specs(2, 9, PS, 4,
                                                 kv_dtype=kv_dtype)
    assert all(t.device.type == "meta" for t in specs.tensors())
    assert specs.page_size == jspecs.page_size == PS
    assert tuple(specs.page_table.shape) == jspecs.page_table.shape
    for layer, c in enumerate(specs.layers):
        ref = jspecs.layers[layer % qwen["cfg"].period]
        assert set(c) == set(ref)
        for name, t in c.items():
            assert tuple(t.shape) == tuple(ref[name].shape[1:])
            assert str(t.dtype).removeprefix("torch.") == \
                jnp.dtype(ref[name].dtype).name


def test_paged_cache_needs_an_attention_only_pattern():
    model = build(configs.smoke("qwen2-7b"))
    ssm = dataclasses.replace(model.cfg, pattern=(
        model.cfg.pattern[0]._replace(mixer="ssm"),))
    with pytest.raises(ValueError, match="attention-only"):
        transformer.paged_cache_specs(ssm, 2, 9, PS, 4)


def test_shape_key_tells_layouts_and_page_sizes_apart(qwen):
    eng = _engine(qwen)
    keys = {_shape_key(eng.new_paged_cache(2, 9, ps, 4)) for ps in (4, 8)}
    keys.add(_shape_key(eng.new_cache(2, 32)))
    keys.add(_shape_key(_engine(qwen, "int8").new_cache(2, 32)))
    assert len(keys) == 4


def test_paged_falls_back_to_dense_without_batching(qwen):
    b = ContinuousBatcher(_engine(qwen), qwen["params"], paged=True,
                          batched=False)
    assert not b.paged
