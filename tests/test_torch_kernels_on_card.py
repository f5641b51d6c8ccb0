"""The hand-written CUDA kernels against their plain versions, on a card.

These tests need a CUDA device and ``nvcc`` (the kernels are built from
their sources at first use); without a device they skip. The file imports
nothing of jax, so it also runs where only the port is installed:

  python -m pytest -m gpu tests/test_torch_kernels_on_card.py

Tolerances are the reference kernel tests' own: 2e-5 in fp32, 2e-2 in bf16.
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.decode_attention import fused_sampling as fs
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.quant import quantize_kv
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partials_ref, decode_attention_quant_ref,
    decode_attention_ref,
    paged_decode_attention_quant_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import RunConfig, build
from repro_torch.serving import Engine

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# (b, s, t, h, kv, d, causal, window, cap)
GPU_CASES = [
    (1, 128, 128, 4, 2, 64, True, None, None),
    (2, 64, 64, 4, 4, 32, True, None, None),
    (1, 256, 256, 8, 2, 64, True, None, 50.0),
    (1, 128, 128, 4, 1, 64, True, 32, None),
    (2, 64, 128, 4, 2, 64, False, None, None),   # cross attn, t > s
    (1, 100, 100, 8, 2, 64, True, None, None),   # pad path
    (1, 96, 200, 2, 2, 128, False, None, 30.0),  # pad + bidir + cap
    (2, 7, 5, 2, 1, 16, False, None, None),      # tiny: still the kernel
    # tensor-parallel local heads: qwen2-7b on a "model" axis of 2 and 4
    # (a GQA group of 7 over one kv head), distilbert-imdb on 2
    (1, 256, 256, 14, 2, 128, True, None, None),
    (1, 256, 256, 7, 1, 128, True, None, None),
    (32, 128, 128, 6, 6, 64, False, None, None),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=[str(c) for c in GPU_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_matches_ref_on_card(cuda, case, dtype):
    b, s, t, h, kv, d, causal, window, cap = case
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g, device=cuda, dtype=dtype)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=cap)
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 64, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               q, q)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa_ops.flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(ValueError, match="dtype"):
        h = q.half()
        fa_ops.flash_attention(h, h, h)


@pytest.mark.gpu
def test_engine_classify_runs_the_kernel_in_every_layer(cuda):
    cfg = configs.smoke("distilbert-imdb")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (4, 48),
                           generator=torch.Generator().manual_seed(1))
    kernel = Engine(model, RunConfig(attn_impl="pallas"), device=cuda)
    plain = Engine(model, RunConfig(attn_impl="xla"), device=cuda)
    before = fa_ops.launches
    got = kernel.classify_logits(params, tokens.numpy())
    assert fa_ops.launches == before + cfg.n_layers
    want = plain.classify_logits(params, tokens.numpy())
    assert abs(got - want).max() <= 0.05


# decode attention: (b, h, kv, d, t, lengths, window, cap); lengths hold 0,
# T - 1 and lengths past T; every row sees at least one position
DECODE_CASES = [
    (4, 28, 4, 128, 256, (0, 255, 256, 1000), None, None),  # qwen2 GQA 7
    (3, 8, 8, 64, 300, (10, 299, 150), 128, 30.0),          # MHA, both
    (2, 4, 2, 32, 40, (17, 39), None, None),                # tiny T < 64
    (2, 16, 4, 16, 130, (129, 64), 64, None),               # window
    # tensor-parallel local heads and one data shard's rows of qwen2-7b
    (8, 14, 2, 128, 512, (64, 272, 100, 511, 0, 130, 200, 90), None, None),
    (8, 7, 1, 128, 512, (64, 272, 100, 511, 0, 130, 200, 90), None, None),
    (4, 28, 4, 128, 512, (64, 272, 100, 511), None, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[str(c[:5]) for c in DECODE_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_decode_kernel_matches_ref_on_card(cuda, case, dtype):
    b, h, kv, d, t, lengths, window, cap = case
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(b, h, d, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(b, t, kv, d, generator=g, device=cuda, dtype=dtype)
            for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = da_ops.launches
    got = da_ops.decode_attention(q, k, v, lens, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    want = decode_attention_ref(q, k, v, lens, window=window, softcap=cap)
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


SAMPLE_CASES = [dict(temperature=0.8), dict(temperature=0.8, top_k=50),
                dict(temperature=1.0, top_k=3), dict(temperature=0.7,
                                                      top_p=0.9),
                dict(temperature=0.8, top_k=50, top_p=0.95),
                dict(temperature=1.0, top_p=0.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("kw", SAMPLE_CASES,
                         ids=[str(sorted(k.items())) for k in SAMPLE_CASES])
def test_sampling_kernel_matches_ref_on_card(cuda, kw):
    """Tokens equal the plain epilogue's on the same noise and cutoff: the
    kernel's top-p margin (fused_sampling.cu) absorbs its own reduction
    order, and random fp32 logits put no other token that close to the
    cutoff."""
    g = torch.Generator(device=cuda).manual_seed(4)
    logits = torch.randn(4, 5000, generator=g, device=cuda) * 3
    logits[0, 100:103] = logits[0].max() + 1  # ties at the top
    top_k, top_p = kw.get("top_k"), kw.get("top_p")
    z = fs.apply_filters(logits, temperature=kw["temperature"], top_k=top_k)
    cutoff = (fs.nucleus_cutoff(z, top_p) if top_p is not None
              else torch.zeros(4, 1, device=cuda))
    for _ in range(3):
        noise = fs.gumbel_noise(logits.shape, g, cuda)
        before = fs.launches
        got = fs.fused_sample_kernel(logits, noise, cutoff,
                                     temperature=kw["temperature"],
                                     top_k=top_k,
                                     use_top_p=top_p is not None)
        torch.cuda.synchronize()
        assert fs.launches == before + 1 and got.dtype == torch.int32
        want = fs.fused_sample_ref(logits, noise, cutoff,
                                   temperature=kw["temperature"],
                                   top_k=top_k, use_top_p=top_p is not None)
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("factor,kernel_tok,plain_tok",
                         [(1 + fs.TOP_P_SLACK / 4, 5, 0),
                          (1 + 4 * fs.TOP_P_SLACK, 0, 0)],
                         ids=["inside_margin", "outside_margin"])
def test_sampling_kernel_top_p_margin_on_card(cuda, factor, kernel_tok,
                                              plain_tok):
    """The kernel's one deliberate difference from the plain epilogue and
    the reference kernel: token 5, given the largest noise and p = cutoff /
    ``factor``, stays when p is below the cutoff by less than TOP_P_SLACK
    (relative), where the plain version drops it; below by more, both drop
    it."""
    logits = torch.linspace(2.0, -2.0, 16, device=cuda)[None]
    p = torch.softmax(logits.double(), dim=-1)
    cutoff = (p[:, 5:6] * factor).float()
    gumbel = torch.zeros_like(logits)
    gumbel[0, 5] = 10.0
    got = fs.fused_sample_kernel(logits, gumbel, cutoff, temperature=1.0,
                                 use_top_p=True)
    want = fs.fused_sample_ref(logits, gumbel, cutoff, temperature=1.0,
                               use_top_p=True)
    assert got.tolist() == [kernel_tok] and want.tolist() == [plain_tok]


# The sampling kernel's cluster split at the serving path's vocabulary and
# on its edges: (name, B, V, settings, n_split (None: the wrapper's pick),
# input pattern). Patterns: "randn" (N(0, 9) logits), "ties" (about 100
# tokens tie at the 50th value, on both sides of every 5-, 7-, 8- and
# 16-way slice boundary), "argmax_tie" (y ties exactly in two slices: zero noise),
# "zeros" (-0.0 and +0.0 in several slices are the k-th value).
PATH_KW = dict(temperature=0.8, top_k=50, top_p=0.95)
SPLIT_SAMPLE_CASES = [
    ("path", 8, 152064, PATH_KW, None, "randn"),
    ("path_n7", 8, 152064, PATH_KW, 7, "randn"),     # V % 7 != 0
    ("path_n1", 8, 152064, PATH_KW, 1, "randn"),     # stages nothing
    ("path_n5", 8, 152064, PATH_KW, 5, "randn"),     # stages the logits
    ("admission_b1", 1, 152064, PATH_KW, None, "randn"),
    ("vocab_30522", 8, 30522, PATH_KW, None, "randn"),
    ("vocab_5000", 4, 5000, PATH_KW, None, "randn"),
    ("vocab_256000", 8, 256000, PATH_KW, None, "randn"),
    ("device_memory", 2, 1_000_000, PATH_KW, None, "randn"),
    ("top_k_1", 8, 152064, dict(temperature=0.8, top_k=1), None, "randn"),
    ("top_k_v", 2, 152064, dict(temperature=0.8, top_k=152064), None,
     "randn"),
    # the k-th value deep in the row
    ("top_k_quarter", 2, 152064, dict(temperature=0.8, top_k=38016), None,
     "randn"),
    ("ties_across_slices", 4, 152064, dict(temperature=1.0, top_k=50), None,
     "ties"),
    ("argmax_tie_across_slices", 4, 152064, dict(temperature=0.9, top_k=3),
     None, "argmax_tie"),
    ("signed_zeros", 4, 152064, dict(temperature=0.8, top_k=4), None,
     "zeros"),
    ("top_p_zero", 4, 152064, dict(temperature=1.0, top_p=0.0), None,
     "randn"),
    ("top_p_negative", 4, 152064, dict(temperature=1.0, top_k=50,
                                       top_p=-0.5), None, "randn"),
]


def _split_sample_inputs(cuda, b, v, kw, pattern, g):
    """Logits and noise for a SPLIT_SAMPLE_CASES pattern, the cutoff as
    ``fused_sample`` makes it, and the tokens each row may take (None:
    any)."""
    logits = torch.randn(b, v, generator=g, device=cuda) * 3
    noise = fs.gumbel_noise((b, v), g, cuda)
    allowed = None
    if pattern == "ties":
        bounds = sorted({i * -(-v // n) + d for n in (5, 7, 8, 16)
                         for i in range(1, n) for d in (-2, -1, 0, 1)})
        logits -= 20
        logits[:, [11, 70001, v - 3, 40000, 123456]] = 30.0
        logits[:, bounds] = 25.0
        allowed = set(bounds) | {11, 70001, v - 3, 40000, 123456}
    elif pattern == "argmax_tie":
        per = -(-v // 8)
        logits.zero_()
        logits[:, [per + 3, 6 * per + 1]] = 7.0
        noise.zero_()
        allowed = {per + 3}
    elif pattern == "zeros":
        logits.fill_(-1.0)
        logits[:, [17, 90000, 150000]] = 2.0
        zeros = [5, 9505, 19009, 76033, 152063]
        for i, x in zip(zeros, (-0.0, 0.0, -0.0, 0.0, -0.0)):
            logits[:, i] = x
        allowed = set(zeros) | {17, 90000, 150000}
    top_k, top_p = kw.get("top_k"), kw.get("top_p")
    use_top_p = top_p is not None and top_p < 1.0
    cutoff = (fs.nucleus_cutoff(fs.apply_filters(
        logits, temperature=kw["temperature"], top_k=top_k), top_p)
        if use_top_p else torch.zeros(b, 1, device=cuda))
    return dict(logits=logits, gumbel=noise, cutoff=cutoff,
                temperature=kw["temperature"], top_k=top_k,
                use_top_p=use_top_p), allowed


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPLIT_SAMPLE_CASES,
                         ids=[c[0] for c in SPLIT_SAMPLE_CASES])
def test_sampling_kernel_split_matches_ref_on_card(cuda, case):
    """Tokens equal the plain epilogue's on the same inputs at every
    cluster size and staging mode the wrapper or the case picks; with
    top-p a row may differ only at a near-tie (a token's p within twice
    the kernel's margin of the cutoff)."""
    name, b, v, kw, n_split, pattern = case
    g = torch.Generator(device=cuda).manual_seed(len(name))
    for _ in range(2):
        inputs, allowed = _split_sample_inputs(cuda, b, v, kw, pattern, g)
        before = fs.launches
        got = fs.fused_sample_kernel(**inputs, n_split=n_split)
        torch.cuda.synchronize()
        assert fs.launches == before + 1
        want = fs.fused_sample_ref(**inputs)
        if allowed is not None:
            assert set(want.tolist()) <= allowed
        if not inputs["use_top_p"]:
            assert torch.equal(got, want)
            continue
        p = torch.softmax(fs.apply_filters(
            inputs["logits"], temperature=kw["temperature"],
            top_k=kw.get("top_k")), dim=-1)
        for r in torch.nonzero(got != want).flatten().tolist():
            c = float(inputs["cutoff"][r, 0])
            gap = min(abs(float(p[r, int(x[r])]) - c) for x in (got, want))
            assert gap <= 2 * fs.TOP_P_SLACK * c, (name, r, gap / c)


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", range(1, 9))
def test_sampling_kernel_every_cluster_size_on_card(cuda, n_split):
    """Every cluster size the kernel takes draws the plain epilogue's
    tokens, on a vocabulary that no size above 1 divides."""
    g = torch.Generator(device=cuda).manual_seed(n_split)
    inputs, _ = _split_sample_inputs(cuda, 4, 30011, dict(
        temperature=0.7, top_k=20), "randn", g)
    got = fs.fused_sample_kernel(**inputs, n_split=n_split)
    assert torch.equal(got, fs.fused_sample_ref(**inputs))


@pytest.mark.gpu
def test_engine_decode_runs_the_kernels_on_card(cuda):
    cfg = configs.smoke("qwen2-7b")
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    kernel = Engine(model, RunConfig(attn_impl="pallas"), device=cuda)
    plain = Engine(model, RunConfig(attn_impl="xla"), device=cuda)
    caches = []
    for eng in (kernel, plain):
        cache = eng.new_cache(3, 80)
        for row, n in ((0, 5), (2, 70)):
            tokens = torch.arange(n, device=cuda)[None] % cfg.vocab_size
            _, cache = eng.prefill_into(params, cache, row, tokens)
        caches.append(cache)
    token = torch.tensor([[1], [2], [3]], device=cuda)
    before = (fa_ops.launches, da_ops.launches, fs.launches)
    got, _ = kernel.decode(params, caches[0], token)
    toks, _ = kernel.decode_sample(params, caches[0], token,
                                   torch.Generator(device=cuda),
                                   temperature=0.8, top_k=5)
    torch.cuda.synchronize()
    assert (fa_ops.launches, da_ops.launches, fs.launches) == (
        before[0], before[1] + 2 * cfg.n_layers, before[2] + 1)
    want, _ = plain.decode(params, caches[1], token)
    assert toks.shape == (3,) and toks.dtype == torch.int32
    assert (got - want).abs().max().item() <= 0.05


# int8, paged and paged-int8 decode attention: (b, h, kv, d, logical
# positions, page size, lengths, window, cap); pools are shuffled, rows 0
# and 1 share their first pages and the last row is free (all-zero table)
VARIANT_CASES = [
    (4, 28, 4, 128, 256, 16, (0, 255, 256, 1000), None, None),  # qwen2
    (3, 8, 8, 64, 192, 8, (10, 191, 150), 128, 30.0),          # MHA, both
    (3, 16, 4, 16, 144, 24, (143, 64, 7), 64, None),           # ps 24
    (2, 4, 2, 32, 64, 64, (17, 63), None, None),               # one page
]


def _variant_inputs(cuda, case, variant, dtype, seed=5):
    b, h, kv, d, n_pos, ps, lengths = case[:7]
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = {"q": torch.randn(b, h, d, generator=g, device=cuda, dtype=dtype),
         "lengths": torch.tensor(lengths, dtype=torch.int32, device=cuda)}
    if variant == "quant":
        shape = (b, n_pos, kv, d)
    else:
        pmax = n_pos // ps
        shape = (1 + b * pmax, ps, kv, d)
        table = (torch.randperm(b * pmax, generator=g, device=cuda) + 1
                 ).reshape(b, pmax).to(torch.int32)
        table[1, :pmax // 2] = table[0, :pmax // 2]
        table[-1] = 0
        x["page_table"] = table
    data = [torch.randn(shape, generator=g, device=cuda) for _ in range(2)]
    if variant == "paged":
        x["k"], x["v"] = (t.to(dtype) for t in data)
    else:
        (x["k"], x["k_scale"]), (x["v"], x["v_scale"]) = (
            quantize_kv(t) for t in data)
    return x


def _variant_call(x, variant, plain=False, **kw):
    if variant == "quant":
        if plain:
            return decode_attention_quant_ref(
                x["q"], x["k"], x["v"], x["k_scale"], x["v_scale"],
                x["lengths"], **kw)
        return da_ops.decode_attention(x["q"], x["k"], x["v"], x["lengths"],
                                       k_scale=x["k_scale"],
                                       v_scale=x["v_scale"], **kw)
    scales = ({} if variant == "paged" else
              dict(k_scale=x["k_scale"], v_scale=x["v_scale"]))
    if plain:
        fn = (paged_decode_attention_ref if variant == "paged" else
              paged_decode_attention_quant_ref)
        args = ((x["q"], x["k"], x["v"]) if variant == "paged" else
                (x["q"], x["k"], x["v"], x["k_scale"], x["v_scale"]))
        return fn(*args, x["lengths"], x["page_table"], **kw)
    return da_ops.paged_decode_attention(x["q"], x["k"], x["v"],
                                         x["lengths"], x["page_table"],
                                         **scales, **kw)


COUNTERS = {"quant": "quant_launches", "paged": "paged_launches",
            "paged_quant": "paged_quant_launches"}


@pytest.mark.gpu
@pytest.mark.parametrize("case", VARIANT_CASES,
                         ids=[str(c[:6]) for c in VARIANT_CASES])
@pytest.mark.parametrize("variant", ["quant", "paged", "paged_quant"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_variant_kernels_match_ref_on_card(cuda, case, variant, dtype):
    window, cap = case[7:]
    x = _variant_inputs(cuda, case, variant, dtype)
    counter = COUNTERS[variant]
    before = getattr(da_ops, counter)
    got = _variant_call(x, variant, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert getattr(da_ops, counter) == before + 1
    want = _variant_call(x, variant, plain=True, window=window, softcap=cap)
    assert got.shape == x["q"].shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
def test_variant_wrappers_reject_what_they_cannot_take(cuda):
    x = _variant_inputs(cuda, VARIANT_CASES[0], "paged_quant",
                        torch.bfloat16)
    buf = torch.zeros(x["k"].numel() + 1, dtype=torch.int8, device=cuda)
    misaligned = buf[1:].view(x["k"].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da_ops.paged_decode_attention(
            x["q"], misaligned, x["v"], x["lengths"], x["page_table"],
            k_scale=x["k_scale"], v_scale=x["v_scale"])
    with pytest.raises(ValueError, match="want torch.bfloat16"):
        da_ops.paged_decode_attention(x["q"], x["k"], x["v"], x["lengths"],
                                      x["page_table"])
    with pytest.raises(ValueError, match="int32"):
        da_ops.paged_decode_attention(
            x["q"], x["k"], x["v"], x["lengths"], x["page_table"].long(),
            k_scale=x["k_scale"], v_scale=x["v_scale"])
    with pytest.raises(ValueError, match="one CUDA device"):
        da_ops.paged_decode_attention(
            x["q"], x["k"], x["v"], x["lengths"], x["page_table"],
            k_scale=x["k_scale"].cpu(), v_scale=x["v_scale"].cpu())
    with pytest.raises(ValueError, match="dtype"):
        da_ops.paged_decode_attention(
            x["q"].half(), x["k"], x["v"], x["lengths"], x["page_table"],
            k_scale=x["k_scale"], v_scale=x["v_scale"])
    q = _variant_inputs(cuda, VARIANT_CASES[0], "quant", torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        da_ops.decode_attention(q["q"], q["k"].transpose(1, 2).contiguous(
            ).transpose(1, 2), q["v"], q["lengths"], k_scale=q["k_scale"],
            v_scale=q["v_scale"])


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_paged_and_int8_decode_run_the_kernels_on_card(cuda,
                                                              kv_dtype):
    """Engine.decode and decode_sample on a dense and a paged cache of
    ``kv_dtype``: every layer through the matching kernel, logits within
    0.05 of the plain path's on the same caches."""
    cfg = configs.smoke("qwen2-7b")
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    kernel = Engine(model, RunConfig(attn_impl="pallas", kv_dtype=kv_dtype),
                    device=cuda)
    plain = Engine(model, RunConfig(attn_impl="xla", kv_dtype=kv_dtype),
                   device=cuda)
    token = torch.tensor([[1], [2], [3]], device=cuda)
    for paged in (False, True):
        caches = []
        for eng in (kernel, plain):
            if paged:
                cache = eng.new_paged_cache(3, 1 + 3 * 10, 8, 10)
                for row, n in ((0, 5), (2, 70)):
                    pages = list(range(1 + row * 10, 11 + row * 10))
                    eng.assign_row_pages(cache, row, pages)
                    eng.extend_row(params, cache, row, torch.arange(
                        n, device=cuda)[None] % cfg.vocab_size)
            else:
                cache = eng.new_cache(3, 80)
                for row, n in ((0, 5), (2, 70)):
                    eng.prefill_into(params, cache, row, torch.arange(
                        n, device=cuda)[None] % cfg.vocab_size)
            caches.append(cache)
        name = {(False, "bf16"): "launches", (False, "int8"):
                "quant_launches", (True, "bf16"): "paged_launches",
                (True, "int8"): "paged_quant_launches"}[paged, kv_dtype]
        before = (getattr(da_ops, name), fs.launches)
        got, _ = kernel.decode(params, caches[0], token)
        toks, _ = kernel.decode_sample(params, caches[0], token,
                                       torch.Generator(device=cuda),
                                       temperature=0.8, top_k=5)
        torch.cuda.synchronize()
        assert (getattr(da_ops, name), fs.launches) == (
            before[0] + 2 * cfg.n_layers, before[1] + 1)
        want, _ = plain.decode(params, caches[1], token)
        assert toks.shape == (3,) and toks.dtype == torch.int32
        assert (got - want).abs().max().item() <= 0.05


# partials decode attention over sequence shards: (b, h, kv, d, t,
# lengths, window, cap), each cache cut into M = 1, 2 and 4 shards (the
# chip smoke's (a4) edge cases at a smaller T): lengths 0, Sl - 1, Sl,
# T - 1 and past T; rows a shard sees nothing of; a window crossing shard
# boundaries; softcap; MHA; GQA 7
PARTIALS_CASES = [
    (8, 28, 4, 128, 256, (0, 63, 64, 127, 128, 255, 256, 900), None, None),
    (4, 28, 4, 128, 256, (40, 100, 150, 255), 48, None),
    (4, 28, 4, 128, 256, (10, 130, 255, 400), None, 30.0),
    (4, 12, 12, 64, 128, (0, 127, 70, 17), None, None),
    (1, 28, 4, 128, 256, (200,), 100, 20.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PARTIALS_CASES,
                         ids=[str(c) for c in PARTIALS_CASES])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_partials_kernel_matches_ref_on_card(cuda, case, shards, dtype):
    """Every shard's (num, den, m) against the plain version (fp32 on both
    sides: 1e-4 of the largest value); a shard a row sees nothing of gives
    exactly (0, 0, -1e30); the merged shards equal the dense decode kernel
    on the whole cache."""
    b, h, kv, d, t, lengths, window, cap = case
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(b, h, d, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(b, t, kv, d, generator=g, device=cuda, dtype=dtype)
            for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    sl = t // shards
    parts = []
    for r in range(shards):
        kb, vb = (x[:, r * sl:(r + 1) * sl].contiguous() for x in (k, v))
        before = da_ops.partials_launches
        got = da_ops.decode_attention_partials(q, kb, vb, lens,
                                               offset=r * sl, window=window,
                                               softcap=cap)
        torch.cuda.synchronize()
        assert da_ops.partials_launches == before + 1
        want = decode_attention_partials_ref(q, kb, vb, lens, offset=r * sl,
                                             window=window, softcap=cap)
        for x, y in zip(got, want):
            assert x.dtype == torch.float32 and x.shape == y.shape
            assert (x - y).abs().max().item() <= 1e-4 * max(
                1.0, y.abs().max().item())
        local = lens.long() - r * sl
        lo = (torch.zeros_like(local) if window is None
              else torch.clamp(local - window + 1, min=0))
        for row in torch.nonzero(torch.clamp(local, max=sl - 1) < lo
                                 ).flatten().tolist():
            assert not got[0][row].any() and not got[1][row].any()
            assert (got[2][row] == -1e30).all()
        parts.append(got)
    m_g = torch.stack([m for _, _, m in parts]).amax(0)
    num = sum(n * torch.exp(m - m_g)[..., None] for n, _, m in parts)
    den = sum(dn * torch.exp(m - m_g) for _, dn, m in parts)
    merged = (num / torch.clamp(den, min=1e-30)[..., None]).reshape(
        q.shape).to(dtype)
    dense = da_ops.decode_attention(q, k, v, lens, window=window,
                                    softcap=cap)
    torch.testing.assert_close(merged.float(), dense.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_seq_shard_engine_decode_matches_dense_kernel_on_card(cuda):
    """A one-rank ``Engine(mesh, seq_shard=True)`` decode round over the
    dense kernel engine's own cache: the partials kernel in every layer,
    no other attention kernel, the sampling kernel once for the sampled
    round, and the dense kernel's logits (at one shard the partials loop
    is the dense kernel's)."""
    from repro_torch.launch.mesh import make_host_mesh
    cfg = configs.smoke("qwen2-7b")
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    dense = Engine(model, RunConfig(attn_impl="pallas"), device=cuda)
    seq = Engine(model, RunConfig(), device=cuda,
                 mesh=make_host_mesh((1, 1)), seq_shard=True)
    cache = dense.new_cache(3, 80)
    for row, n in ((0, 5), (2, 70)):
        tokens = torch.arange(n, device=cuda)[None] % cfg.vocab_size
        _, cache = dense.prefill_into(params, cache, row, tokens)
    copy = seq.new_cache(3, 80)
    for big, small in zip(copy.layers, cache.layers):
        for name in big:
            big[name].copy_(small[name])
    copy.lengths.copy_(cache.lengths)
    token = torch.tensor([[1], [2], [3]], device=cuda)
    before = (fa_ops.launches, da_ops.launches, da_ops.partials_launches,
              fs.launches)
    got, _ = seq.decode(params, copy, token)
    toks, _ = seq.decode_sample(params, copy, token,
                                torch.Generator(device=cuda),
                                temperature=0.8, top_k=5)
    torch.cuda.synchronize()
    assert (fa_ops.launches, da_ops.launches, da_ops.partials_launches,
            fs.launches) == (before[0], before[1],
                             before[2] + 2 * cfg.n_layers, before[3] + 1)
    want, _ = dense.decode(params, cache, token)
    assert toks.shape == (3,) and toks.dtype == torch.int32
    assert (got - want).abs().max().item() <= 0.05


# flash attention on the tensor-core body (bf16): the timed shapes cut in
# batch (distilbert at B 6 runs 128-row tiles, qwen2's prefill 64-row
# ones), S and T that are no multiple of a tile, a window and a softcap;
# every row sees at least one key (a row with none: the kernel writes 0,
# the plain version averages v): (b, s, t, h, kv, d, causal, window, cap)
WGMMA_CASES = [
    (6, 512, 512, 12, 12, 64, False, None, None),   # distilbert, bidir
    (1, 512, 512, 28, 4, 128, True, None, None),    # qwen2 prefill, GQA 7
    (2, 300, 445, 8, 2, 64, False, None, None),     # ragged S and T
    (1, 200, 333, 28, 4, 128, True, None, None),    # ragged, causal
    (6, 512, 512, 12, 4, 64, True, 100, 30.0),      # window and softcap
    (2, 333, 333, 4, 2, 32, True, 50, 20.0),        # D 32
    (2, 130, 70, 4, 1, 16, False, 80, None),        # D 16, S > T
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=[str(c) for c in WGMMA_CASES])
def test_wgmma_flash_kernel_matches_ref_on_card(cuda, case):
    b, s, t, h, kv, d, causal, window, cap = case
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(shape, generator=g, device=cuda,
                           dtype=torch.bfloat16)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=cap)
    assert got.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.gpu
def test_decode_kernel_splits_the_serving_shape_on_card(cuda):
    """At the serving path's shape (8 rows, 4 kv heads, T 1024) the
    wrapper runs a cluster of more than one block per (row, kv head), and
    the result still matches the plain version."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(8, 28, 128, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(8, 1024, 4, 128, generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor([500, 390, 326, 202, 221, 85, 102, 72],
                        dtype=torch.int32, device=cuda)
    assert da_ops._n_split(q, 8 * 4, 1024, None) > 1
    got = da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


# chunks of a cluster left empty: lengths 0 and 1 among longer rows, a
# window ending inside one chunk, T 4096 with one row near T - 1 and the
# others short: (b, h, kv, d, positions, page size, lengths, window)
EMPTY_CHUNK_CASES = [
    (4, 28, 4, 128, 1024, 16, (0, 1, 2, 700), None),
    (4, 28, 4, 128, 1024, 16, (300, 900, 1023, 64), 70),
    (4, 28, 4, 128, 4096, 16, (4095, 3, 10, 100), None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", EMPTY_CHUNK_CASES,
                         ids=[str(c[4:]) for c in EMPTY_CHUNK_CASES])
@pytest.mark.parametrize("entry", ["dense", "quant", "paged", "paged_quant",
                                   "partials"])
def test_decode_entries_with_empty_chunks_on_card(cuda, case, entry):
    b, h, kv, d, n_pos, ps, lengths, window = case
    assert da_ops._n_split(torch.empty(0, device=cuda), b * kv, n_pos,
                           window) > 1
    if entry in ("quant", "paged", "paged_quant"):
        x = _variant_inputs(cuda, case[:7], entry, torch.bfloat16, seed=8)
        got = _variant_call(x, entry, window=window)
        torch.cuda.synchronize()
        want = _variant_call(x, entry, plain=True, window=window)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[torch.bfloat16],
                                   rtol=TOL[torch.bfloat16])
        return
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(b, h, d, generator=g, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn(b, n_pos, kv, d, generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if entry == "dense":
        got = da_ops.decode_attention(q, k, v, lens, window=window)
        torch.cuda.synchronize()
        want = decode_attention_ref(q, k, v, lens, window=window)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[torch.bfloat16],
                                   rtol=TOL[torch.bfloat16])
        return
    got = da_ops.decode_attention_partials(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    want = decode_attention_partials_ref(q, k, v, lens, window=window)
    for x, y in zip(got, want):
        assert (x - y).abs().max().item() <= 1e-4 * max(
            1.0, y.abs().max().item())


# The batch DAG's determinism on the card: qwen2-7b's widths at two layers,
# the DAG's replica shape (4 slots, 64-token prompts + 8 new, cache_pad 8)


def _dag_engine(cuda):
    import dataclasses

    from repro_torch.batch import make_dataset
    from repro_torch.launch import serve
    cfg = dataclasses.replace(configs.get("qwen2-7b"), n_layers=2)
    engine, params = serve.lm_engine(cfg, device=cuda, cache_pad=8)
    data = make_dataset(8, prompt_len=64, vocab=cfg.vocab_size,
                        max_new_tokens=8, seed=0)
    return cfg, engine, params, data


@pytest.mark.gpu
def test_dag_prefill_stage_equals_admission_first_tokens_on_card(cuda):
    """The DAG's prefill stage (``Engine.prefill``, B = 1, capacity S +
    cache_pad) and the batcher's admission (``Engine.prefill_into`` into
    a 4-slot cache of that capacity, or of a larger one) give bit-equal
    logits, all through the flash kernel: the capacity only pads the
    cache."""
    cfg, engine, params, data = _dag_engine(cuda)
    cache, wide = engine.new_cache(4, 72), engine.new_cache(4, 136)
    for i in range(data.n_items):
        prompt = data.tokens[i][None]
        before = fa_ops.launches
        a, _ = engine.prefill(params, prompt)
        b, cache = engine.prefill_into(params, cache, i % 4, prompt)
        c, wide = engine.prefill_into(params, wide, i % 4, prompt)
        torch.cuda.synchronize()
        assert fa_ops.launches == before + 3 * cfg.n_layers
        assert torch.equal(a, b) and torch.equal(a, c), i


@pytest.mark.gpu
def test_decode_row_does_not_depend_on_other_slots_on_card(cuda):
    """A decode round's row output is the same bit for bit whatever the
    other slots hold (free, or other prompts at other depths) and
    whichever slot the row sits in: the determinism the DAG's one digest
    across placements, kills and pools rests on."""
    cfg, engine, params, data = _dag_engine(cuda)
    tok = torch.tensor([[5], [6], [7], [8]], device=cuda)

    def decode(rows, token=tok):
        """rows: slot -> (item, prompt length); returns the logits."""
        cache = engine.new_cache(4, 72)
        for slot, (item, n) in rows.items():
            engine.prefill_into(params, cache, slot,
                                data.tokens[item][None, :n])
        before = da_ops.launches
        logits, _ = engine.decode(params, cache, token)
        torch.cuda.synchronize()
        assert da_ops.launches == before + cfg.n_layers
        return logits

    alone = decode({2: (0, 64)})
    crowded = decode({0: (1, 40), 1: (2, 64), 2: (0, 64), 3: (3, 10)})
    assert torch.equal(alone[2], crowded[2])
    # the same row in slot 3, fed slot 2's token
    moved_tok = tok.clone()
    moved_tok[3] = tok[2]
    moved = decode({0: (3, 64), 1: (1, 20), 3: (0, 64)}, moved_tok)
    assert torch.equal(alone[2], moved[3])


# Cases with a softcap: randn q and k give scores of std 1, which a cap
# of 30 or 50 barely moves, so there q is scaled by SHARP_Q (a power of
# two: exact in bf16) to put the scores at std 32, past the cap. The
# kernel is held by relative RMS over all rows and over the rows a window
# 64 positions off would cut, and the same kernel called with each
# planted fault (the softcap or the window dropped, the window 64
# positions short or long) must break the bf16 bound.
SHARP_Q = 32.0
SHARP_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _hold(got, want, dtype, rows, sharp):
    if not sharp:
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        return
    err = max(_rel_rms(got.float(), want.float()),
              _rel_rms(got[rows].float(), want[rows].float()))
    assert err <= SHARP_RTOL[dtype], err


def _faults_caught(call, want, rows, window, cap):
    """``call(window, softcap)`` runs the kernel; each planted fault must
    land farther than the bf16 bound from ``want``."""
    faults = [(window, None)]
    if window is not None:
        faults += [(None, cap), (window + 64, cap)]
        faults += [(window - 64, cap)] if window > 64 else []
    for w, c in faults:
        out = call(w, c).float()
        err = max(_rel_rms(out, want.float()),
                  _rel_rms(out[rows], want[rows].float()))
        assert err > SHARP_RTOL[torch.bfloat16], (w, c, err)


# The remaining model families' shapes: nemotron-4-340b's head_dim 192
# (GQA 12), gemma2-27b's window 4096 with softcap 50 (GQA 2, D 128),
# whisper-base's cross-attention of one decoder row over its 1 500
# encoder frames (bidirectional, T no multiple of the 64-key tile):
# (b, s, t, h, kv, d, causal, window, cap)
FAMILY_FLASH_CASES = [
    (1, 300, 300, 24, 2, 192, True, None, None),     # nemotron, GQA 12
    (2, 100, 170, 4, 4, 192, False, 64, 30.0),       # D 192, window + cap
    (1, 4608, 4608, 4, 2, 128, True, 4096, 50.0),    # gemma2 local layer
    (1, 1, 1500, 8, 8, 64, False, None, None),       # whisper cross, S 1
    (4, 1, 1500, 8, 8, 64, False, None, None),
    # whisper-base on a "model" axis of 2: 4 heads a rank, the encoder's
    # bidirectional self-attention over 1 500 frames and the decoder's
    # cross-attention of one row over them
    (4, 1500, 1500, 4, 4, 64, False, None, None),
    (4, 1, 1500, 4, 4, 64, False, None, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FAMILY_FLASH_CASES,
                         ids=[str(c) for c in FAMILY_FLASH_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_family_flash_shapes_on_card(cuda, case, dtype):
    """Both bodies (fp32 on the CUDA cores, bf16 on wgmma) at the new
    families' shapes against the plain version; with a softcap, at scores
    past it, and blind to no planted fault."""
    b, s, t, h, kv, d, causal, window, cap = case
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(shape, generator=g, device=cuda, dtype=dtype)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    sharp = cap is not None
    if sharp:
        q = q * SHARP_Q
    rows = (slice(None), slice(max((window or 64) - 64, 0), None))
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=cap)
    assert got.shape == q.shape and got.dtype == q.dtype
    _hold(got, want, dtype, rows, sharp)
    if sharp:
        _faults_caught(lambda w, c: fa_ops.flash_attention(
            q, k, v, causal=causal, window=w, softcap=c), want, rows,
            window, cap)


# decode at D 192 (nemotron, GQA 12) and gemma2's local layers (window
# 4096 and softcap 50 over a 5 120-position cache, rows inside and past
# the window): (b, h, kv, d, t, lengths, window, cap)
FAMILY_DECODE_CASES = [
    (4, 96, 8, 192, 512, (0, 511, 512, 300), None, None),
    (3, 24, 2, 192, 300, (10, 299, 150), 64, 30.0),
    (4, 32, 16, 128, 5120, (4000, 4096, 5119, 300), 4096, 50.0),
    # whisper-base's decoder self-attention at 4 heads a rank (D 64), and
    # a qwen2-7b replica on a (1, 2) slice: 14 q over 2 kv heads a rank
    (4, 4, 4, 64, 32, (0, 9, 31, 16), None, None),
    (4, 14, 2, 128, 512, (63, 200, 511, 0), None, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FAMILY_DECODE_CASES,
                         ids=[str(c[:5]) for c in FAMILY_DECODE_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_family_decode_shapes_on_card(cuda, case, dtype):
    """The dense entry at the new shapes, and the int8, paged and partials
    entries (one template) at D 192, against their plain versions; with a
    softcap, at scores past it, the dense entry blind to no planted
    fault."""
    b, h, kv, d, t, lengths, window, cap = case
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(b, h, d, generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn(b, t, kv, d, generator=g, device=cuda, dtype=dtype)
            for _ in range(2))
    sharp = cap is not None
    if sharp:
        q = q * SHARP_Q
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    rows = lens >= (window or 64) - 64
    before = da_ops.launches
    got = da_ops.decode_attention(q, k, v, lens, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    want = decode_attention_ref(q, k, v, lens, window=window, softcap=cap)
    _hold(got, want, dtype, rows, sharp)
    if sharp:
        _faults_caught(lambda w, c: da_ops.decode_attention(
            q, k, v, lens, window=w, softcap=c), want, rows, window, cap)
    if d != 192:
        return
    kq, ks = quantize_kv(k.float())
    vq, vs = quantize_kv(v.float())
    got = da_ops.decode_attention(q, kq, vq, lens, k_scale=ks, v_scale=vs,
                                  window=window, softcap=cap)
    want = decode_attention_quant_ref(q, kq, vq, ks, vs, lens,
                                      window=window, softcap=cap)
    _hold(got, want, dtype, rows, sharp)
    ps = 16
    pmax = t // ps if t % ps == 0 else t // ps + 1
    pool_k = torch.zeros(1 + b * pmax, ps, kv, d, device=cuda, dtype=dtype)
    pool_v = torch.zeros_like(pool_k)
    table = (torch.randperm(b * pmax, generator=g, device=cuda) + 1
             ).reshape(b, pmax).to(torch.int32)
    for row in range(b):
        for i in range(pmax):
            n = min(ps, t - i * ps)
            pool_k[table[row, i], :n] = k[row, i * ps:i * ps + n]
            pool_v[table[row, i], :n] = v[row, i * ps:i * ps + n]
    got = da_ops.paged_decode_attention(q, pool_k, pool_v, lens, table,
                                        window=window, softcap=cap)
    want = paged_decode_attention_ref(q, pool_k, pool_v, lens, table,
                                      window=window, softcap=cap)
    _hold(got, want, dtype, rows, sharp)
    got = da_ops.decode_attention_partials(q, k, v, lens, offset=0,
                                           window=window, softcap=cap)
    want = decode_attention_partials_ref(q, k, v, lens, offset=0,
                                         window=window, softcap=cap)
    for x, y in zip(got, want):
        assert (x - y).abs().max().item() <= 1e-4 * max(
            1.0, y.abs().max().item())


@pytest.mark.gpu
def test_sampling_kernel_logits_staging_at_vocab_256000_on_card(cuda):
    """gemma2's, command-r's and nemotron's vocabulary: at B = 4 the
    kernel stages only the logits of its slice ("logits" staging), as on
    gemma2's serving path; with top-k the tokens equal the plain
    epilogue's on the same noise."""
    b, v = 4, 256_000
    n = fs.choose_sample_split(b, v, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert fs.staging(v, n) == "logits"
    g = torch.Generator(device=cuda).manual_seed(8)
    logits = torch.randn(b, v, generator=g, device=cuda) * 3
    noise = fs.gumbel_noise(logits.shape, g, cuda)
    cutoff = torch.zeros(b, 1, device=cuda)
    before = fs.launches
    got = fs.fused_sample_kernel(logits, noise, cutoff, temperature=0.8,
                                 top_k=50)
    torch.cuda.synchronize()
    assert fs.launches == before + 1
    want = fs.fused_sample_ref(logits, noise, cutoff, temperature=0.8,
                               top_k=50)
    torch.testing.assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_k=50),
                                dict(temperature=0.8, top_p=0.9)],
                         ids=["top_k", "top_p"])
def test_sampling_kernel_at_whisper_vocab_on_card(cuda, kw):
    """whisper-base's vocabulary (V 51 865) on the logits a "model"-split
    LM head gathers whole, 4 rows: the tokens equal the plain epilogue's
    on the same noise and cutoff."""
    b, v = 4, 51_865
    g = torch.Generator(device=cuda).manual_seed(11)
    logits = torch.randn(b, v, generator=g, device=cuda) * 3
    top_k, top_p = kw.get("top_k"), kw.get("top_p")
    z = fs.apply_filters(logits, temperature=kw["temperature"], top_k=top_k)
    cutoff = (fs.nucleus_cutoff(z, top_p) if top_p is not None
              else torch.zeros(b, 1, device=cuda))
    noise = fs.gumbel_noise(logits.shape, g, cuda)
    before = fs.launches
    got = fs.fused_sample_kernel(logits, noise, cutoff,
                                 temperature=kw["temperature"], top_k=top_k,
                                 use_top_p=top_p is not None)
    torch.cuda.synchronize()
    assert fs.launches == before + 1
    want = fs.fused_sample_ref(logits, noise, cutoff,
                               temperature=kw["temperature"], top_k=top_k,
                               use_top_p=top_p is not None)
    assert torch.equal(got, want)
