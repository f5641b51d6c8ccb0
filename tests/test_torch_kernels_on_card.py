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
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
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
