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
