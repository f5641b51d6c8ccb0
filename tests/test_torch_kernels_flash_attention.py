"""Port's flash attention against the JAX reference.

The plain torch version (``repro_torch...ref``) and the wrapper's CPU path
are held against the JAX oracle and the JAX Pallas kernel in interpret
mode, on the same inputs made from a numpy seed. The CUDA kernel itself
runs only on a card: its tests are in test_torch_kernels_on_card.py.
Tolerances are the reference's own: 2e-5 in fp32, 2e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention import ref as jax_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# small versions of tests/test_kernels_flash_attention.py's cases:
# (b, s, t, h, kv, d, causal, window, cap)
CASES = [
    (1, 64, 64, 4, 2, 32, True, None, None),     # causal, GQA 2
    (2, 32, 64, 4, 4, 16, False, None, None),    # bidir, cross t > s
    (1, 64, 64, 4, 1, 32, True, 16, None),       # window, GQA 4
    (1, 64, 64, 2, 2, 32, True, None, 5.0),      # softcap
    (1, 50, 50, 4, 2, 32, True, None, None),     # pad path
    (1, 40, 70, 2, 2, 16, False, None, 30.0),    # pad + bidir + cap
]
IDS = [str(c) for c in CASES]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(case, dtype: str, seed=0):
    b, s, t, h, kv, d = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(torch_out, jax_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref(case, dtype):
    causal, window, cap = case[6:]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype)
    want = jax.jit(lambda q, k, v: jax_ref.flash_attention_ref(
        q, k, v, causal=causal, window=window, softcap=cap))(jq, jk, jv)
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                              softcap=cap)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_wrapper_matches_jax_interpret_kernel(case):
    causal, window, cap = case[6:]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, "float32", seed=1)
    want = jax_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                   softcap=cap, block_q=32, block_k=32,
                                   interpret=True)
    before = fa_ops.launches
    got = fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 softcap=cap)
    assert fa_ops.launches == before  # CPU tensors never launch the kernel
    _close(got, want, "float32")


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    kv3 = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa_ops.flash_attention(q, kv3, kv3)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="window"):
        fa_ops.flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError, match="softcap"):
        fa_ops.flash_attention(q, kv, kv, softcap=-1.0)
    with pytest.raises(ValueError, match="do not match"):
        fa_ops.flash_attention(q, torch.zeros(1, 8, 2, 32),
                               torch.zeros(1, 8, 2, 32))
