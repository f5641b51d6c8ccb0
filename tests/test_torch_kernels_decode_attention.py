"""Port's decode attention against the JAX reference.

The plain torch version (``repro_torch...decode_attention.ref``) and the
wrapper's CPU path are held against the JAX oracle and the JAX Pallas
kernel in interpret mode, on the same inputs made from a numpy seed. T is
a multiple of 64, so the JAX wrapper really runs its Pallas kernel (it
takes its oracle below 64 positions). Lengths are ragged and include 0,
T - 1 and lengths at or past T (free rows that have run past the cache's
end). The CUDA kernel itself runs only on a card: its tests are in
test_torch_kernels_on_card.py. Tolerances are the reference's own: 2e-5
in fp32, 2e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jax_ops
from repro.kernels.decode_attention import ref as jax_ref
from repro.kernels.decode_attention.decode_attention import \
    decode_attention_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# (b, h, kv, d, t, lengths, window, cap); every row sees at least one
# position (a row with none: the kernels write 0, the oracles average v)
CASES = [
    (4, 4, 2, 32, 128, (0, 127, 128, 300), None, None),   # GQA 2, >= T
    (3, 8, 2, 16, 64, (5, 63, 40), None, 20.0),           # GQA 4, softcap
    (3, 4, 1, 32, 192, (150, 191, 17), 32, None),         # GQA 4, window
    (2, 2, 2, 64, 128, (64, 200), 100, 5.0),              # MHA, >= T, both
    (1, 4, 4, 16, 256, (255,), None, None),               # last position
]
IDS = [str(c[:5]) for c in CASES]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(case, dtype: str, seed=0):
    b, h, kv, d, t, lengths = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, d), (b, t, kv, d), (b, t, kv, d))]
    lens = np.asarray(lengths, np.int32)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx + [jnp.asarray(lens)], tx + [torch.tensor(lens)]


def _close(torch_out, jax_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref(case, dtype):
    window, cap = case[6:]
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(case, dtype)
    want = jax.jit(lambda q, k, v, lens: jax_ref.decode_attention_ref(
        q, k, v, lens, window=window, softcap=cap))(jq, jk, jv, jl)
    got = decode_attention_ref(tq, tk, tv, tl, window=window, softcap=cap)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_wrapper_matches_jax_interpret_kernel(case, dtype):
    window, cap = case[6:]
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(case, dtype, seed=1)
    want = decode_attention_kernel(jq, jk, jv, jl, window=window,
                                   softcap=cap, block_t=64, interpret=True)
    before = da_ops.launches
    got = da_ops.decode_attention(tq, tk, tv, tl, window=window,
                                  softcap=cap)
    assert da_ops.launches == before  # CPU tensors never launch the kernel
    _close(got, want, dtype)


def test_scalar_lengths_broadcast_like_the_reference():
    case = (2, 4, 2, 32, 128, (70, 70), None, None)
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(case, "float32", seed=2)
    want = jax_ops.decode_attention(jq, jk, jv, 70, interpret=True)
    got = da_ops.decode_attention(tq, tk, tv, 70)
    _close(got, want, "float32")


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 4, 16)
    kv3 = torch.zeros(2, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        da_ops.decode_attention(q, kv3, kv3, 0)
    kv = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="window"):
        da_ops.decode_attention(q, kv, kv, 0, window=0)
    with pytest.raises(ValueError, match="softcap"):
        da_ops.decode_attention(q, kv, kv, 0, softcap=-1.0)
    with pytest.raises(ValueError, match="do not match"):
        da_ops.decode_attention(q, torch.zeros(2, 8, 2, 32),
                                torch.zeros(2, 8, 2, 32), 0)
