"""The decode kernel's cluster split, checked on the CPU.

On a card the decode-attention kernel works one (row, kv head) with a
cluster of ``n_split`` blocks: block r takes the r-th chunk of whole
64-position tiles of the row's visible range [lo, hi], and the cluster's
rank 0 merges the blocks' unnormalised (num, den, m) with M = max m,
weights exp(m_r - M) (0 for an empty chunk), sums, and num / den. The CUDA
code runs only on a card (test_torch_kernels_on_card.py). Here:

* ``choose_n_split``, the wrapper's pick of n_split, on its edge cases;
* a torch-op emulation of that chunk-and-merge (the plain partials version
  on each chunk, merged by the kernel's formula), held to the JAX decode
  reference on the same numpy inputs, in fp32 at the reference tests'
  2e-5, empty chunks included; and the partials entry's split (one
  sequence shard, unnormalised state) held to JAX's partials oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ref as jax_ref
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_partials_ref

TOL = 2e-5
NEG_INF = -1e30
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# (pairs = B * KV, SMs, longest visible range, expected n_split)
CHOOSER_CASES = [
    (32, H100_SMS, 1024, 8),      # the serving path: 8 rows x 4 kv heads
    (132, H100_SMS, 4096, 1),     # the pairs alone fill the card
    (500, H100_SMS, 4096, 1),
    (100, H100_SMS, 4096, 2),     # about two blocks an SM
    (1, H100_SMS, 10 ** 6, 8),    # never above the portable cluster size
    (1, H100_SMS, 64, 1),         # never more chunks than visible tiles
    (1, H100_SMS, 65, 2),
    (2, H100_SMS, 200, 4),
    (4, H100_SMS, 1, 1),
    (40, H100_SMS, 4096, 6),
    (8, 16, 4096, 4),             # a smaller card
]


@pytest.mark.parametrize("pairs,sms,visible,want", CHOOSER_CASES,
                         ids=[str(c[:3]) for c in CHOOSER_CASES])
def test_choose_n_split(pairs, sms, visible, want):
    got = da_ops.choose_n_split(pairs, sms, visible)
    assert got == want
    assert 1 <= got <= da_ops.CLUSTER_LIMIT
    assert got <= max(1, -(-visible // da_ops.TILE))
    if pairs >= sms:
        assert got == 1


def chunks(length, capacity, window, n_split, tile=da_ops.TILE):
    """The kernel's chunks of one row: [(c_lo, c_hi)] per block rank, an
    empty chunk as c_lo > c_hi (decode_attention.cu, the block's chunk)."""
    hi = min(length, capacity - 1)
    lo = max(0, length - window + 1) if window else 0
    n_tiles = (hi - lo) // tile + 1 if hi >= lo else 0
    per = -(-n_tiles // n_split)
    out = []
    for r in range(n_split):
        first = min(r * per, n_tiles)
        end = min(first + per, n_tiles)
        out.append((lo + first * tile, min(hi, lo + end * tile - 1)))
    return out


def split_partials(q, k, v, lengths, n_split, *, offset=0, window=None,
                   softcap=None):
    """The kernel's chunk-and-merge in plain torch: per row, the plain
    partials on each chunk, merged as rank 0 merges them. Returns the
    unnormalised (num, den, m) and how many chunks were empty."""
    b, h, d = q.shape
    kv = k.shape[2]
    num = torch.zeros(b, kv, h // kv, d)
    den = torch.zeros(b, kv, h // kv)
    m = torch.full((b, kv, h // kv), NEG_INF)
    empty = 0
    for row in range(b):
        local = int(lengths[row]) - offset
        states = []
        for c_lo, c_hi in chunks(local, k.shape[1], window, n_split):
            if c_lo > c_hi:  # past hi: the neutral element
                empty += 1
                states.append((torch.zeros(kv, h // kv, d),
                               torch.zeros(kv, h // kv),
                               torch.full((kv, h // kv), NEG_INF)))
                continue
            n_, d_, m_ = decode_attention_partials_ref(
                q[row:row + 1], k[row:row + 1, c_lo:c_hi + 1],
                v[row:row + 1, c_lo:c_hi + 1], lengths[row:row + 1],
                offset=offset + c_lo, window=window, softcap=softcap)
            states.append((n_[0], d_[0], m_[0]))
        m_all = torch.stack([s[2] for s in states]).amax(0)
        for n_, d_, m_ in states:
            w = torch.where(m_ > NEG_INF / 2, torch.exp(m_ - m_all), 0.0)
            num[row] += w[..., None] * n_
            den[row] += w * d_
        m[row] = m_all
    return num, den, m, empty


def _inputs(b, h, kv, d, t, lengths, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, d), (b, t, kv, d), (b, t, kv, d))]
    lens = np.asarray(lengths, np.int32)
    return ([jnp.asarray(a) for a in arrs] + [jnp.asarray(lens)],
            [torch.tensor(a) for a in arrs] + [torch.tensor(lens)])


# (b, h, kv, d, t, lengths, window, cap, n_split); every row sees at least
# one position. Empty chunks: short rows under 8 blocks, length 1, a window
# ending inside one chunk, one row near T - 1 among short ones.
SPLIT_CASES = [
    (4, 4, 2, 32, 256, (0, 1, 63, 64), None, None, 8),
    (4, 4, 2, 32, 256, (65, 255, 256, 900), None, None, 3),
    (4, 8, 2, 16, 512, (511, 1, 2, 100), None, 20.0, 8),
    (3, 4, 1, 32, 512, (300, 511, 90), 70, None, 4),
    (3, 4, 1, 32, 512, (300, 511, 90), 200, None, 8),
    (2, 2, 2, 64, 192, (191, 5), None, None, 2),
    (2, 4, 2, 16, 128, (127, 40), 32, 5.0, 1),
]
SPLIT_IDS = [str(c[4:7] + c[8:]) for c in SPLIT_CASES]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=SPLIT_IDS)
def test_chunk_and_merge_matches_jax_ref(case):
    b, h, kv, d, t, lengths, window, cap, n_split = case
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(b, h, kv, d, t, lengths,
                                                 seed=0)
    want = jax.jit(lambda q, k, v, lens: jax_ref.decode_attention_ref(
        q, k, v, lens, window=window, softcap=cap))(jq, jk, jv, jl)
    num, den, _, empty = split_partials(tq, tk, tv, tl, n_split,
                                        window=window, softcap=cap)
    got = torch.where(den[..., None] == 0, 0.0,
                      num / den[..., None]).reshape(b, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if n_split == 8:
        assert empty > 0  # the cases at 8 blocks hold empty chunks


@pytest.mark.parametrize("n_split", [1, 2, 5, 8])
def test_partials_split_matches_jax_partials_oracle(n_split):
    """One sequence shard (local position t is global offset + t): rows the
    shard holds nothing of, or little of, leave chunks empty; the merged
    state equals the JAX oracle's, (0, 0, -1e30) included."""
    b, h, kv, d, sl, offset = 6, 4, 2, 32, 256, 256
    lengths = (0, 255, 256, 300, 511, 2000)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _inputs(b, h, kv, d, sl, lengths,
                                                 seed=n_split)
    want = jax.jit(lambda q, k, v, lens:
                   jax_ref.decode_attention_partials_ref(
                       q, k, v, lens, offset=offset))(jq, jk, jv, jl)
    num, den, m, empty = split_partials(tq, tk, tv, tl, n_split,
                                        offset=offset)
    for got, ref in zip((num, den, m), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)
    assert empty >= 2 * n_split  # rows 0 and 1 see nothing of this shard


def test_wrapper_split_follows_capacity_and_window():
    """The wrapper sizes the cluster from what the host knows (the
    capacity, or the window when smaller), never from the lengths, which
    live on the card."""
    assert da_ops.choose_n_split(8 * 4, H100_SMS, 1024) == 8
    assert da_ops.choose_n_split(8 * 4, H100_SMS, min(1024, 100)) == 2
    assert da_ops.choose_n_split(1 * 4, H100_SMS, min(4096, 64)) == 1
