"""The sampling kernel's cluster split, checked on the CPU.

On a card the fused-sampling kernel (``fused_sampling.cu``) splits each
row over a cluster of ``n_split`` blocks: block r holds the r-th slice of
ceil(V / n_split) elements of z = logits / temperature; the row max is the
max of the slices' maxima; the top-k threshold is found by a radix select
over order-preserving uint32 keys of z (-0.0 keyed as +0.0), 8 bits a digit
from the top, each digit from the slices' histograms of the keys under the
digits found so far, summed; the top-p denominator is the slices' sums of
exp(z - max) added in rank order; the token is the (value, global index)
argmax merged over the slices, the smaller index winning a tie. The CUDA
code runs only on a card (test_torch_kernels_on_card.py). Here:

* ``choose_sample_split``, the wrapper's pick of n_split, on its edges;
* a torch-op emulation of that algorithm, fed JAX's own Gumbel noise and
  cutoff, held token for token to the JAX Pallas epilogue in interpret
  mode and to the port's plain epilogue, at several n_split, with a V that
  no n_split divides, ties at the k-th value across slice boundaries, an
  argmax tie across slices, -0.0 and +0.0 at the threshold and top_p <= 0;
* the radix keys' order (hypothesis).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.decode_attention import fused_sampling as jfs
from repro_torch.kernels.decode_attention import fused_sampling as fs
from test_torch_fused_sampling import _jax_inputs

H100_SMS = 132
V = 1003  # a prime: no n_split > 1 divides it
# the kernel takes up to 8; 16 cuts finer, to show the token does not
# depend on where the slices fall
SPLITS = [1, 2, 5, 8, 16]
NEG_INF = -1e30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# (B, V, SMs, expected n_split)
CHOOSER_CASES = [
    (1, 5000, H100_SMS, 1),      # one slice of a few thousand
    (1, 30522, H100_SMS, 7),     # distilbert's vocabulary: 4 360 a block
    (1, 152064, H100_SMS, 8),    # an admission: the largest cluster
    (1, 256000, H100_SMS, 8),
    (4, 152064, H100_SMS, 8),
    (8, 5000, H100_SMS, 1),
    (8, 30522, H100_SMS, 7),
    (8, 152064, H100_SMS, 8),    # the serving path: 64 blocks
    (8, 256000, H100_SMS, 8),    # stages the logits, not the noise
    (64, 5000, H100_SMS, 1),
    (64, 30522, H100_SMS, 2),    # the batch alone nearly fills the card
    (64, 152064, H100_SMS, 7),   # raised until both slices fit
    (64, 256000, H100_SMS, 8),
    (8, 152064, 16, 7),          # a smaller card: raised to fit
]


@pytest.mark.parametrize("b,v,sms,want", CHOOSER_CASES,
                         ids=[str(c[:3]) for c in CHOOSER_CASES])
def test_choose_sample_split(b, v, sms, want):
    got = fs.choose_sample_split(b, v, sms)
    assert got == want
    assert 1 <= got <= fs.CLUSTER_LIMIT == 8  # the portable size
    # every vocabulary the repo has stages at least the logits: each
    # logit and noise value is read from device memory once
    assert fs.staging(v, got) in ("both", "logits")


def test_staging_edges():
    """Both slices fit up to about 24 500 elements a block, the logits
    alone up to about 49 000; beyond that nothing is staged."""
    assert fs.staging(152064, 7) == fs.staging(152064, 8) == "both"
    assert fs.staging(256000, 8) == "logits"
    assert fs.staging(8 * 24573, 8) == "both"
    assert fs.staging(8 * 24574, 8) == "logits"
    assert fs.staging(1_000_000, 8) == "none"


# ---------------------------------------------------------------------------
# The kernel's algorithm in torch ops
# ---------------------------------------------------------------------------


def radix_key(z):
    """uint32 keys (as int64) that order like the floats, -0.0 as +0.0."""
    u = z.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    return torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def key_value(key):
    u = torch.where(key >= 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    return ((u + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32).view(
        torch.float32)


def slices(v, n_split):
    per = -(-v // n_split)
    return [(min(v, r * per), min(v, r * per + per)) for r in range(n_split)]


def radix_select(keys, k):
    """The key of the k-th largest over the slices' keys, ties counted,
    8-bit digits from the top, each from the slices' histograms (of the
    keys under the digits found so far) summed: one cluster step."""
    prefix, mask = 0, 0
    for shift in (24, 16, 8, 0):
        hist = sum(torch.bincount((kk[(kk & mask) == prefix] >> shift) & 255,
                                  minlength=256) for kk in keys)
        incl = hist.flip(0).cumsum(0)         # counts from the top digit
        t = int(torch.nonzero(incl >= k)[0])
        k -= int(incl[t] - hist.flip(0)[t])   # those above its digit
        prefix |= (255 - t) << shift
        mask |= 255 << shift
    return prefix


def split_sample(logits, gumbel, cutoff, *, temperature, top_k=None,
                 use_top_p=False, n_split):
    """The kernel's split algorithm, row by row, slice by slice."""
    z = logits / temperature
    bounds = slices(logits.shape[1], n_split)
    out = []
    for row in range(z.shape[0]):
        parts = [z[row, lo:hi] for lo, hi in bounds]
        zmax = max(p.max() for p in parts if len(p))
        if top_k is not None:
            kth = key_value(torch.tensor(radix_select(
                [radix_key(p) for p in parts], top_k)))
            parts = [torch.where(p < kth, NEG_INF, p) for p in parts]
        if use_top_p:
            denom = torch.zeros((), dtype=torch.float32)
            for p in parts:  # rank order
                denom = denom + torch.exp(p - zmax).sum()
        best, arg = -float("inf"), None
        for (lo, hi), p in zip(bounds, parts):
            if not len(p):
                continue
            g = gumbel[row, lo:hi]
            y = p + g
            if use_top_p:
                drop = (p < zmax) & (torch.exp(p - zmax) / denom
                                     * (1 + fs.TOP_P_SLACK) < cutoff[row, 0])
                y = torch.where(drop, NEG_INF + g, y)
            i = int(torch.argmax(y))  # the first index of the slice's max
            if float(y[i]) > best:    # an equal later slice loses
                best, arg = float(y[i]), lo + i
        out.append(arg)
    return torch.tensor(out, dtype=torch.int32)


def _check(logits_np, kw, n_split, seed, gumbel_np=None):
    """The emulation, the JAX interpret kernel and the plain epilogue draw
    the same tokens from JAX's noise (or ``gumbel_np``); each framework
    computes its own top-p cutoff, as ``fused_sample`` does (the two agree
    to 1e-6, test_torch_fused_sampling.py)."""
    logits, gumbel, cutoff, use_top_p = _jax_inputs(logits_np, kw, seed)
    if gumbel_np is not None:
        gumbel = jnp.asarray(gumbel_np)
    top_k = kw.get("top_k")
    want = np.asarray(jfs.fused_sample_kernel(
        logits, gumbel, cutoff, temperature=kw["temperature"], top_k=top_k,
        use_top_p=use_top_p, interpret=True))
    t_logits = torch.tensor(logits_np)
    t_cutoff = (fs.nucleus_cutoff(fs.apply_filters(
        t_logits, temperature=kw["temperature"], top_k=top_k), kw["top_p"])
        if use_top_p else torch.zeros(len(logits_np), 1))
    args = (t_logits, torch.tensor(np.asarray(gumbel)), t_cutoff)
    opts = dict(temperature=kw["temperature"], top_k=top_k,
                use_top_p=use_top_p)
    got = split_sample(*args, n_split=n_split, **opts)
    plain = fs.fused_sample_ref(*args, **opts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    return want


SETTINGS = [
    dict(temperature=0.8),
    dict(temperature=0.8, top_k=1),
    dict(temperature=0.8, top_k=50),
    dict(temperature=1.0, top_k=V),
    dict(temperature=0.8, top_k=50, top_p=0.95),
    dict(temperature=1.1, top_p=0.9),
    dict(temperature=1.0, top_p=0.0),
    dict(temperature=1.0, top_k=50, top_p=-0.5),
]


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("kw", SETTINGS,
                         ids=[str(sorted(k.items())) for k in SETTINGS])
def test_split_matches_jax_kernel(kw, n_split):
    logits = np.random.default_rng(n_split).standard_normal(
        (3, V)).astype(np.float32) * 3
    for seed in range(2):
        got = _check(logits, kw, n_split, seed)
        if kw.get("top_p") is not None and kw["top_p"] <= 0:
            np.testing.assert_array_equal(got, logits.argmax(-1))


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("top_k", [5, 13], ids=["first_tie", "last_tie"])
def test_ties_at_kth_across_slice_boundaries(n_split, top_k):
    """Ten tokens tie below three larger ones, two on each side of every
    boundary of the 8-way split and one at each end, and the k-th value
    is the first or the last of the ties: every tie is kept wherever the
    slices fall."""
    per8 = -(-V // 8)
    row = np.full(V, -4.0, np.float32)
    row[[3, 500, 900]] = 6.0
    ties = [0, per8 - 1, per8, 2 * per8 - 1, 2 * per8, 4 * per8 - 1,
            4 * per8, 7 * per8 - 1, 7 * per8, V - 1]
    row[ties] = 5.0
    seen = set()
    for seed in range(12):
        tok = int(_check(row[None], dict(temperature=1.0, top_k=top_k),
                         n_split, seed)[0])
        assert tok in set(ties) | {3, 500, 900}
        seen.add(tok)
    assert len(seen & set(ties)) > 1  # ties actually get drawn


@pytest.mark.parametrize("n_split", SPLITS)
def test_argmax_tie_across_slices_takes_the_smaller_index(n_split):
    """y ties exactly at indices in slices 1 and 6 of an 8-way split (and
    at two neighbours of a boundary): the first index wins."""
    per8 = -(-V // 8)
    row = np.zeros((2, V), np.float32)
    row[0, [per8 + 3, 6 * per8 + 1]] = 7.0
    row[1, [4 * per8 - 1, 4 * per8]] = 7.0
    got = _check(row, dict(temperature=0.9, top_k=3), n_split, 0,
                 gumbel_np=np.zeros_like(row))
    np.testing.assert_array_equal(got, [per8 + 3, 4 * per8 - 1])


@pytest.mark.parametrize("n_split", SPLITS)
def test_signed_zeros_at_the_threshold(n_split):
    """-0.0 and +0.0 in several slices are the k-th value: all of them are
    kept, and the noise that favours a -0.0 draws it."""
    row = np.full(V, -1.0, np.float32)
    row[[10, 700]] = 2.0
    zeros = {5: -0.0, 130: 0.0, 260: -0.0, 631: 0.0, 999: -0.0}
    for i, x in zeros.items():
        row[i] = x
    for k in (3, 4, 7):  # the threshold on a +0.0, on a -0.0, the last
        kw = dict(temperature=0.8, top_k=k)
        noise = np.zeros((1, V), np.float32)
        noise[0, 999] = 5.0
        assert int(_check(row[None], kw, n_split, 0,
                          gumbel_np=noise)[0]) == 999
        for seed in range(3):
            tok = int(_check(row[None], kw, n_split, seed)[0])
            assert tok in set(zeros) | {10, 700}


def test_radix_select_gives_lax_top_k_threshold():
    """The radix select's value equals lax.top_k's k-th value (counting
    duplicates) on rows with many ties, for every k."""
    rng = np.random.default_rng(7)
    row = rng.integers(-6, 7, 200).astype(np.float32) / 2
    row[::17] = -0.0
    t = torch.tensor(row)
    keys = [radix_key(t[lo:hi]) for lo, hi in slices(200, 5)]
    want = np.asarray(jax.lax.top_k(jnp.asarray(row), 200)[0])
    for k in range(1, 201):
        got = key_value(torch.tensor(radix_select(keys, k)))
        assert float(got) == float(want[k - 1])


@settings(max_examples=200, deadline=None)
@given(st.floats(width=32, allow_nan=False),
       st.floats(width=32, allow_nan=False))
def test_radix_keys_order_like_floats(a, b):
    t = torch.tensor([a, b], dtype=torch.float32)
    k = radix_key(t)
    assert bool(k[0] < k[1]) == bool(t[0] < t[1])
    assert bool(k[0] == k[1]) == bool(t[0] == t[1])  # -0.0 == +0.0
    back = key_value(k)
    assert torch.equal(back, t)  # values round-trip (a -0.0 as +0.0)
    assert not torch.signbit(back[t == 0]).any()


@pytest.mark.parametrize("n_split", [0, 9])
def test_wrapper_rejects_a_cluster_size_the_kernel_cannot_take(n_split):
    logits = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="n_split"):
        fs.fused_sample_kernel(logits, logits, torch.zeros(2, 1),
                               temperature=1.0, n_split=n_split)
