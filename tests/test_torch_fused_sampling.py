"""Port's sampling (filters, cutoff, epilogue, host sampler) against JAX.

torch cannot reproduce ``jax.random``'s threefry bits, so the sampled math
is compared by feeding the reference's own Gumbel noise
(``jax.random.gumbel``, as numpy) into the port: through the plain
epilogue and the wrapper's CPU path (``fused_sample_kernel``), the host
sampler's ``noise=`` seam and ``fused_sample``'s. Tokens must be EQUAL to
the JAX Pallas epilogue in interpret mode and to JAX's
``argmax(apply_filters + noise)``: the top-p boundary token sits exactly on
the cutoff in both frameworks' own arithmetic, so no near-tie arises on
these inputs. Filtered logits and cutoffs are compared at fp32 tolerance
1e-6. The port's own noise stream gets a distribution test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import fused_sampling as jfs
from repro_torch.kernels.decode_attention import fused_sampling as fs
from repro_torch.serving.sampler import sample

F32_TOL = 1e-6
SAMPLING_GRID = [
    dict(temperature=0.8, top_k=5),
    dict(temperature=1.1, top_p=0.9),
    dict(temperature=0.7, top_k=8, top_p=0.95),
    dict(temperature=1.0),                                # unfiltered
]
GRID_IDS = [str(sorted(kw.items())) for kw in SAMPLING_GRID]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_inputs(logits_np, kw, seed):
    """The reference's kernel inputs: noise from its key, and the cutoff
    computed as ``fused_sample`` does (top-k first)."""
    logits = jnp.asarray(logits_np)
    gumbel = jax.random.gumbel(jax.random.PRNGKey(seed), logits.shape,
                               jnp.float32)
    z = logits / kw["temperature"]
    if kw.get("top_k") is not None:
        vals, _ = jax.lax.top_k(z, kw["top_k"])
        z = jnp.where(z < vals[:, -1:], jfs.NEG_INF, z)
    use_top_p = kw.get("top_p") is not None and kw["top_p"] < 1.0
    cutoff = (jfs.nucleus_cutoff(z, kw["top_p"]) if use_top_p
              else jnp.zeros((logits.shape[0], 1), jnp.float32))
    return logits, gumbel, cutoff, use_top_p


def _check_all_paths(logits_np, kw, seed):
    """Every port path against the JAX interpret kernel and the JAX host
    draw, on the reference's noise. Returns the tokens."""
    logits, gumbel, cutoff, use_top_p = _jax_inputs(logits_np, kw, seed)
    top_k, top_p = kw.get("top_k"), kw.get("top_p")
    want_kernel = np.asarray(jfs.fused_sample_kernel(
        logits, gumbel, cutoff, temperature=kw["temperature"], top_k=top_k,
        use_top_p=use_top_p, interpret=True))
    want_host = np.asarray(jnp.argmax(
        jfs.apply_filters(logits, **kw) + gumbel, axis=-1))
    np.testing.assert_array_equal(want_kernel, want_host)

    t_logits = torch.tensor(logits_np)
    noise = torch.tensor(np.asarray(gumbel))
    t_cutoff = fs.nucleus_cutoff(
        fs.apply_filters(t_logits, temperature=kw["temperature"],
                         top_k=top_k), top_p) if use_top_p else \
        torch.zeros(len(logits_np), 1)
    np.testing.assert_allclose(t_cutoff.numpy(), np.asarray(cutoff),
                               rtol=F32_TOL, atol=F32_TOL)
    before = fs.launches
    got = [
        fs.fused_sample_ref(t_logits, noise, t_cutoff,
                            temperature=kw["temperature"], top_k=top_k,
                            use_top_p=use_top_p),
        fs.fused_sample_kernel(t_logits, noise, t_cutoff,
                               temperature=kw["temperature"], top_k=top_k,
                               use_top_p=use_top_p),
        fs.fused_sample(t_logits, noise=noise, **kw),
        sample(t_logits, noise=noise, **kw),
    ]
    assert fs.launches == before  # CPU tensors never launch the kernel
    for g in got:
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), want_kernel)
    return want_kernel


@pytest.mark.parametrize("kw", SAMPLING_GRID, ids=GRID_IDS)
def test_filters_match_jax(kw):
    logits = np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32) * 2
    want = np.asarray(jfs.apply_filters(jnp.asarray(logits), **kw))
    got = fs.apply_filters(torch.tensor(logits), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.999])
def test_nucleus_cutoff_matches_jax(top_p):
    logits = np.random.default_rng(1).standard_normal((3, 100)).astype(
        np.float32) * 3
    want = np.asarray(jfs.nucleus_cutoff(jnp.asarray(logits), top_p))
    got = fs.nucleus_cutoff(torch.tensor(logits), top_p).numpy()
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kw", SAMPLING_GRID, ids=GRID_IDS)
def test_epilogue_on_jax_noise_matches_jax_kernel(kw):
    logits = np.random.default_rng(2).standard_normal((4, 64)).astype(
        np.float32)
    for seed in range(4):
        _check_all_paths(logits, kw, seed)


def test_top_k_boundary_ties_keep_lax_top_k_semantics():
    # three tokens tie at the kth value: every one stays eligible
    row = np.full(32, -3.0, np.float32)
    row[[4, 9, 17]] = 5.0
    row[1] = 4.0
    seen = set()
    for seed in range(24):
        tok = int(_check_all_paths(row[None], dict(temperature=1.0,
                                                   top_k=2), seed)[0])
        assert tok in (4, 9, 17)
        seen.add(tok)
    assert len(seen) > 1  # ties actually get sampled


def test_top_p_cumulative_boundary():
    # probs [0.5, 0.3, 0.2], top_p=0.8: slot 2's (cum - p_i) hits 0.8
    # exactly and the strict `<` must exclude it on every path
    logits = np.log(np.array([0.5, 0.3, 0.2]))[None].astype(np.float32)
    for seed in range(24):
        tok = int(_check_all_paths(logits, dict(temperature=1.0, top_p=0.8),
                                   seed)[0])
        assert tok in (0, 1)


@pytest.mark.parametrize("top_p", [0.0, -0.5])
def test_top_p_nonpositive_keeps_only_top_token(top_p):
    logits = np.random.default_rng(3).standard_normal((3, 40)).astype(
        np.float32)
    for seed in range(4):
        got = _check_all_paths(logits, dict(temperature=1.0, top_p=top_p),
                               seed)
        np.testing.assert_array_equal(got, logits.argmax(-1))


@pytest.mark.parametrize("factor,want", [(1 + fs.TOP_P_SLACK / 4, 0),
                                         (1 - fs.TOP_P_SLACK / 4, 5)],
                         ids=["just_below_cutoff", "just_above_cutoff"])
def test_top_p_token_near_cutoff_follows_reference(factor, want):
    """Token 5 gets the largest noise and p = cutoff / ``factor``: the plain
    epilogue drops it exactly when p < cutoff, as the JAX kernel does, even
    inside the CUDA kernel's margin (the card test pins the kernel's side
    of that deliberate difference)."""
    logits = np.linspace(2.0, -2.0, 16).astype(np.float32)[None]
    p = np.exp(logits.astype(np.float64))
    p /= p.sum()
    cutoff = np.array([[p[0, 5] * factor]], np.float32)
    gumbel = np.zeros_like(logits)
    gumbel[0, 5] = 10.0
    jax_tok = np.asarray(jfs.fused_sample_kernel(
        jnp.asarray(logits), jnp.asarray(gumbel), jnp.asarray(cutoff),
        temperature=1.0, use_top_p=True, interpret=True))
    got = fs.fused_sample_kernel(torch.tensor(logits), torch.tensor(gumbel),
                                 torch.tensor(cutoff), temperature=1.0,
                                 use_top_p=True)
    np.testing.assert_array_equal(jax_tok, [want])
    np.testing.assert_array_equal(got.numpy(), [want])


def test_greedy_is_argmax_and_draws_nothing():
    logits = torch.tensor(np.random.default_rng(4).standard_normal(
        (5, 33)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    for out in (fs.fused_sample(logits, gen), sample(logits, gen)):
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(),
                                      logits.argmax(-1).numpy())
    assert torch.equal(gen.get_state(), state)


def test_fused_and_host_draw_the_same_token_from_one_generator_state():
    """The port's own noise stream: at the same generator state the fused
    path and the host sampler draw the same tokens (bit-identical on the
    CPU), round after round."""
    logits = torch.tensor(np.random.default_rng(5).standard_normal(
        (6, 50)).astype(np.float32))
    kw = dict(temperature=0.7, top_k=8, top_p=0.9)
    g_fused, g_host = (torch.Generator().manual_seed(3) for _ in range(2))
    for _ in range(5):
        np.testing.assert_array_equal(fs.fused_sample(logits, g_fused,
                                                      **kw).numpy(),
                                      sample(logits, g_host, **kw).numpy())


@pytest.mark.parametrize("kw", [dict(temperature=1.3),
                                dict(temperature=0.9, top_k=3),
                                dict(temperature=1.0, top_p=0.7)],
                         ids=["temperature", "top_k", "top_p"])
def test_port_noise_draws_the_filtered_distribution(kw):
    """20 000 draws over V = 8 from the port's generator: each token's
    frequency is within 4 sigma of its filtered softmax probability, and
    tokens the filters remove are never drawn."""
    n = 20_000
    row = torch.tensor([[2.0, 1.5, 1.2, 0.3, 0.0, -0.4, -1.0, -2.0]])
    probs = torch.softmax(fs.apply_filters(row, **kw), dim=-1)[0].double()
    draws = fs.fused_sample(row.expand(n, -1),
                            torch.Generator().manual_seed(11), **kw)
    freq = torch.bincount(draws.long(), minlength=8).double() / n
    sigma = torch.sqrt(probs * (1 - probs) / n)
    assert torch.all((freq - probs).abs() <= 4 * sigma + 1e-12), (freq,
                                                                  probs)
    assert torch.all(freq[probs == 0] == 0)
    if "top_k" in kw:
        assert int((freq > 0).sum()) == kw["top_k"]
    if "top_p" in kw:  # masses .40 .24 .18 .07 ...: a nucleus of 3
        assert int((freq > 0).sum()) == 3


def test_epilogue_rejects_bad_inputs():
    logits = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="temperature"):
        fs.fused_sample_kernel(logits, logits, torch.zeros(2, 1),
                               temperature=0.0)
    with pytest.raises(ValueError, match="top_k"):
        fs.fused_sample_kernel(logits, logits, torch.zeros(2, 1),
                               temperature=1.0, top_k=9)
    with pytest.raises(ValueError, match="cutoff"):
        fs.fused_sample_kernel(logits, logits, torch.zeros(2),
                               temperature=1.0)
