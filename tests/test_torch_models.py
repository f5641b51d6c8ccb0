"""Port's model code against the JAX reference, on the same inputs.

Inputs come from a numpy seed; JAX params come from
``build(cfg).init(PRNGKey(0))``, go to numpy (bf16 -> fp32 is exact) and
cross into the port through ``repro_torch.models.convert``. Numerics are
compared in fp32 where the point is the algorithm (tolerance 1e-5) and in
bf16 where the point is the model as it runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import RunConfig as JRunConfig
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.models import RunConfig, build
from repro_torch.models import attention, common, mlp, transformer
from repro_torch.models.convert import from_reference, reference_path
from repro_torch.tree import tree_leaves_with_path

F32_TOL = 1e-5
# Logits of the smoke models: activations are bf16, and JAX evaluates
# GELU/SiLU in bf16 op by op where torch rounds once, so the two differ by
# a few bf16 ulps at the logits' scale. 4% of the largest reference logit
# covers that; labels must then agree except where the reference's own
# top-2 logit gap is below NEAR_TIE.
LOGIT_REL_TOL = 0.04
NEAR_TIE = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    return np.asarray(x, np.float32)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.tensor(a)


def _ref_params(arch):
    jcfg = jconfigs.smoke(arch)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    params_np = jax.tree.map(lambda x: np.asarray(x, np.float32), jparams)
    return jcfg, jparams, params_np


@pytest.fixture(scope="module")
def distilbert_ref():
    return _ref_params("distilbert-imdb")


_jax_forward = jax.jit(jtransformer.forward, static_argnums=(0, 1))


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_tanh", "relu",
                                  "relu2"])
def test_act_fn(name):
    jx, tx = _pair(np.random.default_rng(0), (4, 64), 3.0)
    np.testing.assert_allclose(common.act_fn(name)(tx).numpy(),
                               _np(jcommon.act_fn(name)(jx)),
                               atol=F32_TOL, rtol=F32_TOL)


@jax.jit
def _jax_numerics(x, scale, bias, pos, logits, labels):
    return (jcommon.layer_norm(x, scale, bias, 1e-5),
            jcommon.rms_norm(x, scale, 1e-5),
            jcommon.apply_rope(x, pos, 1e4),
            jcommon.sinusoidal_positions(12, 8),
            jcommon.cross_entropy(logits, labels))


def test_norms_rope_and_cross_entropy():
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 8, 4, 16))
    js, ts = _pair(rng, (16,))
    jb, tb = _pair(rng, (16,))
    jl, tl = _pair(rng, (3, 5, 11))
    pos = np.arange(8)[None] + 3
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, :2] = -100
    want = _jax_numerics(jx, js, jb, jnp.asarray(pos), jl,
                         jnp.asarray(labels))
    got = (common.layer_norm(tx, ts, tb, 1e-5),
           common.rms_norm(tx, ts, 1e-5),
           common.apply_rope(tx, torch.tensor(pos), 1e4),
           common.sinusoidal_positions(12, 8),
           common.cross_entropy(tl, torch.tensor(labels)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("arch", ["distilbert-imdb", "qwen2-7b"])
def test_mlp_apply(arch):
    cfg, jcfg = configs.smoke(arch), jconfigs.smoke(arch)
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng, (2, 6, cfg.d_model))
    pairs = {k: _pair(rng, s.shape, 0.1)
             for k, s in jmlp.mlp_specs(jcfg).items()}
    want = jax.jit(lambda p, x: jmlp.mlp_apply(jcfg, p, x))(
        {k: j for k, (j, _) in pairs.items()}, jx)
    got = mlp.mlp_apply(cfg, {k: t for k, (_, t) in pairs.items()}, tx)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL)


# (b, s, t, h, kv, hd, mask_kind, window, cap); s = 3072 takes the
# Q_CHUNK path (s > 2 * Q_CHUNK and s % Q_CHUNK == 0)
ATTEND_CASES = [
    (2, 16, 16, 4, 2, 8, "bidir", None, None),
    (1, 24, 24, 4, 1, 8, "causal", 6, 20.0),
    (1, 3072, 3072, 1, 1, 8, "causal", None, None),
    (1, 3072, 3072, 1, 1, 8, "bidir", 700, None),
]


@pytest.mark.parametrize("case", ATTEND_CASES,
                         ids=[str(c) for c in ATTEND_CASES])
def test_attend_full_xla(case):
    b, s, t, h, kv, hd, mask_kind, window, cap = case
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (b, s, h, hd))
    jk, tk = _pair(rng, (b, t, kv, hd))
    jv, tv = _pair(rng, (b, t, kv, hd))
    want = jax.jit(lambda q, k, v: jattn.attend_full(
        q, k, v, mask_kind=mask_kind, window=window, cap=cap))(jq, jk, jv)
    got = attention.attend_full(tq, tk, tv, mask_kind=mask_kind,
                                window=window, cap=cap)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_attn_forward_bf16():
    """In bf16 the attention sublayer (projections, RoPE, GQA attention,
    output projection) agrees to within one bf16 ulp at its output's
    scale: the rounding points are the same, the fusion is not."""
    jcfg, cfg = jconfigs.smoke("qwen2-7b"), configs.smoke("qwen2-7b")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    p = {k: (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
         for k, s in jattn.attn_specs(jcfg).items()}
    pos = np.arange(12)[None]
    want = jax.jit(lambda p, x, pos: jattn.attn_forward(
        jcfg, p, x, mixer="attn", positions=pos))(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    got = attention.attn_forward(
        cfg, {k: torch.tensor(v).bfloat16() for k, v in p.items()},
        torch.tensor(x).bfloat16(), mixer="attn",
        positions=torch.tensor(pos))
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=2 ** -7 * np.abs(_np(want)).max())


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


def _assert_logits_match(got, want):
    np.testing.assert_allclose(got, want,
                               atol=LOGIT_REL_TOL * np.abs(want).max())
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= NEAR_TIE
    np.testing.assert_array_equal(got.argmax(-1)[decided],
                                  want.argmax(-1)[decided])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_distilbert_smoke(impl, distilbert_ref):
    """JAX "pallas" runs the Pallas kernel in interpret mode (seq 32 is
    past its 16-token oracle fallback); the port's runs the kernel's plain
    version on CPU tensors."""
    jcfg, jparams, params_np = distilbert_ref
    cfg = configs.smoke("distilbert-imdb")
    params = from_reference(params_np, cfg, device="cpu")
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)
    want, _ = _jax_forward(jcfg, JRunConfig(attn_impl=impl), jparams,
                           tokens=jnp.asarray(tokens))
    got, aux = transformer.forward(cfg, RunConfig(attn_impl=impl), params,
                                   tokens=torch.tensor(tokens))
    assert got.shape == (8, cfg.num_labels) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _assert_logits_match(got.numpy(), _np(want))


def test_forward_qwen2_smoke_causal_rope_gqa():
    jcfg, jparams, params_np = _ref_params("qwen2-7b")
    cfg = configs.smoke("qwen2-7b")
    params = from_reference(params_np, cfg, device="cpu")
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = _jax_forward(jcfg, JRunConfig(), jparams,
                           tokens=jnp.asarray(tokens))
    got, _ = build(cfg).forward(RunConfig(), params,
                                {"tokens": torch.tensor(tokens)})
    _assert_logits_match(got.numpy(), _np(want))


# ---------------------------------------------------------------------------
# Param specs and the bridge
# ---------------------------------------------------------------------------


def test_bridge_full_width_layout_matches_reference():
    """Leaf paths, shapes and dtypes of the port's full-width
    distilbert-imdb params (on the meta device: nothing allocated) equal
    the reference's abstract tree, blocks unstacked."""
    cfg = configs.get("distilbert-imdb")
    port = dict(tree_leaves_with_path(
        build(cfg).init(torch.Generator(), device="meta")))
    ref = dict(tree_leaves_with_path(
        jbuild(jconfigs.get("distilbert-imdb")).abstract()))
    assert all(t.device.type == "meta" for t in port.values())
    seen = set()
    for path, t in port.items():
        rpath, group = reference_path(cfg, path)
        r = ref[rpath]
        want_shape = r.shape if group is None else r.shape[1:]
        assert tuple(t.shape) == tuple(want_shape), path
        assert str(t.dtype).removeprefix("torch.") == jnp.dtype(r.dtype).name
        seen.add(rpath)
    assert seen == set(ref)
    n_block = sum(1 for p in ref if p[0] == "blocks")
    assert len(port) == len(ref) - n_block + cfg.n_groups * n_block


def test_bridge_raises_on_missing_or_extra_leaf(distilbert_ref):
    _, _, params_np = distilbert_ref
    cfg = configs.smoke("distilbert-imdb")
    extra = dict(params_np, surprise=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="no port counterpart"):
        from_reference(extra, cfg, device="cpu")
    missing = {k: v for k, v in params_np.items() if k != "cls_head"}
    with pytest.raises(KeyError, match="cls_head"):
        from_reference(missing, cfg, device="cpu")


def test_bridge_keeps_declared_dtypes(distilbert_ref):
    _, _, params_np = distilbert_ref
    params = from_reference(params_np, configs.smoke("distilbert-imdb"),
                            device="cpu")
    assert params["blocks"][1]["attn"]["wq"].dtype == torch.bfloat16
    assert params["blocks"][1]["norm1"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        params["blocks"][1]["mlp"]["w1"].float().numpy(),
        params_np["blocks"][0]["mlp"]["w1"][1])


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-moe-a2.7b",
                                  "gemma2-27b", "whisper-base"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 #7"):
        build(configs.smoke(arch))
