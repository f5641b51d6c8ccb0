"""Every architecture of the registry in the port against the JAX package.

For each name in ``configs.ARCHS``: the param bridge (the full-width
param tree's paths, shapes and dtypes, on the meta device; the smoke
reference init loading leaf for leaf), and at ``configs.smoke(arch)``
forward logits and the MoE load-balancing loss, prefill logits and cache,
and one ragged decode step, on the same numpy inputs and the reference's
own params (``models.convert``). The port runs "xla" (plain torch) and
"pallas" (the hand kernels' plain versions on CPU tensors); the reference
runs its "xla" path. Then ``ContinuousBatcher`` streams for gemma2,
qwen2-moe, mamba2 and jamba against the reference's batcher.

Tolerances. Activations are bf16, and the frameworks round at different
places (JAX evaluates GELU/SiLU op by op in bf16 where torch rounds once),
so the two differ by a few bf16 ulps a layer. Several smoke models amplify
that: a perturbation of every reference param by a relative 2^-9 (half a
bf16 ulp) moves jamba's smoke logits by about 58% RMS and gemma2's by
16%. So:
  * block by block, fed the reference's own hidden state, every layer's
    output is within LAYER_TOL (2%) of the largest reference entry: this
    holds the algorithm of each block tightly;
  * whole-model outputs (logits and each cache leaf) are within a relative
    RMS of max(RMS_FLOOR, NOISE_FACTOR x the reference's own shift under
    that half-ulp perturbation), RMS_FLOOR 0.02 and NOISE_FACTOR 2, where
    that bound stays within BOUND_CAP (0.1); integer leaves (lengths) are
    equal. Where it would not, both packages run that comparison in
    fp32, params, activations and caches (``_fp32_everywhere``), and agree
    within FP32_RTOL (1e-4; jamba's forward differs by about 1e-5), the
    load-balancing loss within FP32_LB_TOL (1e-4). The shifts that send a
    comparison to fp32 (forward, prefill, decode step): jamba 0.58, 1.23;
    gemma2 0.16, 0.20; whisper 0.22, 0.21; command-r 0.066, -, 0.071;
    nemotron 0.068, 0.057; qwen2-7b 0.053; distilbert 0.062;
  * the load-balancing loss within LB_TOL (0.05): it counts each token's
    top-1 expert, and one top-1 flip among T = 32 routed tokens moves it
    by about 1/T times E times that expert's mean probability;
  * greedy streams token for token, or parted only at a near-tie of the
    reference batcher's logits at that token: both tokens within
    max(NEAR_TIE (0.05), the largest difference between the two batchers'
    logits there) of the best, those logits agreeing within the bf16
    noise bound, uncapped (the batchers run as served, in bf16); at most
    a third of the streams part, unless the model's own half-ulp shift
    exceeds CHAOTIC (0.1: jamba's smoke init).
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import RunConfig as JRunConfig
from repro.models import build as jbuild
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import configs
from repro_torch.models import RunConfig, build
from repro_torch.models.convert import (cache_from_reference, from_reference,
                                        reference_path)
from repro_torch.serving import ContinuousBatcher, Engine, Request
from repro_torch.tree import tree_leaves_with_path, tree_map

LAYER_TOL = 0.02
RMS_FLOOR = 0.02
NOISE_FACTOR = 2.0
BOUND_CAP = 0.1
FP32_RTOL = 1e-4
FP32_LB_TOL = 1e-4
HALF_ULP = 2.0 ** -9
LB_TOL = 0.05
NEAR_TIE = 0.05
CHAOTIC = 0.1
ARCHS = list(configs.ARCHS)
DECODERS = [a for a in ARCHS if not configs.get(a).num_labels]
B, S = 2, 16
RUN = dict(cache_pad=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_REFS = {}


def _ref(arch):
    """(jcfg, jparams, cfg, port params on the CPU) for ``arch``'s smoke
    config, the reference initialised from PRNGKey(0)."""
    if arch not in _REFS:
        jcfg, cfg = jconfigs.smoke(arch), configs.smoke(arch)
        jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
        params_np = jax.tree.map(lambda x: np.asarray(x, np.float32),
                                 jparams)
        _REFS[arch] = (jcfg, jparams, cfg,
                       from_reference(params_np, cfg, device="cpu"))
    return _REFS[arch]


def _np(x):
    return np.asarray(x, np.float32)


def _batches(cfg, s=S, seed=0):
    """The same batch for both packages: (JAX dict, torch dict)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    if cfg.encdec:
        enc = rng.standard_normal((B, s, cfg.enc_d_model)).astype(np.float32)
        return ({"enc_embeds": jnp.asarray(enc, jnp.bfloat16),
                 "tokens": jnp.asarray(tokens)},
                {"enc_embeds": torch.tensor(enc).bfloat16(),
                 "tokens": torch.tensor(tokens)})
    if cfg.input_mode == "embeddings":
        emb = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
        return ({"embeddings": jnp.asarray(emb, jnp.bfloat16)},
                {"embeddings": torch.tensor(emb).bfloat16()})
    return {"tokens": jnp.asarray(tokens)}, {"tokens": torch.tensor(tokens)}


def _rel_rms(got, want) -> float:
    want = _np(want)
    return float(np.sqrt(np.mean((_np(got) - want) ** 2)
                         / max(np.mean(want ** 2), 1e-30)))


def _perturbed(jparams):
    """Every float param times (1 + HALF_ULP * N(0, 1)), from a seed."""
    rng = np.random.default_rng(11)
    return jax.tree.map(
        lambda x: (x.astype(jnp.float32) * (1 + HALF_ULP * jnp.asarray(
            rng.standard_normal(x.shape), jnp.float32))).astype(x.dtype),
        jparams)


def _ref_outputs(cfg, fn, jparams, *args):
    """(the reference's outputs as a flat {path: numpy} dict, and per path
    its relative RMS shift under the half-ulp perturbation of its
    params)."""
    want = _ref_flat(cfg, fn(jparams, *args))
    shifted = _ref_flat(cfg, fn(_perturbed(jparams), *args))
    return want, {k: _rel_rms(shifted[k], w) for k, w in want.items()}


def _ref_flat(cfg, out):
    """Logits and cache leaves keyed by a path the port can also name:
    ("logits",), ("lengths",) and (layer, leaf name)."""
    logits, cache = out
    flat = {("logits",): _np(logits)}
    if cache is not None:
        flat.update(_ref_cache_flat(cfg, cache))
    return flat


def _ref_cache_flat(cfg, jcache):
    flat = {("lengths",): np.asarray(jcache.lengths)}
    if cfg.encdec:
        for name in ("self_k", "self_v", "cross_k", "cross_v"):
            for layer in range(cfg.n_layers):
                flat[(layer, name)] = _np(getattr(jcache, name)[layer])
        return flat
    for layer in range(cfg.n_layers):
        for name, leaf in jcache.layers[layer % cfg.period].items():
            flat[(layer, name)] = _np(leaf[layer // cfg.period])
    return flat


def _port_flat(cfg, logits, cache):
    flat = {("logits",): _np(logits)}
    if cache is None:
        return flat
    flat[("lengths",)] = cache.lengths.numpy()
    if cfg.encdec:
        for name in ("self_k", "self_v", "cross_k", "cross_v"):
            for layer, t in enumerate(getattr(cache, name)):
                flat[(layer, name)] = _np(t.float())
        return flat
    for layer, leaves in enumerate(cache.layers):
        for name, t in leaves.items():
            flat[(layer, name)] = _np(t.float())
    return flat


def _assert_matches(got: dict, want: dict, noise: dict = None):
    """Each output within its bound: the noise bound in bf16, FP32_RTOL
    where ``noise`` is None (both packages in fp32)."""
    assert set(got) == set(want)
    for key, w in want.items():
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[key], w, err_msg=str(key))
            continue
        assert got[key].shape == w.shape, key
        bound = FP32_RTOL if noise is None else max(RMS_FLOOR,
                                                    NOISE_FACTOR * noise[key])
        assert bound <= BOUND_CAP, key
        err = _rel_rms(got[key], w)
        assert err <= bound, f"{key}: relative RMS {err:.4f} > {bound:.4f}"


@contextlib.contextmanager
def _fp32_everywhere():
    """Both packages compute in fp32 where they name bf16 (activations, KV
    and conv-window caches): ``jnp.bfloat16`` and ``torch.bfloat16`` read
    as fp32 inside the block. JAX's jit caches are cleared on the way in
    and out, so no trace crosses the patch."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "bfloat16", jnp.float32)
        mp.setattr(torch, "bfloat16", torch.float32)
        try:
            yield
        finally:
            jax.clear_caches()


def _to_fp32(tree):
    """Every float leaf of a JAX tree, a port param tree or a batch in
    fp32."""
    if any(torch.is_tensor(t) for _, t in tree_leaves_with_path(tree)):
        return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                        tree)
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@contextlib.contextmanager
def _precision(*noises):
    """Where the bf16 noise bound of every output stays within BOUND_CAP,
    the comparison runs as served (bf16, held to that bound); else in fp32
    on both sides, held to FP32_RTOL. Yields ``m``: ``m.fp32``,
    ``m.cast(tree)`` (identity in bf16), ``m.noise(noise)`` (what
    ``_assert_matches`` takes), ``m.lb_tol``."""
    fp32 = any(NOISE_FACTOR * v > BOUND_CAP for n in noises
               for v in n.values())
    m = types.SimpleNamespace(
        fp32=fp32, cast=_to_fp32 if fp32 else (lambda t: t),
        noise=(lambda n: None) if fp32 else (lambda n: n),
        lb_tol=FP32_LB_TOL if fp32 else LB_TOL)
    with _fp32_everywhere() if fp32 else contextlib.nullcontext():
        yield m


def _to_numpy_cache(jcache):
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if x.dtype == jnp.bfloat16 else np.asarray(x),
                        jcache)


# ---------------------------------------------------------------------------
# Build and the param bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_full_width_layout_matches_reference(arch):
    """Leaf paths, shapes and dtypes of the port's full-width params (on
    the meta device: nothing allocated) equal the reference's abstract
    tree, stacked layers unstacked; the smoke config builds too."""
    cfg = configs.get(arch)
    build(configs.smoke(arch))
    model = build(cfg)
    port = dict(tree_leaves_with_path(
        model.init(torch.Generator(), device="meta")))
    ref = dict(tree_leaves_with_path(jbuild(jconfigs.get(arch)).abstract()))
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
    assert model.n_params == jbuild(jconfigs.get(arch)).n_params
    assert (model.active_param_count
            == jbuild(jconfigs.get(arch)).active_param_count)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_loads_every_smoke_leaf(arch):
    """Each leaf of the reference's smoke init lands at its port path with
    its value, in the port's declared dtype."""
    jcfg, jparams, cfg, params = _ref(arch)
    ref = {path: leaf for path, leaf in tree_leaves_with_path(jparams)}
    specs = dict(tree_leaves_with_path(build(cfg).param_specs,
                                       lambda s: hasattr(s, "axes")))
    for path, t in tree_leaves_with_path(params):
        rpath, group = reference_path(cfg, path)
        want = _np(ref[rpath] if group is None else ref[rpath][group])
        assert t.dtype == specs[path].dtype, path
        np.testing.assert_array_equal(_np(t.float()), want, err_msg=str(path))


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [a for a in ARCHS if not configs.get(a).encdec])
def test_each_block_matches_jax_on_the_reference_hidden_state(arch):
    """Layer by layer, the port's block (mixer, sandwich norms, dense or
    MoE MLP) fed the reference's hidden state gives the reference block's
    output within LAYER_TOL of its largest entry, and the same MoE
    load-balancing loss."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer
    jcfg, jparams, cfg, params = _ref(arch)
    jbatch, batch = _batches(cfg)
    pos = jnp.arange(S)[None]
    x = jtransformer._embed_in(jcfg, jparams, jbatch.get("tokens"),
                               jbatch.get("embeddings"), pos)
    block = jax.jit(jtransformer._apply_block_position,
                    static_argnums=(0, 1, 2))
    for layer in range(cfg.n_layers):
        spec = cfg.pattern[layer % cfg.period]
        gp = jax.tree.map(lambda t: t[layer // cfg.period],
                          jparams["blocks"][layer % cfg.period])
        want, lb = block(jcfg, JRunConfig(), jcfg.pattern[layer % cfg.period],
                         gp, x, pos, jnp.zeros((), jnp.float32))
        got, got_lb, _ = transformer._apply_block_position(
            cfg, RunConfig(), spec, params["blocks"][layer],
            torch.tensor(_np(x)).bfloat16(), torch.arange(S)[None])
        w = _np(want)
        np.testing.assert_allclose(_np(got.float()), w,
                                   atol=LAYER_TOL * np.abs(w).max(),
                                   err_msg=f"layer {layer} {spec}")
        np.testing.assert_allclose(float(got_lb), float(lb), atol=LB_TOL)
        x = want


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_lb_loss_match_jax(arch, impl):
    jcfg, jparams, cfg, params = _ref(arch)
    jbatch, batch = _batches(cfg)
    fwd = jax.jit(jbuild(jcfg).forward, static_argnums=0)
    _, noise = _ref_outputs(
        cfg, lambda p: (fwd(JRunConfig(**RUN), p, jbatch)[0], None), jparams)
    with _precision(noise) as m:
        jp, jb = m.cast(jparams), m.cast(jbatch)
        want, want_aux = fwd(JRunConfig(**RUN), jp, jb)
        got, aux = build(cfg).forward(RunConfig(attn_impl=impl, **RUN),
                                      m.cast(params), m.cast(batch))
    assert got.dtype == torch.float32
    _assert_matches(_port_flat(cfg, got, None),
                    _ref_flat(cfg, (want, None)), m.noise(noise))
    assert aux.dtype == torch.float32 and aux.shape == ()
    if cfg.moe is None:
        assert float(aux) == float(want_aux) == 0.0
    else:
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), float(want_aux),
                                   atol=m.lb_tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_step_match_jax(arch, impl):
    """Prefill logits and every cache leaf (KV, SSM conv windows and state,
    cross K/V), then one ragged decode step from the reference's own cache
    (bridged by ``cache_from_reference``): logits and the written cache."""
    jcfg, jparams, cfg, params = _ref(arch)
    model, run = build(cfg), RunConfig(attn_impl=impl, **RUN)
    jmodel, jrun = jbuild(jcfg), JRunConfig(**RUN)
    token = np.asarray([[3], [200]], np.int32)
    prefill = jax.jit(lambda p, b: jmodel.prefill(jrun, p, b, max_len=24))
    decode = jax.jit(lambda p, c: jmodel.decode_step(
        jrun, p, c, {"token": jnp.asarray(token)}))
    jbatch, batch = _batches(cfg)
    _, pre_noise = _ref_outputs(cfg, lambda p: prefill(p, jbatch), jparams)
    jcache = prefill(jparams, jbatch)[1]
    _, dec_noise = _ref_outputs(cfg, lambda p: decode(p, jcache), jparams)
    with _precision(pre_noise, dec_noise) as m:
        jp, p = m.cast(jparams), m.cast(params)
        want_pre, jcache = prefill(jp, m.cast(jbatch))
        got, cache = model.prefill(run, p, m.cast(batch), max_len=24)
        pre = (_port_flat(cfg, got, cache),
               _ref_flat(cfg, (want_pre, jcache)))
        want_dec = _ref_flat(cfg, decode(jp, jcache))
        cache = cache_from_reference(_to_numpy_cache(jcache), cfg,
                                     device="cpu")
        if m.fp32 and not cfg.encdec:  # the bridge's conv leaves are bf16
            for key, leaf in _ref_cache_flat(cfg, jcache).items():
                if key != ("lengths",):
                    cache.layers[key[0]][key[1]] = torch.tensor(leaf)
        got, out = model.decode_step(run, p, cache,
                                     {"token": torch.tensor(token)})
    assert out is cache  # written in place
    _assert_matches(*pre, m.noise(pre_noise))
    _assert_matches(_port_flat(cfg, got, cache), want_dec,
                    m.noise(dec_noise))


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_plus_decode_equals_forward(arch):
    """The contract of tests/test_arch_smoke.py::test_decode_consistency_smoke
    on the port: prefill's last logits and one decode step equal the full
    forward's at those positions (0.5 absolute, its bound). The MoE archs
    run "ragged", whose rows do not depend on the other tokens of a call,
    so forward and decode route alike."""
    _, _, cfg, params = _ref(arch)
    run = RunConfig(moe_impl="ragged", **RUN)
    model = build(cfg)
    _, full = _batches(cfg, S + 1, seed=3)
    pre = {k: v[:, :S] for k, v in full.items()}
    if cfg.encdec:
        pre["enc_embeds"] = full["enc_embeds"]
    logits_full, _ = model.forward(run, params, full)
    logits_pre, cache = model.prefill(run, params, pre)
    assert float((logits_pre - logits_full[:, S - 1]).abs().max()) < 0.5
    if "embeddings" in full:  # pixtral's stubbed frontend: prefill only
        return
    logits_dec, cache = model.decode_step(
        run, params, cache, {"token": full["tokens"][:, S:S + 1]})
    assert float((logits_dec - logits_full[:, S]).abs().max()) < 0.5
    assert cache.lengths.tolist() == [S + 1] * B


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

BATCHER_ARCHS = ["gemma2-27b", "qwen2-moe-a2.7b", "mamba2-130m",
                 "jamba-1.5-large-398b"]
# smoke SSM chunk is 8: a prompt is at most one chunk or whole chunks
PROMPT_LENS = (3, 5, 8, 16)


def _requests(cls, vocab, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid, rng.integers(0, vocab, int(rng.choice(PROMPT_LENS))
                                  ).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 7)))
            for rid in range(n)]


def _forward_noise(arch) -> float:
    """The reference's forward logits' relative RMS shift under the
    half-ulp param perturbation (the batch of ``_batches``)."""
    jcfg, jparams, _, _ = _ref(arch)
    fwd = jax.jit(jbuild(jcfg).forward, static_argnums=0)
    jbatch, _ = _batches(jcfg)
    want = fwd(JRunConfig(**RUN), jparams, jbatch)[0]
    return _rel_rms(fwd(JRunConfig(**RUN), _perturbed(jparams), jbatch)[0],
                    want)


class _EngineLog:
    """Wraps an engine's ``prefill_into`` and ``decode`` (the reference's or
    the port's): keeps each admission's (row, prompt, logits) and each
    decode round's (lengths after the round, logits), in order, so a
    parted stream is judged on the logits each batcher saw at that token
    (an MoE row's logits may depend on the round's other rows)."""

    def __init__(self, engine):
        self.events = []
        self._prefill_into, self._decode = engine.prefill_into, engine.decode
        engine.prefill_into, engine.decode = self.prefill_into, self.decode

    def prefill_into(self, params, cache, row, tokens, **kw):
        logits, cache = self._prefill_into(params, cache, row, tokens, **kw)
        self.events.append(("admit", int(row),
                            tuple(int(t) for t in np.array(tokens)[0]),
                            np.array(logits[0], np.float32)))
        return logits, cache

    def decode(self, params, cache, token):
        logits, cache = self._decode(params, cache, token)
        self.events.append(("round", np.array(cache.lengths),
                            np.array(logits, np.float32)))
        return logits, cache

    def logits_at(self, prompt, i):
        """The reference logits from which the request with ``prompt``
        took its token ``i``."""
        prompt = tuple(int(t) for t in prompt)
        rows = [(n, e[1]) for n, e in enumerate(self.events)
                if e[0] == "admit" and e[2] == prompt]
        assert len(rows) == 1, "prompts are distinct"
        start, row = rows[0]
        if i == 0:
            return self.events[start][3]
        for e in self.events[start + 1:]:
            if e[0] == "admit" and e[1] == row:
                break
            if e[0] == "round" and e[1][row] == len(prompt) + i:
                return e[2][row]
        return None


def _assert_streams_match(reqs, want, got, ref_log, port_log, noise):
    """Equal token for token, or parted where the two tokens are a near-tie
    of the reference's logits at the first differing token: both within
    max(NEAR_TIE, the largest difference between the two batchers' logits
    there) of the best one. Those logits, computed from the same tokens,
    must themselves agree within the whole-model bound (relative RMS
    max(RMS_FLOOR, NOISE_FACTOR x ``noise``)). At most a third part where
    the model's own half-ulp shift ``noise`` is below CHAOTIC; above it
    (jamba's smoke init: about 0.58) any one rounding difference reorders
    most streams, so only the per-token rule holds."""
    parted = 0
    for r, a, b in zip(reqs, want, got):
        a, b = [int(t) for t in a], [int(t) for t in b]
        assert len(a) == len(b)
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        row, mine = ref_log.logits_at(r.prompt, i), port_log.logits_at(
            r.prompt, i)
        assert row is not None and mine is not None, (r.rid, i)
        err = _rel_rms(mine, row)
        assert err <= max(RMS_FLOOR, NOISE_FACTOR * noise), (
            f"request {r.rid}, token {i}: logits relative RMS {err:.4f}")
        tie = max(NEAR_TIE, float(np.abs(mine - row).max()))
        gaps = (row.max() - row[a[i]], row.max() - row[b[i]])
        assert max(gaps) <= tie, (
            f"request {r.rid} parts at token {i} ({a[i]} vs {b[i]}) with "
            f"reference logit gaps {gaps}: not a near-tie ({tie:.4f})")
        parted += 1
    if noise < CHAOTIC:
        assert parted <= len(want) // 3, f"{parted} of {len(want)} parted"


@pytest.mark.parametrize("arch", BATCHER_ARCHS)
def test_batcher_greedy_streams_match_jax(arch):
    """8 requests over 3 slots, admit/evict churn; streams, completion
    order and counters equal the reference batcher's (the port on the
    hand kernels' plain versions)."""
    jcfg, jparams, cfg, params = _ref(arch)
    jeng = JEngine(jbuild(jcfg), JRunConfig())
    eng = Engine(build(cfg), RunConfig(attn_impl="pallas"), device="cpu")
    ref_log, port_log = _EngineLog(jeng), _EngineLog(eng)
    jb = JBatcher(jeng, jparams, n_slots=3)
    pb = ContinuousBatcher(eng, params, n_slots=3)
    jb.submit_many(_requests(JRequest, cfg.vocab_size))
    reqs = _requests(Request, cfg.vocab_size)
    pb.submit_many(reqs)
    want, got = jb.run(), pb.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    _assert_streams_match(got, [r.generated for r in want],
                          [r.generated for r in got], ref_log, port_log,
                          _forward_noise(arch))
    for name in ("decode_dispatches", "decode_steps", "sampler_dispatches",
                 "rounds"):
        assert getattr(pb, name) == getattr(jb, name), name
    assert eng.compile_count == jeng.compile_count
