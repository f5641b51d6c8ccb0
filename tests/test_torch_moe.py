"""The port's MoE sublayer (``repro_torch.models.moe``) against the JAX one.

The contracts of tests/test_models_parity.py re-run on the port (the three
dispatch impls agree with no drops, capacity drops bounded, the shared
expert contributes), and each impl, the router (with grok's softcap),
``capacity`` and the load-balancing loss held to ``repro.models.moe`` on
the same numpy params and inputs. Computed in fp32, where the point is
the algorithm: tolerance F32_TOL (1e-5 absolute, the parity test's own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models.common import LayerSpec as JLayerSpec
from repro.models.common import ModelConfig as JModelConfig
from repro.models.common import MoEConfig as JMoEConfig
from repro.models.common import init_params
from repro_torch.models import moe
from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig

F32_TOL = 1e-5


def _cfgs(**moe_kw):
    """The same tiny MoE model in both packages."""
    base = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64)
    jmc, mc = JMoEConfig(**moe_kw), MoEConfig(**moe_kw)
    return (JModelConfig(**base, moe=jmc,
                         pattern=(JLayerSpec("attn", "moe"),)),
            ModelConfig(**base, moe=mc, pattern=(LayerSpec("attn", "moe"),)))


def _params(jcfg, seed=0):
    """fp32 params from the reference's init, for both packages."""
    p = init_params(jax.random.PRNGKey(seed), JM.moe_specs(jcfg, jcfg.moe))
    p = jax.tree.map(lambda x: x.astype(jnp.float32), p)
    return p, jax.tree.map(lambda x: torch.tensor(np.asarray(x)), p)


def _x(shape, seed=1, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    return jnp.asarray(x), torch.tensor(x)


@pytest.mark.parametrize("impl", ["einsum", "scatter", "ragged"])
@pytest.mark.parametrize("moe_kw", [
    dict(num_experts=8, top_k=2, expert_ff=64),                   # drops
    dict(num_experts=4, top_k=1, expert_ff=16, capacity_factor=1.0),
    dict(num_experts=16, top_k=4, expert_ff=32, num_shared=1,
         shared_ff=48, router_softcap=30.0),
], ids=["e8k2", "e4k1_cf1", "e16k4_shared_softcap"])
def test_each_impl_and_lb_loss_match_jax(impl, moe_kw):
    """Same routes, the same capacity drops and the same outputs as the
    reference impl, with the default capacity factor (drops happen)."""
    jcfg, cfg = _cfgs(**moe_kw)
    jp, tp = _params(jcfg)
    jx, tx = _x((3, 24, 32))
    want, waux = jax.jit(lambda p, x: JM.moe_apply(jcfg, jcfg.moe, p, x,
                                                   impl=impl))(jp, jx)
    got, aux = moe.moe_apply(cfg, cfg.moe, tp, tx, impl=impl)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(waux["lb_loss"]), rtol=F32_TOL)


def test_router_and_capacity_match_jax():
    jcfg, cfg = _cfgs(num_experts=16, top_k=4, expert_ff=8,
                      router_softcap=5.0)
    jp, tp = _params(jcfg)
    jx, tx = _x((40, 32), scale=3.0)
    vals, idx, probs = JM._route(jcfg.moe, jp, jx)
    tvals, tidx, tprobs = moe._route(cfg.moe, tp, tx)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(vals), atol=F32_TOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs),
                               atol=F32_TOL)
    for n in (1, 3, 8, 64, 4096):
        assert moe.capacity(cfg.moe, n) == JM.capacity(jcfg.moe, n)
    pos, keep = JM._positions_in_expert(jcfg.moe, idx, 6)
    tpos, tkeep = moe._positions_in_expert(cfg.moe, tidx, 6)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))


@pytest.mark.parametrize("e,k", [(8, 2), (4, 1), (16, 4)])
def test_impl_parity_without_drops(e, k):
    """tests/test_models_parity.py::test_moe_impl_parity on the port: with
    a capacity factor of E nothing is dropped and all three agree."""
    jcfg, cfg = _cfgs(num_experts=e, top_k=k, expert_ff=64,
                      capacity_factor=float(e))
    _, tp = _params(jcfg)
    _, tx = _x((4, 16, 32))
    ys = {impl: moe.moe_apply(cfg, cfg.moe, tp, tx, impl=impl)[0]
          for impl in ("einsum", "scatter", "ragged")}
    torch.testing.assert_close(ys["scatter"], ys["einsum"], atol=F32_TOL,
                               rtol=0)
    torch.testing.assert_close(ys["ragged"], ys["einsum"], atol=F32_TOL,
                               rtol=0)


def test_scatter_and_einsum_drop_the_same_tokens():
    """Under a tight capacity the two capacity-bound impls keep exactly the
    same (token, choice) pairs: zeroing the kept experts' outputs leaves
    the same tokens untouched."""
    jcfg, cfg = _cfgs(num_experts=4, top_k=2, expert_ff=16,
                      capacity_factor=0.5)
    _, tp = _params(jcfg)
    _, tx = _x((64, 32))
    ys = {impl: moe.moe_apply(cfg, cfg.moe, tp, tx, impl=impl)[0]
          for impl in ("einsum", "scatter", "ragged")}
    torch.testing.assert_close(ys["scatter"], ys["einsum"], atol=F32_TOL,
                               rtol=0)
    dropped = [(y.abs().amax(-1) < 1e-9) for y in (ys["einsum"],
                                                   ys["scatter"])]
    assert torch.equal(dropped[0], dropped[1]) and dropped[0].any()
    assert not (ys["ragged"].abs().amax(-1) < 1e-9).any()  # dropless


def test_capacity_drops_are_bounded():
    """tests/test_models_parity.py::test_moe_capacity_drops_are_bounded:
    identical tokens all route to one expert, which keeps at most C."""
    jcfg, cfg = _cfgs(num_experts=4, top_k=1, expert_ff=16,
                      capacity_factor=1.0)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "d_model": 8})
    cfg = cfg.__class__(**{**cfg.__dict__, "d_model": 8})
    _, tp = _params(jcfg)
    y, _ = moe.moe_apply(cfg, cfg.moe, tp, torch.ones(1, 64, 8),
                         impl="scatter")
    assert torch.isfinite(y).all()
    nonzero = int((y[0].abs() > 1e-9).any(-1).sum())
    assert nonzero <= moe.capacity(cfg.moe, 64) + 4


def test_shared_expert_contributes():
    jcfg, cfg = _cfgs(num_experts=4, top_k=2, expert_ff=16, num_shared=1,
                      shared_ff=32, capacity_factor=4.0)
    _, tp = _params(jcfg)
    _, tx = _x((2, 8, 32))
    y_with, _ = moe.moe_apply(cfg, cfg.moe, tp, tx, impl="einsum")
    tp["shared"] = {k: torch.zeros_like(v) for k, v in tp["shared"].items()}
    y_without, _ = moe.moe_apply(cfg, cfg.moe, tp, tx, impl="einsum")
    assert float((y_with - y_without).abs().max()) > 1e-4


def test_auto_picks_einsum_up_to_2048_tokens(monkeypatch):
    jcfg, cfg = _cfgs(num_experts=4, top_k=1, expert_ff=8)
    _, tp = _params(jcfg)
    seen = []
    for name in ("einsum", "scatter"):
        impl = moe._IMPLS[name]
        monkeypatch.setitem(moe._IMPLS, name,
                            lambda *a, name=name, impl=impl:
                            seen.append(name) or impl(*a))
    for t in (2048, 2049):
        moe.moe_apply(cfg, cfg.moe, tp, torch.zeros(t, 32))
    assert seen == ["einsum", "scatter"]
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_apply(cfg, cfg.moe, tp, torch.zeros(4, 32), impl="dense")


def test_rows_depend_on_neighbours_under_capacity_but_not_ragged():
    """A difference by design (ROADMAP Queue 3): capacity drops depend on
    every token of the call, so under "einsum" and "scatter" a row's
    output changes with the rows beside it (a decode round carries every
    slot, free rows' stale tokens included), as in the reference; under
    "ragged" it does not."""
    jcfg, cfg = _cfgs(num_experts=4, top_k=1, expert_ff=16,
                      capacity_factor=1.0)
    jp, tp = _params(jcfg)
    _, row = _x((1, 32), seed=5)
    crowd = row.expand(16, 32).clone()  # all route where the row routes
    for impl in ("einsum", "scatter", "ragged"):
        alone = moe.moe_apply(cfg, cfg.moe, tp, row, impl=impl)[0]
        late = moe.moe_apply(cfg, cfg.moe, tp,
                             torch.cat([crowd, row]), impl=impl)[0][-1:]
        want = np.asarray(JM.moe_apply(
            jcfg, jcfg.moe, jp, jnp.asarray(torch.cat([crowd, row]).numpy()),
            impl=impl)[0])[-1:]
        np.testing.assert_allclose(late.numpy(), want, atol=F32_TOL)
        if impl == "ragged":
            torch.testing.assert_close(late, alone, atol=F32_TOL, rtol=0)
        else:  # the row queues behind 16 identical tokens and is dropped
            assert float(alone.abs().max()) > 1e-4
            assert float(late.abs().max()) < 1e-9
