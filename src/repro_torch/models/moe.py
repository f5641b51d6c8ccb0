"""Mixture-of-Experts sublayer: top-k router + three dispatch strategies.

Counterpart of ``repro.models.moe``. Dispatch impls (``RunConfig.moe_impl``,
or picked by token count under "auto"):
  * "einsum"  — GShard capacity-based one-hot dispatch and combine
                products; the dispatch product grows with tokens² · k / E,
                so "auto" takes it only up to 2048 tokens (decode steps,
                short prefills).
  * "scatter" — the same capacity and the same dropped tokens, dispatched
                by writing each kept (token, choice) into its expert slot
                and combined by a gather: no dispatch product.
  * "ragged"  — sort-based DROPLESS dispatch: tokens sorted by expert, one
                matmul per expert over its contiguous segment (the
                reference's ``jax.lax.ragged_dot``, which has no PyTorch
                counterpart), no capacity drops.

The reference cuts the scatter dispatch into one group per data-parallel
shard of its mesh (``_dp_groups``, ``_shmap_over_groups``); without a mesh
that is one group, the only case the port runs (a data axis larger than 1
is ROADMAP Queue 1 #4.1).

Capacity drops depend on every token of the call: a decode round carries
all of the batcher's slots, so under "einsum" and "scatter" a row's output
depends on its neighbours (as in the reference); under "ragged" it does
not. Shared experts (Qwen-MoE style) run densely beside the routed ones,
behind a sigmoid gate. ``moe_apply`` returns (y, {"lb_loss": scalar}).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (AxSpec, ModelConfig, MoEConfig,
                                       act_fn, softcap)

EINSUM_MAX_TOKENS = 2048  # "auto" takes "einsum" up to here, then "scatter"


def moe_specs(cfg: ModelConfig, mc: MoEConfig):
    d, e, f = cfg.d_model, mc.num_experts, mc.expert_ff
    p = {
        "router": AxSpec((d, e), ("d_model", "experts"), "small",
                         torch.float32),
        "w1": AxSpec((e, d, f), ("experts", "d_model", "d_ff")),
        "w2": AxSpec((e, f, d), ("experts", "d_ff", "d_model")),
    }
    if cfg.gated_mlp:
        p["w3"] = AxSpec((e, d, f), ("experts", "d_model", "d_ff"))
    if mc.num_shared:
        shared_ff = mc.shared_ff or mc.expert_ff * mc.num_shared
        p["shared"] = mlp_lib.mlp_specs(cfg, d_ff=shared_ff)
        p["shared_gate"] = AxSpec((d, 1), ("d_model", None), "small",
                                  torch.float32)
    return p


def capacity(mc: MoEConfig, n_tokens: int) -> int:
    c = int(math.ceil(mc.capacity_factor * mc.top_k * n_tokens /
                      mc.num_experts))
    return max(4 * ((c + 3) // 4), mc.top_k)


def _route(mc: MoEConfig, p, xt):
    """Shared router: (gate_vals (T,k) fp32, gate_idx (T,k) int64,
    probs (T,E) fp32)."""
    logits = softcap(xt.float() @ p["router"], mc.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, mc.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return gate_vals, gate_idx, probs


def _lb_loss(mc: MoEConfig, gate_idx, probs):
    frac_tokens = F.one_hot(gate_idx[:, 0], mc.num_experts).float().mean(0)
    frac_probs = probs.mean(0)
    return mc.num_experts * torch.sum(frac_tokens * frac_probs)


def _positions_in_expert(mc: MoEConfig, gate_idx, c: int):
    """GShard slot-priority positions: choice j of every token queues
    behind all choices < j. Returns (pos (T,k) int64, keep (T,k) bool)."""
    e = mc.num_experts
    counts = torch.zeros(e, dtype=torch.float32, device=gate_idx.device)
    pos_all, keep_all = [], []
    for j in range(mc.top_k):
        oh = F.one_hot(gate_idx[:, j], e).float()
        pos_e = (torch.cumsum(oh, 0) - 1.0) + counts[None]
        pos_j = (pos_e * oh).sum(-1)  # (T,)
        keep_all.append(pos_j < c)
        pos_all.append(pos_j.long())
        counts = counts + oh.sum(0)
    return torch.stack(pos_all, 1), torch.stack(keep_all, 1)


def _expert_mlp(cfg: ModelConfig, p, x, dtype):
    """x: (E,C,D) -> (E,C,D), each expert's MLP on its own slots."""
    act = act_fn(cfg.act)
    h = act(torch.bmm(x, p["w1"].to(dtype)))
    if "w3" in p:
        h = h * torch.bmm(x, p["w3"].to(dtype))
    return torch.bmm(h, p["w2"].to(dtype))


# ---------------------------------------------------------------------------
# Dispatch implementations
# ---------------------------------------------------------------------------


def _apply_einsum(cfg, mc, p, xt, gate_vals, gate_idx):
    t = xt.shape[0]
    e, k = mc.num_experts, mc.top_k
    c = capacity(mc, t)
    counts = torch.zeros(e, dtype=torch.float32, device=xt.device)
    dispatch = torch.zeros((t, e, c), dtype=xt.dtype, device=xt.device)
    combine = torch.zeros((t, e, c), dtype=torch.float32, device=xt.device)
    for j in range(k):
        oh = F.one_hot(gate_idx[:, j], e).float()
        pos = (torch.cumsum(oh, 0) - 1.0) + counts[None]
        keep = oh * (pos < c)
        slot = F.one_hot(pos.clamp(0, c - 1).long(), c).float() \
            * keep[..., None]
        dispatch = dispatch + slot.to(xt.dtype)
        combine = combine + slot * gate_vals[:, j][:, None, None]
        counts = counts + oh.sum(0)
    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    expert_out = _expert_mlp(cfg, p, expert_in, xt.dtype)
    return torch.einsum("tec,ecd->td", combine.to(xt.dtype), expert_out)


def _apply_scatter(cfg, mc, p, xt, gate_vals, gate_idx):
    t, d = xt.shape
    e, k = mc.num_experts, mc.top_k
    c = capacity(mc, t)
    pos, keep = _positions_in_expert(mc, gate_idx, c)
    # flat slot into (E*C [+1 overflow row]); dropped choices -> overflow.
    # A kept slot holds exactly one (token, choice), so a copy places what
    # the reference's scatter-add into zeros places; only the discarded
    # overflow row receives several.
    slot = torch.where(keep, gate_idx * c + pos.clamp(0, c - 1), e * c)
    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_copy_(0, slot.reshape(-1),
                    xt[:, None].expand(t, k, d).reshape(t * k, d))
    expert_out = _expert_mlp(cfg, p, buf[:e * c].reshape(e, c, d), xt.dtype)
    padded = torch.cat([expert_out.reshape(e * c, d),
                        torch.zeros((1, d), dtype=xt.dtype,
                                    device=xt.device)])
    gathered = padded[slot.reshape(-1)].reshape(t, k, d)
    w = (gate_vals * keep).to(xt.dtype)
    return torch.einsum("tkd,tk->td", gathered, w)


def _apply_ragged(cfg, mc, p, xt, gate_vals, gate_idx):
    """Sort-based dropless dispatch: one matmul per expert segment."""
    t, d = xt.shape
    e, k = mc.num_experts, mc.top_k
    act = act_fn(cfg.act)
    flat_e = gate_idx.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    tok_of = order // k
    xs = xt[tok_of]  # (T*k, D) sorted by expert
    sizes = torch.bincount(flat_e, minlength=e).tolist()
    ys = torch.empty_like(xs)
    start = 0
    for ex, n in enumerate(sizes):
        if n:
            seg = xs[start:start + n]
            h = act(seg @ p["w1"][ex].to(xt.dtype))
            if "w3" in p:
                h = h * (seg @ p["w3"][ex].to(xt.dtype))
            ys[start:start + n] = h @ p["w2"][ex].to(xt.dtype)
        start += n
    gates_sorted = gate_vals.reshape(-1)[order].to(xt.dtype)
    y = torch.zeros((t, d), dtype=xt.dtype, device=xt.device)
    return y.index_add_(0, tok_of, ys * gates_sorted[:, None])


_IMPLS = {"einsum": _apply_einsum, "scatter": _apply_scatter,
          "ragged": _apply_ragged}


def moe_apply(cfg: ModelConfig, mc: MoEConfig, p, x, impl: str = "auto"):
    """x: (B,S,D) or (T,D). Returns (y, {"lb_loss": scalar})."""
    orig_shape = x.shape
    xt = x.reshape(-1, orig_shape[-1])
    if impl == "auto":
        impl = "einsum" if xt.shape[0] <= EINSUM_MAX_TOKENS else "scatter"
    if impl not in _IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}")
    gate_vals, gate_idx, probs = _route(mc, p, xt)
    y = _IMPLS[impl](cfg, mc, p, xt, gate_vals, gate_idx)
    if "shared" in p:
        sh = mlp_lib.mlp_apply(cfg, p["shared"], xt)
        g = torch.sigmoid(xt.float() @ p["shared_gate"])
        y = y + sh * g.to(sh.dtype)
    return y.reshape(orig_shape), {"lb_loss": _lb_loss(mc, gate_idx, probs)}
