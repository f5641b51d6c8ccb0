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

Over a data axis the reference's answer is the port's. The scatter
dispatch runs one group per data shard where the reference's rule
(``_dp_groups``) makes one: when the tokens of the whole batch divide
into the shards with at least 4k each, each group with its own capacity.
A rank whose rows are one data shard (``dist.context.current_rows``) then
dispatches its own group alone; a rank holding the whole batch runs every
group. Where the rule falls back to one group, and for "einsum", the
capacity and slot priorities span every token of the batch, so a rank
holding one shard gathers the hidden states over the data axes
(``dist.collectives.data_gather``), dispatches them all and keeps its own
rows. "ragged" drops nothing and each token's output is its own: it runs
on the rank's rows as they are. "auto" picks by the whole batch's tokens.

Under a "model" axis the planner cuts the experts ("experts" is the first
TP candidate) or, where the axis does not divide them, each expert's
d_ff, and the shared expert's d_ff. The router's logits over an expert
block are gathered over "model" before top-k, so every rank routes alike;
each rank runs its experts' slots (or its d_ff block of every expert) and
the partial outputs are summed over "model", the shared expert's with
them.

Capacity drops depend on every token of the call: a decode round carries
all of the batcher's slots, so under "einsum" and "scatter" a row's output
depends on its neighbours (as in the reference); under "ragged" it does
not. Shared experts (Qwen-MoE style) run densely beside the routed ones,
behind a sigmoid gate. ``moe_apply`` returns (y, {"lb_loss": scalar}).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives
from repro_torch.dist import context as dctx
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
    probs (T,E) fp32). A router holding a block of the experts gathers
    its logits over "model" first."""
    logits = xt.float() @ p["router"]
    if logits.shape[-1] < mc.num_experts:
        logits = collectives.model_gather(logits, dim=-1)
    logits = softcap(logits, mc.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, mc.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return gate_vals, gate_idx, probs


def _lb_loss(mc: MoEConfig, gate_idx, probs, shards: int = 1):
    """E x sum over experts of (share of first choices) x (mean prob).
    With ``shards`` > 1 the tokens are one data shard of the batch: the
    per-expert counts and probability sums are summed over the data axes
    first (``collectives.data_sum``), so the loss is the whole batch's,
    as the reference's means over every token."""
    e = mc.num_experts
    if shards == 1:
        frac_tokens = F.one_hot(gate_idx[:, 0], e).float().mean(0)
        frac_probs = probs.mean(0)
        return e * torch.sum(frac_tokens * frac_probs)
    sums = collectives.data_sum(torch.cat([
        F.one_hot(gate_idx[:, 0], e).float().sum(0), probs.sum(0)]))
    n = gate_idx.shape[0] * shards
    return e * torch.sum((sums[:e] / n) * (sums[e:] / n))


def _positions_in_expert(mc: MoEConfig, gate_idx, c: int):
    """GShard slot-priority positions: choice j of every token queues
    behind all choices < j. Returns (pos (T,k) int64, keep (T,k) bool)."""
    e = mc.num_experts
    counts = torch.zeros(e, dtype=torch.float32, device=gate_idx.device)
    pos_all, keep_all = [], []
    for j in range(mc.top_k):
        hot = F.one_hot(gate_idx[:, j], e)
        oh = hot.float()
        # counted in integers: exact, and deterministic on CUDA
        pos_e = (torch.cumsum(hot, 0) - 1).float() + counts[None]
        pos_j = (pos_e * oh).sum(-1)  # (T,)
        keep_all.append(pos_j < c)
        pos_all.append(pos_j.long())
        counts = counts + oh.sum(0)
    return torch.stack(pos_all, 1), torch.stack(keep_all, 1)


def _experts(mc: MoEConfig, p) -> Tuple[int, int]:
    """(first expert, experts) whose weights this rank holds."""
    el = p["w1"].shape[0]
    if el == mc.num_experts:
        return 0, el
    return dctx.get_mesh().coord("model") * el, el


def _expert_mlp(cfg: ModelConfig, p, x, dtype):
    """x: (El,C,D) -> (El,C,D), each of this rank's experts' MLP on its
    own slots (a d_ff block of it under a d_ff cut: partial outputs)."""
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
        hot = F.one_hot(gate_idx[:, j], e)
        oh = hot.float()
        pos = (torch.cumsum(hot, 0) - 1).float() + counts[None]
        keep = oh * (pos < c)
        slot = F.one_hot(pos.clamp(0, c - 1).long(), c).float() \
            * keep[..., None]
        dispatch = dispatch + slot.to(xt.dtype)
        combine = combine + slot * gate_vals[:, j][:, None, None]
        counts = counts + oh.sum(0)
    lo, el = _experts(mc, p)
    dispatch = dispatch[:, lo:lo + el]
    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    expert_out = _expert_mlp(cfg, p, expert_in, xt.dtype)
    return torch.einsum("tec,ecd->td",
                        combine[:, lo:lo + el].to(xt.dtype), expert_out)


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
    lo, el = _experts(mc, p)
    expert_out = _expert_mlp(
        cfg, p, buf[lo * c:(lo + el) * c].reshape(el, c, d), xt.dtype)
    # other ranks' experts' slots read zeros here: their share of the sum
    padded = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=xt.device)
    padded[lo * c:(lo + el) * c] = expert_out.reshape(el * c, d)
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
    lo, el = _experts(mc, p)
    ys = torch.zeros_like(xs)  # other ranks' experts' segments stay 0
    start = 0
    for ex, n in enumerate(sizes):
        if n and lo <= ex < lo + el:
            seg = xs[start:start + n]
            h = act(seg @ p["w1"][ex - lo].to(xt.dtype))
            if "w3" in p:
                h = h * (seg @ p["w3"][ex - lo].to(xt.dtype))
            ys[start:start + n] = h @ p["w2"][ex - lo].to(xt.dtype)
        start += n
    gates_sorted = gate_vals.reshape(-1)[order].to(xt.dtype)
    y = torch.zeros((t, d), dtype=xt.dtype, device=xt.device)
    return y.index_add_(0, tok_of, ys * gates_sorted[:, None])


_IMPLS = {"einsum": _apply_einsum, "scatter": _apply_scatter,
          "ragged": _apply_ragged}


def _dp_groups(t: int, k: int) -> int:
    """Dispatch groups of a ``t``-token batch: one per data shard of the
    ambient mesh when the shards divide the tokens with at least 4k each,
    else one (the reference's rule)."""
    g = dctx.dp_size()
    if g <= 1 or t % g or (t // g) < 4 * k:
        return 1
    return g


def _routed_split(mc: MoEConfig, p) -> bool:
    """Whether the routed experts' output is a partial sum over "model"
    (an expert or a d_ff block a rank)."""
    e, _, f = p["w1"].shape
    return e < mc.num_experts or f < mc.expert_ff


def moe_apply(cfg: ModelConfig, mc: MoEConfig, p, x, impl: str = "auto"):
    """x: (B,S,D) or (T,D). Returns (y, {"lb_loss": scalar}); under a
    data axis the loss is over the tokens of this rank's rows, and under
    autograd (a train step) over the whole batch's, its counts and
    probability sums summed over the data axes."""
    orig_shape = x.shape
    xt = x.reshape(-1, orig_shape[-1])
    shards, index = dctx.current_rows()
    t_local = xt.shape[0]
    t = t_local * shards  # the whole batch's tokens
    if impl == "auto":
        impl = "einsum" if t <= EINSUM_MAX_TOKENS else "scatter"
    if impl not in _IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}")
    groups = _dp_groups(t, mc.top_k) if impl == "scatter" else 1
    gather = shards > 1 and impl != "ragged" and groups != shards
    if gather:  # capacity over every token of the batch
        xt = collectives.data_gather(xt)
    elif shards > 1 and impl == "scatter":
        groups = 1  # this rank's rows are its own group
    # what enters a region split over "model" passes model_copy (its
    # grad summed over "model" in the backward); the router's probs stay
    # whole on every rank
    routed = _routed_split(mc, p)
    router_split = p["router"].shape[-1] < mc.num_experts
    xt_tp = collectives.model_copy(xt) if routed or router_split else xt
    gate_vals, gate_idx, probs = _route(mc, p,
                                        xt_tp if router_split else xt)
    gates = collectives.model_copy(gate_vals) if routed else gate_vals
    # ``groups`` equal, consecutive groups, each with its own capacity
    y = torch.cat([_IMPLS[impl](cfg, mc, p, *parts) for parts in zip(
        (xt_tp if routed else xt).chunk(groups), gates.chunk(groups),
        gate_idx.chunk(groups))])
    if gather:  # keep this rank's rows
        rows = slice(index * t_local, (index + 1) * t_local)
        y, xt = y[rows], xt[rows]
        gate_idx, probs = gate_idx[rows], probs[rows]
    # partial sums over "model" are summed once, whole terms added after
    partial, whole = (y, None) if routed else (None, y)
    if "shared" in p:
        shared_ff = mc.shared_ff or mc.expert_ff * mc.num_shared
        g = torch.sigmoid(xt.float() @ p["shared_gate"])
        sh = mlp_lib.mlp_apply(cfg, p["shared"], xt, d_ff=shared_ff,
                               reduce=False)
        split = p["shared"]["w1"].shape[1] < shared_ff
        sh = sh * (collectives.model_copy(g) if split else g).to(sh.dtype)
        if split:
            partial = sh if partial is None else partial + sh
            if "b2" in p["shared"]:
                bias = p["shared"]["b2"].to(sh.dtype) * g.to(sh.dtype)
                whole = bias if whole is None else whole + bias
        else:
            whole = whole + sh if whole is not None else sh
    if partial is not None:
        part = collectives.model_sum(partial)
        whole = part if whole is None else whole + part
    # a train step sums the grads over the data axes, so its loss counts
    # every data shard's tokens; serving discards the loss
    lb = _lb_loss(mc, gate_idx, probs,
                  shards if torch.is_grad_enabled() else 1)
    return whole.reshape(orig_shape), {"lb_loss": lb}
