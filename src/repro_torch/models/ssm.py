"""Mamba-2 mixer (SSD, state-space duality), chunked-scan formulation.

Counterpart of ``repro.models.ssm``. The packed in-projection of Mamba-2 is
split into per-stream projections (x / B / C / dt / z), and the depthwise
causal conv into one per x / B / C stream, which is the same function.

State convention: state[b, h, p, n]  (head, head_dim, d_state).
Recurrence: state_s = exp(dt_s A_h) · state_{s-1} + dt_s · x_s ⊗ B_s
            y_s     = state_s · C_s + D_h · x_s

The reference has no Pallas kernel here: the chunked SSD is plain tensor
code (einsums and a scan over chunks), and so it is here (a Python loop
over chunks), on the CPU and on the card alike.

Under a "model" axis the planner leaves the "ssm_inner" leaves whole
(no TP candidate) and cuts the per-head leaves (``wdt``, ``A_log``,
``dt_bias``, ``D``) by "heads" where the axis divides them, as the
reference's planner does: every "model" rank runs the whole mixer on the
replicated residual, those four leaves gathered whole first, in one
all_gather (:func:`_whole_heads`; the gather's backward keeps the rank's
block, as every rank computes the same whole grad).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives
from repro_torch.models.common import (AxSpec, ModelConfig, SSMConfig, cumsum,
                                       rms_norm)

_HEAD_LEAVES = ("wdt", "A_log", "dt_bias", "D")

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def ssm_specs(cfg: ModelConfig, sc: SSMConfig):
    d = cfg.d_model
    di = sc.d_inner(d)
    h = sc.n_heads(d)
    gn = sc.n_groups * sc.d_state
    k = sc.d_conv
    bf16, f32 = torch.bfloat16, torch.float32
    return {
        "wz": AxSpec((d, di), ("d_model", "ssm_inner")),
        "wx": AxSpec((d, di), ("d_model", "ssm_inner")),
        "wB": AxSpec((d, gn), ("d_model", None)),
        "wC": AxSpec((d, gn), ("d_model", None)),
        "wdt": AxSpec((d, h), ("d_model", "heads")),
        "conv_wx": AxSpec((k, di), (None, "ssm_inner"), "normal", bf16, 0.3),
        "conv_bx": AxSpec((di,), ("ssm_inner",), "zeros"),
        "conv_wB": AxSpec((k, gn), (None, None), "normal", bf16, 0.3),
        "conv_bB": AxSpec((gn,), (None,), "zeros"),
        "conv_wC": AxSpec((k, gn), (None, None), "normal", bf16, 0.3),
        "conv_bC": AxSpec((gn,), (None,), "zeros"),
        "A_log": AxSpec((h,), ("heads",), "ones", f32),
        "dt_bias": AxSpec((h,), ("heads",), "zeros", f32),
        "D": AxSpec((h,), ("heads",), "ones", f32),
        "norm_scale": AxSpec((di,), ("ssm_inner",), "zeros", f32),
        "out_proj": AxSpec((di, d), ("ssm_inner", "d_model")),
    }


# ---------------------------------------------------------------------------
# Depthwise causal conv (separable per stream)
# ---------------------------------------------------------------------------


def _conv_full(x, w, b):
    """x: (B,S,C), w: (K,C) depthwise causal; returns silu(conv(x))."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    y = sum(pad[:, i:i + s] * w[i].to(x.dtype) for i in range(k))
    return F.silu(y + b.to(x.dtype))


def _conv_step(window, w, b):
    """window: (B,K,C), the last K raw inputs incl. the current one;
    returns (B,C)."""
    y = torch.einsum("bkc,kc->bc", window, w.to(window.dtype))
    return F.silu(y + b.to(window.dtype))


def _expand_groups(t, h):
    """(B,...,G,N) -> (B,...,H,N) by repeating each group H/G times."""
    g = t.shape[-2]
    return torch.repeat_interleave(t, h // g, dim=-2)


def _whole_heads(sc: SSMConfig, d: int, p):
    """``p`` with its per-head leaves whole where the planner cut them by
    "heads" over "model": the four stacked as rows of one fp32 (d + 3,
    heads) block, gathered over "model" in one all_gather, and split
    back into their dtypes."""
    h = sc.n_heads(d)
    if p["A_log"].shape[-1] == h:
        return p
    rows = torch.cat([p["wdt"].float()] + [p[name].float()[None]
                                           for name in _HEAD_LEAVES[1:]])
    rows = collectives.model_gather(rows, dim=-1)
    wdt, *rest = rows.split([d, 1, 1, 1])
    return dict(p, wdt=wdt.to(p["wdt"].dtype),
                **{name: t[0] for name, t in zip(_HEAD_LEAVES[1:], rest)})


def _projections(u, p):
    """z, x, B, C and dt streams of u (B,S,D), in u's dtype."""
    return tuple(u @ p[name].to(u.dtype)
                 for name in ("wz", "wx", "wB", "wC", "wdt"))


def _gated_out(cfg: ModelConfig, p, y, z, dtype):
    """Gated RMSNorm, then the out projection."""
    y = rms_norm((y * F.silu(z.float())).to(dtype), p["norm_scale"],
                 cfg.norm_eps)
    return y @ p["out_proj"].to(dtype)


# ---------------------------------------------------------------------------
# Full-sequence chunked SSD
# ---------------------------------------------------------------------------


def check_prefill_len(sc: SSMConfig, s: int):
    """A prompt whose SSD state is kept must fill whole chunks (or be one
    chunk at most): the trailing zero-pad of a last partial chunk would
    pollute the state. The reference raises the same ValueError."""
    q = min(sc.chunk, s)
    if s % q:
        raise ValueError(f"prefill seq {s} must be divisible by ssd chunk "
                         f"{q}")


def ssm_forward(cfg: ModelConfig, sc: SSMConfig, p, u, *,
                return_state: bool = False):
    """u: (B,S,D) -> (B,S,D); with ``return_state`` also the decode cache
    leaves after the last position."""
    b, s_orig, d = u.shape
    p = _whole_heads(sc, d, p)
    di = sc.d_inner(d)
    h = sc.n_heads(d)
    hp = sc.head_dim
    n = sc.d_state
    q = min(sc.chunk, s_orig)
    # causal: a trailing zero-pad up to a chunk multiple never changes the
    # outputs at real positions (it does pollute the final state, so the
    # prefill path, which needs the state, requires divisibility)
    pad_s = (-s_orig) % q
    if return_state:
        check_prefill_len(sc, s_orig)
    if pad_s:
        u = F.pad(u, (0, 0, 0, pad_s))
    s = s_orig + pad_s
    nc = s // q

    z, x_raw, b_raw, c_raw, dt = _projections(u, p)
    x = _conv_full(x_raw, p["conv_wx"], p["conv_bx"])
    bm = _conv_full(b_raw, p["conv_wB"], p["conv_bB"])
    cm = _conv_full(c_raw, p["conv_wC"], p["conv_bC"])

    xh = x.reshape(b, s, h, hp).float()
    bh = _expand_groups(bm.reshape(b, s, sc.n_groups, n), h).float()
    ch = _expand_groups(cm.reshape(b, s, sc.n_groups, n), h).float()
    dtp = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["A_log"])  # (H,) negative

    xh = xh.reshape(b, nc, q, h, hp)
    bh = bh.reshape(b, nc, q, h, n)
    ch = ch.reshape(b, nc, q, h, n)
    dtc = dtp.reshape(b, nc, q, h)

    cum = cumsum(dtc * a, dim=2)  # (B,Nc,Q,H)
    cum_t = cum.permute(0, 3, 1, 2)     # (B,H,Nc,Q)

    # intra-chunk (quadratic within a chunk); the decay exponent is masked
    # BEFORE exp: above the diagonal it is positive and, over a long
    # chunk, overflows to inf, whose masked-out grad is then 0 x inf = NaN
    # (the reference exponentiates first: ROADMAP Queue 3)
    att = torch.einsum("bzihn,bzjhn->bhzij", ch, bh)  # (B,H,Nc,Q,Q)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=u.device))
    seg = torch.exp(torch.where(
        mask, cum_t[..., :, None] - cum_t[..., None, :], float("-inf")))
    m = torch.where(mask, att * seg, 0.0)
    m = m * dtc.permute(0, 3, 1, 2)[..., None, :]  # x dt_j
    y_diag = torch.einsum("bhzij,bzjhp->bzihp", m, xh)

    # each chunk's state contribution
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,Nc,Q,H)
    sz = torch.einsum("bzjh,bzjhp,bzjhn->bzhpn", decay_end * dtc, xh, bh)

    # inter-chunk recurrence, sequential over chunks
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,Nc,H)
    state = torch.zeros((b, h, hp, n), dtype=torch.float32, device=u.device)
    states_prev = []
    for zc in range(nc):
        states_prev.append(state)  # the state BEFORE chunk zc
        state = chunk_decay[:, zc, :, None, None] * state + sz[:, zc]
    states_prev = torch.stack(states_prev, 1)  # (B,Nc,H,P,N)

    y_off = torch.einsum("bzihn,bzhpn->bzihp", ch, states_prev) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, hp) \
        + xh.reshape(b, s, h, hp) * p["D"][:, None]
    out = _gated_out(cfg, p, y.reshape(b, s, di), z, u.dtype)
    if pad_s:
        out = out[:, :s_orig]
    if not return_state:
        return out
    k = sc.d_conv
    cache = {
        "conv_x": x_raw[:, s - (k - 1):].to(torch.bfloat16),
        "conv_B": b_raw[:, s - (k - 1):].to(torch.bfloat16),
        "conv_C": c_raw[:, s - (k - 1):].to(torch.bfloat16),
        "state": state,
    }
    return out, cache


# ---------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------


def ssm_decode(cfg: ModelConfig, sc: SSMConfig, p, u, cache):
    """u: (B,1,D); cache: conv_x/B/C (B,K-1,.), state (B,H,P,N). Returns
    (out (B,1,D), new cache leaves); ``cache`` is not written."""
    b, _, d = u.shape
    p = _whole_heads(sc, d, p)
    di = sc.d_inner(d)
    h = sc.n_heads(d)
    hp = sc.head_dim
    n = sc.d_state
    z, x_raw, b_raw, c_raw, dt = (t[:, 0] for t in _projections(u, p))

    def upd(cc, raw, w, bias):
        win = torch.cat([cc.to(raw.dtype), raw[:, None]], dim=1)
        return _conv_step(win, w, bias), win[:, 1:].to(cc.dtype)

    x, conv_x = upd(cache["conv_x"], x_raw, p["conv_wx"], p["conv_bx"])
    bm, conv_b = upd(cache["conv_B"], b_raw, p["conv_wB"], p["conv_bB"])
    cm, conv_c = upd(cache["conv_C"], c_raw, p["conv_wC"], p["conv_bC"])

    xh = x.reshape(b, h, hp).float()
    bh = _expand_groups(bm.reshape(b, sc.n_groups, n), h).float()
    ch = _expand_groups(cm.reshape(b, sc.n_groups, n), h).float()
    dtp = F.softplus(dt.float() + p["dt_bias"])  # (B,H)
    a = -torch.exp(p["A_log"])

    decay = torch.exp(dtp * a)  # (B,H)
    state = cache["state"] * decay[..., None, None] + \
        torch.einsum("bh,bhp,bhn->bhpn", dtp, xh, bh)
    y = torch.einsum("bhpn,bhn->bhp", state, ch) + xh * p["D"][:, None]
    out = _gated_out(cfg, p, y.reshape(b, di), z, u.dtype)[:, None]
    return out, {"conv_x": conv_x, "conv_B": conv_b, "conv_C": conv_c,
                 "state": state}


def ssm_cache(cfg: ModelConfig, sc: SSMConfig, batch: int, device="cuda"):
    """One layer's zeroed decode-cache leaves on ``device``: the last K - 1
    raw conv inputs of each stream (bf16) and the SSD state (fp32)."""
    d = cfg.d_model
    gn = sc.n_groups * sc.d_state
    k = sc.d_conv
    shapes = {"conv_x": ((batch, k - 1, sc.d_inner(d)), torch.bfloat16),
              "conv_B": ((batch, k - 1, gn), torch.bfloat16),
              "conv_C": ((batch, k - 1, gn), torch.bfloat16),
              "state": ((batch, sc.n_heads(d), sc.head_dim, sc.d_state),
                        torch.float32)}
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in shapes.items()}


def ssm_cache_specs(cfg: ModelConfig, sc: SSMConfig, batch: int):
    """One layer's decode-cache leaves on the meta device (no allocation)."""
    return ssm_cache(cfg, sc, batch, device="meta")


# ---------------------------------------------------------------------------
# Naive sequential reference (oracle for tests)
# ---------------------------------------------------------------------------


def ssm_forward_naive(cfg: ModelConfig, sc: SSMConfig, p, u):
    """Token-by-token recurrence, the test oracle for ``ssm_forward``."""
    cache = ssm_cache(cfg, sc, u.shape[0], device=u.device)
    outs = []
    for i in range(u.shape[1]):
        o, cache = ssm_decode(cfg, sc, p, u[:, i:i + 1], cache)
        outs.append(o)
    return torch.cat(outs, dim=1)
