"""Qwen2 as the benchmark's ``qwen2-7b`` cells run it, in plain float32
PyTorch: RMSNorm, rotary positions (theta 1e6), grouped-query attention
with q/k/v biases, a SwiGLU MLP and an untied LM head.

Source: https://huggingface.co/Qwen/Qwen2-7B (28 layers, hidden 3584, 28
query and 4 key/value heads of 128, intermediate 18944, vocab 152064,
rms_norm_eps 1e-6). Departures from the source, all of layout, none of
arithmetic:

- an RMSNorm weight is stored as its offset from 1 (the port's leaf
  layout): the norm multiplies by ``1 + scale`` where the source stores
  and multiplies by the weight itself;
- rotary embeddings rotate the two halves of each head (the source's
  ``rotate_half``), with the angles computed in float32;
- no sliding window (the source's ``use_sliding_window`` is false) and no
  dropout.

Two entry points compute the same function: :func:`decoder_logits`, the
full causal forward of whole sequences (layer by layer over a block of
rows, so a 28-layer model at full width fits beside its float32 layer
weights), and :class:`Incremental`, the same forward extended one token at
a time over a cache of its own float32 keys and values.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

from perfbench.reference.lowp import Precision


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x, positions, theta):
    """x (..., S, H, hd) rotated at ``positions`` (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions.float()[:, None] * inv                  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Layer:
    """One block's weights as float32 (K, N) matrices, made once."""

    def __init__(self, blk, prec: Precision):
        a, m = blk["attn"], blk["mlp"]
        self.heads, self.hd = a["wq"].shape[1], a["wq"].shape[2]
        self.kv = a["wk"].shape[1]
        d = a["wq"].shape[0]
        self.wq = prec.weight(a["wq"].reshape(d, -1))
        self.wk = prec.weight(a["wk"].reshape(d, -1))
        self.wv = prec.weight(a["wv"].reshape(d, -1))
        self.bq = a["bq"].float().reshape(-1)
        self.bk = a["bk"].float().reshape(-1)
        self.bv = a["bv"].float().reshape(-1)
        self.wo = prec.weight(a["wo"].reshape(-1, d))
        self.w1, self.w3 = prec.weight(m["w1"]), prec.weight(m["w3"])
        self.w2 = prec.weight(m["w2"])
        self.n1, self.n2 = blk["norm1"]["scale"], blk["norm2"]["scale"]


def _attend(prec, q, k, v, q_pos, k_pos):
    """q (S, H, hd), k/v (T, KV, hd): causal GQA by absolute positions."""
    h, kv, hd = q.shape[1], k.shape[1], q.shape[2]
    g = h // kv
    k = k.repeat_interleave(g, dim=1)       # query head i reads kv head i // g
    v = v.repeat_interleave(g, dim=1)
    scores = prec.mm2(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(hd)
    mask = k_pos[None, :] <= q_pos[:, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    o = prec.mm2(torch.softmax(scores, dim=-1), v.transpose(0, 1))
    return o.transpose(0, 1).reshape(q.shape[0], h * hd)


def _block(L: _Layer, prec, x, positions, cfg, k_past=None, v_past=None,
           k_pos_past=None):
    """One layer over the rows ``x`` (S, D) at ``positions``; returns
    (x, k, v) with this call's keys and values appended to the past."""
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = rms_norm(x, L.n1, eps)
    s = x.shape[0]
    q = (prec.mm(h, L.wq) + L.bq).reshape(s, L.heads, L.hd)
    k = (prec.mm(h, L.wk) + L.bk).reshape(s, L.kv, L.hd)
    v = (prec.mm(h, L.wv) + L.bv).reshape(s, L.kv, L.hd)
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    k_pos = positions
    if k_past is not None:
        k, v = torch.cat([k_past, k]), torch.cat([v_past, v])
        k_pos = torch.cat([k_pos_past, positions])
    x = x + prec.mm(_attend(prec, q, k, v, positions, k_pos), L.wo)
    h = rms_norm(x, L.n2, eps)
    f = torch.nn.functional.silu(prec.mm(h, L.w1)) * prec.mm(h, L.w3)
    return x + prec.mm(f, L.w2), k, v, k_pos


def _head(w, prec, x, cfg):
    return prec.mm(rms_norm(x, w["final_norm"]["scale"], cfg["rms_norm_eps"]),
                   prec.weight(w["lm_head"]))


def decoder_logits(w, tokens: torch.Tensor, cfg: dict,
                   head_at: Sequence[Sequence[int]],
                   prec: Precision = None) -> List[torch.Tensor]:
    """tokens (B, T) int; returns for each row b the (len(head_at[b]), V)
    float32 logits at positions ``head_at[b]`` (the logits there predict
    the token at the next position)."""
    prec = prec or Precision()
    tokens = tokens.long()
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device)
    xs = [w["embed"].float()[tokens[i]] for i in range(b)]
    for blk in w["blocks"]:
        L = _Layer(blk, prec)
        xs = [_block(L, prec, x, positions, cfg)[0] for x in xs]
        del L
    lm = prec.weight(w["lm_head"])
    return [prec.mm(rms_norm(x[list(at)], w["final_norm"]["scale"],
                             cfg["rms_norm_eps"]), lm)
            for x, at in zip(xs, head_at)]


class Incremental:
    """The same forward extended token by token: :meth:`step` takes the
    next tokens of one sequence and returns the logits after each."""

    def __init__(self, w, cfg: dict, prec: Precision = None):
        self.w, self.cfg = w, cfg
        self.prec = prec or Precision()
        self.layers = [_Layer(blk, self.prec) for blk in w["blocks"]]
        self.past = [(None, None, None)] * len(self.layers)
        self.n = 0

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (S,) int -> (S, V) float32 logits."""
        positions = torch.arange(self.n, self.n + tokens.shape[0],
                                 device=tokens.device)
        x = self.w["embed"].float()[tokens.long()]
        for i, L in enumerate(self.layers):
            x, k, v, kp = _block(L, self.prec, x, positions, self.cfg,
                                 *self.past[i])
            self.past[i] = (k, v, kp)
        self.n += tokens.shape[0]
        return _head(self.w, self.prec, x, self.cfg)
