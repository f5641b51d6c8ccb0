"""DistilBERT as the benchmark's ``distilbert-imdb`` cell runs it, in plain
float32 PyTorch: learned positions, LayerNorm, bidirectional multi-head
attention, a GELU MLP and a classification head on the [CLS] state.

Source: https://huggingface.co/distilbert/distilbert-base-uncased (6
layers, dim 768, 12 heads, hidden_dim 3072, vocab 30522, 512 positions)
plus the paper's 2-way sentiment head. Departures from the source, each
one the port's (``src/repro_torch/models``), which this file follows so
that the two compute the same function:

- the blocks are pre-LayerNorm (``x + attn(LN1(x))``, ``x + mlp(LN2(x))``)
  where DistilBERT normalises after each residual sum;
- no LayerNorm on the embeddings, and one final LayerNorm before the head;
- the head is one ``dim x num_labels`` matrix on the [CLS] (position 0)
  state, without DistilBERT's ``pre_classifier`` and ReLU;
- no dropout (inference).

Weights are the benchmark's tree (the port's leaf layout, read here by
name): ``wq``/``wk``/``wv`` are (dim, heads, head_dim), ``wo`` (heads,
head_dim, dim), ``w1`` (dim, hidden), ``w2`` (hidden, dim).
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.lowp import Precision


def layer_norm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"].float() \
        + p["bias"].float()


def encoder_logits(w, tokens: torch.Tensor, cfg: dict,
                   prec: Precision = None, block: int = 32,
                   state: bool = False):
    """tokens (B, S) int -> (B, num_labels) float32 logits, ``block``
    rows at a time; with ``state`` also the (B, dim) normed [CLS] state
    the head reads."""
    prec = prec or Precision()
    parts = [_block(w, tokens[i:i + block].long(), cfg, prec)
             for i in range(0, tokens.shape[0], block)]
    logits = torch.cat([p[0] for p in parts])
    return (logits, torch.cat([p[1] for p in parts])) if state else logits


def _block(w, tokens, cfg, prec):
    eps = cfg["layer_norm_eps"]
    heads = cfg["n_heads"]
    b, s = tokens.shape
    x = w["embed"].float()[tokens] + w["pos_embed"].float()[:s][None]
    for blk in w["blocks"]:
        a, m = blk["attn"], blk["mlp"]
        hd = a["wq"].shape[-1]
        h = layer_norm(x, blk["norm1"], eps)

        def proj(name, bias):
            y = prec.mm(h, prec.weight(a[name].reshape(a[name].shape[0], -1)))
            y = y + a[bias].float().reshape(-1)
            return y.reshape(b, s, heads, hd).transpose(1, 2)  # (B, H, S, hd)
        q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
        scores = prec.mm2(q, k.transpose(-1, -2)) / math.sqrt(hd)
        o = prec.mm2(torch.softmax(scores, dim=-1), v)
        o = o.transpose(1, 2).reshape(b, s, heads * hd)
        x = x + prec.mm(o, prec.weight(a["wo"].reshape(heads * hd, -1))) \
            + a["bo"].float()
        h = layer_norm(x, blk["norm2"], eps)
        f = torch.nn.functional.gelu(prec.mm(h, prec.weight(m["w1"]))
                                     + m["b1"].float())
        x = x + prec.mm(f, prec.weight(m["w2"])) + m["b2"].float()
    cls = layer_norm(x[:, 0], w["final_norm"], eps)
    return prec.mm(cls, prec.weight(w["cls_head"])), cls
