"""Sequence-sharded decode attention, and the compressed gradient sum.

Counterpart of ``repro.dist.collectives``: ``seq_sharded_decode`` and
``seq_sharded_write_decode`` for serving, ``compress_psum`` for training
(the "pod" reduction of ``training.train_step``). Each rank holds one block of
the KV cache's SEQUENCE dim, (B, S/M, KV, hd) for M ranks on "model",
computes a flash-style partial softmax over it (the
``kernels/decode_attention`` partials kernel on CUDA tensors: running max
``m``, exp-sum ``den``, weighted values ``num``), and the ranks merge
with one ``all_reduce(MAX)`` of ``m`` and one packed ``all_reduce(SUM)``
of ``num e^{m-M}`` and ``den e^{m-M}`` (the reference's pmax and two
psums: the elementwise arithmetic is the same). The cache never gathers.
The write variant writes each row's new K/V in the rank that owns that
row's global position ``lengths[b]`` and nowhere else.

Where the reference reads the sharded array's global length, the port's
caller passes ``seq_shards``: how many blocks the sequence is cut into,
M (each rank holds its own block) or 1 (every rank holds the whole
cache: no mesh, a one-rank "model" axis, or a length M does not divide,
where the reference's planner replicates). With one shard both entry
points run the single-block math locally, as the reference's fallback
does.

No collective is caught and retried: a failed ``all_reduce`` raises out
of the decode call. The rank layout is the mesh's (``dist.context``);
``launch.mesh`` picks the backend (NCCL, or gloo where ranks share a
card).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import context as ctx
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partials_ref, row_lengths)

# None = the default (the kernel on CUDA tensors, the plain version on CPU
# tensors); True/False force the kernel wrapper or the plain version
_FUSED_OVERRIDE: Optional[bool] = None


def set_fused_partials(enabled: Optional[bool]):
    """Force the per-shard partial-softmax implementation: ``True`` the
    kernel wrapper (``ops.decode_attention_partials``, whose CPU tensors
    take the plain version), ``False`` the plain version
    (``decode_attention_partials_ref``), ``None`` the default (the
    kernel on CUDA tensors)."""
    global _FUSED_OVERRIDE
    _FUSED_OVERRIDE = enabled


def fused_partials_enabled(device=None) -> bool:
    """Whether the per-shard block runs through the kernel wrapper for
    tensors on ``device``."""
    if _FUSED_OVERRIDE is not None:
        return _FUSED_OVERRIDE
    return device is not None and torch.device(device).type == "cuda"


def _partial_decode(q, k_blk, v_blk, lengths, offset, window, cap):
    """Flash-decode partials over one cache block.

    q: (B,1,H,hd); k_blk/v_blk: (B,Sl,KV,hd); the global kv position of
    local row t is ``offset + t``; ``lengths`` (B,). Returns (num
    (B,KV,G,hd), den (B,KV,G), m (B,KV,G)), all fp32, such that attention
    over the union of blocks is ``sum(num e^{m-M}) / sum(den e^{m-M})``
    with M the max of m.
    """
    if fused_partials_enabled(q.device):
        return da_ops.decode_attention_partials(
            q[:, 0], k_blk, v_blk, lengths, offset=offset, window=window,
            softcap=cap)
    return decode_attention_partials_ref(
        q[:, 0], k_blk, v_blk, lengths, offset=offset, window=window,
        softcap=cap)


def _combine_local(q, num, den):
    """Normalise merged partials: ``num / max(den, 1e-30)``. A row with no
    visible key gives 0 (the plain dense version would average v)."""
    b, _, h, hd = q.shape
    o = num / torch.clamp(den, min=1e-30)[..., None]
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _write_at(cache, new, indices):
    """Write ``new`` (B,1,KV,hd) at each row's local position
    ``indices[b]`` iff 0 <= indices[b] < Sl, IN PLACE (rows whose position
    lives in another block, or past the cache's end, write nothing; the
    dense path instead clamps to the last position). ``indices`` is scalar
    or (B,). Returns ``cache``."""
    b, sl = cache.shape[0], cache.shape[1]
    idx = row_lengths(indices, b, cache.device).long()
    in_range = (idx >= 0) & (idx < sl)
    at = torch.clamp(idx, 0, sl - 1)
    rows = torch.arange(b, device=cache.device)
    keep = cache[rows, at]
    cache[rows, at] = torch.where(in_range[:, None, None],
                                  new[:, 0].to(cache.dtype), keep)
    return cache


def _all_reduce(t, op, group):
    """One collective over the "model" group (a seam the smoke run times
    through)."""
    torch.distributed.all_reduce(t, op=op, group=group)
    return t


def _shard_plan(mesh, seq_shards: int):
    """(model group, this rank's block index) when the sequence is cut
    into ``seq_shards`` blocks over "model", or None when every rank holds
    the whole cache."""
    msize = ctx.axis_size("model", mesh)
    if mesh is None or msize <= 1 or seq_shards == 1:
        return None
    if seq_shards != msize:
        raise ValueError(f"a cache cut into {seq_shards} sequence blocks "
                         f"does not fit a 'model' axis of {msize} ranks")
    if any(ctx.axis_size(a, mesh) > 1 for a in ctx.dp_axes(mesh)):
        raise NotImplementedError(
            "a data axis larger than 1 (batch-sharded rows across ranks) "
            "is not ported yet (ROADMAP.md Queue 1 #4.1, a data axis "
            "larger than 1)")
    group = mesh.group("model")
    if group is None:
        raise ValueError(f"{mesh} has no process group on 'model'")
    return group, mesh.coord("model")


def _merge(num, den, m, group):
    """Combine per-rank partials: M = max of m over the group, then the
    sums of ``num e^{m-M}`` and ``den e^{m-M}`` in one packed SUM."""
    m_g = _all_reduce(m.clone(), torch.distributed.ReduceOp.MAX, group)
    scale = torch.exp(m - m_g)
    packed = torch.cat([(num * scale[..., None]).reshape(-1),
                        (den * scale).reshape(-1)])
    _all_reduce(packed, torch.distributed.ReduceOp.SUM, group)
    n = num.numel()
    return packed[:n].view_as(num), packed[n:].view_as(den)


def seq_sharded_decode(q, k_cache, v_cache, lengths, *,
                       window: Optional[int] = None,
                       cap: Optional[float] = None, seq_shards: int = 1):
    """Decode attention over a sequence-sharded KV cache.

    q: (B,1,H,hd); caches: this rank's block (B,S/M,KV,hd) of a cache cut
    into ``seq_shards`` = M blocks over "model" (the whole (B,S,KV,hd)
    when 1); ``lengths`` scalar or (B,) global. Returns (B,1,H,hd), the
    same on every rank: ``decode_attention_ref`` over the whole cache,
    except that a row with no visible key gives 0.
    """
    lengths = row_lengths(lengths, q.shape[0], q.device)
    plan = _shard_plan(ctx.get_mesh(), seq_shards)
    if plan is None:
        num, den, _ = _partial_decode(q, k_cache, v_cache, lengths, 0,
                                      window, cap)
        return _combine_local(q, num, den)
    group, index = plan
    off = index * k_cache.shape[1]
    num, den, m = _partial_decode(q, k_cache, v_cache, lengths, off, window,
                                  cap)
    num, den = _merge(num, den, m, group)
    return _combine_local(q, num, den)


def seq_sharded_write_decode(q, k_new, v_new, k_cache, v_cache, lengths, *,
                             window: Optional[int] = None,
                             cap: Optional[float] = None,
                             seq_shards: int = 1):
    """Fused cache write + decode attention over a sequence-sharded cache.

    Writes k_new/v_new (B,1,KV,hd) at each row's global position
    ``lengths[b]``, in place, in the block that owns it (a position past
    the cache's end is written nowhere), then attends q over the updated
    cache (row b sees positions <= lengths[b]). Returns (out (B,1,H,hd),
    k_cache, v_cache), the caches being the blocks passed in.
    """
    lengths = row_lengths(lengths, q.shape[0], q.device)
    plan = _shard_plan(ctx.get_mesh(), seq_shards)
    if plan is None:
        _write_at(k_cache, k_new, lengths)
        _write_at(v_cache, v_new, lengths)
        num, den, _ = _partial_decode(q, k_cache, v_cache, lengths, 0,
                                      window, cap)
        return _combine_local(q, num, den), k_cache, v_cache
    group, index = plan
    off = index * k_cache.shape[1]
    _write_at(k_cache, k_new, lengths - off)
    _write_at(v_cache, v_new, lengths - off)
    num, den, m = _partial_decode(q, k_cache, v_cache, lengths, off, window,
                                  cap)
    num, den = _merge(num, den, m, group)
    return _combine_local(q, num, den), k_cache, v_cache


# ---------------------------------------------------------------------------
# Compressed gradient reduction
# ---------------------------------------------------------------------------


def _axis_group(mesh, axis: str):
    """The process group along ``axis``, or None when it has one rank
    (no mesh, no such axis, or size 1): the sum is then the identity."""
    if ctx.axis_size(axis, mesh) <= 1:
        return None
    group = mesh.group(axis)
    if group is None:
        raise ValueError(f"{mesh} has no process group on {axis!r}")
    return group


def compress_psum(x, axis_name: str, method: str, mesh=None):
    """Sum of ``x`` over the ranks of ``axis_name`` with the payload
    compressed to ``method``, on ``mesh`` (default the ambient one).

    Emulates the wire format of a compressed cross-pod gradient
    all-reduce, as the reference's: "none" sums ``x`` as is; "bf16" casts
    the payload to bf16 and sums that; "int8" quantizes against the
    amax over every rank (one extra MAX all-reduce of a scalar), rounds
    half to even and clips to +-127, sums in int32 so the accumulator
    cannot saturate, and scales back. "bf16" and "int8" return fp32; any
    other method raises ``ValueError`` before any collective.
    """
    if method not in (None, "none", "bf16", "int8"):
        raise ValueError(f"unknown grad compression method {method!r}")
    group = _axis_group(mesh if mesh is not None else ctx.get_mesh(),
                        axis_name)

    def total(t, op=torch.distributed.ReduceOp.SUM):
        return t if group is None else _all_reduce(t, op, group)

    if method in (None, "none"):
        return total(x.clone())
    if method == "bf16":
        return total(x.to(torch.bfloat16, copy=True)).to(torch.float32)
    xf = x.to(torch.float32)
    amax = total(torch.max(torch.abs(xf)), torch.distributed.ReduceOp.MAX)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return total(q.to(torch.int32)).to(torch.float32) * scale
