"""Sequence-sharded decode attention, the tensor-parallel and data-axis
collectives, and the compressed gradient sum.

Counterpart of ``repro.dist.collectives``: ``seq_sharded_decode`` and
``seq_sharded_write_decode`` for serving, ``compress_psum`` for training
(the "pod" reduction of ``training.train_step``). Where the reference's
GSPMD partitioner inserts collectives for tensor-parallel params and a
batch cut over the data axes, the port calls them itself:
:func:`model_sum` (the SUM all_reduce after a row-split matmul),
:func:`model_gather` (vocab- or expert-split outputs made whole),
:func:`data_gather` (every data shard's rows) and :func:`data_broadcast`
(one data shard's result to all). Each counts its calls, and times them
when :func:`set_timing` is on (``STATS``, read by the card's smoke run).
Under gloo (ranks sharing a card, or the CPU) a CUDA tensor is staged
through the host for these; NCCL takes it as it is.

Sequence-sharded decode: each rank holds one block of the KV cache's
SEQUENCE dim, (B, S/M, KV, hd) for M ranks on "model",
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

import time
from typing import Dict, List, Optional

import numpy as np
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


# per call kind: [calls, seconds] (seconds only while timing is on)
STATS: Dict[str, List[float]] = {}
_TIMING = False


def reset_stats():
    """Zero every call count and time."""
    STATS.clear()


def set_timing(enabled: bool):
    """Time each collective (the device synchronised around it) into
    ``STATS``; off by default, since the synchronisation costs."""
    global _TIMING
    _TIMING = bool(enabled)


def _counted(kind: str, fn, t):
    """Run ``fn(t)``, counting it under ``kind`` (and timing it)."""
    entry = STATS.setdefault(kind, [0, 0.0])
    entry[0] += 1
    if not _TIMING:
        return fn(t)
    cuda = t.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn(t)
    if cuda:
        torch.cuda.synchronize(t.device)
    entry[1] += time.perf_counter() - t0
    return out


def _staged(fn, t, group):
    """``fn(t)`` on the host under gloo when ``t`` is a CUDA tensor (the
    result moved back), else on ``t`` as it is."""
    if (t.device.type == "cuda"
            and torch.distributed.get_backend(group) == "gloo"):
        return fn(t.cpu()).to(t.device)
    return fn(t)


def _all_reduce(t, op, group):
    """One all_reduce (a seam the smoke run times through)."""
    def run(t):
        torch.distributed.all_reduce(t, op=op, group=group)
        return t
    return _counted("all_reduce", run, t)


def _line(axis):
    """(group, size) of this rank's line along ``axis`` ("model" or the
    data axes, "data"), or None when it holds one rank."""
    mesh = ctx.get_mesh()
    if axis == "model":
        if ctx.axis_size("model", mesh) <= 1:
            return None
        group = mesh.group("model")
        if group is None:
            raise ValueError(f"{mesh} has no process group on 'model'")
        return group, ctx.axis_size("model", mesh)
    if ctx.dp_size(mesh) <= 1:
        return None
    return ctx.dp_group(mesh), ctx.dp_size(mesh)


def model_sum(x):
    """Sum of ``x`` over the "model" axis (the identity on one rank): the
    all_reduce after a row-split matmul. Summed in fp32 and returned in
    ``x``'s dtype."""
    line = _line("model")
    if line is None:
        return x
    group = line[0]

    def run(t):
        t = t.float().contiguous()
        torch.distributed.all_reduce(t, group=group)
        return t
    return _counted("all_reduce", lambda t: _staged(run, t, group),
                    x).to(x.dtype)


def _gather(x, dim: int, axis: str, kind: str):
    line = _line(axis)
    if line is None:
        return x
    group, n = line

    def run(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        torch.distributed.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)
    return _counted(kind, lambda t: _staged(run, t, group), x)


def model_gather(x, dim: int = -1):
    """The "model" ranks' blocks of ``x`` concatenated along ``dim`` in
    rank order (``x`` on one rank)."""
    return _gather(x, dim, "model", "all_gather_model")


def data_gather(x, dim: int = 0):
    """The data shards' rows of ``x`` concatenated along ``dim`` in shard
    order (``x`` without a data axis)."""
    return _gather(x, dim, "data", "all_gather_data")


def data_broadcast(x, src_index: int):
    """``x`` as data shard ``src_index`` holds it, on every data shard of
    this rank's line (same shape and dtype everywhere)."""
    line = _line("data")
    if line is None:
        return x
    group = line[0]
    mesh = ctx.get_mesh()
    src = mesh.rank_at(**dict(zip(
        ctx.dp_axes(mesh), np.unravel_index(src_index, [
            ctx.axis_size(a, mesh) for a in ctx.dp_axes(mesh)]))))

    def run(t):
        t = t.contiguous()
        torch.distributed.broadcast(t, src=src, group=group)
        return t
    return _counted("broadcast", lambda t: _staged(run, t, group), x)


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
