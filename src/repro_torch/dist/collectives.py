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
through the host for these; NCCL takes it as it is, and so does the
compile-only dry run's "fake" backend (``launch.dryrun``: fake CPU
tensors, no staging and no CUDA IPC), whose trace then shows the
collectives of an NCCL layout of one rank per card.

Under autograd (a train step) each carries its conjugate as its backward
(Megatron's f and g): :func:`model_copy` (the identity, whose backward
sums the grad over "model") enters a split region and :func:`model_sum`
(whose backward is the identity) leaves it; a gather's backward keeps
the rank's block; :func:`data_sum` sums a statistic over the data axes
with the identity as its backward.

ZeRO-3 ("fsdp", "fsdp_tp"): :func:`param_gather` makes a unit's leaves
(a layer, the embedding, the head) usable where the layout cuts them
over the data axes, one all_gather per set of (axes, dtype); its
backward sums each grad over those ranks and keeps the rank's block (a
reduce-scatter). Ranks sharing one card move these shards through CUDA
IPC (:class:`_CardLine`), as gloo's loopback is too slow for weights.
:func:`whole` gathers a leaf whole (checkpoints), :func:`sum_over` sums
tensors over any line of axes.

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
from torch.multiprocessing.reductions import reduce_tensor

from repro_torch.dist import context as ctx
from repro_torch.dist.sharding import Sharding
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partials_ref, row_lengths)
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

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


def _index(axis) -> int:
    """This rank's block index along ``axis`` ("model" or "data")."""
    mesh = ctx.get_mesh()
    return mesh.coord("model") if axis == "model" else ctx.dp_index(mesh)


class _Conjugate(torch.autograd.Function):
    """``fwd(x)`` in the forward pass and ``bwd(grad)`` in the backward:
    a collective and its conjugate (Megatron's f and g)."""

    @staticmethod
    def forward(ctx_, x, fwd, bwd):
        ctx_.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx_, grad):
        return ctx_.bwd(grad.contiguous()), None, None


def _conjugate(x, fwd, bwd):
    """``fwd(x)``, with ``bwd`` as its backward where autograd records
    ``x``; plain ``fwd(x)`` elsewhere (serving)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Conjugate.apply(x, fwd, bwd)
    return fwd(x)


def _summed(group):
    """A function of ``t``: its SUM over ``group`` in fp32, returned in
    ``t``'s dtype (one counted all_reduce)."""
    def total(t):
        def run(u):
            u = u.float().contiguous()
            torch.distributed.all_reduce(u, group=group)
            return u
        return _counted("all_reduce", lambda u: _staged(run, u, group),
                        t).to(t.dtype)
    return total


def model_sum(x):
    """Sum of ``x`` over the "model" axis (the identity on one rank): the
    all_reduce after a row-split matmul. Summed in fp32 and returned in
    ``x``'s dtype. Its backward is the identity: the grad of a sum every
    rank holds whole is every rank's."""
    line = _line("model")
    if line is None:
        return x
    return _conjugate(x, _summed(line[0]), lambda g: g)


def model_copy(x):
    """``x`` as it is, entering a region split over "model" (a
    column-split matmul, a rank's heads or experts); its backward sums
    the grad over "model", since each rank's grad holds only its own
    block's share. The identity on one rank and outside autograd."""
    line = _line("model")
    if line is None:
        return x
    return _conjugate(x, lambda t: t, _summed(line[0]))


def data_sum(x):
    """Sum of ``x`` over the data axes, with the identity as its
    backward: for a statistic every data shard adds its rows to (the MoE
    load-balancing loss's counts and probability sums) whose result each
    rank's loss holds once, the grads summed over the data axes after the
    backward pass then count every row once."""
    line = _line("data")
    if line is None:
        return x
    return _conjugate(x, _summed(line[0]), lambda g: g)


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

    at = _index(axis) * x.shape[dim]  # read here: autograd runs a CUDA
    # backward on a thread of its own, without this one's mesh

    def mine(g):  # the grad of this rank's block
        return g.narrow(dim, at, x.shape[dim])
    return _conjugate(
        x, lambda t: _counted(kind, lambda u: _staged(run, u, group), t),
        mine)


def model_gather(x, dim: int = -1):
    """The "model" ranks' blocks of ``x`` concatenated along ``dim`` in
    rank order (``x`` on one rank); the backward keeps this rank's block
    of the grad."""
    return _gather(x, dim, "model", "all_gather_model")


def data_gather(x, dim: int = 0):
    """The data shards' rows of ``x`` concatenated along ``dim`` in shard
    order (``x`` without a data axis); the backward keeps this rank's
    rows of the grad."""
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


# ---------------------------------------------------------------------------
# Params cut over the data axes (ZeRO-3)
# ---------------------------------------------------------------------------


def _group_of(mesh, axes):
    group = mesh.group(axes)
    if group is None:
        raise ValueError(f"{mesh} has no process group on {axes}")
    return group


def line_size(mesh, axes) -> int:
    """Ranks along the line of ``axes`` taken together."""
    return int(np.prod([mesh.shape[a] for a in ctx.line_axes(mesh, axes)]
                       or [1]))


class _CardLine:
    """The ranks of one process group that share ONE card (gloo, where
    NCCL refuses them): each rank's device buffer is mapped into every
    rank of the group through CUDA IPC once, so a gather or a
    reduce-scatter reads the peers' memory in place on the card instead
    of staging through the host (gloo moves a layer's 0.1 GB at about 0.5
    GB/s on loopback). Each buffer has two slots used in turn: a rank
    writes its slot, waits for its copy, and meets the others at a gloo
    barrier; it then reads every rank's slot. A rank reaches the next
    barrier only after its reads ran (the device is synchronised first),
    so a slot is written again only when every rank has read it."""

    def __init__(self, group, device):
        self.group, self.device = group, device
        self.me = torch.distributed.get_rank(group)
        self.n = torch.distributed.get_world_size(group)
        self.cap, self.slot, self.mine, self.bufs = 0, 0, None, None

    def _grow(self, nbytes: int):
        # every rank moves the same payload, so every rank grows here, to
        # the payload rounded up to 16 MiB (the card is shared: no slack)
        self.cap = -(-nbytes // 2 ** 24) * 2 ** 24
        self.mine = self.bufs = None
        self.mine = torch.empty(2 * self.cap, dtype=torch.uint8,
                                device=self.device)
        handles = [None] * self.n
        torch.distributed.all_gather_object(
            handles, reduce_tensor(self.mine), group=self.group)
        self.bufs = [self.mine if i == self.me else fn(*args)
                     for i, (fn, args) in enumerate(handles)]

    def exchange(self, t) -> list:
        """Every rank's ``t`` (same shape everywhere), as views of their
        slots, in group rank order."""
        nbytes = t.numel() * t.element_size()
        if nbytes > self.cap:
            self._grow(nbytes)
        off = self.slot * self.cap
        self.slot ^= 1

        def view(buf):
            return buf[off:off + nbytes].view(t.dtype).view(t.shape)
        view(self.mine).copy_(t)
        torch.cuda.synchronize(self.device)
        torch.distributed.barrier(group=self.group)
        return [view(b) for b in self.bufs]


# by the group's ranks: every mesh built over the same ranks (one a job)
# shares one line and its buffers
_CARD_LINES: Dict[tuple, _CardLine] = {}


def _card_line(group, t):
    """The :class:`_CardLine` of ``group``'s ranks where ``t`` lies on a
    card they share (a CUDA tensor under gloo); None elsewhere (the CPU,
    or NCCL)."""
    if t.device.type != "cuda" or \
            torch.distributed.get_backend(group) != "gloo":
        return None
    key = tuple(torch.distributed.get_process_group_ranks(group))
    line = _CARD_LINES.get(key)
    if line is None:
        line = _CARD_LINES[key] = _CardLine(group, t.device)
    return line


def _reduce_scatter(g, group, index: int, n: int):
    """Row ``index`` of the SUM of ``g`` (n, L) over ``group``, summed in
    fp32: NCCL's reduce_scatter (also under the dry run's "fake" backend,
    which traces what NCCL ranks run); on a shared card, the peers' rows
    read in place; on the CPU, gloo's all_reduce and the rank's row (gloo
    has no reduce_scatter)."""
    def run(t):
        t = t.contiguous()
        line = _card_line(group, t)
        if line is not None:
            return sum(p[index].float() for p in line.exchange(t)
                       ).to(g.dtype)
        t = t.float()
        if torch.distributed.get_backend(group) in ("nccl", "fake"):
            out = torch.empty_like(t[0])
            torch.distributed.reduce_scatter_tensor(out, t, group=group)
            return out.to(g.dtype)
        torch.distributed.all_reduce(t, group=group)
        return t[index].to(g.dtype)
    return _counted("reduce_scatter_param", run, g)


def _gather_flat(flat, axes):
    """(n, L): every rank's ``flat`` (L,) along the line of ``axes``, in
    block order; the backward sums the grad over the line and keeps this
    rank's row (a reduce-scatter)."""
    mesh = ctx.get_mesh()
    group, n = _group_of(mesh, axes), line_size(mesh, axes)
    index = ctx.line_index(mesh, axes)

    def run(t):
        t = t.contiguous()
        line = _card_line(group, t)
        if line is not None:
            return torch.stack(line.exchange(t))
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        if torch.distributed.get_backend(group) == "gloo":
            torch.distributed.all_gather(list(out.unbind(0)), t,
                                         group=group)
        else:  # one buffer: NCCL, and the dry run's "fake" backend
            torch.distributed.all_gather_into_tensor(out, t, group=group)
        return out
    return _conjugate(
        flat, lambda t: _counted("all_gather_param", run, t),
        lambda g: _reduce_scatter(g, group, index, n))


def param_gather(tree, shardings):
    """The usable params of one unit (a layer's leaves, the embedding):
    every leaf of ``tree`` whose ``Sharding`` has a ZeRO dim is gathered
    whole along it over its ZeRO axes, the rest kept as they are (whole,
    or this rank's "model" block). The leaves cut over the same axes with
    the same dtype travel in ONE all_gather, packed flat. Under autograd
    the backward sums each leaf's grad over those ranks and keeps this
    rank's block: the grad comes out cut as the leaf is."""
    flat = list(tree_leaves_with_path(tree))
    cuts = dict(tree_leaves_with_path(
        shardings, lambda x: isinstance(x, Sharding)))
    out, packs = {}, {}
    for path, t in flat:
        sh = cuts.get(path)
        if sh is None or not sh.zero:
            out[path] = t
            continue
        packs.setdefault((sh.zero_axes, t.dtype), []).append(
            (path, t, sh.zero[0]))
    for (axes, _), items in packs.items():
        rows = _gather_flat(torch.cat([t.reshape(-1) for _, t, _ in items]),
                            axes)
        at = 0
        for path, t, dim in items:
            # the n blocks concatenated along ``dim``, in block order
            shape = list(t.shape)
            blocks = rows[:, at:at + t.numel()].reshape(
                [rows.shape[0]] + shape).movedim(0, dim)
            shape[dim] *= rows.shape[0]
            out[path] = blocks.reshape(shape)
            at += t.numel()
    return tree_map_with_path(lambda p, _: out[p], tree)


def gathered(sub, *path):
    """``sub``, the params at ``path`` of the whole tree (a leaf or a
    subtree), ready to use: gathered by :func:`param_gather` where the
    ambient ``dist.context.param_layout`` cuts it over the data axes, as
    it is otherwise. The model code calls this at the head of each unit
    (a layer, the embedding, the head), so outside autograd at most one
    unit's gathered leaves live at a time."""
    layout = ctx.get_param_layout()
    if layout is None:
        return sub
    for key in path:
        layout = layout[key]
    return param_gather(sub, layout)


def whole(t, sharding):
    """The whole tensor of which ``t`` is this rank's block as
    ``sharding`` cuts it (every cut dim gathered over its axes, ZeRO and
    "model" alike): the ranks of each cut's line all take part. For a
    checkpoint, outside autograd."""
    for dim, cut in enumerate(sharding.cuts):
        if cut is None:
            continue
        rows = _gather_flat(t.detach().reshape(-1), cut[0])
        t = torch.cat(rows.reshape((rows.shape[0],) + tuple(t.shape))
                      .unbind(0), dim=dim)
    return t


def sum_over(tensors, axes):
    """Each of ``tensors`` summed over the line of ``axes`` (the grads of
    leaves whole over a batch axis), packed per dtype into one all_reduce
    in fp32; the tensors themselves where the line holds one rank."""
    mesh = ctx.get_mesh()
    if not tensors or line_size(mesh, axes) <= 1:
        return list(tensors)
    total = _summed(_group_of(mesh, axes))
    flat = total(torch.cat([t.reshape(-1).float() for t in tensors]))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t).to(t.dtype))
        at += t.numel()
    return out


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
