"""Sharding planner: logical param axes -> mesh partition specs -> the
slice of every tensor that this rank holds.

Counterpart of ``repro.dist.sharding``. The planner is the reference's,
rule for rule, as pure functions on ``AxSpec`` trees and the port's
``dist.context.Mesh``:

  * "tp"      — tensor parallel only: one TP-natural dim per tensor over
                the "model" axis (the Megatron layout); params replicated
                over the data axes. The serving default.
  * "fsdp"    — ZeRO-3: each tensor's largest dim over EVERY mesh axis.
  * "fsdp_tp" — "tp" plus a second dim over the data axes.

Every spec passes through :func:`sanitize_spec`, so an axis that does not
exist or does not divide its dim is dropped. Where the reference hands a
spec to GSPMD (``NamedSharding``), the port turns it into this rank's
slice (:class:`Sharding`: per dim, the (axes, index, count) cut) and the
model code computes on the slices (``models.attention``, ``models.mlp``,
``models.moe``, ``models.transformer``), with explicit collectives
(``dist.collectives``) where the reference's partitioner inserts them.

The reference stacks the layers of each pattern position into one leaf
with a leading "layers" dim that is never sharded; the port's leaves are
per layer, so a port leaf's spec is the reference's without its first
entry.

:func:`seq_blocks` is the rule of ``cache_shardings(seq_shard=True)`` for
the sequence dim, the one place the port decides it: ``serving.Engine``
allocates and prefills each rank's block by it, and
``models.convert.cache_from_reference`` cuts a reference cache by it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.dist import context as ctx
from repro_torch.models.common import param_bytes, tree_map_spec
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

# logical axes eligible for tensor parallelism, in priority order
TP_CANDIDATES = ("experts", "d_ff", "heads", "kv_heads", "vocab")
# never shard these: "layers" is the reference's stacked dim, "head_dim"
# is tiny
_NEVER_SHARD = ("layers", "head_dim")

HBM_BYTES = 80 * 10 ** 9          # one NVIDIA H100 80GB
FSDP_MAX_PARAM_BYTES = 16e9       # <=8B bf16 params counts as "small"
_TRAIN_STATE_MULT = 7             # bf16 params + fp32 master/m/v, /2 bytes


class PartitionSpec(tuple):
    """One entry per tensor dim: None (whole), an axis name, or a tuple of
    axis names (the dim cut over their product). Compares equal to the
    tuple of its entries, as ``tuple(jax.sharding.PartitionSpec)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# Spec sanitation
# ---------------------------------------------------------------------------


def sanitize_spec(spec, shape, mesh) -> PartitionSpec:
    """Drop unusable axes from a spec for a tensor of ``shape``.

    Guarantees about the returned spec:
      * every named axis exists on ``mesh``,
      * no axis is used twice,
      * for each dim the kept axes' combined size divides the dim
        (axes are considered left-to-right; a non-dividing axis is
        skipped, later axes may still apply),
      * length equals ``len(shape)`` (short specs pad with None,
        over-long specs truncate).
    """
    entries = tuple(spec)
    if len(entries) < len(shape):
        entries = entries + (None,) * (len(shape) - len(entries))
    entries = entries[:len(shape)]
    used = set()
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        axes = e if isinstance(e, tuple) else (e,)
        kept, prod = [], 1
        for a in axes:
            if a is None or a in used or a not in mesh.shape:
                continue
            n = int(mesh.shape[a])
            if n <= 1 or dim % (prod * n):
                continue
            kept.append(a)
            prod *= n
            used.add(a)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return P(*out)


# ---------------------------------------------------------------------------
# Strategy selection
# ---------------------------------------------------------------------------


def pick_strategy(param_specs, mesh, kind: str = "train",
                  hbm_bytes: int = HBM_BYTES) -> str:
    """Choose "fsdp" / "tp" / "fsdp_tp" for an (arch, mesh, kind) cell.

    Train: small models go pure-FSDP (the optimizer state must fit
    sharded over all ranks); everything else ZeRO-3 + TP. Inference: TP
    alone when the weights fit a rank after the model-axis split (half of
    ``hbm_bytes``), else additionally sharded over the data axes.
    """
    pb = param_bytes(param_specs)
    chips = int(mesh.devices.size)
    msize = int(mesh.shape.get("model", 1))
    if kind == "train":
        state = pb * _TRAIN_STATE_MULT
        if pb <= FSDP_MAX_PARAM_BYTES and state <= 0.5 * hbm_bytes * chips:
            return "fsdp"
        return "fsdp_tp"
    if pb / max(msize, 1) <= 0.5 * hbm_bytes:
        return "tp"
    return "fsdp_tp"


# ---------------------------------------------------------------------------
# Mesh slicing (replica-per-slice serving)
# ---------------------------------------------------------------------------


# the slices of one live mesh, by (rank grid, axes, n): their process
# groups are made once, by every rank in one order
_SLICES: dict = {}


def slice_meshes(mesh, n: int):
    """Partition ``mesh`` into ``n`` disjoint sub-meshes of its ranks.

    The cut runs along the first axis whose size ``n`` divides, data axes
    first and "model" last, as the reference's. Each slice keeps all of
    the parent's axis names (the cut axis shrinks to ``size // n``).
    Where the parent has process groups (a live multi-rank mesh), every
    slice gets its own: each rank makes every slice's groups, its own
    and the others', in slice order (``launch.mesh.line_groups``: a
    ``new_group`` every rank of the world must call), once per (mesh,
    n), and keeps those of the slice it is in; a rank outside a slice
    holds a slice mesh with no coordinates and no groups. ``n == 1``
    returns ``[mesh]``; raises ``ValueError`` when no axis divides.
    """
    if n <= 0:
        raise ValueError(f"need at least one slice, got n={n}")
    if n == 1:
        return [mesh]
    names = list(mesh.axis_names)
    order = [a for a in names if a != "model"]
    if "model" in names:
        order.append("model")
    for axis in order:
        if int(mesh.shape[axis]) % n == 0:
            subs = np.split(mesh.devices, n, axis=names.index(axis))
            break
    else:
        raise ValueError(
            f"cannot cut mesh {dict(mesh.shape)} into {n} disjoint "
            f"slices: no axis size is divisible by {n}")
    if not mesh.groups:
        return [ctx.Mesh(s, names, rank=mesh.rank) for s in subs]
    key = (mesh.devices.tobytes(), mesh.devices.shape, tuple(names), n)
    if key not in _SLICES:
        from repro_torch.launch.mesh import line_groups
        _SLICES[key] = [ctx.Mesh(s, names, rank=mesh.rank,
                                 groups=line_groups(s, names))
                        for s in subs]
    return _SLICES[key]


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _spec_for(s, strategy: str, mesh) -> PartitionSpec:
    """The spec for one AxSpec leaf under ``strategy``."""
    names = list(s.axes)
    entries: list = [None] * len(names)
    msize = int(mesh.shape.get("model", 1))
    dp = tuple(a for a in mesh.axis_names if a != "model")
    dp_size = int(math.prod(mesh.shape[a] for a in dp)) if dp else 1

    if strategy in ("tp", "fsdp_tp") and msize > 1:
        # one TP-natural dim over "model"; fall through the candidate
        # list until one divides (e.g. 28 heads on a 16-wide axis -> d_ff)
        for cand in TP_CANDIDATES:
            if cand in names:
                i = names.index(cand)
                if s.shape[i] % msize == 0:
                    entries[i] = "model"
                    break

    if strategy == "fsdp":
        all_axes = tuple(mesh.axis_names)
        order = sorted((i for i in range(len(names))
                        if names[i] not in _NEVER_SHARD),
                       key=lambda i: -s.shape[i])
        for i in order:
            entries[i] = all_axes
            break
    elif strategy == "fsdp_tp" and dp and dp_size > 1:
        # ZeRO-3: largest remaining dim over the data axes
        order = sorted((i for i in range(len(names))
                        if entries[i] is None
                        and names[i] not in _NEVER_SHARD),
                       key=lambda i: -s.shape[i])
        for i in order:
            if s.shape[i] % dp_size == 0:
                entries[i] = dp if len(dp) > 1 else dp[0]
                break
    return sanitize_spec(P(*entries), s.shape, mesh)


def param_specs_tree(param_specs, strategy: str, mesh):
    """Tree of PartitionSpec mirroring an AxSpec param tree."""
    return tree_map_spec(lambda s: _spec_for(s, strategy, mesh), param_specs)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """This rank's slice of one tensor: the planner's ``spec`` and, per
    dim, None (whole) or the cut ``(axes, index, count)``: the dim is cut
    into ``count`` equal blocks over ``axes`` and this rank holds block
    ``index``. ``zero`` lists the dims cut over the ZeRO axes of the
    layout ("fsdp": every axis; "fsdp_tp": the data axes): the model code
    gathers those before use (``dist.collectives.param_gather``) and
    computes on the rest of the cut, the "model" split."""

    spec: PartitionSpec
    cuts: Tuple[Optional[tuple], ...]
    zero: Tuple[int, ...] = ()

    def local_shape(self, shape) -> tuple:
        return tuple(n if c is None else n // c[2]
                     for n, c in zip(shape, self.cuts))

    def slice(self, x):
        """This rank's block of ``x`` (a tensor or array of the whole
        shape): a view; callers copy it where they keep it."""
        idx = tuple(slice(None) if c is None else
                    slice(c[1] * (n // c[2]), (c[1] + 1) * (n // c[2]))
                    for n, c in zip(x.shape, self.cuts))
        return x[idx]

    @property
    def replicated(self) -> bool:
        return all(c is None for c in self.cuts)

    def axes(self, dims=None) -> tuple:
        """The mesh axes that cut ``dims`` (default every dim)."""
        dims = range(len(self.cuts)) if dims is None else dims
        return tuple(a for d in dims if self.cuts[d] is not None
                     for a in _entry_axes(self.cuts[d][0]))

    @property
    def zero_axes(self) -> tuple:
        """The axes whose ranks each hold a block of the ZeRO-cut dim."""
        return self.axes(self.zero)

    def counted_here(self, mesh) -> bool:
        """Whether this rank counts the tensor's elements in a sum over
        every rank (the grad norm): a tensor whole over an axis counts on
        that axis's coordinate 0 only, so each element counts once."""
        cut = set(self.axes())
        return all(mesh.coord(a) == 0 for a in mesh.axis_names
                   if a not in cut)


def _entry_axes(e) -> tuple:
    return e if isinstance(e, tuple) else (e,)


def zero_axes(strategy: str, mesh) -> tuple:
    """The mesh axes ``strategy`` cuts params over only to spread their
    memory (ZeRO-3), to be gathered before use: every axis for "fsdp",
    the data axes for "fsdp_tp", none for "tp"."""
    if strategy == "fsdp":
        return tuple(mesh.axis_names)
    if strategy == "fsdp_tp":
        return tuple(a for a in mesh.axis_names if a != "model")
    return ()


def rank_sharding(spec, mesh, zero=()) -> Sharding:
    """The :class:`Sharding` of ``spec`` for ``mesh``'s rank; the dims cut
    over axes of ``zero`` (:func:`zero_axes`) are its ZeRO dims. A dim cut
    over ZeRO axes and other axes at once raises, as does a cut whose axes
    run against the mesh's order (the lines' process groups rank their
    members in that order)."""
    cuts, zdims = [], []
    for d, e in enumerate(spec):
        if e is None:
            cuts.append(None)
            continue
        axes = _entry_axes(e)
        if list(axes) != [a for a in mesh.axis_names if a in axes]:
            raise ValueError(f"{spec}: axes {axes} against the mesh's "
                             f"order {mesh.axis_names}")
        inside = [a in zero for a in axes]
        if all(inside):
            zdims.append(d)
        elif any(inside):
            raise ValueError(f"{spec}: dim {d} cut over ZeRO and "
                             f"tensor-parallel axes at once")
        index, count = 0, 1
        for a in axes:
            n = int(mesh.shape[a])
            index = index * n + mesh.coord(a)
            count *= n
        cuts.append((e, index, count))
    if len(zdims) > 1:
        raise ValueError(f"{spec}: more than one dim cut over {zero}")
    return Sharding(P(*spec), tuple(cuts), tuple(zdims))


def param_shardings(param_specs, strategy: str, mesh):
    """Tree of :class:`Sharding` (this rank's slice of every leaf)
    mirroring an AxSpec param tree."""
    zero = zero_axes(strategy, mesh)
    return tree_map_spec(
        lambda s: rank_sharding(_spec_for(s, strategy, mesh), mesh, zero),
        param_specs)


def state_shardings(state_specs, mesh, strategy: str):
    """Tree of :class:`Sharding` mirroring an optimizer's state spec tree
    (``optimizer.state_specs``): the state is cut as the params are, its
    ``step`` whole."""
    zero = zero_axes(strategy, mesh)
    return tree_map(lambda p: rank_sharding(p, mesh, zero), state_specs,
                    is_leaf=lambda x: isinstance(x, PartitionSpec))


def rank_param_bytes(param_specs, strategy: str, mesh) -> int:
    """Bytes of the params one rank holds under ``strategy`` (the
    largest, where cuts leave ranks unequal: they never do, every cut
    divides its dim)."""
    def one(s):
        sh = rank_sharding(_spec_for(s, strategy, mesh), mesh)
        return math.prod(sh.local_shape(s.shape)) * s.dtype.itemsize
    return sum(tree_leaves(tree_map_spec(one, param_specs)))


def whole_over_data(shardings, batch_axes, mesh) -> dict:
    """path -> the batch axes (of size > 1) that a leaf's ZeRO cut does
    not span, for every leaf that has some: the layout leaves it whole
    over them (``sanitize_spec`` found no dim they divide, or the layout
    cuts nothing over data), so its grad is summed over them explicitly
    after the backward pass (the gather's backward sums over the rest)."""
    out = {}
    for path, sh in tree_leaves_with_path(
            shardings, lambda x: isinstance(x, Sharding)):
        axes = tuple(a for a in batch_axes if int(mesh.shape.get(a, 1)) > 1
                     and a not in sh.zero_axes)
        if axes:
            out[path] = axes
    return out


def check_layout(cfg, mesh, strategy: str, seq_shard: bool = False,
                 plan=None):
    """Raise where the port does not lay out ``cfg`` on ``mesh``: a GQA
    layout whose q-head blocks map onto no uniform group of whole kv
    heads (``models.attention.kv_group``), the q heads cut over "model"
    by ``plan`` (the planner's spec tree, default
    :func:`param_specs_tree`) while the kv heads stay whole.

    Every other layout is served: rows over any number of data axes
    (all of them or none, ``serving.Engine``), the SSM mixer whole on
    each "model" rank (its per-head leaves gathered, ``models.ssm``), the
    encoder-decoder split as the decoder-only layers are
    (``models.encdec``)."""
    from repro_torch.models import attention as attn_lib
    # "fsdp" gathers every leaf whole: "model" splits nothing there
    m = ctx.axis_size("model", mesh) if strategy != "fsdp" else 1
    if m <= 1 or seq_shard or not cfg.has_mixer("attn"):
        return
    if plan is None:
        plan = param_specs_tree(_model_specs(cfg), strategy, mesh)
    blocks = plan["blocks"] if "blocks" in plan else plan["dec_blocks"]
    attn = next(b.get("attn", b.get("self_attn")) for b in blocks
                if "attn" in b or "self_attn" in b)
    if attn["wq"][1] == "model" and attn["wk"][1] is None:
        # q heads cut over "model", kv heads whole: each block of q heads
        # must attend whole kv heads in one uniform group
        for index in range(m):
            attn_lib.kv_group(cfg, cfg.n_heads // m, index)


def _model_specs(cfg):
    from repro_torch.models import model_zoo
    return model_zoo.build(cfg).param_specs


def drop_axis(spec, axis: str) -> PartitionSpec:
    """``spec`` with ``axis`` removed from every entry."""
    out = []
    for e in spec:
        axes = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if a is not None and a != axis)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return P(*out)


# ---------------------------------------------------------------------------
# Input / cache shardings
# ---------------------------------------------------------------------------


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", np.shape(x)))


def input_shardings(inputs, mesh):
    """Batch-shard dim 0 of every input leaf over the data axes."""
    dp = ctx.dp_axes(mesh)

    def one(x):
        shape = _shape(x)
        if not shape:
            return P()
        spec = P(dp if dp else None, *([None] * (len(shape) - 1)))
        return sanitize_spec(spec, shape, mesh)

    return tree_map(one, inputs)


def rows_all_or_none(spec, mesh) -> PartitionSpec:
    """``spec`` with its first (batch) dim whole unless it is cut over
    every data axis of the mesh (those of size > 1): the port cuts a
    batch's rows over all the data axes or none (its row gathers and
    admission broadcasts span them all), where :func:`sanitize_spec`
    may keep a prefix of them (ROADMAP Queue 3, differences by
    design)."""
    if not len(spec) or spec[0] is None:
        return spec
    data = tuple(a for a in ctx.dp_axes(mesh) if ctx.axis_size(a, mesh) > 1)
    if tuple(_entry_axes(spec[0])) == data:
        return spec
    return P(None, *spec[1:])


def cache_shardings(cache, cfg, mesh, *, seq_shard: bool = False):
    """Specs for a decode cache of the whole batch (``transformer.Cache``
    or ``encdec.EncDecCache``; shapes are read, nothing is allocated).

    Attention KV leaves (B, T, KV, hd) shard batch over the data axes
    and, when ``seq_shard``, the sequence over "model"; otherwise kv_heads
    over "model" when it divides them. SSM leaves and the (B,) lengths
    shard batch only. A ``transformer.Cache`` comes back as a Cache of
    specs; any other cache as a dict of field name -> specs.
    """
    dp = ctx.dp_axes(mesh)
    dpe = dp if dp else None

    def one(x):
        n = len(_shape(x))
        if n == 0:
            return P()
        if n >= 4:
            lead = (None,) * (n - 4)
            spec = (P(*lead, dpe, "model", None, None) if seq_shard
                    else P(*lead, dpe, None, "model", None))
        else:
            spec = P(dpe)
        return sanitize_spec(spec, _shape(x), mesh)

    def batch_only(x):
        n = len(_shape(x))
        if n == 0:
            return P()
        return sanitize_spec(P(dpe, *([None] * (n - 1))), _shape(x), mesh)

    layers = getattr(cache, "layers", None)
    if layers is not None and cfg is not None and not cfg.encdec:
        out = []
        for layer, leaves in enumerate(layers):
            kv = cfg.pattern[layer % cfg.period].mixer.startswith("attn")
            out.append({name: (one if kv else batch_only)(t)
                        for name, t in leaves.items()})
        return dataclasses.replace(cache, layers=tuple(out),
                                   lengths=batch_only(cache.lengths))
    return {f.name: tree_map(lambda x: one(x) if len(_shape(x)) >= 4
                             else batch_only(x), getattr(cache, f.name))
            for f in dataclasses.fields(cache)
            if not isinstance(getattr(cache, f.name), int)}


# ---------------------------------------------------------------------------
# Sequence blocks of a seq-sharded cache
# ---------------------------------------------------------------------------


def seq_blocks(mesh, max_len: int) -> Tuple[int, int]:
    """(M, index): a ``max_len``-position cache's sequence dim is cut into
    M equal blocks over ``mesh``'s "model" axis and this rank holds block
    ``index``; (1, 0) without a mesh, on a one-rank "model" axis, or when
    the axis does not divide ``max_len`` (every rank holds the whole
    cache)."""
    if mesh is None:
        return 1, 0
    m = ctx.axis_size("model", mesh)
    if m <= 1 or max_len % m:
        return 1, 0
    return m, mesh.coord("model")
