"""Op-stream analyzer: FLOPs, HBM bytes, collective bytes and peak live
bytes of one rank's traced program.

Counterpart of ``repro.launch.hlo_analysis``. The reference parses the
post-optimisation HLO of a compiled SPMD partition; the port runs
eagerly, so its program is the stream of aten and c10d ops that one rank
dispatches. :class:`AnalysisMode` is a ``TorchDispatchMode`` that reads
that stream (under ``launch.dryrun``'s ``FakeTensorMode``, so nothing is
computed or allocated) and fills an :class:`Analysis` with the
reference's fields:

  * ``flops``: ``torch.utils.flop_counter``'s formulas for the matmuls
    and convolutions (mm, addmm, bmm, baddbmm, convolution and its
    backward): 2·m·n·k for a matmul. Each op is counted as often as it
    runs: a layer recomputed by remat counts twice, as in the reference's
    HLO.
  * ``hbm_bytes``: every op's input and output bytes (numel x element
    size of each tensor argument and result). View ops move nothing and
    are skipped; in eager code every other op is a fusion boundary, so
    nothing is fused away. ``hbm_top`` sums them by op.
  * ``collective_bytes`` / ``collective_instances`` by type, from the
    c10d ops seen, with the reference's ring factors: all-reduce 2x;
    all-gather, reduce-scatter and all-to-all 1x (the larger of the
    input and output bytes); broadcast 1x. ``collective_by_link`` splits
    the bytes by the slowest link of the op's process group: "nvlink"
    where every rank of the group lies on one host of ``host_cards``
    consecutive ranks, "network" where the group crosses hosts.
  * ``peak_live_bytes``: the most bytes held at once by the storages the
    traced ops made, plus those of the tensors passed as ``track`` (the
    params, optimizer state, inputs and cache), each storage followed
    from its first tensor to the last one's release (weakref
    finalizers).

The reference's ``while_trips`` has no counterpart: an eager program runs
every layer, and the dry run records the layers it traced instead.

All numbers are for ONE rank, what the per-chip roofline terms need.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_DOTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
         aten.convolution_backward}

# c10d op -> the reference's collective type
COLLECTIVES = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}
_RING = {"all-reduce": 2.0}

# aten ops that move no bytes: allocation without a write, views the
# schema does not mark as views, metadata (other namespaces' ops, prim's
# device and shape queries, move none either)
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided, aten.lift_fresh,
             aten._unsafe_view, aten._local_scalar_dense}


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_instances: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    collective_by_link: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    n_dots: int = 0
    hbm_by_op: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    peak_live_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def hbm_top(self, n: int = 10) -> List[Tuple[float, str]]:
        """The ``n`` ops that move the most bytes: (bytes, op)."""
        return sorted(((b, op) for op, b in self.hbm_by_op.items()),
                      reverse=True)[:n]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    """The tensors in ``x`` (a tensor, or lists, tuples and dicts of
    them): an op's arguments nest no deeper."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return []
    return [t for item in x for t in _tensors(item)]


class _Live:
    """Bytes held by live storages: each storage counted once, from the
    first tensor seen on it to the release of the last."""

    def __init__(self):
        self.refs: Dict[int, int] = {}
        self.size: Dict[int, int] = {}
        self.now = self.peak = 0

    def add(self, t: torch.Tensor):
        key = t.untyped_storage()._cdata
        if key not in self.refs:
            self.refs[key] = 0
            self.size[key] = t.untyped_storage().nbytes()
            self.now += self.size[key]
            self.peak = max(self.peak, self.now)
        self.refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.now -= self.size.pop(key)


def _link(pg, host_cards: int) -> str:
    """"nvlink" where the ranks of process group ``pg`` (a c10d op's
    boxed argument) lie on one host of ``host_cards`` cards, else
    "network"."""
    ranks = torch.distributed.get_process_group_ranks(
        torch._C._distributed_c10d.ProcessGroup.unbox(pg))
    return "nvlink" if len({r // host_cards for r in ranks}) == 1 \
        else "network"


class AnalysisMode(TorchDispatchMode):
    """Fills ``analysis`` from every op dispatched inside; ``track``: the
    tensors alive before the trace (params, optimizer state, inputs,
    cache), counted in the live bytes from the start; ``host_cards``:
    the cards of one host (consecutive ranks)."""

    def __init__(self, analysis: Analysis, track=(), host_cards: int = 8):
        super().__init__()
        self.an = analysis
        self.host_cards = host_cards
        self.live = _Live()
        self._seen = set()
        for t in _tensors(list(track)):
            self._hold(t)

    def _hold(self, t: torch.Tensor):
        if id(t) not in self._seen:
            self._seen.add(id(t))
            weakref.finalize(t, self._seen.discard, id(t))
            self.live.add(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        an = self.an
        if func.namespace == "c10d":
            kind = COLLECTIVES.get(packet.__name__)
            if kind is not None:
                sizes = [sum(_nbytes(t) for t in _tensors(a))
                         for a in args if _tensors(a)]
                nbytes = _RING.get(kind, 1.0) * max(sizes or [0])
                an.collective_bytes[kind] += nbytes
                an.collective_instances[kind] += 1
                pg = next(a for a in args
                          if type(a).__name__ == "ScriptObject")
                an.collective_by_link[_link(pg, self.host_cards)] += nbytes
            return out
        if packet in _DOTS:
            an.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            an.n_dots += 1
        if (func.namespace == "aten" and not func.is_view
                and packet not in _NO_BYTES):
            nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(
                _nbytes(t) for t in _tensors(out))
            an.hbm_bytes += nbytes
            an.hbm_by_op[packet.__name__] += nbytes
        for t in _tensors(out):
            self._hold(t)
        an.peak_live_bytes = self.live.peak
        return out
