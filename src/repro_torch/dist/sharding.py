"""Where a sequence-sharded cache's blocks live.

The reference's planner (``repro.dist.sharding.cache_shardings(
seq_shard=True)``) puts a decode cache's sequence dim over the "model"
axis when that axis divides it, and otherwise leaves the dim whole (its
``sanitize_spec`` drops an axis that does not divide). :func:`seq_blocks`
is that rule, the one place the port decides it: ``serving.Engine``
allocates and prefills each rank's block by it, and
``models.convert.cache_from_reference`` cuts a reference cache by it.

The rest of the reference's planner (param layouts, strategies, input
specs, mesh slices) lays out tensor-parallel params and a data axis, which
the port does not have yet: every rank holds the params whole and the
data axis is 1 (ROADMAP Queue 1 #4.1, a data axis larger than 1, and
#4.2, tensor-parallel params).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.dist import context as ctx


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
