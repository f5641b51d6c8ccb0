"""Distribution subsystem: mesh context, the sharding planner, and the
collectives of tensor-parallel params, a data axis and sequence-sharded
decode (counterpart of ``repro.dist``). Importing it starts nothing:
process groups come from ``launch.mesh``."""
from repro_torch.dist import collectives, context, sharding  # noqa: F401
from repro_torch.dist.collectives import (  # noqa: F401
    seq_sharded_decode, seq_sharded_write_decode, set_fused_partials)
from repro_torch.dist.context import (  # noqa: F401
    Mesh, axis_size, dp_axes, get_mesh, mesh_context, set_batch_axes)
from repro_torch.dist.sharding import (  # noqa: F401
    param_shardings, param_specs_tree, pick_strategy, seq_blocks)
