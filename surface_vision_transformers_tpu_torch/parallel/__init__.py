"""Data, fully sharded and tensor parallelism over torch.distributed
(counterpart of ``surface_vision_transformers_tpu.parallel``): the
('data', 'fsdp', 'model') mesh, its placement rules and the per-rank feed
(``mesh``), multi-process start-up (``multihost``), tensor parallelism
(``tp``) and a model's training state on a mesh (``sharding``). The GPipe
schedule (``tpu.mesh_pipe``) and sequence sharding (``tpu.seq_sharding``)
are not ported yet.
"""

from surface_vision_transformers_tpu_torch.parallel.mesh import (
    AXES,
    Layout,
    Rows,
    batch_axes,
    make_mesh,
    mesh_from_config,
    mesh_shape,
    param_placement,
)
from surface_vision_transformers_tpu_torch.parallel.multihost import (
    initialize_multihost,
    is_primary,
    local_rows,
    process_local_slice,
)

__all__ = [
    "AXES",
    "Layout",
    "Rows",
    "batch_axes",
    "make_mesh",
    "mesh_from_config",
    "mesh_shape",
    "param_placement",
    "initialize_multihost",
    "is_primary",
    "local_rows",
    "process_local_slice",
]
