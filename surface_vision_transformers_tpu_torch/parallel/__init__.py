"""Data, fully sharded, tensor, sequence and pipeline parallelism over
torch.distributed (counterpart of ``surface_vision_transformers_tpu.
parallel``): the ('data', 'fsdp', 'model'[, 'pipe']) mesh, its placement
rules and the per-rank feed (``mesh``), multi-process start-up
(``multihost``), tensor parallelism by whole heads (``tp``), sequence
sharding over 'model' (``seq``, ``tpu.seq_sharding``), the GPipe schedule
over 'pipe' (``pipeline``, ``tpu.mesh_pipe``) and a model's training state
on a mesh (``sharding``).
"""

from surface_vision_transformers_tpu_torch.parallel.mesh import (
    AXES,
    PIPE,
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
    "PIPE",
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
