"""Icosphere patch geometry (numpy)."""

from surface_vision_transformers_tpu_torch.geometry.icosphere import (
    num_vertices,
    patch_grid,
)
from surface_vision_transformers_tpu_torch.geometry.tables import (
    PatchTable,
    load_patch_table,
    read_reference_csv,
)

__all__ = ["PatchTable", "load_patch_table", "num_vertices", "patch_grid",
           "read_reference_csv"]
