"""Icosphere patch geometry (numpy)."""

from surface_vision_transformers_tpu_torch.geometry.tables import (
    PatchTable,
    load_patch_table,
    num_vertices,
    patch_grid,
)

__all__ = ["PatchTable", "load_patch_table", "num_vertices", "patch_grid"]
