"""Patch lookup tables: (patch, within-patch vertex) -> global vertex id.

numpy counterpart of ``surface_vision_transformers_tpu.geometry.tables``,
with its search order (``load_patch_table``): an explicit path, then
``$SVT_TABLE_DIR`` and the shipped ``assets/`` for
``patch_table_ico{ico}_sub{sub_ico}.npz`` (keys ``indices`` ((num_patches,
vertices_per_patch) int32), ``ico``, ``sub_ico``; the dHCP atlas vertex
order), else a table generated from the icosphere in this package's
canonical vertex order.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from pathlib import Path

import numpy as np

from surface_vision_transformers_tpu_torch.geometry.icosphere import (
    generate_patch_table,
    num_vertices,
    patch_grid,
    remap_table_to_icosphere,
)

ASSET_DIR = Path(__file__).resolve().parent.parent.parent / "assets"


@dataclasses.dataclass(frozen=True)
class PatchTable:
    """Validated patch table for (ico, sub_ico). ``ordering`` names the
    vertex numbering: 'atlas' (the shipped dHCP assets) or 'canonical'
    (generated here; raw-vertex data must be in the same numbering)."""

    indices: np.ndarray
    ico: int
    sub_ico: int
    ordering: str = "atlas"

    def validate(self) -> "PatchTable":
        """Shape from the geometry formula, id range, full mesh coverage and
        no repeated id within a patch."""
        n_patches, n_per_patch = patch_grid(self.ico, self.sub_ico)
        if self.indices.shape != (n_patches, n_per_patch):
            raise ValueError(
                f"table shape {self.indices.shape} != expected "
                f"{(n_patches, n_per_patch)} for ico={self.ico}, "
                f"sub_ico={self.sub_ico}"
            )
        total = num_vertices(self.ico)
        if self.indices.min() < 0 or self.indices.max() >= total:
            raise ValueError("vertex ids out of range")
        if np.unique(self.indices).size != total:
            raise ValueError("patches do not cover every mesh vertex")
        s = np.sort(self.indices, axis=1)
        if (s[:, 1:] == s[:, :-1]).any():
            raise ValueError("a patch repeats a vertex id")
        return self


def read_reference_csv(path: str | os.PathLike) -> np.ndarray:
    """A reference-format table CSV (one column per patch under a header row
    of patch ids) -> (num_patches, vertices_per_patch) int32."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return np.ascontiguousarray(np.asarray(rows[1:], dtype=np.int32).T)


def _load_npz(p: Path, ico: int, sub_ico: int) -> PatchTable:
    with np.load(p) as z:
        table = PatchTable(
            z["indices"].astype(np.int32), int(z["ico"]), int(z["sub_ico"]))
    if (table.ico, table.sub_ico) != (ico, sub_ico):
        raise ValueError(
            f"{p} holds ico={table.ico}, sub_ico={table.sub_ico}, not "
            f"ico={ico}, sub_ico={sub_ico}")
    return table.validate()


def load_patch_table(
    ico: int = 6, sub_ico: int = 2, path: str | os.PathLike | None = None
) -> PatchTable:
    """The validated table for (ico, sub_ico): from ``path`` (.npz, or a
    reference .csv) when given; else the first
    ``patch_table_ico{ico}_sub{sub_ico}.npz`` in ``$SVT_TABLE_DIR`` and
    ``assets/``; else generated (``ordering="canonical"``)."""
    if path is not None:
        p = Path(path)
        if p.suffix == ".csv":
            return PatchTable(read_reference_csv(p), ico, sub_ico).validate()
        return _load_npz(p, ico, sub_ico)
    dirs = [Path(os.environ["SVT_TABLE_DIR"])] if os.environ.get("SVT_TABLE_DIR") else []
    for d in dirs + [ASSET_DIR]:
        cand = d / f"patch_table_ico{ico}_sub{sub_ico}.npz"
        if cand.exists():
            return _load_npz(cand, ico, sub_ico)
    table, verts = generate_patch_table(ico, sub_ico)
    return PatchTable(remap_table_to_icosphere(table, verts, ico), ico, sub_ico,
                      ordering="canonical").validate()
