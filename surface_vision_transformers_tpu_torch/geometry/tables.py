"""Patch lookup tables: (patch, within-patch vertex) -> global vertex id.

numpy counterpart of ``surface_vision_transformers_tpu.geometry.tables``
for the shipped assets: ``assets/patch_table_ico{ico}_sub{sub_ico}.npz``
with keys ``indices`` ((num_patches, vertices_per_patch) int32), ``ico`` and
``sub_ico``, in the dHCP atlas vertex order.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np

ASSET_DIR = Path(__file__).resolve().parent.parent.parent / "assets"


def num_vertices(order: int) -> int:
    """Vertices of an ico-``order`` icosphere."""
    return 10 * 4**order + 2


def patch_grid(ico: int, sub_ico: int) -> tuple[int, int]:
    """(num_patches, vertices_per_patch) for patching ico-``ico`` at level
    ``sub_ico``: one patch per face of ico-``sub_ico``."""
    if not 0 <= sub_ico <= ico:
        raise ValueError(f"need 0 <= sub_ico <= ico, got {sub_ico}, {ico}")
    r = 2 ** (ico - sub_ico)
    return 20 * 4**sub_ico, (r + 1) * (r + 2) // 2


@dataclasses.dataclass(frozen=True)
class PatchTable:
    """Validated patch table for (ico, sub_ico)."""

    indices: np.ndarray
    ico: int
    sub_ico: int

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


def load_patch_table(
    ico: int = 6, sub_ico: int = 2, path: str | os.PathLike | None = None
) -> PatchTable:
    """Load and validate the table from ``path`` or the shipped assets."""
    p = Path(path) if path is not None else (
        ASSET_DIR / f"patch_table_ico{ico}_sub{sub_ico}.npz")
    if not p.exists():
        raise FileNotFoundError(
            f"no patch table for ico={ico}, sub_ico={sub_ico} at {p}")
    with np.load(p) as z:
        table = PatchTable(
            z["indices"].astype(np.int32), int(z["ico"]), int(z["sub_ico"]))
    if (table.ico, table.sub_ico) != (ico, sub_ico):
        raise ValueError(
            f"{p} holds ico={table.ico}, sub_ico={table.sub_ico}, not "
            f"ico={ico}, sub_ico={sub_ico}")
    return table.validate()
