"""Reference-format .npy dataset IO (numpy counterpart of
``surface_vision_transformers_tpu.data.npy``).

A split is ``{split}_data.npy`` -- (S, C, L, V) pre-patched or (S, C, G) raw
vertex arrays -- beside ``{split}_labels.npy``. Per-channel normalisation
stats ``means.npy`` / ``stds.npy`` of shape (1, C, 1) live under
``{label_dir}/{task}/{configuration}/``.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np

SHIPPED_LABEL_DIR = (
    Path(__file__).resolve().parent.parent.parent / "assets" / "labels" / "dHCP"
)


def load_split(
    data_path: str | os.PathLike, split: str, *, mmap: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """(data, labels float32 flattened) of one split. The data come back as
    float32 in memory, or under ``mmap=True`` as a read-only np.memmap in
    their on-disk dtype, never read whole (the streaming loader casts each
    batch)."""
    d = Path(data_path)
    data = np.load(d / f"{split}_data.npy", mmap_mode="r" if mmap else None)
    labels = np.load(d / f"{split}_labels.npy").reshape(-1)
    if data.shape[0] != labels.shape[0]:
        raise ValueError(
            f"{split}: {data.shape[0]} samples vs {labels.shape[0]} labels"
        )
    if not mmap:
        data = data.astype(np.float32)
    return data, labels.astype(np.float32)


def resolve_label_dir(label_path: str | os.PathLike, task: str) -> Path:
    """The configured label dir when it holds ``{task}/``, else the shipped
    dHCP assets (with a warning when a non-empty path was passed over)."""
    if label_path:
        p = Path(label_path)
        if (p / task).exists() or not (SHIPPED_LABEL_DIR / task).exists():
            return p
        warnings.warn(
            f"data.label_path={str(p)!r} has no {task}/ subfolder; falling "
            f"back to the shipped assets at {str(SHIPPED_LABEL_DIR)!r}",
            stacklevel=2,
        )
    return SHIPPED_LABEL_DIR


def load_norm_stats(
    label_path: str | os.PathLike, task: str, configuration: str
) -> tuple[np.ndarray, np.ndarray]:
    """means, stds of shape (1, C, 1) for (task, configuration)."""
    d = resolve_label_dir(label_path, task) / task / configuration
    return np.load(d / "means.npy"), np.load(d / "stds.npy")
