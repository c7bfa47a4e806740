"""Offline preprocessing ETL: GIFTI metric files -> patched .npy datasets
(numpy counterpart of ``surface_vision_transformers_tpu.data.preprocess``).

Per subject it loads the left and right hemisphere metric files
``sub-{id}_ses-{ses}_{L,R}.shape.gii`` from
``{data_path}/regression_{configuration}_space_features/``, keeps the first
``channels`` metrics, z-scores them with the dataset-level (1, C, 1) stats,
gathers patches through the (L, V) triangle table of ``resolution.ico`` /
``resolution.sub_ico``, and writes

* ``{split}_data.npy``: (2N, C, L, V) float32, left hemispheres in rows
  0..N-1, right in N..2N-1;
* ``{split}_labels.npy``: the N labels twice, float32;
* under ``export_raw=True`` also ``{split}_raw.npy``: the (2N, C, G)
  normalised vertex arrays, which the models embed themselves (on CUDA in
  bfloat16 through the ``patch_embed`` kernel). Their dtype is what numpy's
  arithmetic gives: float64 where the stats are float64.

The files are byte-for-byte the JAX package's (and so the reference's
``tools/preprocessing.py`` layout). The JAX package gathers with a threaded
C++ library where one is built; the gather is exact, so numpy fancy
indexing gives the same bytes.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np

from surface_vision_transformers_tpu_torch.data import gifti
from surface_vision_transformers_tpu_torch.data.npy import resolve_label_dir
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.utils.config import _get


def read_label_csv(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """(ids as strings, labels float32) of a label CSV with 'ids' and
    'labels' columns."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    ids = np.array([r["ids"] for r in rows])
    labels = np.array([float(r["labels"]) for r in rows], np.float32)
    return ids, labels


def load_subject_hemispheres(
    data_path: str | os.PathLike, configuration: str, subject_id: str, channels: int
) -> tuple[np.ndarray, np.ndarray]:
    """(C, G) metric arrays of one subject's left and right hemispheres;
    ``subject_id`` is '{sub}_{ses}'."""
    sub, ses = subject_id.split("_")[:2]
    folder = Path(data_path) / f"regression_{configuration}_space_features"
    left, right = (
        np.asarray(gifti.load(folder / f"sub-{sub}_ses-{ses}_{hemi}.shape.gii").agg_data())[
            :channels, :]
        for hemi in ("L", "R"))
    return left, right


def patchify_stack(vertex_data: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(N, C, G) -> (N, C, L, V) float32 through an (L, V) table."""
    data = np.ascontiguousarray(vertex_data, np.float32)
    return np.ascontiguousarray(data[:, :, np.asarray(indices, np.int32)])


def run(config: dict, *, export_raw: bool = False) -> dict:
    """The ETL on a preprocessing config dict (``configs/preprocessing/
    dhcp.yml``'s keys) -> {split, shape, output_folder, n_subjects}."""
    ico = int(_get(config, "resolution.ico", 6))
    sub_ico = int(_get(config, "resolution.sub_ico", 2))
    configuration = _get(config, "data.configuration", "template")
    split = _get(config, "data.split", "train")
    channels = int(_get(config, "data.channels", 4))
    task = _get(config, "data.task", "scan_age")
    data_path = _get(config, "data.data_path")
    label_path = resolve_label_dir(_get(config, "data.label_path", ""), task)
    output_folder = _get(config, "output.folder").format(task, configuration)

    ids, labels = read_label_csv(Path(label_path) / task / f"{split}.csv")
    stats = Path(label_path) / task / configuration
    means, stds = np.load(stats / "means.npy"), np.load(stats / "stds.npy")

    hemis = [load_subject_hemispheres(data_path, configuration, sid, channels) for sid in ids]
    # all left hemispheres first, then all right
    raw = np.stack([h[0] for h in hemis] + [h[1] for h in hemis]).astype(np.float32)
    raw = (raw - means.reshape(1, channels, 1)) / stds.reshape(1, channels, 1)
    out_labels = np.concatenate([labels, labels])

    out = Path(output_folder)
    out.mkdir(parents=True, exist_ok=True)
    if export_raw:
        np.save(out / f"{split}_raw.npy", raw)
    data = patchify_stack(raw, load_patch_table(ico, sub_ico).indices)
    np.save(out / f"{split}_data.npy", data)
    np.save(out / f"{split}_labels.npy", out_labels)
    return {
        "split": split,
        "shape": tuple(data.shape),
        "output_folder": str(output_folder),
        "n_subjects": int(ids.shape[0]),
    }
