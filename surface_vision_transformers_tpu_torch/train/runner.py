"""Test-time evaluation workflow (counterpart of
``surface_vision_transformers_tpu.train.runner.run_testing`` for regression
configs): load a split and a checkpoint, serve it through ``predict``, report
the MAE and write ``results.csv`` of (pred, target) rows in split order.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from surface_vision_transformers_tpu_torch.checkpoints.convert import (
    load_params_npz,
    load_torch_state_dict,
    state_dict_from_jax,
)
from surface_vision_transformers_tpu_torch.data import npy as npy_io
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.models.fused import predict
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.utils.config import Experiment


def load_state_dict_any(path: str, depth: int) -> dict:
    """Reference-layout state dict from a JAX params ``.npz`` or a
    reference ``.pt``/``.pth`` file. Orbax checkpoint directories need JAX
    to read and are refused."""
    p = Path(path)
    if p.is_dir():
        raise ValueError(
            f"{p} is a directory (an Orbax checkpoint?); the PyTorch port reads "
            "params .npz files (e.g. best_params.npz in the run folder) or "
            "reference .pt/.pth state dicts")
    if p.suffix == ".npz":
        tree = load_params_npz(p)
        return state_dict_from_jax(tree.get("params", tree), depth)
    return load_torch_state_dict(p)


def write_preds_csv(path, preds, targets) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pred", "target"])
        for p, t in zip(np.asarray(preds).ravel(), np.asarray(targets).ravel()):
            w.writerow([float(p), float(t)])


def run_testing(exp: Experiment, *, device) -> dict:
    """Evaluate on ``exp.data.split`` (default 'validation') at
    ``training.bs_val`` (0 -> ``training.bs``) on ``device``, with the
    weights at ``testing.path_to_ckpt`` (loaded strictly)."""
    if exp.is_pretraining or exp.model.num_classes != 1:
        raise NotImplementedError(
            "run_testing covers regression configs only; MPP evaluation is "
            "not ported yet")
    if not exp.ckpt_path:
        raise ValueError(
            "run_testing needs weights: set testing.path_to_ckpt (a params "
            ".npz or a reference .pth)")
    split = exp.data.split or "validation"
    data, labels = npy_io.load_split(exp.data.resolved_data_path(), split)

    table = None
    if data.ndim == 3:
        table = load_patch_table(exp.ico, exp.sub_ico).indices
    model = SiT.from_config(exp, patch_table=table)
    model.load_state_dict(
        load_state_dict_any(exp.ckpt_path, exp.model.depth), strict=True)
    model.eval()

    preds = predict(
        model, data, device=device,
        batch_size=exp.training.bs_val or exp.training.bs,
        quant=None if exp.quant == "none" else exp.quant,
    ).reshape(-1)

    out_dir = Path(exp.ckpt_path)
    if out_dir.is_file() or out_dir.suffix in (".npz", ".pt", ".pth"):
        out_dir = out_dir.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    write_preds_csv(out_dir / "results.csv", preds, labels)
    return {"n": int(data.shape[0]), "split": split,
            "mae": float(np.mean(np.abs(preds - labels.reshape(-1))))}
