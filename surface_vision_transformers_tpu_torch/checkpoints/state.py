"""Full training-state checkpoints in a run folder (the port's own format,
beside the JAX package's Orbax directories, which it does not read).

A checkpoint is a directory -- ``last/`` (the rolling one,
``training.ckpt_every``), ``final/`` (the end of a run) or ``best/`` (each
validation improvement) -- holding ``state.pt``, the trainer's
``state_dict()`` (model, optimizer, step, EMA, every generator) as a file
that ``torch.load(..., weights_only=True)`` reads, and ``metadata.json``
with the JAX package's keys (``epoch``, the metric, ``best``,
``best_epoch``). ``state.pt`` is written beside and renamed into place, so a
run killed while writing keeps the checkpoint before. Under a mesh every
rank gathers the state whole (``parallel.sharding.ShardedModel``: FSDP2
shards, TP slices and pipeline stages) and rank 0 alone writes it, so a
file is the single-process format whatever mesh wrote it, and loads under
any other.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

NAMES = ("last", "final", "best")


def save_state(path: str | os.PathLike, state: dict, metadata: dict) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / "state.pt.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path / "state.pt")
    (path / "metadata.json").write_text(json.dumps(metadata))


def load_state(path: str | os.PathLike) -> tuple[dict, dict]:
    """(state on the CPU, metadata) of the checkpoint directory ``path``."""
    path = Path(path)
    state = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
    meta_file = path / "metadata.json"
    return state, json.loads(meta_file.read_text()) if meta_file.exists() else {}


def newest(run_dir: str | os.PathLike) -> tuple[str, int, dict]:
    """(name, epoch, metadata) of the checkpoint among ``last`` / ``final``
    / ``best`` with the highest recorded epoch: ``last`` is older than
    ``final`` when ``ckpt_every`` does not divide the epochs."""
    run_dir = Path(run_dir)
    candidates = []
    for name in NAMES:
        if (run_dir / name / "state.pt").exists():
            meta_file = run_dir / name / "metadata.json"
            meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
            candidates.append((int(meta.get("epoch", -1)), name, meta))
    if not candidates:
        raise FileNotFoundError(f"no checkpoint (last/final/best) under {run_dir}")
    epoch, name, meta = max(candidates, key=lambda c: c[0])
    return name, epoch, meta
