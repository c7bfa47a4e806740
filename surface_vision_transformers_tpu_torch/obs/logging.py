"""Run folders and metric logs (counterpart of
``surface_vision_transformers_tpu.obs.logging``): the same run-folder name,
JSONL events and per-prefix CSV files. No TensorBoard. Under several
processes only rank 0 keeps the logs and prints (``MetricLogger(enabled=
parallel.is_primary())``, the runner's ``progress``).
"""

from __future__ import annotations

import csv
import json
import os
import time
from datetime import datetime
from pathlib import Path
from typing import Any

from surface_vision_transformers_tpu_torch.utils.config import Experiment


def run_folder_name(exp: Experiment, date: str | None = None) -> str:
    """``{date}-{tiny|small|base}[-imgnet][-ssl-{dataset}]-{finetune|freeze}``,
    as the JAX package (and the reference) name a training run."""
    date = date or datetime.today().strftime("%Y-%m-%d-%H:%M:%S")
    name = date + "-" + exp.model.size_name
    if exp.training.load_weights_imagenet:
        name += "-imgnet"
    if exp.training.load_weights_ssl:
        name += "-ssl-" + exp.training.dataset_ssl
    if exp.is_pretraining:
        name += "-mpp"
    elif exp.training.finetuning:
        name += "-finetune"
    else:
        name += "-freeze"
    return name


class MetricLogger:
    """``metrics.jsonl`` (one record per event) and one CSV per metric
    prefix (``metrics_train.csv``, ``metrics_val.csv``), written at epoch
    granularity and flushed on every record. Close it when the run ends.
    ``enabled=False`` (a rank other than 0) writes nothing."""

    def __init__(self, run_dir: str | os.PathLike, enabled: bool = True):
        self.run_dir = Path(run_dir)
        self.enabled = enabled
        self._csv: dict[str, tuple] = {}
        if enabled:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.run_dir / "metrics.jsonl", "a")

    def log(self, step: int, scalars: dict[str, Any], prefix: str = "") -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({prefix + k: v for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        key = prefix.strip("/") or "metrics"
        if key not in self._csv:
            path = self.run_dir / ("metrics.csv" if key == "metrics" else f"metrics_{key}.csv")
            f = open(path, "a", newline="")
            w = csv.DictWriter(f, fieldnames=list(rec), extrasaction="ignore")
            if path.stat().st_size == 0:
                w.writeheader()
            self._csv[key] = (f, w)
        f, w = self._csv[key]
        w.writerow(rec)
        f.flush()

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        for f, _ in self._csv.values():
            f.close()
