"""Run folders, metric logs and the profiler (counterpart of
``surface_vision_transformers_tpu.obs.logging``): the same run-folder name,
JSONL events, per-prefix CSV files and TensorBoard scalars (written where
``torch.utils.tensorboard`` imports, else none, as in the JAX package).
``profile_trace`` records one epoch with ``torch.profiler`` where the JAX
package runs ``jax.profiler``. Under several processes only rank 0 keeps the
logs and prints (``MetricLogger(enabled=parallel.is_primary())``, the
runner's ``progress``); every rank writes its own trace.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import socket
import time
import warnings
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
    """``metrics.jsonl`` (one record per event), one CSV per metric prefix
    (``metrics_train.csv``, ``metrics_val.csv``) and, under
    ``use_tensorboard`` where ``torch.utils.tensorboard`` imports, an event
    file of every int or float scalar (tag ``prefix + key``), written at
    epoch granularity and flushed on every record. Close it when the run
    ends. ``enabled=False`` (a rank other than 0) writes nothing."""

    def __init__(self, run_dir: str | os.PathLike, enabled: bool = True,
                 use_tensorboard: bool = True):
        self.run_dir = Path(run_dir)
        self.enabled = enabled
        self._csv: dict[str, tuple] = {}
        self._tb = None
        if not enabled:
            return
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a")
        if use_tensorboard:
            try:  # tensorboard is optional, as in the JAX package
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.run_dir))
            except Exception:
                self._tb = None

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
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(prefix + k, v, step)

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        for f, _ in self._csv.values():
            f.close()
        if self._tb is not None:
            self._tb.close()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@contextlib.contextmanager
def profile_trace(log_dir: str | os.PathLike, enabled: bool = True, device="cpu"):
    """``torch.profiler`` over the block (the JAX package's ``jax.profiler``
    trace): CPU activity always, CUDA activity where ``device`` is CUDA. On
    exit one Chrome trace a process, ``{host}.rank{rank}.pt.trace.json``
    under ``log_dir`` (Perfetto or chrome://tracing read it). Does nothing
    where ``enabled`` is false. A CUDA trace that holds no kernel (no CUPTI
    on the machine) is written with a warning."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(log_dir / f"{socket.gethostname()}.rank{_rank()}.pt.trace.json"))
    if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
        warnings.warn("profile_trace: CUDA activity was asked for but the trace holds no "
                      "device event (is CUPTI missing?)", RuntimeWarning, stacklevel=3)
