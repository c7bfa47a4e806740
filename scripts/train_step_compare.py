#!/usr/bin/env python3
"""SiT-tiny's training step beside another checkout's, on one NVIDIA GPU.

    python3 scripts/train_step_compare.py OTHER_CHECKOUT [mpp]

Runs ``chip_smoke.phase_train`` (phase 7: ten SGD steps of ``Trainer`` at
B = 256 on the kernels, beside the eager model), or with ``mpp`` the fused
MPP training of phase 17 alone (``sit_tiny_mpp.yml`` at its bs 32,
``MPP_RATE_STEPS`` steps of ``Trainer`` on ``fused_mpp_loss``, seeded
weights and data), of OTHER_CHECKOUT and of this tree, each in a process
of its own with its own kernels, in the order other, this, this, other
(twice for ``mpp``), and prints each run's per-step CUDA-event median over
steps 2.. and its host-clock window, then the mean of each tree's medians
and their ratio. MPP's step at bs 32 waits on the host, so its CUDA-event
times carry the host's stalls: ``mpp`` also prints the device time of a
step's kernels (torch.profiler over six more steps, their sum over six)
and its means. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASE7 = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
cs.phase_train(load_patch_table(6, 2).indices)
"""
MPP_RATE_STEPS = 30
MPP = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
import chip_smoke as cs
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.models.mpp import mpp_target
from surface_vision_transformers_tpu_torch.utils import config
exp = config.load_config(cs.MPP_CFG)
bs, steps = exp.training.bs, {steps}
start, make = cs.mpp_models(np.random.default_rng(cs.SEED), exp, load_patch_table(6, 2).indices)
raw, _ = make_regression_dataset(2 * bs, raw_vertices=40962, seed=cs.SEED + 5)
with torch.no_grad():
    tokens = mpp_target(make().transformer, torch.from_numpy(raw).cuda())
_, step_s, step_ms, _ = cs.trainer_run(exp, make(), start,
                                       [(tokens[:bs], None), (tokens[bs:], None)], steps)
print(f"bs {{bs}}: CUDA-event times, steps 2..{{steps}}, kernel path: median "
      f"{{float(np.median(step_ms)):.4f}}; kernel path {{step_s * 1e3:.4f}} ms a step")
from torch.profiler import ProfilerActivity, profile
model = make()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    cs.trainer_run(exp, model, start, [(tokens[:bs], None), (tokens[bs:], None)], 6)
    torch.cuda.synchronize()
dev = sum(e.self_device_time_total for e in prof.key_averages()) / 6 / 1e3
print(f"device time a step {{dev:.4f}} ms")
"""


def run(root: Path, path: str) -> tuple[float, float, float | None]:
    """(CUDA-event median ms, host-clock ms, device ms or None) of the
    kernel path's steps."""
    code = (MPP.format(root=str(root), steps=MPP_RATE_STEPS) if path == "mpp"
            else PHASE7.format(root=str(root)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise SystemExit(f"train_step_compare: {path} of {root} failed:\n{res.stdout[-3000:]}\n"
                         f"{res.stderr[-3000:]}")
    median = float(re.search(r"CUDA-event times, steps 2\.\.\d+, kernel path: median ([\d.]+)",
                             res.stdout)[1])
    host = float(re.search(r"kernel path ([\d.]+) ms a step", res.stdout)[1])
    dev = re.search(r"device time a step ([\d.]+) ms", res.stdout)
    return median, host, float(dev[1]) if dev else None


def main() -> None:
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["mpp"]):
        raise SystemExit(__doc__)
    other, path = Path(sys.argv[1]).resolve(), "mpp" if sys.argv[2:] else "phase 7"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    runs, devs = {"other": [], "this": []}, {"other": [], "this": []}
    for name in ("other", "this", "this", "other") * (2 if path == "mpp" else 1):
        median, host, dev = run(other if name == "other" else ROOT, path)
        runs[name].append(median)
        print(f"{name}: {path} kernel path, CUDA-event median {median:.3f} ms a step (host "
              f"clock {host:.3f} ms" + ("" if dev is None else f"; device {dev:.4f} ms") + ")",
              flush=True)
        if dev is not None:
            devs[name].append(dev)
    for what, r in (("the medians", runs), ("the device times", devs)):
        if not r["this"]:
            continue
        mean = {n: sum(v) / len(v) for n, v in r.items()}
        print(f"mean of {what}: this {mean['this']:.4f} ms, other {mean['other']:.4f} ms, this "
              f"- other {mean['this'] - mean['other']:+.4f} ms "
              f"({mean['this'] / mean['other']:.4f})", flush=True)


if __name__ == "__main__":
    main()
