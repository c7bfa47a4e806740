#!/usr/bin/env python3
"""The reference recipe on the PyTorch / CUDA port: SiT-tiny scan-age
regression (``configs/training/sit_tiny_scan_age.yml``: dim 192, depth 12,
3 heads, bs 256, 100 epochs, SGD with momentum 0.9 at LR 1e-5, validation
every 10 epochs, best checkpoint) in bfloat16 and float32 at several seeds,
each run followed by the test driver on its run folder, as a user runs it.
The port's counterpart of ``scripts/run_recipe_r05.py`` (whose result is
``RECIPE_r05.json``); it imports only the port.

    python3 scripts/run_recipe_torch.py [--seeds 0 1 2] [--dtypes bfloat16 float32]
                                        [--work DIR] [--out RECIPE_torch.json]

The data are ``run_recipe_r05.py``'s, byte for byte: 846 training and 106
validation surfaces of shape (4, 320, 153), float32, z-scored noise with a
linear age signal planted along one pattern (``synth_split``, the same
seeds and sizes). Each run records its best val MAE and epoch, the epoch-9
val MAE (``metrics_val.csv``), the test driver's MAE, ``phases_s``, its wall
seconds and its median CUDA-event step time. The summary gives each dtype's
spread over the seeds and the tolerance it sets for ``chip_smoke.py``'s
recipe gate (``recipe_tolerance``). Last, the int8 question on trained
weights: the bfloat16 seed-0 best checkpoint served on the validation split
through ``fused_forward`` with int8 weights against bf16 (recorded, gated
nowhere). The output JSON starts with the card's name and power limit.
Needs one CUDA device (about 5 minutes on an H100).
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONFIG = ROOT / "configs/training/sit_tiny_scan_age.yml"
N_TRAIN_SUBJ, N_VAL_SUBJ = 423, 53  # subjects; two hemispheres each
SEEDS = (0, 1, 2)
DTYPES = ("bfloat16", "float32")
# the JAX package's record of the same recipe on the same data (RECIPE_r05.json)
JAX_BEST = {"bfloat16": 4.859167710790095, "float32": 4.857121881448998}
JAX_EPOCH9_BF16 = 5.855459537146227
TOL_CAP = 0.10  # the recipe gate is never wider than 2% of the reference MAE


def synth_split(rng, n_subjects, pattern):
    """(2N, 4, 320, 153) hemisphere-duplicated samples and scan-age labels
    (weeks): z-scored noise carrying a linear age signal along
    ``pattern``."""
    ages = rng.uniform(26.0, 45.0, size=n_subjects).astype(np.float32)
    labels = np.concatenate([ages, ages])  # L then R rows
    n = 2 * n_subjects
    data = rng.standard_normal((n, 4, 320, 153)).astype(np.float32)
    z = (labels - 36.0) / 6.0
    data += z[:, None, None, None] * pattern[None]
    return data, labels


def make_data(work: Path, n_train: int = N_TRAIN_SUBJ, n_val: int = N_VAL_SUBJ) -> Path:
    """The train and validation splits as npy files under
    ``work/scan_age/template`` -> that folder."""
    rng = np.random.default_rng(0)
    pattern = (rng.standard_normal((4, 320, 153)) * 0.5).astype(np.float32)
    d = work / "scan_age" / "template"
    d.mkdir(parents=True, exist_ok=True)
    for split, n in (("train", n_train), ("validation", n_val)):
        data, labels = synth_split(rng, n, pattern)
        np.save(d / f"{split}_data.npy", data)
        np.save(d / f"{split}_labels.npy", labels)
    return d


def recipe_config(work: Path, tag: str, compute_dtype: str, seed: int = 0,
                  epochs: int | None = None) -> dict:
    """The recipe's raw config: the shipped file with the data under
    ``work``, the logs in ``work/logs_{tag}``, the compute dtype and the
    seed set."""
    raw = yaml.safe_load(CONFIG.read_text())
    raw["data"]["data_path"] = str(work / "{}" / "{}")
    raw["logging"]["folder_to_save_model"] = str(work / f"logs_{tag}")
    raw.setdefault("tpu", {})["compute_dtype"] = compute_dtype
    raw["training"]["seed"] = seed
    if epochs is not None:
        raw["training"]["epochs"] = epochs
    return raw


def test_config(raw: dict, run_dir: str) -> dict:
    """The test driver's config: the run's, its validation split, the
    weights of the run folder."""
    out = dict(raw)
    out["data"] = dict(raw["data"], split="validation")
    out["weights"] = dict(raw.get("weights", {}))
    out["testing"] = {"path_to_ckpt": str(run_dir)}
    return out


class StepTimer:
    """CUDA events around every ``Trainer.optimizer_step`` while installed
    (read once, after the run: no sync in the loop)."""

    def __init__(self):
        import torch

        from surface_vision_transformers_tpu_torch.train.trainer import Trainer

        self.torch, self.cls, self.events = torch, Trainer, []
        self.orig = Trainer.optimizer_step

    def __enter__(self):
        timer, orig, torch = self, self.orig, self.torch

        def step(trainer, *a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(trainer, *a, **k)
            end.record()
            timer.events.append((start, end))
            return out

        self.cls.optimizer_step = step
        return self

    def __exit__(self, *exc):
        self.cls.optimizer_step = self.orig
        self.torch.cuda.synchronize()

    def median_ms(self) -> float:
        return float(np.median([a.elapsed_time(b) for a, b in self.events]))


def val_mae_at(run_dir: Path, epoch: int) -> float:
    """The val MAE the run logged at ``epoch`` (``metrics_val.csv``)."""
    with open(run_dir / "metrics_val.csv") as f:
        for row in csv.DictReader(f):
            if int(row["step"]) == epoch:
                return float(row["val/mae"])
    raise KeyError(f"no validation at epoch {epoch} in {run_dir}")


def one_run(work: Path, compute_dtype: str, seed: int, device: str = "cuda",
            epochs: int | None = None, tpu: dict | None = None) -> dict:
    """``run_training`` then ``run_testing`` on its run folder -> the run's
    record (``raw`` and ``run_dir`` included for the caller)."""
    from surface_vision_transformers_tpu_torch.train import runner
    from surface_vision_transformers_tpu_torch.utils.config import from_dict

    tag = f"{compute_dtype}_s{seed}"
    raw = recipe_config(work, tag, compute_dtype, seed, epochs)
    raw["tpu"].update(tpu or {})
    t0 = time.time()
    with StepTimer() as timer:
        results = runner.run_training(from_dict(raw), device=device, progress=False)
    wall = time.time() - t0
    test = runner.run_testing(from_dict(test_config(raw, results["run_dir"])), device=device)
    run_dir = Path(results["run_dir"])
    return {"compute_dtype": compute_dtype, "seed": seed,
            "best_val_mae": float(results["best_mae"]),
            "best_epoch": int(results["best_epoch"]),
            "epoch9_val_mae": val_mae_at(run_dir, 9),
            "test_driver_mae": float(test["mae"]), "test_n": int(test["n"]),
            "epochs": int(results["epochs"]), "train_wall_s": round(wall, 2),
            "phases_s": results["phases_s"], "step_ms_median": timer.median_ms(),
            "steps": len(timer.events), "run_dir": str(run_dir), "raw": raw}


def int8_on_trained(run: dict, device: str = "cuda", bs: int = 64) -> dict:
    """The run's best checkpoint (bfloat16) served on the validation split
    through ``fused_forward`` with int8 weights and with bf16 ones: the
    rel-L2 of the int8 predictions against bf16's and the val MAE gap."""
    import torch

    from surface_vision_transformers_tpu_torch.data import npy as npy_io
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.models import fused
    from surface_vision_transformers_tpu_torch.train import runner
    from surface_vision_transformers_tpu_torch.utils.config import from_dict

    exp = from_dict(run["raw"])
    model = runner.build_model(exp, load_patch_table(exp.ico, exp.sub_ico).indices)
    state = runner.load_state_dict_any(str(Path(run["run_dir"]) / "best_params.npz"),
                                       exp.model.depth)
    runner.load_model_state(model, state)
    model.eval().to(device)
    data, labels = npy_io.load_split(exp.data.resolved_data_path(), "validation")
    x = torch.from_numpy(data).to(device)
    preds = {}
    with torch.inference_mode():
        for quant in (None, "int8"):
            w = fused.prepare_weights(model, quant)
            preds[quant or "bf16"] = torch.cat([
                fused.fused_forward(model, x[s:s + bs], w, quant=quant)
                for s in range(0, len(x), bs)]).reshape(-1).double().cpu().numpy()
    p16, p8 = preds["bf16"], preds["int8"]
    mae16 = float(np.abs(p16 - labels).mean())
    mae8 = float(np.abs(p8 - labels).mean())
    return {"checkpoint": f"{run['compute_dtype']} seed {run['seed']} best_params.npz",
            "n": int(len(labels)),
            "rel_l2_int8_vs_bf16": float(np.linalg.norm(p8 - p16) / np.linalg.norm(p16)),
            "max_abs_int8_vs_bf16": float(np.abs(p8 - p16).max()),
            "val_mae_bf16": mae16, "val_mae_int8": mae8, "val_mae_gap": mae8 - mae16,
            "seeded_weight_block_rel_l2": 0.01124,
            "note": "rel-L2 of the predictions (ages), beside the int8 block's rel-L2 to "
                    "float32 at SiT-base width on seeded weights "
                    "(tests/test_torch_int8.py); SiT-tiny sits below serving_quant's "
                    "crossover (INT8_MIN_DIM 384), so int8 is asked of fused_forward "
                    "directly"}


def recipe_tolerance(spread: dict) -> dict:
    """The recipe gate's tolerance from the seed spread: the port at one
    seed and the JAX record are two draws, each off its mean by the seed
    spread, so their gap may reach twice the larger dtype's full range
    over the seeds (max - min), capped at ``TOL_CAP``."""
    widest = max(s["range"] for s in spread.values())
    return {"rule": "min(TOL_CAP, 2 * the larger dtype's max - min best val MAE over seeds)",
            "widest_range": widest, "tol_cap": TOL_CAP, "recipe_tol": min(TOL_CAP, 2 * widest)}


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in out.split(","))
    return {"name": name, "power.limit": power}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--dtypes", nargs="+", default=list(DTYPES), choices=DTYPES)
    ap.add_argument("--work", default=None, help="data and run folders (default: a temp dir)")
    ap.add_argument("--out", default=str(ROOT / "RECIPE_torch.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("run_recipe_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 runs stay float32
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(args.work or tmp)
        t0 = time.time()
        make_data(work)
        out = {"card": card(), "torch": torch.__version__, "cuda": torch.version.cuda,
               "recipe": "configs/training/sit_tiny_scan_age.yml: SiT-tiny (dim 192, depth 12, "
                         "3 heads), 100 epochs, bs 256, SGD m=0.9 LR 1e-5, val every 10, best "
                         "checkpoint, test driver on the run folder",
               "data": f"synthetic, scripts/run_recipe_r05.py's byte for byte "
                       f"({2 * N_TRAIN_SUBJ} train / {2 * N_VAL_SUBJ} val surfaces)",
               "data_s": round(time.time() - t0, 2), "jax_record": {
                   "source": "RECIPE_r05.json (the JAX package on a TPU)",
                   "best_val_mae": JAX_BEST, "epoch9_val_mae_bfloat16": JAX_EPOCH9_BF16},
               "runs": []}
        for dtype in args.dtypes:
            for seed in args.seeds:
                run = one_run(work, dtype, seed)
                print(json.dumps({k: v for k, v in run.items() if k != "raw"}), flush=True)
                out["runs"].append(run)
        spread = {}
        for dtype in args.dtypes:
            best = [r["best_val_mae"] for r in out["runs"] if r["compute_dtype"] == dtype]
            spread[dtype] = {"best_val_mae": best, "mean": float(np.mean(best)),
                             "std": float(np.std(best, ddof=1)) if len(best) > 1 else 0.0,
                             "range": float(max(best) - min(best)),
                             "mean_minus_jax": float(np.mean(best) - JAX_BEST[dtype])}
        out["seed_spread"] = spread
        out["tolerance"] = recipe_tolerance(spread)
        seed0 = {r["compute_dtype"]: r for r in out["runs"] if r["seed"] == 0}
        if len(seed0) == 2:
            out["bf16_vs_fp32_seed0"] = abs(seed0["bfloat16"]["best_val_mae"]
                                            - seed0["float32"]["best_val_mae"])
        out["test_driver_vs_best_val"] = max(abs(r["test_driver_mae"] - r["best_val_mae"])
                                             for r in out["runs"])
        if "bfloat16" in seed0:
            out["int8_on_trained"] = int8_on_trained(seed0["bfloat16"])
        out["wall_s"] = round(time.time() - t0, 1)
        for r in out["runs"]:
            del r["raw"], r["run_dir"]
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}, indent=1), flush=True)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
