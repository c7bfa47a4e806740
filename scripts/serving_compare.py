#!/usr/bin/env python3
"""The serving forwards' times beside another checkout's, on one NVIDIA GPU.

    python3 scripts/serving_compare.py OTHER_CHECKOUT

Times, in a process of its own for OTHER_CHECKOUT and for this tree, each
with its own kernels, in the order other, this, this, other:
``fused_forward`` of SiT-tiny (``chip_smoke.py`` phase 4's seeded model,
raw bf16 input on the card) at B = 256 and 1024, and at B = 8, where the
host's launch path sets the time; and ``fused_mssit_forward`` of the shipped
MS-SiT (phase 27's seeded model) at B = 64, bf16 and int8. CUDA-event
medians (``chip_smoke.cuda_ms``: 10 calls, MS-SiT 5), and the host's time
to enqueue one forward on an idle card (``host_ms``: the host clock around a
call, no synchronisation inside, median of 10); then each case's mean over
each tree's runs, how far that tree's runs differ, and the ratio.
``--rounds K`` runs the four-process turn K times (default 1). Needs a CUDA
device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import numpy as np
import torch
import chip_smoke as cs
from surface_vision_transformers_tpu_torch.checkpoints.convert import state_dict_from_jax
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.models import fused
from surface_vision_transformers_tpu_torch.models import fused_mssit as fm
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.ops import _native

_native.build()


def host_ms(fn, reps=10):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2]


def both(fn, reps):
    return [cs.cuda_ms(fn, reps=reps), host_ms(fn)]


rng = np.random.default_rng(cs.SEED)
table = load_patch_table(6, 2).indices
model = SiT(dim=cs.DIM, depth=cs.DEPTH, heads=cs.HEADS, mlp_dim=cs.MLP, dim_head=cs.DH,
            patch_table=table, dtype=torch.bfloat16, attn_backend="plain")
model.load_state_dict(state_dict_from_jax(cs.jax_shaped_params(rng, table.shape[1]), cs.DEPTH))
model = model.eval().cuda()
w = fused.prepare_weights(model)
out = {{}}
with torch.inference_mode():
    for B in (8, 256, 1024):
        x = torch.from_numpy(rng.standard_normal((B, 4, 40962)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        out[f"SiT-tiny B={{B}}"] = both(lambda: fused.fused_forward(model, x, w), 10)
    del model, w, x
    _, _, ms, _, _ = cs.mssit_models(np.random.default_rng(cs.SEED))
    x = torch.from_numpy(rng.standard_normal((64, 4, 40962)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    for label, q in (("bf16", None), ("int8", "int8")):
        wm = fm.prepare_mssit_weights(ms, q)
        out[f"MS-SiT B=64 {{label}}"] = both(
            lambda: fm.fused_mssit_forward(ms, x, wm, quant=q), 5)
print("RESULT " + json.dumps(out))
"""


def run(root: Path) -> dict:
    res = subprocess.run([sys.executable, "-c", RUN.format(root=str(root))], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise SystemExit(f"serving_compare: {root} failed:\n{res.stdout[-3000:]}\n"
                         f"{res.stderr[-3000:]}")
    line = next(l for l in res.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    other = Path(args.other).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other") * args.rounds:
        r = run(other if name == "other" else ROOT)
        runs[name].append(r)
        print(f"{name}: " + ", ".join(f"{k} {v[0]:.4f} ms (host {v[1]:.4f})"
                                      for k, v in r.items()), flush=True)
    for case in runs["this"][0]:
        for i, what in enumerate(("CUDA events", "host enqueue")):
            vals = {n: [r[case][i] for r in rs] for n, rs in runs.items()}
            mean = {n: sum(v) / len(v) for n, v in vals.items()}
            spread = {n: max(v) - min(v) for n, v in vals.items()}
            print(f"{case}, {what}: this {mean['this']:.4f} ms (runs differ by "
                  f"{spread['this']:.4f}), other {mean['other']:.4f} ms (by "
                  f"{spread['other']:.4f}), ratio {mean['this'] / mean['other']:.4f}", flush=True)


if __name__ == "__main__":
    main()
