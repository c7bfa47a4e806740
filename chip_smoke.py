#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (surface_vision_transformers_tpu_torch) at
the full width of SiT-tiny (ico-6 sub-ico-2, dim 192, depth 12, 3 heads,
mlp 768) with random weights made from a numpy seed. Phases, one line each;
any failure raises, so the script exits non-zero and prints no result:

1. device  -- a CUDA device is required; prints the card and power limit.
2. build   -- compiles the kernels in csrc/ (nvcc, sm_90a) and loads them.
3. kernels -- each block kernel against a float32 plain run on the same bf16
              inputs and weights, at the full block shape, plus controls
              (a wrong mask, a wrong softmax scale) that the same gate must
              reject; CUDA-event times of each kernel and of the eager bf16
              block the plain path runs.
4. slice   -- ``predict`` on 300 raw surfaces at batch 256 (the last batch
              padded): the kernels' launch counts, agreement with the plain
              (eager bf16) path, controls (a dropped block, a wrong mask)
              the same gate must reject, and surfaces/s at B=256 and B=1024.
5. entry   -- ``python -m surface_vision_transformers_tpu_torch.cli.test``
              on a synthetic npy split (labels near the predictions) and a
              params npz, in a subprocess; its results.csv must equal
              ``predict`` at the same batch size, and its MAE the plain
              path's within their largest prediction gap.

Then a JSON line of per-kernel results, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SOURCE = "surface_vision_transformers_tpu_torch/csrc/fused_block.cu"
REPLACES = {
    "fused_block": "surface_vision_transformers_tpu/ops/pallas/fused_block.py:251",
    "fused_block_cls": "surface_vision_transformers_tpu/ops/pallas/fused_block.py:1381",
}
DIM, DEPTH, HEADS, DH, MLP = 192, 12, 3, 64, 768
HD = HEADS * DH
N_TOKENS = 321  # 320 patches + CLS; the port does not pad
SEED = 0
# With fan-in init alone the residual stream carries each block's output and
# attention adds ~1% to it, so a broken mask or softmax hides under the bf16
# rounding of the output, and the predictions barely depend on the input.
# These gains make attention O(1) of every block's output and the tokens
# input-dominated; the gates below are set from readings at these weights.
QK_GAIN, OUT_GAIN, POS_STD = 1.5, 8.0, 0.02
X_SCALE = 0.1  # phase-3 block input: LayerNorm makes the branches scale-free
# Kernel gate: bf16 steps at the largest |output| of the float32 plain run,
# on the kernel against both the float32 and the bf16 plain run. Kernels
# and plain bf16 versions (same rounding points) read 0.65-1.25 steps from
# float32 and one step from each other on an H100; the controls read 7.5
# steps and more.
BOUND_STEPS = 2
# Slice gate on |kernel path - eager bf16| in predictions (std 0.30 across
# surfaces): three times the largest reading on an H100, 0.0098; the
# controls read 0.24 and more.
SLICE_TOL = 0.03


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def bf16_step(x: float) -> float:
    """Spacing of bfloat16 values at magnitude |x| (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def cuda_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn`` in ms, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def jax_shaped_params(rng, num_vertices: int, num_channels: int = 4) -> dict:
    """A numpy tree shaped like the JAX SiT's params (flax (in, out)
    kernels): torch-Linear-style uniform init, perturbed LayerNorms, and
    the attention gains above."""

    def lin(fan_in, fan_out, bias=True, gain=1.0):
        b = 1.0 / np.sqrt(fan_in)
        d = {"kernel": gain * rng.uniform(-b, b, (fan_in, fan_out)).astype(np.float32)}
        if bias:
            d["bias"] = rng.uniform(-b, b, fan_out).astype(np.float32)
        return d

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(DIM)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(DIM)).astype(np.float32)}

    pe = lin(num_channels * num_vertices, DIM)
    enc = {}
    for i in range(DEPTH):
        qkv = lin(DIM, 3 * HD, bias=False)
        qkv["kernel"][:, :2 * HD] *= QK_GAIN
        enc[f"layers_{i}_attn"] = {"norm": ln(), "to_qkv": qkv,
                                   "to_out": lin(HD, DIM, gain=OUT_GAIN)}
        enc[f"layers_{i}_mlp"] = {"norm": ln(), "fc1": lin(DIM, MLP),
                                  "fc2": lin(MLP, DIM)}
    return {
        "patch_embedding_kernel": pe["kernel"],
        "patch_embedding_bias": pe["bias"],
        "pos_embedding": (POS_STD * rng.standard_normal((1, N_TOKENS, DIM))).astype(np.float32),
        "cls_token": rng.standard_normal((1, 1, DIM)).astype(np.float32),
        "encoder": enc, "head_norm": ln(), "head": lin(DIM, 1),
    }


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> '/'-joined keys (the JAX package's params npz)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def zero_keys_reference(fb, x, p, rows):
    """The block in float32 as it would come out if the attention kernel
    left its zero-filled keys (N up to a multiple of 32) unmasked."""
    N = x.shape[1]
    h = fb._layer_norm(x, p[0], p[1], 1e-5)
    qkv = fb._mm(h, p[2])
    pad = -(-N // 32) * 32
    kv = F.pad(qkv[..., HD:], (0, 0, 0, pad - N))
    attn = fb._attention(qkv[:, :rows, :HD], kv[..., :HD], kv[..., HD:],
                         HEADS, DH, pad, x.dtype)
    return fb._out_proj_mlp(x[:, :rows], attn, *p[3:], 1e-5, x.dtype)


def phase_kernels(rng, fb, params, layer) -> dict:
    """Phase 3: each kernel at the block shape against a float32 plain run
    on the same bf16 inputs and weights (``params``: block 0 as the slice
    feeds it; ``layer``: the eager model's block 0)."""
    mats32 = [q.float() for q in params]
    q_scaled = list(mats32)
    q_scaled[2] = mats32[2].clone()
    q_scaled[2][:HD] *= 1.1  # softmax scale x1.1
    kw = dict(heads=HEADS, dim_head=DH)

    def eager(x):  # the plain path's block: eager SiT layer in bf16
        attn, ff = layer
        x1 = x + attn(x)
        return x1 + ff(x1)

    results = {}
    cases = [("fused_block", fb.fused_block, fb.fused_block_reference),
             ("fused_block_cls", fb.fused_block_cls, fb.fused_block_cls_reference)]
    # (B, N, valid_len): the main path's shape, then a padded one
    for B, N, vl in [(256, N_TOKENS, N_TOKENS), (256, 328, N_TOKENS)]:
        x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N, DIM)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        for name, kernel, plain in cases:
            got = kernel(x, *params, valid_len=vl, **kw).float()
            ref32 = plain(x.float(), *mats32, valid_len=vl, **kw)
            rows = min(vl, got.shape[1])

            def dist(a, b):
                return (a - b)[:, :rows].abs().max().item()

            ref_bf16 = plain(x, *params, valid_len=vl, **kw).float()
            err, err_plain = dist(got, ref32), dist(ref_bf16, ref32)
            err_bf16 = dist(got, ref_bf16)
            bound = BOUND_STEPS * bf16_step(ref32[:, :rows].abs().max().item())
            if N == N_TOKENS:
                controls = {
                    "softmax scale x1.1": dist(got, plain(
                        x.float(), *q_scaled, valid_len=vl, **kw)),
                    "zero-filled keys unmasked": dist(got, zero_keys_reference(
                        fb, x.float(), mats32, got.shape[1])),
                }
            else:
                controls = {"valid_len=N, keys 321..327 unmasked": dist(
                    kernel(x, *params, valid_len=N, **kw).float(), ref32)}
            phase("kernels", f"{name} B={B} N={N} valid_len={vl}: max abs err "
                  f"vs fp32 plain {err:.6g} (plain bf16 {err_plain:.6g}), vs plain "
                  f"bf16 {err_bf16:.6g}, bound on both "
                  f"{bound:.6g} = {BOUND_STEPS} bf16 steps at the largest output; "
                  "controls (must exceed the bound): "
                  + ", ".join(f"{k} {v:.6g}" for k, v in controls.items()))
            if not bool(torch.isfinite(got).all()) or max(err, err_bf16) > bound:
                raise AssertionError(f"{name} disagrees with its plain version")
            if min(controls.values()) <= bound:
                raise AssertionError(f"{name}: a control passed the gate")
            if N == N_TOKENS:
                with torch.inference_mode():
                    ms = cuda_ms(lambda: kernel(x, *params, **kw))
                    plain_ms = cuda_ms(lambda: eager(x))
                phase("kernels", f"{name} B={B} N={N}: kernel {ms:.4f} ms, eager "
                      f"bf16 SiT block {plain_ms:.4f} ms (median of 25, CUDA events)")
                results[name] = {"name": name, "route": "cuda", "source": SOURCE,
                                 "replaces": REPLACES[name], "max_abs_err": err,
                                 "ms": ms, "plain_ms": plain_ms}
    return results


def main() -> None:
    # -- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, str(ROOT))
    from surface_vision_transformers_tpu_torch.checkpoints.convert import (
        state_dict_from_jax,
    )
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.models import fused
    from surface_vision_transformers_tpu_torch.models.sit import SiT
    from surface_vision_transformers_tpu_torch.ops import _native
    from surface_vision_transformers_tpu_torch.ops import fused_block as fb

    # -- 2. build
    cached = _native.library_path().exists()
    t0 = time.perf_counter()
    _native.build()
    _native.library()
    phase("build", f"{time.perf_counter() - t0:.2f} s "
          f"({'already built' if cached else 'nvcc'}) -> {_native.library_path().name}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    table = load_patch_table(6, 2).indices
    tree = jax_shaped_params(rng, table.shape[1])
    state = state_dict_from_jax(tree, DEPTH)

    def sit(dtype):
        m = SiT(dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP, dim_head=DH,
                patch_table=table, dtype=dtype)
        m.load_state_dict(state, strict=True)
        return m.eval().to(dev)

    model, plain32 = sit(torch.bfloat16), sit(torch.float32)
    w = fused.prepare_weights(model)

    # -- 3. kernels
    kernels = phase_kernels(rng, fb, w.blocks[0], model.transformer.layers[0])

    # -- 4. slice
    data = rng.standard_normal((300, 4, 40962)).astype(np.float32)
    fb.fused_block.launches = fb.fused_block_cls.launches = 0
    preds = fused.predict(model, data, device="cuda", batch_size=256)
    launches = {"fused_block": fb.fused_block.launches,
                "fused_block_cls": fb.fused_block_cls.launches}
    n_batches = 2
    want = {"fused_block": (DEPTH - 1) * n_batches, "fused_block_cls": n_batches}
    phase("slice", f"predict(300 surfaces, batch 256): launches {launches}, "
          f"expected {want}")
    if launches != want:
        raise AssertionError("the main path did not launch every kernel as expected")
    if preds.shape != (300, 1) or not np.isfinite(preds).all():
        raise AssertionError(f"bad predictions: shape {preds.shape}")
    for name in kernels:
        kernels[name]["launches"] = launches[name]

    with torch.inference_mode():
        x = torch.from_numpy(data).to(dev)
        plain = torch.cat([model(x[s:s + 256]) for s in (0, 256)]).float().cpu().numpy()
        ref32 = torch.cat([plain32(x[s:s + 256]) for s in (0, 256)]).cpu().numpy()
        # controls on the first batch, through the kernel path
        dropped = dataclasses.replace(w, blocks=w.blocks[:6] + w.blocks[7:])
        controls = {"block 6 dropped": fused.fused_forward(model, x[:256], dropped)}
        saved = fused.fused_block, fused.fused_block_cls
        fused.fused_block = functools.partial(saved[0], valid_len=289)
        fused.fused_block_cls = functools.partial(saved[1], valid_len=289)
        try:
            controls["keys >= 289 masked"] = fused.fused_forward(model, x[:256], w)
        finally:
            fused.fused_block, fused.fused_block_cls = saved
    controls = {k: float(np.abs(v.cpu().numpy() - plain[:256]).max())
                for k, v in controls.items()}
    err_kp = float(np.abs(preds - plain).max())
    phase("slice", f"predictions |kernel - plain bf16| max {err_kp:.6g} "
          f"(tol {SLICE_TOL}); vs fp32 eager: kernel {np.abs(preds - ref32).max():.6g}, "
          f"plain bf16 {np.abs(plain - ref32).max():.6g}; std across surfaces "
          f"{ref32.std():.4g}; controls (must exceed the tol): "
          + ", ".join(f"{k} {v:.6g}" for k, v in controls.items()))
    if err_kp > SLICE_TOL:
        raise AssertionError("the kernel path disagrees with the plain path")
    if min(controls.values()) <= SLICE_TOL:
        raise AssertionError("a slice control passed the gate")

    with torch.inference_mode():
        for B in (256, 1024):
            xb = torch.from_numpy(
                rng.standard_normal((B, 4, 40962)).astype(np.float32)).to(
                    dev, torch.bfloat16)
            k_ms = cuda_ms(lambda: fused.fused_forward(model, xb, w), reps=10)
            p_ms = cuda_ms(lambda: model(xb), reps=10)
            phase("slice", f"B={B} raw bf16 input on device: kernel path "
                  f"{k_ms:.3f} ms = {B / k_ms * 1e3:.1f} surfaces/s, plain path "
                  f"{p_ms:.3f} ms = {B / p_ms * 1e3:.1f} surfaces/s")
            del xb

    # -- 5. entry point
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        n, bs_val = 40, 16
        sub = rng.standard_normal((n, 4, 40962)).astype(np.float32)
        with torch.inference_mode():
            xs = torch.from_numpy(sub).to(dev)
            batches = [xs[s:s + bs_val] for s in range(0, n, bs_val)]
            ref = torch.cat([model(b) for b in batches]).float().cpu().numpy().reshape(-1)
            ref32 = torch.cat([plain32(b) for b in batches]).cpu().numpy().reshape(-1)
        # labels close to the predictions, so that the MAE is set by them
        labels = (ref32 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        np.save(tmp / "validation_data.npy", sub)
        np.save(tmp / "validation_labels.npy", labels)
        np.savez(tmp / "best_params.npz", **flatten({"params": tree}))
        cfg = {"resolution": {"ico": 6, "sub_ico": 2},
               "transformer": {"dim": DIM, "depth": DEPTH, "heads": HEADS,
                               "mlp_dim": MLP, "dim_head": DH, "pool": "cls"},
               "data": {"data_path": str(tmp), "split": "validation"},
               "training": {"bs": 256, "bs_val": bs_val},
               "testing": {"path_to_ckpt": str(tmp / "best_params.npz")}}
        (tmp / "cfg.json").write_text(json.dumps(cfg))
        cmd = [sys.executable, "-m", "surface_vision_transformers_tpu_torch.cli.test",
               str(tmp / "cfg.json"), "--device", "cuda"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        if res.returncode:
            raise AssertionError(f"cli.test failed ({res.returncode}):\n{res.stderr}")
        with open(tmp / "results.csv") as f:
            rows = list(csv.DictReader(f))
        cli_preds = np.array([float(r["pred"]) for r in rows], np.float32)
        targets = np.array([float(r["target"]) for r in rows], np.float32)
        if len(rows) != n or not np.array_equal(targets, labels):
            raise AssertionError(f"results.csv: {len(rows)} rows, targets out of order")
        reported = ast.literal_eval(res.stdout.strip().splitlines()[-1])
        same = fused.predict(model, sub, device="cuda", batch_size=bs_val).reshape(-1)
        err_cli = float(np.abs(cli_preds - same).max())
        shifted = float(np.abs(cli_preds - np.roll(same, 1)).max())  # control
        err_ref = float(np.abs(same - ref).max())
        mae_cli = float(np.abs(cli_preds - targets).mean())
        mae_plain = float(np.abs(ref - labels).mean())
        phase("entry", f"cli.test in {time.perf_counter() - t0:.1f} s: {reported}; "
              f"results.csv {len(rows)} rows; |pred - predict(batch {bs_val})| max "
              f"{err_cli:.6g} (must be 0; control, rows shifted by one: "
              f"{shifted:.6g}); predict vs plain bf16 at batch {bs_val} max "
              f"{err_ref:.6g} (tol {SLICE_TOL}); MAE {mae_cli:.6f} (printed "
              f"{reported['mae']:.6f}) vs plain path {mae_plain:.6f}, may differ "
              f"by at most {err_ref:.6g}; vs fp32 eager "
              f"{np.abs(ref32 - labels).mean():.6f}")
        if err_cli != 0 or shifted == 0:
            raise AssertionError("cli.test's results.csv disagrees with predict")
        if abs(reported["mae"] - mae_cli) > 1e-6 or reported["n"] != n:
            raise AssertionError("cli.test's MAE disagrees with its results.csv")
        if err_ref > SLICE_TOL or abs(mae_cli - mae_plain) > err_ref + 1e-6:
            raise AssertionError("cli.test's MAE disagrees with the plain path")

    print(json.dumps({"kernels": [kernels[k] for k in sorted(kernels)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
