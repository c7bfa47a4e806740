#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths
(surface_vision_transformers_tpu_torch) at the full width of SiT-tiny
(ico-6 sub-ico-2, dim 192, depth 12, 3 heads, mlp 768) with random weights
made from a numpy seed. Phases, one line each; any failure raises, so the
script exits non-zero and prints no result:

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
6. train-kernels -- each backward kernel's 12 outputs (dx and 11 parameter
              gradients) at B=256, N=321 and at N=328 / valid_len 321, at
              SiT-tiny and SiT-small width, against the float32 and the
              bf16 plain backward on the same bf16 inputs, with controls
              (softmax scale x1.1, key mask ignored, LayerNorm-backward mean
              term dropped) the same gate must reject; CUDA-event times
              beside the eager bf16 block's autograd backward.
7. train   -- ten SGD-momentum steps of ``Trainer`` (``fused_train_forward``
              on the kernels) at full depth, B=256 raw surfaces with a
              planted label, against the eager bf16 ``SiT`` under autograd
              from the same float32 masters and batches: per-step losses and
              every parameter's update must agree, the loss must fall, the
              kernels launch 11 + 1 times per step each way, and a control
              (one block's dW_fc1 zeroed) must fail the update gate;
              steps/s and training surfaces/s of both paths.
8. train-entry -- ``python -m surface_vision_transformers_tpu_torch.cli.train``
              on a synthetic npy split in a subprocess: best_params.npz,
              preds.csv and hparams_results.yml written, the val MAE falls,
              and ``cli.test`` on best_params.npz reports the best epoch's
              val MAE.

Then a JSON line of per-kernel results, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import ast
import contextlib
import copy
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
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SOURCE = "surface_vision_transformers_tpu_torch/csrc/fused_block.cu"
BWD_SOURCE = "surface_vision_transformers_tpu_torch/csrc/fused_block_bwd.cu"
REPLACES = {
    "fused_block": "surface_vision_transformers_tpu/ops/pallas/fused_block.py:251",
    "fused_block_cls": "surface_vision_transformers_tpu/ops/pallas/fused_block.py:1381",
    "fused_block_bwd": "surface_vision_transformers_tpu/ops/pallas/fused_block.py:525",
    "fused_block_cls_bwd": "surface_vision_transformers_tpu/ops/pallas/fused_block.py:1606",
}
# The H100 SXM's dense bf16 tensor-core peak and HBM3 rate (NVIDIA's data
# sheet): a kernel's bound is the larger of its operations and its bytes
# (each input read once, each output written once) over these.
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
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
# Phase 6: each backward output within BWD_STEPS bf16 steps, at its largest
# |float32 plain| value, of the float32 and of the bf16 plain backward.
BWD_STEPS = 2
WIDTHS = {"SiT-tiny": (192, 3, 768), "SiT-small": (384, 6, 1536)}
G_SCALE = 0.01  # scale of the seeded cotangents (the gate is relative)
GRAD_NAMES = ("dx", "d_ln1_scale", "d_ln1_bias", "d_w_qkv", "d_w_out", "d_b_out",
              "d_ln2_scale", "d_ln2_bias", "d_w_fc1", "d_b_fc1", "d_w_fc2", "d_b_fc2")
# Phase 7: ten steps of SGD, momentum 0.9, at LR 1e-4 (ten times the
# recipe's 1e-5, so that the loss moves within ten steps), on two
# alternating batches of 256.
TRAIN_LR, TRAIN_STEPS, TRAIN_B = 1e-4, 10, 256
# Gates set from readings on an H100: the largest relative per-step loss gap
# read 1.6e-4 and the worst per-tensor update gap 0.0083 of the largest
# eager update; the control (one block's dW_fc1 zeroed) reads 1.75e-3 and
# 1.0.
TRAIN_LOSS_TOL = 1e-3  # relative, per step, kernel path vs eager bf16
TRAIN_UPD_TOL = 0.05  # max |update difference| / max |eager update|, per tensor


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
                cls = name == "fused_block_cls"
                flops = block_flops(B, N, vl, DIM, HEADS, MLP, cls)[0]
                nbytes = nbytes_of(x, *params) + got.numel() * 2
                b_ms, b_by = bound_ms(flops, nbytes)
                phase("kernels", f"{name} B={B} N={N}: kernel {ms:.4f} ms, eager "
                      f"bf16 SiT block {plain_ms:.4f} ms (median of 25, CUDA events); "
                      f"bound {b_ms:.4f} ms by {b_by} ({flops / 1e9:.1f} GFLOP, "
                      f"{nbytes / 1e6:.1f} MB)")
                results[name] = {"name": name, "route": "cuda", "source": SOURCE,
                                 "replaces": REPLACES[name], "max_abs_err": err,
                                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "library_ms": None}
    return results


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM rate, in ms."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def block_flops(B, N, vl, dim, heads, mlp, cls):
    """(forward, backward) operations of one block at these shapes; the
    attention products count only the rows and keys < valid_len that this
    input needs. Forward: the four GEMMs and Q.K^T, P.V; backward: dX and dW
    of each GEMM and the attention's four gradient products (dV, dP, dQ,
    dK). What a design recomputes (the kernels recompute S from the kept
    LSE) is its own cost, not part of the bound."""
    hd, M = heads * DH, B * N
    rows = min(8, N) if cls else N
    Mt = B * rows
    if cls:
        gemm = 2 * (M * dim * 2 * hd + Mt * dim * hd + Mt * hd * dim + 2 * Mt * dim * mlp)
    else:
        gemm = 2 * M * (dim * 3 * hd + hd * dim + 2 * dim * mlp)
    prod = 2 * B * heads * min(rows, vl) * min(N, vl) * DH
    return gemm + 2 * prod, 2 * gemm + 4 * prod


def grad_bound_ratio(got, ref32, vl):
    """Largest |a - ref32| over its bound (BWD_STEPS bf16 steps at the
    largest |ref32|) across the 12 gradients, dx on the rows < valid_len;
    and the largest absolute error."""
    worst, abs_err = 0.0, 0.0
    for a, r in zip(got, ref32):
        a, r = a.float(), r.float()
        if a.dim() == 3:
            a, r = a[:, :vl], r[:, :vl]
        e = (a - r).abs().max().item()
        abs_err = max(abs_err, e)
        worst = max(worst, e / (BWD_STEPS * bf16_step(r.abs().max().item())))
    return worst, abs_err


def block_params(rng, dim, heads, mlp):
    """The 11 block parameters (torch layout, float32) with the attention
    gains of the phase-3 weights."""
    hd = heads * DH

    def u(shape, fan_in, gain=1.0):
        b = gain / np.sqrt(fan_in)
        return torch.from_numpy(rng.uniform(-b, b, shape).astype(np.float32))

    def ln():
        return (torch.from_numpy((1 + 0.1 * rng.standard_normal(dim)).astype(np.float32)),
                torch.from_numpy((0.1 * rng.standard_normal(dim)).astype(np.float32)))

    (s1, b1), (s2, b2) = ln(), ln()
    w_qkv = u((3 * hd, dim), dim)
    w_qkv[:2 * hd] *= QK_GAIN
    return [s1, b1, w_qkv, u((dim, hd), hd, OUT_GAIN), u((dim,), hd), s2, b2,
            u((mlp, dim), dim), u((mlp,), dim), u((dim, mlp), mlp), u((dim,), mlp)]


def ln_bwd_without_mean(fb):
    """The plain LayerNorm backward with its mean(d) term dropped (control)."""
    def ln_bwd(dh, x, stats, scale):
        n = (x.float() - stats[..., :1]) * stats[..., 1:]
        d = dh * scale
        dx = (d - n * (d * n).mean(-1, keepdim=True)) * stats[..., 1:]
        return dx, fb._colsum(dh * n), fb._colsum(dh)
    return ln_bwd


def phase_train_kernels(rng, fb, sit_module) -> dict:
    """Phase 6: each backward kernel at B=256 against the float32 and the
    bf16 plain backward on the same bf16 inputs, at SiT-tiny and SiT-small
    width; times at SiT-tiny beside the eager bf16 block's autograd
    backward."""
    results = {}
    attn_bwd = fb._attention_bwd
    for width, (dim, heads, mlp) in WIDTHS.items():
        p32 = [t.cuda() for t in block_params(rng, dim, heads, mlp)]
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous() for t in p32]
        pr = [t.float() for t in pb]  # the bf16 values, in float32
        kw = dict(heads=heads, dim_head=DH)
        for B, N, vl in [(256, N_TOKENS, N_TOKENS), (256, 328, N_TOKENS)]:
            x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N, dim)).astype(
                np.float32)).to("cuda", torch.bfloat16)
            for name, cls in (("fused_block_bwd", False), ("fused_block_cls_bwd", True)):
                rows = 8 if cls else N
                g_np = (G_SCALE * rng.standard_normal((B, rows, dim))).astype(np.float32)
                g_np[:, vl:] = 0.0
                g = torch.from_numpy(g_np).to("cuda", torch.bfloat16)
                kernel = fb.fused_block_cls_bwd if cls else fb.fused_block_bwd
                plain = fb.fused_block_cls_bwd_reference if cls else fb.fused_block_bwd_reference
                out, sv = fb.train_forward(x, *pb, valid_len=vl, cls=cls, **kw)
                serving = (fb.fused_block_cls if cls else fb.fused_block)(
                    x, *pb, valid_len=vl, **kw)
                same_fwd = bool(torch.equal(out, serving))
                got = kernel(x, g, *pb, saved=sv, valid_len=vl, **kw)
                ref32 = plain(x.float(), g.float(), *pr, valid_len=vl, **kw)
                ref_bf = plain(x, g, *pb, valid_len=vl, **kw)
                r32, err = grad_bound_ratio(got, ref32, vl)
                rbf, _ = grad_bound_ratio(got, ref_bf, vl)
                rplain, _ = grad_bound_ratio(ref_bf, ref32, vl)

                def control(vl_bwd=vl, **patches):
                    with contextlib.ExitStack() as stack:
                        for k, v in patches.items():
                            stack.enter_context(mock.patch.object(fb, k, v))
                        sv32 = {}
                        fwd = fb.fused_block_cls_reference if cls else fb.fused_block_reference
                        fwd(x.float(), *pr, valid_len=vl, saved=sv32, **kw)
                        bwd = fb._block_cls_bwd_plain if cls else fb._block_bwd_plain
                        return grad_bound_ratio(got, bwd(x.float(), g.float(), pr, sv32,
                                                         heads, DH, vl_bwd), vl)[0]

                if N == N_TOKENS:
                    controls = {
                        "softmax scale x1.1 in the backward": control(
                            _attention_bwd=lambda q, *a: attn_bwd(q * 1.1, *a)),
                        "LayerNorm backward without its mean term": control(
                            _ln_bwd=ln_bwd_without_mean(fb)),
                    }
                else:
                    controls = {"keys 321..327 unmasked in the backward": control(vl_bwd=N)}
                phase("train-kernels", f"{name} {width} B={B} N={N} valid_len={vl}: "
                      f"worst |err|/bound over the 12 gradients vs fp32 plain {r32:.4g} "
                      f"(plain bf16 {rplain:.4g}), vs plain bf16 {rbf:.4g}, bound "
                      f"{BWD_STEPS} bf16 steps at each gradient's largest value; max "
                      f"abs err {err:.6g}; training forward == serving forward: "
                      f"{same_fwd}; controls (must exceed 1): "
                      + ", ".join(f"{k} {v:.4g}" for k, v in controls.items()))
                if not all(bool(torch.isfinite(t).all()) for t in got) or max(r32, rbf) > 1:
                    raise AssertionError(f"{name} disagrees with its plain backward")
                if not same_fwd:
                    raise AssertionError("the training forward changed the forward's output")
                if min(controls.values()) <= 1:
                    raise AssertionError(f"{name}: a control passed the gate")
                if N == N_TOKENS:
                    k_ms = cuda_ms(lambda: kernel(x, g, *pb, saved=sv, valid_len=vl, **kw))
                    e_ms = eager_backward_ms(sit_module, p32, x, g, heads, dim, mlp, cls)
                    flops = block_flops(B, N, vl, dim, heads, mlp, cls)[1]
                    # the function's own inputs and outputs: what the forward
                    # kept for the backward is the design's cost, not the bound's
                    nbytes = nbytes_of(x, g, *pb, *got)
                    b_ms, b_by = bound_ms(flops, nbytes)
                    phase("train-kernels", f"{name} {width} B={B} N={N}: kernel {k_ms:.4f} ms, "
                          f"eager bf16 SiT block autograd backward {e_ms:.4f} ms (median of "
                          f"25, CUDA events); bound {b_ms:.4f} ms by {b_by} "
                          f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
                    if width == "SiT-tiny":
                        results[name] = {
                            "name": name, "route": "cuda", "source": BWD_SOURCE,
                            "replaces": REPLACES[name], "max_abs_err": err, "ms": k_ms,
                            "plain_ms": e_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None}
                del out, serving, sv, got, ref32, ref_bf
                torch.cuda.empty_cache()
    return results


def eager_backward_ms(sit_module, p32, x, g, heads, dim, mlp, cls) -> float:
    """CUDA-event time of the eager bf16 SiT block's autograd backward (the
    whole block; its top rows under CLS), from float32 masters."""
    m = sit_module.SiT(dim=dim, depth=1, heads=heads, mlp_dim=mlp, dim_head=DH,
                       num_patches=x.shape[1] - 1, dtype=torch.bfloat16).cuda()
    from surface_vision_transformers_tpu_torch.models.fused import block_parameters

    params = block_parameters(m)[0]
    with torch.no_grad():
        for p, v in zip(params, p32):
            p.copy_(v)
    attn, ff = m.transformer.layers[0]
    xr = x.detach().requires_grad_()
    x1 = xr + attn(xr)
    out = x1 + ff(x1)
    if cls:
        out = out[:, :g.shape[1]]
    return cuda_ms(lambda: torch.autograd.grad(out, [xr, *params], g, retain_graph=True))


def phase_train(table) -> dict:
    """Phase 7: ten optimizer steps of the port's trainer (kernels forward
    and backward) against the eager bf16 SiT under autograd, from the same
    float32 masters and batches. -> launches of the four kernels."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
    from surface_vision_transformers_tpu_torch.models.sit import SiT
    from surface_vision_transformers_tpu_torch.ops import fused_block as fb
    from surface_vision_transformers_tpu_torch.train.losses import weighted_mse
    from surface_vision_transformers_tpu_torch.train.optim import Optimizer
    from surface_vision_transformers_tpu_torch.train.trainer import Trainer
    from surface_vision_transformers_tpu_torch.utils import config

    data, labels = make_regression_dataset(2 * TRAIN_B, raw_vertices=40962, seed=SEED)
    data, labels = torch.from_numpy(data).cuda(), torch.from_numpy(labels).cuda()
    batches = [(data[s:s + TRAIN_B], labels[s:s + TRAIN_B]) for s in (0, TRAIN_B)]
    ones = torch.ones(TRAIN_B, device="cuda")
    exp = config.Experiment(
        model=config.ModelConfig(), training=config.TrainingConfig(bs=TRAIN_B),
        data=config.DataConfig(),
        optim=config.OptimConfig(name="SGD", lr=TRAIN_LR, momentum=0.9))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        init = SiT(patch_table=table, dtype=torch.bfloat16).cuda()
    start = init.state_dict()

    def run(step_fn, model):
        """-> (losses, mean step time in s over steps 2..TRAIN_STEPS on the
        host clock, one synchronize at each end of that window; CUDA-event
        time in ms of each of those steps; parameter updates)."""
        losses, events = [], []
        for i in range(TRAIN_STEPS):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if i >= 1:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            xb, yb = batches[i % 2]
            losses.append(step_fn(xb, yb))
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 1)
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        update = {k: (p.detach() - start[k]).float() for k, p in model.named_parameters()}
        return [float(v) for v in losses], step_s, step_ms, update

    def kernel_path(hook_block=None):
        model = copy.deepcopy(init)
        if hook_block is not None:
            w = model.transformer.layers[hook_block][1].fn.net[0].weight
            w.register_hook(torch.zeros_like)  # control: that block's dW_fc1 zeroed
        trainer = Trainer(exp, model)
        return run(lambda xb, yb: trainer.optimizer_step(xb, yb, ones)[0], model)

    def eager_path():
        model = copy.deepcopy(init)
        opt = Optimizer(exp.optim, model.parameters())

        def step(xb, yb):
            opt.zero_grad()
            loss = weighted_mse(model(xb).reshape(-1), yb)
            loss.backward()
            opt.step()
            return loss.detach()
        return run(step, model)

    counters = {"fused_block": fb.fused_block, "fused_block_cls": fb.fused_block_cls,
                "fused_block_bwd": fb.fused_block_bwd,
                "fused_block_cls_bwd": fb.fused_block_cls_bwd}
    for c in counters.values():
        c.launches = 0
    k_loss, k_s, k_ms, k_upd = kernel_path()
    launches = {k: c.launches for k, c in counters.items()}
    e_loss, e_s, e_ms, e_upd = eager_path()
    c_loss, _, _, c_upd = kernel_path(hook_block=5)

    def upd_ratio(upd):
        return max(((upd[k] - e_upd[k]).abs().max() / e_upd[k].abs().max()).item()
                   for k in e_upd)

    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k_loss, e_loss))
    want = {"fused_block": 11 * TRAIN_STEPS, "fused_block_cls": TRAIN_STEPS,
            "fused_block_bwd": 11 * TRAIN_STEPS, "fused_block_cls_bwd": TRAIN_STEPS}
    phase("train", f"{TRAIN_STEPS} SGD steps (momentum 0.9, LR {TRAIN_LR}) at B={TRAIN_B}: "
          f"launches {launches}, expected {want}")
    phase("train", "losses kernel path " + " ".join(f"{v:.6g}" for v in k_loss))
    phase("train", "losses eager bf16  " + " ".join(f"{v:.6g}" for v in e_loss))
    phase("train", f"max relative loss gap {loss_err:.4g} (tol {TRAIN_LOSS_TOL}); worst "
          f"|update - eager update| / max |eager update| over the parameters "
          f"{upd_ratio(k_upd):.4g} (tol {TRAIN_UPD_TOL}); control, block 5's dW_fc1 "
          f"zeroed: {upd_ratio(c_upd):.4g} (must exceed the tol), loss gap "
          f"{max(abs(a - b) / abs(b) for a, b in zip(c_loss, e_loss)):.4g}")
    phase("train", f"steps 2..{TRAIN_STEPS} as one window (host clock, synchronized at "
          f"both ends): kernel path {k_s * 1e3:.3f} ms a step = {1 / k_s:.3f} steps/s = "
          f"{TRAIN_B / k_s:.1f} training surfaces/s; eager bf16 {e_s * 1e3:.3f} ms = "
          f"{1 / e_s:.3f} steps/s = {TRAIN_B / e_s:.1f} surfaces/s")
    for label, ms in (("kernel path", k_ms), ("eager bf16 ", e_ms)):
        phase("train", f"per-step CUDA-event times, steps 2..{TRAIN_STEPS}, {label}: median "
              f"{np.median(ms):.3f} ms; " + " ".join(f"{v:.3f}" for v in ms))
    if launches != want:
        raise AssertionError("the training path did not launch every kernel as expected")
    if not all(math.isfinite(v) for v in k_loss) or k_loss[-1] > 0.5 * k_loss[0]:
        raise AssertionError("the training loss did not fall")
    if loss_err > TRAIN_LOSS_TOL or upd_ratio(k_upd) > TRAIN_UPD_TOL:
        raise AssertionError("the kernel training path disagrees with the eager path")
    if upd_ratio(c_upd) <= TRAIN_UPD_TOL:
        raise AssertionError("the training control passed the gate")
    return launches


def phase_train_entry() -> None:
    """Phase 8: cli.train then cli.test in subprocesses on a synthetic split."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data, labels = make_regression_dataset(612, raw_vertices=40962, seed=SEED + 1)
        for split, sl in (("train", slice(0, 512)), ("validation", slice(512, 612))):
            np.save(tmp / f"{split}_data.npy", data[sl])
            np.save(tmp / f"{split}_labels.npy", labels[sl])
        del data
        cfg = {"resolution": {"ico": 6, "sub_ico": 2},
               "transformer": {"dim": DIM, "depth": DEPTH, "heads": HEADS, "mlp_dim": MLP,
                               "dim_head": DH, "pool": "cls"},
               "data": {"data_path": str(tmp), "split": "validation"},
               "training": {"bs": 256, "bs_val": 64, "epochs": 4, "val_epoch": 1,
                            "LR": TRAIN_LR, "seed": SEED},
               "optimisation": {"optimiser": "SGD"}, "SGD": {"momentum": 0.9},
               "logging": {"folder_to_save_model": str(tmp / "runs")}}
        (tmp / "cfg.json").write_text(json.dumps(cfg))

        def cli(tool, *extra):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", f"surface_vision_transformers_tpu_torch.cli.{tool}",
                 str(tmp / "cfg.json"), "--device", "cuda", *extra],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            if res.returncode:
                raise AssertionError(f"cli.{tool} failed ({res.returncode}):\n{res.stderr}")
            return ast.literal_eval(res.stdout.strip().splitlines()[-1]), time.perf_counter() - t0

        results, t_train = cli("train")
        run_dir = Path(results["run_dir"])
        missing = [f for f in ("best_params.npz", "preds.csv", "hparams_results.yml",
                               "final_params.npz") if not (run_dir / f).exists()]
        with open(run_dir / "metrics_val.csv") as f:
            val_mae = [float(r["val/mae"]) for r in csv.DictReader(f)]
        tested, t_test = cli("test", "--set",
                             f"testing.path_to_ckpt={run_dir / 'best_params.npz'}")
        phase("train-entry", f"cli.train in {t_train:.1f} s: val MAE by epoch "
              + " ".join(f"{v:.6g}" for v in val_mae) + f", best {results['best_mae']:.6g} "
              f"at epoch {results['best_epoch']}; phases_s {results['phases_s']}; files "
              f"missing: {missing or 'none'}; cli.test in {t_test:.1f} s on best_params.npz: "
              f"{tested} (must equal the best val MAE)")
        if missing or len(val_mae) != 4 or not val_mae[-1] < val_mae[0]:
            raise AssertionError("cli.train did not train as expected")
        if tested["n"] != 100 or abs(tested["mae"] - results["best_mae"]) > 1e-4 * results["best_mae"]:
            raise AssertionError("cli.test disagrees with the best epoch's val MAE")


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

    # -- 6. train-kernels
    from surface_vision_transformers_tpu_torch.models import sit as sit_module

    del model, plain32, w
    torch.cuda.empty_cache()
    kernels.update(phase_train_kernels(rng, fb, sit_module))

    # -- 7. train (the training path; every count zeroed just before it)
    launches = phase_train(table)
    for name in ("fused_block_bwd", "fused_block_cls_bwd"):
        kernels[name]["launches"] = launches[name]
    torch.cuda.empty_cache()

    # -- 8. train-entry
    phase_train_entry()

    print(json.dumps({"kernels": [kernels[k] for k in sorted(kernels)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
