#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths
(surface_vision_transformers_tpu_torch) at the full width of SiT-tiny
(ico-6 sub-ico-2, dim 192, depth 12, 3 heads, mlp 768) and of SiT-base
(ico-6 sub-ico-3, below), and its MPP pretraining and dropout training
(phases 14-19), with random weights made from a numpy seed.
Phases, one line each; any failure raises, so the script exits non-zero
and prints no result:

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

Phases 9-13 run SiT-base on the sub-ico-3 grid
(``configs/training/sit_base_subico3.yml``: dim 768, depth 12, 12 heads,
mlp 3072, 1280 patches x 45 vertices, N = 1281 unpadded, the generated
table) at full depth and width:

9. flash-kernels -- ``flash_attention`` forward and backward against the
              float32 and bf16 plain versions at B=16, 12 heads: N=1281,
              N=1288 with valid_len 1281, and 8 queries against 1281 keys;
              then at the training path's B=128, N=1281 with q/k/v read
              through the packed qkv's strides; controls (softmax scale
              x1.1, key mask ignored, the last K/V tile skipped); the forward
              alone at the edges of its tiling (one row short of and past a
              query tile, valid_len inside and on the edge of a key tile,
              the packed strides), a control beside each; CUDA-event times
              at B=128 beside the plain version and SDPA, and the forward at
              SiT-base's serving batch (B=64) beside SDPA.
10. base-kernels -- fused_block, fused_block_cls, fused_block_cls_bwd and the
              recompute route's 12 gradients at SiT-base width, N=1281 and
              the config's bs 128, against the float32 and bf16 plain
              versions (run 16 samples at a time), with phase 3's and 6's
              controls; times at B=32 beside the eager bf16 block.
11. base-slice -- ``predict`` (80 surfaces, batch 64) against the eager bf16
              model with controls; surfaces/s at B=64 and B=128.
12. base-train -- four SGD steps of ``Trainer`` at B=8 against the eager bf16
              SiT under autograd (losses, every parameter's update, a
              control), launches per step by the route rule (11 recompute
              backwards, 11 + 11 flash_attention, 1 fused_block_cls_bwd);
              then four steps at the config's bs 128 (surfaces/s, peak
              memory), the same four steps with every block on the chain
              route for comparison, and a torch.profiler breakdown of one
              step.
13. base-entry -- ``cli.train`` with the shipped config cut to 4 blocks (2
              epochs on a small synthetic split, ``--set`` overrides), then
              ``cli.test`` on its best_params.npz.

Phases 14-19 run the modular attention path and masked-patch pretraining
(MPP) of SiT-tiny (``configs/pretraining/sit_tiny_mpp.yml``: the width
above, N = 321, bs 32, bs_val 32) and supervised training with dropout:

14. qkv-kernels -- ``flash_attention_qkv`` forward and backward (q, k, v and
              dq, dk, dv through the packed (B, N, 3*H*dh) strides) against the
              float32 and bf16 plain versions at B = 32 and 256, N = 321, and
              N = 384 with valid_len 321; controls (last K/V tile skipped,
              softmax scale x1.1, key mask ignored); times beside the plain
              versions and SDPA on the same views; the host time of the
              forward's C entry (its three TMA maps encoded, the launch
              enqueued).
15. dropout-kernels -- ``flash_attention_qkv_dropout`` (rate 0.1) forward and
              backward against the plain versions fed ``dropout_keep_mask`` of
              the same seed, at B = 256, N = 321 and B = 32, N = 384 / 321;
              controls (another seed's mask, the mask dropped in the backward
              only); the kept share read off the forward's own output; times
              beside the plain versions and SDPA with dropout_p.
16. tiled  -- ``flash_attention_tiled`` at B = 2, 3 heads, N = 5,121 (sub-ico
              4) against the plain versions with controls and times; then a
              modular SiT-tiny-width model at that length (depth cut to 2)
              trained three steps through it against plain attention.
17. mpp-slice -- ten fused MPP steps (``fused_mpp_loss``) and ten modular ones
              on the attention kernels (``tpu.fused_train: false``) against
              the modular MPP with plain attention on identical corruption
              (per-step loss, every parameter's update, a control), launches
              per step; a frozen-decoder run; the validation loss through
              ``flash_attention_qkv`` against the plain path with a control;
              training surfaces/s at bs 32 and 256, evaluation at B = 32 and
              256; the modular gate's loss gap at four more data seeds
              (printed, not gated).
18. dropout-train -- ten steps of SiT-tiny with dropout 0.1 at B = 256 on the
              dropout kernel against plain attention on identical masks and
              dropout streams, with a control; launches; the rate beside
              phase 7's fused step.
19. pretrain-entry -- ``cli.pretrain`` with the shipped MPP config, ``cli.test``
              on its best_params.npz (the best val loss), and ``cli.train``
              with the shipped supervised config finetuning from its
              encoder_best_params.npz.

Phases 20-23 run W8A8 int8 serving (``tpu.quant: int8``) of SiT-base on
sub-ico 3 and the gather-fused patch embedding:

20. int8-kernels -- the int8 chain's row quantizer (codes and scales) and
              int8 GEMM (int32 accumulators) bitwise against their plain
              versions at SiT-base shapes (M = 64 x 1281, K 768 and 3072);
              ``fused_block_int8`` against the float32 and bf16 plain int8
              block at dim 768 / N 1281 / B 64, dim 384 / N 321 / B 256,
              N 328 / valid_len 321 and N 64, with controls (one scale per
              tensor, valid_len ignored, x1 rounded to bf16); times beside
              ``fused_block``, ``torch._int_mm`` per GEMM and the bounds,
              and int8 against bf16 block times at dim 192, 384 and 768.
21. patch-embed -- ``patch_embed`` against the float32 and bf16 plain
              versions at sub-ico 2 (B 256, dim 192 and 384) and sub-ico 3
              (B 64, dim 768), with controls (the table shifted by one
              patch, (c v) order); times beside the plain version and
              index_select + matmul.
22. int8-slice -- SiT-base ``predict(quant="int8")`` at bs_val 64: launches
              (11 fused_block_int8, 1 fused_block_cls, 1 patch_embed a
              batch), against the float32 eager model (rel-L2 under 0.02)
              and bf16 ``predict``, with a control; int8 and bf16
              surfaces/s and peak memory at B 64 and 128.
23. int8-entry -- ``cli.test`` on the SiT-base config cut to 4 blocks with
              ``--set tpu.quant=int8`` (results.csv equal to ``predict``),
              and on a SiT-tiny config, where int8 falls back to bf16 with
              one notice.
24. fp32-entry -- ``cli.test --set tpu.compute_dtype=float32 --device cuda``
              on the SiT-tiny config of phase 5: float32 serves the modular
              model (no kernel launches), results.csv equal to in-process
              float32 ``predict`` bit for bit.

Phases 9 and 14-16 also check that the attention backward repeats bit for
bit: two calls on the same inputs give identical dq, dk and dv, and the
same comparison tells a call with one dO element raised by 1 apart; and
that summing the plain version's per-key-block dQ shares in the reverse
order changes dq's bf16 bits at that shape, so a dQ sum taken out of order
would not repeat either. Phase 9 then runs the backward while a kernel on
another stream holds all multiprocessors but one: it must finish, equal
to its run on the idle card, before that kernel ends.

The eager baselines of phases 3-12 run plain attention (``attn_backend=
"plain"``), as their gates were set on it.

Each phase prints its seconds. Then two records lines: the attention
backward and forward rows beside their recorded times under the mma.sync
kernels they replaced (a record, not measured in the run), the forward
rows with their ratio to SDPA in this run and their share of the bound.
Then a JSON line of per-kernel results, and last ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import csv
import dataclasses
import functools
import importlib
import io
import json
import math
import re
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
FLASH_SOURCE = "surface_vision_transformers_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = "surface_vision_transformers_tpu/ops/pallas/flash_attention.py"
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
# controls read 0.24 and more. With the gather-fused embed (its bias added
# before its one rounding, the eager model's after) it reads 0.0168.
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
# Phases 9-13: SiT-base on the sub-ico-3 grid, the shipped config.
BASE_CFG = ROOT / "configs/training/sit_base_subico3.yml"
# flash_attention cases (B, H, Nq, Nk, valid_len): SiT-base's N, the JAX
# package's padded N with its mask, the CLS block's 8 query rows, and last
# the training path's own call (bs 128, q/k/v read through the packed qkv's
# strides), on whose tensors the times are taken.
FLASH_MAIN = (128, 12, 1281, 1281, 1281)
FLASH_CASES = [(16, 12, 1281, 1281, 1281), (16, 12, 1288, 1288, 1281),
               (16, 12, 8, 1281, 1281), FLASH_MAIN]
# The forward at the edges of its tiling (csrc/flash_attention.cu's rule:
# query tiles of 192 rows past 512 keys where that grid fills the card
# twice, else 64; key tiles of 128 past 512 keys, else 64), forward only,
# (B, H, Nq, Nk, valid_len, packed): one row short of and one past a
# 192-row tile, valid_len inside a 128-key tile and on its edge with Nk >
# valid_len; the same at 64-row and 64-key tiles; the packed qkv strides at
# both. Inputs from a generator of their own, so that the phases after
# phase 9 draw the data their gates were set on.
FWD_EDGES = [(32, 12, 191, 600, 577, False), (16, 12, 193, 648, 640, False),
             (32, 12, 63, 330, 321, False), (32, 12, 65, 328, 320, False),
             (16, 12, 640, 640, 577, True), (64, 3, 127, 127, 127, True)]
FWD_SERVE_B = 64  # SiT-base bs_val: the forward timed beside SDPA there too
# The forward rows' times under the mma.sync forward this design replaced,
# each read by the timer its row uses here (PERF.md section 6, NVIDIA H100
# 80GB HBM3 at 700 W): flash_attention at B=128 by this script's CUDA
# events on the mma.sync tree; the others by scripts/flash_fwd_compare.py
# (device_ms, the mma.sync tree's kernel built beside this one's). A record
# printed beside this run's, not a measurement of this run.
MMA_SYNC_FWD_MS = {"flash_attention": 3.1813, "flash_attention B=64": 1.4657,
                   "flash_attention_qkv": 0.0298, "flash_attention_qkv B=256": 0.1420,
                   "flash_attention_qkv_dropout": 0.3157, "flash_attention_tiled": 0.1898}
# Forward rows of this run for the records line: name -> (ms, SDPA ms,
# bound ms), filled by phases 9 and 14-16.
FWD_RECORDS: dict = {}
# Gates set as phases 4 and 7 set theirs, from readings on an H100: the
# prediction gap read 0.0082-0.0097 (std across surfaces 0.14-0.16), the
# controls 0.079 and more; the largest per-step loss gap 1.9e-4 and the
# worst per-tensor update gap 0.0108 of the largest eager update, the
# control 6.8e-3 and 1.0.
BASE_SLICE_TOL = 0.03  # |kernel path - eager bf16| in SiT-base predictions
BASE_TRAIN_B, BASE_TRAIN_STEPS = 8, 4  # the eager comparison's batch and steps
BASE_RATE_STEPS = 4  # steps of the kernel path alone at the config's bs 128
BASE_LOSS_TOL = 1e-3  # relative, per step
# Phase 13's CLI run cuts the shipped SiT-base config to 4 blocks: model
# set-up and checkpoint writes at full depth took ~20 of its 50 s (NVIDIA
# H100 80GB HBM3, 700 W).
BASE_ENTRY_DEPTH = 4
BASE_UPD_TOL = 0.05  # max |update difference| / max |eager update|, per tensor


PHASE_STARTS: dict = {}  # phase name -> host time it started
T0 = time.perf_counter()


def start(name: str) -> None:
    PHASE_STARTS[name] = time.perf_counter()
    print(f"-- {name} (at {PHASE_STARTS[name] - T0:.1f} s)", flush=True)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def phase_seconds(t_end: float) -> str:
    """Seconds from each phase's start to the next one's."""
    names = list(PHASE_STARTS)
    ends = [PHASE_STARTS[n] for n in names[1:]] + [t_end]
    return ", ".join(f"{n} {e - PHASE_STARTS[n]:.1f}" for n, e in zip(names, ends))


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


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around ``reps``
    calls queued on the stream behind a kernel that holds it (``HOLD_SRC``,
    one CTA) until they are all enqueued, so the device runs them back to
    back and never waits for the host's next launch; after two warm-up
    calls. Not torch.profiler's sum of kernel times: late in this script's
    run that read short kernels up to five times below their device time,
    some below their bound."""
    import ctypes

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_ns = int((2 * enqueue_s + 0.005) * 1e9)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    err = hold_lib().hold_sms(1, 0, hold_ns,
                              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"device_ms: the holding kernel did not launch (CUDA error {err})")
    if queued_s * 1e9 >= hold_ns:
        raise AssertionError("device_ms: the calls were not all queued before the hold ended")
    return a.elapsed_time(b) / reps


def jax_shaped_params(rng, num_vertices: int, num_channels: int = 4,
                      width=(DIM, DEPTH, HEADS, MLP), n_tokens: int = N_TOKENS) -> dict:
    """A numpy tree shaped like the JAX SiT's params (flax (in, out)
    kernels) at ``width`` = (dim, depth, heads, mlp): torch-Linear-style
    uniform init, perturbed LayerNorms, and the attention gains above."""
    dim, depth, heads, mlp = width
    hd = heads * DH

    def lin(fan_in, fan_out, bias=True, gain=1.0):
        b = 1.0 / np.sqrt(fan_in)
        d = {"kernel": gain * rng.uniform(-b, b, (fan_in, fan_out)).astype(np.float32)}
        if bias:
            d["bias"] = rng.uniform(-b, b, fan_out).astype(np.float32)
        return d

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(dim)).astype(np.float32)}

    pe = lin(num_channels * num_vertices, dim)
    enc = {}
    for i in range(depth):
        qkv = lin(dim, 3 * hd, bias=False)
        qkv["kernel"][:, :2 * hd] *= QK_GAIN
        enc[f"layers_{i}_attn"] = {"norm": ln(), "to_qkv": qkv,
                                   "to_out": lin(hd, dim, gain=OUT_GAIN)}
        enc[f"layers_{i}_mlp"] = {"norm": ln(), "fc1": lin(dim, mlp),
                                  "fc2": lin(mlp, dim)}
    return {
        "patch_embedding_kernel": pe["kernel"],
        "patch_embedding_bias": pe["bias"],
        "pos_embedding": (POS_STD * rng.standard_normal((1, n_tokens, dim))).astype(np.float32),
        "cls_token": rng.standard_normal((1, 1, dim)).astype(np.float32),
        "encoder": enc, "head_norm": ln(), "head": lin(dim, 1),
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


def zero_keys_reference(fb, x, p, rows, heads=HEADS):
    """The block in float32 as it would come out if the attention kernel
    left its zero-filled keys (N up to a multiple of its 64-key K/V tiles)
    unmasked."""
    N, hd = x.shape[1], heads * DH
    h = fb._layer_norm(x, p[0], p[1], 1e-5)
    qkv = fb._mm(h, p[2])
    pad = -(-N // 64) * 64
    kv = F.pad(qkv[..., hd:], (0, 0, 0, pad - N))
    attn = fb._attention(qkv[:, :rows, :hd], kv[..., :hd], kv[..., hd:],
                         heads, DH, pad, x.dtype)
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


def attention_flops(B, H, nq, nk):
    """(forward, backward) operations of attention over nq query rows and nk
    keys (those a run needs): the forward's two products (Q.K^T, P.V); the
    backward's five, 2.5x the forward's, since its inputs are q, k, v, o,
    lse and dO: S = Q.K^T again, dP, dV, dQ, dK. Every attention bound of
    this script counts them here."""
    fwd = 4 * B * H * nq * nk * DH
    return fwd, 2.5 * fwd


def block_flops(B, N, vl, dim, heads, mlp, cls):
    """(forward, backward) operations of one block at these shapes; the
    attention products count only the rows and keys < valid_len that this
    input needs. Forward: the four GEMMs and the attention's forward;
    backward: dX and dW of each GEMM and the attention's backward
    (``attention_flops``). What a design keeps or recomputes beyond that is
    its own cost, not part of the bound."""
    hd, M = heads * DH, B * N
    rows = min(8, N) if cls else N
    Mt = B * rows
    if cls:
        gemm = 2 * (M * dim * 2 * hd + Mt * dim * hd + Mt * hd * dim + 2 * Mt * dim * mlp)
    else:
        gemm = 2 * M * (dim * 3 * hd + hd * dim + 2 * dim * mlp)
    att_f, att_b = attention_flops(B, heads, min(rows, vl), min(N, vl))
    return gemm + att_f, 2 * gemm + att_b


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


def sliced(fn, *batched, chunk: int = 16):
    """``fn`` on ``chunk`` samples of each batched argument at a time (the
    plain versions hold float32 scores), the results joined: tensors
    concatenated along the batch; of a backward's 12 outputs, dx
    concatenated and the parameter gradients summed."""
    outs = [fn(*(t[s:s + chunk] for t in batched))
            for s in range(0, batched[0].shape[0], chunk)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return (torch.cat([o[0] for o in outs]),
            *(sum(o[i] for o in outs) for i in range(1, len(outs[0]))))


def bwd_control(fb, x, g, pr, heads, vl, cls, got, vl_bwd, chunk=None, **patches):
    """|got| against the float32 plain backward with ``patches`` applied to
    the plain functions (and keys up to ``vl_bwd`` in the backward), as the
    worst ratio to the gate (``grad_bound_ratio``); the plain backward runs
    ``chunk`` samples at a time (default: the whole batch)."""
    kw = dict(heads=heads, dim_head=DH)
    fwd = fb.fused_block_cls_reference if cls else fb.fused_block_reference

    def plain(xs, gs):
        sv32 = {}
        fwd(xs.float(), *pr, valid_len=vl, saved=sv32, **kw)
        bwd = fb._block_cls_bwd_plain if cls else fb._block_bwd_plain
        return bwd(xs.float(), gs.float(), pr, sv32, heads, DH, vl_bwd)

    with contextlib.ExitStack() as stack:
        for k, v in patches.items():
            stack.enter_context(mock.patch.object(fb, k, v))
        return grad_bound_ratio(got, sliced(plain, x, g, chunk=chunk or x.shape[0]), vl)[0]


def bwd_controls(fb, control) -> dict:
    """The backward gate's controls: a wrong softmax scale, a LayerNorm
    backward without its mean term."""
    attn_bwd = fb._attention_bwd
    return {
        "softmax scale x1.1 in the backward": control(
            _attention_bwd=lambda q, *a: attn_bwd(q * 1.1, *a)),
        "LayerNorm backward without its mean term": control(
            _ln_bwd=ln_bwd_without_mean(fb)),
    }


def phase_train_kernels(rng, fb, sit_module) -> dict:
    """Phase 6: each backward kernel at B=256 against the float32 and the
    bf16 plain backward on the same bf16 inputs, at SiT-tiny and SiT-small
    width; times at SiT-tiny beside the eager bf16 block's autograd
    backward."""
    results = {}
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
                    return bwd_control(fb, x, g, pr, heads, vl, cls, got, vl_bwd, **patches)

                if N == N_TOKENS:
                    controls = bwd_controls(fb, control)
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
                       num_patches=x.shape[1] - 1, dtype=torch.bfloat16,
                       attn_backend="plain").cuda()
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


def run_steps(step_fn, model, start, batches, steps):
    """``steps`` calls of step_fn on alternating batches -> (losses, mean
    step time in s over steps 2..steps on the host clock, one synchronize at
    each end of that window; CUDA-event time in ms of each of those steps;
    parameter updates from ``start``)."""
    losses, events = [], []
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if i >= 1:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        xb, yb = batches[i % len(batches)]
        losses.append(step_fn(xb, yb))
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (steps - 1)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    update = {k: (p.detach() - start[k]).float() for k, p in model.named_parameters()}
    return [float(v) for v in losses], step_s, step_ms, update


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
        init = SiT(patch_table=table, dtype=torch.bfloat16, attn_backend="plain").cuda()
    start = init.state_dict()

    def run(step_fn, model):
        return run_steps(step_fn, model, start, batches, TRAIN_STEPS)

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

    counters = zero_counts(fb)
    k_loss, k_s, k_ms, k_upd = kernel_path()
    launches = read_counts(counters)
    e_loss, e_s, e_ms, e_upd = eager_path()
    c_loss, _, _, c_upd = kernel_path(hook_block=5)

    def upd_ratio(upd):
        return max(((upd[k] - e_upd[k]).abs().max() / e_upd[k].abs().max()).item()
                   for k in e_upd)

    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k_loss, e_loss))
    want = {k: 0 for k in counters}
    want.update(fused_block=11 * TRAIN_STEPS, fused_block_cls=TRAIN_STEPS,
                fused_block_bwd=11 * TRAIN_STEPS, fused_block_cls_bwd=TRAIN_STEPS,
                patch_embed=TRAIN_STEPS)
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
    return launches, k_s


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


def ptxas_report(log_path: Path) -> str:
    """Registers per kernel and any spills, from the build's ``-Xptxas=-v``
    report."""
    regs, spills, name = {}, [], None
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            fwd = re.search(r"flash_fwd_kernelILi(\d)ELi(\d+)ELb(\d)E", mangled)
            name = f"flash_fwd<{','.join(fwd.groups())}>" if fwd else next((k for k in (
                "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_kernel", "ln_bwd", "gemm_bwd",
                "int8_gemm", "gemm_kernel", "layer_norm", "reduce", "ln_quant", "quant_rows",
                "patch_embed") if k in mangled), mangled[:40])
        elif name and "registers" in line:
            regs[name] = max(regs.get(name, 0), int(line.split("Used ")[1].split()[0]))
        elif name and "spill" in line and " 0 bytes spill stores" not in line:
            spills.append(f"{name}: {line.strip()}")
    return (", ".join(f"{k} {v} registers" for k, v in sorted(regs.items()))
            + "; spills: " + ("; ".join(spills) or "none"))


def kernel_counters(fb) -> dict:
    """Every kernel wrapper's launch counter (and the recompute route's), by
    kernel name."""
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa
    from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as fbi8
    from surface_vision_transformers_tpu_torch.ops import patch_embed as pe

    return {"fused_block": fb.fused_block, "fused_block_cls": fb.fused_block_cls,
            "fused_block_bwd": fb.fused_block_bwd,
            "fused_block_cls_bwd": fb.fused_block_cls_bwd,
            "fused_block_recompute_bwd": fb.fused_block_recompute_bwd,
            "flash_attention": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "flash_attention_qkv": fa.flash_attention_qkv_fwd,
            "flash_attention_qkv_bwd": fa.flash_attention_qkv_bwd,
            "flash_attention_qkv_dropout": fa.flash_attention_qkv_dropout_fwd,
            "flash_attention_qkv_dropout_bwd": fa.flash_attention_qkv_dropout_bwd,
            "flash_attention_tiled": fa.flash_attention_tiled_fwd,
            "flash_attention_tiled_bwd": fa.flash_attention_tiled_bwd,
            "fused_block_int8": fbi8.fused_block_int8, "patch_embed": pe.patch_embed}


def zero_counts(fb) -> dict:
    counters = kernel_counters(fb)
    for c in counters.values():
        c.launches = 0
    return counters


def read_counts(counters) -> dict:
    return {k: c.launches for k, c in counters.items()}


def phase_flash(rng) -> dict:
    """Phase 9: flash_attention forward and backward against the float32
    and bf16 plain versions on the same bf16 inputs, with controls; then
    CUDA-event times at the training path's shape beside the plain version
    and SDPA."""
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa

    def t(shape, sc=1.0):
        return torch.from_numpy((sc * rng.standard_normal(shape)).astype(np.float32)).to(
            "cuda", torch.bfloat16)

    def outputs(q, k, v, do, vl, dtype=None):
        """(o, dq, dk, dv) of the plain versions, in ``dtype`` (float32: the
        exact reference; None: the inputs' bf16), 16 samples at a time (the
        plain versions hold float32 scores)."""
        parts = []
        for s in range(0, q.shape[0], 16):
            a = [x[s:s + 16].to(dtype) if dtype else x[s:s + 16] for x in (q, k, v, do)]
            o, lse = fa.flash_attention_reference(*a[:3], vl)
            parts.append([o, *fa.flash_attention_bwd_reference(*a[:3], o, lse, a[3], vl)])
        return [torch.cat(p) for p in zip(*parts)]

    def ratio(got, want, ref32):
        """Largest |got - want| over BOUND_STEPS bf16 steps at the largest
        |ref32| of each output."""
        return max((a.float() - b.float()).abs().max().item()
                   / (BOUND_STEPS * bf16_step(r.abs().max().item()))
                   for a, b, r in zip(got, want, ref32))

    def packed(B, H, N):
        """q, k, v and do as the recompute route hands them to the kernel:
        (B, H, N, dh) views of the packed (B, N, 3*H*dh) qkv and of the
        (B, N, H*dh) attention-output cotangent."""
        qkv = torch.cat([t((B, N, 2, H, DH), 1.5), t((B, N, 1, H, DH))], 2)
        return (*(x.transpose(1, 2) for x in qkv.unbind(2)),
                t((B, N, H, DH)).transpose(1, 2))

    for B, H, nq, nk, vl in FLASH_CASES:
        if (B, H, nq, nk, vl) == FLASH_MAIN:
            q, k, v, do = packed(B, H, nq)
        else:
            q, k, v = t((B, H, nq, DH), 1.5), t((B, H, nk, DH), 1.5), t((B, H, nk, DH))
            do = t((B, H, nq, DH))
        o, lse = fa.flash_attention_fwd(q, k, v, vl)
        got = [o, *fa.flash_attention_bwd(q, k, v, o, lse, do, vl)]
        ref32 = outputs(q, k, v, do, vl, torch.float32)
        ref_bf = outputs(q, k, v, do, vl)
        r32, rbf, rplain = ratio(got, ref32, ref32), ratio(got, ref_bf, ref32), ratio(
            ref_bf, ref32, ref32)
        del ref_bf
        errs = [(a.float() - r).abs().max().item() for a, r in zip(got, ref32)]
        last = (min(vl, nk) - 1) // 64 * 64  # the last 64-key K/V tile dropped
        controls = {"last K/V tile skipped": ratio(
            got, outputs(q, k, v, do, last, torch.float32), ref32)}
        if nk > vl:
            controls[f"key mask ignored (keys {vl}..{nk - 1})"] = ratio(
                got, outputs(q, k, v, do, nk, torch.float32), ref32)
        else:
            controls["softmax scale x1.1"] = ratio(
                got, outputs(q.float() * 1.1, k, v, do, vl, torch.float32), ref32)
        main = (B, H, nq, nk, vl) == FLASH_MAIN
        phase("flash-kernels", f"B={B} H={H} Nq={nq} Nk={nk} valid_len={vl}"
              f"{' (packed q/k/v strides, the training path)' if main else ''}: worst "
              f"|err|/bound over o, dq, dk, dv vs fp32 plain {r32:.4g} (plain bf16 "
              f"{rplain:.4g}), vs plain bf16 {rbf:.4g}, bound {BOUND_STEPS} bf16 steps at "
              f"each output's largest value; max abs err o {errs[0]:.6g}, dq/dk/dv "
              f"{max(errs[1:]):.6g}; controls (must exceed 1): "
              + ", ".join(f"{k_} {v_:.4g}" for k_, v_ in controls.items()))
        if not all(bool(torch.isfinite(x).all()) for x in got) or max(r32, rbf) > 1:
            raise AssertionError("flash_attention disagrees with its plain version")
        if min(controls.values()) <= 1:
            raise AssertionError("flash_attention: a control passed the gate")
        repeat_check("flash-kernels", f"B={B} H={H} Nq={nq} Nk={nk} valid_len={vl}",
                     lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, vl),
                     lambda: fa.flash_attention_bwd(q, k, v, o, lse, bump(do), vl),
                     lambda: order_control(q, k, v, o, lse, do, vl))
        if main:
            abs_err = {"fwd": errs[0], "bwd": max(errs[1:])}
        del got, ref32
        torch.cuda.empty_cache()

    busy_card(fa)
    fwd_edges(fa)

    # times at the training path's shape, on the main case's tensors
    B, H, N = FLASH_MAIN[:3]
    o, lse = fa.flash_attention_fwd(q, k, v)
    chunks = range(0, B, 16)  # the plain versions in slices that fit memory
    ms = {"fwd": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v)),
          "bwd": cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))}
    plain = {"fwd": cuda_ms(lambda: [fa.flash_attention_reference(
                 q[s:s + 16], k[s:s + 16], v[s:s + 16]) for s in chunks], reps=3),
             "bwd": cuda_ms(lambda: [fa.flash_attention_bwd_reference(
                 q[s:s + 16], k[s:s + 16], v[s:s + 16], o[s:s + 16], lse[s:s + 16],
                 do[s:s + 16]) for s in chunks], reps=3)}
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qr, kr, vr)
    library = {"fwd": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
               "bwd": cuda_ms(lambda: torch.autograd.grad(
                   sdpa_out, (qr, kr, vr), do, retain_graph=True))}
    bounds = dict(zip(("fwd", "bwd"), attention_bound(B, H, N, N, (q, k, v, o, lse),
                                                      (q, k, v, o, lse, do, q, k, v))))
    FWD_RECORDS["flash_attention"] = (ms["fwd"], library["fwd"], bounds["fwd"][0])
    # the forward at the serving batch (SiT-base bs_val), on the first samples
    qs, ks, vs = (x[:FWD_SERVE_B] for x in (q, k, v))
    serve = (device_ms(lambda: fa.flash_attention_fwd(qs, ks, vs)),
             device_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
             attention_bound(FWD_SERVE_B, H, N, N, (qs, ks, vs, o[:FWD_SERVE_B],
                                                     lse[:FWD_SERVE_B]), ())[0][0])
    FWD_RECORDS[f"flash_attention B={FWD_SERVE_B}"] = serve
    phase("flash-kernels", f"flash_attention forward at B={FWD_SERVE_B} H={H} N={N} (SiT-base "
          f"serving; device time, mean of 10 queued calls): kernel {serve[0]:.4f} ms, "
          f"SDPA {serve[1]:.4f} ms ({serve[0] / serve[1]:.3f}x), bound {serve[2]:.4f} ms "
          f"({serve[2] / serve[0]:.1%} of it)")
    results = {}
    for key, name, line in (("fwd", "flash_attention", 265), ("bwd", "flash_attention_bwd", 233)):
        b_ms, b_by = bounds[key]
        phase("flash-kernels", f"{name} B={B} H={H} N={N}: kernel {ms[key]:.4f} ms, plain "
              f"{plain[key]:.4f} ms (8 slices of 16), SDPA {library[key]:.4f} ms (median of "
              f"25, CUDA events; plain of 3); bound {b_ms:.4f} ms by {b_by}")
        results[name] = {"name": name, "route": "cuda", "source": FLASH_SOURCE,
                         "replaces": f"{FLASH_TPU}:{line}", "max_abs_err": abs_err[key],
                         "ms": ms[key], "plain_ms": plain[key], "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": library[key]}
    return results


def fwd_gate(fa, q, k, v, vl) -> tuple[float, float, dict]:
    """The forward against the float32 and bf16 plain forwards on the same
    inputs (16 samples at a time): (worst |err| over BOUND_STEPS bf16 steps
    at the largest |fp32 output| against either, max abs err, controls
    that must exceed 1: the key mask ignored where Nk > valid_len, else the
    softmax scale x1.1)."""
    o, _ = fa.flash_attention_fwd(q, k, v, vl)

    def plain(dtype, vl_=vl, scale=1.0):
        return torch.cat([fa.flash_attention_reference(
            (q[s:s + 16].to(dtype) if dtype else q[s:s + 16]) * scale,
            *(x[s:s + 16].to(dtype) if dtype else x[s:s + 16] for x in (k, v)), vl_)[0]
            for s in range(0, q.shape[0], 16)])

    ref32 = plain(torch.float32)
    bound = BOUND_STEPS * bf16_step(ref32.abs().max().item())
    err32 = (o.float() - ref32).abs().max().item()
    ratio = max(err32, (o.float() - plain(None).float()).abs().max().item()) / bound
    nk = k.shape[2]
    ctrl = (plain(torch.float32, nk) if nk > vl else plain(torch.float32, scale=1.1))
    label = f"key mask ignored (keys {vl}..{nk - 1})" if nk > vl else "softmax scale x1.1"
    controls = {label: (o.float() - ctrl).abs().max().item() / bound}
    if not bool(torch.isfinite(o).all()):
        ratio = math.inf
    return ratio, err32, controls


def fwd_edges(fa) -> None:
    """The forward at the edges of its tiling (FWD_EDGES), each held to the
    two-step gate against the fp32 and bf16 plain forwards with a control
    that must fail it."""
    rng = np.random.default_rng(SEED + 2)
    for B, H, nq, nk, vl, packed in FWD_EDGES:
        if packed:  # (B, H, N, dh) views of a packed (B, N, 3*H*dh) qkv, N = Nq = Nk
            qkv = torch.cat([bf16_randn(rng, (B, nq, 2, H, DH), 1.5),
                             bf16_randn(rng, (B, nq, 1, H, DH))], 2)
            q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        else:
            q, k, v = (bf16_randn(rng, (B, H, nq, DH), 1.5), bf16_randn(rng, (B, H, nk, DH), 1.5),
                       bf16_randn(rng, (B, H, nk, DH)))
        ratio, err, controls = fwd_gate(fa, q, k, v, vl)
        phase("flash-kernels", f"forward edge B={B} H={H} Nq={nq} Nk={k.shape[2]} valid_len={vl}"
              f"{' (packed qkv strides)' if packed else ''}: worst |err|/bound vs fp32 and bf16 "
              f"plain {ratio:.4g} (bound {BOUND_STEPS} bf16 steps), max abs err {err:.6g}; "
              "control (must exceed 1): " + ", ".join(f"{k_} {v_:.4g}"
                                                     for k_, v_ in controls.items()))
        if ratio > 1:
            raise AssertionError("flash_attention's forward disagrees with its plain version at "
                                 "a tiling edge")
        if min(controls.values()) <= 1:
            raise AssertionError("flash_attention's forward: an edge control passed the gate")


# A kernel that holds its multiprocessor for a while: one CTA per SM (its
# shared memory leaves no room for a backward CTA beside it).
HOLD_SRC = r"""
#include <cuda_runtime.h>

__global__ void hold(long long ns) {
  long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < ns);
}

extern "C" int hold_sms(int ctas, int smem, long long ns, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(hold, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  hold<<<ctas, 32, smem, (cudaStream_t)stream>>>(ns);
  return (int)cudaGetLastError();
}
"""
HOLD_MS = 300  # how long the other stream's kernel holds its multiprocessors
BUSY_SHAPE = (1, 12, 1281)  # (B, H, N): SiT-base attention, 12 (sample, head)s x 21 key blocks
HOLD_SMEM = 200 * 1024  # with a backward CTA's ~99 KB, over an SM's 228 KB


@functools.cache
def hold_lib():
    """HOLD_SRC built with nvcc into a shared library and loaded, once."""
    import ctypes

    from surface_vision_transformers_tpu_torch.ops import _native

    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "hold.cu", Path(tmp) / "libhold.so"
        src.write_text(HOLD_SRC)
        subprocess.run([_native._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)], check=True,
                       capture_output=True, timeout=300)
        lib = ctypes.CDLL(str(lib_path))
    lib.hold_sms.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    return lib


def busy_card(fa) -> None:
    """The attention backward while a kernel on another stream holds every
    multiprocessor but one: its key blocks wait only for blocks of lower
    index, never for the whole (sample, head) to be on the card, so it must
    finish on that one SM, equal bit for bit to its run on the idle card,
    before the other kernel ends. Its inputs come from a generator of its
    own, so the phases after it draw the data their gates were set on."""
    import ctypes

    B, H, N = BUSY_SHAPE
    rng = np.random.default_rng(SEED + 1)
    q, k, v = bf16_randn(rng, (B, H, N, DH), 1.5), bf16_randn(rng, (B, H, N, DH), 1.5), \
        bf16_randn(rng, (B, H, N, DH))
    do = bf16_randn(rng, (B, H, N, DH))
    o, lse = fa.flash_attention_fwd(q, k, v)
    idle = fa.flash_attention_bwd(q, k, v, o, lse, do)
    idle_ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))
    lib = hold_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    side = torch.cuda.Stream()
    stream = ctypes.c_void_p(side.cuda_stream)
    # a first launch loads the holding kernel's module, which would wait for
    # the card to go idle if it came while the backward runs
    err = lib.hold_sms(1, HOLD_SMEM, 0, stream)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        ev[0].record()
        err = err or lib.hold_sms(sms - 1, HOLD_SMEM, HOLD_MS * 1_000_000, stream)
        ev[1].record()
    if err:
        raise AssertionError(f"busy card: the holding kernel did not launch (CUDA error {err})")
    time.sleep(0.01)  # the holding kernel takes its SMs before the backward is issued
    ev[2].record()
    busy = fa.flash_attention_bwd(q, k, v, o, lse, do)
    ev[3].record()
    torch.cuda.synchronize()
    hold_ms, done_ms, bwd_ms = (ev[0].elapsed_time(ev[1]), ev[0].elapsed_time(ev[3]),
                                ev[2].elapsed_time(ev[3]))
    same = all(torch.equal(a, b) for a, b in zip(idle, busy))
    phase("flash-kernels", f"busy card: B={B} H={H} N={N} backward while {sms - 1} of {sms} "
          f"SMs are held for {HOLD_MS} ms by a kernel on another stream: done {done_ms:.2f} ms "
          f"after that kernel's start, which ended at {hold_ms:.2f} ms (must be later); the "
          f"backward took {bwd_ms:.3f} ms, {bwd_ms / idle_ms:.1f}x its {idle_ms:.4f} ms on "
          f"the idle card (CUDA events); equal to the idle card's dq, dk, dv bit for bit "
          f"{same} (must be True)")
    if not same:
        raise AssertionError("busy card: the backward's outputs differ from the idle card's")
    if done_ms >= hold_ms:
        raise AssertionError("busy card: the backward waited for the other stream's kernel")


def phase_base_kernels(rng, fb, sit_module, m, bs) -> None:
    """Phase 10: at SiT-base width, N = 1281 and the config's batch ``bs``
    (the shapes the training path gives them), fused_block and
    fused_block_cls (streamed attention), fused_block_cls_bwd (LayerNorm
    backward at dim 768, the attention backward) and the recompute route's 12
    gradients, each against the float32 and the bf16 plain version on the
    same bf16 inputs (run 16 samples at a time), with phase 3's and phase
    6's controls; times at B=32 beside the eager bf16 block."""
    dim, heads, mlp, hd = m.dim, m.heads, m.mlp_dim, m.heads * m.dim_head
    N = m.num_patches + 1
    p32 = [x.cuda() for x in block_params(rng, dim, heads, mlp)]
    pb = [(x.bfloat16() if x.dim() == 2 else x).contiguous() for x in p32]
    pr = [x.float() for x in pb]
    q_scaled = list(pr)
    q_scaled[2] = pr[2].clone()
    q_scaled[2][:hd] *= 1.1
    kw = dict(heads=heads, dim_head=DH)
    B = bs
    x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N, dim)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    for name, kernel, plain in (("fused_block", fb.fused_block, fb.fused_block_reference),
                                ("fused_block_cls", fb.fused_block_cls,
                                 fb.fused_block_cls_reference)):
        got = kernel(x, *pb, **kw).float()

        def dist(fn):
            return (got - sliced(fn, x)).abs().max().item()

        ref32 = sliced(lambda xs: plain(xs.float(), *pr, **kw), x)
        err = (got - ref32).abs().max().item()
        err_bf16 = dist(lambda xs: plain(xs, *pb, **kw).float())
        bound = BOUND_STEPS * bf16_step(ref32.abs().max().item())
        del ref32
        controls = {
            "softmax scale x1.1": dist(lambda xs: plain(xs.float(), *q_scaled, **kw)),
            "zero-filled keys to 1344 unmasked": dist(lambda xs: zero_keys_reference(
                fb, xs.float(), pr, got.shape[1], heads))}
        phase("base-kernels", f"{name} SiT-base B={B} N={N}: max abs err vs fp32 plain "
              f"{err:.6g}, vs plain bf16 {err_bf16:.6g}, bound {bound:.6g} ({BOUND_STEPS} "
              "bf16 steps at the largest output); controls (must exceed the bound): "
              + ", ".join(f"{k_} {v_:.6g}" for k_, v_ in controls.items()))
        if not bool(torch.isfinite(got).all()) or max(err, err_bf16) > bound:
            raise AssertionError(f"{name} disagrees with its plain version at SiT-base")
        if min(controls.values()) <= bound:
            raise AssertionError(f"{name}: a control passed the gate at SiT-base")
    for name, cls in (("fused_block_cls_bwd", True), ("fused_block_recompute_bwd", False)):
        rows = 8 if cls else N
        g = torch.from_numpy((G_SCALE * rng.standard_normal((B, rows, dim))).astype(
            np.float32)).to("cuda", torch.bfloat16)
        if cls:
            _, sv = fb.train_forward(x, *pb, cls=True, **kw)
            got = fb.fused_block_cls_bwd(x, g, *pb, saved=sv, **kw)
            del sv
        else:  # float32 masters, as the trainer passes them
            got = fb.fused_block_recompute_bwd(x, g, *p32, **kw)
        plain = fb.fused_block_cls_bwd_reference if cls else fb.fused_block_bwd_reference
        ref32 = sliced(lambda xs, gs: plain(xs.float(), gs.float(), *pr, **kw), x, g)
        r32, err = grad_bound_ratio(got, ref32, N)
        rbf, _ = grad_bound_ratio(got, sliced(lambda xs, gs: plain(xs, gs, *pb, **kw), x, g), N)
        controls = bwd_controls(fb, lambda **patches: bwd_control(
            fb, x, g, pr, heads, N, cls, got, N, chunk=16, **patches))
        phase("base-kernels", f"{name} SiT-base B={B} N={N}: worst |err|/bound over the 12 "
              f"gradients vs fp32 plain {r32:.4g}, vs plain bf16 {rbf:.4g}; max abs err "
              f"{err:.6g}; controls (must exceed 1): "
              + ", ".join(f"{k_} {v_:.4g}" for k_, v_ in controls.items()))
        if not all(bool(torch.isfinite(a).all()) for a in got) or max(r32, rbf) > 1:
            raise AssertionError(f"{name} disagrees with its plain backward at SiT-base")
        if min(controls.values()) <= 1:
            raise AssertionError(f"{name}: a control passed the gate at SiT-base")
        del got, ref32
        torch.cuda.empty_cache()

    # times at B = 32 (the eager block's fp32 scores fit)
    B = 32
    x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N, dim)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    layer = sit_module.SiT(dim=dim, depth=1, heads=heads, mlp_dim=mlp, dim_head=DH,
                           num_patches=N - 1, dtype=torch.bfloat16,
                           attn_backend="plain").cuda().transformer.layers[0]

    def eager(xx):
        attn, ff = layer
        x1 = xx + attn(xx)
        return x1 + ff(x1)

    g = torch.from_numpy((G_SCALE * rng.standard_normal((B, N, dim))).astype(
        np.float32)).to("cuda", torch.bfloat16)
    g8 = g[:, :8].contiguous()
    _, sv = fb.train_forward(x, *pb, cls=True, **kw)
    with torch.inference_mode():
        times = {"fused_block": cuda_ms(lambda: fb.fused_block(x, *pb, **kw), reps=10),
                 "fused_block_cls": cuda_ms(lambda: fb.fused_block_cls(x, *pb, **kw), reps=10),
                 "eager block forward": cuda_ms(lambda: eager(x), reps=10)}
    times["fused_block_cls_bwd"] = cuda_ms(
        lambda: fb.fused_block_cls_bwd(x, g8, *pb, saved=sv, **kw), reps=10)
    times["fused_block_recompute_bwd"] = cuda_ms(
        lambda: fb.fused_block_recompute_bwd(x, g, *p32, **kw), reps=10)
    del sv
    times["eager block autograd backward"] = eager_backward_ms(
        sit_module, p32, x, g, heads, dim, mlp, False)
    phase("base-kernels", f"SiT-base B={B} N={N}, CUDA-event medians of 10 (ms): "
          + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in times.items()))
    fwd_f, bwd_f = block_flops(B, N, N, dim, heads, mlp, False)
    cls_f, cls_b = block_flops(B, N, N, dim, heads, mlp, True)
    io_fwd = nbytes_of(x, *pb) + B * 8 * dim * 2  # the CLS block writes its 8 top rows
    io_bwd = nbytes_of(x, g8, *pb) + x.numel() * 2 + 4 * sum(t.numel() for t in pb)
    phase("base-kernels", f"bounds at B={B}: block forward {bound_ms(fwd_f, 0)[0]:.4f} ms, "
          f"backward {bound_ms(bwd_f, 0)[0]:.4f} ms by operations; fused_block_cls "
          "{:.4f} ms by {}, fused_block_cls_bwd {:.4f} ms by {} (inputs read and outputs "
          "written once)".format(*bound_ms(cls_f, io_fwd), *bound_ms(cls_b, io_bwd)))
    del x, g, g8, layer
    torch.cuda.empty_cache()


def phase_base_slice(rng, fb, fused, exp, table, state) -> None:
    """Phase 11: ``predict`` at SiT-base sub-ico-3, full depth and width,
    against the eager bf16 model, with controls; surfaces/s at the config's
    bs_val 64 and bs 128."""
    from surface_vision_transformers_tpu_torch.models.sit import SiT

    m = exp.model
    model = SiT.from_config(exp, patch_table=table, dtype=torch.bfloat16, attn_backend="plain")
    model.load_state_dict(state, strict=True)
    model = model.eval().cuda()
    w = fused.prepare_weights(model)
    data = rng.standard_normal((80, 4, 40962)).astype(np.float32)
    counters = zero_counts(fb)
    preds = fused.predict(model, data, device="cuda", batch_size=64)
    launches = read_counts(counters)
    want = {k: 0 for k in counters}
    want.update(fused_block=(m.depth - 1) * 2, fused_block_cls=2, patch_embed=2)
    phase("base-slice", f"predict(80 surfaces, batch 64): launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError("the SiT-base serving path did not launch as expected")
    if preds.shape != (80, 1) or not np.isfinite(preds).all():
        raise AssertionError(f"bad SiT-base predictions: shape {preds.shape}")
    with torch.inference_mode():
        x = torch.from_numpy(data).cuda()
        plain = torch.cat([model(x[s:s + 64]) for s in (0, 64)]).float().cpu().numpy()
        dropped = dataclasses.replace(w, blocks=w.blocks[:6] + w.blocks[7:])
        controls = {"block 6 dropped": fused.fused_forward(model, x[:64], dropped)}
        saved = fused.fused_block, fused.fused_block_cls
        cut = int(0.9 * (m.num_patches + 1))
        fused.fused_block = functools.partial(saved[0], valid_len=cut)
        fused.fused_block_cls = functools.partial(saved[1], valid_len=cut)
        try:
            controls[f"keys >= {cut} masked"] = fused.fused_forward(model, x[:64], w)
        finally:
            fused.fused_block, fused.fused_block_cls = saved
    controls = {k: float(np.abs(v.cpu().numpy() - plain[:64]).max()) for k, v in controls.items()}
    err = float(np.abs(preds - plain).max())
    phase("base-slice", f"predictions |kernel - eager bf16| max {err:.6g} (tol "
          f"{BASE_SLICE_TOL}); std across surfaces {plain.std():.4g}; controls (must exceed "
          "the tol): " + ", ".join(f"{k} {v:.6g}" for k, v in controls.items()))
    if err > BASE_SLICE_TOL:
        raise AssertionError("the SiT-base kernel path disagrees with the eager path")
    if min(controls.values()) <= BASE_SLICE_TOL:
        raise AssertionError("a SiT-base slice control passed the gate")
    del x
    with torch.inference_mode():
        for B in (64, 128):
            xb = torch.from_numpy(rng.standard_normal((B, 4, 40962)).astype(np.float32)).to(
                "cuda", torch.bfloat16)
            torch.cuda.reset_peak_memory_stats()
            k_ms = cuda_ms(lambda: fused.fused_forward(model, xb, w), reps=5)
            k_mem = torch.cuda.max_memory_allocated() / 2**30
            p_ms = cuda_ms(lambda: model(xb), reps=3)
            phase("base-slice", f"B={B} raw bf16 input on device: kernel path {k_ms:.3f} ms = "
                  f"{B / k_ms * 1e3:.1f} surfaces/s (peak {k_mem:.2f} GiB allocated), eager "
                  f"bf16 {p_ms:.3f} ms = {B / p_ms * 1e3:.1f} surfaces/s (median of 5 / 3)")
            del xb
    del model, w
    torch.cuda.empty_cache()


def phase_base_train(fb, exp, table) -> dict:
    """Phase 12: a few SGD steps of ``Trainer`` at SiT-base sub-ico-3 (the
    recompute route for blocks 0-10, the CLS chain for block 11) against
    the eager bf16 SiT under autograd at B=8, with a control; then the
    kernel path alone at the config's bs 128, and the same steps on the
    chain route beside it. -> the launches of the bs-128 run."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
    from surface_vision_transformers_tpu_torch.models.sit import SiT
    from surface_vision_transformers_tpu_torch.train.losses import weighted_mse
    from surface_vision_transformers_tpu_torch.train.optim import Optimizer
    from surface_vision_transformers_tpu_torch.train.trainer import Trainer
    from surface_vision_transformers_tpu_torch.utils import config

    m = exp.model
    blocks = m.depth - 1
    optim = config.OptimConfig(name="SGD", lr=TRAIN_LR, momentum=0.9)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        init = SiT.from_config(exp, patch_table=table, dtype=torch.bfloat16,
                               attn_backend="plain").cuda()
    start = init.state_dict()

    def batches_of(bs, n_batches, seed):
        data, labels = make_regression_dataset(n_batches * bs, raw_vertices=40962, seed=seed)
        data, labels = torch.from_numpy(data).cuda(), torch.from_numpy(labels).cuda()
        return [(data[s:s + bs], labels[s:s + bs]) for s in range(0, n_batches * bs, bs)]

    def kernel_path(bs, batches, steps, hook_block=None):
        model = copy.deepcopy(init)
        if hook_block is not None:
            wt = model.transformer.layers[hook_block][1].fn.net[0].weight
            wt.register_hook(torch.zeros_like)  # control: that block's dW_fc1 zeroed
        trainer = Trainer(dataclasses.replace(
            exp, training=config.TrainingConfig(bs=bs), optim=optim), model)
        ones = torch.ones(bs, device="cuda")
        return run_steps(lambda xb, yb: trainer.optimizer_step(xb, yb, ones)[0], model,
                         start, batches, steps)

    def eager_path(batches, steps):
        model = copy.deepcopy(init)
        opt = Optimizer(optim, model.parameters())

        def step(xb, yb):
            opt.zero_grad()
            loss = weighted_mse(model(xb).reshape(-1), yb)
            loss.backward()
            opt.step()
            return loss.detach()
        return run_steps(step, model, start, batches, steps)

    B, steps = BASE_TRAIN_B, BASE_TRAIN_STEPS
    small = batches_of(B, 2, SEED + 2)
    counters = zero_counts(fb)
    k_loss, k_s, _, k_upd = kernel_path(B, small, steps)
    launches = read_counts(counters)
    e_loss, e_s, _, e_upd = eager_path(small, steps)
    c_loss, _, _, c_upd = kernel_path(B, small, steps, hook_block=5)

    def upd_ratio(upd):
        return max(((upd[k] - e_upd[k]).abs().max() / e_upd[k].abs().max()).item()
                   for k in e_upd)

    per_step = {k: 0 for k in counters}
    per_step.update(fused_block=blocks, fused_block_cls=1, fused_block_cls_bwd=1,
                    fused_block_recompute_bwd=blocks, flash_attention=blocks,
                    flash_attention_bwd=blocks, patch_embed=1)
    want = {k: v * steps for k, v in per_step.items()}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k_loss, e_loss))
    phase("base-train", f"{steps} SGD steps (momentum 0.9, LR {TRAIN_LR}) at B={B}: "
          f"launches {launches}, expected {want}")
    phase("base-train", "losses kernel path " + " ".join(f"{v:.6g}" for v in k_loss))
    phase("base-train", "losses eager bf16  " + " ".join(f"{v:.6g}" for v in e_loss))
    phase("base-train", f"max relative loss gap {loss_err:.4g} (tol {BASE_LOSS_TOL}); worst "
          f"|update - eager update| / max |eager update| over the parameters "
          f"{upd_ratio(k_upd):.4g} (tol {BASE_UPD_TOL}); control, block 5's dW_fc1 zeroed: "
          f"{upd_ratio(c_upd):.4g} (must exceed the tol), loss gap "
          f"{max(abs(a - b) / abs(b) for a, b in zip(c_loss, e_loss)):.4g}; steps 2..{steps} "
          f"at B={B}: kernel path {k_s * 1e3:.1f} ms a step, eager bf16 {e_s * 1e3:.1f} ms")
    if launches != want:
        raise AssertionError("the SiT-base training path did not launch as the route rule says")
    if not all(math.isfinite(v) for v in k_loss) or k_loss[-1] >= k_loss[0]:
        raise AssertionError("the SiT-base training loss did not fall")
    if loss_err > BASE_LOSS_TOL or upd_ratio(k_upd) > BASE_UPD_TOL:
        raise AssertionError("the SiT-base kernel training path disagrees with the eager path")
    if upd_ratio(c_upd) <= BASE_UPD_TOL:
        raise AssertionError("the SiT-base training control passed the gate")
    del k_upd, e_upd, c_upd, small
    torch.cuda.empty_cache()

    # the kernel path alone at the config's batch size
    bs = exp.training.bs
    big = batches_of(bs, 2, SEED + 3)
    counters = zero_counts(fb)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, step_ms, _ = kernel_path(bs, big, BASE_RATE_STEPS)
    launches = read_counts(counters)
    phase("base-train", f"B={bs}, {BASE_RATE_STEPS} steps: launches {launches}; losses "
          + " ".join(f"{v:.6g}" for v in losses) + f"; steps 2..{BASE_RATE_STEPS} as one "
          f"window (host clock, synchronized at both ends): {step_s * 1e3:.1f} ms a step = "
          f"{bs / step_s:.2f} training surfaces/s; per-step CUDA-event times "
          + " ".join(f"{v:.1f}" for v in step_ms) + f" ms; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    want = {k: v * BASE_RATE_STEPS for k, v in per_step.items()}
    if launches != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError("the SiT-base training path at bs 128 did not run as expected")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # For comparison only, not the main path: the same steps with every
    # block on the chain route (forward keeping its activations,
    # fused_block_bwd), which the route rule gives SiT-base no block of.
    counters = zero_counts(fb)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(fb, "uses_recompute", lambda n_tokens, dim: False):
        c_losses, c_step_s, c_step_ms, _ = kernel_path(bs, big, BASE_RATE_STEPS)
    c_launches = read_counts(counters)
    phase("base-train", f"B={bs}, {BASE_RATE_STEPS} steps, every block on the chain route "
          f"(comparison): launches {c_launches}; losses "
          + " ".join(f"{v:.6g}" for v in c_losses) + f" (max relative gap to the recompute "
          f"route {max(abs(a - b) / abs(b) for a, b in zip(c_losses, losses)):.4g}); steps "
          f"2..{BASE_RATE_STEPS}: {c_step_s * 1e3:.1f} ms a step = {bs / c_step_s:.2f} "
          "training surfaces/s; per-step CUDA-event times "
          + " ".join(f"{v:.1f}" for v in c_step_ms) + f" ms; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; recompute route "
          f"(above): {step_s * 1e3:.1f} ms a step, peak {peak:.2f} GiB")
    if c_launches["fused_block_bwd"] != blocks * BASE_RATE_STEPS:
        raise AssertionError("the chain-route comparison did not take the chain")
    torch.cuda.empty_cache()
    model = copy.deepcopy(init)
    trainer = Trainer(dataclasses.replace(
        exp, training=config.TrainingConfig(bs=bs), optim=optim), model)
    ones = torch.ones(bs, device="cuda")
    profile_step(lambda: trainer.optimizer_step(*big[0], ones), bs)
    del big, model, trainer
    torch.cuda.empty_cache()
    return launches


def profile_step(step_fn, bs) -> None:
    """torch.profiler over one call of ``step_fn`` (a training step at
    ``bs``) after a warm-up call: device time by kernel, and their sum
    against the step's CUDA-event time (the rest is the device's idle
    share)."""
    from torch.autograd import DeviceType

    step_fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        a.record()
        step_fn()
        b.record()
        torch.cuda.synchronize()
    step_ms = a.elapsed_time(b)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    phase("base-train", f"torch.profiler, one step at B={bs}: {step_ms:.1f} ms (CUDA events, "
          f"profiler on), kernels {busy:.1f} ms of device time (idle share "
          f"{max(0.0, 1 - busy / step_ms):.3f}); top kernels (ms, share of device time):")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:16]:
        ms_e = e.self_device_time_total / 1e3
        phase("base-train", f"  {ms_e:9.2f} {ms_e / max(busy, 1e-9):6.1%} x{e.count:<4d} "
              f"{e.key[:100]}")


def phase_base_entry() -> None:
    """Phase 13: cli.train with the shipped SiT-base config cut to
    BASE_ENTRY_DEPTH blocks (2 epochs on a small synthetic split, ``--set``
    overrides), then cli.test on its best_params.npz, in subprocesses."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data, labels = make_regression_dataset(80, raw_vertices=40962, seed=SEED + 4)
        for split, sl in (("train", slice(0, 64)), ("validation", slice(64, 80))):
            np.save(tmp / f"{split}_data.npy", data[sl])
            np.save(tmp / f"{split}_labels.npy", labels[sl])
        del data
        # the recipe's LR 1e-5: at LR 1e-4 the 8 steps overshoot and the val
        # MAE rose (4.80 -> 5.28) in a first reading on an H100
        sets = [f"data.data_path={tmp}", "data.split=validation", "training.bs=16",
                "training.bs_val=8", "training.epochs=2", "training.val_epoch=1",
                f"transformer.depth={BASE_ENTRY_DEPTH}",
                f"logging.folder_to_save_model={tmp / 'runs'}"]

        def cli(tool, *extra):
            t0 = time.perf_counter()
            args = [a for s_ in (*sets, *extra) for a in ("--set", s_)]
            res = subprocess.run(
                [sys.executable, "-m", f"surface_vision_transformers_tpu_torch.cli.{tool}",
                 str(BASE_CFG), "--device", "cuda", *args],
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
        tested, t_test = cli("test", f"testing.path_to_ckpt={run_dir / 'best_params.npz'}")
        phase("base-entry", f"cli.train {BASE_CFG.relative_to(ROOT)} (depth {BASE_ENTRY_DEPTH}) "
              f"in {t_train:.1f} s: val "
              "MAE by epoch " + " ".join(f"{v:.6g}" for v in val_mae) + f", best "
              f"{results['best_mae']:.6g} at epoch {results['best_epoch']}; phases_s "
              f"{results['phases_s']}; files missing: {missing or 'none'}; cli.test in "
              f"{t_test:.1f} s on best_params.npz: {tested} (must equal the best val MAE)")
        if missing or len(val_mae) != 2 or not val_mae[-1] < val_mae[0]:
            raise AssertionError("cli.train did not train SiT-base as expected")
        best = results["best_mae"]
        if tested["n"] != 16 or abs(tested["mae"] - best) > 1e-4 * best:
            raise AssertionError("cli.test disagrees with the best epoch's val MAE")


# Phases 14-19: the modular attention path and MPP pretraining of SiT-tiny
# (configs/pretraining/sit_tiny_mpp.yml: the width above, N = 321, bs 32,
# bs_val 32), and supervised SiT-tiny training with dropout.
MPP_CFG = ROOT / "configs/pretraining/sit_tiny_mpp.yml"
TRAIN_CFG = ROOT / "configs/training/sit_tiny_scan_age.yml"
# flash_attention_qkv cases (B, N, valid_len): the config's bs_val, the
# training batch of phase 7, and the JAX package's padded N with its mask.
QKV_CASES = [(32, 321, 321), (256, 321, 321), (32, 384, 321)]
DROP_RATE, DROP_SEED = 0.1, 1234
# Phases 14-16 time the attention kernels (and SDPA) by their device time
# (``device_ms``: calls queued behind a holding kernel): at N=321 a
# CUDA-event window around a call, or around ten back-to-back calls,
# measured the wrapper's host work rather than the kernel. Phase 14 prints
# the wrappers' per-call time beside.
DROP_CASES = [(256, 321, 321), (32, 384, 321)]
# The keep fraction read off the dropout forward's own output (q = 0, v = 1:
# each row's output is its kept share / (1 - rate)) may differ from the
# mask's exact share by the bf16 rounding of o (2^-9 relative) and must sit
# within 0.01 of 1 - rate.
KEEP_TOL = 3e-3
TILED_SHAPE = (2, 3, 5121)  # (B, heads, N): sub-ico 4, 5,120 patches + CLS
TILED_DEPTH, TILED_STEPS = 2, 3  # the modular slice through the tiled entry
MPP_STEPS = 10
# Gates as phase 7's (relative per-step loss, per-tensor update against the
# plain path) and the validation loss through the kernel against the plain
# one, set from readings on an NVIDIA H100 80GB HBM3 at 700 W: MPP steps
# against plain attention read loss gaps 1.15e-3 to 2.3e-3 (losses ~6-29 at
# the seeded weights) and update gaps 0.012-0.024, the control 1.0 (its loss
# gap 2.0e-3 passes the loss gate; the update gate rejects it); the
# validation loss read 4.9e-5 and 6.3e-5 from the plain path, a control
# masking keys >= 289 only 1.0e-3.
MPP_LOSS_TOL, MPP_UPD_TOL, MPP_VAL_TOL = 5e-3, 0.05, 5e-4
# Four more data seeds for the modular gate's margin (its own data: SEED + 5).
MPP_MARGIN_SEEDS = (SEED + 11, SEED + 12, SEED + 13, SEED + 14)
DROP_TRAIN_B, DROP_STEPS = 256, 10
# The recorded times of the rows whose attention backward is now the wgmma
# design, under the two-pass mma.sync backward it replaced (PERF.md section
# 6; this script on an NVIDIA H100 80GB HBM3 at 700 W): a record printed
# beside this run's times, not a measurement of this run, so it stays out
# of the kernels line.
TWO_PASS_MS = {"flash_attention_bwd": 9.9093, "flash_attention_qkv_bwd": 0.0912,
          "flash_attention_qkv_dropout_bwd": 0.7603, "flash_attention_tiled_bwd": 0.6243,
          "fused_block_bwd": 2.6721}


def step_ratio(got, want, ref32) -> float:
    """Largest |got - want| over BOUND_STEPS bf16 steps at the largest
    |ref32| of each output."""
    return max((a.float() - b.float()).abs().max().item()
               / (BOUND_STEPS * bf16_step(r.abs().max().item()))
               for a, b, r in zip(got, want, ref32))


def bump(t):
    """A copy of t with its first element raised by 1."""
    out = t.clone()
    idx = (0,) * out.dim()
    out[idx] = out[idx].float() + 1.0
    return out


ORDER_ELEMENTS = 1 << 18  # dq elements order_control looks at, at least


def order_control(q, k, v, o, lse, do, vl) -> tuple[int, int]:
    """(differing, total) bf16 elements of dq when the plain backward's
    per-64-key-block dQ shares dS K (float32, dS rounded to bf16 as the
    kernel rounds it; no dropout) are summed over the blocks in reverse
    order instead of 0, 1, ...: on the first samples of the (B, H, N, dh)
    operands (two, or more up to ORDER_ELEMENTS dq elements: an order
    change moves only a few dq elements in 10^5 across a bf16 step)."""
    B, H, nq, dh = q.shape
    samples = min(B, max(2, -(-ORDER_ELEMENTS // (H * nq * dh))))
    q, k, v, o, do = (x[:samples].float() for x in (q, k, v, o, do))
    s = q @ k.transpose(-1, -2) * 0.125
    s[..., vl:] = float("-inf")
    p = torch.exp(s - lse[:samples, ..., None])
    p[..., vl:, :] = 0.0
    ds = (p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True)) * 0.125)
    ds = ds.to(torch.bfloat16).float()
    shares = [ds[..., c:c + 64] @ k[..., c:c + 64, :] for c in range(0, min(vl, k.shape[-2]), 64)]
    ahead = functools.reduce(torch.add, shares).to(torch.bfloat16)
    back = functools.reduce(torch.add, shares[::-1]).to(torch.bfloat16)
    return int((ahead != back).sum()), ahead.numel()


def repeat_check(name, label, call, perturbed, order) -> None:
    """The backward repeats bit for bit: two calls of ``call`` on the same
    inputs give identical outputs. Two controls the comparison must tell
    apart: ``perturbed``, the call with one dO element raised by 1, and
    ``order`` (``order_control`` on the call's inputs), the plain dQ summed
    over the key blocks in reverse order, which shows that at this shape
    the order of the dQ sum reaches dq's bf16 bits."""
    first, again, moved = call(), call(), perturbed()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    control = all(torch.equal(a, b) for a, b in zip(first, moved))
    differ, total = order()
    phase(name, f"{label}: two backward calls on the same inputs bitwise identical {same} "
          f"(must be True); controls: one dO element raised by 1, identical {control} "
          f"(must be False); plain dQ shares summed over the key blocks in reverse order, "
          f"{differ} of {total} bf16 elements of dq differ (must be > 0)")
    if not same:
        raise AssertionError(f"{name}: the backward does not repeat bit for bit")
    if control:
        raise AssertionError(f"{name}: the repeat check did not tell a perturbed input apart")
    if differ == 0:
        raise AssertionError(f"{name}: the order of the dQ sum does not reach dq's bits")


def heads4(t):
    """(B, N, H*dh) -> (B, H, N, dh) view."""
    B, N, _ = t.shape
    return t.view(B, N, HEADS, DH).transpose(1, 2)


def bf16_randn(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
        "cuda", torch.bfloat16)


def packed_qkv(rng, B, N):
    """A packed (B, N, 3*H*dh) qkv at SiT-tiny width (q and k scaled as the
    seeded weights' attention gains make them) and an output cotangent."""
    qkv = torch.cat([bf16_randn(rng, (B, N, 2 * HD), 1.5), bf16_randn(rng, (B, N, HD))], -1)
    return qkv, bf16_randn(rng, (B, N, HD))


def qkv_plain(fa, qkv, do, vl, dtype=None, keep=None, keep_bwd=True, scale=1.0):
    """(o, dqkv) of the packed plain versions in ``dtype`` (float32: the
    exact reference; None: the inputs' bf16), 32 samples at a time; dropout
    with ``keep`` (in the backward too unless ``keep_bwd`` is False)."""
    parts = []
    for s in range(0, qkv.shape[0], 32):
        x, g = qkv[s:s + 32], do[s:s + 32]
        if dtype is not None:
            x, g = x.to(dtype), g.to(dtype)
        if scale != 1.0:
            x = torch.cat([x[..., :HD] * scale, x[..., HD:]], -1)
        kp = None if keep is None else keep[s:s + 32]
        rate = DROP_RATE if keep is not None else 0.0
        o, lse = fa.flash_attention_qkv_reference(x, HEADS, vl, kp, rate)
        d = fa.flash_attention_qkv_bwd_reference(
            x, o, lse, g, HEADS, vl, kp if keep_bwd else None, rate if keep_bwd else 0.0)
        parts.append((o, d))
    return [torch.cat(p) for p in zip(*parts)]


def attention_bound(B, H, nq, nk, tensors_fwd, tensors_bwd):
    """(forward, backward) bounds: ``attention_flops`` over keys and rows a
    run needs; bytes of the inputs read and outputs written once."""
    fwd, bwd = attention_flops(B, H, nq, nk)
    return bound_ms(fwd, nbytes_of(*tensors_fwd)), bound_ms(bwd, nbytes_of(*tensors_bwd))


def kernel_row(name, source_line, err, ms, plain_ms, bound, library_ms) -> dict:
    return {"name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": f"{FLASH_TPU}:{source_line}", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms}


def phase_qkv(rng) -> dict:
    """Phase 14: flash_attention_qkv forward and backward against the
    float32 and bf16 plain versions at B = 32 and 256, N = 321, and N = 384
    with valid_len 321, with controls; CUDA-event times beside the plain
    versions and SDPA on the same views."""
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa

    results, times = {}, {}
    for B, N, vl in QKV_CASES:
        qkv, do = packed_qkv(rng, B, N)
        o, lse = fa.flash_attention_qkv_fwd(qkv, HEADS, vl)
        got = [o, fa.flash_attention_qkv_bwd(qkv, o, lse, do, HEADS, vl)]
        ref32 = qkv_plain(fa, qkv, do, vl, torch.float32)
        r32, rbf = step_ratio(got, ref32, ref32), step_ratio(got, qkv_plain(fa, qkv, do, vl), ref32)
        errs = [(a.float() - r).abs().max().item() for a, r in zip(got, ref32)]
        last = (vl - 1) // 64 * 64
        controls = {"last K/V tile skipped": step_ratio(
            got, qkv_plain(fa, qkv, do, last, torch.float32), ref32)}
        if N > vl:
            controls[f"key mask ignored (keys {vl}..{N - 1})"] = step_ratio(
                got, qkv_plain(fa, qkv, do, N, torch.float32), ref32)
        else:
            controls["softmax scale x1.1"] = step_ratio(
                got, qkv_plain(fa, qkv, do, vl, torch.float32, scale=1.1), ref32)
        phase("qkv-kernels", f"B={B} N={N} valid_len={vl} (q/k/v and dq/dk/dv through the "
              f"packed strides): worst |err|/bound over o, dqkv vs fp32 plain {r32:.4g}, vs "
              f"plain bf16 {rbf:.4g}, bound {BOUND_STEPS} bf16 steps at each output's "
              f"largest value; max abs err o {errs[0]:.6g}, dqkv {errs[1]:.6g}; controls "
              "(must exceed 1): " + ", ".join(f"{k} {v:.4g}" for k, v in controls.items()))
        if not all(bool(torch.isfinite(x).all()) for x in got) or max(r32, rbf) > 1:
            raise AssertionError("flash_attention_qkv disagrees with its plain version")
        if min(controls.values()) <= 1:
            raise AssertionError("flash_attention_qkv: a control passed the gate")
        repeat_check("qkv-kernels", f"B={B} N={N} valid_len={vl}",
                     lambda: (fa.flash_attention_qkv_bwd(qkv, o, lse, do, HEADS, vl),),
                     lambda: (fa.flash_attention_qkv_bwd(qkv, o, lse, bump(do), HEADS, vl),),
                     lambda: order_control(*fa.split_qkv(qkv, HEADS), heads4(o), lse,
                                           heads4(do), vl))
        if N == vl:
            q, k, v = fa.split_qkv(qkv, HEADS)
            do4 = heads4(do)
            qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qr, kr, vr)
            t = {"fwd": device_ms(lambda: fa.flash_attention_qkv_fwd(qkv, HEADS)),
                 "bwd": device_ms(lambda: fa.flash_attention_qkv_bwd(qkv, o, lse, do, HEADS)),
                 "plain_fwd": cuda_ms(lambda: fa.flash_attention_qkv_reference(qkv, HEADS),
                                      reps=3),
                 "plain_bwd": cuda_ms(lambda: fa.flash_attention_qkv_bwd_reference(
                     qkv, o, lse, do, HEADS), reps=3),
                 "sdpa_fwd": device_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                 "sdpa_bwd": device_ms(lambda: torch.autograd.grad(
                     sdpa_out, (qr, kr, vr), do4, retain_graph=True))}
            bounds = attention_bound(B, HEADS, N, N, (qkv, o, lse), (qkv, o, lse, do, got[1]))
            phase("qkv-kernels", f"B={B} N={N}: forward kernel {t['fwd']:.4f} ms, plain "
                  f"{t['plain_fwd']:.4f}, SDPA {t['sdpa_fwd']:.4f}, bound {bounds[0][0]:.4f} ms "
                  f"by {bounds[0][1]}; backward kernel {t['bwd']:.4f} ms, plain "
                  f"{t['plain_bwd']:.4f}, SDPA {t['sdpa_bwd']:.4f}, bound {bounds[1][0]:.4f} ms "
                  f"by {bounds[1][1]} (device time, mean of 10 queued calls; plain: "
                  "CUDA-event median of 3)")
            call = (cuda_ms(lambda: fa.flash_attention_qkv_fwd(qkv, HEADS)),
                    cuda_ms(lambda: fa.flash_attention_qkv_bwd(qkv, o, lse, do, HEADS)))
            phase("qkv-kernels", f"B={B} N={N}: a wrapper call, host work included (CUDA-event "
                  f"median of 25): forward {call[0]:.4f} ms, backward {call[1]:.4f} ms")
            FWD_RECORDS["flash_attention_qkv" + ("" if B == 32 else f" B={B}")] = (
                t["fwd"], t["sdpa_fwd"], bounds[0][0])
            times[B] = (t, bounds, errs)
            del sdpa_out, qr, kr, vr
        del got, ref32
        torch.cuda.empty_cache()
    host_us = fwd_host_us(fa)
    phase("qkv-kernels", f"the forward's C entry on the host (three TMA maps encoded, the launch "
          f"enqueued; B=1 H=1 N=64, mean of 200 calls, host clock): {host_us:.2f} us a call")
    t, bounds, errs = times[32]  # the MPP validation batch
    results["flash_attention_qkv"] = kernel_row(
        "flash_attention_qkv", 462, errs[0], t["fwd"], t["plain_fwd"], bounds[0], t["sdpa_fwd"])
    results["flash_attention_qkv_bwd"] = kernel_row(
        "flash_attention_qkv_bwd", 427, errs[1], t["bwd"], t["plain_bwd"], bounds[1],
        t["sdpa_bwd"])
    return results


def fwd_host_us(fa) -> float:
    """Host microseconds of one call of the forward's C entry: its three
    tensor maps encoded and the kernel enqueued, at a shape whose kernel
    is short (mean over 200 calls, synchronised only at the end)."""
    from surface_vision_transformers_tpu_torch.ops import _native

    q = torch.zeros((1, 1, 64, DH), device="cuda", dtype=torch.bfloat16)
    o, lse = torch.empty_like(q), torch.empty((1, 1, 64), device="cuda")
    args = [*fa._operand(q), *fa._operand(q), *fa._operand(q), *fa._operand(o),
            lse.data_ptr(), 1, 1, 64, 64, 64, *fa._drop_args(0.0, 0), 0,
            torch.cuda.current_stream().cuda_stream]
    lib = _native.library()
    for _ in range(10):
        _native.check(lib.svt_flash_attention_fwd(*args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        lib.svt_flash_attention_fwd(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / 200 * 1e6


def keep_fraction(fa, B, N, vl) -> tuple[float, float]:
    """The dropout forward's kept share of the valid scores, read off its own
    output at q = 0 (uniform P) and v = 1: (measured, the mask's exact
    share)."""
    qkv = torch.zeros((B, N, 3 * HD), device="cuda", dtype=torch.bfloat16)
    qkv[..., 2 * HD:] = 1.0
    qkv[..., HD:2 * HD] = torch.randn((B, N, HD), device="cuda").bfloat16()
    o, _ = fa.flash_attention_qkv_dropout_fwd(qkv, HEADS, vl, DROP_RATE, DROP_SEED)
    keep = fa.dropout_keep_mask(DROP_SEED, B, HEADS, N, N, DROP_RATE, device="cuda")
    return ((o.float().mean() * (1 - DROP_RATE)).item(),
            keep[..., :vl].float().mean().item())


def phase_dropout(rng) -> dict:
    """Phase 15: flash_attention_qkv_dropout forward and backward against
    the float32 and bf16 plain versions fed ``dropout_keep_mask`` of the
    same seed, with controls (another seed's mask; the mask dropped in the
    backward only); the keep fraction off the forward's output; times
    beside the plain versions and SDPA with dropout_p."""
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa

    for B, N, vl in DROP_CASES:
        qkv, do = packed_qkv(rng, B, N)
        o, lse = fa.flash_attention_qkv_dropout_fwd(qkv, HEADS, vl, DROP_RATE, DROP_SEED)
        got = [o, fa.flash_attention_qkv_dropout_bwd(qkv, o, lse, do, HEADS, vl, DROP_RATE,
                                                     DROP_SEED)]
        keep = fa.dropout_keep_mask(DROP_SEED, B, HEADS, N, N, DROP_RATE, device="cuda")
        ref32 = qkv_plain(fa, qkv, do, vl, torch.float32, keep)
        r32 = step_ratio(got, ref32, ref32)
        rbf = step_ratio(got, qkv_plain(fa, qkv, do, vl, keep=keep), ref32)
        errs = [(a.float() - r).abs().max().item() for a, r in zip(got, ref32)]
        other = fa.dropout_keep_mask(DROP_SEED + 1, B, HEADS, N, N, DROP_RATE, device="cuda")
        controls = {
            "another seed's mask": step_ratio(got, qkv_plain(fa, qkv, do, vl, torch.float32,
                                                             other), ref32),
            "mask dropped in the backward only": step_ratio(
                got[1:], qkv_plain(fa, qkv, do, vl, torch.float32, keep, keep_bwd=False)[1:],
                ref32[1:])}
        measured, exact = keep_fraction(fa, B, N, vl)
        phase("dropout-kernels", f"B={B} N={N} valid_len={vl} rate {DROP_RATE} seed {DROP_SEED}: "
              f"worst |err|/bound over o, dqkv vs fp32 plain on the same mask {r32:.4g}, vs "
              f"plain bf16 {rbf:.4g}; max abs err o {errs[0]:.6g}, dqkv {errs[1]:.6g}; kept "
              f"share off the forward's output {measured:.6f} (mask {exact:.6f}, 1 - rate "
              f"{1 - DROP_RATE}); controls (must exceed 1): "
              + ", ".join(f"{k} {v:.4g}" for k, v in controls.items()))
        if not all(bool(torch.isfinite(x).all()) for x in got) or max(r32, rbf) > 1:
            raise AssertionError("flash_attention_qkv_dropout disagrees with its plain version")
        if min(controls.values()) <= 1:
            raise AssertionError("flash_attention_qkv_dropout: a control passed the gate")
        if abs(measured - exact) > KEEP_TOL or abs(measured - (1 - DROP_RATE)) > 0.01:
            raise AssertionError("the dropout kernel keeps the wrong share of the scores")
        repeat_check("dropout-kernels", f"B={B} N={N} valid_len={vl} rate {DROP_RATE}",
                     lambda: (fa.flash_attention_qkv_dropout_bwd(
                         qkv, o, lse, do, HEADS, vl, DROP_RATE, DROP_SEED),),
                     lambda: (fa.flash_attention_qkv_dropout_bwd(
                         qkv, o, lse, bump(do), HEADS, vl, DROP_RATE, DROP_SEED),),
                     lambda: order_control(*fa.split_qkv(qkv, HEADS), heads4(o), lse,
                                           heads4(do), vl))
        if B == DROP_TRAIN_B:
            q, k, v = fa.split_qkv(qkv, HEADS)
            do4 = heads4(do)
            qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qr, kr, vr, dropout_p=DROP_RATE)
            t = {"fwd": device_ms(lambda: fa.flash_attention_qkv_dropout_fwd(
                     qkv, HEADS, vl, DROP_RATE, DROP_SEED)),
                 "bwd": device_ms(lambda: fa.flash_attention_qkv_dropout_bwd(
                     qkv, o, lse, do, HEADS, vl, DROP_RATE, DROP_SEED)),
                 "plain_fwd": cuda_ms(lambda: fa.flash_attention_qkv_reference(
                     qkv, HEADS, vl, keep, DROP_RATE), reps=3),
                 "plain_bwd": cuda_ms(lambda: fa.flash_attention_qkv_bwd_reference(
                     qkv, o, lse, do, HEADS, vl, keep, DROP_RATE), reps=3),
                 "sdpa_fwd": device_ms(lambda: F.scaled_dot_product_attention(
                     q, k, v, dropout_p=DROP_RATE)),
                 "sdpa_bwd": device_ms(lambda: torch.autograd.grad(
                     sdpa_out, (qr, kr, vr), do4, retain_graph=True))}
            bounds = attention_bound(B, HEADS, N, N, (qkv, o, lse), (qkv, o, lse, do, got[1]))
            phase("dropout-kernels", f"B={B} N={N}: forward kernel {t['fwd']:.4f} ms, plain "
                  f"(mask given) {t['plain_fwd']:.4f}, SDPA dropout_p={DROP_RATE} "
                  f"{t['sdpa_fwd']:.4f}, bound {bounds[0][0]:.4f} ms by {bounds[0][1]}; "
                  f"backward kernel {t['bwd']:.4f} ms, plain {t['plain_bwd']:.4f}, SDPA "
                  f"{t['sdpa_bwd']:.4f}, bound {bounds[1][0]:.4f} ms by {bounds[1][1]} "
                  "(tensor-core products only; device time, mean of 10 queued calls; plain: "
                  "CUDA-event median of 3)")
            FWD_RECORDS["flash_attention_qkv_dropout"] = (t["fwd"], t["sdpa_fwd"], bounds[0][0])
            rows = {"flash_attention_qkv_dropout": kernel_row(
                        "flash_attention_qkv_dropout", 761, errs[0], t["fwd"], t["plain_fwd"],
                        bounds[0], t["sdpa_fwd"]),
                    "flash_attention_qkv_dropout_bwd": kernel_row(
                        "flash_attention_qkv_dropout_bwd", 724, errs[1], t["bwd"],
                        t["plain_bwd"], bounds[1], t["sdpa_bwd"])}
            del sdpa_out, qr, kr, vr
        del got, ref32, keep, other
        torch.cuda.empty_cache()
    return rows


def upd_ratio(upd, ref) -> float:
    """Worst |update - reference update| / max |reference update| over the
    parameters the reference moved."""
    return max(((upd[k] - ref[k]).abs().max() / ref[k].abs().max()).item()
               for k in ref if ref[k].abs().max() > 0)


def trainer_run(exp, model, start, batches, steps, hook_block=None):
    """``steps`` optimizer steps of ``Trainer(exp, model)`` on alternating
    batches (``run_steps``); with ``hook_block`` that block's dW_fc1 is
    zeroed (the control)."""
    from surface_vision_transformers_tpu_torch.models.mpp import MPP
    from surface_vision_transformers_tpu_torch.train.trainer import Trainer

    enc = model.transformer if isinstance(model, MPP) else model
    if hook_block is not None:
        enc.transformer.layers[hook_block][1].fn.net[0].weight.register_hook(torch.zeros_like)
    trainer = Trainer(exp, model)
    ones = torch.ones(batches[0][0].shape[0], device="cuda")
    return run_steps(lambda xb, yb: trainer.optimizer_step(xb, yb, ones)[0], model, start,
                     batches, steps)


def gate_runs(name, label, run, plain, control, loss_tol, upd_tol) -> None:
    """Phase 7's gate: per-step losses and every parameter's update of
    ``run`` against ``plain``; ``control`` must fail the update gate."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(run[0], plain[0]))
    c_loss = max(abs(a - b) / abs(b) for a, b in zip(control[0], plain[0]))
    r, c = upd_ratio(run[3], plain[3]), upd_ratio(control[3], plain[3])
    phase(name, f"{label}: losses " + " ".join(f"{v:.6g}" for v in run[0]))
    phase(name, f"{label}: plain   " + " ".join(f"{v:.6g}" for v in plain[0]))
    phase(name, f"{label}: max relative loss gap {loss_err:.4g} (tol {loss_tol}); worst "
          f"|update - plain update| / max |plain update| {r:.4g} (tol {upd_tol}); control, "
          f"one block's dW_fc1 zeroed: {c:.4g} (must exceed the tol), loss gap {c_loss:.4g}")
    if not all(math.isfinite(v) for v in run[0]) or loss_err > loss_tol or r > upd_tol:
        raise AssertionError(f"{label} disagrees with the plain path")
    if c <= upd_tol:
        raise AssertionError(f"{label}: the control passed the gate")


def phase_tiled(rng, fb) -> dict:
    """Phase 16: flash_attention_tiled at N = 5,121 against the float32 and
    bf16 plain versions with controls and times; then the modular SiT at
    that length (depth cut to 2) trained through it (``tpu.fused_train:
    false``) against plain attention, with the launches. -> kernel rows."""
    from surface_vision_transformers_tpu_torch.geometry import patch_grid
    from surface_vision_transformers_tpu_torch.models.sit import SiT
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa
    from surface_vision_transformers_tpu_torch.utils import config

    B, H, N = TILED_SHAPE
    q, k, v = bf16_randn(rng, (B, H, N, DH), 1.5), bf16_randn(rng, (B, H, N, DH), 1.5), \
        bf16_randn(rng, (B, H, N, DH))
    do = bf16_randn(rng, (B, H, N, DH))

    def plain(dtype=None, vl=None, scale=1.0):
        a = [x.to(dtype) if dtype else x for x in (q, k, v, do)]
        o_, lse_ = fa.flash_attention_reference(a[0] * scale, *a[1:3], vl)
        return [o_, *fa.flash_attention_bwd_reference(a[0] * scale, *a[1:3], o_, lse_, a[3], vl)]

    o, lse = fa.flash_attention_tiled_fwd(q, k, v)
    got = [o, *fa.flash_attention_tiled_bwd(q, k, v, o, lse, do)]
    ref32 = plain(torch.float32)
    r32, rbf = step_ratio(got, ref32, ref32), step_ratio(got, plain(), ref32)
    errs = [(a.float() - r).abs().max().item() for a, r in zip(got, ref32)]
    controls = {"last K/V tile skipped": step_ratio(got, plain(torch.float32, (N - 1) // 64 * 64),
                                                    ref32),
                "softmax scale x1.1": step_ratio(got, plain(torch.float32, scale=1.1), ref32)}
    phase("tiled", f"B={B} H={H} N={N}: worst |err|/bound over o, dq, dk, dv vs fp32 plain "
          f"{r32:.4g}, vs plain bf16 {rbf:.4g}; max abs err o {errs[0]:.6g}, dq/dk/dv "
          f"{max(errs[1:]):.6g}; controls (must exceed 1): "
          + ", ".join(f"{k_} {v_:.4g}" for k_, v_ in controls.items()))
    if not all(bool(torch.isfinite(x).all()) for x in got) or max(r32, rbf) > 1:
        raise AssertionError("flash_attention_tiled disagrees with its plain version")
    if min(controls.values()) <= 1:
        raise AssertionError("flash_attention_tiled: a control passed the gate")
    repeat_check("tiled", f"B={B} H={H} N={N}",
                 lambda: fa.flash_attention_tiled_bwd(q, k, v, o, lse, do),
                 lambda: fa.flash_attention_tiled_bwd(q, k, v, o, lse, bump(do)),
                 lambda: order_control(q, k, v, o, lse, do, N))
    del ref32, got
    torch.cuda.empty_cache()
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qr, kr, vr)
    t = {"fwd": device_ms(lambda: fa.flash_attention_tiled_fwd(q, k, v)),
         "bwd": device_ms(lambda: fa.flash_attention_tiled_bwd(q, k, v, o, lse, do)),
         "plain_fwd": cuda_ms(lambda: fa.flash_attention_reference(q, k, v), reps=3),
         "plain_bwd": cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do),
                              reps=3),
         "sdpa_fwd": device_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
         "sdpa_bwd": device_ms(lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do,
                                                         retain_graph=True))}
    bounds = attention_bound(B, H, N, N, (q, k, v, o, lse), (q, k, v, o, lse, do, q, k, v))
    phase("tiled", f"B={B} H={H} N={N}: forward kernel {t['fwd']:.4f} ms, plain "
          f"{t['plain_fwd']:.4f}, SDPA {t['sdpa_fwd']:.4f}, bound {bounds[0][0]:.4f} ms by "
          f"{bounds[0][1]}; backward kernel {t['bwd']:.4f} ms, plain {t['plain_bwd']:.4f}, "
          f"SDPA {t['sdpa_bwd']:.4f}, bound {bounds[1][0]:.4f} ms by {bounds[1][1]} (device "
          "time, mean of 10 queued calls; plain: CUDA-event median of 3)")
    FWD_RECORDS["flash_attention_tiled"] = (t["fwd"], t["sdpa_fwd"], bounds[0][0])
    rows = {"flash_attention_tiled": kernel_row("flash_attention_tiled", 1015, errs[0], t["fwd"],
                                                t["plain_fwd"], bounds[0], t["sdpa_fwd"]),
            "flash_attention_tiled_bwd": kernel_row(
                "flash_attention_tiled_bwd", 966, max(errs[1:]), t["bwd"], t["plain_bwd"],
                bounds[1], t["sdpa_bwd"])}
    del sdpa_out, qr, kr, vr, q, k, v, do, o, lse
    torch.cuda.empty_cache()

    # the modular SiT at sub-ico 4 (pre-patched input), trained through the
    # tiled entry: blocks' attention via multi_head_attention beyond 1536
    L, V = patch_grid(6, 4)
    exp = config.Experiment(
        model=config.ModelConfig(depth=TILED_DEPTH, num_patches=L, num_vertices=V),
        training=config.TrainingConfig(bs=B), data=config.DataConfig(),
        optim=config.OptimConfig(name="SGD", lr=TRAIN_LR, momentum=0.9), fused_train=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        start = {k_: v_.cuda() for k_, v_ in SiT.from_config(exp).state_dict().items()}

    def model(backend):
        m = SiT.from_config(exp, attn_backend=backend)
        m.load_state_dict(start)
        return m.cuda()

    batches = [(torch.from_numpy(rng.standard_normal((B, 4, L, V)).astype(np.float32)).cuda(),
                torch.full((B,), 35.0, device="cuda")) for _ in range(2)]
    counters = zero_counts(fb)
    run = trainer_run(exp, model("auto"), start, batches, TILED_STEPS)
    launches = read_counts(counters)
    plain_run = trainer_run(exp, model("plain"), start, batches, TILED_STEPS)
    control = trainer_run(exp, model("auto"), start, batches, TILED_STEPS, hook_block=1)
    want = {k_: 0 for k_ in counters}
    want.update(flash_attention_tiled=TILED_DEPTH * TILED_STEPS,
                flash_attention_tiled_bwd=TILED_DEPTH * TILED_STEPS)
    phase("tiled", f"modular SiT-tiny width, depth {TILED_DEPTH}, N={L + 1}, B={B}, "
          f"{TILED_STEPS} SGD steps (tpu.fused_train false): launches {launches}, expected {want}")
    gate_runs("tiled", "tiled slice", run, plain_run, control, MPP_LOSS_TOL, MPP_UPD_TOL)
    if launches != want:
        raise AssertionError("the long-sequence path did not launch the tiled kernels")
    for name in rows:
        rows[name]["launches"] = launches[name]
    torch.cuda.empty_cache()
    return rows


def mpp_models(rng, exp, table):
    """(start state, make(backend, exp)) for MPP of SiT-tiny at the config's
    width with seeded weights (phase 3's gains; mask token and head as the
    reference initialises them)."""
    from surface_vision_transformers_tpu_torch.checkpoints.convert import (
        mpp_state,
        state_dict_from_jax,
    )
    from surface_vision_transformers_tpu_torch.models.mpp import MPP
    from surface_vision_transformers_tpu_torch.models.sit import SiT
    from surface_vision_transformers_tpu_torch.train.runner import load_model_state

    m = exp.model
    state = mpp_state(state_dict_from_jax(jax_shaped_params(rng, m.num_vertices), m.depth))
    pd, b = 4 * m.num_vertices, 1.0 / np.sqrt(m.dim)
    state["mask_token"] = torch.from_numpy(rng.standard_normal((1, 1, pd)).astype(np.float32))
    state["to_original.weight"] = torch.from_numpy(rng.uniform(-b, b, (pd, m.dim)).astype(
        np.float32))
    state["to_original.bias"] = torch.from_numpy(rng.uniform(-b, b, pd).astype(np.float32))

    def make(backend="auto", e=exp):
        mp = e.mpp
        model = MPP(SiT.from_config(e, patch_table=table, attn_backend=backend),
                    mask_prob=mp.mask_prob, replace_prob=mp.replace_prob, swap_prob=mp.swap_prob)
        load_model_state(model, state)
        return model.cuda()

    return {k: v.cuda() for k, v in make().state_dict().items()}, make


def phase_mpp(rng, fb, table) -> dict:
    """Phase 17: MPP of SiT-tiny per the shipped config: 10 fused steps
    (``fused_mpp_loss``) and 10 modular steps with the kernels
    (``tpu.fused_train: false``) against the modular MPP with plain
    attention on identical corruption, with a control and the launches; a
    frozen-decoder run; the validation loss through ``flash_attention_qkv``
    against the plain path with a control; training and evaluation
    surfaces/s. -> the attention kernels' main-path launches."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
    from surface_vision_transformers_tpu_torch.models import sit as sit_module
    from surface_vision_transformers_tpu_torch.models.mpp import mpp_target
    from surface_vision_transformers_tpu_torch.train.trainer import evaluate_mpp
    from surface_vision_transformers_tpu_torch.utils import config

    exp = config.load_config(MPP_CFG)
    bs, bs_val = exp.training.bs, exp.training.bs_val
    start, make = mpp_models(rng, exp, table)
    raw, _ = make_regression_dataset(512, raw_vertices=40962, seed=SEED + 5)
    with torch.no_grad():
        tokens = mpp_target(make().transformer, torch.from_numpy(raw).cuda())
    del raw
    small = [(tokens[s:s + bs], None) for s in (0, bs)]
    modular = dataclasses.replace(exp, fused_train=False)

    counters = zero_counts(fb)
    fused_run = trainer_run(exp, make(), start, small, MPP_STEPS)
    fused_launches = read_counts(counters)
    plain_run = trainer_run(modular, make("plain"), start, small, MPP_STEPS)
    counters = zero_counts(fb)
    mod_run = trainer_run(modular, make(), start, small, MPP_STEPS)
    mod_launches = read_counts(counters)
    control = trainer_run(exp, make(), start, small, MPP_STEPS, hook_block=5)
    blocks = exp.model.depth
    want_fused = {k: 0 for k in counters}
    want_fused.update(fused_block=blocks * MPP_STEPS, fused_block_bwd=blocks * MPP_STEPS)
    want_mod = {k: 0 for k in counters}
    want_mod.update(flash_attention_qkv=blocks * MPP_STEPS,
                    flash_attention_qkv_bwd=blocks * MPP_STEPS)
    phase("mpp-slice", f"{MPP_CFG.relative_to(ROOT)}: {MPP_STEPS} SGD steps (LR "
          f"{exp.optim.lr}, momentum {exp.optim.momentum}) at bs {bs}, mask/replace/swap "
          f"{exp.mpp.mask_prob}/{exp.mpp.replace_prob}/{exp.mpp.swap_prob}; launches fused "
          f"{fused_launches} (expected {want_fused}); modular with the kernels {mod_launches} "
          f"(expected {want_mod})")
    gate_runs("mpp-slice", "fused MPP (fused_mpp_loss)", fused_run, plain_run, control,
              MPP_LOSS_TOL, MPP_UPD_TOL)
    gate_runs("mpp-slice", "modular MPP with the attention kernels", mod_run, plain_run,
              control, MPP_LOSS_TOL, MPP_UPD_TOL)
    if fused_launches != want_fused or mod_launches != want_mod:
        raise AssertionError("the MPP training paths did not launch as expected")
    # steps 0, 2, 4, 6, 8 and 1, 3, 5, 7, 9 see the same batch
    if not fused_run[0][8] < fused_run[0][0] or not fused_run[0][9] < fused_run[0][1]:
        raise AssertionError("the MPP training loss did not fall")

    frozen_exp = dataclasses.replace(exp, mpp=dataclasses.replace(exp.mpp,
                                                                  optimize_decoder=False))
    model = make(e=frozen_exp)
    trainer_run(frozen_exp, model, start, small, 3)
    decoder = ("to_original.weight", "to_original.bias", "mask_token")
    after = model.state_dict()
    same = all(torch.equal(after[k], start[k]) for k in decoder)
    moved = not torch.equal(after["transformer.transformer.layers.0.0.fn.to_qkv.weight"],
                            start["transformer.transformer.layers.0.0.fn.to_qkv.weight"])
    phase("mpp-slice", f"optimize_decoder false, 3 fused steps: to_original and mask_token "
          f"bit-identical {same}; the encoder moved {moved}")
    if not same or not moved:
        raise AssertionError("the frozen decoder moved, or the encoder did not")

    val = tokens[:2 * bs_val]
    k_model, p_model = make().eval(), make("plain").eval()
    counters = zero_counts(fb)
    k_loss = evaluate_mpp(k_model, val, bs_val)
    val_launches = read_counts(counters)
    p_loss = evaluate_mpp(p_model, val, bs_val)
    real = sit_module.flash_attention_qkv
    controls = {}
    for label, fn in (("keys >= 161 masked", lambda qkv, heads, vl: real(qkv, heads, 161)),
                      ("softmax scale x1.1", lambda qkv, heads, vl: real(
                          torch.cat([qkv[..., :HD] * 1.1, qkv[..., HD:]], -1), heads, vl))):
        with mock.patch.object(sit_module, "flash_attention_qkv", fn):
            controls[label] = abs(evaluate_mpp(k_model, val, bs_val) - p_loss) / p_loss
    gap = abs(k_loss - p_loss) / p_loss
    want_val = {k: 0 for k in counters}
    want_val.update(flash_attention_qkv=blocks * 2)
    phase("mpp-slice", f"validation ({2 * bs_val} surfaces, bs_val {bs_val}, fixed corruption): "
          f"loss through flash_attention_qkv {k_loss:.6g}, plain attention {p_loss:.6g}, "
          f"relative gap {gap:.4g} (tol {MPP_VAL_TOL}); controls (must exceed the tol): "
          + ", ".join(f"{k_} {v_:.4g}" for k_, v_ in controls.items())
          + f"; launches {val_launches}, expected {want_val}")
    if not math.isfinite(k_loss) or gap > MPP_VAL_TOL or val_launches != want_val:
        raise AssertionError("MPP validation through the kernel disagrees with the plain path")
    if min(controls.values()) <= MPP_VAL_TOL:
        raise AssertionError("an MPP validation control passed the gate")

    big = [(tokens[s:s + 256], None) for s in (0, 256)]
    torch.cuda.reset_peak_memory_stats()
    big_run = trainer_run(exp, make(), start, big, MPP_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for B, run in ((bs, fused_run), (256, big_run)):
        phase("mpp-slice", f"fused MPP training at B={B}, steps 2..{MPP_STEPS} as one window "
              f"(host clock, synchronized at both ends): {run[1] * 1e3:.3f} ms a step = "
              f"{B / run[1]:.1f} surfaces/s; per-step CUDA-event times "
              + " ".join(f"{v:.2f}" for v in run[2]) + " ms"
              + (f"; peak {peak:.2f} GiB allocated" if B == 256 else ""))
    phase("mpp-slice", f"modular MPP with the attention kernels at B={bs}: {mod_run[1] * 1e3:.3f} "
          f"ms a step = {bs / mod_run[1]:.1f} surfaces/s; plain attention "
          f"{plain_run[1] * 1e3:.3f} ms = {bs / plain_run[1]:.1f} surfaces/s")
    for B in (bs_val, 256):
        evaluate_mpp(k_model, tokens, B)  # warm-up
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate_mpp(k_model, tokens, B)
            secs.append(time.perf_counter() - t0)
        secs.sort()
        phase("mpp-slice", f"MPP evaluation of {tokens.shape[0]} surfaces at B={B} (median of 3, "
              f"host clock): {secs[1] * 1e3:.2f} ms = {tokens.shape[0] / secs[1]:.1f} surfaces/s")
    del tokens, small, big
    torch.cuda.empty_cache()

    # The modular gate's margin: the same ten steps on MPP_MARGIN_SEEDS'
    # data, printed beside the gate's own reading (the gate stays on its
    # own data).
    gaps = []
    for seed in MPP_MARGIN_SEEDS:
        raw, _ = make_regression_dataset(2 * bs, raw_vertices=40962, seed=seed)
        with torch.no_grad():
            tok = mpp_target(make().transformer, torch.from_numpy(raw).cuda())
        data = [(tok[s_:s_ + bs], None) for s_ in (0, bs)]
        k_run = trainer_run(modular, make(), start, data, MPP_STEPS)
        p_run = trainer_run(modular, make("plain"), start, data, MPP_STEPS)
        gaps.append(max(abs(a - b) / abs(b) for a, b in zip(k_run[0], p_run[0])))
    own = max(abs(a - b) / abs(b) for a, b in zip(mod_run[0], plain_run[0]))
    phase("mpp-slice", f"modular MPP gate's margin: max relative loss gap over {MPP_STEPS} steps "
          f"{own:.6f} at the gate's data (seed {SEED + 5}); at data seeds "
          + ", ".join(f"{sd} {g:.6f}" for sd, g in zip(MPP_MARGIN_SEEDS, gaps))
          + f" (tol {MPP_LOSS_TOL}; printed, not gated)")
    return {"flash_attention_qkv": val_launches["flash_attention_qkv"],
            "flash_attention_qkv_bwd": mod_launches["flash_attention_qkv_bwd"]}


def phase_dropout_train(fb, table, fused_step_s) -> dict:
    """Phase 18: ten SGD steps of ``Trainer`` on SiT-tiny with dropout 0.1 at
    B = 256 (the modular path, attention on flash_attention_qkv_dropout)
    against the same model with plain attention, both drawing identical
    masks and dropout streams (``DropoutRNG`` of one seed; the plain route
    takes the kernel's mask), with a control; the launches; the rate beside
    phase 7's fused step without dropout. -> the launches."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
    from surface_vision_transformers_tpu_torch.models.sit import SiT
    from surface_vision_transformers_tpu_torch.utils import config

    data, labels = make_regression_dataset(2 * DROP_TRAIN_B, raw_vertices=40962, seed=SEED)
    data, labels = torch.from_numpy(data).cuda(), torch.from_numpy(labels).cuda()
    batches = [(data[s:s + DROP_TRAIN_B], labels[s:s + DROP_TRAIN_B]) for s in (0, DROP_TRAIN_B)]
    exp = config.Experiment(
        model=config.ModelConfig(dropout=DROP_RATE), training=config.TrainingConfig(
            bs=DROP_TRAIN_B), data=config.DataConfig(),
        optim=config.OptimConfig(name="SGD", lr=TRAIN_LR, momentum=0.9))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        start = SiT(patch_table=table, dropout=DROP_RATE).state_dict()

    def model(backend):
        m = SiT(patch_table=table, dtype=torch.bfloat16, dropout=DROP_RATE, attn_backend=backend)
        m.load_state_dict(start)
        return m.cuda()

    start = {k: v.cuda() for k, v in start.items()}
    counters = zero_counts(fb)
    run = trainer_run(exp, model("auto"), start, batches, DROP_STEPS)
    launches = read_counts(counters)
    plain_run = trainer_run(exp, model("plain"), start, batches, DROP_STEPS)
    control = trainer_run(exp, model("auto"), start, batches, DROP_STEPS, hook_block=5)
    want = {k: 0 for k in counters}
    want.update(flash_attention_qkv_dropout=DEPTH * DROP_STEPS,
                flash_attention_qkv_dropout_bwd=DEPTH * DROP_STEPS, patch_embed=DROP_STEPS)
    phase("dropout-train", f"{DROP_STEPS} SGD steps (momentum 0.9, LR {TRAIN_LR}) at "
          f"B={DROP_TRAIN_B}, dropout {DROP_RATE}: launches {launches}, expected {want}")
    gate_runs("dropout-train", "dropout kernel path", run, plain_run, control, TRAIN_LOSS_TOL,
              TRAIN_UPD_TOL)
    if launches != want:
        raise AssertionError("the dropout training path did not launch as expected")
    if not run[0][-1] < run[0][0]:
        raise AssertionError("the dropout training loss did not fall")
    phase("dropout-train", f"steps 2..{DROP_STEPS} as one window (host clock): dropout kernel "
          f"path {run[1] * 1e3:.3f} ms a step = {DROP_TRAIN_B / run[1]:.1f} surfaces/s; plain "
          f"attention with dropout {plain_run[1] * 1e3:.3f} ms = "
          f"{DROP_TRAIN_B / plain_run[1]:.1f}; phase 7's fused step without dropout "
          f"{fused_step_s * 1e3:.3f} ms = {DROP_TRAIN_B / fused_step_s:.1f} surfaces/s "
          f"({run[1] / fused_step_s:.3f}x its time); per-step CUDA-event times "
          + " ".join(f"{v:.2f}" for v in run[2]) + " ms")
    del data, labels, batches
    torch.cuda.empty_cache()
    return launches


def phase_pretrain_entry() -> None:
    """Phase 19: cli.pretrain with the shipped MPP config on a synthetic
    split, cli.test on the MPP config (the run's best val loss), and
    cli.train finetuning from its encoder_best_params.npz with the shipped
    supervised config."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data, labels = make_regression_dataset(96, raw_vertices=40962, seed=SEED + 6)
        for split, sl in (("train", slice(0, 64)), ("validation", slice(64, 96))):
            np.save(tmp / f"{split}_data.npy", data[sl])
            np.save(tmp / f"{split}_labels.npy", labels[sl])
        del data
        common = [f"data.data_path={tmp}", "data.split=validation", "training.epochs=2",
                  "training.val_epoch=1", f"logging.folder_to_save_model={tmp / 'runs'}"]

        def cli(tool, cfg, *extra):
            """The CLI's ``main`` with these arguments, in this process (phases
            5, 8 and 13 run ``python -m`` in subprocesses); -> (the results
            dict it prints last, seconds)."""
            mod = importlib.import_module(f"surface_vision_transformers_tpu_torch.cli.{tool}")
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mod.main([str(cfg), "--device", "cuda",
                          *[a for s_ in (*common, *extra) for a in ("--set", s_)]])
            last = out.getvalue().strip().splitlines()[-1]
            return ast.literal_eval(last), time.perf_counter() - t0

        pre, t_pre = cli("pretrain", MPP_CFG)
        run_dir = Path(pre["run_dir"])
        missing = [f for f in ("best_params.npz", "encoder_best_params.npz", "final_params.npz",
                               "encoder_final_params.npz", "hparams_results.yml")
                   if not (run_dir / f).exists()]
        with open(run_dir / "metrics_val.csv") as f:
            val_loss = [float(r["val/loss"]) for r in csv.DictReader(f)]
        tested, t_test = cli("test", MPP_CFG,
                             f"testing.path_to_ckpt={run_dir / 'best_params.npz'}")
        ft, t_ft = cli("train", TRAIN_CFG, "training.bs=32", "training.bs_val=32",
                       "training.load_weights_ssl=true",
                       f"weights.ssl_mpp={run_dir / 'encoder_best_params.npz'}")
        phase("pretrain-entry", f"cli.pretrain {MPP_CFG.relative_to(ROOT)} in {t_pre:.1f} s: val "
              "loss by epoch " + " ".join(f"{v:.6g}" for v in val_loss) + f", best "
              f"{pre['best_loss']:.6g} at epoch {pre['best_epoch']}; files missing: "
              f"{missing or 'none'}; cli.test on best_params.npz in {t_test:.1f} s: {tested} "
              f"(must equal the best val loss); cli.train {TRAIN_CFG.relative_to(ROOT)} from "
              f"encoder_best_params.npz in {t_ft:.1f} s: best val MAE {ft['best_mae']:.6g}, run "
              f"{Path(ft['run_dir']).name}")
        if missing or len(val_loss) != 2 or not all(math.isfinite(v) for v in val_loss):
            raise AssertionError("cli.pretrain did not pretrain as expected")
        if tested["n"] != 32 or abs(tested["loss"] - pre["best_loss"]) > 1e-4 * pre["best_loss"]:
            raise AssertionError("cli.test disagrees with the best epoch's val loss")
        if not math.isfinite(ft["best_mae"]) or "-ssl-" not in Path(ft["run_dir"]).name:
            raise AssertionError("cli.train did not finetune from the MPP encoder")


# Phases 20-23: W8A8 int8 serving (``tpu.quant: int8``) of SiT-base on
# sub-ico 3, and the gather-fused patch embedding.
INT8_SOURCE = "surface_vision_transformers_tpu_torch/csrc/fused_block_int8.cu"
EMBED_SOURCE = "surface_vision_transformers_tpu_torch/csrc/patch_embed.cu"
INT8_TPU = "surface_vision_transformers_tpu/ops/pallas/fused_block_int8.py:145"
EMBED_TPU = "surface_vision_transformers_tpu/ops/pallas/patch_embed.py:34"
PEAK_INT8 = 1979e12  # the H100 SXM's dense int8 tensor-core peak (NVIDIA's data sheet)
# fused_block_int8 cases (dim, heads, mlp, B, N, valid_len): SiT-base on
# sub-ico 3 at its bs_val, SiT-small width at SiT-tiny's N, the JAX package's
# padded N with its mask, and one 64-key tile (N = 64), where the attention
# kernel rounds P against the row's final max as the plain version does, so
# the chain matches the bf16 plain run but for rare code flips and a control
# that only double-rounds the output can be told apart.
INT8_CASES = [(768, 12, 3072, 64, 1281, 1281), (384, 6, 1536, 256, 321, 321),
              (384, 6, 1536, 64, 328, 321), (384, 6, 1536, 512, 64, 64)]
# Block times, int8 against the bf16 fused_block, at three widths (dim,
# heads, mlp, B, N): the card's own crossover, beside the JAX package's
# INT8_MIN_DIM = 384.
INT8_RATE_CASES = [(192, 3, 768, 256, 321), (384, 6, 1536, 256, 321), (768, 12, 3072, 64, 1281)]
# fused_block_int8 gates, set from readings on an NVIDIA H100 80GB HBM3 at
# 700 W. A code that lands on the other side of a rounding boundary in the
# kernel and in the plain version moves a whole row by a quantization step,
# so the kernel sits up to 3.5 bf16 steps (at the largest output) from the
# bf16 plain int8 block, where the bf16 blocks of phase 3 sit within one;
# the controls are held by what moves them. (i) max |err| against the fp32
# and the bf16 plain run: readings 1.61-3.50 steps (the plain bf16 run
# reads up to 3.47 from the fp32 one), valid_len ignored 25.7-27.8.
# (ii) rel-L2 against the fp32 plain run over the bf16 plain run's own:
# readings 1.000 (0.0101-0.0128 each), one scale per tensor 1.78-2.12,
# valid_len ignored 7.3-7.4. (iii) at N = 64 the share of outputs that
# differ from the bf16 plain run: readings 0.027-0.031, x1 rounded to bf16
# 0.694-0.702 (its max and rel-L2 sit with the kernel's: a double rounding
# moves an output by one step at most).
INT8_STEPS, INT8_REL_RATIO, INT8_SHARE = 6, 1.25, 0.05
EMBED_CASES = [(2, 256, 192), (2, 256, 384), (3, 64, 768)]  # (sub_ico, B, dim)
# int8 SiT-base predictions against the fp32 eager model, rel-L2. At these
# seeded weights (attention O(1) of every block, twelve blocks) bf16
# ``predict`` itself reads 0.024-0.029 and int8 0.031-0.058 (two draws of
# the weights), above tests/test_int8.py's 0.02 for a two-block model; the
# gate is set from those readings (an NVIDIA H100 80GB HBM3 at 700 W), the
# control (a block dropped) read 1.69-2.16.
INT8_SLICE_REL = 0.08
INT8_SLICE_N = 128  # SiT-base surfaces served at bs_val 64 (two batches)


def int8_block_params(rng, dim, heads, mlp):
    """(fused_block_int8's 15 parameters, fused_block's 11 in bf16) on the
    card from phase 10's seeded block, the int8 codes quantized from
    float32."""
    from surface_vision_transformers_tpu_torch.ops.quant import quantize_block_weights

    p = [t.cuda() for t in block_params(rng, dim, heads, mlp)]
    q = quantize_block_weights(p[2], p[3], p[7], p[9])
    p8 = (p[0], p[1], *q[:4], p[4], p[5], p[6], q[4], q[5], p[8], q[6], q[7], p[10])
    return p8, [(t.bfloat16() if t.dim() == 2 else t).contiguous() for t in p]


def per_tensor_rows(h):
    """A control's activation quantizer: one scale for the whole tensor in
    place of one per row."""
    from surface_vision_transformers_tpu_torch.ops import quant

    hf = h.float()
    absmax = hf.abs().amax().reshape([1] * hf.dim()).expand(*hf.shape[:-1], 1)
    return quant._quantize(hf, absmax)


def int8_block_x1_rounded(fb, x, p, heads, vl):
    """The plain int8 block with x1 rounded to bf16 (a control)."""
    from surface_vision_transformers_tpu_torch.ops.quant import int8_mm_reference as mm

    (ln1_s, ln1_b, q_qkv, s_qkv, q_out, s_out, b_out, ln2_s, ln2_b,
     q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2) = p
    hd, dt = heads * DH, x.dtype
    qkv = mm(fb._layer_norm(x, ln1_s, ln1_b, 1e-5), q_qkv, s_qkv).to(dt)
    attn = fb._attention(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], heads, DH, vl, dt)
    x1 = (x.float() + (mm(attn, q_out, s_out) + b_out)).bfloat16().float()
    f = F.gelu(mm(fb._layer_norm(x1, ln2_s, ln2_b, 1e-5), q_fc1, s_fc1) + b_fc1)
    return (x1 + (mm(f, q_fc2, s_fc2) + b_fc2)).to(dt)


def int8_block_ops(B, N, vl, dim, heads, mlp):
    """(int8 GEMM operations, bf16 attention operations) of one block; the
    attention products over the rows and keys < valid_len."""
    hd = heads * DH
    return 2 * B * N * (dim * 3 * hd + hd * dim + 2 * dim * mlp), 4 * B * heads * vl * vl * DH


def phase_int8_kernels(rng, fb) -> dict:
    """Phase 20: the int8 chain's row quantizer and GEMM bitwise against
    their plain versions at SiT-base shapes; fused_block_int8 against the
    float32 and bf16 plain int8 block with controls; times beside
    fused_block, ``torch._int_mm`` and the bounds. -> the kernel's row."""
    from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as fbi8
    from surface_vision_transformers_tpu_torch.ops import quant

    failures = []
    M = 64 * 1281  # SiT-base rows at bs_val 64
    for K, dt in ((768, torch.float32), (3072, torch.float32), (768, torch.bfloat16)):
        h = torch.randn((M, K), device="cuda", dtype=torch.float32) * 3.0
        h[0] = 0.0  # an all-zero row: the 1e-30 floor
        h[1, :] = (torch.arange(K, device="cuda") % 255 - 127 + 0.5).float()  # half steps
        h = h.to(dt)
        q, s = fbi8.quant_rows_kernel(h)
        qp, sp = quant.quant_rows(h)
        bad = int((q != qp).sum()) + int((s != sp.reshape(-1)).sum())
        phase("int8-kernels", f"row quantizer M={M} K={K} {str(dt)[6:]}: {bad} of "
              f"{q.numel() + s.numel()} codes and scales differ from the plain version "
              f"(must be 0); zero row scale {s[0].item():.6g}")
        if bad:
            failures.append(f"row quantizer K={K} {dt}")
    times = {}
    gemms = {"qkv": (2304, 768), "out": (768, 768), "fc1": (3072, 768), "fc2": (768, 3072)}
    for name, (n_out, K) in gemms.items():
        qa = torch.randint(-127, 128, (M, K), device="cuda", dtype=torch.int8)
        qa[:64] = 127
        qw = torch.randint(-127, 128, (n_out, K), device="cuda", dtype=torch.int8)
        qw[:8] = 127
        acc = fbi8.int8_gemm_kernel(qa, qw)
        bad = int((acc != quant.int8_product(qa, qw)).sum())
        phase("int8-kernels", f"int8 GEMM {name} M={M} N={n_out} K={K}: {bad} int32 "
              f"accumulators differ from the exact product (must be 0); largest "
              f"|acc| {acc.abs().max().item()}")
        if bad:
            failures.append(f"int8 GEMM {name}")
        ms = cuda_ms(lambda: fbi8.int8_gemm_kernel(qa, qw))
        try:
            lib = cuda_ms(lambda: torch._int_mm(qa, qw.t()))
        except RuntimeError as e:  # a yardstick only: report what the library refused
            lib, why = None, str(e).splitlines()[0]
            phase("int8-kernels", f"torch._int_mm refused {name}: {why}")
        b = max(2 * M * n_out * K / PEAK_INT8, (qa.numel() + qw.numel() + 4 * acc.numel())
                / PEAK_BYTES) * 1e3
        times[name] = (ms, lib, b)
        phase("int8-kernels", f"int8 GEMM {name}: kernel {ms:.4f} ms, torch._int_mm "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound {b:.4f} ms "
              f"({2 * M * n_out * K / 1e9:.1f} G int8 operations; CUDA-event medians of 25)")
        del qa, qw, acc
    torch.cuda.empty_cache()

    row = None
    for dim, heads, mlp, B, N, vl in INT8_CASES:
        p8, _ = int8_block_params(rng, dim, heads, mlp)
        kw = dict(heads=heads, dim_head=DH)
        x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N, dim)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        got = fbi8.fused_block_int8(x, *p8, valid_len=vl, **kw).float()
        chunk = 16 if N > 400 else 64

        def plain(fn=fbi8.fused_block_int8_reference, dtype=None, valid=vl):
            return sliced(lambda xs: fn(xs.to(dtype) if dtype else xs, *p8, valid_len=valid,
                                        **kw).float(), x, chunk=chunk)

        ref32, ref_bf = plain(dtype=torch.float32), plain()
        rows = slice(0, vl)

        def steps(a, r=ref32):
            return ((a - r)[:, rows].abs().max() / bf16_step(r[:, rows].abs().max().item())).item()

        def rel(a, r=ref32):
            return (torch.linalg.vector_norm((a - r)[:, rows])
                    / torch.linalg.vector_norm(r[:, rows])).item()

        def share(a, r=ref_bf):
            return (a[:, rows] != r[:, rows]).float().mean().item()

        cases = {"kernel": got, "plain bf16": ref_bf}
        if N == vl and N > 64:
            with mock.patch.object(quant, "quant_rows", per_tensor_rows):
                cases["control: one scale per tensor"] = plain(dtype=torch.float32)
        if N > vl:
            cases["control: valid_len ignored"] = plain(dtype=torch.float32, valid=N)
        if N == 64:
            cases["control: x1 rounded to bf16"] = sliced(
                lambda xs: int8_block_x1_rounded(fb, xs, p8, heads, vl).float(), x, chunk=chunk)
        for label, a in cases.items():
            phase("int8-kernels", f"dim {dim} B={B} N={N} valid_len={vl}: {label}: max |err| vs "
                  f"fp32 plain {steps(a):.3f} bf16 steps at the largest output, vs plain bf16 "
                  f"{steps(a, ref_bf):.3f}; rel-L2 vs fp32 plain {rel(a):.4g}; share of outputs "
                  f"differing from plain bf16 {share(a):.4f}")
        rel_bf = rel(ref_bf)

        def passes(a):
            """The three gates: max steps, rel-L2 ratio, and at N = 64 the share."""
            return (bool(torch.isfinite(a).all()) and max(steps(a), steps(a, ref_bf)) <= INT8_STEPS
                    and rel(a) <= INT8_REL_RATIO * rel_bf and (N > 64 or share(a) <= INT8_SHARE))

        phase("int8-kernels", f"dim {dim} N={N}: gates max {INT8_STEPS} bf16 steps vs both, "
              f"rel-L2 vs fp32 plain <= {INT8_REL_RATIO} x plain bf16's {rel_bf:.4g}"
              + (f", share <= {INT8_SHARE}" if N == 64 else "") + "; every control must fail one")
        if not passes(got):
            failures.append(f"fused_block_int8 dim {dim} N={N} failed its gates")
        failures += [f"fused_block_int8 dim {dim} N={N}: {k} passed the gates"
                     for k, v in cases.items() if k.startswith("control") and passes(v)]
        if (dim, B, N) == (768, 64, 1281):
            with torch.inference_mode():
                ms = cuda_ms(lambda: fbi8.fused_block_int8(x, *p8, **kw), reps=10)
                plain_ms = cuda_ms(lambda: [fbi8.fused_block_int8_reference(
                    x[s:s + 16], *p8, **kw) for s in range(0, B, 16)], reps=3)
            g_ops, a_ops = int8_block_ops(B, N, vl, dim, heads, mlp)
            nbytes = nbytes_of(x, *p8) + x.numel() * 2
            t_ops = (g_ops / PEAK_INT8 + a_ops / PEAK_FLOPS) * 1e3
            b_ms, b_by = max((t_ops, "operations"), (nbytes / PEAK_BYTES * 1e3, "bytes"))
            phase("int8-kernels", f"fused_block_int8 SiT-base B={B} N={N}: kernel {ms:.4f} ms, "
                  f"plain int8 block (bf16, 4 slices of 16) {plain_ms:.4f} ms (CUDA-event medians "
                  f"of 10 / 3); bound {b_ms:.4f} ms by {b_by} ({g_ops / 1e12:.3f} T int8 "
                  f"operations + {a_ops / 1e12:.3f} TFLOP attention, {nbytes / 1e6:.1f} MB); "
                  "the four GEMMs alone (kernel / torch._int_mm / bound, ms): "
                  + ", ".join(f"{k} {t[0]:.4f} / {'n/a' if t[1] is None else f'{t[1]:.4f}'} / "
                              f"{t[2]:.4f}" for k, t in times.items()))
            row = {"name": "fused_block_int8", "route": "cuda", "source": INT8_SOURCE,
                   "replaces": INT8_TPU, "max_abs_err": (got - ref32).abs().max().item(),
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None}
        del got, ref32, ref_bf, cases, x
        torch.cuda.empty_cache()

    for dim, heads, mlp, B, N in INT8_RATE_CASES:
        p8, pb = int8_block_params(rng, dim, heads, mlp)
        kw = dict(heads=heads, dim_head=DH)
        x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N, dim)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        with torch.inference_mode():
            t8 = cuda_ms(lambda: fbi8.fused_block_int8(x, *p8, **kw), reps=10)
            t16 = cuda_ms(lambda: fb.fused_block(x, *pb, **kw), reps=10)
        phase("int8-kernels", f"crossover, dim {dim} mlp {mlp} B={B} N={N}: fused_block_int8 "
              f"{t8:.4f} ms, fused_block (bf16) {t16:.4f} ms, ratio bf16/int8 {t16 / t8:.3f} "
              "(CUDA-event medians of 10)")
        del x
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("int8 kernels: " + "; ".join(failures))
    return row


def embed_plain_cv(x, idx, w, b):
    """The plain embedding with the tokens in (c v) order in place of (v c)
    (a control)."""
    B, C, _ = x.shape
    L, V = idx.shape
    t = x.index_select(2, idx.reshape(-1)).reshape(B, C, L, V).permute(0, 2, 1, 3)
    t = t.reshape(B, L, C * V).to(w.dtype).float()
    return (t @ w[:, :C * V].float().t() + b).to(w.dtype)


def phase_patch_embed(rng, embed_launches) -> dict:
    """Phase 21: the gather-fused patch_embed against the float32 and bf16
    plain versions at sub-ico 2 (B=256, dim 192 and 384) and sub-ico 3
    (B=64, dim 768), with controls; times beside the plain version,
    index_select + torch.matmul, and the bound. -> the kernel's row (at
    phase 4's shape, with phase 4's launches)."""
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.ops import patch_embed as pe

    failures, row = [], None
    for sub_ico, B, dim in EMBED_CASES:
        table = load_patch_table(6, sub_ico).indices
        L, V = table.shape
        idx = pe.table_tensor(table, "cuda")
        x = torch.from_numpy(rng.standard_normal((B, 4, 40962)).astype(np.float32)).cuda()
        bd = 1.0 / np.sqrt(4 * V)
        kernel = torch.from_numpy(rng.uniform(-bd, bd, (4 * V, dim)).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.uniform(-bd, bd, dim).astype(np.float32)).cuda()
        means = rng.uniform(-1, 1, (1, 4, 1)).astype(np.float32)
        stds = rng.uniform(0.5, 2, (1, 4, 1)).astype(np.float32)
        w, b = pe.embed_matrix(kernel, bias, V, means=means, stds=stds)
        got = pe.patch_embed(x, idx, w, b).float()
        ref32 = pe.patch_embed_reference(x, idx, w.float(), b).float()
        ref_bf = pe.patch_embed_reference(x, idx, w, b).float()
        step = bf16_step(ref32.abs().max().item())
        errs = {"vs fp32 plain": (got - ref32).abs().max().item(),
                "vs plain bf16": (got - ref_bf).abs().max().item(),
                "plain bf16 vs fp32 plain": (ref_bf - ref32).abs().max().item()}
        controls = {
            "table shifted by one patch": (got - pe.patch_embed_reference(
                x, idx.roll(1, 0), w, b).float()).abs().max().item(),
            "(c v) order": (got - embed_plain_cv(x, idx, w, b).float()).abs().max().item()}
        phase("patch-embed", f"sub-ico {sub_ico} ({L} x {V}, K {4 * V} -> {w.shape[1]}) B={B} "
              f"dim {dim}: max |err| " + ", ".join(f"{k} {v / step:.3f}" for k, v in errs.items())
              + f" bf16 steps at the largest output (gate {BOUND_STEPS}); controls: "
              + ", ".join(f"{k} {v / step:.1f}" for k, v in controls.items()))
        if not bool(torch.isfinite(got).all()) or max(errs["vs fp32 plain"],
                                                      errs["vs plain bf16"]) > BOUND_STEPS * step:
            failures.append(f"patch_embed sub-ico {sub_ico} dim {dim}")
        if min(controls.values()) <= BOUND_STEPS * step:
            failures.append(f"patch_embed sub-ico {sub_ico} dim {dim}: a control passed the gate")
        flat = idx.reshape(-1)
        wt = w[:, :4 * V].t()

        def library():  # index_select + torch.matmul: the library form
            t = x.index_select(2, flat).view(B, 4, L, V).permute(0, 2, 3, 1).reshape(B, L, 4 * V)
            return torch.addmm(b.bfloat16(), t.bfloat16().reshape(B * L, -1), wt)

        ms = cuda_ms(lambda: pe.patch_embed(x, idx, w, b))
        plain_ms = cuda_ms(lambda: pe.patch_embed_reference(x, idx, w, b), reps=5)
        lib_ms = cuda_ms(library)
        flops = 2 * B * L * 4 * V * dim
        nbytes = nbytes_of(x, idx, w, b) + got.numel() * 2
        b_ms, b_by = bound_ms(flops, nbytes)
        phase("patch-embed", f"sub-ico {sub_ico} B={B} dim {dim}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, index_select + addmm {lib_ms:.4f} ms (CUDA-event medians of "
              f"25 / 5 / 25); bound {b_ms:.4f} ms by {b_by} ({flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
        if (sub_ico, B, dim) == (2, 256, 192):
            row = {"name": "patch_embed", "route": "cuda", "source": EMBED_SOURCE,
                   "replaces": EMBED_TPU, "launches": embed_launches,
                   "max_abs_err": errs["vs fp32 plain"], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        del x, got, ref32, ref_bf
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return row


def phase_int8_slice(rng, fb, fused, exp, table, state, tiny) -> int:
    """Phase 22: SiT-base ``predict(quant="int8")`` at bs_val 64 with the
    launches per forward, against the float32 eager model and bf16
    ``predict``, with a control; int8 and bf16 surfaces/s and peak memory
    at B=64 and 128, and of the SiT-tiny model ``tiny`` at B=256 (below the
    crossover, where the trainer and the CLI serve bf16). -> fused_block_int8's
    launches."""
    from surface_vision_transformers_tpu_torch.models.sit import SiT

    m = exp.model
    model = SiT.from_config(exp, patch_table=table, dtype=torch.bfloat16, attn_backend="plain")
    model.load_state_dict(state, strict=True)
    model = model.eval().cuda()
    data = rng.standard_normal((INT8_SLICE_N, 4, 40962)).astype(np.float32)
    bs = exp.training.bs_val
    n_batches = INT8_SLICE_N // bs
    counters = zero_counts(fb)
    preds8 = fused.predict(model, data, device="cuda", batch_size=bs, quant="int8")
    launches = read_counts(counters)
    want = {k: 0 for k in counters}
    want.update(fused_block_int8=(m.depth - 1) * n_batches, fused_block_cls=n_batches,
                patch_embed=n_batches)
    phase("int8-slice", f"predict({INT8_SLICE_N} surfaces, batch {bs}, quant int8): launches "
          f"{launches}, expected {want}")
    if launches != want:
        raise AssertionError("the int8 serving path did not launch as expected")
    preds16 = fused.predict(model, data, device="cuda", batch_size=bs)
    w8 = fused.prepare_weights(model, "int8")
    plain32 = SiT.from_config(exp, patch_table=table, dtype=torch.float32, attn_backend="plain")
    plain32.load_state_dict(state, strict=True)
    plain32 = plain32.eval().cuda()
    with torch.inference_mode():
        x = torch.from_numpy(data).cuda()
        ref = torch.cat([plain32(x[s:s + bs]) for s in range(0, INT8_SLICE_N, bs)]).cpu().numpy()
        dropped = dataclasses.replace(w8, blocks=w8.blocks[:6] + w8.blocks[7:])
        control = fused.fused_forward(model, x[:bs], dropped, quant="int8").cpu().numpy()
    del plain32, x

    def rel(a, r):
        return float(np.linalg.norm(a - r) / np.linalg.norm(r))

    r8, r16, rc = rel(preds8, ref), rel(preds16, ref), rel(control, ref[:bs])
    phase("int8-slice", f"predictions vs the fp32 eager model: int8 rel-L2 {r8:.4g} (tol "
          f"{INT8_SLICE_REL}; tests/test_int8.py's two-block bound is 0.02), max |gap| "
          f"{np.abs(preds8 - ref).max():.6g}; bf16 predict rel-L2 "
          f"{r16:.4g}, max |gap| {np.abs(preds16 - ref).max():.6g}; int8 vs bf16 max |gap| "
          f"{np.abs(preds8 - preds16).max():.6g}; std across surfaces {ref.std():.4g}, mean "
          f"{ref.mean():.4g}; control, block 6 dropped: rel-L2 {rc:.4g} (must exceed the tol)")
    if not np.isfinite(preds8).all() or r8 > INT8_SLICE_REL:
        raise AssertionError("the int8 serving path disagrees with the fp32 model")
    if rc <= INT8_SLICE_REL:
        raise AssertionError("the int8 slice control passed the gate")
    w16 = fused.prepare_weights(model)
    with torch.inference_mode():
        for B in (64, 128):
            xb = torch.from_numpy(rng.standard_normal((B, 4, 40962)).astype(np.float32)).to(
                "cuda", torch.bfloat16)
            res = {}
            for label, w, q in (("int8", w8, "int8"), ("bf16", w16, None)):
                torch.cuda.reset_peak_memory_stats()
                t = cuda_ms(lambda: fused.fused_forward(model, xb, w, quant=q), reps=5)
                res[label] = (t, torch.cuda.max_memory_allocated() / 2**30)
            phase("int8-slice", f"B={B} raw bf16 input on device: " + ", ".join(
                f"{k} {t:.3f} ms = {B / t * 1e3:.1f} surfaces/s (peak {g:.2f} GiB allocated)"
                for k, (t, g) in res.items()) + f"; int8/bf16 rate {res['bf16'][0] / res['int8'][0]:.3f} "
                "(CUDA-event medians of 5)")
            del xb
    del model, w8, w16
    w8, w16 = fused.prepare_weights(tiny, "int8"), fused.prepare_weights(tiny)
    with torch.inference_mode():
        xb = torch.from_numpy(rng.standard_normal((256, 4, 40962)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        t8 = cuda_ms(lambda: fused.fused_forward(tiny, xb, w8, quant="int8"), reps=10)
        t16 = cuda_ms(lambda: fused.fused_forward(tiny, xb, w16), reps=10)
    phase("int8-slice", f"SiT-tiny B=256 raw bf16 input on device: int8 {t8:.3f} ms = "
          f"{256 / t8 * 1e3:.1f} surfaces/s, bf16 {t16:.3f} ms = {256 / t16 * 1e3:.1f} "
          f"surfaces/s; int8/bf16 rate {t16 / t8:.3f} (CUDA-event medians of 10)")
    del xb, w8, w16
    torch.cuda.empty_cache()
    return launches["fused_block_int8"]


def phase_int8_entry(fb, tiny_cfg, tiny_tree, tiny_data, tiny_labels) -> None:
    """Phase 23: ``cli.test`` on the SiT-base config cut to
    BASE_ENTRY_DEPTH blocks with ``--set tpu.quant=int8`` (results.csv must
    equal ``predict(quant="int8")``, the launches per batch those of int8
    serving), then on a SiT-tiny config with and without int8: the notice
    and the bf16 MAE."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
    from surface_vision_transformers_tpu_torch.models import fused
    from surface_vision_transformers_tpu_torch.train.runner import build_model, load_state_dict_any
    from surface_vision_transformers_tpu_torch.utils import config

    def cli(cfg, *sets):
        """cli.test's ``main`` in this process -> (its stdout lines, seconds)."""
        mod = importlib.import_module("surface_vision_transformers_tpu_torch.cli.test")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main([str(cfg), "--device", "cuda", *[a for s_ in sets for a in ("--set", s_)]])
        return out.getvalue().strip().splitlines(), time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        n, bs_val = 16, 8
        data, labels = make_regression_dataset(n, raw_vertices=40962, seed=SEED + 7)
        np.save(tmp / "validation_data.npy", data)
        np.save(tmp / "validation_labels.npy", labels)
        exp = config.load_config(BASE_CFG)
        m = exp.model
        tree = jax_shaped_params(np.random.default_rng(SEED + 7), m.num_vertices,
                                 width=(m.dim, BASE_ENTRY_DEPTH, m.heads, m.mlp_dim),
                                 n_tokens=m.num_patches + 1)
        np.savez(tmp / "best_params.npz", **flatten({"params": tree}))
        sets = [f"data.data_path={tmp}", "data.split=validation", f"training.bs_val={bs_val}",
                f"transformer.depth={BASE_ENTRY_DEPTH}",
                f"testing.path_to_ckpt={tmp / 'best_params.npz'}", "tpu.quant=int8"]
        counters = zero_counts(fb)
        lines, secs = cli(BASE_CFG, *sets)
        launches = read_counts(counters)
        reported = ast.literal_eval(lines[-1])
        with open(tmp / "results.csv") as f:
            cli_preds = np.array([float(r["pred"]) for r in csv.DictReader(f)], np.float32)
        exp4 = dataclasses.replace(exp, model=dataclasses.replace(m, depth=BASE_ENTRY_DEPTH))
        from surface_vision_transformers_tpu_torch.geometry import load_patch_table

        model = build_model(exp4, load_patch_table(exp.ico, exp.sub_ico).indices)
        model.load_state_dict(load_state_dict_any(str(tmp / "best_params.npz"),
                                                  BASE_ENTRY_DEPTH), strict=True)
        same = fused.predict(model.eval(), data, device="cuda", batch_size=bs_val,
                             quant="int8").reshape(-1)
        want = {k: 0 for k in counters}
        want.update(fused_block_int8=(BASE_ENTRY_DEPTH - 1) * 2, fused_block_cls=2,
                    patch_embed=2)
        err = float(np.abs(cli_preds - same).max())
        phase("int8-entry", f"cli.test {BASE_CFG.relative_to(ROOT)} --set tpu.quant=int8 "
              f"(depth {BASE_ENTRY_DEPTH}) in {secs:.1f} s: {reported}; launches {launches}, "
              f"expected {want}; |results.csv - predict(quant int8)| max {err:.6g} (must be 0); "
              f"notice printed: {any('INT8_MIN_DIM' in ln for ln in lines)} (must be False)")
        if launches != want or err != 0 or len(cli_preds) != n:
            raise AssertionError("cli.test int8 on SiT-base disagrees with predict")
        if any("INT8_MIN_DIM" in ln for ln in lines):
            raise AssertionError("cli.test printed the fallback notice at dim 768")
        del model

        (tmp / "tiny").mkdir()
        np.save(tmp / "tiny" / "validation_data.npy", tiny_data)
        np.save(tmp / "tiny" / "validation_labels.npy", tiny_labels)
        np.savez(tmp / "tiny" / "best_params.npz", **flatten({"params": tiny_tree}))
        cfg = dict(tiny_cfg, data={"data_path": str(tmp / "tiny"), "split": "validation"},
                   testing={"path_to_ckpt": str(tmp / "tiny" / "best_params.npz")})
        (tmp / "tiny.json").write_text(json.dumps(cfg))
        lines8, _ = cli(tmp / "tiny.json", "tpu.quant=int8")
        lines16, _ = cli(tmp / "tiny.json")
        notice = [ln for ln in lines8 if "INT8_MIN_DIM" in ln]
        r8, r16 = ast.literal_eval(lines8[-1]), ast.literal_eval(lines16[-1])
        phase("int8-entry", f"cli.test SiT-tiny (dim {DIM}) --set tpu.quant=int8: {r8}, notice "
              f"{notice}; without quant: {r16} (the MAE must be equal)")
        if len(notice) != 1 or r8 != r16:
            raise AssertionError("SiT-tiny int8 did not fall back to bf16 with one notice")


def phase_fp32_entry(fb, tiny_cfg, tiny_tree, tiny_data, tiny_labels) -> None:
    """Phase 24: ``cli.test <cfg> --set tpu.compute_dtype=float32 --device
    cuda`` on SiT-tiny. float32 serves through the modular model, as the
    JAX trainer's ``_use_fused_inference`` (bfloat16 only) routes it, so no
    kernel launches; results.csv must equal in-process float32 serving
    (``predict`` of the float32 model) bit for bit, and the printed MAE the
    csv's."""
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.models import fused
    from surface_vision_transformers_tpu_torch.train.runner import build_model, load_state_dict_any
    from surface_vision_transformers_tpu_torch.utils import config

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.save(tmp / "validation_data.npy", tiny_data)
        np.save(tmp / "validation_labels.npy", tiny_labels)
        np.savez(tmp / "best_params.npz", **flatten({"params": tiny_tree}))
        cfg = dict(tiny_cfg, data={"data_path": str(tmp), "split": "validation"},
                   testing={"path_to_ckpt": str(tmp / "best_params.npz")})
        (tmp / "cfg.json").write_text(json.dumps(cfg))
        mod = importlib.import_module("surface_vision_transformers_tpu_torch.cli.test")
        out = io.StringIO()
        counters = zero_counts(fb)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main([str(tmp / "cfg.json"), "--set", "tpu.compute_dtype=float32",
                      "--device", "cuda"])
        secs = time.perf_counter() - t0
        launches = read_counts(counters)
        reported = ast.literal_eval(out.getvalue().strip().splitlines()[-1])
        with open(tmp / "results.csv") as f:
            rows = list(csv.DictReader(f))
        cli_preds = np.array([float(r["pred"]) for r in rows], np.float32)
        targets = np.array([float(r["target"]) for r in rows], np.float32)
        exp = config.from_dict(dict(cfg, tpu={"compute_dtype": "float32"}))
        model = build_model(exp, load_patch_table(exp.ico, exp.sub_ico).indices)
        model.load_state_dict(load_state_dict_any(str(tmp / "best_params.npz"),
                                                  exp.model.depth), strict=True)
        bs_val = exp.training.bs_val or exp.training.bs
        same = fused.predict(model.eval(), tiny_data, device="cuda",
                             batch_size=bs_val).reshape(-1)
        err = float(np.abs(cli_preds - same).max())
        shifted = float(np.abs(cli_preds - np.roll(same, 1)).max())  # control
        mae = float(np.abs(cli_preds - targets).mean())
        want = {k: 0 for k in counters}
        phase("fp32-entry", f"cli.test --set tpu.compute_dtype=float32 --device cuda in "
              f"{secs:.1f} s: {reported}; results.csv {len(rows)} rows; launches {launches}, "
              f"expected {want}; |results.csv - float32 predict| max {err:.6g} (must be 0; "
              f"control, rows shifted by one: {shifted:.6g}); MAE of the csv {mae:.6f}")
        if len(rows) != len(tiny_labels) or not np.array_equal(targets, tiny_labels):
            raise AssertionError("float32 cli.test: results.csv rows out of order")
        if launches != want or err != 0 or shifted == 0:
            raise AssertionError("float32 cli.test disagrees with in-process float32 serving")
        if abs(reported["mae"] - mae) > 1e-6:
            raise AssertionError("float32 cli.test's MAE disagrees with its results.csv")


def main() -> None:
    # -- 1. device
    start("device")
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
    start("build")
    cached = _native.library_path().exists()
    t0 = time.perf_counter()
    _native.build()
    _native.library()
    phase("build", f"{time.perf_counter() - t0:.2f} s "
          f"({'already built' if cached else 'nvcc'}) -> {_native.library_path().name}")
    phase("build", "ptxas: " + ptxas_report(_native.library_path().with_suffix(".log")))

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    table = load_patch_table(6, 2).indices
    tree = jax_shaped_params(rng, table.shape[1])
    state = state_dict_from_jax(tree, DEPTH)

    def sit(dtype):  # the plain path: eager SiT, plain attention
        m = SiT(dim=DIM, depth=DEPTH, heads=HEADS, mlp_dim=MLP, dim_head=DH,
                patch_table=table, dtype=dtype, attn_backend="plain")
        m.load_state_dict(state, strict=True)
        return m.eval().to(dev)

    model, plain32 = sit(torch.bfloat16), sit(torch.float32)
    w = fused.prepare_weights(model)

    # -- 3. kernels
    start("kernels")
    kernels = phase_kernels(rng, fb, w.blocks[0], model.transformer.layers[0])

    # -- 4. slice
    start("slice")
    data = rng.standard_normal((300, 4, 40962)).astype(np.float32)
    counters = zero_counts(fb)
    preds = fused.predict(model, data, device="cuda", batch_size=256)
    launches = read_counts(counters)
    n_batches = 2
    want = {k: 0 for k in counters}
    want.update(fused_block=(DEPTH - 1) * n_batches, fused_block_cls=n_batches,
                patch_embed=n_batches)
    phase("slice", f"predict(300 surfaces, batch 256): launches {launches}, "
          f"expected {want}")
    if launches != want:
        raise AssertionError("the main path did not launch every kernel as expected")
    if preds.shape != (300, 1) or not np.isfinite(preds).all():
        raise AssertionError(f"bad predictions: shape {preds.shape}")
    for name in ("fused_block", "fused_block_cls"):
        kernels[name]["launches"] = launches[name]
    embed_launches = launches["patch_embed"]

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
    start("entry")
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
        tiny_entry = (cfg, tree, sub, labels)  # phase 23 serves them again

    # -- 6. train-kernels
    start("train-kernels")
    from surface_vision_transformers_tpu_torch.models import sit as sit_module

    del model, plain32, w
    torch.cuda.empty_cache()
    kernels.update(phase_train_kernels(rng, fb, sit_module))

    # -- 7. train (the training path; every count zeroed just before it)
    start("train")
    launches, fused_step_s = phase_train(table)
    for name in ("fused_block_bwd", "fused_block_cls_bwd"):
        kernels[name]["launches"] = launches[name]
    torch.cuda.empty_cache()

    # -- 8. train-entry
    start("train-entry")
    phase_train_entry()

    # -- 9. flash-kernels
    start("flash-kernels")
    kernels.update(phase_flash(rng))

    # -- 10. base-kernels
    start("base-kernels")
    from surface_vision_transformers_tpu_torch.utils import config

    exp = config.load_config(BASE_CFG)
    phase_base_kernels(rng, fb, sit_module, exp.model, exp.training.bs)

    # -- 11. base-slice
    start("base-slice")
    t_phase = time.perf_counter()
    t3 = load_patch_table(exp.ico, exp.sub_ico)
    m = exp.model
    phase("base-slice", f"{BASE_CFG.relative_to(ROOT)}: dim {m.dim}, depth {m.depth}, heads "
          f"{m.heads}, mlp {m.mlp_dim}, {m.num_patches} patches x {m.num_vertices} vertices "
          f"(N = {m.num_patches + 1}, unpadded), table {t3.ordering} order, generated in "
          f"{time.perf_counter() - t_phase:.2f} s")
    tree = jax_shaped_params(rng, m.num_vertices, width=(m.dim, m.depth, m.heads, m.mlp_dim),
                             n_tokens=m.num_patches + 1)
    base_state = state_dict_from_jax(tree, m.depth)
    phase_base_slice(rng, fb, fused, exp, t3.indices, base_state)
    del tree

    # -- 12. base-train (every count zeroed just before each run)
    start("base-train")
    launches = phase_base_train(fb, exp, t3.indices)
    for name in ("flash_attention", "flash_attention_bwd"):
        kernels[name]["launches"] = launches[name]

    # -- 13. base-entry
    start("base-entry")
    phase_base_entry()

    # -- 14. qkv-kernels
    start("qkv-kernels")
    kernels.update(phase_qkv(rng))

    # -- 15. dropout-kernels
    start("dropout-kernels")
    kernels.update(phase_dropout(rng))

    # -- 16. tiled (its slice zeroes the counts just before it)
    start("tiled")
    kernels.update(phase_tiled(rng, fb))

    # -- 17. mpp-slice (every count zeroed just before each run)
    start("mpp-slice")
    for name, n in phase_mpp(rng, fb, table).items():
        kernels[name]["launches"] = n

    # -- 18. dropout-train
    start("dropout-train")
    launches = phase_dropout_train(fb, table, fused_step_s)
    for name in ("flash_attention_qkv_dropout", "flash_attention_qkv_dropout_bwd"):
        kernels[name]["launches"] = launches[name]

    # -- 19. pretrain-entry
    start("pretrain-entry")
    phase_pretrain_entry()

    # -- 20. int8-kernels
    start("int8-kernels")
    kernels["fused_block_int8"] = phase_int8_kernels(rng, fb)

    # -- 21. patch-embed
    start("patch-embed")
    kernels["patch_embed"] = phase_patch_embed(rng, embed_launches)

    # -- 22. int8-slice (every count zeroed just before it)
    start("int8-slice")
    kernels["fused_block_int8"]["launches"] = phase_int8_slice(
        rng, fb, fused, exp, t3.indices, base_state, sit(torch.bfloat16))
    del base_state

    # -- 23. int8-entry
    start("int8-entry")
    phase_int8_entry(fb, *tiny_entry)

    # -- 24. fp32-entry
    start("fp32-entry")
    phase_fp32_entry(fb, *tiny_entry)
    phase("records", "the attention backward rows, this run's ms beside the two-pass "
          "mma.sync backward's recorded ms (PERF.md section 6, NVIDIA H100 80GB HBM3 at "
          "700 W; a record, not measured in this run): " + ", ".join(
              f"{k_} {kernels[k_]['ms']:.4f} (two-pass {v_})"
              for k_, v_ in TWO_PASS_MS.items()))
    def fwd_record(name):
        ms, sdpa, bound = FWD_RECORDS[name]
        return f"{ms:.4f}, {ms / sdpa:.3f}x SDPA, {bound / ms:.1%} of the bound"

    phase("records", "the attention forward rows, this run's ms, ratio to SDPA in this call "
          "and share of the bound, beside the mma.sync forward's recorded ms (PERF.md section "
          "6, NVIDIA H100 80GB HBM3 at 700 W; a record, not measured in this run): "
          + "; ".join(f"{k_} {fwd_record(k_)} (mma.sync {v_})"
                      for k_, v_ in MMA_SYNC_FWD_MS.items()))
    print(f"seconds per phase: {phase_seconds(time.perf_counter())}", flush=True)

    print(json.dumps({"kernels": [kernels[k] for k in sorted(kernels)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
