#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths
(surface_vision_transformers_tpu_torch) at the full width of SiT-tiny
(ico-6 sub-ico-2, dim 192, depth 12, 3 heads, mlp 768) and of SiT-base
(ico-6 sub-ico-3, below), its MPP pretraining and dropout training
(phases 14-19), MS-SiT serving (phases 26-28), and MS-SiT training and
MPP (phases 29-32), with random weights made from a numpy seed.
Phases, one line each; any failure raises, so the script exits non-zero
and prints no result:

1. device  -- a CUDA device is required; prints the card and power limit.
2. build   -- compiles the kernels in csrc/ (nvcc, sm_90a) and loads them.
3. kernels -- each block kernel against a float32 plain run on the same bf16
              inputs and weights, at the full block shape, plus controls
              (a wrong mask, a wrong softmax scale; for the CLS block also
              Q made from the top rows of x itself, not of LN1(x), and the
              last 64-key tile dropped) that the same gate must reject;
              the CLS forward's route from the C entry against the Python
              rules; CUDA-event times of each kernel and of the eager bf16
              block the plain path runs; the 8-query attention forward
              (the few-query kernel, Q given) at the CLS block's shape
              against its plain version, beside SDPA (its kernels row).
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
              term dropped; for the CLS block also the top rows' dq W_q
              share left out of dh, one key tile's dK and dV skipped, delta
              taken as 0) the same gate must reject; the CLS backward's dh
              and workspace floats from the C entries against the Python
              rules (its device kernels a call: phase 29), at SiT-tiny its
              bitwise repeat (a one-element control) and its run beside a
              kernel holding all SMs but one, and the same gates and CLS
              controls at N = 12 and N = 8 (under 16 rows a sample LN1
              leaves dkv W_kv's epilogue); CUDA-event times beside the
              eager bf16 block's autograd backward.
7. train   -- ten SGD-momentum steps of ``Trainer`` (``fused_train_forward``
              on the kernels) at full depth, B=256 raw surfaces with a
              planted label, against the eager bf16 ``SiT`` under autograd
              from the same float32 masters and batches: per-step losses and
              every parameter's update must agree, the loss must fall, the
              kernels launch 11 + 1 times per step each way (the CLS
              backward's few-query attention once), and a control
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
              8 queries against 321 keys at B=256, 3 heads (SiT-tiny's CLS
              block; the few-query backward's workspace, none, its time
              beside SDPA's backward and the bound); then at the
              training path's B=128, N=1281 with q/k/v read
              through the packed qkv's strides; controls (softmax scale
              x1.1, key mask ignored, the last K/V tile skipped, delta taken
              as 0 at 8 queries); the forward
              alone at the edges of its tiling (one row short of and past a
              query tile, valid_len inside and on the edge of a key tile,
              the packed strides), a control beside each; CUDA-event times
              at B=128 beside the plain version and SDPA, and the forward at
              SiT-base's serving batch (B=64) beside SDPA.
10. base-kernels -- fused_block, fused_block_cls, fused_block_cls_bwd and the
              recompute route's 12 gradients at SiT-base width, N=1281 and
              the config's bs 128, against the float32 and bf16 plain
              versions (run 16 samples at a time), with phase 3's and 6's
              controls (the CLS block's three too, and its route); times at
              B=32 beside the eager bf16 block.
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
              int8 GEMM on the engine (Q_S32: int32 accumulators) bitwise
              against their plain versions at SiT-base shapes (M = 64 x
              1281, K 768 and 3072) and at K 192 (82,176 and 1,000 rows);
              qkv, out-projection and fc2 with their dequantizing epilogues
              bitwise against the plain dequantized product (bias,
              residuals, roundings); a scan over every float of what fc1's
              epilogues assume
              (gelu_erf non-decreasing above 0 and bounded below it, codes
              by reciprocal equal to codes by division); fc1 and f's
              quantization (two passes, no fp32 f) bitwise against
              ``quant_rows`` of the plain f at SiT-base and SiT-tiny widths;
              ``fused_block_int8`` against the float32 and bf16 plain int8
              block at dim 768 / N 1281 / B 64, dim 384 / N 321 / B 256,
              N 328 / valid_len 321 and N 64, with controls (one scale per
              tensor, valid_len ignored, x1 rounded to bf16); times beside
              ``fused_block``, ``torch._int_mm`` per GEMM and the bounds,
              and int8 against bf16 block times at dim 192, 384 and 768.
21. patch-embed -- ``patch_embed`` against the float32 and bf16 plain
              versions at sub-ico 2 (B 256, dim 192 and 384), sub-ico 3
              (B 64, dim 768) and sub-ico 5 (B 64, dim 96), fp32 and bf16
              x, and a ragged case (sub-ico 2's first 300 patches, B 3:
              items past L), with controls (the table shifted by one
              patch, (c v) order); two calls bitwise equal; the kernel's
              shared memory from the C entry against ``embed_plan``; times
              beside the plain version and index_select + matmul, fp32
              and bf16 x.
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
25. block-gemms -- the block chains' GEMMs alone (``csrc/gemm.cuh``, one
              engine behind every product of ``fused_block`` and
              ``fused_block_bwd``): the forward's four at SiT-tiny B=256
              (M = 82,176) and SiT-base B=32 (M = 40,992, not a multiple of
              128), the backward's eight (four dX with their epilogues, four
              split-K weight gradients) at SiT-tiny B=256, each against the
              fp32 plain product with its epilogue (bf16 outputs within one
              bf16 step at the largest output, fp32 outputs within 2e-4 of
              it), a control with the last 64-deep k-step dropped that the
              gate must reject, times beside ``torch.mm(out_dtype=float32)``
              (timed, never used) and the bound; ``fused_block_bwd`` bitwise
              equal across two calls at SiT-tiny B=256 (controls: one
              cotangent element raised by 1; the plain dW_fc2's split
              partials summed in reverse order move fp32 bits);
              ``fused_block`` and ``fused_block_bwd`` timed at the MPP
              config's bs 32.

Phases 26-28 run MS-SiT serving (``configs/training/mssit_scan_age.yml``:
ico 6 patched at sub-ico 5, 20,480 patches x 6 vertices, stage dims 96 /
192 / 384 / 768 with heads 3 / 6 / 12 / 24, so head dim 32 throughout;
window 64, global_max 512, axial cross-mixing, mean pooling) at bs_val 64,
full width and depth:

26. mssit-kernels -- at the folded shapes a batch of 64 gives the kernels
              (models/mssit.py's stage_plan and fold_tokens: (20,480, 64,
              96), (4,096, 320, 96), (5,120, 64, 192), (4,096, 80, 192),
              (1,280, 64, 384), (4,096, 20, 384), (64, 320, 768)): the
              attention forward at dh 32 alone (also past 512 keys and with
              a key mask), ``fused_block`` at each fold and
              ``fused_block_int8`` at stages 2-3 against their float32 and
              bf16 plain versions (phase 3's and phase 20's gates),
              ``patch_embed`` at sub-ico 5 (K = 24, dim 96), and stage 0's
              four GEMMs alone (N 288 and 96, K 96: ragged against the
              engine's tiles) under phase 25's gate; controls (the dh-64
              scale 1/8 at dh 32, the last K/V tile skipped at N = 320, the
              last half k-step dropped at K = 96, and phase 20's and 21's);
              times beside the bound and the chain floor (now and with the
              seven launches), SDPA at dh 32 for the attention; then the
              fused chain's two kernels alone at stage 0's and 1's rows
              (``block_mlp``, ``block_ln_gemm``: one bf16 step from their
              plain versions; controls: the residual left out, GELU skipped
              on one chunk, LN2's gamma ignored, LN1's gamma or beta
              ignored), the C route against ``fuses_mlp``, and the resident
              attention forward at its packing edges (N = 20 / 80 / 100
              with valid_len 15 / 70 / 90; control: the block-diagonal mask
              ignored) beside SDPA with the key mask.
27. mssit-slice -- ``predict`` on 100 raw surfaces at batch 64 (the last
              padded), bf16 and int8: launches (1 patch_embed and 12
              fused_block a batch, of which stages 0-1's 4 run LN1 + qkv and
              the fused MLP; int8 1, 4 and 8 fused_block_int8),
              against the eager bf16 model (plain attention, batches of 8)
              and, int8, the float32 one, with controls (block 5 dropped,
              stage 0's axial fold run as the window fold); surfaces/s and
              peak memory at B=64 and 128.
28. mssit-entry -- ``cli.test`` on the shipped MS-SiT config in a
              subprocess (a synthetic npy split, a params npz written from
              the port's weights), bf16 and ``--set tpu.quant=int8``:
              results.csv equal to ``predict`` bit for bit; ``--set
              tpu.compute_dtype=float32``: the modular model, no launches,
              equal to float32 ``predict``.

Phases 29-32 run MS-SiT training and masked-window pretraining (MPP) at the
same width and depth, every block at dh 32:

29. mssit-train-kernels -- the route ``uses_recompute`` gives each fold (the
              chain at every one); at the folds of a batch of 64 (and at
              valid_len inside a key block) the attention backward at dh 32
              through ``flash_attention_qkv``'s packed strides, and
              ``fused_block_bwd`` after the training forward, against their
              float32 and bf16 plain versions (phase 14's and phase 6's
              gates) with controls (the dh-64 scale 1/8, the last key block
              skipped, the key mask ignored; the softmax scale x1.1 and the
              LayerNorm backward's mean term dropped); bitwise repeats of
              both, with an order control for the attention; times beside
              the bound, SDPA's backward, the eager block's autograd
              backward and the chain's floor; then, in a process of its own
              (``scripts/bwd_chain_parts.py``: the profiler of a long run
              drops launches), each part of the block backward alone at the
              folds and SiT-tiny, and of the CLS block's at SiT-tiny,
              SiT-small width and SiT-base, whose device kernels a call are
              held to its route (one few-query attention launch, LN1 in the
              epilogue up to dim 192), as are the 8-query attention
              backward's alone (one launch) and the CLS forward's, serving
              and training (``cls_fwd_kernels``: one few-query forward, LN1
              in the K/V product and Q made in the attention at dims 96 /
              192, ``cls_fwd_launches`` kernels a call).
30. mssit-train -- ``mssit_scan_age.yml``: four SGD steps of ``Trainer``
              (``fused_mssit_train_forward``) at a batch of 8 against the
              eager bf16 MSSiT under autograd (losses 1e-3, every update
              5%, or where eager bf16 is itself farther from the eager
              float32 update, within 1.25x its distance; a control: one
              block's dW_fc1 zeroed), 12 fused_block +
              12 fused_block_bwd + 1 patch_embed a step; then ten steps at
              the config's bs 64 with its AdamW: training surfaces/s (steps
              2..10, CUDA events beside), peak memory, where a step goes,
              a torch.profiler step.
31. mssit-pretrain -- ``mssit_mpp.yml`` the same way (MPP gate 5e-3, bs 32,
              ``fused_mssit_mpp_loss``; no patch_embed: the corrupted tokens
              are embedded by a plain product).
32. mssit-train-entry -- ``cli.train`` / ``cli.pretrain`` on the two
              configs (two epochs, 64 + 64 synthetic surfaces) and ``cli.train
              --set tpu.fused_train=False`` (the modular bf16 model on
              ``flash_attention_qkv``, forward and backward; batch 16), each
              in a subprocess, equal to ``run_training`` in this process,
              whose launches show the route.

Phases 9 and 14-16 also check that the attention backward repeats bit for
bit: two calls on the same inputs give identical dq, dk and dv, and the
same comparison tells a call with one dO element raised by 1 apart; and
that summing the plain version's per-key-block dQ shares in the reverse
order changes dq's bf16 bits at that shape, so a dQ sum taken out of order
would not repeat either. Phase 9 then runs the backward while a kernel on
another stream holds all multiprocessors but one: it must finish, equal
to its run on the idle card, before that kernel ends; so does the
few-query backward at SiT-tiny's and SiT-base's CLS shapes.

The eager baselines of phases 3-12 run plain attention (``attn_backend=
"plain"``), as their gates were set on it.

Each phase prints its seconds. Then six records lines: the attention
backward and forward rows, the block rows and the int8 rows beside their
recorded times under the mma.sync kernels they replaced (a record, not
measured in the run), the forward rows with their ratio to SDPA in this run
and their share of the bound, the int8 GEMMs beside ``torch._int_mm``; and
the MS-SiT serving and training paths' kernels at dh 32 with their library
or eager times and bounds.
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
CLS_SMALL_N = (12, 8)  # the CLS backward below 16 rows a sample: LN1 standalone
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
# package's padded N with its mask, the CLS block's 8 query rows (the
# few-query backward) at SiT-base and at SiT-tiny's training batch, and
# last the training path's own call (bs 128, q/k/v read through the packed
# qkv's strides), on whose tensors the times are taken.
FLASH_MAIN = (128, 12, 1281, 1281, 1281)
FEW_TINY = (256, 3, 8, 321, 321)  # the SiT-tiny CLS block's attention: its timed row
FLASH_CASES = [(16, 12, 1281, 1281, 1281), (16, 12, 1288, 1288, 1281),
               (16, 12, 8, 1281, 1281), FEW_TINY, FLASH_MAIN]
# the few-query backward beside a kernel holding all SMs but one: SiT-tiny's
# and SiT-base's CLS blocks (B, H, Nq, Nk)
FEW_BUSY_SHAPES = [(256, 3, 8, 321), (32, 12, 8, 1281)]
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


def device_ms(fn, reps: int = 10, tries: int = 4) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around ``reps``
    calls queued on the stream behind a kernel that holds it (``HOLD_SRC``,
    one CTA) until they are all enqueued, so the device runs them back to
    back and never waits for the host's next launch; after two warm-up
    calls. Not torch.profiler's sum of kernel times: late in this script's
    run that read short kernels up to five times below their device time,
    some below their bound. A run whose calls were not all queued before the
    hold ended (the host stalled: the card's host shares its cores) is not
    a measurement: it is run again behind a hold four times as long, up to
    ``tries`` runs, and fails after that. The hold's length does not enter
    the time, which starts when the hold ends."""
    import ctypes
    import gc

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_ns = int((2 * enqueue_s + 0.005) * 1e9)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    queued = []
    for _ in range(tries):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        gc.collect()
        gc.disable()
        try:
            err = hold_lib().hold_sms(1, 0, hold_ns, stream)
            t0 = time.perf_counter()
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            queued_s = time.perf_counter() - t0
        finally:
            gc.enable()
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"device_ms: the holding kernel did not launch (CUDA error {err})")
        if queued_s * 1e9 < hold_ns:
            return a.elapsed_time(b) / reps
        queued.append(f"{queued_s * 1e3:.2f} ms queueing behind a {hold_ns / 1e6:.2f} ms hold")
        hold_ns = 4 * max(hold_ns, int(queued_s * 1e9))
    raise AssertionError("device_ms: the calls were not all queued before the hold ended, in "
                         f"each of {tries} runs ({'; '.join(queued)})")


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


def cls_raw_q_reference(fb, x, p, heads=HEADS, valid_len=None):
    """The CLS block in float32 with Q made from the top rows of x itself,
    not of LN1(x) (a control of the few-query forward's own Q)."""
    rows, hd = min(8, x.shape[1]), heads * DH
    vl = x.shape[1] if valid_len is None else valid_len
    kv = fb._mm(fb._layer_norm(x, p[0], p[1], 1e-5), p[2][hd:])
    attn = fb._attention(fb._mm(x[:, :rows], p[2][:hd]), kv[..., :hd], kv[..., hd:], heads,
                         DH, vl, x.dtype)
    return fb._out_proj_mlp(x[:, :rows], attn, *p[3:], 1e-5, x.dtype)


def cls_fwd_controls(fb, dist, x, p, heads, vl) -> dict:
    """Controls of the CLS forward: Q from un-normalised top rows; the last
    64-key tile dropped (valid_len cut by 64 in the float32 plain run)."""
    kw = dict(heads=heads, dim_head=DH)
    return {"Q from un-normalised top rows": dist(
                lambda xs: cls_raw_q_reference(fb, xs.float(), p, heads, vl)),
            f"keys {vl - 64}..{vl - 1} dropped": dist(
                lambda xs: fb.fused_block_cls_reference(xs.float(), *p, valid_len=vl - 64, **kw))}


def cls_fwd_route_line(fb, label, N, dim) -> str:
    """The CLS forward's route from the C entry (``svt_cls_fwd_route``)
    against the Python rules (``cls_fwd_route``, ``cls_ln1_in_kv``)."""
    from surface_vision_transformers_tpu_torch.ops import _native

    rows = min(8, N)
    got = _native.library().svt_cls_fwd_route(N, rows, dim)
    want = (1 if fb.cls_fwd_route(N, rows) else 0) | (2 if fb.cls_ln1_in_kv(N, rows, dim) else 0)
    if got != want:
        raise AssertionError(f"{label}: svt_cls_fwd_route {got}, the Python rules {want}")
    return (f"{label}: the CLS forward's route {got} from the C entry (1: the few-query "
            f"attention, 2: LN1 in the K/V product and Q made in the attention), {want} by "
            "the rules; "
            f"{fb.cls_fwd_launches(N, dim)} device kernels a call by cls_fwd_launches "
            "(counted in phase 29)")


FEW_FWD = "flash_attention 8 queries"  # the few-query forward's counter and kernels row


def few_fwd_row(fa) -> dict:
    """The kernels line's row of the 8-query attention forward
    (``few_query_fwd``, Q given) at the SiT-tiny CLS block's shape (B = 256,
    3 heads, 8 queries, 321 keys), inputs from a generator of its own:
    against the float32 plain version (its gate), device time beside the
    plain version, SDPA and the bound."""
    B, H, nq, nk, _ = FEW_TINY
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q, k, v = (dev_randn(g, (B, H, n, DH), s) for n, s in ((nq, 1.5), (nk, 1.5), (nk, 1.0)))
    o, lse = fa.flash_attention_fwd(q, k, v)
    o32, lse32 = fa.flash_attention_reference(q.float(), k.float(), v.float())
    obf, _ = fa.flash_attention_reference(q, k, v)
    err = (o.float() - o32).abs().max().item()
    bound = BOUND_STEPS * bf16_step(o32.abs().max().item())
    ctl = (o.float() - fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                                    nk - 64)[0]).abs().max().item()
    kernels = device_kernels(lambda: fa.flash_attention_fwd(q, k, v))
    ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v))
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), reps=5)
    library = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    b_ms, b_by = attention_bound(B, H, nq, nk, (q, k, v, o, lse), (q,))[0]
    phase("kernels", f"flash_attention forward B={B} H={H} Nq={nq} Nk={nk} (the few-query "
          f"kernel, {len(kernels)} device kernel a call: "
          f"{[n.split('namespace)::')[-1].split('(')[0] for n in kernels]}): max abs err vs "
          f"fp32 plain {err:.6g}, vs plain bf16 {(o.float() - obf.float()).abs().max().item():.6g}, "
          f"lse {(lse - lse32).abs().max().item():.3g}, bound {bound:.6g}; control (the last "
          f"64 keys dropped) {ctl:.6g}; device time {ms:.4f} ms, SDPA {library:.4f} ms "
          f"({ms / library:.3f}x), plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
          f"({b_ms / ms:.1%} of it)")
    if max(err, (o.float() - obf.float()).abs().max().item()) > bound or ctl <= bound:
        raise AssertionError("the few-query attention forward disagrees with its plain version")
    if len(kernels) != 1 or "flash_fwd_few_kernel" not in kernels[0]:
        raise AssertionError(f"the 8-query attention forward is not one few-query launch: "
                             f"{kernels}")
    return {"name": FEW_FWD, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": f"{FLASH_TPU}:203", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library}


def cls_fwd_kernels(kernels, N, dim) -> str:
    """One CLS forward's device kernels (``device_kernels``) against its
    route: on ``cls_fwd_route`` one attention launch, the few-query forward,
    no streamed forward; LN1 in the K/V product where ``cls_ln1_in_kv``
    (LN2's the only LayerNorm pass, no Q product); ``cls_fwd_launches``
    kernels in all. -> a summary; raises where they disagree."""
    from surface_vision_transformers_tpu_torch.ops import fused_block as fb

    rows = min(8, N)
    attn = [k for k in kernels if "flash_fwd" in k]
    few = sum("flash_fwd_few_kernel" in k for k in attn)
    ln = sum("layer_norm_kernel" in k for k in kernels)
    epis = [GEMM_EPIS[int(m[1])] for k in kernels
            if (m := re.search(r"gemm_kernel<[^>]*?(\d+)>", k))]
    msg = (f"{len(kernels)} device kernels a call (rule {fb.cls_fwd_launches(N, dim)}), "
           f"{len(attn)} attention launches ({few} of flash_fwd_few_kernel), "
           f"{epis.count('F_LNA')} LN1 + K/V products, {ln} LayerNorm passes")
    if len(kernels) != fb.cls_fwd_launches(N, dim):
        raise AssertionError(f"the CLS forward's kernels do not follow its route: {msg}")
    if fb.cls_fwd_route(N, rows) and (len(attn) != 1 or few != 1):
        raise AssertionError(f"the CLS forward's attention is not one few-query launch: {msg}")
    if fb.cls_ln1_in_kv(N, rows, dim) and (ln != 1 or epis.count("F_LNA") != 1):
        raise AssertionError(f"the CLS forward's LN1 is not in the K/V product: {msg}")
    return msg


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
                if name == "fused_block_cls":
                    controls.update(cls_fwd_controls(
                        fb, lambda fn: dist(got, fn(x)), x, mats32, HEADS, vl))
                    phase("kernels", cls_fwd_route_line(fb, f"{name} B={B} N={N}", N, DIM))
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
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa

    results[FEW_FWD] = few_fwd_row(fa)
    return results


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM rate, in ms."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def attention_flops(B, H, nq, nk, dh=DH):
    """(forward, backward) operations of attention over nq query rows and nk
    keys (those a run needs): the forward's two products (Q.K^T, P.V); the
    backward's five, 2.5x the forward's, since its inputs are q, k, v, o,
    lse and dO: S = Q.K^T again, dP, dV, dQ, dK. Every attention bound of
    this script counts them here."""
    fwd = 4 * B * H * nq * nk * dh
    return fwd, 2.5 * fwd


def block_flops(B, N, vl, dim, heads, mlp, cls, dh=DH):
    """(forward, backward) operations of one block at these shapes; the
    attention products count only the rows and keys < valid_len that this
    input needs. Forward: the four GEMMs and the attention's forward;
    backward: dX and dW of each GEMM and the attention's backward
    (``attention_flops``). What a design keeps or recomputes beyond that is
    its own cost, not part of the bound."""
    hd, M = heads * dh, B * N
    rows = min(8, N) if cls else N
    Mt = B * rows
    if cls:
        gemm = 2 * (M * dim * 2 * hd + Mt * dim * hd + Mt * hd * dim + 2 * Mt * dim * mlp)
    else:
        gemm = 2 * M * (dim * 3 * hd + hd * dim + 2 * dim * mlp)
    att_f, att_b = attention_flops(B, heads, min(rows, vl), min(N, vl), dh)
    return gemm + att_f, 2 * gemm + att_b


def chain_bytes(B, N, dim, heads, mlp, dh=DH, fused_ln=None,
                fused_mlp=None) -> tuple[int, int, int]:
    """HBM bytes the block chains move at these shapes (csrc/fused_block.cu,
    fused_block_bwd.cu: each launch reads its inputs and writes its outputs
    once, the weights aside): (serving forward, training forward with its
    saves, backward without the attention's fp32 dQ workspace). The chain
    design's own floor, beside the function's bound (block_flops). The
    backward's LayerNorms run in dh's products' epilogues where
    ``fused_ln`` (default: ``ln_in_epilogue(dim)``, this tree's rule), so
    its fp32 dh (written and read back twice, 8 bf16 widths of x) never
    moves; ``fused_ln=False`` counts the chain with standalone passes
    (the design before the LayerNorm epilogues). The forward runs four
    launches where ``fused_mlp`` (default: ``fuses_mlp(dim, mlp)``, this
    tree's rule, serving and training each): LN1 in the qkv product's
    prologue and the MLP half as one kernel, so h, h2 and f move only where
    the training form keeps them; ``fused_mlp=False`` counts the seven
    launches (the design before)."""
    M, hd, bf, f4 = B * N, heads * dh, 2, 4
    x, qkv, att, hid = M * dim * bf, M * 3 * hd * bf, M * hd * bf, M * mlp * bf
    from surface_vision_transformers_tpu_torch.ops.fused_block import fuses_mlp

    kept = 2 * hid + 2 * M * 2 * f4 + B * heads * N * f4  # fpre, stats, lse
    seven = ((x + x) + (x + qkv) + (qkv + att) + (att + x + x) + (x + x) + (x + hid)
             + (hid + x + x))  # LN1, qkv, attention, out-proj, LN2, fc1, fc2
    four = (x + qkv) + (qkv + att) + (att + x + x) + (x + x)  # LN1 + qkv, .., the MLP half
    fwd = four if (fuses_mlp(dim, mlp) if fused_mlp is None else fused_mlp) else seven
    fused_t = fuses_mlp(dim, mlp, train=True) if fused_mlp is None else fused_mlp
    train = (four + (x + x + hid) if fused_t else seven) + kept  # the four also write h1, h2, f
    bwd = ((x + hid) + (x + 2 * hid + hid) + (hid + x) + (hid + 2 * x)  # dW_fc2, df1, dW_fc1, dh
           + (2 * x + x + x + 2 * x + x) + (x + att) + (x + att)  # LN2 bwd, dW_out, da
           + (qkv + att + att + qkv) + (qkv + x) + (qkv + 2 * x)  # attention, dW_qkv, dh
           + (2 * x + x + 2 * x + x))  # LN1 bwd -> dx
    if fused_ln is None:
        from surface_vision_transformers_tpu_torch.ops.fused_block import ln_in_epilogue

        fused_ln = ln_in_epilogue(dim)
    if fused_ln:
        bwd -= 8 * x  # dh's fp32 write and read, at LN2 and at LN1
    return fwd, train, bwd


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


def block_params(rng, dim, heads, mlp, dh=DH):
    """The 11 block parameters (torch layout, float32) with the attention
    gains of the phase-3 weights."""
    hd = heads * dh

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


def bwd_control(fb, x, g, pr, heads, vl, cls, got, vl_bwd, chunk=None, dh=DH, **patches):
    """|got| against the float32 plain backward with ``patches`` applied to
    the plain functions (and keys up to ``vl_bwd`` in the backward), as the
    worst ratio to the gate (``grad_bound_ratio``); the plain backward runs
    ``chunk`` samples at a time (default: the whole batch)."""
    kw = dict(heads=heads, dim_head=dh)
    fwd = fb.fused_block_cls_reference if cls else fb.fused_block_reference

    def plain(xs, gs):
        sv32 = {}
        fwd(xs.float(), *pr, valid_len=vl, saved=sv32, **kw)
        bwd = fb._block_cls_bwd_plain if cls else fb._block_bwd_plain
        return bwd(xs.float(), gs.float(), pr, sv32, heads, dh, vl_bwd)

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


def cls_bwd_controls(fb, control, vl, heads) -> dict:
    """The CLS backward gate's controls on what this chain does its own way:
    the top rows' dq W_q share left out of dh (LN1's epilogue), the last 64
    valid keys' dK and dV skipped (one key tile of the few-query attention;
    the ragged last tile holds 1 key at N = 321 or 1281, too few for the
    block's gate to see), delta = rowsum(dO . O) taken as 0."""
    attn_bwd, plain_cls = fb._attention_bwd, fb._block_cls_bwd_plain
    first = max(vl - 64, 0)

    def no_dq_share(x, g, params, sv, *a):
        p = list(params)
        p[2] = params[2].clone()
        p[2][:heads * DH] = 0.0  # W_q, read by the backward only for dq W_q
        return plain_cls(x, g, p, sv, *a)

    def tile_skipped(*a):
        dq, dk, dv = (t.clone() for t in attn_bwd(*a))
        dk[:, first:vl] = 0.0
        dv[:, first:vl] = 0.0
        return dq, dk, dv

    return {
        "dq W_q share left out of dh": control(_block_cls_bwd_plain=no_dq_share),
        f"dK, dV of keys {first}..{vl - 1} skipped": control(_attention_bwd=tile_skipped),
        "delta taken as 0": control(_attention_bwd=lambda q, k, v, o, *a: attn_bwd(
            q, k, v, torch.zeros_like(o), *a)),
    }


def cls_route(name, fb, label, B, N, dim, heads, mlp) -> str:
    """The CLS backward's dh scratch and workspace floats from the C entries
    against the Python rules (no dh where ``cls_ln1_in_epilogue``: up to dim
    192 at N >= 16); its device kernels a call are counted in phase 29
    (``cls_kernels``, in a process of its own). -> a line for the phase."""
    from surface_vision_transformers_tpu_torch.ops import _native

    lib, rows = _native.library(), min(8, N)
    fused = fb.cls_ln1_in_epilogue(N, rows, dim)
    dhf = (lib.svt_block_bwd_dh_floats(B, N, dim, rows), fb.block_bwd_dh_floats(B, N, dim, rows))
    ws = (lib.svt_block_bwd_workspace(B, N, rows, dim, heads, DH, mlp),
          fb.block_bwd_workspace(B, N, rows, dim, heads, DH, mlp))
    msg = (f"{label}: LN1 in dkv W_kv's epilogue {fused}; dh scratch {dhf[0]} floats from the "
           f"C entry, {dhf[1]} by the rule (0 where LN1 is in the epilogue, else B N dim); "
           f"workspace {ws[0]}, rule {ws[1]} (each pair equal)")
    if (dhf[0] == 0) is not fused:
        raise AssertionError(f"{name}: the CLS backward's dh scratch does not follow its route")
    if dhf[0] != dhf[1] or ws[0] != ws[1]:
        raise AssertionError(f"{name}: a C entry disagrees with its rule\n{msg}")
    return msg


def cls_kernels(kernels, N, dim) -> str:
    """One ``fused_block_cls_bwd`` call's device kernels (``device_kernels``)
    against its route: one attention launch, the few-query kernel; where
    ``cls_ln1_in_epilogue`` LN1 in dkv W_kv's epilogue (one B_LN1_TOP
    product) and no standalone LayerNorm pass. -> a summary; raises where
    they disagree."""
    from surface_vision_transformers_tpu_torch.ops.fused_block import cls_ln1_in_epilogue

    attn = [k for k in kernels if "flash_bwd" in k]
    few = sum("flash_bwd_few_kernel" in k for k in attn)
    epis = [GEMM_EPIS[int(m[1])] for k in kernels
            if (m := re.search(r"gemm_kernel<[^>]*?(\d+)>", k))]
    ln_pass = sum("ln_bwd_kernel" in k for k in kernels)
    msg = (f"{len(kernels)} device kernels a call, {len(attn)} attention launches ({few} of "
           f"flash_bwd_few_kernel), {epis.count('B_LN1_TOP')} LN1 epilogue products, {ln_pass} "
           f"standalone LayerNorm passes")
    if len(attn) != 1 or few != 1:
        raise AssertionError(f"the CLS backward's attention is not one few-query launch: {msg}")
    if cls_ln1_in_epilogue(N, 8, dim) and (ln_pass or epis.count("B_LN1_TOP") != 1):
        raise AssertionError(f"the CLS backward's LN1 is not in dkv W_kv's epilogue: {msg}")
    return msg


def cls_small_n(rng, fb, pb, pr, dim, heads, mlp) -> None:
    """The CLS backward where a sample has under 16 rows (N = 12 and N = 8,
    its 8 top rows; ``CLS_SMALL_N``): two rows 8 apart can then both be top
    rows, so LN1 leaves dkv W_kv's epilogue for the standalone pass
    (``cls_ln1_in_epilogue``), and at N = 8 the attention is not the
    few-query kernel's. Held against the float32 and bf16 plain backwards
    with the CLS controls."""
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa

    kw = dict(heads=heads, dim_head=DH)
    for N in CLS_SMALL_N:
        B, rows = 256, min(8, N)
        x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N, dim)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        g = torch.from_numpy((G_SCALE * rng.standard_normal((B, rows, dim))).astype(
            np.float32)).to("cuda", torch.bfloat16)
        _, sv = fb.train_forward(x, *pb, valid_len=N, cls=True, **kw)
        got = fb.fused_block_cls_bwd(x, g, *pb, saved=sv, valid_len=N, **kw)
        ref32 = fb.fused_block_cls_bwd_reference(x.float(), g.float(), *pr, valid_len=N, **kw)
        ref_bf = fb.fused_block_cls_bwd_reference(x, g, *pb, valid_len=N, **kw)
        r32, err = grad_bound_ratio(got, ref32, N)
        rbf, _ = grad_bound_ratio(got, ref_bf, N)
        rplain, _ = grad_bound_ratio(ref_bf, ref32, N)

        def control(vl_bwd=N, **patches):
            return bwd_control(fb, x, g, pr, heads, N, True, got, vl_bwd, **patches)

        controls = cls_bwd_controls(fb, control, N, heads)
        label = f"fused_block_cls_bwd SiT-tiny B={B} N={N}"
        phase("train-kernels", cls_route("train-kernels", fb, label, B, N, dim, heads, mlp))
        phase("train-kernels", f"{label} (few-query attention "
              f"{fa.few_query_bwd(rows, N, DH)}): worst |err|/bound over the 12 gradients vs "
              f"fp32 plain {r32:.4g} (plain bf16 {rplain:.4g}), vs plain bf16 {rbf:.4g}; max "
              f"abs err {err:.6g}; controls (must exceed 1): "
              + ", ".join(f"{k} {v:.4g}" for k, v in controls.items()))
        if not all(bool(torch.isfinite(t).all()) for t in got) or max(r32, rbf) > 1:
            raise AssertionError(f"{label} disagrees with its plain backward")
        if min(controls.values()) <= 1:
            raise AssertionError(f"{label}: a control passed the gate")
        del x, g, sv, got, ref32, ref_bf


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
                if cls:
                    controls.update(cls_bwd_controls(fb, control, vl, heads))
                    phase("train-kernels", cls_route(
                        "train-kernels", fb, f"{name} {width} B={B} N={N}", B, N, dim, heads,
                        mlp))
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
                if cls and N == N_TOKENS and width == "SiT-tiny":
                    # the CLS chain (its GEMMs' persistent grids, the few-query
                    # attention, the fixed-order sums) repeats bit for bit and
                    # needs no two of its CTAs on the card together
                    def call(gg=g):
                        return kernel(x, gg, *pb, saved=sv, valid_len=vl, **kw)
                    again, moved = call(), call(bump(g))
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    control = all(torch.equal(a, b) for a, b in zip(got, moved))
                    phase("train-kernels", f"{name} {width} B={B} N={N}: two calls bitwise "
                          f"identical {same} (must be True), control: one g element raised by "
                          f"1, identical {control} (must be False)")
                    if not same or control:
                        raise AssertionError(f"{name}: the backward does not repeat bit for bit")
                    busy_run("train-kernels", f"{name} {width} B={B} N={N}", call)
                    del again, moved
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
        if width == "SiT-tiny":
            cls_small_n(rng, fb, pb, pr, dim, heads, mlp)
    return results


def eager_backward_ms(sit_module, p32, x, g, heads, dim, mlp, cls, dh=DH, reps=25) -> float:
    """CUDA-event time of the eager bf16 SiT block's autograd backward (the
    whole block; its top rows under CLS), from float32 masters."""
    m = sit_module.SiT(dim=dim, depth=1, heads=heads, mlp_dim=mlp, dim_head=dh,
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
    return cuda_ms(lambda: torch.autograd.grad(out, [xr, *params], g, retain_graph=True),
                   reps=reps)


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
    want["flash_attention_bwd 8 queries"] = TRAIN_STEPS  # one in each CLS backward
    want[FEW_FWD] = TRAIN_STEPS  # one in each CLS forward
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


def gemm_epis(root: Path) -> tuple:
    """The epilogues of the checkout at ``root`` in their enum order (its
    ``csrc/gemm.cuh``): how its gemm_kernel instantiations number them."""
    src = (root / "surface_vision_transformers_tpu_torch/csrc/gemm.cuh").read_text()
    body = re.search(r"enum Epi \{([^}]*)\}", src)[1]
    return tuple(n.strip() for n in body.split(",") if n.strip())


GEMM_EPIS = gemm_epis(ROOT)  # this tree's


def ptxas_report(log_path: Path) -> str:
    """Registers per kernel and any spills, from the build's ``-Xptxas=-v``
    report."""
    regs, spills, name = {}, [], None
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            fwd = re.search(r"flash_fwd_kernelILi(\d)ELi(\d+)ELb(\d)E", mangled)
            gemm = re.search(r"gemm_kernelI(13__nv_bfloat16|a)Li(\d)ELi(\d)ELi(\d+)E", mangled)
            res = re.search(r"flash_bwd_resident_kernelILi(\d)E", mangled)
            mlp = re.search(r"fused_mlp_kernelILi(\d+)ELb(\d)E", mangled)
            name = (f"flash_fwd<{','.join(fwd.groups())}>" if fwd else
                    f"flash_bwd_resident<{res[1]}>" if res else
                    f"fused_mlp<{mlp[1]},{'train' if mlp[2] == '1' else 'serve'}>" if mlp else
                    "flash_fwd_resident" if "flash_fwd_resident" in mangled else
                    f"gemm<{'int8' if gemm[1] == 'a' else 'bf16'},{gemm[2]},{gemm[3]},"
                    f"{GEMM_EPIS[int(gemm[4])]}>" if gemm else next((
                        k for k in ("flash_bwd_delta", "flash_bwd_dq", "flash_bwd_kernel",
                                    "flash_bwd_few",
                                    "ln_bwd", "layer_norm", "reduce", "ln_quant",
                                    "quant_rows", "gelu_scan", "div_scan", "patch_embed")
                        if k in mangled), mangled[:40]))
        elif name and re.search(r"Used \d+ registers", line):
            used = int(re.search(r"Used (\d+) registers", line)[1])
            regs[name] = max(regs.get(name, 0), used)
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
            # the few-query kernel, counted where it is launched (alone and
            # in the CLS block's backward chain)
            "flash_attention_bwd 8 queries": fa.few_query_bwd,
            # the few-query forward, likewise (alone and in the CLS forward chain)
            FEW_FWD: fa.few_query_fwd,
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


def device_kernels(call, sessions: int = 3) -> list:
    """Names of the device kernels one call of ``call`` launches, in order
    (torch.profiler, after a warm-up call): the longest list of ``sessions``
    calls, one a session (a session may drop a launch, never add one)."""
    from torch.autograd import DeviceType

    call()
    torch.cuda.synchronize()
    seen = []
    for _ in range(sessions):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        seen.append([e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)])
    return max(seen, key=len)


def few_route(name, fa, label, B, H, nq, nk) -> None:
    """The few-query backward's workspace from the C entry against the
    Python rule (``few_query_bwd``, ``bwd_workspace_floats``): none. Its
    launches a call are counted in phase 29 (in a process of its own)."""
    from surface_vision_transformers_tpu_torch.ops import _native

    ws = (_native.library().svt_flash_attention_bwd_workspace(B, H, nq, nk, DH),
          fa.bwd_workspace_floats(B, H, nq, nk, DH))
    phase(name, f"{label}: few-query route (few_query_bwd {fa.few_query_bwd(nq, nk, DH)}): "
          f"workspace {ws[0]} floats from the C entry, {ws[1]} by the rule (must be 0 and 0)")
    if ws != (0, 0):
        raise AssertionError(f"{name}: the few-query backward asks for a workspace")


def few_query_row(fa, q, k, v, o, lse, do, err) -> dict:
    """The kernels line's row of the few-query attention backward at these
    operands (the SiT-tiny CLS block's 8 query rows against 321 keys):
    device time beside the plain version, SDPA's backward and the bound."""
    B, H, nq, _ = q.shape
    nk = k.shape[2]
    ms = device_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))
    plain_ms = cuda_ms(lambda: [fa.flash_attention_bwd_reference(
        q[s:s + 16], k[s:s + 16], v[s:s + 16], o[s:s + 16], lse[s:s + 16], do[s:s + 16])
        for s in range(0, B, 16)], reps=3)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qr, kr, vr)
    library = device_ms(lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do, retain_graph=True))
    b_ms, b_by = attention_bound(B, H, nq, nk, (q, k, v, o, lse), (q, k, v, o, lse, do, q, k, v))[1]
    phase("flash-kernels", f"flash_attention_bwd B={B} H={H} Nq={nq} Nk={nk} (the few-query "
          f"kernel; device time, mean of 10 queued calls): kernel {ms:.4f} ms, SDPA backward "
          f"{library:.4f} ms ({ms / library:.3f}x), plain {plain_ms:.4f} ms (slices of 16, CUDA "
          f"events, median of 3); bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%} of it)")
    return {"name": "flash_attention_bwd 8 queries", "route": "cuda", "source": FLASH_SOURCE,
            "replaces": f"{FLASH_TPU}:233", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library}


def phase_flash(rng) -> dict:
    """Phase 9: flash_attention forward and backward against the float32
    and bf16 plain versions on the same bf16 inputs, with controls; then
    CUDA-event times at the training path's shape beside the plain version
    and SDPA."""
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa

    def t(shape, sc=1.0):
        return torch.from_numpy((sc * rng.standard_normal(shape)).astype(np.float32)).to(
            "cuda", torch.bfloat16)

    def outputs(q, k, v, do, vl, dtype=None, zero_delta=False):
        """(o, dq, dk, dv) of the plain versions, in ``dtype`` (float32: the
        exact reference; None: the inputs' bf16), 16 samples at a time (the
        plain versions hold float32 scores); ``zero_delta``: the backward
        with delta = rowsum(dO . O) taken as 0 (a control)."""
        parts = []
        for s in range(0, q.shape[0], 16):
            a = [x[s:s + 16].to(dtype) if dtype else x[s:s + 16] for x in (q, k, v, do)]
            o, lse = fa.flash_attention_reference(*a[:3], vl)
            ob = torch.zeros_like(o) if zero_delta else o
            parts.append([o, *fa.flash_attention_bwd_reference(*a[:3], ob, lse, a[3], vl)])
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
        few = fa.few_query_bwd(nq, nk, DH)
        if few:
            controls["delta taken as 0"] = ratio(
                got, outputs(q, k, v, do, vl, torch.float32, zero_delta=True), ref32)
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
        if few:
            few_route("flash-kernels", fa, f"B={B} H={H} Nq={nq} Nk={nk} valid_len={vl}", B, H,
                      nq, nk)
        if (B, H, nq, nk, vl) == FEW_TINY:
            few_row = few_query_row(fa, q, k, v, o, lse, do, max(errs[1:]))
        if main:
            abs_err = {"fwd": errs[0], "bwd": max(errs[1:])}
        del got, ref32
        torch.cuda.empty_cache()

    busy_card(fa)
    for shape in FEW_BUSY_SHAPES:
        busy_card(fa, shape)
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
    results = {"flash_attention_bwd 8 queries": few_row}
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


def busy_card(fa, shape=BUSY_SHAPE, dh=DH, name="flash-kernels") -> None:
    """The attention backward while a kernel on another stream holds every
    multiprocessor but one (``busy_run``): the streamed kernel's key blocks
    wait only for blocks of lower index, never for the whole (sample, head)
    to be on the card, and the resident and few-query kernels' CTAs wait for
    none, so it must finish on that one SM. ``shape``: (B, H, N), or (B, H,
    Nq, Nk). Its inputs come from a generator of its own, so the phases
    after it draw the data their gates were set on."""
    B, H, nq, N = shape if len(shape) == 4 else (*shape, shape[-1])
    rng = np.random.default_rng(SEED + 1)
    q, k, v = bf16_randn(rng, (B, H, nq, dh), 1.5), bf16_randn(rng, (B, H, N, dh), 1.5), \
        bf16_randn(rng, (B, H, N, dh))
    do = bf16_randn(rng, (B, H, nq, dh))
    o, lse = fa.flash_attention_fwd(q, k, v)
    busy_run(name, f"B={B} H={H} Nq={nq} Nk={N} dh={dh} backward",
             lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))


def busy_run(name, label, call) -> None:
    """``call`` (a backward) while a kernel on another stream holds every
    multiprocessor but one: it must finish on that one SM, equal bit for bit
    to its run on the idle card, before the other kernel ends."""
    import ctypes

    idle = call()
    idle_ms = cuda_ms(call)
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
    busy = call()
    ev[3].record()
    torch.cuda.synchronize()
    hold_ms, done_ms, bwd_ms = (ev[0].elapsed_time(ev[1]), ev[0].elapsed_time(ev[3]),
                                ev[2].elapsed_time(ev[3]))
    same = all(torch.equal(a, b) for a, b in zip(idle, busy))
    phase(name, f"busy card: {label} while {sms - 1} of {sms} SMs are held for {HOLD_MS} ms "
          f"by a kernel on another stream: done {done_ms:.2f} ms after that kernel's start, "
          f"which ended at {hold_ms:.2f} ms (must be later); the backward took {bwd_ms:.3f} "
          f"ms, {bwd_ms / idle_ms:.1f}x its {idle_ms:.4f} ms on the idle card (CUDA events); "
          f"equal to the idle card's outputs bit for bit {same} (must be True)")
    if not same:
        raise AssertionError("busy card: the backward's outputs differ from the idle card's")
    if done_ms >= hold_ms:
        raise AssertionError("busy card: the backward waited for the other stream's kernel")


def phase_base_kernels(rng, fb, sit_module, m, bs) -> dict:
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
        if name == "fused_block_cls":
            controls.update(cls_fwd_controls(fb, dist, x, pr, heads, N))
            phase("base-kernels", cls_fwd_route_line(fb, f"{name} SiT-base B={B} N={N}", N, dim))
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
        def control(vl_bwd=N, **patches):
            return bwd_control(fb, x, g, pr, heads, N, cls, got, vl_bwd, chunk=16, **patches)

        controls = bwd_controls(fb, control)
        if cls:
            controls.update(cls_bwd_controls(fb, control, N, heads))
            phase("base-kernels", cls_route(
                "base-kernels", fb, f"{name} SiT-base B={B} N={N}", B, N, dim, heads, mlp))
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
    base_times = dict(times)
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
    return base_times


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
    want[FEW_FWD] = 2  # one in each CLS forward
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
    per_step["flash_attention_bwd 8 queries"] = 1  # the CLS backward's
    per_step[FEW_FWD] = 1  # the CLS forward's
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


def profile_step(step_fn, bs, name="base-train") -> None:
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
    phase(name, f"torch.profiler, one step at B={bs}: {step_ms:.1f} ms (CUDA events, "
          f"profiler on), kernels {busy:.1f} ms of device time (idle share "
          f"{max(0.0, 1 - busy / step_ms):.3f}); top kernels (ms, share of device time):")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:16]:
        ms_e = e.self_device_time_total / 1e3
        phase(name, f"  {ms_e:9.2f} {ms_e / max(busy, 1e-9):6.1%} x{e.count:<4d} "
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
    scale = dh ** -0.5
    s = q @ k.transpose(-1, -2) * scale
    s[..., vl:] = float("-inf")
    p = torch.exp(s - lse[:samples, ..., None])
    p[..., vl:, :] = 0.0
    ds = (p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True)) * scale)
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
            lse.data_ptr(), 1, 1, 64, 64, 64, DH, *fa._drop_args(0.0, 0), 0,
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


def upd_ratios(upd, ref) -> dict:
    """|update - reference update| / max |reference update| of each
    parameter the reference moved."""
    return {k: ((upd[k] - ref[k]).abs().max() / ref[k].abs().max()).item()
            for k in ref if ref[k].abs().max() > 0}


def upd_ratio(upd, ref) -> float:
    """The worst of ``upd_ratios``."""
    return max(upd_ratios(upd, ref).values())


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
    worst = sorted(upd_ratios(run[3], plain[3]).items(), key=lambda kv: -kv[1])[:3]
    phase(name, f"{label}: max relative loss gap {loss_err:.4g} (tol {loss_tol}); worst "
          f"|update - plain update| / max |plain update| {r:.4g} (tol {upd_tol}; the worst "
          "three: " + ", ".join(f"{k} {v:.4g}" for k, v in worst) + f"); control, "
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
# The chain's int8 GEMM held bit for bit against the exact product (name:
# (M, N, K)): the four SiT-base products at bs_val 64 (timed beside
# torch._int_mm), SiT-tiny's qkv (K = 192: one and a half 128-deep k-steps)
# at B=256 and at 1,000 rows (a ragged last tile).
INT8_GEMMS = {"qkv": (64 * 1281, 2304, 768), "out": (64 * 1281, 768, 768),
              "fc1": (64 * 1281, 3072, 768), "fc2": (64 * 1281, 768, 3072),
              "qkv K=192": (256 * 321, 576, 192), "qkv K=192 M=1000": (1000, 576, 192)}
# Row scales at which the scan of fc1's arithmetic (svt_int8_scan) holds the
# codes by reciprocal against those by division: the all-zero row's 1e-30 /
# 127, both sides of the 2^-60 where quant_recip rescales, and scales from
# 1e-12 to 1234.5 (at every float v in [0, 128 s]).
INT8_SCAN_SCALES = [1e-30 / 127, 2.0 ** -70, 2.0 ** -61, 2.0 ** -60, 1e-12, 2.0 ** -7, 1 / 127,
                    0.0213, 1.0, 7.77, 1234.5]
# The int8 block and its GEMMs under the mma.sync s8 design this one
# replaced (PERF.md section 6, NVIDIA H100 80GB HBM3 at 700 W): a record
# printed beside this run's, not a measurement of this run.
MMA_SYNC_INT8_MS = {"fused_block_int8": 5.8335, "qkv": 0.9488, "out": 0.3495, "fc1": 1.2722,
                    "fc2": 1.0784}
INT8_RECORDS: dict = {}  # this run's: name -> (ms, torch._int_mm ms, bound ms)
EMBED_CASES = [(2, 256, 192), (2, 256, 384), (3, 64, 768)]  # (sub_ico, B, dim)
# int8 SiT-base predictions against the fp32 eager model, rel-L2. At these
# seeded weights (attention O(1) of every block, twelve blocks) bf16
# ``predict`` itself reads 0.024-0.029 and int8 0.031-0.058 (two draws of
# the weights), above tests/test_int8.py's 0.02 for a two-block model; the
# gate is set from those readings (an NVIDIA H100 80GB HBM3 at 700 W), the
# control (a block dropped) read 1.69-2.16.
INT8_SLICE_REL = 0.08
INT8_SLICE_N = 128  # SiT-base surfaces served at bs_val 64 (two batches)


def int8_block_params(rng, dim, heads, mlp, dh=DH):
    """(fused_block_int8's 15 parameters, fused_block's 11 in bf16) on the
    card from phase 10's seeded block, the int8 codes quantized from
    float32."""
    from surface_vision_transformers_tpu_torch.ops.quant import quantize_block_weights

    p = [t.cuda() for t in block_params(rng, dim, heads, mlp, dh)]
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


def int8_block_x1_rounded(fb, x, p, heads, vl, dh=DH):
    """The plain int8 block with x1 rounded to bf16 (a control)."""
    from surface_vision_transformers_tpu_torch.ops.quant import int8_mm_reference as mm

    (ln1_s, ln1_b, q_qkv, s_qkv, q_out, s_out, b_out, ln2_s, ln2_b,
     q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2) = p
    hd, dt = heads * dh, x.dtype
    qkv = mm(fb._layer_norm(x, ln1_s, ln1_b, 1e-5), q_qkv, s_qkv).to(dt)
    attn = fb._attention(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], heads, dh, vl, dt)
    x1 = (x.float() + (mm(attn, q_out, s_out) + b_out)).bfloat16().float()
    f = F.gelu(mm(fb._layer_norm(x1, ln2_s, ln2_b, 1e-5), q_fc1, s_fc1) + b_fc1)
    return (x1 + (mm(f, q_fc2, s_fc2) + b_fc2)).to(dt)


def int8_block_ops(B, N, vl, dim, heads, mlp, dh=DH):
    """(int8 GEMM operations, bf16 attention operations) of one block; the
    attention products over the rows and keys < valid_len."""
    hd = heads * dh
    return 2 * B * N * (dim * 3 * hd + hd * dim + 2 * dim * mlp), 4 * B * heads * vl * vl * dh


def phase_int8_kernels(rng, fb) -> dict:
    """Phase 20: the int8 chain's row quantizer and GEMM bitwise against
    their plain versions at SiT-base shapes; fused_block_int8 against the
    float32 and bf16 plain int8 block with controls; times beside
    fused_block, ``torch._int_mm`` and the bounds. -> the kernel's row."""
    from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as fbi8
    from surface_vision_transformers_tpu_torch.ops import quant

    failures = []
    M = 64 * 1281  # SiT-base rows at bs_val 64 (the last 128-row tile half full)
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
    for name, (m, n_out, K) in INT8_GEMMS.items():
        qa = torch.randint(-127, 128, (m, K), device="cuda", dtype=torch.int8)
        qa[:64] = 127
        qw = torch.randint(-127, 128, (n_out, K), device="cuda", dtype=torch.int8)
        qw[:8] = 127
        acc = fbi8.int8_gemm_kernel(qa, qw)
        bad = int((acc != quant.int8_product(qa, qw)).sum())
        phase("int8-kernels", f"int8 GEMM (Q_S32) {name} M={m} N={n_out} K={K}: {bad} int32 "
              f"accumulators differ from the exact product (must be 0); largest "
              f"|acc| {acc.abs().max().item()}")
        if bad:
            failures.append(f"int8 GEMM {name}")
        if m != M:
            continue
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
    INT8_RECORDS.update(times)

    # the chain's products with their epilogues, bitwise against the plain
    # dequantized product (int8_mm_reference's arithmetic), at SiT-base widths
    for kind, n_out, K in (("qkv", 2304, 768), ("out", 768, 768), ("fc2", 768, 3072)):
        h = torch.randn((M, K), device="cuda") * 2.0
        qa, sa = quant.quant_rows(h)
        qw, sw = quant.quantize_weight_int8(
            (torch.rand((n_out, K), device="cuda") * 2 - 1) * K ** -0.5)
        b = torch.randn(n_out, device="cuda") * 0.5
        deq = quant.int8_mm_reference(h, qw, sw)
        r = torch.randn((M, n_out), device="cuda")
        if kind == "qkv":
            got, want = fbi8.int8_block_gemm(kind, qa, sa.reshape(-1), qw, sw), deq.bfloat16()
        elif kind == "out":  # x1 = x + (. + b_out), x bf16, x1 fp32
            r = r.bfloat16()
            got, want = fbi8.int8_block_gemm(kind, qa, sa.reshape(-1), qw, sw, b, r), \
                r.float() + (deq + b)
        else:  # out = (x1 + (. + b_fc2)) in bf16, x1 fp32
            got, want = fbi8.int8_block_gemm(kind, qa, sa.reshape(-1), qw, sw, b, r), \
                (r + (deq + b)).bfloat16()
        bad = int((got != want).sum())
        phase("int8-kernels", f"int8 GEMM {kind} with its epilogue M={M} N={n_out} K={K}: {bad} "
              f"of {got.numel()} outputs differ from the plain version (must be 0)")
        if bad:
            failures.append(f"int8 GEMM {kind} epilogue")
        del h, qa, qw, deq, r, got, want
    torch.cuda.empty_cache()

    scan = fbi8.int8_scan(torch.tensor(INT8_SCAN_SCALES, device="cuda"))
    phase("int8-kernels", f"every float: gelu_erf decreases to the next float above 0 at "
          f"{scan['gelu_decreases']} (must be 0); max |gelu_erf| below 0 "
          f"{scan['gelu_neg_max']:.8g} (must be <= the kernel's bound "
          f"{scan['gelu_neg_bound']:.8g}); codes by reciprocal "
          f"differing from codes by division over every v in [0, 128 s] at "
          f"{len(INT8_SCAN_SCALES)} scales: {scan['codes_differ']} (must be 0)")
    if scan["gelu_decreases"] or scan["gelu_neg_max"] > scan["gelu_neg_bound"] \
            or scan["codes_differ"]:
        failures.append("the scan of fc1's arithmetic")
    for m, mlp, K in ((M, 3072, 768), (256 * 321, 768, 192)):  # SiT-base's fc1, SiT-tiny's
        h = torch.randn((m, K), device="cuda") * 2.0  # LN2's output
        h[0] = 0.0  # an all-zero row: f = GELU(b_fc1)
        h[1, 0] = 1e3  # a row whose codes are mostly 0
        qa, sa = quant.quant_rows(h)
        qw, sw = quant.quantize_weight_int8(
            (torch.rand((mlp, K), device="cuda") * 2 - 1) * K ** -0.5)
        b = torch.randn(mlp, device="cuda") * 0.5
        q, sc = fbi8.fc1_codes_kernel(qa, sa.reshape(-1), qw, sw, b)
        f = F.gelu(quant.int8_mm_reference(h, qw, sw) + b)  # the plain block's f, in fp32
        qp, sp = quant.quant_rows(f)
        bad = int((q != qp).sum()) + int((sc != sp.reshape(-1)).sum())
        phase("int8-kernels", f"fc1 + f's quantization (two passes, no fp32 f) M={m} mlp={mlp} "
              f"K={K}: {bad} of {q.numel() + sc.numel()} codes and scales differ from "
              "quant_rows of the plain f (must be 0)")
        if bad:
            failures.append(f"fc1 codes mlp={mlp}")
        del h, qa, qw, q, f, qp
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
            INT8_RECORDS["fused_block_int8"] = (ms, None, b_ms)
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


def embed_case(pe, rng, sub_ico, B, dim, patches, failures) -> dict:
    """One ``patch_embed`` case of phase 21: the kernel on fp32 x and on the
    same x rounded to bf16 (the same tokens: the outputs must be the same
    bits) against the float32 and bf16 plain versions, with controls; two
    calls bitwise equal; the kernel's shared memory from the C entry
    against ``embed_plan``; times, fp32 and bf16 x, beside the plain
    version, index_select + addmm and the bound. -> the fp32 row's numbers."""
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.ops import _native

    table = load_patch_table(6, sub_ico).indices[:patches]
    L, V = table.shape
    label = f"sub-ico {sub_ico} ({L} x {V}) B={B} dim {dim}"
    idx = pe.table_tensor(table, "cuda")
    x = torch.from_numpy(rng.standard_normal((B, 4, 40962)).astype(np.float32)).cuda()
    bd = 1.0 / np.sqrt(4 * V)
    kernel = torch.from_numpy(rng.uniform(-bd, bd, (4 * V, dim)).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.uniform(-bd, bd, dim).astype(np.float32)).cuda()
    means = rng.uniform(-1, 1, (1, 4, 1)).astype(np.float32)
    stds = rng.uniform(0.5, 2, (1, 4, 1)).astype(np.float32)
    w, b = pe.embed_matrix(kernel, bias, V, means=means, stds=stds)
    x16 = x.bfloat16()
    got = pe.patch_embed(x, idx, w, b)
    again, got16 = pe.patch_embed(x, idx, w, b), pe.patch_embed(x16, idx, w, b)
    same, same16 = torch.equal(got, again), torch.equal(got, got16)
    got = got.float()
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
    smem = (_native.library().svt_patch_embed_smem(L, V, w.shape[1], dim),
            pe.embed_plan(L, V, w.shape[1], dim)["bytes"])
    phase("patch-embed", f"{label} (K {4 * V} -> {w.shape[1]}): max |err| "
          + ", ".join(f"{k} {v / step:.3f}" for k, v in errs.items())
          + f" bf16 steps at the largest output (gate {BOUND_STEPS}); "
          f"{(got != ref_bf).float().mean().item():.4%} of outputs differ from plain bf16; "
          f"controls: " + ", ".join(f"{k} {v / step:.1f}" for k, v in controls.items())
          + f"; two calls bitwise equal {same}, bf16 x gives fp32 x's bits {same16}; shared "
          f"memory {smem[0]} bytes from the C entry, {smem[1]} by embed_plan")
    if not bool(torch.isfinite(got).all()) or max(errs["vs fp32 plain"],
                                                  errs["vs plain bf16"]) > BOUND_STEPS * step:
        failures.append(f"patch_embed {label}")
    if min(controls.values()) <= BOUND_STEPS * step:
        failures.append(f"patch_embed {label}: a control passed the gate")
    if not (same and same16) or smem[0] != smem[1]:
        failures.append(f"patch_embed {label}: not bitwise repeatable, or its plan disagrees")
    flat = idx.reshape(-1)
    wt = w[:, :4 * V].t()
    out = {}
    for xx, name in ((x, "fp32"), (x16, "bf16")):
        def library():  # index_select + torch.matmul: the library form
            t = xx.index_select(2, flat).view(B, 4, L, V).permute(0, 2, 3, 1).reshape(B, L, 4 * V)
            return torch.addmm(b.bfloat16(), t.bfloat16().reshape(B * L, -1), wt)

        ms = cuda_ms(lambda: pe.patch_embed(xx, idx, w, b))
        plain_ms = cuda_ms(lambda: pe.patch_embed_reference(xx, idx, w, b), reps=5)
        lib_ms = cuda_ms(library)
        flops = 2 * B * L * 4 * V * dim
        nbytes = nbytes_of(xx, idx, w, b) + got.numel() * 2
        b_ms, b_by = bound_ms(flops, nbytes)
        phase("patch-embed", f"{label} {name} x: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_select + addmm {lib_ms:.4f} ms (CUDA-event medians of 25 / 5 / 25); bound "
              f"{b_ms:.4f} ms by {b_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB, "
              f"{b_ms / ms:.1%} of it)")
        out[name] = {"max_abs_err": errs["vs fp32 plain"], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    del x, x16, got, got16, again, ref32, ref_bf
    torch.cuda.empty_cache()
    return out["fp32"]


# phase 21's cases past EMBED_CASES, from a generator of their own (the
# phases after 21 draw the data their gates were set on): sub-ico 5, and a
# ragged one, sub-ico 2's first 300 patches at B = 3 (the kernel's last
# group of 64 patches runs past L). (sub_ico, B, dim, patches kept)
EMBED_EXTRA = [(5, 64, 96, None), (2, 3, 192, 300)]


def phase_patch_embed(rng, embed_launches) -> dict:
    """Phase 21: the gather-fused patch_embed (``embed_case``) at sub-ico 2
    (B=256, dim 192 and 384) and sub-ico 3 (B=64, dim 768), then at
    ``EMBED_EXTRA``. -> the kernel's row (at phase 4's shape, fp32 x, with
    phase 4's launches)."""
    from surface_vision_transformers_tpu_torch.ops import patch_embed as pe

    failures, row = [], None
    for sub_ico, B, dim in EMBED_CASES:
        nums = embed_case(pe, rng, sub_ico, B, dim, None, failures)
        if (sub_ico, B, dim) == (2, 256, 192):
            row = {"name": "patch_embed", "route": "cuda", "source": EMBED_SOURCE,
                   "replaces": EMBED_TPU, "launches": embed_launches, **nums}
    own = np.random.default_rng(SEED + 21)
    for sub_ico, B, dim, patches in EMBED_EXTRA:
        embed_case(pe, own, sub_ico, B, dim, patches, failures)
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
    want[FEW_FWD] = n_batches  # one in each CLS forward
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
        want[FEW_FWD] = 2  # one in each CLS forward
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


GEMM_SOURCE = "surface_vision_transformers_tpu_torch/csrc/gemm.cuh"
GEMM_FP32_REL = 2e-4  # fp32 outputs: |err| / max |ref|; the first run of the engine read <= 4.8e-5
GEMM_TINY_M = 256 * N_TOKENS  # SiT-tiny rows at B=256
GEMM_BASE_M = 32 * 1281  # SiT-base rows at B=32 (not a multiple of 128)
MPP_BS = 32  # the MPP config's batch: fused_block / fused_block_bwd timed there once
# The mma.sync block chains' recorded times (PERF.md section 6, the parent
# design's final run, NVIDIA H100 80GB HBM3 at 700 W): a record, not measured
# in this run.
MMA_SYNC_BLOCK_MS = {"fused_block": 0.9515, "fused_block SiT-base B=32": 4.1880,
                     "fused_block_cls": 0.3550, "fused_block_bwd": 2.4956,
                     "fused_block_cls_bwd": 0.9076}


def gemm_inputs(rng, M, N, K, a_scale=1.0):
    """bf16 A (M, K) ~ N(0, a_scale^2) (LayerNorm outputs and the like) and
    W (N, K) ~ U(+-1/sqrt(K)), the seeded weights' scale."""
    a = bf16_randn(rng, (M, K), a_scale)
    w = torch.from_numpy(rng.uniform(-1, 1, (N, K)).astype(np.float32) / np.sqrt(K)).to(
        "cuda", torch.bfloat16)
    return a, w


def gemm_gate(got, ref, fp32) -> tuple[float, bool]:
    """(measure, passes): bf16 outputs within one bf16 step at the largest
    |ref|; fp32 outputs within GEMM_FP32_REL of it."""
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    m = err / top if fp32 else err / bf16_step(top)
    return m, bool(math.isfinite(err)) and m <= (GEMM_FP32_REL if fp32 else 1.0)


def phase_block_gemms(rng, fb) -> dict:
    """Phase 25: the block chains' GEMMs alone (csrc/gemm.cuh). Each of the
    forward's four products at SiT-tiny B=256 and SiT-base B=32, and each of
    the backward's eight at SiT-tiny B=256, against the fp32 plain product
    of the same bf16 operands with its epilogue: bf16 outputs within one
    bf16 step at the largest output, fp32 outputs within GEMM_FP32_REL of
    it; control: the plain product without its last 64-deep k-step, which
    the gate must reject. CUDA-event times beside torch.mm(out_dtype=fp32)
    on the same operands (timed, never used) and the bound. Then
    fused_block_bwd repeats bit for bit at SiT-tiny B=256 (a control with one
    cotangent element raised by 1; the plain dW_fc2's split partials summed
    in reverse order shown to move fp32 bits), and fused_block /
    fused_block_bwd timed at the MPP config's bs 32. -> per-GEMM rows."""
    rows, failures = [], []
    f32 = torch.float32

    def check(label, outs, plains, controls, ms, lib_ms, flops, nbytes):
        """outs / plains: [(tensor, fp32?)]; controls: plain outputs that
        must fail."""
        measures = [gemm_gate(o, p, fp32) for (o, fp32), (p, _) in zip(outs, plains)]
        ctl = [gemm_gate(outs[0][0], c, outs[0][1]) for c in controls]
        b_ms, b_by = bound_ms(flops, nbytes)
        unit = lambda fp32: "rel" if fp32 else "bf16 steps"
        phase("block-gemms", f"{label}: " + ", ".join(
            f"{m:.4g} {unit(fp32)}" for (m, _), (_, fp32) in zip(measures, outs))
              + " (gates: 1 bf16 step, " + f"{GEMM_FP32_REL} rel); control, last k-step "
              f"dropped: {', '.join(f'{m:.4g}' for m, _ in ctl)} (must fail); kernel {ms:.4f} "
              f"ms, torch.mm {lib_ms:.4f} ms ({lib_ms / ms:.3f}x the kernel's speed), bound "
              f"{b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%}; {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
        if not all(ok for _, ok in measures):
            failures.append(label)
        if any(ok for _, ok in ctl):
            failures.append(f"{label}: a control passed")
        rows.append({"gemm": label, "ms": ms, "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by})

    def drop_last(t, dim):
        t = t.clone()
        t.narrow(dim, t.shape[dim] - 64, 64).zero_()
        return t

    # the forward's four, at SiT-tiny B=256 and SiT-base B=32
    for width, M, (dim, mlp, hd) in (("SiT-tiny", GEMM_TINY_M, (192, 768, 192)),
                                     ("SiT-base", GEMM_BASE_M, (768, 3072, 768))):
        for name, N, K in (("qkv", 3 * hd, dim), ("out", dim, hd), ("fc1", mlp, dim),
                           ("fc2", dim, mlp)):
            a, w = gemm_inputs(rng, M, N, K)
            bias = torch.from_numpy((0.1 * rng.standard_normal(N)).astype(np.float32)).cuda()
            res = bf16_randn(rng, (M, N)) if name in ("out", "fc2") else None
            label = f"forward {name} {width} M={M} N={N} K={K}"

            def kernel(aa=a):
                return fb.block_gemm(aa, w, bias if name != "qkv" else None, res,
                                     gelu=name == "fc1")

            def plain(aa=a):
                return fb.gemm_reference(aa.float(), w.float(), bias if name != "qkv" else None,
                                         res, gelu=name == "fc1")

            got, ref, ctl = kernel(), plain(), plain(drop_last(a, 1))
            if name == "fc1":
                outs, plains = [(got[0], False), (got[1], True)], [(ref[0], False), (ref[1], True)]
                ctl = [ctl[0]]
            else:
                outs, plains, ctl = [(got, False)], [(ref, False)], [ctl]
            del got, ref
            ms = cuda_ms(kernel)
            lib_ms = cuda_ms(lambda: torch.mm(a, w.t(), out_dtype=f32))
            out_bytes = M * N * 2 + (M * N * 4 if name == "fc1" else 0)
            nbytes = nbytes_of(a, w, bias) + out_bytes + (nbytes_of(res) if res is not None else 0)
            check(label, outs, plains, ctl, ms, lib_ms, 2 * M * N * K, nbytes)
            del a, w, res, outs, plains, ctl
            torch.cuda.empty_cache()

    # the backward's eight, at SiT-tiny B=256: four dX products, four dW
    M, dim, mlp, hd = GEMM_TINY_M, DIM, MLP, HD
    for name, N, K, kind in (("df1 = g W_fc2, * GELU'", mlp, dim, "gelu"),
                             ("dh = df1 W_fc1", dim, mlp, "f32"),
                             ("da = dx1 W_out", hd, dim, "bf16"),
                             ("dh = dqkv W_qkv", dim, 3 * hd, "f32")):
        a = bf16_randn(rng, (M, K), 0.01)  # a cotangent; w the (out = K, in = N) weight
        w = torch.from_numpy(rng.uniform(-1, 1, (K, N)).astype(np.float32) / np.sqrt(N)).to(
            "cuda", torch.bfloat16)
        pre = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)).cuda() \
            if kind == "gelu" else None
        out_dtype = f32 if kind == "f32" else torch.bfloat16
        label = f"backward {name} M={M} N={N} K={K}"

        def kernel(aa=a):
            return fb.block_gemm_nn(aa, w, pre, out_dtype=out_dtype)

        def plain(aa=a):
            return fb.gemm_nn_reference(aa.float(), w.float(), pre, out_dtype=f32)

        got, ref, ctl = kernel(), plain(), plain(drop_last(a, 1))
        if kind == "gelu":
            outs, plains, ctl = [(got[0], False), (got[1], True)], [(ref[0], False),
                                                                     (ref[1], True)], [ctl[0]]
        else:
            outs, plains, ctl = [(got, kind == "f32")], [(ref, kind == "f32")], [ctl]
        del got, ref
        ms = cuda_ms(kernel)
        lib_ms = cuda_ms(lambda: torch.mm(a, w, out_dtype=f32))
        nbytes = nbytes_of(a, w) + M * N * (4 if kind == "f32" else 2) + (
            nbytes_of(pre) + 4 * N if pre is not None else 0)
        check(label, outs, plains, ctl, ms, lib_ms, 2 * M * N * K, nbytes)
        del a, w, pre, outs, plains, ctl
        torch.cuda.empty_cache()
    for name, m_out, n_out in (("dW_fc2 = g^T f", dim, mlp), ("dW_fc1 = df1^T h2", mlp, dim),
                               ("dW_out = dx1^T attn", dim, hd),
                               ("dW_qkv = dqkv^T h1", 3 * hd, dim)):
        a, b = bf16_randn(rng, (M, m_out), 0.01), bf16_randn(rng, (M, n_out))
        label = f"backward {name} Mout={m_out} Nout={n_out} K={M}"
        got = fb.block_weight_grad(a, b)
        ref = fb.weight_grad_reference(a, b)
        ctl = fb.weight_grad_reference(drop_last(a, 0), b)
        ms = cuda_ms(lambda: fb.block_weight_grad(a, b))
        lib_ms = cuda_ms(lambda: torch.mm(a.t(), b, out_dtype=f32))
        check(label, [(got, True)], [(ref, True)], [ctl], ms, lib_ms, 2 * M * m_out * n_out,
              nbytes_of(a, b, got))
        del a, b, got, ref, ctl
        torch.cuda.empty_cache()

    for width, (B, N, dim, heads, mlp) in (("SiT-tiny", (256, N_TOKENS, DIM, HEADS, MLP)),
                                           ("SiT-base", (32, 1281, 768, 12, 3072))):
        fwd_b, train_b, bwd_b = chain_bytes(B, N, dim, heads, mlp)
        fwd7 = chain_bytes(B, N, dim, heads, mlp, fused_mlp=False)[0]
        phase("block-gemms", f"{width} B={B} N={N}: the chains' round trips through HBM "
              f"(chain_bytes) {fwd_b / 1e9:.3f} GB serving forward = "
              f"{fwd_b / PEAK_BYTES * 1e3:.4f} ms (the seven launches' {fwd7 / 1e9:.3f} GB), "
              f"{train_b / 1e9:.3f} GB training forward = "
              f"{train_b / PEAK_BYTES * 1e3:.4f} ms, {bwd_b / 1e9:.3f} GB backward = "
              f"{bwd_b / PEAK_BYTES * 1e3:.4f} ms at 3.35 TB/s")

    # fused_block_bwd repeats bit for bit at SiT-tiny B=256
    p = [t.cuda() for t in block_params(rng, DIM, HEADS, MLP)]
    pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous() for t in p]
    kw = dict(heads=HEADS, dim_head=DH)
    for B, label in ((256, "SiT-tiny B=256"), (MPP_BS, f"SiT-tiny B={MPP_BS} (MPP's bs)")):
        x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N_TOKENS, DIM)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        g = bf16_randn(rng, (B, N_TOKENS, DIM), G_SCALE)
        _, sv = fb.train_forward(x, *pb, **kw)
        if B == 256:
            first = fb.fused_block_bwd(x, g, *pb, saved=sv, **kw)
            again = fb.fused_block_bwd(x, g, *pb, saved=sv, **kw)
            moved = fb.fused_block_bwd(x, bump(g), *pb, saved=sv, **kw)
            same = all(torch.equal(u, v) for u, v in zip(first, again))
            control = all(torch.equal(u, v) for u, v in zip(first, moved))
            # the order of a split-K sum reaches fp32 bits: dW_fc2's partials
            gm, fm = g.reshape(-1, DIM).float(), sv["f"].reshape(-1, MLP).float()
            chunk = -(-gm.shape[0] // 16)
            parts = [gm[s:s + chunk].t() @ fm[s:s + chunk] for s in range(0, gm.shape[0], chunk)]
            ahead = functools.reduce(torch.add, parts)
            back = functools.reduce(torch.add, parts[::-1])
            differ = int((ahead != back).sum())
            phase("block-gemms", f"fused_block_bwd {label}: two calls on the same inputs "
                  f"bitwise identical {same} (must be True); controls: one cotangent element "
                  f"raised by 1, identical {control} (must be False); the plain dW_fc2 as 16 "
                  f"split partials summed in reverse order, {differ} of {ahead.numel()} fp32 "
                  "elements differ (must be > 0)")
            if not same or control or differ == 0:
                failures.append("fused_block_bwd bitwise repeat")
            del first, again, moved, parts, ahead, back
        else:
            with torch.inference_mode():
                f_ms = cuda_ms(lambda: fb.fused_block(x, *pb, **kw))
            b_ms = cuda_ms(lambda: fb.fused_block_bwd(x, g, *pb, saved=sv, **kw))
            fwd_f, bwd_f = block_flops(B, N_TOKENS, N_TOKENS, DIM, HEADS, MLP, False)
            phase("block-gemms", f"{label}: fused_block {f_ms:.4f} ms (bound "
                  f"{bound_ms(fwd_f, 0)[0]:.4f} ms by operations), fused_block_bwd {b_ms:.4f} "
                  f"ms (bound {bound_ms(bwd_f, 0)[0]:.4f} ms); CUDA-event medians of 25")
        del x, g, sv
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("block GEMMs: " + "; ".join(failures))
    return rows


# Phases 26-28: MS-SiT serving (configs/training/mssit_scan_age.yml: ico 6
# patched at sub-ico 5, 20,480 patches x 6 vertices; stage dims 96 / 192 /
# 384 / 768 with heads 3 / 6 / 12 / 24, so head dim 32 in every stage;
# window 64, global_max 512, axial cross-mixing, mlp ratio 4; mean pooling)
# at its bs_val 64, full width and depth.
MSSIT_CFG = ROOT / "configs/training/mssit_scan_age.yml"
MSSIT_DH = 32
# The folds a batch of 64 gives the block kernels (stage, sequences, N, dim,
# heads, blocks a batch): models/mssit.py's stage_plan and fold_tokens.
MSSIT_FOLDS = [(0, 20480, 64, 96, 3, 1), (0, 4096, 320, 96, 3, 1),
               (1, 5120, 64, 192, 6, 1), (1, 4096, 80, 192, 6, 1),
               (2, 1280, 64, 384, 12, 3), (2, 4096, 20, 384, 12, 3),
               (3, 64, 320, 768, 24, 2)]
MSSIT_ROW_FOLD = (0, 4096, 320, 96, 3, 1)  # the bf16 rows' shape: stage 0's axial fold
MSSIT_INT8_ROW_FOLD = (3, 64, 320, 768, 24, 2)  # the int8 row's: stage 3's global attention
# The attention forward at dh 32 past 512 keys, where its other two tilings
# run (csrc/flash_attention.cu: 192 queries a CTA where that grid fills the
# card twice, else 64; 128-key tiles), and with valid_len inside a key tile.
MSSIT_ATT_EDGES = [(32, 3, 1281, 1281), (2, 3, 1281, 1281), (16, 6, 200, 150)]
# The dh-64 softmax scale 1/8 applied at dh 32 (a control): q scaled by
# (1/8) / 32^-0.5.
MSSIT_SCALE_64 = 0.125 / MSSIT_DH ** -0.5
# The resident attention forward at dh 32 at its packing edges (B, heads, N,
# valid_len): three sequences of 20 rows a tile, each masked from row 15;
# four of 80 (masked from 70) in five tiles, so that tiles cross sequences;
# three of 100 (from 90) in five tiles. B * heads is a multiple of the pack,
# so the "block-diagonal mask ignored" control merges whole units.
MSSIT_FWD_PACK_EDGES = [(1024, 12, 20, 15), (1024, 6, 80, 70), (64, 3, 100, 90)]
# The fused forward chain's kernels alone (stage, rows, dim, heads): a batch
# of 64's stage 0 and stage 1 rows.
MSSIT_FUSED_CASES = [(0, 64 * 20480, 96, 3), (1, 64 * 5120, 192, 6)]
FUSED_SOURCE = "surface_vision_transformers_tpu_torch/csrc/fused_mlp.cu"
MSSIT_SLICE_N = 100  # surfaces served at bs_val 64: two batches, the last padded
MSSIT_EAGER_B = 8  # the eager models' batch (their fp32 scores at B=64 reach ~5 GB a fold)
# Phase 27's gates, set from readings on an NVIDIA H100 80GB HBM3 at 700 W at
# these seeded weights, whose predictions vary little across surfaces (std
# 0.027 about a mean of -0.445: the head pools 320 LayerNormed tokens):
# |kernel path - eager bf16| read 0.0056, its controls 0.053 (stage 0's
# axial fold run as the window fold) and 0.44 (block 5 dropped); the int8
# predictions' rel-L2 from the fp32 eager model read 0.0139 (bf16's 0.0088),
# the controls 0.054 and 0.84. Phase 22's 0.08 would pass the fold control.
MSSIT_SLICE_TOL = 0.015  # |kernel path - eager bf16| in MS-SiT predictions
MSSIT_INT8_REL = 0.03  # int8 predictions' rel-L2 from the fp32 eager model
MSSIT_ENTRY_N = 80  # cli.test surfaces: two batches of 64, the last padded
MSSIT_RECORDS: dict = {}  # this run's dh-32 times for the records line


def dev_randn(g, shape, scale=1.0) -> torch.Tensor:
    """bf16 N(0, scale^2) made on the card from the generator ``g``: the
    MS-SiT folds' activations run to hundreds of millions of values."""
    return (scale * torch.randn(shape, generator=g, device="cuda")).bfloat16()


def mssit_chunk(N, dim, heads, budget=2**29) -> int:
    """Sequences per slice of a plain run at a fold: its fp32 scores and
    MLP hidden within ~``budget`` bytes."""
    return max(1, budget // max(heads * N * N * 4, N * 4 * dim * 4 * 2))


def mssit_state(rng, model) -> dict:
    """A seeded state dict for the port's MS-SiT ``model``, the phase-3
    weights' recipe: torch-Linear-style uniform init, perturbed
    LayerNorms, positions N(0, POS_STD), and the attention gains (q and k
    rows of every qkv x QK_GAIN, every out-projection x OUT_GAIN)."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out = {}
    for name, shape in shapes.items():
        if name.endswith("norm.weight"):
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("norm.bias"):
            v = 0.1 * rng.standard_normal(shape)
        elif name == "pos_embedding":
            v = POS_STD * rng.standard_normal(shape)
        else:  # a Linear weight (out, in), or its bias
            fan_in = shape[1] if len(shape) == 2 else shapes[name[:-4] + "weight"][1]
            b = 1.0 / np.sqrt(fan_in)
            v = rng.uniform(-b, b, shape)
            if name.endswith("to_qkv.weight"):
                v[: 2 * shape[0] // 3] *= QK_GAIN
            elif name.endswith("to_out.weight"):
                v *= OUT_GAIN
        out[name] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def mssit_gate(got, ref32, ref_bf, controls) -> tuple[float, dict]:
    """(worst |err| over BOUND_STEPS bf16 steps at the largest |fp32
    output| against the fp32 and bf16 plain runs, each control's |err| over
    the same bound: must exceed 1)."""
    bound = BOUND_STEPS * bf16_step(ref32.abs().max().item())
    err = max((got - ref32).abs().max().item(), (got - ref_bf).abs().max().item())
    ratio = err / bound if bool(torch.isfinite(got).all()) else math.inf
    return ratio, {k: (got - v).abs().max().item() / bound for k, v in controls.items()}


def fwd_mask_ignored(fa, qkv, heads, pack, vl):
    """o of the float32 plain attention with each of the resident forward's
    units (``pack`` consecutive (sample, head) sequences) merged into one
    sequence, so that they see each other's keys: the block-diagonal mask
    ignored, the key mask kept (a control). The merged sequence takes each
    sequence's first ``vl`` rows first, so that its own valid_len, pack *
    vl, masks the rest."""
    Bf, N, F_ = qkv.shape
    dh, BH = F_ // (3 * heads), Bf * heads
    idx = torch.arange(pack * N, device=qkv.device).view(pack, N)
    order = torch.cat([idx[:, :vl].reshape(-1), idx[:, vl:].reshape(-1)])
    q, k, v = (t.float().reshape(BH // pack, 1, pack * N, dh)[:, :, order]
               for t in fa.split_qkv(qkv, heads))
    o = fa.flash_attention_reference(q, k, v, pack * vl)[0]
    return fa.merge_heads(o[:, :, torch.argsort(order)].reshape(Bf, heads, N, dh))


def mlp_plain(fb, x1, ln_s, ln_b, w1, b1, w2, b2, residual=True, gelu_skip=None, gamma=True):
    """``fused_block.mlp_reference`` with the controls the fused MLP's gate
    must reject: the residual left out, GELU skipped on the 64 hidden
    columns of chunk ``gelu_skip``, LN2's gamma ignored (all defaults: the
    plain version itself)."""
    dt = x1.dtype
    h2 = fb._layer_norm(x1, ln_s if gamma else torch.ones_like(ln_s), ln_b, 1e-5).to(dt)
    fpre = fb._mm(h2, w1) + b1
    f = F.gelu(fpre)
    if gelu_skip is not None:
        f[..., 64 * gelu_skip:64 * gelu_skip + 64] = fpre[..., 64 * gelu_skip:64 * gelu_skip + 64]
    out = fb._mm(f.to(dt), w2) + b2
    return (x1.float() + out if residual else out).to(dt)


def phase_fused_chain_parts(fb, failures, rows) -> None:
    """Phase 26's part for the fused forward chain (dims 96 and 192): the
    MLP half (``block_mlp``) and the qkv product with LN1 in its prologue
    (``block_ln_gemm``) alone at stage 0's and stage 1's rows, each within
    one bf16 step of its plain bf16 version, with controls that must fail
    (the residual left out, GELU skipped on one chunk, LN2's gamma ignored;
    LN1's gamma or beta ignored), the training forms' outputs equal to the
    serving forms' and their saves beside the plain ones; times beside the
    byte floor and the bound. Data from generators of their own (the phase's
    other data stay as their gates were set on)."""
    name, dh = "mssit-kernels", MSSIT_DH
    from surface_vision_transformers_tpu_torch.ops import _native

    lib = _native.library()
    routes = {(d, t_): (bool(lib.svt_block_fused_mlp(d, 4 * d, int(t_))),
                        fb.fuses_mlp(d, 4 * d, train=t_))
              for d in (96, 192, 384, 768) for t_ in (False, True)}
    phase(name, "the fused chain's route (svt_block_fused_mlp, fuses_mlp), by (dim, training): "
          + ", ".join(f"{k} {v[0]} / {v[1]}" for k, v in routes.items()))
    if any(a_ != b_ for a_, b_ in routes.values()):
        failures.append("svt_block_fused_mlp disagrees with fuses_mlp")
    frng = np.random.default_rng(SEED + 261)
    fg = torch.Generator(device="cuda").manual_seed(SEED + 261)
    for stage, M, dim, heads in MSSIT_FUSED_CASES:
        mlp, hd = 4 * dim, heads * dh
        p32 = [t.cuda() for t in block_params(frng, dim, heads, mlp, dh)]
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous() for t in p32]
        x = dev_randn(fg, (M, dim))
        args, args32 = pb[5:], p32[5:]
        train = fb.fuses_mlp(dim, mlp, train=True)  # the training form: dim 96
        with torch.inference_mode():
            got = fb.block_mlp(x, *args)
            got_t, sv = fb.block_mlp(x, *args, train=True) if train else (got, {})
            ref, ref32 = mlp_plain(fb, x, *args), mlp_plain(fb, x.float(), *args32)
            svr = {}
            fb.mlp_reference(x, *args, saved=svr)
            controls = {"residual left out": mlp_plain(fb, x, *args, residual=False),
                        "GELU skipped on chunk 1": mlp_plain(fb, x, *args, gelu_skip=1),
                        "LN2's gamma ignored": mlp_plain(fb, x, *args, gamma=False)}
        m_, ok = gemm_gate(got, ref, False)
        ctl = {k: gemm_gate(got, v, False) for k, v in controls.items()}
        label = f"fused MLP stage {stage} M={M} dim {dim}"
        saves = {k: gemm_gate(sv[k], svr[k], k in ("fpre", "stats2"))[0] for k in sv}
        same = bool(torch.equal(got, got_t))
        if not ok or not same:
            failures.append(label)
        failures += [f"{label}: control {k} passed" for k, (_, c_ok) in ctl.items() if c_ok]
        with torch.inference_mode():
            ms = cuda_ms(lambda: fb.block_mlp(x, *args), reps=10)
            ms_t = cuda_ms(lambda: fb.block_mlp(x, *args, train=True), reps=10) if train else 0.
            plain_ms = cuda_ms(lambda: fb.mlp_reference(x, *args), reps=3)
        floor = (nbytes_of(x, *args) + x.numel() * 2) / PEAK_BYTES * 1e3
        b_ms, b_by = bound_ms(4 * M * dim * mlp, nbytes_of(x, *args) + x.numel() * 2)
        phase(name, f"{label}: {m_:.4g} bf16 steps from the plain bf16 version (gate 1), "
              f"{gemm_gate(got, ref32, False)[0]:.4g} from fp32 plain, share equal to plain "
              f"bf16 {(got == ref).float().mean().item():.6f}; controls (must exceed 1): "
              + ", ".join(f"{k} {v[0]:.4g}" for k, v in ctl.items())
              + (f"; training form: out equal {same}, saves vs plain (bf16 steps; fpre, stats2 "
                 "rel): " + ", ".join(f"{k} {v:.3g}" for k, v in saves.items())
                 + f", {ms_t:.4f} ms" if train else "; no training form at this width")
              + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"byte floor {floor:.4f} ms ({floor / ms:.1%}), bound {b_ms:.4f} ms by {b_by} "
              f"({b_ms / ms:.1%})")
        MSSIT_RECORDS[label] = (ms, None, b_ms)
        if stage == 0:
            rows["fused_mlp dh32"] = {
                "name": "fused_mlp dh32", "route": "cuda", "source": FUSED_SOURCE,
                "replaces": REPLACES["fused_block"],
                "max_abs_err": (got.float() - ref32.float()).abs().max().item(), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del got, got_t, sv, svr, ref, ref32, controls
        # the qkv product with LN1 in its prologue
        ln_s, ln_b, w = pb[0], pb[1], pb[2]
        with torch.inference_mode():
            got = fb.block_ln_gemm(x, ln_s, ln_b, w)
            got_t, h_t, st_t = fb.block_ln_gemm(x, ln_s, ln_b, w, train=True)  # any width
            ref, h_r, st_r = fb.ln_gemm_reference(x, ln_s, ln_b, w)
            ref32 = fb.ln_gemm_reference(x.float(), p32[0], p32[1], p32[2])[0]
            controls = {"LN1's gamma ignored": fb.ln_gemm_reference(
                            x, torch.ones_like(ln_s), ln_b, w)[0],
                        "LN1's beta ignored": fb.ln_gemm_reference(
                            x, ln_s, torch.zeros_like(ln_b), w)[0]}
        m_, ok = gemm_gate(got, ref, False)
        ctl = {k: gemm_gate(got, v, False) for k, v in controls.items()}
        same = bool(torch.equal(got, got_t))
        label = f"LN1 + qkv stage {stage} M={M} N={3 * hd} K={dim}"
        if not ok or not same:
            failures.append(label)
        failures += [f"{label}: control {k} passed" for k, (_, c_ok) in ctl.items() if c_ok]
        with torch.inference_mode():
            ms = cuda_ms(lambda: fb.block_ln_gemm(x, ln_s, ln_b, w), reps=10)
            plain_ms = cuda_ms(lambda: fb.ln_gemm_reference(x, ln_s, ln_b, w), reps=3)
        out_bytes = M * 3 * hd * 2
        floor = (nbytes_of(x, ln_s, ln_b, w) + out_bytes) / PEAK_BYTES * 1e3
        b_ms, b_by = bound_ms(2 * M * dim * 3 * hd, nbytes_of(x, ln_s, ln_b, w) + out_bytes)
        phase(name, f"{label}: {m_:.4g} bf16 steps from the plain bf16 version (gate 1), "
              f"{gemm_gate(got, ref32, False)[0]:.4g} from fp32 plain, share equal to plain "
              f"bf16 {(got == ref).float().mean().item():.6f}; controls (must exceed 1): "
              + ", ".join(f"{k} {v[0]:.4g}" for k, v in ctl.items())
              + f"; training form: out equal {same}, h1 share equal "
              f"{(h_t == h_r).float().mean().item():.6f}, stats max |diff| "
              f"{(st_t - st_r).abs().max().item():.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, byte floor {floor:.4f} ms ({floor / ms:.1%}), bound {b_ms:.4f} ms by {b_by} "
              f"({b_ms / ms:.1%})")
        MSSIT_RECORDS[label] = (ms, None, b_ms)
        if stage == 0:
            rows["ln_qkv dh32"] = {
                "name": "ln_qkv dh32", "route": "cuda", "source": GEMM_SOURCE,
                "replaces": REPLACES["fused_block"],
                "max_abs_err": (got.float() - ref32.float()).abs().max().item(), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del x, got, got_t, h_t, st_t, ref, h_r, st_r, ref32, controls, p32, pb
        torch.cuda.empty_cache()


def phase_fwd_pack_edges(fa, failures) -> None:
    """Phase 26's part for the resident attention forward at its packing
    edges (MSSIT_FWD_PACK_EDGES): against the fp32 and bf16 plain versions
    under the phase's gate, with controls (the dh-64 scale, the key mask
    ignored, the block-diagonal mask ignored) that must fail; device times
    beside SDPA's (with the key mask). Data from a generator of its own."""
    name, dh = "mssit-kernels", MSSIT_DH
    g = torch.Generator(device="cuda").manual_seed(SEED + 262)
    for Bf, heads, N, vl in MSSIT_FWD_PACK_EDGES:
        hd, pack = heads * dh, fa.fwd_pack(N)
        qkv = torch.cat([dev_randn(g, (Bf, N, 2 * hd), 1.5), dev_randn(g, (Bf, N, hd))], -1)
        with torch.inference_mode():
            o, lse = fa.flash_attention_qkv_fwd(qkv, heads, vl)
            o = o.float()

            def plain(dtype, n_valid=vl, scale=1.0):
                def one(x_):
                    x_ = x_.to(dtype) if dtype is not None else x_
                    if scale != 1.0:
                        x_ = torch.cat([x_[..., :hd] * scale, x_[..., hd:]], -1)
                    return fa.flash_attention_qkv_reference(x_, heads, n_valid)[0].float()
                return sliced(one, qkv, chunk=mssit_chunk(N, hd, heads))

            ref32, ref_bf = plain(torch.float32), plain(None)
            controls = {"dh-64 scale 1/8": plain(torch.float32, scale=MSSIT_SCALE_64),
                        "key mask ignored": plain(torch.float32, N),
                        "block-diagonal mask ignored": fwd_mask_ignored(fa, qkv, heads, pack, vl)}
        ratio, ctl = mssit_gate(o, ref32, ref_bf, controls)
        label = (f"attention forward dh 32 packing edge Bf={Bf} H={heads} N={N} valid_len={vl} "
                 f"({pack} sequences a unit)")
        if not ratio <= 1:
            failures.append(label)
        if any(v <= 1 for v in ctl.values()):
            failures.append(f"{label}: a control passed the gate")
        q, k, v = fa.split_qkv(qkv, heads)
        mask = (torch.arange(N, device="cuda") < vl).view(1, 1, 1, N)
        with torch.inference_mode():
            ms = device_ms(lambda: fa.flash_attention_qkv_fwd(qkv, heads, vl))
            sdpa = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        b_ms, b_by = bound_ms(attention_flops(Bf, heads, N, vl, dh)[0],
                              nbytes_of(qkv) + o.numel() * 2 + lse.numel() * 4)
        phase(name, f"{label}: worst |err|/bound vs fp32 and bf16 plain {ratio:.4g}; controls "
              "(must exceed 1): " + ", ".join(f"{k_} {v_:.4g}" for k_, v_ in ctl.items())
              + f"; kernel {ms:.4f} ms, SDPA (key mask) {sdpa:.4f} ms ({ms / sdpa:.3f}x), bound "
              f"{b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%}) (device_ms)")
        MSSIT_RECORDS[f"attention edge Bf={Bf} H={heads} N={N} valid_len={vl}"] = (ms, sdpa, b_ms)
        del qkv, o, lse, ref32, ref_bf, controls, q, k, v
        torch.cuda.empty_cache()


def phase_mssit_kernels(rng, fb) -> dict:
    """Phase 26: every kernel of the MS-SiT serving path at the shapes a
    batch of 64 gives it (MSSIT_FOLDS), against its float32 and bf16 plain
    versions (BOUND_STEPS bf16 steps at the largest output; fused_block_int8
    under phase 20's gates), with controls that must fail: the attention
    forward alone at dh 32 (and past 512 keys), fused_block at each fold,
    fused_block_int8 at stages 2 and 3, patch_embed at sub-ico 5, and stage
    0's four GEMMs alone (their ragged N and K edges) under phase 25's gate.
    Times by CUDA events beside the bound, SDPA at dh 32 for the attention
    (timed, never used). -> rows by kernel name (launches filled by phase
    27)."""
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa
    from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as fbi8
    from surface_vision_transformers_tpu_torch.ops import patch_embed as pe
    from surface_vision_transformers_tpu_torch.ops import quant

    failures, rows, dh = [], {}, MSSIT_DH
    name = "mssit-kernels"
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)

    def record(label, ok, ratio, controls):
        if not ok:
            failures.append(label)
        if any(v <= 1 for v in controls.values()):
            failures.append(f"{label}: a control passed the gate")

    # -- the attention forward at dh 32, alone, on the packed qkv as the chains hold it
    def att_plain(qkv, heads, vl, dtype, scale=1.0):
        hd = heads * dh

        def one(x):
            x = x.to(dtype) if dtype is not None else x
            if scale != 1.0:
                x = torch.cat([x[..., :hd] * scale, x[..., hd:]], -1)
            return fa.flash_attention_qkv_reference(x, heads, vl)[0].float()
        return sliced(one, qkv, chunk=mssit_chunk(qkv.shape[1], hd, heads))

    att_cases = [(Bf, heads, N, N) for _, Bf, N, _, heads, _ in MSSIT_FOLDS] + MSSIT_ATT_EDGES
    for Bf, heads, N, vl in att_cases:
        hd = heads * dh
        qkv = torch.cat([dev_randn(g, (Bf, N, 2 * hd), 1.5), dev_randn(g, (Bf, N, hd))], -1)
        o, lse = fa.flash_attention_qkv_fwd(qkv, heads, vl)
        o = o.float()
        ref32, ref_bf = att_plain(qkv, heads, vl, torch.float32), att_plain(qkv, heads, vl, None)
        controls = {"dh-64 scale 1/8": att_plain(qkv, heads, vl, torch.float32, MSSIT_SCALE_64)}
        if N == 320:
            controls["last K/V tile skipped"] = att_plain(qkv, heads, 256, torch.float32)
        if N > vl:
            controls["key mask ignored"] = att_plain(qkv, heads, N, torch.float32)
        ratio, ctl = mssit_gate(o, ref32, ref_bf, controls)
        label = f"attention forward dh 32 Bf={Bf} H={heads} N={N} valid_len={vl}"
        msg = (f"{label}: worst |err|/bound vs fp32 and bf16 plain {ratio:.4g} (bound "
               f"{BOUND_STEPS} bf16 steps), max abs err {(o - ref32).abs().max().item():.6g}; "
               "controls (must exceed 1): " + ", ".join(f"{k} {v:.4g}" for k, v in ctl.items()))
        record(label, ratio <= 1, ratio, ctl)
        if (Bf, heads, N, vl) in [(f[1], f[4], f[2], f[2]) for f in MSSIT_FOLDS]:
            q, k, v = fa.split_qkv(qkv, heads)
            with torch.inference_mode():
                ms = device_ms(lambda: fa.flash_attention_qkv_fwd(qkv, heads, vl))
                sdpa = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            flops = attention_flops(Bf, heads, N, N, dh)[0]
            b_ms, b_by = bound_ms(flops, nbytes_of(qkv) + o.numel() * 2 + lse.numel() * 4)
            msg += (f"; kernel {ms:.4f} ms, SDPA {sdpa:.4f} ms ({ms / sdpa:.3f}x), bound "
                    f"{b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%})")
            MSSIT_RECORDS[f"attention Bf={Bf} H={heads} N={N}"] = (ms, sdpa, b_ms)
            if (Bf, N, heads) == MSSIT_ROW_FOLD[1:3] + MSSIT_ROW_FOLD[4:5]:
                plain_ms = cuda_ms(lambda: att_plain(qkv, heads, vl, None), reps=3)
                msg += f", plain {plain_ms:.4f} ms"
                rows["flash_attention_fwd dh32"] = {
                    "name": "flash_attention_fwd dh32", "route": "cuda", "source": FLASH_SOURCE,
                    "replaces": f"{FLASH_TPU}:203", "max_abs_err": (o - ref32).abs().max().item(),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": sdpa}
        phase(name, msg + " (device_ms: ten calls queued behind a hold)")
        del qkv, o, lse, ref32, ref_bf, controls
        torch.cuda.empty_cache()

    # -- fused_block at dh 32, at every fold
    for stage, Bf, N, dim, heads, per_batch in MSSIT_FOLDS:
        mlp, hd = 4 * dim, heads * dh
        p32 = [t.cuda() for t in block_params(rng, dim, heads, mlp, dh)]
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous() for t in p32]
        kw = dict(heads=heads, dim_head=dh)
        x = dev_randn(g, (Bf, N, dim), X_SCALE)
        chunk = mssit_chunk(N, dim, heads)
        got = fb.fused_block(x, *pb, **kw).float()

        def plain(params, dtype=torch.float32, vl=N):
            return sliced(lambda xs: fb.fused_block_reference(
                xs.to(dtype) if dtype else xs, *params, valid_len=vl, **kw).float(), x,
                chunk=chunk)

        scaled = list(p32)
        scaled[2] = p32[2].clone()
        scaled[2][:hd] *= MSSIT_SCALE_64
        controls = {"dh-64 scale 1/8": plain(scaled)}
        if N == 320:
            controls["last K/V tile skipped"] = plain(p32, vl=256)
        ref32 = plain(p32)
        ratio, ctl = mssit_gate(got, ref32, plain(pb, None), controls)
        label = f"fused_block dh 32 stage {stage} ({Bf}, {N}, {dim})"
        record(label, ratio <= 1, ratio, ctl)
        with torch.inference_mode():
            ms = cuda_ms(lambda: fb.fused_block(x, *pb, **kw), reps=10)
        flops = block_flops(Bf, N, N, dim, heads, mlp, False, dh)[0]
        b_ms, b_by = bound_ms(flops, nbytes_of(x, *pb) + x.numel() * 2)
        floors = [chain_bytes(Bf, N, dim, heads, mlp, dh, fused_mlp=f_)[0] / PEAK_BYTES * 1e3
                  for f_ in (None, False)]
        phase(name, f"{label}, {per_batch} a batch: worst |err|/bound vs fp32 and bf16 plain "
              f"{ratio:.4g}, max abs err {(got - ref32).abs().max().item():.6g}; controls "
              "(must exceed 1): " + ", ".join(f"{k} {v:.4g}" for k, v in ctl.items())
              + f"; kernel {ms:.4f} ms (CUDA-event median of 10), bound {b_ms:.4f} ms by "
              f"{b_by} ({b_ms / ms:.1%}; {flops / 1e9:.1f} GFLOP), chain floor {floors[0]:.4f} "
              f"ms ({floors[0] / ms:.1%}; fused chain: {fb.fuses_mlp(dim, mlp)}; the seven "
              f"launches' {floors[1]:.4f} ms)")
        MSSIT_RECORDS[f"fused_block stage {stage} ({Bf}, {N}, {dim})"] = (ms, None, b_ms)
        if (stage, Bf, N) == MSSIT_ROW_FOLD[:3]:
            with torch.inference_mode():
                plain_ms = cuda_ms(lambda: plain(pb, None), reps=3)
            rows["fused_block dh32"] = {
                "name": "fused_block dh32", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES["fused_block"],
                "max_abs_err": (got - ref32).abs().max().item(), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del x, got, ref32, controls, p32, pb, scaled
        torch.cuda.empty_cache()

    # -- fused_block_int8 at dh 32, stages 2 and 3, under phase 20's gates
    for stage, Bf, N, dim, heads, per_batch in [f for f in MSSIT_FOLDS if f[3] >= 384]:
        mlp, hd = 4 * dim, heads * dh
        p8, _ = int8_block_params(rng, dim, heads, mlp, dh)
        kw = dict(heads=heads, dim_head=dh)
        x = dev_randn(g, (Bf, N, dim), X_SCALE)
        chunk = mssit_chunk(N, dim, heads)
        got = fbi8.fused_block_int8(x, *p8, **kw).float()

        def plain(params=p8, dtype=None):
            return sliced(lambda xs: fbi8.fused_block_int8_reference(
                xs.to(dtype) if dtype else xs, *params, **kw).float(), x, chunk=chunk)

        ref32, ref_bf = plain(dtype=torch.float32), plain()
        scaled = list(p8)
        scaled[3] = p8[3].clone()
        scaled[3][:hd] *= MSSIT_SCALE_64  # the q rows' dequantization scales
        cases = {"kernel": got, "plain bf16": ref_bf,
                 "control: dh-64 scale 1/8": plain(scaled, torch.float32)}
        if N > 64:
            with mock.patch.object(quant, "quant_rows", per_tensor_rows):
                cases["control: one scale per tensor"] = plain(dtype=torch.float32)
        else:
            cases["control: x1 rounded to bf16"] = sliced(
                lambda xs: int8_block_x1_rounded(fb, xs, p8, heads, N, dh).float(), x,
                chunk=chunk)

        def steps(a, r=ref32):
            return ((a - r).abs().max() / bf16_step(r.abs().max().item())).item()

        def rel(a, r=ref32):
            return (torch.linalg.vector_norm(a - r) / torch.linalg.vector_norm(r)).item()

        def share(a):
            return (a != ref_bf).float().mean().item()

        rel_bf = rel(ref_bf)

        def passes(a):
            return (bool(torch.isfinite(a).all()) and max(steps(a), steps(a, ref_bf)) <= INT8_STEPS
                    and rel(a) <= INT8_REL_RATIO * rel_bf and (N > 64 or share(a) <= INT8_SHARE))

        label = f"fused_block_int8 dh 32 stage {stage} ({Bf}, {N}, {dim})"
        for k_, a in cases.items():
            phase(name, f"{label}: {k_}: max |err| vs fp32 plain {steps(a):.3f} bf16 steps at the "
                  f"largest output, vs plain bf16 {steps(a, ref_bf):.3f}; rel-L2 vs fp32 plain "
                  f"{rel(a):.4g}; share of outputs differing from plain bf16 {share(a):.4f}")
        if not passes(got):
            failures.append(label)
        failures += [f"{label}: {k_} passed the gates" for k_, v in cases.items()
                     if k_.startswith("control") and passes(v)]
        with torch.inference_mode():
            ms = cuda_ms(lambda: fbi8.fused_block_int8(x, *p8, **kw), reps=10)
        g_ops, a_ops = int8_block_ops(Bf, N, N, dim, heads, mlp, dh)
        t_ops = (g_ops / PEAK_INT8 + a_ops / PEAK_FLOPS) * 1e3
        b_ms, b_by = max((t_ops, "operations"),
                         ((nbytes_of(x, *p8) + x.numel() * 2) / PEAK_BYTES * 1e3, "bytes"))
        phase(name, f"{label}, {per_batch} a batch: gates max {INT8_STEPS} bf16 steps vs both, "
              f"rel-L2 <= {INT8_REL_RATIO} x plain bf16's {rel_bf:.4g}"
              + (f", share <= {INT8_SHARE}" if N <= 64 else "")
              + f"; kernel {ms:.4f} ms (CUDA-event median of 10), bound {b_ms:.4f} ms by {b_by}")
        MSSIT_RECORDS[f"fused_block_int8 stage {stage} ({Bf}, {N}, {dim})"] = (ms, None, b_ms)
        if (stage, Bf, N) == MSSIT_INT8_ROW_FOLD[:3]:
            with torch.inference_mode():
                plain_ms = cuda_ms(lambda: plain(), reps=3)
            rows["fused_block_int8 dh32"] = {
                "name": "fused_block_int8 dh32", "route": "cuda", "source": INT8_SOURCE,
                "replaces": INT8_TPU, "max_abs_err": (got - ref32).abs().max().item(), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del x, got, ref32, ref_bf, cases, p8, scaled
        torch.cuda.empty_cache()

    # -- patch_embed at sub-ico 5: L = 20,480, V = 6, K = 24 (one 64-deep step), dim 96
    table = load_patch_table(6, 5).indices
    L, V = table.shape
    idx = pe.table_tensor(table, "cuda")
    B, dim = 64, 96
    x = torch.randn((B, 4, 40962), generator=g, device="cuda")
    bd = 1.0 / np.sqrt(4 * V)
    kern = torch.from_numpy(rng.uniform(-bd, bd, (4 * V, dim)).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.uniform(-bd, bd, dim).astype(np.float32)).cuda()
    w, b = pe.embed_matrix(kern, bias, V, means=rng.uniform(-1, 1, (1, 4, 1)).astype(np.float32),
                           stds=rng.uniform(0.5, 2, (1, 4, 1)).astype(np.float32))
    got = pe.patch_embed(x, idx, w, b).float()
    ref32 = pe.patch_embed_reference(x, idx, w.float(), b).float()
    ref_bf = pe.patch_embed_reference(x, idx, w, b).float()
    controls = {"table shifted by one patch": pe.patch_embed_reference(
                    x, idx.roll(1, 0), w, b).float(),
                "(c v) order": embed_plain_cv(x, idx, w, b).float()}
    ratio, ctl = mssit_gate(got, ref32, ref_bf, controls)
    label = f"patch_embed sub-ico 5 ({L} x {V}, K {4 * V} -> {w.shape[1]}) B={B} dim {dim}"
    record(label, ratio <= 1, ratio, ctl)
    flat, wt = idx.reshape(-1), w[:, :4 * V].t()

    def library():  # index_select + addmm: the library form
        t = x.index_select(2, flat).view(B, 4, L, V).permute(0, 2, 3, 1).reshape(B, L, 4 * V)
        return torch.addmm(b.bfloat16(), t.bfloat16().reshape(B * L, -1), wt)

    ms = cuda_ms(lambda: pe.patch_embed(x, idx, w, b))
    plain_ms = cuda_ms(lambda: pe.patch_embed_reference(x, idx, w, b), reps=5)
    lib_ms = cuda_ms(library)
    flops = 2 * B * L * 4 * V * dim
    b_ms, b_by = bound_ms(flops, nbytes_of(x, idx, w, b) + got.numel() * 2)
    phase(name, f"{label}: worst |err|/bound vs fp32 and bf16 plain {ratio:.4g}; controls "
          "(must exceed 1): " + ", ".join(f"{k} {v:.4g}" for k, v in ctl.items())
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select + addmm {lib_ms:.4f} "
          f"ms (CUDA-event medians of 25 / 5 / 25), bound {b_ms:.4f} ms by {b_by}")
    MSSIT_RECORDS["patch_embed sub-ico 5"] = (ms, lib_ms, b_ms)
    rows["patch_embed sub-ico 5"] = {
        "name": "patch_embed sub-ico 5", "route": "cuda", "source": EMBED_SOURCE,
        "replaces": EMBED_TPU, "max_abs_err": (got - ref32).abs().max().item(), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    del x, got, ref32, ref_bf, controls
    torch.cuda.empty_cache()

    # -- stage 0's four GEMMs alone: N 288 (qkv) and 96 (out, fc2) ragged against
    # the 192-column tiles, K 96 (qkv, out, fc1) half a 64-deep step past one
    M, dim, mlp = 64 * 20480, 96, 384
    for gname, N, K in (("qkv", 3 * dim, dim), ("out", dim, dim), ("fc1", mlp, dim),
                        ("fc2", dim, mlp)):
        a = dev_randn(g, (M, K))
        wg = torch.from_numpy(rng.uniform(-1, 1, (N, K)).astype(np.float32) / np.sqrt(K)).to(
            "cuda", torch.bfloat16)
        bias = torch.from_numpy((0.1 * rng.standard_normal(N)).astype(np.float32)).cuda()
        res = dev_randn(g, (M, N)) if gname in ("out", "fc2") else None
        bz = bias if gname != "qkv" else None

        def kernel(aa=a):
            return fb.block_gemm(aa, wg, bz, res, gelu=gname == "fc1")

        def plain(aa=a):
            return fb.gemm_reference(aa.float(), wg.float(), bz, res, gelu=gname == "fc1")

        cut = a.clone()
        drop = 32 if K == 96 else 64  # the last half step of K = 96, else the last step
        cut[:, K - drop:] = 0
        got, ref, ctl = kernel(), plain(), plain(cut)
        if gname == "fc1":
            measures = [gemm_gate(got[0], ref[0], False), gemm_gate(got[1], ref[1], True)]
            control = gemm_gate(got[0], ctl[0], False)
        else:
            measures, control = [gemm_gate(got, ref, False)], gemm_gate(got, ctl, False)
        ms = cuda_ms(kernel)
        lib_ms = cuda_ms(lambda: torch.mm(a, wg.t(), out_dtype=torch.float32))
        out_bytes = M * N * 2 + (M * N * 4 if gname == "fc1" else 0)
        nbytes = nbytes_of(a, wg, bias) + out_bytes + (nbytes_of(res) if res is not None else 0)
        b_ms, b_by = bound_ms(2 * M * N * K, nbytes)
        label = f"stage-0 GEMM {gname} M={M} N={N} K={K}"
        phase(name, f"{label}: " + ", ".join(f"{m:.4g}" for m, _ in measures)
              + f" (bf16 steps; fc1's fp32 pre-activation rel, gate {GEMM_FP32_REL}; gate 1 "
              f"bf16 step); control, the last {drop} of K dropped: {control[0]:.4g} (must fail); "
              f"kernel {ms:.4f} ms, torch.mm {lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
              f"({b_ms / ms:.1%})")
        if not all(ok for _, ok in measures):
            failures.append(label)
        if control[1]:
            failures.append(f"{label}: the control passed")
        MSSIT_RECORDS[label] = (ms, lib_ms, b_ms)
        del a, wg, res, got, ref, ctl, cut
        torch.cuda.empty_cache()
    phase_fused_chain_parts(fb, failures, rows)
    phase_fwd_pack_edges(fa, failures)
    if failures:
        raise AssertionError("MS-SiT kernels: " + "; ".join(failures))
    return rows


def mssit_models(rng):
    """(the shipped MS-SiT config, its canonical sub-ico-5 table, the bf16
    model with plain attention on the card (the kernel path ignores the
    attention backend), its float32 twin, the seeded state dict)."""
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.models.mssit import MSSiT
    from surface_vision_transformers_tpu_torch.utils import config

    exp = config.load_config(MSSIT_CFG)
    table = load_patch_table(exp.ico, exp.sub_ico).indices
    model = MSSiT.from_config(exp, patch_table=table, attn_backend="plain")
    state = mssit_state(rng, model)
    model.load_state_dict(state, strict=True)
    plain32 = MSSiT.from_config(exp, patch_table=table, attn_backend="plain",
                                dtype=torch.float32)
    plain32.load_state_dict(state, strict=True)
    return exp, table, model.eval().cuda(), plain32.eval().cuda(), state


def phase_mssit_slice(rng, fb, fused, models) -> dict:
    """Phase 27: ``predict`` of the MS-SiT at bs_val 64 on MSSIT_SLICE_N raw
    surfaces (the last batch padded), bf16 and int8: launches a batch (1
    patch_embed and 12 fused_block; int8: 1, 4 and 8 fused_block_int8),
    agreement with the eager bf16 model (plain attention, batches of
    MSSIT_EAGER_B) and, int8, with the float32 one, each with controls
    (block 5 dropped; stage 0's axial fold as the window fold); surfaces/s
    and peak memory at B=64 and 128. -> the launches of each run."""
    from surface_vision_transformers_tpu_torch.models import fused_mssit as fm

    exp, table, model, plain32, _ = models
    bs, n = exp.training.bs_val, MSSIT_SLICE_N
    n_batches = -(-n // bs)
    data = rng.standard_normal((n, 4, 40962)).astype(np.float32)
    runs = {}
    for label, q, want_blocks in (("bf16", None, {"fused_block": 12}),
                                  ("int8", "int8", {"fused_block": 4, "fused_block_int8": 8})):
        counters = zero_counts(fb)
        fused_counters = {"block_mlp": fb.block_mlp, "block_ln_gemm": fb.block_ln_gemm}
        for c_ in fused_counters.values():
            c_.launches = 0
        preds = fused.predict(model, data, device="cuda", batch_size=bs, quant=q)
        launches = read_counts(counters)
        fused_launches = read_counts(fused_counters)
        want = {k: 0 for k in counters}
        want["patch_embed"] = n_batches
        want.update({k: v * n_batches for k, v in want_blocks.items()})
        # stages 0-1 (dims 96, 192) run the fused chain: LN1 + qkv and the MLP half
        want_fused = {k: 4 * n_batches for k in fused_counters}
        phase("mssit-slice", f"predict({n} surfaces, batch {bs}, {label}): launches {launches}, "
              f"expected {want}; the fused chain's kernels {fused_launches}, expected "
              f"{want_fused}")
        if launches != want or fused_launches != want_fused:
            raise AssertionError(f"the MS-SiT {label} serving path did not launch as expected")
        launches.update(fused_launches)
        if preds.shape != (n, 1) or not np.isfinite(preds).all():
            raise AssertionError(f"bad MS-SiT predictions: shape {preds.shape}")
        runs[label] = (preds, launches)

    x = torch.from_numpy(data).cuda()
    with torch.inference_mode():
        eager = torch.cat([model(x[s:s + MSSIT_EAGER_B]) for s in range(0, n, MSSIT_EAGER_B)])
        ref32 = torch.cat([plain32(x[s:s + MSSIT_EAGER_B])
                           for s in range(0, n, MSSIT_EAGER_B)]).cpu().numpy()
        eager = eager.float().cpu().numpy()
        controls, controls8 = {}, {}
        for quant_, out in ((None, controls), ("int8", controls8)):
            w = fm.prepare_mssit_weights(model, quant_)
            block = "fused_block_int8" if quant_ else "fused_block"
            real, calls = getattr(fm, block), []

            def drop5(xx, *a, real=real, calls=calls, **k):  # the sixth block launched: stage 2's
                calls.append(1)
                return xx if len(calls) == (2 if quant_ else 6) else real(xx, *a, **k)

            with mock.patch.object(fm, block, drop5):
                out["block 5 dropped"] = fm.fused_mssit_forward(model, x[:bs], w, quant=quant_)
            real_plan = fm.stage_plan

            def window_only(m):
                plan = real_plan(m)
                plan[0] = dict(plan[0], mixes=["window"] * len(plan[0]["mixes"]))
                return plan

            with mock.patch.object(fm, "stage_plan", window_only):
                out["stage 0 axial fold as the window fold"] = fm.fused_mssit_forward(
                    model, x[:bs], w, quant=quant_)
            for k_ in out:
                out[k_] = out[k_].float().cpu().numpy()
    del x
    preds, preds8 = runs["bf16"][0], runs["int8"][0]
    err = float(np.abs(preds - eager).max())
    ctl = {k: float(np.abs(v - eager[:bs]).max()) for k, v in controls.items()}

    def rel(a, r):
        return float(np.linalg.norm(a - r) / np.linalg.norm(r))

    phase("mssit-slice", f"bf16 predictions |kernel - eager bf16| max {err:.6g} (tol "
          f"{MSSIT_SLICE_TOL}); vs fp32 eager: kernel {np.abs(preds - ref32).max():.6g} (rel-L2 "
          f"{rel(preds, ref32):.4g}), eager bf16 {np.abs(eager - ref32).max():.6g}; std across "
          f"surfaces {ref32.std():.4g}, mean {ref32.mean():.4g}; controls (must exceed the tol): "
          + ", ".join(f"{k} {v:.6g}" for k, v in ctl.items()))
    if err > MSSIT_SLICE_TOL:
        raise AssertionError("the MS-SiT kernel path disagrees with the eager bf16 model")
    if min(ctl.values()) <= MSSIT_SLICE_TOL:
        raise AssertionError("an MS-SiT slice control passed the gate")
    r8 = rel(preds8, ref32)
    ctl8 = {k: rel(v, ref32[:bs]) for k, v in controls8.items()}
    phase("mssit-slice", f"int8 predictions vs the fp32 eager model: rel-L2 {r8:.4g} (tol "
          f"{MSSIT_INT8_REL}), max |gap| {np.abs(preds8 - ref32).max():.6g}; bf16 rel-L2 "
          f"{rel(preds, ref32):.4g}; int8 vs bf16 max |gap| {np.abs(preds8 - preds).max():.6g}; "
          "controls (rel-L2, must exceed the tol): "
          + ", ".join(f"{k} {v:.4g}" for k, v in ctl8.items()))
    if not np.isfinite(preds8).all() or r8 > MSSIT_INT8_REL:
        raise AssertionError("the MS-SiT int8 path disagrees with the fp32 model")
    if min(ctl8.values()) <= MSSIT_INT8_REL:
        raise AssertionError("an MS-SiT int8 control passed the gate")

    w16, w8 = fm.prepare_mssit_weights(model), fm.prepare_mssit_weights(model, "int8")
    with torch.inference_mode():
        for B in (64, 128):
            xb = torch.from_numpy(rng.standard_normal((B, 4, 40962)).astype(np.float32)).to(
                "cuda", torch.bfloat16)
            res = {}
            for label, w, q in (("bf16", w16, None), ("int8", w8, "int8")):
                torch.cuda.reset_peak_memory_stats()
                t = cuda_ms(lambda: fm.fused_mssit_forward(model, xb, w, quant=q), reps=5)
                res[label] = (t, torch.cuda.max_memory_allocated() / 2**30)
            if B == 64:
                torch.cuda.reset_peak_memory_stats()
                t = cuda_ms(lambda: torch.cat([model(xb[s:s + MSSIT_EAGER_B])
                                               for s in range(0, B, MSSIT_EAGER_B)]), reps=3)
                res[f"eager bf16 (plain attention, batches of {MSSIT_EAGER_B})"] = (
                    t, torch.cuda.max_memory_allocated() / 2**30)
            phase("mssit-slice", f"B={B} raw bf16 input on device: " + ", ".join(
                f"{k} {t:.3f} ms = {B / t * 1e3:.1f} surfaces/s (peak {g:.2f} GiB allocated)"
                for k, (t, g) in res.items())
                + f"; int8/bf16 rate {res['bf16'][0] / res['int8'][0]:.3f} (CUDA-event medians "
                "of 5, eager 3)")
            del xb
    del w16, w8
    torch.cuda.empty_cache()
    return {k: v[1] for k, v in runs.items()}


def phase_mssit_entry(fb, fused, models) -> None:
    """Phase 28: ``cli.test`` on ``configs/training/mssit_scan_age.yml`` (a
    synthetic npy split of MSSIT_ENTRY_N raw surfaces, a params npz written
    from the port's weights), in a subprocess, bf16 and ``--set
    tpu.quant=int8``: results.csv equal to in-process ``predict`` bit for
    bit; then ``--set tpu.compute_dtype=float32`` in process: the modular
    model, no kernel launches, results.csv equal to float32 ``predict`` bit
    for bit."""
    from surface_vision_transformers_tpu_torch.checkpoints.convert import (
        jax_params_from_mssit_state_dict,
    )
    from surface_vision_transformers_tpu_torch.train.runner import build_model, load_state_dict_any
    from surface_vision_transformers_tpu_torch.utils import config

    exp, table, model, _, state = models
    rng = np.random.default_rng(SEED + 5)
    n, bs = MSSIT_ENTRY_N, exp.training.bs_val
    sub = rng.standard_normal((n, 4, 40962)).astype(np.float32)
    labels = rng.uniform(30, 45, n).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.save(tmp / "validation_data.npy", sub)
        np.save(tmp / "validation_labels.npy", labels)
        tree = jax_params_from_mssit_state_dict(state, model)
        np.savez(tmp / "best_params.npz", **flatten({"params": tree}))
        raw = config.read_config_file(MSSIT_CFG)
        raw["data"] = {"data_path": str(tmp), "split": "validation"}
        raw["testing"] = {"path_to_ckpt": str(tmp / "best_params.npz")}
        (tmp / "cfg.json").write_text(json.dumps(raw))

        def csv_preds():
            with open(tmp / "results.csv") as f:
                rows = list(csv.DictReader(f))
            targets = np.array([float(r["target"]) for r in rows], np.float32)
            if len(rows) != n or not np.array_equal(targets, labels):
                raise AssertionError(f"results.csv: {len(rows)} rows, targets out of order")
            return np.array([float(r["pred"]) for r in rows], np.float32)

        for label, extra, q in (("bf16", [], None), ("int8", ["--set", "tpu.quant=int8"], "int8")):
            cmd = [sys.executable, "-m", "surface_vision_transformers_tpu_torch.cli.test",
                   str(tmp / "cfg.json"), "--device", "cuda", *extra]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            if res.returncode:
                raise AssertionError(f"cli.test ({label}) failed ({res.returncode}):\n{res.stderr}")
            reported = ast.literal_eval(res.stdout.strip().splitlines()[-1])
            got = csv_preds()
            same = fused.predict(model, sub, device="cuda", batch_size=bs, quant=q).reshape(-1)
            err = float(np.abs(got - same).max())
            shifted = float(np.abs(got - np.roll(same, 1)).max())
            mae = float(np.abs(got - labels).mean())
            phase("mssit-entry", f"cli.test {MSSIT_CFG.relative_to(ROOT)} ({label}) in "
                  f"{time.perf_counter() - t0:.1f} s: {reported}; |results.csv - predict(batch "
                  f"{bs}{', int8' if q else ''})| max {err:.6g} (must be 0; control, rows shifted "
                  f"by one: {shifted:.6g}); MAE of the csv {mae:.6f}")
            if err != 0 or shifted == 0 or abs(reported["mae"] - mae) > 1e-6:
                raise AssertionError(f"MS-SiT cli.test ({label}) disagrees with predict")

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
        got = csv_preds()
        exp32 = config.from_dict(dict(raw, tpu={"compute_dtype": "float32"}))
        model32 = build_model(exp32, table)
        model32.load_state_dict(load_state_dict_any(str(tmp / "best_params.npz"), 0), strict=True)
        same = fused.predict(model32.eval(), sub, device="cuda", batch_size=bs).reshape(-1)
        err = float(np.abs(got - same).max())
        shifted = float(np.abs(got - np.roll(same, 1)).max())
        want = {k: 0 for k in counters}
        phase("mssit-entry", f"cli.test --set tpu.compute_dtype=float32 --device cuda in "
              f"{secs:.1f} s: {reported}; launches {launches}, expected {want}; |results.csv - "
              f"float32 predict| max {err:.6g} (must be 0; control, rows shifted by one: "
              f"{shifted:.6g})")
        if launches != want or err != 0 or shifted == 0:
            raise AssertionError("float32 MS-SiT cli.test disagrees with float32 predict")
        del model32
    torch.cuda.empty_cache()



# Phases 29-32: MS-SiT training and MPP at mssit_scan_age.yml / mssit_mpp.yml (dh 32).
# Phase 29's cases beyond the folds: valid_len inside a key block (the
# backward's key mask and its query rows past valid_len; the third past 320
# keys, where the streamed kernels take dh 32; the last in a packed tile,
# three sequences of 20 rows, each masked from row 15), and the folds with
# five key blocks, where the bitwise repeat's order control can show that the dQ
# sum's order reaches dq's bits.
MSSIT_BWD_EDGES = [(256, 6, 80, 70), (64, 3, 320, 300), (32, 3, 400, 390),
                   (4096, 12, 20, 15)]
MSSIT_REPEAT_FOLDS = [(4096, 3, 320), (64, 24, 320)]  # (sequences, heads, N)
MSSIT_BWD_RECORDS: dict = {}  # this run's dh-32 backward times for the records line
MSSIT_BUSY_SHAPE = (64, 24, 320)  # (B, H, N): stage 3's fold, 1,536 resident CTAs
LN_SUM_REL = 1e-3  # the LayerNorm epilogue's column sums (up to 1.3 M rows, another order)
# The LayerNorm epilogue alone (M, dim, K of LN2's product, K of LN1's: 3 hd):
# stage 0's axial fold, stage 1's window fold (dh 32), SiT-tiny at B = 256.
LN_EPILOGUE_CASES = [(4096 * 320, 96, 384, 288), (5120 * 64, 192, 768, 576),
                     (256 * N_TOKENS, 192, 768, 576)]


def packed_mask_ignored(fa, qkv, do, heads, pack, vl):
    """(o, dqkv) of the float32 plain versions with each packed tile's
    sequences merged into one (``pack`` consecutive heads of a sample, the
    resident backward's units), so that they see each other's keys: the
    block-diagonal mask ignored, the key mask kept (a control). The merged
    sequence takes each sequence's first ``vl`` rows first, so that its own
    valid_len, pack * vl, masks the rest."""
    Bf, N, F_ = qkv.shape
    dh = F_ // (3 * heads)
    idx = torch.arange(pack * N, device=qkv.device).view(pack, N)
    order = torch.cat([idx[:, :vl].reshape(-1), idx[:, vl:].reshape(-1)])
    q, k, v = (t.float().reshape(Bf, heads // pack, pack * N, dh)[:, :, order]
               for t in fa.split_qkv(qkv, heads))
    do4 = do.float().view(Bf, N, heads, dh).transpose(1, 2).reshape(
        Bf, heads // pack, pack * N, dh)[:, :, order]
    o, lse = fa.flash_attention_reference(q, k, v, pack * vl)
    grads = fa.flash_attention_bwd_reference(q, k, v, o, lse, do4, pack * vl)
    inv = torch.argsort(order)
    back = [fa.merge_heads(t[:, :, inv].reshape(Bf, heads, N, dh)) for t in (o, *grads)]
    return [back[0], torch.cat(back[1:], -1)]


def ln_epilogue_gates(fb, g, name) -> None:
    """The LayerNorm backward in dh's product's epilogue alone
    (``block_gemm_ln``, both forms) against its plain version
    (``gemm_ln_reference``) at LN_EPILOGUE_CASES: bf16 out within one bf16
    step of the largest |out| (phase 25's rule), fp32 out within
    GEMM_FP32_REL, the column sums within LN_SUM_REL of the largest |sum|;
    a control with the residual left out must fail; times beside the dh
    product alone (``block_gemm_nn``, fp32 C, as the chain with a
    standalone LayerNorm pass runs it) and the epilogue's byte floor."""
    for M, dim, k2, k1 in LN_EPILOGUE_CASES:
        x = dev_randn(g, (M, dim))
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        stats = torch.cat([mu, torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + 1e-5)],
                          -1).contiguous()
        del xf, mu
        gamma = (1 + 0.1 * torch.randn(dim, device="cuda", generator=g)).contiguous()
        for ln, K in ((2, k2), (1, k1)):
            a = dev_randn(g, (M, K), 0.05)
            w = dev_randn(g, (K, dim), K ** -0.5)
            res = (dev_randn(g, (M, dim), 0.5) if ln == 2
                   else 0.5 * torch.randn(M, dim, device="cuda", generator=g))
            got = fb.block_gemm_ln(a, w, x, stats, gamma, res)
            ref = fb.gemm_ln_reference(a, w, x, stats, gamma, res)
            m_b, ok_b = gemm_gate(got[1], ref[1], False)
            m_f, ok_f = gemm_gate(got[0], ref[0], True) if ln == 2 else (0.0, True)
            m_s = ((got[2] - ref[2]).abs().max() / ref[2].abs().max()).item()
            control = gemm_gate(got[1], fb.gemm_ln_reference(
                a, w, x, stats, gamma, torch.zeros_like(res))[1], False)
            ms = device_ms(lambda: fb.block_gemm_ln(a, w, x, stats, gamma, res))
            dh_ms = device_ms(lambda: fb.block_gemm_nn(a, w, out_dtype=torch.float32))
            nbytes = nbytes_of(a, w, x, stats, gamma, res, *(t for t in got if t is not None))
            label = f"LayerNorm epilogue LN{ln} M={M} dim={dim} K={K}"
            msg = (f"{label}: bf16 out {m_b:.4g} bf16 steps (tol 1), fp32 out {m_f:.3g} "
                   f"(tol {GEMM_FP32_REL}), column sums {m_s:.3g} (tol {LN_SUM_REL}); control, "
                   f"the residual left out: {control[0]:.4g} bf16 steps (must exceed 1); "
                   f"{ms:.4f} ms (device_ms), the dh product alone with fp32 C {dh_ms:.4f} ms; "
                   f"byte floor {nbytes / PEAK_BYTES * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB)")
            phase(name, msg)
            if not (ok_b and ok_f and math.isfinite(m_s) and m_s <= LN_SUM_REL):
                raise AssertionError(f"{label} disagrees with its plain version")
            if control[1]:
                raise AssertionError(f"{label}: the control passed the gate")
            del a, w, res, got, ref
        del x, stats
        torch.cuda.empty_cache()


def mssit_qkv_plain(fa, qkv, do, heads, vl, dtype=None, scale=1.0):
    """(o, dqkv) of the packed plain versions (``qkv_plain`` at MS-SiT's
    heads, any dh) in ``dtype`` (None: the inputs' bf16), q scaled by
    ``scale`` (a control), sliced by ``mssit_chunk``."""
    hd = qkv.shape[-1] // 3

    def one(x, g):
        if dtype is not None:
            x, g = x.to(dtype), g.to(dtype)
        if scale != 1.0:
            x = torch.cat([x[..., :hd] * scale, x[..., hd:]], -1)
        o, lse = fa.flash_attention_qkv_reference(x, heads, vl)
        return o.float(), fa.flash_attention_qkv_bwd_reference(x, o, lse, g, heads, vl).float()

    chunk = mssit_chunk(qkv.shape[1], hd, heads)
    parts = [one(qkv[s:s + chunk], do[s:s + chunk]) for s in range(0, qkv.shape[0], chunk)]
    return [torch.cat(p) for p in zip(*parts)]


# The block backward's launches as torch.profiler names them -> a part's name.
_PART_KINDS = (("gemm_kernel", None), ("reduce_kernel", "reduce"),
               ("reduce_chunks_kernel", "reduce"), ("reduce_sums_kernel", "reduce"),
               ("ln_bwd_kernel", "LN bwd"),
               ("flash_bwd_resident", "attention bwd (resident)"),
               ("flash_bwd_few", "attention bwd (few queries)"),
               ("flash_bwd_delta", "attention delta"), ("flash_bwd_dq", "attention dq pass"),
               ("flash_bwd_kernel", "attention main pass"))
# the dX products by epilogue, and the weight gradients in chain order
_DX_NAMES = {"B_GELU_GRAD": "df1 = g W_fc2 * GELU'", "B_F32": "dh (fp32)",
             "B_BF16": "da = dx1 W_out", "B_LN2": "dh = df1 W_fc1 + LN2 bwd (epilogue)",
             "B_LN1": "dh = dqkv W_qkv + LN1 bwd (epilogue)", "B_ADD_F32": "dh += dq W_q",
             "B_LN1_TOP": "dh = dkv W_kv + dq W_q + LN1 bwd (epilogue)"}
_DW_NAMES = ("dW_fc2", "dW_fc1", "dW_out", "dW_qkv")
CLS_DW_NAMES = ("dW_fc2", "dW_fc1", "dW_out", "dW_q", "dW_kv")  # the CLS chain's


def chain_parts(call, reps: int = 3, dw_names=_DW_NAMES, epis=GEMM_EPIS) -> list:
    """torch.profiler over ``reps`` calls of ``call`` (one block backward),
    one call a profiler session, after a warm-up call and a session that
    takes whatever an earlier session left: each part's device time in
    chain order, the mean over the sessions that saw the same launches ->
    [(part, ms)], or [] when no two did. A part is one launch of the
    chain's kernels from its first weight gradient on (other device work
    is left out), or a run of reduce launches (the sums after one product);
    parts are named by kernel and epilogue (``epis``: this tree's GEMM_EPIS,
    or ``gemm_epis`` of the checkout whose kernels run), the weight
    gradients (B_PART) in chain order (``dw_names``: CLS_DW_NAMES for
    ``fused_block_cls_bwd``)."""
    from torch.autograd import DeviceType

    def session(fn):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and any(key in e.name for key, _ in _PART_KINDS)),
                    key=lambda e: e.time_range.start)
        first = next((i for i, e in enumerate(ev) if "gemm_kernel" in e.name
                      and re.search(r"gemm_kernel<[^>]*?(\d+)>", e.name)[1]
                      == str(epis.index("B_PART"))), len(ev))
        return [(e.name, e.time_range.elapsed_us() / 1e3) for e in ev[first:]]

    call()
    torch.cuda.synchronize()
    session(lambda: torch.zeros(1, device="cuda").add_(1))
    runs = [session(call) for _ in range(reps)]
    names = [tuple(n for n, _ in r) for r in runs]
    common = max(set(names), key=names.count)
    runs = [r for r, n in zip(runs, names) if n == common]
    if len(runs) < 2 or not common:
        return []
    parts, dw = [], 0
    for i, name in enumerate(common):
        label = next((lab for key, lab in _PART_KINDS if key in name), name[:40])
        if label is None:  # a GEMM: its epilogue from the template's last argument
            epi = epis[int(re.search(r"gemm_kernel<[^>]*?(\d+)>", name)[1])]
            if epi == "B_PART":
                label = f"{dw_names[min(dw, len(dw_names) - 1)]} (split-K)"
                dw += 1
            else:
                label = _DX_NAMES.get(epi, epi)
        ms = sum(r[i][1] for r in runs) / len(runs)
        if label == "reduce" and parts and parts[-1][0].startswith("reduce"):
            parts[-1] = (parts[-1][0], parts[-1][1] + ms, parts[-1][2] + 1)
        else:
            parts.append((f"reduce after {parts[-1][0].split(' (')[0]}" if label == "reduce"
                          else label, ms, 1))
    return [(f"{p} x{c}" if c > 1 else p, ms) for p, ms, c in parts]


def part_floors(parts, B, N, dim, heads, mlp, dh=DH) -> list:
    """The byte floor of each part of ``chain_parts`` (a fused_block_bwd at
    these shapes), in ms at PEAK_BYTES: what the part reads and writes, each
    once (a split-K product's partials, and the sums a reduce reads, are
    its own bytes); None for the streamed attention's main and dq passes,
    whose workspace traffic depends on the walk."""
    from surface_vision_transformers_tpu_torch.ops import fused_block as fb

    M, hd, f4 = B * N, heads * dh, 4
    x, hid, qkv, att, stats = M * dim * 2, M * mlp * 2, M * 3 * hd * 2, M * hd * 2, M * 2 * f4
    lse = B * heads * N * f4
    ln_rows = -(-M // 128) if not fb.ln_in_epilogue(dim) else min(-(-M // 128), 132)
    ln_ctas = min(fb._cdiv(fb._cdiv(M, 2), fb._LNB_WARPS), fb._LNB_CTAS)  # ln_bwd_ctas
    dw = {"dW_fc2": (x, hid, dim, mlp), "dW_fc1": (hid, x, mlp, dim), "dW_out": (x, att, dim, hd),
          "dW_qkv": (qkv, x, 3 * hd, dim)}
    seen, out, last = {}, [], None
    for label, _ in parts:
        base = label.split(" x")[0]
        k = seen[base] = seen.get(base, 0) + 1
        name = base.split(" (")[0]
        if name in dw:
            a, b, mo, no = dw[name]
            last = fb._split_k(mo, no, M) * mo * no * f4
            nb = a + b + last
        elif base.startswith("reduce after dW"):
            nb = last + dw[base.split("after ")[1]][2] * dw[base.split("after ")[1]][3] * f4
        elif base.startswith("df1"):
            last = -(-M // 128) * mlp * f4
            nb = x + 2 * hid + hid + last
        elif base.startswith("reduce after df1"):
            nb = last + mlp * f4
        elif base.startswith("dh = df1"):
            last = ln_rows * 4 * dim * f4
            nb = hid + x + x + stats + 2 * x + x + last
        elif base.startswith("dh = dqkv"):
            last = ln_rows * 2 * dim * f4
            nb = qkv + x + stats + 2 * x + x + last
        elif base.startswith("reduce after dh = "):
            nb = last + last // ln_rows
        elif base == "dh (fp32)":
            nb = (hid if k == 1 else qkv) + 2 * x
        elif base == "LN bwd":  # LN2 then LN1
            nsum = 4 if k == 1 else 2
            last = ln_ctas * nsum * dim * f4
            nb = 2 * x + x + stats + (x + 2 * x + x if k == 1 else 2 * x + x) + last
        elif base == "reduce after LN bwd":
            nb = last + last // ln_ctas
        elif base.startswith("da ="):
            nb = x + att
        elif base == "attention bwd (resident)":
            nb = qkv + att + att + lse + qkv
        elif base == "attention delta":
            nb = att + att + lse
        else:
            nb = None
        out.append(None if nb is None else nb / PEAK_BYTES * 1e3)
    return out


def _cls_sizes(B, N, dim, heads, mlp, rows=8):
    """Bytes of the CLS backward's tensors: every row's (x, kv, x's fp32
    width, LN stats) and the B * rows top rows' (x, hidden, attention width,
    LN stats, lse)."""
    M, Mt, hd = B * N, B * rows, heads * DH
    return dict(x=M * dim * 2, kv=M * 2 * hd * 2, xf=M * dim * 4, st=M * 8, xt=Mt * dim * 2,
                ht=Mt * mlp * 2, at=Mt * hd * 2, stt=Mt * 8, lse=B * heads * rows * 4)


def cls_part_floors(parts, B, N, dim, heads, mlp, rows=8) -> list:
    """``part_floors`` for the parts of ``fused_block_cls_bwd`` (``chain_parts``
    with ``CLS_DW_NAMES``): the MLP branch, dW_out, da and dW_q over the B *
    rows top rows, the attention over rows queries and N keys, dW_kv and
    LN1 over every row. An fp32 dh B_F32 writes is LN2's (past dim 192, the
    top rows), the top rows' dq W_q share (before the product that adds it:
    the LN1 epilogue B_LN1_TOP, or past dim 192 dkv W_kv's B_F32) or dkv
    W_kv's over every row (which, in the earlier chain, dh += dq W_q then
    read and wrote on the top rows); None for the streamed attention's main
    and dq passes."""
    from surface_vision_transformers_tpu_torch.ops import fused_block as fb

    s = _cls_sizes(B, N, dim, heads, mlp, rows)
    M, Mt, hd, f4 = B * N, B * rows, heads * DH, 4
    xt, ht, at = s["xt"], s["ht"], s["at"]
    ln_rows = min(-(-M // 128), 132)
    ln_ctas = min(fb._cdiv(fb._cdiv(M, 2), fb._LNB_WARPS), fb._LNB_CTAS)
    ln_ctas_t = min(fb._cdiv(fb._cdiv(Mt, 2), fb._LNB_WARPS), fb._LNB_CTAS)
    dw = {"dW_fc2": (xt, ht, dim, mlp, Mt), "dW_fc1": (ht, xt, mlp, dim, Mt),
          "dW_out": (xt, at, dim, hd, Mt), "dW_q": (at, xt, hd, dim, Mt),
          "dW_kv": (s["kv"], s["x"], 2 * hd, dim, M)}
    labels = [label.split(" x")[0] for label, _ in parts]
    out, last, sums, f32_seen, ln_seen = [], 0, 0, 0, 0
    for i, base in enumerate(labels):
        name = base.split(" (")[0]
        nxt = labels[i + 1] if i + 1 < len(labels) else ""
        prev = labels[i - 1] if i else ""
        if name in dw:
            a, b, mo, no, k = dw[name]
            last = fb._split_k(mo, no, k) * mo * no * f4
            nb = a + b + last
        elif base.startswith("reduce after dW"):
            a, b, mo, no, k = dw[base.split("after ")[1]]
            nb = last + mo * no * f4
        elif base.startswith("df1"):
            last = -(-Mt // 128) * mlp * f4
            nb = xt + 2 * ht + ht + last
        elif base.startswith("reduce after df1"):
            nb = last + mlp * f4
        elif base.startswith("dh = df1"):  # LN2 in the epilogue: df1, x1, stats, g -> dx1 fp32, bf16
            last, sums = min(-(-Mt // 128), 132) * 4 * dim * f4, 4 * dim * f4
            nb = ht + xt + s["stt"] + xt + 2 * xt + xt + last
        elif base.startswith("dh = dkv"):  # B_LN1_TOP: dkv, x, stats, dq W_q, dx1 -> dx
            last, sums = ln_rows * 2 * dim * f4, 2 * dim * f4
            nb = s["kv"] + s["x"] + s["st"] + 2 * xt + 2 * xt + s["x"] + last
        elif base.startswith("reduce after dh = ") or base == "reduce after LN bwd":
            nb = last + sums
        elif base == "dh (fp32)":
            f32_seen += 1
            if nxt.startswith("dh = dkv") or nxt == "dh (fp32)":  # the top rows' dq W_q share
                nb = at + 2 * xt
            elif f32_seen == 1 and dim > fb.LN_EPILOGUE_MAX_DIM:  # LN2's dh
                nb = ht + 2 * xt
            else:  # dkv W_kv over every row, plus the share where one was made before it
                nb = s["kv"] + s["xf"] + (2 * xt if prev == "dh (fp32)" else 0)
        elif base == "dh += dq W_q":
            nb = at + 2 * 2 * xt
        elif base == "LN bwd":  # LN2 (past dim 192) on the top rows, then LN1 on every row
            ln_seen += 1
            if ln_seen == 1 and dim > fb.LN_EPILOGUE_MAX_DIM:
                last, sums = ln_ctas_t * 4 * dim * f4, 4 * dim * f4
                nb = 2 * xt + xt + s["stt"] + xt + 2 * xt + xt + last
            else:
                last, sums = ln_ctas * 2 * dim * f4, 2 * dim * f4
                nb = s["xf"] + s["x"] + s["st"] + 2 * xt + s["x"] + last
        elif base.startswith("da ="):
            nb = xt + at
        elif base == "attention bwd (few queries)":  # q, o, dO, lse, k, v -> dq, dk, dv
            nb = 4 * at + s["lse"] + 2 * s["kv"]
        elif base == "attention delta":
            nb = 2 * at + s["lse"]
        else:
            nb = None
        out.append(None if nb is None else nb / PEAK_BYTES * 1e3)
    return out


def cls_chain_bytes(B, N, dim, heads, mlp, rows=8, ln1_epilogue=None) -> int:
    """HBM bytes of ``fused_block_cls_bwd``'s chain (each launch's inputs read
    and outputs written once, the weights, split-K partials, column sums and
    the streamed attention's fp32 dQ sums aside), as ``chain_bytes`` counts
    the full block's: the MLP branch on the top rows (LN2 in dh's epilogue
    up to dim 192), dW_out, da, the attention backward (q, o, dO, k, v in;
    dq, dk, dv out), dW_q, dW_kv, then LN1. Where ``ln1_epilogue`` (default:
    ``cls_ln1_in_epilogue(N, rows, dim)``, this tree's rule) LN1 runs in dkv W_kv's
    epilogue beside the top rows' fp32 dq W_q share; else dh is written in
    fp32 over every row, the top rows' share added into it, and read back
    by the standalone pass (past dim 192, and the design before at 192)."""
    from surface_vision_transformers_tpu_torch.ops.fused_block import (
        cls_ln1_in_epilogue,
        ln_in_epilogue,
    )

    s = _cls_sizes(B, N, dim, heads, mlp, rows)
    x, kv, xt, ht, at = s["x"], s["kv"], s["xt"], s["ht"], s["at"]
    mlp_b = (xt + ht) + (xt + 2 * ht + ht) + (ht + xt)  # dW_fc2, df1, dW_fc1
    if ln_in_epilogue(dim):
        mlp_b += ht + xt + s["stt"] + xt + 2 * xt + xt  # dh with LN2 -> dx1 fp32 and bf16
    else:
        mlp_b += (ht + 2 * xt) + (2 * xt + xt + s["stt"] + xt + 2 * xt + xt)
    rest = (xt + at) + (xt + at) + (4 * at + s["lse"] + 2 * kv) + (at + xt) + (kv + x)
    if ln1_epilogue is None:
        ln1_epilogue = cls_ln1_in_epilogue(N, rows, dim)
    if ln1_epilogue:
        ln1 = (at + 2 * xt) + (kv + x + s["st"] + 2 * xt + 2 * xt + x)
    else:
        ln1 = (kv + s["xf"]) + (at + 4 * xt) + (s["xf"] + x + s["st"] + 2 * xt + x)
    return mlp_b + rest + ln1


def cls_fwd_chain_bytes(B, N, dim, heads, mlp, rows=8, train=False, design=None) -> int:
    """HBM bytes of the CLS block's forward chain (``fused_block_cls``; with
    ``train``, the training form and its saves), each launch's inputs read
    and outputs written once, the weights aside, as ``chain_bytes`` counts
    the full block's. ``design`` None: this tree's route
    (``fused_block.cls_fwd_route``, ``cls_ln1_in_kv``):
    [LN1 + K/V] (x in, kv out; training: h1 and stats1 too) or LN1 and K/V
    (h written and read), the few-query attention reading x's top rows and
    kv and writing attn (training: q and lse), the out-projection, LN2, fc1
    and fc2 on the top rows. "eight":
    the eight launches (LN1, K/V, Q, the streamed attention, out-proj, LN2,
    fc1, fc2), the chain before the few-query forward."""
    from surface_vision_transformers_tpu_torch.ops.fused_block import cls_fwd_route, cls_ln1_in_kv

    s = _cls_sizes(B, N, dim, heads, mlp, rows)
    x, kv, xt, ht, at = s["x"], s["kv"], s["xt"], s["ht"], s["at"]
    saves = (s["st"] + s["lse"] + 2 * ht + s["stt"]) if train else 0  # stats1, lse, fpre, stats2
    tail = (xt + xt) + (xt + ht) + (ht + xt + xt) + (xt + ht + xt if train else 0)  # LN2, fc1, fc2
    if design == "eight" or not cls_fwd_route(N, rows):
        head = (x + x) + (x + kv) + (xt + at) + (at + kv + at)  # LN1, K/V, Q, attention
        return head + (at + xt + xt) + tail + saves
    if cls_ln1_in_kv(N, rows, dim):
        head = x + kv + (x if train else 0)  # h1 kept by the training form
    else:
        head = (x + x) + (x + kv)
    head += xt + kv + at + (at if train else 0)  # the attention: x's top rows in, q kept
    return head + (at + xt + xt) + tail + saves


def phase_mssit_train_kernels(rng, fb, sit_module) -> dict:
    """Phase 29: the MS-SiT training path's kernels at dh 32 at the shapes a
    batch of 64 gives them (MSSIT_FOLDS): the attention backward (through
    ``flash_attention_qkv``'s packed strides, as the modular model and the
    chains hold it) and ``fused_block_bwd`` after the training forward,
    each against its float32 and bf16 plain versions under the gates of
    phases 14 and 6, with controls that must fail; bitwise repeats; the
    route ``uses_recompute`` gives each fold; times beside the bound, SDPA's
    backward (attention) and the eager bf16 block's autograd backward.
    -> rows by kernel name (launches filled by phase 30)."""
    from surface_vision_transformers_tpu_torch.ops import flash_attention as fa

    name, dh, rows = "mssit-train-kernels", MSSIT_DH, {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    routes = {f"({Bf}, {N}, {dim})": fb.uses_recompute(N, dim)
              for _, Bf, N, dim, _, _ in MSSIT_FOLDS}
    phase(name, "uses_recompute at each fold (False: the chain route, training forward "
          "keeping its activations, then fused_block_bwd): "
          + ", ".join(f"{k} {v}" for k, v in routes.items()))
    if any(routes.values()):
        raise AssertionError("an MS-SiT fold left the chain route")

    # -- the attention backward at dh 32, through the packed strides
    cases = [(Bf, heads, N, N) for _, Bf, N, _, heads, _ in MSSIT_FOLDS] + MSSIT_BWD_EDGES
    for Bf, heads, N, vl in cases:
        hd = heads * dh
        qkv = torch.cat([dev_randn(g, (Bf, N, 2 * hd), 1.5), dev_randn(g, (Bf, N, hd))], -1)
        do = dev_randn(g, (Bf, N, hd))
        o, lse = fa.flash_attention_qkv_fwd(qkv, heads, vl)
        got = [o, fa.flash_attention_qkv_bwd(qkv, o, lse, do, heads, vl)]
        ref32 = mssit_qkv_plain(fa, qkv, do, heads, vl, torch.float32)
        r32 = step_ratio(got, ref32, ref32)
        rbf = step_ratio(got, mssit_qkv_plain(fa, qkv, do, heads, vl), ref32)
        err = (got[1].float() - ref32[1]).abs().max().item()
        controls = {"dh-64 scale 1/8": step_ratio(
            got, mssit_qkv_plain(fa, qkv, do, heads, vl, torch.float32, MSSIT_SCALE_64), ref32)}
        if vl > 64:
            last = (vl - 1) // 64 * 64
            controls["last key block skipped"] = step_ratio(
                got, mssit_qkv_plain(fa, qkv, do, heads, last, torch.float32), ref32)
        if N > vl:
            controls["key mask ignored"] = step_ratio(
                got, mssit_qkv_plain(fa, qkv, do, heads, N, torch.float32), ref32)
        if fa.resident_pack(N) > 1:
            controls["packed tile's block-diagonal mask ignored"] = step_ratio(
                got, packed_mask_ignored(fa, qkv, do, heads, fa.resident_pack(N), vl), ref32)
        label = f"attention backward dh 32 Bf={Bf} H={heads} N={N} valid_len={vl}"
        msg = (f"{label}: worst |err|/bound over o, dqkv vs fp32 plain {r32:.4g}, vs plain "
               f"bf16 {rbf:.4g} (bound {BOUND_STEPS} bf16 steps at each output's largest "
               f"value), max abs err dqkv {err:.6g}; controls (must exceed 1): "
               + ", ".join(f"{k} {v:.4g}" for k, v in controls.items()))
        if not all(bool(torch.isfinite(t).all()) for t in got) or max(r32, rbf) > 1:
            raise AssertionError(f"{label}: disagrees with its plain version\n{msg}")
        if min(controls.values()) <= 1:
            raise AssertionError(f"{label}: a control passed the gate\n{msg}")
        if N == vl:
            q, k, v = fa.split_qkv(qkv, heads)
            do4 = do.view(Bf, N, heads, dh).transpose(1, 2)
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qr, kr, vr)
            ms = device_ms(lambda: fa.flash_attention_qkv_bwd(qkv, o, lse, do, heads))
            sdpa = device_ms(lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do4,
                                                         retain_graph=True))
            b_ms, b_by = bound_ms(attention_flops(Bf, heads, N, N, dh)[1],
                                  nbytes_of(qkv, o, lse, do, got[1]))
            msg += (f"; kernel {ms:.4f} ms, SDPA backward {sdpa:.4f} ms ({ms / sdpa:.3f}x), "
                    f"bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%}) (device_ms)")
            MSSIT_BWD_RECORDS[f"attention backward Bf={Bf} H={heads} N={N}"] = (ms, sdpa, b_ms)
            if (Bf, N, heads) == MSSIT_ROW_FOLD[1:3] + MSSIT_ROW_FOLD[4:5]:
                chunk = mssit_chunk(N, hd, heads)

                def plain_bwd():
                    return [fa.flash_attention_qkv_bwd_reference(
                        qkv[s:s + chunk], o[s:s + chunk], lse[s:s + chunk], do[s:s + chunk],
                        heads) for s in range(0, Bf, chunk)]
                plain_ms = cuda_ms(plain_bwd, reps=3)
                msg += f", plain bf16 backward {plain_ms:.4f} ms"
                rows["flash_attention_bwd dh32"] = {
                    "name": "flash_attention_bwd dh32", "route": "cuda",
                    "source": FLASH_SOURCE, "replaces": f"{FLASH_TPU}:233",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": sdpa}
            del sdpa_out, qr, kr, vr
        phase(name, msg)
        if (Bf, heads, N) in MSSIT_REPEAT_FOLDS:
            o4 = o.view(Bf, N, heads, dh).transpose(1, 2)
            do4 = do.view(Bf, N, heads, dh).transpose(1, 2)
            repeat_check(name, f"attention backward dh 32 Bf={Bf} H={heads} N={N}",
                         lambda: (fa.flash_attention_qkv_bwd(qkv, o, lse, do, heads),),
                         lambda: (fa.flash_attention_qkv_bwd(qkv, o, lse, bump(do), heads),),
                         lambda: order_control(*fa.split_qkv(qkv, heads), o4, lse, do4, N))
        del qkv, do, o, lse, got, ref32
        torch.cuda.empty_cache()

    busy_card(fa, MSSIT_BUSY_SHAPE, dh, name)
    ln_epilogue_gates(fb, g, name)

    # -- fused_block_bwd at dh 32 after the training forward, at every fold
    lib = fb._native.library()
    for stage, Bf, N, dim, heads, per_batch in MSSIT_FOLDS:
        mlp = 4 * dim
        p32 = [t.cuda() for t in block_params(rng, dim, heads, mlp, dh)]
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous() for t in p32]
        pr = [t.float() for t in pb]  # the bf16 values, in float32
        kw = dict(heads=heads, dim_head=dh)
        x, gy = dev_randn(g, (Bf, N, dim), X_SCALE), dev_randn(g, (Bf, N, dim), G_SCALE)
        out, sv = fb.train_forward(x, *pb, **kw)
        same_fwd = bool(torch.equal(out, fb.fused_block(x, *pb, **kw)))
        got = fb.fused_block_bwd(x, gy, *pb, saved=sv, **kw)
        chunk = mssit_chunk(N, dim, heads)
        ref32 = sliced(lambda xs, gs: fb.fused_block_bwd_reference(
            xs.float(), gs.float(), *pr, **kw), x, gy, chunk=chunk)
        ref_bf = sliced(lambda xs, gs: fb.fused_block_bwd_reference(xs, gs, *pb, **kw), x, gy,
                        chunk=chunk)
        r32, err = grad_bound_ratio(got, ref32, N)
        rbf, _ = grad_bound_ratio(got, ref_bf, N)
        rplain, _ = grad_bound_ratio(ref_bf, ref32, N)
        del ref32, ref_bf
        controls = bwd_controls(fb, lambda **patches: bwd_control(
            fb, x, gy, pr, heads, N, False, got, N, chunk=chunk, dh=dh, **patches))
        label = f"fused_block_bwd dh 32 stage {stage} ({Bf}, {N}, {dim})"
        msg = (f"{label}, {per_batch} a batch: worst |err|/bound over the 12 gradients vs fp32 "
               f"plain {r32:.4g} (plain bf16 {rplain:.4g}), vs plain bf16 {rbf:.4g}, bound "
               f"{BWD_STEPS} bf16 steps at each gradient's largest value; max abs err "
               f"{err:.6g}; training forward == serving forward: {same_fwd}; controls (must "
               "exceed 1): " + ", ".join(f"{k} {v:.4g}" for k, v in controls.items()))
        if not all(bool(torch.isfinite(t).all()) for t in got) or max(r32, rbf) > 1:
            raise AssertionError(f"{label} disagrees with its plain backward\n{msg}")
        if not same_fwd:
            raise AssertionError(f"{label}: the training forward changed the forward's output")
        if min(controls.values()) <= 1:
            raise AssertionError(f"{label}: a control passed the gate\n{msg}")
        f_ms = cuda_ms(lambda: fb.train_forward(x, *pb, **kw), reps=10)
        k_ms = cuda_ms(lambda: fb.fused_block_bwd(x, gy, *pb, saved=sv, **kw), reps=10)
        e_ms = eager_backward_ms(sit_module, p32, x, gy, heads, dim, mlp, False, dh=dh, reps=5)
        flops = block_flops(Bf, N, N, dim, heads, mlp, False, dh)[1]
        b_ms, b_by = bound_ms(flops, nbytes_of(x, gy, *pb, *got))
        _, train_b, bwd_b = chain_bytes(Bf, N, dim, heads, mlp, dh)
        bwd_parent = chain_bytes(Bf, N, dim, heads, mlp, dh, fused_ln=False)[2]
        floor_ms = bwd_b / PEAK_BYTES * 1e3
        ws = (lib.svt_block_bwd_workspace(Bf, N, N, dim, heads, dh, mlp),
              fb.block_bwd_workspace(Bf, N, N, dim, heads, dh, mlp))
        dhf = ([lib.svt_block_bwd_dh_floats(Bf, N, dim, c) for c in (0, 8)],
               [fb.block_bwd_dh_floats(Bf, N, dim, c) for c in (0, 8)])
        msg += (f"; training forward {f_ms:.4f} ms, backward kernel {k_ms:.4f} ms, eager bf16 "
                f"block autograd backward {e_ms:.4f} ms (CUDA-event medians of 10 / 10 / 5); "
                f"bound {b_ms:.4f} ms by {b_by} ({b_ms / k_ms:.1%}; {flops / 1e9:.1f} GFLOP), "
                f"chain floor {floor_ms:.4f} ms ({bwd_b / 1e9:.3f} GB; with standalone LN "
                f"passes {bwd_parent / PEAK_BYTES * 1e3:.4f} ms, {bwd_parent / 1e9:.3f} GB; "
                f"training forward {train_b / 1e9:.3f} GB); workspace {ws[0]} floats "
                f"(block_bwd_workspace's rule {ws[1]}, must be equal), dh scratch {dhf[0]} "
                f"floats, block and CLS block (block_bwd_dh_floats's rule {dhf[1]}, must be "
                f"equal)")
        if ws[0] != ws[1]:
            raise AssertionError(f"{label}: svt_block_bwd_workspace disagrees with its rule")
        if dhf[0] != dhf[1]:
            raise AssertionError(f"{label}: svt_block_bwd_dh_floats disagrees with its rule")
        MSSIT_BWD_RECORDS[f"fused_block_bwd stage {stage} ({Bf}, {N}, {dim})"] = (
            k_ms, e_ms, b_ms)
        MSSIT_BWD_RECORDS[f"training fused_block stage {stage} ({Bf}, {N}, {dim})"] = (
            f_ms, None, None)
        if (stage, Bf, N) == MSSIT_ROW_FOLD[:3]:
            again = fb.fused_block_bwd(x, gy, *pb, saved=sv, **kw)
            moved = fb.fused_block_bwd(x, bump(gy), *pb, saved=sv, **kw)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            control = all(torch.equal(a, b) for a, b in zip(got, moved))
            msg += (f"; two calls bitwise identical {same} (must be True), control: one g "
                    f"element raised by 1, identical {control} (must be False)")
            if not same or control:
                raise AssertionError(f"{label}: the backward does not repeat bit for bit\n{msg}")
            rows["fused_block_bwd dh32"] = {
                "name": "fused_block_bwd dh32", "route": "cuda", "source": BWD_SOURCE,
                "replaces": REPLACES["fused_block_bwd"], "max_abs_err": err, "ms": k_ms,
                "plain_ms": e_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            del again, moved
        phase(name, msg)
        del x, gy, out, sv, got, p32, pb, pr
        torch.cuda.empty_cache()
    # each part of the chain alone, in a process of its own (a fresh profiler)
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / "bwd_chain_parts.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise AssertionError(f"{name}: scripts/bwd_chain_parts.py failed after:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    for line in res.stdout.strip().splitlines()[1:]:
        phase(name, f"bwd_chain_parts.py: {line}")
    return rows

# Phases 30-31 compare the training paths at a cut batch (the eager model's
# fp32 scores reach ~5 GB a fold at 64) with SGD, momentum 0.9, whose
# update gate reads every parameter (Adam moves every element by about the
# learning rate, so a gradient near zero flips an update's sign); the rate
# runs take the shipped configs' batch and their AdamW.
MSSIT_MPP_CFG = ROOT / "configs/pretraining/mssit_mpp.yml"
MSSIT_TRAIN_B, MSSIT_TRAIN_STEPS = 8, 4
MSSIT_RATE_STEPS = 10
MSSIT_LOSS_TOL, MSSIT_MPP_LOSS_TOL, MSSIT_UPD_TOL = 1e-3, 5e-3, 0.05
# A tensor whose eager bf16 update is itself farther than MSSIT_UPD_TOL from
# the eager float32 update is held to that distance instead: the kernel
# path's update within MSSIT_FP32_MARGIN times it of the float32 one. On an
# H100 (NVIDIA H100 80GB HBM3, 700 W) only MPP's pos_embedding was such a
# tensor: its gradient, a sum over the batch that cancels, rounded to bf16
# in both bf16 paths, read 0.118 between them and 0.235 from float32 for
# each; every other tensor read <= 0.029 (MPP) and <= 0.0068 (regression)
# between the two bf16 paths.
MSSIT_FP32_MARGIN = 1.25
MSSIT_CONTROL_BLOCK = (2, 1)  # (stage, block) whose dW_fc1 the controls zero


def mssit_training_model(exp, table, state):
    """A model of ``exp`` (an MSSiT, or an MPPMSSiT under MPP) on the card
    with float32 masters from ``state`` (the encoder's, seeded), attention
    on the plain route (the kernel path ignores it; the eager path runs
    it)."""
    from surface_vision_transformers_tpu_torch.train.runner import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)  # MPP's mask token and decoder
        model = build_model(exp, table)
    enc = model.encoder if exp.is_pretraining else model
    for m in enc.modules():
        if hasattr(m, "attn_backend"):
            m.attn_backend = "plain"
    enc.load_state_dict(state, strict=True)
    return model.cuda()


def mssit_run(exp, init, start, batches, steps, *, eager=False, hook=False):
    """``steps`` optimizer steps from ``init``'s copy on alternating
    ``batches`` (``run_steps``): through ``Trainer`` (the kernel path), or
    with ``eager`` the modular model under autograd with the same optimizer
    (MPP: the same corruption stream, a generator seeded as the trainer's);
    ``hook`` zeroes one block's dW_fc1 (the control)."""
    from surface_vision_transformers_tpu_torch.train.losses import weighted_mse
    from surface_vision_transformers_tpu_torch.train.optim import Optimizer
    from surface_vision_transformers_tpu_torch.train.trainer import Trainer

    model = copy.deepcopy(init)
    mpp = exp.is_pretraining
    enc = model.encoder if mpp else model
    if hook:
        s_, b_ = MSSIT_CONTROL_BLOCK
        enc.stages[s_].blocks[b_][1].fn.net[0].weight.register_hook(torch.zeros_like)
    ones = torch.ones(batches[0][0].shape[0], device="cuda")
    if not eager:
        trainer = Trainer(exp, model)
        step = lambda xb, yb: trainer.optimizer_step(xb, yb, ones)[0]  # noqa: E731
        return run_steps(step, model, start, batches, steps)
    opt = Optimizer(exp.optim, [p for p in model.parameters() if p.requires_grad])
    gen = torch.Generator(device="cuda").manual_seed(exp.training.seed)

    def step(xb, yb):
        opt.zero_grad()
        loss = (model(xb, gen, sample_weights=ones)[0] if mpp
                else weighted_mse(model(xb).reshape(-1), yb))
        loss.backward()
        opt.step()
        return loss.detach()
    return run_steps(step, model, start, batches, steps)


def mssit_update_gate(run, plain, fp32) -> tuple[bool, dict, dict]:
    """(every tensor passes, the worst ratios against eager bf16, the
    tensors held to the float32 rule with (kernel, eager bf16) distances
    to the float32 update): a tensor passes within MSSIT_UPD_TOL of the
    eager bf16 update, or, where eager bf16 is itself farther than that
    from eager float32, within MSSIT_FP32_MARGIN of eager bf16's distance
    to it."""
    to_bf, to_32, bf_32 = (upd_ratios(a[3], b[3]) for a, b in
                           ((run, plain), (run, fp32), (plain, fp32)))
    held = {k: (to_32[k], bf_32[k]) for k in to_bf
            if bf_32.get(k, 0.0) > MSSIT_UPD_TOL}
    ok = all(v <= MSSIT_UPD_TOL or (k in held and held[k][0] <= MSSIT_FP32_MARGIN * held[k][1])
             for k, v in to_bf.items())
    return ok, dict(sorted(to_bf.items(), key=lambda kv: -kv[1])[:3]), held


def mssit_step_breakdown(name, step_ms) -> None:
    """Where a step's device time goes, from phase 29's per-fold times of
    the training forward and fused_block_bwd (at a batch of 64) times the
    blocks at each fold; the rest is the embed, the folds' copies, the
    merges, the head, the loss and the optimizer."""
    parts = {}
    for stage, Bf, N, dim, _, per_batch in MSSIT_FOLDS:
        fold = f"stage {stage} ({Bf}, {N}, {dim})"
        fwd = MSSIT_BWD_RECORDS[f"training fused_block {fold}"][0]
        bwd = MSSIT_BWD_RECORDS[f"fused_block_bwd {fold}"][0]
        parts[f"stage {stage}"] = parts.get(f"stage {stage}", 0.0) + per_batch * (fwd + bwd)
    blocks = sum(parts.values())
    phase(name, f"a step at 64 from phase 29's block times (training forward + backward x "
          "blocks): " + ", ".join(f"{k} {v:.2f} ms ({v / step_ms:.1%})" for k, v in parts.items())
          + f"; the blocks {blocks:.2f} ms of the median step {step_ms:.2f} ms, the rest "
          f"{step_ms - blocks:.2f} ms (embed, fold copies, merges, head, loss, optimizer)")


def phase_mssit_training(name, fb, exp, table, state, batches_of, loss_tol) -> dict:
    """Phases 30 and 31 (regression / MPP per ``exp``): MSSIT_TRAIN_STEPS
    SGD steps of ``Trainer`` at B = MSSIT_TRAIN_B (fused_block_train on
    every fold) against the eager bf16 model under autograd from the same
    masters and batches, per-step losses within ``loss_tol`` relative and
    every parameter's update within MSSIT_UPD_TOL (``mssit_update_gate``:
    a tensor that eager bf16 itself updates farther than that from eager
    float32 is held to its distance), a control (one block's dW_fc1 zeroed)
    failing; launches per step (12 fused_block, 12
    fused_block_bwd, a patch_embed for raw regression input); then
    MSSIT_RATE_STEPS steps at the config's batch with its AdamW: training
    surfaces/s (host window of steps 2..10, CUDA-event times beside), peak
    device memory, the launches, a breakdown and a torch.profiler step.
    -> the launches of the rate run."""
    from surface_vision_transformers_tpu_torch.utils import config

    mpp = exp.is_pretraining
    sgd = config.OptimConfig(name="SGD", lr=TRAIN_LR, momentum=0.9)
    B, steps = MSSIT_TRAIN_B, MSSIT_TRAIN_STEPS
    gated = dataclasses.replace(exp, training=dataclasses.replace(exp.training, bs=B),
                                optim=sgd)
    init = mssit_training_model(exp, table, state)
    start = {k: v.clone() for k, v in init.state_dict().items()}
    small = batches_of(B, 2, SEED + 30)
    counters = zero_counts(fb)
    run = mssit_run(gated, init, start, small, steps)
    launches = read_counts(counters)
    plain = mssit_run(gated, init, start, small, steps, eager=True)
    g32 = dataclasses.replace(gated, compute_dtype="float32")
    fp32 = mssit_run(g32, mssit_training_model(g32, table, state), start, small, steps,
                     eager=True)
    control = mssit_run(gated, init, start, small, steps, hook=True)
    per_step = {k: 0 for k in counters}
    per_step.update(fused_block=12, fused_block_bwd=12, patch_embed=0 if mpp else 1)
    want = {k: v * steps for k, v in per_step.items()}
    phase(name, f"{steps} SGD steps (momentum 0.9, LR {TRAIN_LR}) at B={B} (cut from bs "
          f"{exp.training.bs}): launches {launches}, expected {want}")
    for label, r_ in (("kernel path", run), ("eager bf16 ", plain), ("eager fp32 ", fp32)):
        phase(name, f"losses {label} " + " ".join(f"{v:.6g}" for v in r_[0]))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(run[0], plain[0]))
    ok, worst, held = mssit_update_gate(run, plain, fp32)
    c_ok, c_worst, _ = mssit_update_gate(control, plain, fp32)
    phase(name, f"kernel path vs eager bf16 (plain attention): max relative loss gap "
          f"{loss_err:.4g} (tol {loss_tol}); worst |update - eager update| / max |eager "
          f"update|: " + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()) + f" (tol "
          f"{MSSIT_UPD_TOL}); held to the float32 rule (kernel / eager bf16 distance to the "
          f"fp32 update, kernel within {MSSIT_FP32_MARGIN}x): "
          + (", ".join(f"{k} {a:.4g} / {b:.4g}" for k, (a, b) in held.items()) or "none")
          + f"; gate passed {ok}; control, one block's dW_fc1 zeroed: worst "
          + ", ".join(f"{k} {v:.4g}" for k, v in c_worst.items()) + f", gate passed {c_ok} (must "
          "be False)")
    if not all(math.isfinite(v) for v in run[0]) or loss_err > loss_tol or not ok:
        raise AssertionError(f"{name}: the kernel path disagrees with the eager path")
    if c_ok:
        raise AssertionError(f"{name}: the control passed the gate")
    if launches != want:
        raise AssertionError(f"{name}: the training path did not launch as expected")
    # steps 0 and 2 see the same batch (MPP: under another corruption)
    if not mpp and not run[0][-2] < run[0][0]:
        raise AssertionError(f"{name}: the training loss did not fall")
    del run, plain, fp32, control, small
    torch.cuda.empty_cache()

    bs = exp.training.bs
    big = batches_of(bs, 2, SEED + 31)
    counters = zero_counts(fb)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, step_ms, _ = mssit_run(exp, init, start, big, MSSIT_RATE_STEPS)
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: v * MSSIT_RATE_STEPS for k, v in per_step.items()}
    phase(name, f"bs {bs}, {MSSIT_RATE_STEPS} steps ({exp.optim.name}, LR {exp.optim.lr}): "
          f"launches {launches}, expected {want}; losses " + " ".join(f"{v:.6g}" for v in losses)
          + f"; steps 2..{MSSIT_RATE_STEPS} as one window (host clock, synchronized at both "
          f"ends): {step_s * 1e3:.2f} ms a step = {bs / step_s:.2f} training surfaces/s; "
          f"per-step CUDA-event times median {np.median(step_ms):.2f} ms: "
          + " ".join(f"{v:.2f}" for v in step_ms) + f" ms; peak {peak:.2f} GiB allocated")
    if launches != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: the training path at bs {bs} did not run as expected")
    if not mpp:
        mssit_step_breakdown(name, float(np.median(step_ms)))
    from surface_vision_transformers_tpu_torch.train.trainer import Trainer

    model = copy.deepcopy(init)
    trainer = Trainer(exp, model)
    ones = torch.ones(bs, device="cuda")
    profile_step(lambda: trainer.optimizer_step(big[0][0], big[0][1], ones), bs, name)
    del big, model, trainer, init
    torch.cuda.empty_cache()
    return launches


def mssit_configs(rng):
    """(regression exp, MPP exp, the canonical sub-ico-5 table, the seeded
    encoder state): the shipped MS-SiT configs at full width and depth."""
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.models.mssit import MSSiT
    from surface_vision_transformers_tpu_torch.utils import config

    exp, mpp_exp = config.load_config(MSSIT_CFG), config.load_config(MSSIT_MPP_CFG)
    table = load_patch_table(exp.ico, exp.sub_ico).indices
    state = mssit_state(rng, MSSiT.from_config(exp, patch_table=table))
    return exp, mpp_exp, table, state


def phase_mssit_train(fb, exp, table, state) -> dict:
    """Phase 30: ``mssit_scan_age.yml`` training (``phase_mssit_training``)
    on raw surfaces with a planted label."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset

    def batches_of(bs, n, seed):
        data, labels = make_regression_dataset(n * bs, raw_vertices=40962, seed=seed)
        data, labels = torch.from_numpy(data).cuda(), torch.from_numpy(labels).cuda()
        return [(data[s:s + bs], labels[s:s + bs]) for s in range(0, n * bs, bs)]

    phase("mssit-train", f"{MSSIT_CFG.relative_to(ROOT)}: dims {exp.mssit.embed_dim}.., depths "
          f"{exp.mssit.depths}, heads {exp.mssit.heads}, dh 32, bs {exp.training.bs}, "
          f"{exp.optim.name} LR {exp.optim.lr}")
    return phase_mssit_training("mssit-train", fb, exp, table, state, batches_of, MSSIT_LOSS_TOL)


def phase_mssit_pretrain(fb, exp, table, state) -> dict:
    """Phase 31: ``mssit_mpp.yml`` masked-window pretraining
    (``phase_mssit_training``, the MPP gate) on the finest-grid tokens of
    raw surfaces."""
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
    from surface_vision_transformers_tpu_torch.models.mpp_mssit import mssit_target_tokens
    from surface_vision_transformers_tpu_torch.models.mssit import MSSiT

    enc = MSSiT.from_config(exp, patch_table=table)  # its table, for the targets

    def batches_of(bs, n, seed):
        data, _ = make_regression_dataset(n * bs, raw_vertices=40962, seed=seed)
        with torch.no_grad():
            tokens = mssit_target_tokens(enc, torch.from_numpy(data).cuda())
        return [(tokens[s:s + bs], None) for s in range(0, n * bs, bs)]

    m = exp.mpp
    phase("mssit-pretrain", f"{MSSIT_MPP_CFG.relative_to(ROOT)}: bs {exp.training.bs}, "
          f"{exp.optim.name} LR {exp.optim.lr}, mask/replace/swap {m.mask_prob}/"
          f"{m.replace_prob}/{m.swap_prob} of windows of 64, decoder 768 -> 64 x 24")
    return phase_mssit_training("mssit-pretrain", fb, exp, table, state, batches_of,
                                MSSIT_MPP_LOSS_TOL)


def phase_mssit_train_entry(fb) -> None:
    """Phase 32: ``cli.train`` and ``cli.pretrain`` on the two shipped
    MS-SiT configs (two epochs on a synthetic split of 64 + 64 raw
    surfaces), and ``cli.train --set tpu.fused_train=False`` (the modular
    bf16 model, its attention on ``flash_attention_qkv`` forward and
    backward; batch cut to 16), each in a subprocess and equal to
    ``run_training`` in this process on the same ``--set`` overrides, whose
    launches show the route."""
    from surface_vision_transformers_tpu_torch.cli._common import parse_config
    from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset
    from surface_vision_transformers_tpu_torch.train.runner import run_training
    from surface_vision_transformers_tpu_torch.utils import config

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data, labels = make_regression_dataset(128, raw_vertices=40962, seed=SEED + 32)
        for split, sl in (("train", slice(0, 64)), ("validation", slice(64, 128))):
            np.save(tmp / f"{split}_data.npy", data[sl])
            np.save(tmp / f"{split}_labels.npy", labels[sl])
        del data
        runs = [("train", MSSIT_CFG, [], "fused"),
                ("pretrain", MSSIT_MPP_CFG, [], "fused"),
                ("train", MSSIT_CFG, ["tpu.fused_train=False", "training.bs=16",
                                      "training.bs_val=16"], "modular")]
        for i, (tool, cfg, extra, route) in enumerate(runs):
            sets = [f"data.data_path={tmp}", "training.epochs=2", "training.val_epoch=1",
                    f"logging.folder_to_save_model={tmp / f'cli{i}'}", *extra]
            argv = [str(cfg), "--device", "cuda", *[a for s_ in sets for a in ("--set", s_)]]
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", f"surface_vision_transformers_tpu_torch.cli.{tool}",
                 *argv], cwd=ROOT, capture_output=True, text=True, timeout=900)
            if res.returncode:
                raise AssertionError(f"cli.{tool} failed ({res.returncode}):\n{res.stderr}")
            cli = ast.literal_eval(res.stdout.strip().splitlines()[-1])
            t_cli = time.perf_counter() - t0
            raw, _ = parse_config("in-process", argv)
            raw["logging"]["folder_to_save_model"] = str(tmp / f"in{i}")
            if tool == "pretrain":
                raw.setdefault("SSL", "mpp")
            exp = config.from_dict(raw)
            counters = zero_counts(fb)
            t0 = time.perf_counter()
            mine = run_training(exp, device="cuda", progress=False)
            launches = read_counts(counters)
            metric = "best_loss" if tool == "pretrain" else "best_mae"
            vals = []
            for d in (cli["run_dir"], mine["run_dir"]):
                with open(Path(d) / "metrics_val.csv") as f:
                    vals.append([float(r[f"val/{metric[5:]}"]) for r in csv.DictReader(f)])
            steps = 2 * -(-64 // exp.training.bs)
            bwd = launches["fused_block_bwd"], launches["flash_attention_qkv_bwd"]
            want_bwd = (12 * steps, 0) if route == "fused" else (0, 12 * steps)
            phase("mssit-train-entry", f"cli.{tool} {Path(cfg).relative_to(ROOT)} "
                  f"{' '.join('--set ' + e for e in extra)} in {t_cli:.1f} s: {metric} "
                  f"{cli[metric]!r} at epoch {cli['best_epoch']}, val by epoch {vals[0]}; "
                  f"in process ({time.perf_counter() - t0:.1f} s): {mine[metric]!r}, val "
                  f"{vals[1]} (must be equal); tpu.fused_train read as {exp.fused_train}; "
                  f"launches in process {launches}; fused_block_bwd / flash_attention_qkv_bwd "
                  f"{bwd}, expected {want_bwd} ({route} route)")
            if vals[0] != vals[1] or cli[metric] != mine[metric] or len(vals[0]) != 2:
                raise AssertionError(f"cli.{tool} disagrees with the in-process run")
            if not all(math.isfinite(v) for v in vals[0]) or bwd != want_bwd:
                raise AssertionError(f"cli.{tool} did not train on the {route} route")
            if exp.fused_train != (route == "fused"):
                raise AssertionError("--set tpu.fused_train was not read as YAML reads it")
    torch.cuda.empty_cache()


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
    want[FEW_FWD] = n_batches  # one in each CLS forward
    phase("slice", f"predict(300 surfaces, batch 256): launches {launches}, "
          f"expected {want}")
    if launches != want:
        raise AssertionError("the main path did not launch every kernel as expected")
    if preds.shape != (300, 1) or not np.isfinite(preds).all():
        raise AssertionError(f"bad predictions: shape {preds.shape}")
    for name in ("fused_block", "fused_block_cls", FEW_FWD):
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
    few_launches = launches["flash_attention_bwd 8 queries"]  # its row comes in phase 9
    torch.cuda.empty_cache()

    # -- 8. train-entry
    start("train-entry")
    phase_train_entry()

    # -- 9. flash-kernels
    start("flash-kernels")
    kernels.update(phase_flash(rng))
    kernels["flash_attention_bwd 8 queries"]["launches"] = few_launches

    # -- 10. base-kernels
    start("base-kernels")
    from surface_vision_transformers_tpu_torch.utils import config

    exp = config.load_config(BASE_CFG)
    base_times = phase_base_kernels(rng, fb, sit_module, exp.model, exp.training.bs)

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

    # -- 25. block-gemms
    start("block-gemms")
    gemm_rows = phase_block_gemms(rng, fb)

    # -- 26. mssit-kernels (a generator of their own: phases 26-27 draw the
    # data their gates were set on, whatever the phases before them draw)
    start("mssit-kernels")
    ms_rng = np.random.default_rng(SEED)
    mssit_rows = phase_mssit_kernels(ms_rng, fb)

    # -- 27. mssit-slice (every count zeroed just before each run)
    start("mssit-slice")
    ms_models = mssit_models(ms_rng)
    ms_launches = phase_mssit_slice(ms_rng, fb, fused, ms_models)
    bf16_run, int8_run = ms_launches["bf16"], ms_launches["int8"]
    # one dh-32 attention forward runs inside every fused_block launch
    for row_name, n_ in (("flash_attention_fwd dh32", bf16_run["fused_block"]),
                         ("fused_block dh32", bf16_run["fused_block"]),
                         ("fused_mlp dh32", bf16_run["block_mlp"]),
                         ("ln_qkv dh32", bf16_run["block_ln_gemm"]),
                         ("fused_block_int8 dh32", int8_run["fused_block_int8"]),
                         ("patch_embed sub-ico 5", bf16_run["patch_embed"])):
        mssit_rows[row_name]["launches"] = n_
    kernels.update(mssit_rows)

    # -- 28. mssit-entry
    start("mssit-entry")
    phase_mssit_entry(fb, fused, ms_models)
    del ms_models
    torch.cuda.empty_cache()

    # -- 29. mssit-train-kernels (a generator of its own, as phases 26-27)
    start("mssit-train-kernels")
    kernels.update(phase_mssit_train_kernels(np.random.default_rng(SEED + 29), fb, sit_module))

    # -- 30. mssit-train (every count zeroed just before each run)
    start("mssit-train")
    ms_exp, ms_mpp_exp, ms_table, ms_state = mssit_configs(np.random.default_rng(SEED + 30))
    train_launches = phase_mssit_train(fb, ms_exp, ms_table, ms_state)
    # one dh-32 attention backward runs inside every fused_block_bwd launch
    for row_name in ("fused_block_bwd dh32", "flash_attention_bwd dh32"):
        kernels[row_name]["launches"] = train_launches["fused_block_bwd"]

    # -- 31. mssit-pretrain (every count zeroed just before each run)
    start("mssit-pretrain")
    phase_mssit_pretrain(fb, ms_mpp_exp, ms_table, ms_state)
    del ms_state

    # -- 32. mssit-train-entry
    start("mssit-train-entry")
    phase_mssit_train_entry(fb)
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
    block_ms = {"fused_block": kernels["fused_block"]["ms"],
                "fused_block SiT-base B=32": base_times["fused_block"],
                "fused_block_cls": kernels["fused_block_cls"]["ms"],
                "fused_block_bwd": kernels["fused_block_bwd"]["ms"],
                "fused_block_cls_bwd": kernels["fused_block_cls_bwd"]["ms"]}
    phase("records", "the block rows, this run's ms beside the mma.sync "
          "GEMMs' recorded ms (PERF.md section 6, NVIDIA H100 80GB HBM3 at 700 W; a record, "
          "not measured in this run): " + "; ".join(
              f"{k_} {block_ms[k_]:.4f} (mma.sync {v_})" for k_, v_ in MMA_SYNC_BLOCK_MS.items())
          + "; the GEMMs alone against torch.mm, ms: " + "; ".join(
              f"{r_['gemm'].split(' M')[0]} {r_['ms']:.4f} / {r_['library_ms']:.4f}"
              for r_ in gemm_rows))
    phase("records", "the int8 rows, this run's ms beside the mma.sync s8 design's recorded "
          "ms (PERF.md section 6, NVIDIA H100 80GB HBM3 at 700 W; a record, not measured in "
          "this run), with torch._int_mm and the bound of this run: " + "; ".join(
              f"{k_} {INT8_RECORDS[k_][0]:.4f} (mma.sync {v_}"
              + ("" if INT8_RECORDS[k_][1] is None
                 else f"; torch._int_mm {INT8_RECORDS[k_][1]:.4f}")
              + f"; bound {INT8_RECORDS[k_][2]:.4f})" for k_, v_ in MMA_SYNC_INT8_MS.items()))
    for label_, records_, other_ in (
            ("the MS-SiT path's kernels at dh 32 in this run (phase 26)", MSSIT_RECORDS,
             "SDPA, index_select + addmm, torch.mm"),
            ("the MS-SiT training path's kernels at dh 32 in this run (phase 29)",
             MSSIT_BWD_RECORDS, "SDPA's backward, the eager block's autograd backward")):
        phase("records", f"{label_}, ms / other ms ({other_}) / bound ms: " + "; ".join(
            f"{k_} {t_[0]:.4f} / {'-' if t_[1] is None else f'{t_[1]:.4f}'} / "
            f"{'-' if t_[2] is None else f'{t_[2]:.4f}'}" for k_, t_ in records_.items()))
    print(f"seconds per phase: {phase_seconds(time.perf_counter())}", flush=True)

    print(json.dumps({"kernels": [kernels[k] for k in sorted(kernels)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
