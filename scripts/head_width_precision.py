#!/usr/bin/env python3
"""Where bf16 rounding, not a kernel, sets a head width's distance from float32, on one NVIDIA GPU.

    python3 scripts/head_width_precision.py [cls-bwd] [model]

- ``cls-bwd``: the CLS block's backward (``fused_block_cls_bwd``, B = 256,
  N = 321, dim 192, ``chip_smoke.py``'s seeded block) at 12, 24 and 48 heads
  of dh 4: for each of its 12 gradients the largest |difference| over
  phase 6's gate (``BWD_STEPS`` bf16 steps at the gradient's largest
  |float32| value) for the kernel against the float32 plain backward, the
  plain bf16 backward against the float32 one, and the kernel against the
  plain bf16 one;
- ``model``: a seeded SiT-tiny at full depth (dim 192, 12 blocks) as 3 × 20,
  6 × 32 and 3 × 64 on 64 synthetic raw surfaces: the max |difference| of
  the predictions of ``predict`` on the card (the kernels), of the same
  fused route on the host (its plain versions, bf16) and of the eager
  float32 model on the card, pairwise.

Prints one line a case. Needs a CUDA device and nvcc; imports nothing of
JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from surface_vision_transformers_tpu_torch.data.synthetic import make_regression_dataset  # noqa: E402
from surface_vision_transformers_tpu_torch.geometry import load_patch_table  # noqa: E402
from surface_vision_transformers_tpu_torch.models import fused  # noqa: E402
from surface_vision_transformers_tpu_torch.models.sit import SiT  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402


def cls_bwd() -> None:
    dim, mlp, B, N = 192, 768, 256, cs.N_TOKENS
    for heads, dh in ((12, 4), (24, 4), (48, 4)):
        rng = np.random.default_rng(cs.SEED + 390 + dh)
        p32 = [t.cuda() for t in cs.block_params(rng, dim, heads, mlp, dh)]
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous() for t in p32]
        pr = [t.float() for t in pb]
        x = torch.from_numpy(cs.X_SCALE * rng.standard_normal((B, N, dim)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        g = torch.from_numpy((cs.G_SCALE * rng.standard_normal((B, 8, dim))).astype(
            np.float32)).to("cuda", torch.bfloat16)
        kw = dict(heads=heads, dim_head=dh)
        _, sv = fb.train_forward(x, *pb, valid_len=N, cls=True, **kw)
        got = fb.fused_block_cls_bwd(x, g, *pb, saved=sv, valid_len=N, **kw)
        ref32 = cs.sliced(lambda xs, gs: fb.fused_block_cls_bwd_reference(
            xs.float(), gs.float(), *pr, **kw), x, g)
        ref_bf = cs.sliced(lambda xs, gs: fb.fused_block_cls_bwd_reference(xs, gs, *pb, **kw), x, g)
        parts = []
        for name, a, r, q in zip(cs.GRAD_NAMES, got, ref32, ref_bf):
            a, r, q = a.float(), r.float(), q.float()
            step = cs.BWD_STEPS * cs.bf16_step(r.abs().max().item())
            parts.append(f"{name} {(a - r).abs().max().item() / step:.3f} / "
                         f"{(q - r).abs().max().item() / step:.3f} / "
                         f"{(a - q).abs().max().item() / step:.3f}")
        print(f"cls-bwd {heads} x {dh} (kernel vs fp32 / plain bf16 vs fp32 / kernel vs plain "
              f"bf16, of the gate): " + "; ".join(parts), flush=True)
        del p32, pb, pr, x, g, sv, got, ref32, ref_bf
        torch.cuda.empty_cache()


def model() -> None:
    torch.set_num_threads(8)
    table = load_patch_table(6, 2).indices
    data, _ = make_regression_dataset(64, raw_vertices=40962, seed=cs.SEED + 77)
    for heads, dh in ((3, 20), (6, 32), (3, 64)):
        t0 = time.perf_counter()
        torch.manual_seed(cs.SEED)
        kw = dict(dim=192, depth=cs.DEPTH, heads=heads, mlp_dim=768, dim_head=dh,
                  patch_table=table)
        m32 = SiT(dtype=torch.float32, **kw).eval()
        mbf = SiT(dtype=torch.bfloat16, **kw).eval()
        mbf.load_state_dict(m32.state_dict())
        with torch.inference_mode():
            eager = torch.cat([m32.cuda()(torch.from_numpy(data[s:s + 32]).cuda())
                               for s in range(0, len(data), 32)]).float().cpu()
        kern = torch.from_numpy(fused.predict(mbf, data, device="cuda", batch_size=32))
        plain = torch.from_numpy(fused.predict(mbf.cpu(), data, device="cpu", batch_size=32))
        print(f"model {heads} x {dh}: kernels vs eager fp32 {(kern - eager).abs().max():.6g}, "
              f"the fused route's plain versions (host, bf16) vs eager fp32 "
              f"{(plain - eager).abs().max():.6g}, kernels vs plain "
              f"{(kern - plain).abs().max():.6g}; std across surfaces {eager.std():.4g}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("head_width_precision: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card(), flush=True)
    modes = sys.argv[1:] or ["cls-bwd", "model"]
    for mode in modes:
        {"cls-bwd": cls_bwd, "model": model}[mode]()


if __name__ == "__main__":
    main()
