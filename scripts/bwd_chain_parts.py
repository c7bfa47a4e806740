#!/usr/bin/env python3
"""Each part of the block backward alone, on one NVIDIA GPU.

    python3 scripts/bwd_chain_parts.py

At each of the seven MS-SiT folds of a batch of 64 (``chip_smoke.MSSIT_FOLDS``,
dh 32) and at SiT-tiny (B = 256, N = 321, dh 64): ``fused_block_bwd`` after
the training forward, timed whole (``chip_smoke.device_ms``), then each of
its parts alone (``chip_smoke.chain_parts``: every launch's device time
under torch.profiler, one call a session, the mean of the sessions that saw
the same launches) beside the part's byte floor (``chip_smoke.part_floors``)
and the sum of the parts beside the whole. ``chip_smoke.py`` phase 29 runs
this script in a process of its own: late in a long run the profiler there
dropped launches. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402

CASES = [(f"stage {s} ({Bf}, {N}, {dim})", Bf, N, dim, heads, cs.MSSIT_DH)
         for s, Bf, N, dim, heads, _ in cs.MSSIT_FOLDS] + [
    ("SiT-tiny (256, 321, 192)", 256, 321, 192, 3, 64)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bwd_chain_parts: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
    for label, Bf, N, dim, heads, dh in CASES:
        mlp = 4 * dim
        rng = np.random.default_rng(cs.SEED + 14)
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in cs.block_params(rng, dim, heads, mlp, dh)]
        kw = dict(heads=heads, dim_head=dh)
        x, gy = cs.dev_randn(g, (Bf, N, dim), cs.X_SCALE), cs.dev_randn(g, (Bf, N, dim), cs.G_SCALE)
        _, sv = fb.train_forward(x, *pb, **kw)

        def call():
            return fb.fused_block_bwd(x, gy, *pb, saved=sv, **kw)

        print(f"{label}: timing", file=sys.stderr, flush=True)
        whole = cs.device_ms(call)
        parts = cs.chain_parts(call)
        floors = cs.part_floors(parts, Bf, N, dim, heads, mlp, dh)
        total = sum(m for _, m in parts)
        print(f"{label}: fused_block_bwd {whole:.4f} ms (device_ms); each part alone (ms, byte "
              f"floor): " + "; ".join(f"{p} {m:.4f}" + ("" if f is None else f" ({f:.4f})")
                                      for (p, m), f in zip(parts, floors))
              + f"; sum of the parts {total:.4f} ms ({total / whole:.3f} of the whole"
              + ("" if abs(total / whole - 1) < 0.15 else ": the profiler lost launches") + ")",
              flush=True)
        del x, gy, sv, pb
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
