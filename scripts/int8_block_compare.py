#!/usr/bin/env python3
"""The port's int8 block beside another checkout's, on one NVIDIA GPU.

    python3 scripts/int8_block_compare.py OTHER_CHECKOUT

Builds ``fused_block_int8.cu`` and ``flash_attention.cu`` of
OTHER_CHECKOUT's ``surface_vision_transformers_tpu_torch/csrc`` into one
temporary library beside this tree's kernels, then times
``fused_block_int8`` at the three rate cases of ``chip_smoke.py`` phase 20
(``INT8_RATE_CASES``: dim 192, 384 and 768, the last SiT-base at B=64, N =
1281) with one timer (``chip_smoke.cuda_ms``: CUDA-event median of 10), in
the order other, this, this, other. This tree's block runs through its
wrapper; the other's C entry ``svt_fused_block_int8`` is called with the
argument list it had while its GEMMs were ``mma.sync`` (x, the 15
parameters, out, then scratch: codes (M, max(dim, hd, mlp)) int8, scales
(M,) fp32, qkv (M, 3 hd) and attn (M, hd) bf16, x1 (M, dim) and f (M, mlp)
fp32; B, N, dim, heads, dim_head, mlp, valid_len, eps, device, stream),
each call allocating its scratch as the wrapper does.

The inputs are phase 20's seeded int8 block parameters and block input.
Prints per case both libraries' times (the mean of their two readings), the
ratio of this tree's to the other's, and the largest difference between the
two block outputs against the largest output.
Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import INT8_RATE_CASES, SEED, X_SCALE, cuda_ms, int8_block_params  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as fbi8  # noqa: E402


def other_block(lib, x, p8, heads):
    """The other checkout's block through its own C entry."""
    B, N, dim = x.shape
    hd, mlp, M = heads * 64, p8[9].shape[0], B * N
    dev = x.device
    out = torch.empty_like(x)
    ws = [torch.empty((M, max(dim, hd, mlp)), dtype=torch.int8, device=dev),
          torch.empty((M,), dtype=torch.float32, device=dev),
          x.new_empty((M, 3 * hd)), x.new_empty((M, hd)),
          torch.empty((M, dim), dtype=torch.float32, device=dev),
          torch.empty((M, mlp), dtype=torch.float32, device=dev)]
    _native.check(lib.svt_fused_block_int8(
        *[t.data_ptr() for t in (x, *p8, out, *ws)], B, N, dim, heads, 64, mlp, N, 1e-5,
        dev.index, torch.cuda.current_stream(dev).cuda_stream))
    return out


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("int8_block_compare: no CUDA device")
    other_csrc = Path(sys.argv[1]).resolve() / "surface_vision_transformers_tpu_torch" / "csrc"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libint8_other.so"
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                        *(str(other_csrc / f) for f in ("fused_block_int8.cu",
                                                        "flash_attention.cu"))],
                       check=True, capture_output=True, timeout=900)
        other_lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    other_lib.svt_fused_block_int8.argtypes = [P] * 23 + [I] * 7 + [F, I, P]
    other_lib.svt_fused_block_int8.restype = I

    rng = np.random.default_rng(SEED)
    for dim, heads, mlp, B, N in INT8_RATE_CASES:
        p8, _ = int8_block_params(rng, dim, heads, mlp)
        x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N, dim)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        calls = {"other": lambda: other_block(other_lib, x, p8, heads),
                 "this": lambda: fbi8.fused_block_int8(x, *p8, heads=heads, dim_head=64)}
        with torch.inference_mode():
            outs = {n: c().float() for n, c in calls.items()}
            times = {n: [] for n in calls}
            for n in ("other", "this", "this", "other"):
                times[n].append(cuda_ms(calls[n], reps=10))
        diff = ((outs["this"] - outs["other"]).abs().max() / outs["other"].abs().max()).item()
        mean = {n: sum(t) / len(t) for n, t in times.items()}
        each = {n: ", ".join(f"{t:.4f}" for t in ts) for n, ts in times.items()}
        print(f"fused_block_int8 dim {dim} B={B} N={N}: this {mean['this']:.4f} ms "
              f"({each['this']}), other {mean['other']:.4f} ms ({each['other']}), this/other "
              f"{mean['this'] / mean['other']:.3f}; max |this - other| / max |other| {diff:.3g}; "
              f"outputs differing {(outs['this'] != outs['other']).float().mean().item():.4f}",
              flush=True)
        del x, p8, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
