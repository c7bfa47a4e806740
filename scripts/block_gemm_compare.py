#!/usr/bin/env python3
"""The port's block chains beside another checkout's, on one NVIDIA GPU.

    python3 scripts/block_gemm_compare.py OTHER_CHECKOUT

Builds ``fused_block.cu``, ``fused_block_bwd.cu`` and ``flash_attention.cu``
of OTHER_CHECKOUT's ``surface_vision_transformers_tpu_torch/csrc`` into one
temporary library (its C entries ``svt_fused_block[_cls]``,
``svt_fused_block[_cls]_bwd`` and ``svt_block_bwd_workspace`` must take this
tree's arguments) beside this tree's kernels, then times the block rows of
PERF.md section 6 through this tree's wrappers on either library, with one
timer (``chip_smoke.cuda_ms``: CUDA-event median of 25, 10 at SiT-base), in
the order other, this, this, other:

- ``fused_block`` and ``fused_block_cls`` at SiT-tiny B=256, N=321 and at
  SiT-base B=32, N=1281 (phases 3 and 10);
- ``fused_block_bwd`` at SiT-tiny and SiT-small width, B=256, N=321
  (phase 6: the ``_block_bwd`` and ``_block_bwd_split`` rows);
- ``fused_block_cls_bwd`` at SiT-tiny and SiT-small width, B=256, and at
  SiT-base B=32 (phases 6 and 10).

The inputs are ``chip_smoke.py``'s seeded block parameters and scales; a
backward reads what this tree's training forward kept. Prints per row both
libraries' times (the mean of their two readings), the ratio of this
tree's to the other's, and the largest difference between the two outputs
against the largest output (the block output; dx, and the worst of the
parameter gradients).
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

from chip_smoke import G_SCALE, X_SCALE, block_params, cuda_ms  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402

ENTRIES = ("svt_fused_block", "svt_fused_block_cls", "svt_fused_block_train_fwd",
           "svt_fused_block_cls_train_fwd", "svt_fused_block_bwd", "svt_fused_block_cls_bwd",
           "svt_block_bwd_workspace", "svt_error_string")
WIDTHS = {"SiT-tiny": (192, 3, 768), "SiT-small": (384, 6, 1536), "SiT-base": (768, 12, 3072)}
ROWS = [("fused_block", "SiT-tiny", 256, 321), ("fused_block", "SiT-base", 32, 1281),
        ("fused_block_cls", "SiT-tiny", 256, 321), ("fused_block_cls", "SiT-base", 32, 1281),
        ("fused_block_bwd", "SiT-tiny", 256, 321), ("fused_block_bwd", "SiT-small", 256, 321),
        ("fused_block_cls_bwd", "SiT-tiny", 256, 321),
        ("fused_block_cls_bwd", "SiT-small", 256, 321),
        ("fused_block_cls_bwd", "SiT-base", 32, 1281)]


def declare(lib, this_lib):
    """The other library's entries, with this tree's C signatures."""
    for name in ENTRIES:
        fn, ref = getattr(lib, name), getattr(this_lib, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("block_gemm_compare: no CUDA device")
    other_csrc = Path(sys.argv[1]).resolve() / "surface_vision_transformers_tpu_torch" / "csrc"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libblock_other.so"
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                        *(str(other_csrc / f) for f in ("fused_block.cu", "fused_block_bwd.cu",
                                                        "flash_attention.cu"))],
                       check=True, capture_output=True, timeout=900)
        other_lib = declare(ctypes.CDLL(str(so)), this_lib)
    libs = {"other": other_lib, "this": this_lib}

    def run(name, fn):
        _native.library = lambda: libs[name]
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib

    rng = np.random.default_rng(0)
    for kernel, width, B, N in ROWS:
        dim, heads, mlp = WIDTHS[width]
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in block_params(rng, dim, heads, mlp)]
        kw = dict(heads=heads, dim_head=64)
        x = torch.from_numpy(X_SCALE * rng.standard_normal((B, N, dim)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        cls = "cls" in kernel
        if kernel.endswith("_bwd"):
            g = torch.from_numpy((G_SCALE * rng.standard_normal((B, 8 if cls else N, dim))).astype(
                np.float32)).to("cuda", torch.bfloat16)
            _, sv = fb.train_forward(x, *pb, cls=cls, **kw)
            bwd = fb.fused_block_cls_bwd if cls else fb.fused_block_bwd

            def call():
                return bwd(x, g, *pb, saved=sv, **kw)
        else:
            fwd = fb.fused_block_cls if cls else fb.fused_block

            def call():
                with torch.inference_mode():
                    return (fwd(x, *pb, **kw),)
        reps = 10 if width == "SiT-base" else 25
        outs = {n: run(n, call) for n in libs}
        diffs = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                 for a, b in zip(outs["this"], outs["other"])]
        times = {n: [] for n in libs}
        for n in ("other", "this", "this", "other"):
            times[n].append(run(n, lambda: cuda_ms(call, reps=reps)))
        mean = {n: sum(t) / len(t) for n, t in times.items()}
        each = {n: ", ".join(f"{t:.4f}" for t in ts) for n, ts in times.items()}
        print(f"{kernel} {width} B={B} N={N}: this {mean['this']:.4f} ms ({each['this']}), other "
              f"{mean['other']:.4f} ms ({each['other']}), this/other "
              f"{mean['this'] / mean['other']:.3f}; max |this - other| / max |other|: output "
              f"{diffs[0]:.3g}" + (f", worst of the 11 parameter gradients {max(diffs[1:]):.3g}"
                                   if len(diffs) > 1 else ""), flush=True)
        del x, pb, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
