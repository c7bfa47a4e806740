#!/usr/bin/env python3
"""Where the fused forward chain's two kernels spend their time, on one
NVIDIA GPU: copies of this tree's kernels, each with one part taken out.

    python3 scripts/fused_mlp_variants.py

Builds ``fused_block.cu``, ``fused_mlp.cu`` and ``flash_attention.cu`` of
``surface_vision_transformers_tpu_torch/csrc`` once as they are and once per
variant below, each into a library of its own with one change made in the
copy's text (the variants compute wrong outputs: they are timed only), then
times ``block_mlp`` (serving and, at dim 96, the training form) and
``block_ln_gemm`` at a batch of 64's stage-0 and stage-1 rows by CUDA
events, in the order shipped, variants, shipped:

- ``no GELU``: the fused MLP's chunk goes to fc2 without its erf-GELU;
- ``no LN2``: the fused MLP skips its LayerNorm prologue;
- ``no fc2``: the fused MLP issues no fc2 product (its GELU is then dead
  code too);
- ``two warpgroups``: the fused MLP at dim 96 with two consumer warpgroups,
  not three;
- ``no LN1``: the qkv product without its LayerNorm prologue (the engine's
  plain product).

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402

SOURCES = ("fused_block.cu", "fused_mlp.cu", "flash_attention.cu")
ENTRIES = ("svt_block_mlp", "svt_block_ln_gemm", "svt_error_string")
VARIANTS = {  # name -> [(file, text, replacement), ..]
    "no GELU": [("fused_mlp.cu", "pack_bf16(gelu_erf(v0), gelu_erf(v1))", "pack_bf16(v0, v1)")],
    "no LN2": [("fused_mlp.cu", "const float2 st = ln_row_pair<DIM / 8>(",
                "const float2 st = make_float2(0.f, 0.f); if (0) ln_row_pair<DIM / 8>(")],
    "no fc2": [("fused_mlp.cu",
                "wgmma_rs<0>(acc, p[kk], sw128_desc(w2 + kk * 16), c > 0 || kk > 0);", "")],
    "two warpgroups": [("fused_mlp.cu", "static constexpr int NWG = DIM <= 96 ? 3 : 2;",
                        "static constexpr int NWG = 2;")],
    "no LN1": [("gemm.cuh", "      if (w.K == 96)\n        ln_prologue<12>",
                "      if (w.K < 0)\n        ln_prologue<12>"),
               ("gemm.cuh", "      else\n        ln_prologue<24>",
                "      else if (w.K < 0)\n        ln_prologue<24>")],
}
CASES = [(0, 64 * 20480, 96, 3), (1, 64 * 5120, 192, 6)]  # (stage, rows, dim, heads)


def build(root: Path) -> dict:
    """name -> library with this tree's C signatures (the variants' texts
    changed in copies of csrc)."""
    this = _native.library()
    jobs = []
    for name, edits in VARIANTS.items():
        d = root / name.replace(" ", "_")
        shutil.copytree(_native.CSRC_DIR, d)
        for f, old, new in edits:
            text = (d / f).read_text()
            if old not in text:
                raise SystemExit(f"fused_mlp_variants: {name}: the text to change is not in {f}")
            (d / f).write_text(text.replace(old, new))
        jobs.append((name, d))

    def one(job):
        name, d = job
        so = d / "lib.so"
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                        *(str(d / f) for f in SOURCES)], check=True, capture_output=True,
                       timeout=900)
        return name, so

    libs = {"shipped": this}
    with ThreadPoolExecutor(len(jobs)) as ex:
        for name, so in ex.map(one, jobs):
            lib = ctypes.CDLL(str(so))
            for entry in ENTRIES:
                fn, ref = getattr(lib, entry), getattr(this, entry)
                fn.argtypes, fn.restype = ref.argtypes, ref.restype
            libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fused_mlp_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))

        def timed(name, fn):
            _native.library = lambda: libs[name]
            try:
                return cs.cuda_ms(fn, reps=10)
            finally:
                _native.library = lambda: this

        rng = np.random.default_rng(cs.SEED + 13)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
        for stage, M, dim, heads in CASES:
            mlp = 4 * dim
            pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
                  for t in cs.block_params(rng, dim, heads, mlp, 32)]
            x = cs.dev_randn(g, (M, dim))
            order = ["shipped", "no GELU", "no LN2", "no fc2", "two warpgroups", "shipped"]
            with torch.inference_mode():
                for name in order:
                    ms = timed(name, lambda: fb.block_mlp(x, *pb[5:]))
                    train = ""
                    if fb.fuses_mlp(dim, mlp, train=True):
                        t_ms = timed(name, lambda: fb.block_mlp(x, *pb[5:], train=True))
                        train = f", training form {t_ms:.4f} ms"
                    print(f"stage {stage} M={M} dim {dim} fused MLP, {name}: {ms:.4f} ms{train}",
                          flush=True)
                for name in ("shipped", "no LN1", "shipped"):
                    ms = timed(name, lambda: fb.block_ln_gemm(x, pb[0], pb[1], pb[2]))
                    print(f"stage {stage} M={M} dim {dim} LN1 + qkv, {name}: {ms:.4f} ms",
                          flush=True)
            del x, pb
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
