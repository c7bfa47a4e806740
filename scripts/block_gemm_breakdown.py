#!/usr/bin/env python3
"""Where the block GEMM engine spends its time, on one NVIDIA GPU.

    python3 scripts/block_gemm_breakdown.py

Builds ``fused_block.cu``, ``fused_block_bwd.cu``, ``fused_block_int8.cu`` and
``flash_attention.cu`` of ``surface_vision_transformers_tpu_torch/csrc`` a
second time with
``-DSVT_GEMM_PROFILE`` (into a temporary directory), which makes the
engine's warpgroups (``csrc/gemm.cuh``) add up, with ``clock64``, the cycles
each part of their walk over the output tiles takes: for the consumers,
waiting for a stage to land, starting a k-step's wgmma, waiting for the
k-step before it, waiting for a tile's last k-step, the epilogue, and the
rest (the walk's own bookkeeping); for the producer, the share of its walk
spent waiting for a free stage. Runs each GEMM of ``chip_smoke.py`` phase 25
(the forward's four at SiT-tiny B=256 and SiT-base B=32, the backward's
eight at SiT-tiny B=256) and the int8 block's (qkv, out, fc1's two passes,
fc2 at SiT-base B=64, phase 20's block) on random operands and prints the
shares beside the kernel's CUDA-event time with and without the marks.
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

from chip_smoke import cuda_ms  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as fbi8  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import quant  # noqa: E402

PARTS = ("await stage", "start wgmma", "await k-step", "await last k-step", "epilogue")
TINY_M, BASE_M, INT8_M = 256 * 321, 32 * 1281, 64 * 1281


def cases(rng):
    """(label, call) of each GEMM of phase 25, on random bf16 operands."""
    def bf(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
            "cuda", torch.bfloat16)

    for width, M, (dim, mlp, hd) in (("SiT-tiny", TINY_M, (192, 768, 192)),
                                     ("SiT-base", BASE_M, (768, 3072, 768))):
        for name, N, K in (("qkv", 3 * hd, dim), ("out", dim, hd), ("fc1", mlp, dim),
                           ("fc2", dim, mlp)):
            a, w = bf((M, K)), bf((N, K), K ** -0.5)
            bias = torch.zeros(N, device="cuda")
            res = bf((M, N)) if name in ("out", "fc2") else None
            yield (f"forward {name} {width} M={M} N={N} K={K}",
                   lambda a=a, w=w, bias=bias, res=res, name=name: fb.block_gemm(
                       a, w, None if name == "qkv" else bias, res, gelu=name == "fc1"))
    M, dim, mlp, hd = TINY_M, 192, 768, 192
    for name, N, K, kind in (("df1", mlp, dim, "gelu"), ("dh from df1", dim, mlp, "f32"),
                             ("da", hd, dim, "bf16"), ("dh from dqkv", dim, 3 * hd, "f32")):
        a, w = bf((M, K), 0.01), bf((K, N), N ** -0.5)
        pre = torch.randn((M, N), device="cuda") if kind == "gelu" else None
        out_dtype = torch.float32 if kind == "f32" else torch.bfloat16
        yield (f"backward {name} M={M} N={N} K={K}",
               lambda a=a, w=w, pre=pre, out_dtype=out_dtype: fb.block_gemm_nn(
                   a, w, pre, out_dtype=out_dtype))
    for name, m_out, n_out in (("dW_fc2", dim, mlp), ("dW_fc1", mlp, dim), ("dW_out", dim, hd),
                               ("dW_qkv", 3 * hd, dim)):
        a, b = bf((M, m_out), 0.01), bf((M, n_out))
        yield (f"backward {name} Mout={m_out} Nout={n_out} K={M}",
               lambda a=a, b=b: fb.block_weight_grad(a, b))
    M, dim, mlp, hd = INT8_M, 768, 3072, 768
    for name, N, K in (("qkv", 3 * hd, dim), ("out", dim, hd), ("fc1_max", mlp, dim),
                       ("fc1_q8", mlp, dim), ("fc2", dim, mlp)):
        qa, sa = quant.quant_rows(torch.randn((M, K), device="cuda"))
        qw, sw = quant.quantize_weight_int8(torch.randn((N, K), device="cuda") * K ** -0.5)
        bias = torch.randn(N, device="cuda") * 0.1
        res = (bf((M, N)) if name == "out" else torch.randn((M, N), device="cuda")
               if name == "fc2" else None)
        part = fbi8.int8_block_gemm("fc1_max", qa, sa.reshape(-1), qw, sw, bias) \
            if name == "fc1_q8" else None
        yield (f"int8 {name} M={M} N={N} K={K}",
               lambda a=(name, qa, sa.reshape(-1), qw, sw, bias, res, part):
               fbi8.int8_block_gemm(*a[:7], part=a[7]))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("block_gemm_breakdown: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    plain_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libgemm_profile.so"
        res = subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-DSVT_GEMM_PROFILE",
                              "-shared", "-o", str(so), *(str(_native.CSRC_DIR / f) for f in (
                                  "fused_block.cu", "fused_block_bwd.cu", "fused_block_int8.cu",
                                  "flash_attention.cu"))],
                             check=True, capture_output=True, text=True, timeout=900)
        report = (res.stdout + res.stderr).replace("\n    ", " ")
        print("\n".join(l for l in report.splitlines() if "C75" in l), flush=True)
        prof_lib = ctypes.CDLL(str(so))
    for entry, argtypes in (("svt_block_gemm", plain_lib.svt_block_gemm.argtypes),
                            ("svt_block_gemm_nn", plain_lib.svt_block_gemm_nn.argtypes),
                            ("svt_block_weight_grad", plain_lib.svt_block_weight_grad.argtypes),
                            ("svt_block_weight_grad_workspace",
                             plain_lib.svt_block_weight_grad_workspace.argtypes),
                            ("svt_int8_block_gemm", plain_lib.svt_int8_block_gemm.argtypes)):
        fn = getattr(prof_lib, entry)
        fn.argtypes = argtypes
        fn.restype = getattr(plain_lib, entry).restype
    prof_lib.svt_error_string.restype = ctypes.c_char_p
    sums = {k: (ctypes.c_ulonglong * 8)() for k in ("fwd", "bwd", "int8")}
    readers = {"fwd": prof_lib.svt_gemm_profile, "bwd": prof_lib.svt_gemm_profile_bwd,
               "int8": prof_lib.svt_gemm_profile_int8}
    for r in readers.values():
        r.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    rng = np.random.default_rng(0)
    for label, call in cases(rng):
        which = label.split()[0].replace("forward", "fwd").replace("backward", "bwd")
        times = {}
        for name, lib in (("plain", plain_lib), ("marked", prof_lib)):
            _native.library = lambda lib=lib: lib
            try:
                try:
                    times[name] = cuda_ms(call)
                except RuntimeError as e:
                    print(f"{label} on the {name} library: {e}", flush=True)
                    raise
                if name == "marked":
                    _native.check(readers[which](sums[which]))  # zero
                    call()
                    torch.cuda.synchronize()
                    _native.check(readers[which](sums[which]))
            finally:
                _native.library = lambda: plain_lib
        s = sums[which]
        total = max(s[5], 1)
        print(f"{label}: kernel {times['plain']:.4f} ms ({times['marked']:.4f} with the marks); "
              "consumers' walk: "
              + ", ".join(f"{p} {s[i] / total:.3f}" for i, p in enumerate(PARTS))
              + f", other {1 - sum(s[:5]) / total:.3f}; producer waiting for a free stage "
              f"{s[6] / max(s[7], 1):.3f} of its walk", flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
