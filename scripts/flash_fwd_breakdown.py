#!/usr/bin/env python3
"""Where the port's attention forward spends its time, on one NVIDIA GPU.

    python3 scripts/flash_fwd_breakdown.py

Builds ``surface_vision_transformers_tpu_torch/csrc/flash_attention.cu`` a
second time with ``-DSVT_FWD_PROFILE`` (into a temporary directory), which
makes each consumer warpgroup of the forward add up, with ``clock64``, the
cycles it spends in each part of its loop over key tiles: the loop's own
branch, issuing S (K awaited), issuing P.V (V awaited), waiting for S, the
softmax, waiting for P.V, the rescale and packing of P. Runs the forward
(random bf16 inputs) at SiT-base (B=128, 12 heads, N=1281; three consumer
warpgroups, 128-key tiles) and at SiT-tiny's training batch (B=256, 3
heads, N=321; one warpgroup, 64-key tiles), and prints each part's share of
the loop, beside the kernel's device time with and without the marks
(``chip_smoke.device_ms``).
Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms  # noqa: E402  (device time of calls queued behind a hold)
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import flash_attention as fa  # noqa: E402

PARTS = ("loop branch", "issue S (K awaited)", "issue P.V (V awaited)", "await S", "softmax",
         "await P.V", "rescale, pack P")
SHAPES = [(128, 12, 1281), (256, 3, 321)]


def declare(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    S = [P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong]
    D = [ctypes.c_uint, ctypes.c_uint, ctypes.c_float, I]
    lib.svt_flash_attention_fwd.argtypes = S * 4 + [P] + [I] * 6 + D + [I, P]
    lib.svt_flash_attention_fwd.restype = I
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_breakdown: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    plain_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libflash_profile.so"
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-DSVT_FWD_PROFILE", "-shared",
                        "-o", str(so), str(_native.CSRC_DIR / "flash_attention.cu")],
                       check=True, capture_output=True, timeout=600)
        prof_lib = declare(ctypes.CDLL(str(so)))
    prof_lib.svt_flash_fwd_profile.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    sums = (ctypes.c_ulonglong * 8)()
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, H, N in SHAPES:
        q, k, v = ((sc * torch.randn((B, H, N, 64), device="cuda", generator=g)).bfloat16()
                   for sc in (1.5, 1.5, 1.0))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        print(f"B={B} H={H} N={N}: SDPA {sdpa:.4f} ms", flush=True)
        times = {}
        for name, lib in (("plain", plain_lib), ("marked", prof_lib)):
            _native.library = lambda lib=lib: lib
            try:
                times[name] = device_ms(lambda: fa.flash_attention_fwd(q, k, v))
                if name == "marked":
                    _native.check(prof_lib.svt_flash_fwd_profile(sums))  # zero
                    fa.flash_attention_fwd(q, k, v)
                    torch.cuda.synchronize()
                    _native.check(prof_lib.svt_flash_fwd_profile(sums))
            finally:
                _native.library = lambda: plain_lib
        total = max(sums[7], 1)
        print(f"  kernel {times['plain']:.4f} ms ({times['marked']:.4f} with the marks); "
              "share of the loop: " + ", ".join(
                  f"{p} {sums[i] / total:.3f}" for i, p in enumerate(PARTS)), flush=True)
        del q, k, v
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
