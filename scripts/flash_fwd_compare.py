#!/usr/bin/env python3
"""The port's attention forward beside another checkout's, on one NVIDIA GPU.

    python3 scripts/flash_fwd_compare.py OTHER_CHECKOUT

Builds ``surface_vision_transformers_tpu_torch/csrc/flash_attention.cu`` of
OTHER_CHECKOUT alone into a temporary library (its C entry
``svt_flash_attention_fwd`` must take this tree's arguments) beside this
tree's kernels, then times the forward at the shapes of ``chip_smoke.py``'s
forward rows through this tree's wrappers on either library, with one timer
(``chip_smoke.device_ms``: ten calls queued behind a holding kernel), in the
order other, this, this, other, SDPA on the same inputs last:

- ``flash_attention`` at SiT-base, B=128 and B=64, 12 heads, N=1281, q/k/v
  as views of a packed qkv (phase 9);
- ``flash_attention_qkv`` at SiT-tiny, 3 heads, N=321, B=32 and B=256
  (phase 14);
- ``flash_attention_qkv_dropout``, B=256, rate 0.1 (phase 15);
- ``flash_attention_tiled``, B=2, 3 heads, N=5121 (phase 16).

Prints per row both libraries' times (the mean of their two readings), the
ratio of this tree's to the other's, each one's ratio to SDPA, and the
largest difference between the two outputs against the largest output.
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
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms  # noqa: E402  (device time of calls queued behind a hold)
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import flash_attention as fa  # noqa: E402

DH = 64
DROP_RATE, DROP_SEED = 0.1, 1234  # chip_smoke.py phase 15's


def declare(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    S = [P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong]
    D = [ctypes.c_uint, ctypes.c_uint, ctypes.c_float, I]
    lib.svt_flash_attention_fwd.argtypes = S * 4 + [P] + [I] * 5 + D + [I, P]
    lib.svt_flash_attention_fwd.restype = I
    return lib


def randn(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
        "cuda", torch.bfloat16)


def rows(rng):
    """(label, inputs, call, sdpa_call) of each forward row: call(*inputs)
    -> o through the port's wrapper, sdpa_call(*inputs) the same function
    under SDPA."""
    for B in (128, 64):
        qkv = torch.cat([randn(rng, (B, 1281, 2, 12, DH), 1.5),
                         randn(rng, (B, 1281, 1, 12, DH))], 2)
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        yield (f"flash_attention B={B} H=12 N=1281", (q, k, v),
               lambda q, k, v: fa.flash_attention_fwd(q, k, v)[0],
               lambda q, k, v: F.scaled_dot_product_attention(q, k, v))
    for B in (32, 256):
        qkv = torch.cat([randn(rng, (B, 321, 2 * 3 * DH), 1.5), randn(rng, (B, 321, 3 * DH))], -1)
        q, k, v = fa.split_qkv(qkv, 3)
        yield (f"flash_attention_qkv B={B} H=3 N=321", (qkv, q, k, v),
               lambda qkv, *_: fa.flash_attention_qkv_fwd(qkv, 3)[0],
               lambda _, q, k, v: F.scaled_dot_product_attention(q, k, v))
        if B == 256:
            yield (f"flash_attention_qkv_dropout B={B} H=3 N=321 rate {DROP_RATE}",
                   (qkv, q, k, v),
                   lambda qkv, *_: fa.flash_attention_qkv_dropout_fwd(
                       qkv, 3, 321, DROP_RATE, DROP_SEED)[0],
                   lambda _, q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                                     dropout_p=DROP_RATE))
    q, k, v = (randn(rng, (2, 3, 5121, DH), sc) for sc in (1.5, 1.5, 1.0))
    yield ("flash_attention_tiled B=2 H=3 N=5121", (q, k, v),
           lambda q, k, v: fa.flash_attention_tiled_fwd(q, k, v)[0],
           lambda q, k, v: F.scaled_dot_product_attention(q, k, v))


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_compare: no CUDA device")
    other_src = (Path(sys.argv[1]).resolve() / "surface_vision_transformers_tpu_torch" / "csrc"
                 / "flash_attention.cu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libflash_other.so"
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                        str(other_src)], check=True, capture_output=True, timeout=600)
        other_lib = declare(ctypes.CDLL(str(so)))
    libs = {"other": other_lib, "this": this_lib}

    def run(name, fn):
        _native.library = lambda: libs[name]
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib

    rng = np.random.default_rng(0)
    for label, args, call, sdpa_call in rows(rng):
        outs = {n: run(n, lambda: call(*args)).float() for n in libs}
        diff = (outs["this"] - outs["other"]).abs().max().item() / outs["other"].abs().max().item()
        times = {n: [] for n in libs}
        for n in ("other", "this", "this", "other"):
            times[n].append(run(n, lambda: device_ms(lambda: call(*args))))
        sdpa = device_ms(lambda: sdpa_call(*args))
        mean = {n: sum(t) / len(t) for n, t in times.items()}
        each = {n: ", ".join(f"{t:.4f}" for t in ts) for n, ts in times.items()}
        print(f"{label}: this {mean['this']:.4f} ms ({each['this']}), other "
              f"{mean['other']:.4f} ms ({each['other']}), this/other "
              f"{mean['this'] / mean['other']:.3f}; SDPA {sdpa:.4f} ms: this "
              f"{mean['this'] / sdpa:.3f}x, other {mean['other'] / sdpa:.3f}x; max |this - other| "
              f"/ max |other| {diff:.3g}", flush=True)
        del args, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
