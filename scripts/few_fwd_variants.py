#!/usr/bin/env python3
"""The few-query attention forward's ring depth, on one NVIDIA GPU.

    python3 scripts/few_fwd_variants.py

Builds ``csrc/flash_attention.cu`` alone into libraries beside this tree's
kernels, one with the shipped rule (``few_fwd_stages``: as many CTAs an SM
as a two-stage ring lets fit, then the deepest ring that keeps them) and one
each with the ring fixed at 2, 3, 4, 6 and 8 stages (the rule's return
changed in a copy of the source), and times ``flash_attention_fwd`` of 8 queries
(the CLS block's rows, Q given) on each by ``chip_smoke.device_ms``, two
rounds of every variant in turn, at SiT-tiny (B = 256, 3 heads, 321 keys),
SiT-small width (6 heads) and SiT-base (B = 32, 12 heads, 1,281 keys). The
outputs of every variant are the same bits (the ring's depth moves no sum).
Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import flash_attention as fa  # noqa: E402

RULE = "  return room < 2 ? 2 : room > FEW_FWD_MAX_STAGES ? FEW_FWD_MAX_STAGES : room;"
VARIANTS = {"shipped rule": None, **{f"{n} stages": n for n in (2, 3, 4, 6, 8)}}
SHAPES = [(256, 3, 321), (256, 6, 321), (32, 12, 1281)]  # (B, heads, keys), 8 queries


class Lib:
    """A variant's forward entry, declared as this tree's, beside this
    tree's error strings."""

    def __init__(self, so, this):
        lib = ctypes.CDLL(str(so))
        self.svt_flash_attention_fwd = lib.svt_flash_attention_fwd
        self.svt_flash_attention_fwd.argtypes = this.svt_flash_attention_fwd.argtypes
        self.svt_flash_attention_fwd.restype = ctypes.c_int
        self.svt_error_string = this.svt_error_string


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("few_fwd_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this = _native.library()
    src = _native.CSRC_DIR / "flash_attention.cu"
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        shipped = src.read_text()
        if RULE not in shipped:
            raise SystemExit("few_fwd_variants: few_fwd_stages is not the rule this script knows")
        for name, stages in VARIANTS.items():
            v, so = Path(tmp) / f"v{len(jobs)}.cu", Path(tmp) / f"lib{len(jobs)}.so"
            v.write_text(shipped if stages is None else shipped.replace(RULE, f"  return {stages};"))
            jobs[name] = (so, subprocess.Popen(
                [_native._nvcc(), *_native.NVCC_FLAGS, f"-I{_native.CSRC_DIR}", "-shared", "-o",
                 str(so), str(v)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs = {}
        for name, (so, proc) in jobs.items():
            log = proc.communicate(timeout=900)[0]
            if proc.returncode:
                raise SystemExit(f"few_fwd_variants: nvcc failed on {name}:\n{log}")
            libs[name] = Lib(so, this)
        g = torch.Generator(device="cuda").manual_seed(cs.SEED + 16)
        for B, H, nk in SHAPES:
            q = cs.dev_randn(g, (B, H, 8, cs.DH), 1.5)
            k, v = cs.dev_randn(g, (B, H, nk, cs.DH), 1.5), cs.dev_randn(g, (B, H, nk, cs.DH))
            times, outs = {n: [] for n in libs}, {}
            for _ in range(2):
                for name, lib in libs.items():
                    _native.library = lambda lib=lib: lib
                    try:
                        outs[name] = fa.flash_attention_fwd(q, k, v)
                        times[name].append(cs.device_ms(lambda: fa.flash_attention_fwd(q, k, v)))
                    finally:
                        _native.library = lambda: this
            same = all(torch.equal(o[0], outs["shipped rule"][0]) for o in outs.values())
            print(f"B={B} H={H} 8 queries, {nk} keys (ms, two rounds): " + "; ".join(
                f"{n} {t[0]:.4f} / {t[1]:.4f}" for n, t in times.items())
                + f"; outputs equal across variants {same}", flush=True)


if __name__ == "__main__":
    main()
