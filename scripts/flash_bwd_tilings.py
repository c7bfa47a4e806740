#!/usr/bin/env python3
"""The resident attention backward's tiling choices, on one NVIDIA GPU.

    python3 scripts/flash_bwd_tilings.py

Builds a copy of this tree's ``flash_attention.cu`` once per variant, each
with one constant of the resident backward changed in the copy's text, into
temporary libraries beside the shipped build, then times the dh-32 backward
through ``flash_attention_qkv_bwd`` at the seven MS-SiT folds of a batch of
64 (``chip_smoke.MSSIT_FOLDS``) on each, with one timer
(``chip_smoke.device_ms``), every variant in turn, then again in reverse:

- shipped: sequences of N <= 32 packed 64 // N to a tile, the one-tile
  kernel at four CTAs an SM (up to 128 registers);
- pack 1 a tile: ``resident_pack`` returns 1, one sequence a tile at any N
  (stage 2's axial fold: 20 of 64 rows);
- one-tile kernel 5 CTAs/SM: ``RES_T1_CTAS`` 5 (96 registers).

Prints each variant's time at each fold (the mean of its two readings), its
ratio to the shipped build's, the largest difference of its output from
the shipped one's over the largest output (packing moves where a
sequence's keys fall in the k16 steps, so the last bit may move), and the
sum over a batch's twelve launches.
Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import shutil
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

# variant -> (the shipped source's line, its replacement in the copy)
VARIANTS = {
    "pack 1 a tile": ("int resident_pack(int n) { return n <= 32 ? 64 / n : 1; }",
                      "int resident_pack(int n) { return 1; }"),
    "one-tile kernel 5 CTAs/SM": ("constexpr int RES_T1_CTAS = 4;",
                                  "constexpr int RES_T1_CTAS = 5;")}
ENTRIES = ("svt_flash_attention_bwd", "svt_flash_attention_bwd_workspace")


class Variant:
    """A variant library's attention backward entries, with this tree's
    signatures; everything else from the shipped library."""

    def __init__(self, lib, this_lib):
        self._this = this_lib
        for name in ENTRIES:
            fn, ref = getattr(lib, name), getattr(this_lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            setattr(self, name, fn)

    def __getattr__(self, name):
        return getattr(self._this, name)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_tilings: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this_lib = _native.library()
    libs = {"shipped": this_lib}
    with tempfile.TemporaryDirectory() as tmp:
        text = (_native.CSRC_DIR / "flash_attention.cu").read_text()
        procs = {}
        for name, (line, repl) in VARIANTS.items():
            if text.count(line) != 1:
                raise SystemExit(f"flash_bwd_tilings: {line!r} is not once in the source")
            csrc = Path(tmp) / f"csrc{len(procs)}"
            shutil.copytree(_native.CSRC_DIR, csrc)
            (csrc / "flash_attention.cu").write_text(text.replace(line, repl))
            so = Path(tmp) / f"lib{len(procs)}.so"
            procs[name] = (so, subprocess.Popen(
                [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                 str(csrc / "flash_attention.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
        for name, (so, proc) in procs.items():
            out = proc.communicate(timeout=900)[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{out.decode()[-4000:]}")
            libs[name] = Variant(ctypes.CDLL(str(so)), this_lib)

    def run(name, fn):
        _native.library = lambda: libs[name]
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    totals = {n: 0.0 for n in libs}
    for stage, Bf, N, _, heads, per in cs.MSSIT_FOLDS:
        hd = heads * cs.MSSIT_DH
        qkv = torch.cat([cs.dev_randn(g, (Bf, N, 2 * hd), 1.5), cs.dev_randn(g, (Bf, N, hd))], -1)
        do = cs.dev_randn(g, (Bf, N, hd))
        o, lse = fa.flash_attention_qkv_fwd(qkv, heads)

        def call():
            return fa.flash_attention_qkv_bwd(qkv, o, lse, do, heads)

        ref = call()
        diff = {n: ((run(n, call).float() - ref.float()).abs().max()
                    / ref.float().abs().max()).item() for n in libs}
        times = {n: [] for n in libs}
        for n in [*libs, *reversed(libs)]:
            times[n].append(run(n, lambda: cs.device_ms(call)))
        mean = {n: sum(t) / len(t) for n, t in times.items()}
        for n in libs:
            totals[n] += per * mean[n]
        print(f"stage {stage} ({Bf}, {heads}, {N}): " + "; ".join(
            f"{n} {mean[n]:.4f} ms ({mean[n] / mean['shipped']:.3f}x, max |diff| / max "
            f"{diff[n]:.3g})" for n in libs), flush=True)
        del qkv, do, o, lse, ref
        torch.cuda.empty_cache()
    print("a batch's twelve attention backwards: " + "; ".join(
        f"{n} {t:.4f} ms ({t / totals['shipped']:.3f}x)" for n, t in totals.items()), flush=True)


if __name__ == "__main__":
    main()
