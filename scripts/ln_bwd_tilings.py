#!/usr/bin/env python3
"""The standalone LayerNorm backward's tiling choices, on one NVIDIA GPU.

    python3 scripts/ln_bwd_tilings.py

Builds copies of this tree's ``fused_block.cu``, ``fused_block_bwd.cu`` and
``flash_attention.cu`` once per variant, each with constants of
``ln_bwd_kernel``'s launch changed in the copy's text, into temporary
libraries beside the shipped build, then runs ``fused_block_bwd`` after
the training forward on each, at the widths that take the standalone pass
(dims above 192): MS-SiT's stage 2 window fold and stage 3 (dh 32), and
SiT-base at B = 32 and B = 128 (N = 1281, dh 64). Per variant and shape it
prints the block backward whole (``chip_smoke.device_ms``) and its two
LayerNorm passes and their ``reduce`` launches alone (``chip_smoke.
chain_parts``) beside their byte floors (``chip_smoke.part_floors``), every
variant in turn, then again in reverse; and each variant's ``ln_bwd_kernel``
registers and spills from ptxas. Variants:

- shipped: 8 warps a CTA, two rows a warp (two warps a row past dim 384),
  at most 132 CTAs;
- 264 CTAs: at most 264 CTAs;
- 264 CTAs, two an SM: also ``__launch_bounds__`` asking for two CTAs an SM
  (128 registers);
- 16 warps a CTA: LNB_WARPS 16, at most 132 CTAs;
- one warp a row, 264 CTAs: past dim 384 one warp a row (24 values of each
  array a lane), at most 264 CTAs.

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402

CTAS = ("constexpr int LNB_WARPS = 8, LNB_CTAS = 132,",
        "constexpr int LNB_WARPS = 8, LNB_CTAS = 264,")
# variant -> [(the shipped source's text, its replacement in the copy)]
VARIANTS = {
    "264 CTAs": [CTAS],
    "264 CTAs, two an SM": [CTAS, (
        "__global__ void __launch_bounds__(LNB_WARPS * 32)\n    ln_bwd_kernel",
        "__global__ void __launch_bounds__(LNB_WARPS * 32, 2)\n    ln_bwd_kernel")],
    "16 warps a CTA": [("constexpr int LNB_WARPS = 8, LNB_CTAS = 132,",
                        "constexpr int LNB_WARPS = 16, LNB_CTAS = 132,")],
    "one warp a row, 264 CTAs": [
        CTAS, ("ln_bwd_kernel<RT, 3, 2, 2>", "ln_bwd_kernel<RT, 6, 2, 1>"),
        ("ln_bwd_kernel<RT, 3, 4, 2>", "ln_bwd_kernel<RT, 6, 4, 1>")]}
SOURCES = ("fused_block.cu", "fused_block_bwd.cu", "flash_attention.cu")
ENTRIES = ("svt_fused_block_bwd", "svt_block_bwd_workspace", "svt_block_bwd_dh_floats")
# (label, B, N, dim, heads, dh)
SHAPES = [("MS-SiT stage 2 window", 1280, 64, 384, 12, 32),
          ("MS-SiT stage 3", 64, 320, 768, 24, 32),
          ("SiT-base B=32", 32, 1281, 768, 12, 64),
          ("SiT-base B=128", 128, 1281, 768, 12, 64)]


class Variant:
    """A variant library's block backward entries, with this tree's
    signatures; everything else (the training forward) from the shipped
    library."""

    def __init__(self, lib, this_lib):
        self._this = this_lib
        for name in ENTRIES:
            fn, ref = getattr(lib, name), getattr(this_lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            setattr(self, name, fn)

    def __getattr__(self, name):
        return getattr(self._this, name)


def ln_registers(ptxas: str) -> str:
    """``ln_bwd_kernel``'s registers and spill stores per instance, from
    nvcc's ``-Xptxas=-v`` output."""
    out = []
    for m in re.finditer(r"Compiling entry function '\S*ln_bwd_kernel(\S*?)EEEv\S*'.*?"
                         r"(\d+) bytes spill stores.*?Used (\d+) registers", ptxas, re.S):
        rt = "float" if m.group(1).startswith("If") else "bf16"
        args = ", ".join([rt, *re.findall(r"Li(\d+)", m.group(1))])
        out.append(f"<{args}> {m.group(3)} registers, {m.group(2)} B spilled")
    return "; ".join(out)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ln_bwd_tilings: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this_lib = _native.library()
    libs = {"shipped": this_lib}
    log = _native.library_path().with_suffix(".log")
    if log.exists():
        print(f"shipped: {ln_registers(log.read_text())}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        text = (_native.CSRC_DIR / "fused_block_bwd.cu").read_text()
        procs = {}
        for name, subs in VARIANTS.items():
            t = text
            for line, repl in subs:
                if t.count(line) != 1:
                    raise SystemExit(f"ln_bwd_tilings: {line!r} is not once in the source")
                t = t.replace(line, repl)
            csrc = Path(tmp) / f"csrc{len(procs)}"
            shutil.copytree(_native.CSRC_DIR, csrc)
            (csrc / "fused_block_bwd.cu").write_text(t)
            so = Path(tmp) / f"lib{len(procs)}.so"
            procs[name] = (so, subprocess.Popen(
                [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                 *(str(csrc / f) for f in SOURCES)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
        for name, (so, proc) in procs.items():
            out = proc.communicate(timeout=900)[0].decode()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{out[-4000:]}")
            print(f"{name}: {ln_registers(out)}", flush=True)
            libs[name] = Variant(ctypes.CDLL(str(so)), this_lib)

    def run(name, fn):
        _native.library = lambda: libs[name]
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)
    for label, B, N, dim, heads, dh in SHAPES:
        mlp = 4 * dim
        rng = np.random.default_rng(cs.SEED + 15)
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in cs.block_params(rng, dim, heads, mlp, dh)]
        kw = dict(heads=heads, dim_head=dh)
        x, gy = cs.dev_randn(g, (B, N, dim), cs.X_SCALE), cs.dev_randn(g, (B, N, dim), cs.G_SCALE)
        _, sv = fb.train_forward(x, *pb, **kw)

        def call():
            return fb.fused_block_bwd(x, gy, *pb, saved=sv, **kw)

        ref = call()
        diff = {n: max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                       for a, b in zip(run(n, call), ref)) for n in libs}
        whole = {n: [] for n in libs}
        parts = {n: [] for n in libs}
        for n in [*libs, *reversed(libs)]:
            whole[n].append(run(n, lambda: cs.device_ms(call)))
            p = run(n, lambda: cs.chain_parts(call))
            fl = cs.part_floors(p, B, N, dim, heads, mlp, dh)
            parts[n].append([(q, m, f) for (q, m), f in zip(p, fl) if "LN" in q])
        for n in libs:
            runs = [r for r in parts[n] if [q for q, *_ in r] == [q for q, *_ in parts[n][0]]]
            ln = [(q, sum(r[i][1] for r in runs) / len(runs), f)
                  for i, (q, _, f) in enumerate(runs[0])]
            print(f"{label} ({B}, {N}, {dim}) {n}: fused_block_bwd {sum(whole[n]) / 2:.4f} ms, "
                  f"max |diff| / max against shipped {diff[n]:.3g}; " + "; ".join(
                      f"{q} {m:.4f} ms (floor {f:.4f}, {m / f:.2f}x)" for q, m, f in ln),
                  flush=True)
        del x, gy, sv, pb, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
