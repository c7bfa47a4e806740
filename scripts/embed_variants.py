#!/usr/bin/env python3
"""Variants of the patch-embedding kernel, on one NVIDIA GPU.

    python3 scripts/embed_variants.py

Builds ``csrc/patch_embed.cu`` alone into libraries beside this tree's
kernels: as shipped (each consumer's K-slice released once its products
are done: wgmma waited to 0 each slice) and, in a copy whose text is
changed, with each released once the next slice's products are issued
(waited to 1); times ``svt_patch_embed`` on each by
``chip_smoke.device_ms``, two rounds of every variant in turn, at the
shapes of ``scripts/fwd_parts.py`` (sub-ico 2 at B = 256 and dims 192 and
384, sub-ico 3 at B = 64 and dim 768, sub-ico 5 at B = 64 and dim 96, fp32
x), and checks that each variant's output equals the shipped one's bits.
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

import chip_smoke as cs  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402

# the shipped consumer loop's wait and release, and the deferred form that
# replaces them in a copy of the source (the last slice released after the
# loop)
EAGER = """        wg_wait<0>();
        wg_hold(acc);
#endif
        // the slice's products are done: release its A slice (on the last
        // pass over the item) and its W stage, and refill the stage
        if (tid == 0) {
          if (p == pl.passes - 1) mbar_arrive(&a_empty[slot]);
          if (MW > 1 && !resident) mbar_arrive(&we[st]);
        }
        if (loader && !resident && w + pl.sw < w_total) load_w(w + pl.sw);
      }
"""
DEFERRED = """        wg_wait<1>();
        wg_hold(acc);
#endif
        if (s > 0) release(prev_slot, prev_st, w - 1);
        prev_slot = slot;
        prev_st = st;
      }
      wg_wait<0>();
      wg_hold(acc);
      release(prev_slot, prev_st, w - 1);
"""
RELEASE = """      auto release = [&](int slot, int st, long long wd) {
        if (tid == 0) {
          if (p == pl.passes - 1) mbar_arrive(&a_empty[slot]);
          if (MW > 1 && !resident) mbar_arrive(&we[st]);
        }
        if (loader && !resident && wd + pl.sw < w_total) load_w(wd + pl.sw);
      };
      int prev_slot = 0, prev_st = 0;
      for (int s = 0; s < pl.ks; ++s, ++w) {"""
LOOP = "      for (int s = 0; s < pl.ks; ++s, ++w) {"


def deferred(src: str) -> str:
    if EAGER not in src or src.count(LOOP) != 1:
        raise SystemExit("embed_variants: patch_embed.cu's consumer loop is not the one this "
                         "script knows")
    return src.replace(EAGER, DEFERRED).replace(LOOP, RELEASE)


VARIANTS = {"shipped": None, "deferred release": deferred}
CASES = [(2, 256, 192), (2, 256, 384), (3, 64, 768), (5, 64, 96)]  # (sub_ico, B, dim)


def main() -> None:
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.ops import patch_embed as pe

    if not torch.cuda.is_available():
        raise SystemExit("embed_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        shipped = (_native.CSRC_DIR / "patch_embed.cu").read_text()
        for name, change in VARIANTS.items():
            src, so = Path(tmp) / f"v{len(jobs)}.cu", Path(tmp) / f"lib{len(jobs)}.so"
            src.write_text(shipped if change is None else change(shipped))
            jobs[name] = (so, subprocess.Popen(
                [_native._nvcc(), *_native.NVCC_FLAGS, f"-I{_native.CSRC_DIR}", "-shared",
                 "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs = {}
        for name, (so, proc) in jobs.items():
            log = proc.communicate(timeout=900)[0]
            if proc.returncode:
                raise SystemExit(f"embed_variants: nvcc failed on {name}:\n{log}")
            lib = ctypes.CDLL(str(so))
            lib.svt_patch_embed.argtypes = this.svt_patch_embed.argtypes
            lib.svt_patch_embed.restype = ctypes.c_int
            libs[name] = lib
        rng = np.random.default_rng(cs.SEED + 21)
        for sub_ico, B, dim in CASES:
            table = load_patch_table(6, sub_ico).indices
            L, V = table.shape
            idx = pe.table_tensor(table, "cuda")
            x = torch.from_numpy(rng.standard_normal((B, 4, 40962)).astype(np.float32)).cuda()
            w = torch.from_numpy(rng.uniform(-0.05, 0.05, (dim, -(-4 * V // 64) * 64)).astype(
                np.float32)).cuda().bfloat16()
            b = torch.from_numpy(rng.uniform(-0.05, 0.05, dim).astype(np.float32)).cuda()
            outs = {n: torch.empty((B, L, dim), dtype=torch.bfloat16, device="cuda")
                    for n in libs}

            def call(name):
                err = libs[name].svt_patch_embed(
                    x.data_ptr(), 1, idx.data_ptr(), w.data_ptr(), b.data_ptr(),
                    outs[name].data_ptr(), B, 4, 40962, L, V, w.shape[1], dim, 0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"embed_variants: {name} failed (CUDA error {err})")

            times = {n: [] for n in libs}
            for _ in range(2):
                for name in libs:
                    times[name].append(cs.device_ms(lambda: call(name)))
            same = all(torch.equal(o, outs["shipped"]) for o in outs.values())
            print(f"sub-ico {sub_ico} B={B} dim {dim} fp32 x (ms, two rounds): " + "; ".join(
                f"{n} {t[0]:.4f} / {t[1]:.4f}" for n, t in times.items())
                + f"; outputs equal across variants {same}", flush=True)
            del x, outs
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
