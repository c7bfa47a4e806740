#!/usr/bin/env python3
"""Where the few-query attention backward spends its time, on one NVIDIA GPU.

    python3 scripts/few_bwd_variants.py

Builds copies of ``csrc/flash_attention.cu``, each with one part of
``flash_bwd_few_kernel`` (the CLS block's 8 query rows against every key)
changed in the copy's text, into libraries beside this tree's, and times
each one's backward (``flash_attention_bwd``, ``chip_smoke.device_ms``) at
the SiT-tiny (B = 256, 3 heads, 321 keys) and SiT-base (B = 32, 12 heads,
1281 keys) CLS shapes, two rounds of every variant in turn:

- shipped: dK and dV staged in the spent ring stage, out by the copy engine;
- dK and dV out by the threads in 16-byte pieces of the staged rows;
- dK and dV stored from the accumulators in 4-byte pieces (the first form);
- no dK / dV stores; no dQ products; the loads alone (no products, no
  stores);
- the K / V ring at 3 stages and 4 CTAs an SM, or 2 stages and 5 (shipped:
  4 stages, 3 CTAs).

The variants other than the store forms compute wrong gradients: they are
timings, not kernels. Needs a CUDA device and nvcc; imports nothing of JAX.
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

BULK = """    {
      const int which = tid >> 6, r = tid & 63;
      if (k0 + r < nk) bulk_store((which ? dv : dk).row(b, h, k0 + r), stg[which] + r * 64, 128);
      bulk_commit();
    }"""
THREADS = """#pragma unroll
    for (int i = tid; i < 2 * 64 * 8; i += 128) {
      const int which = i >> 9, r = (i >> 3) & 63, ch = i & 7;
      if (k0 + r < nk)
        *reinterpret_cast<uint4*>((which ? dv : dk).row(b, h, k0 + r) + ch * 8) =
            *reinterpret_cast<const uint4*>(stg[which] + r * 64 + ch * 8);
    }"""
FOUR_BYTE = """#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = k0 + r0 + 8 * rr;
      if (key >= nk) continue;
      bf16* dkr = dk.row(b, h, key);
      bf16* dvr = dv.row(b, h, key);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int d = 8 * jj + 2 * t;
        *reinterpret_cast<uint32_t*>(dkr + d) = pack_bf16(dka[4 * jj + 2 * rr],
                                                          dka[4 * jj + 2 * rr + 1]);
        *reinterpret_cast<uint32_t*>(dvr + d) = pack_bf16(dva[4 * jj + 2 * rr],
                                                          dva[4 * jj + 2 * rr + 1]);
      }
    }"""
STAGE_START = "    __syncthreads();  // every warp is past the products that read the stage"
PRODUCTS = "    // S^T = K Q^T, dP^T = V dO^T"
DQ = "      wgmma_ss<1, 0>(dqa, sw128_desc(kt + G * 16 * 64), sw128_desc(sm.ds + G * 16), 1);"
RING = ("constexpr int FEW_STAGES = 4;", "constexpr int FEW_CTAS = 3;")


def variants(src: str) -> dict:
    """name -> the copy's text."""
    staged = src[src.index(STAGE_START):src.index(BULK) + len(BULK)]
    return {
        "shipped": src,
        "16-byte thread stores": src.replace(BULK, THREADS),
        "4-byte stores from the accumulators": src.replace(staged, FOUR_BYTE),
        "no dK / dV stores": src.replace("if (k0 + r < nk) bulk_store", "if (nk < 0) bulk_store"),
        "no dQ products": src.replace(DQ, "      (void)G;"),
        "loads only": src.replace(PRODUCTS, "    if (nk > 0) continue;\n" + PRODUCTS),
        "3 stages, 4 CTAs": src.replace(RING[0], "constexpr int FEW_STAGES = 3;").replace(
            RING[1], "constexpr int FEW_CTAS = 4;"),
        "2 stages, 5 CTAs": src.replace(RING[0], "constexpr int FEW_STAGES = 2;").replace(
            RING[1], "constexpr int FEW_CTAS = 5;"),
    }


def build(name: str, text: str, tmp: Path):
    d = tmp / str(abs(hash(name)))
    shutil.copytree(_native.CSRC_DIR, d)
    (d / "flash_attention.cu").write_text(text)
    so = d / "libfew.so"
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                    str(d / "flash_attention.cu")], check=True, capture_output=True, timeout=900)
    return ctypes.CDLL(str(so))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("few_bwd_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this = _native.library()
    src = (_native.CSRC_DIR / "flash_attention.cu").read_text()
    texts = variants(src)
    for name, text in texts.items():
        if name != "shipped" and text == src:
            raise SystemExit(f"few_bwd_variants: variant {name!r} changed nothing in the source")
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 16)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, text in texts.items():
            lib = build(name, text, Path(tmp))
            for e in ("svt_flash_attention_bwd", "svt_flash_attention_bwd_workspace"):
                fn, ref = getattr(lib, e), getattr(this, e)
                fn.argtypes, fn.restype = ref.argtypes, ref.restype
            libs[name] = type("Lib", (), {e: getattr(lib, e) for e in (
                "svt_flash_attention_bwd", "svt_flash_attention_bwd_workspace")}
                | {"svt_error_string": this.svt_error_string})
        for B, H, nk in ((256, 3, 321), (32, 12, 1281)):
            q, do = cs.dev_randn(g, (B, H, 8, cs.DH), 1.5), cs.dev_randn(g, (B, H, 8, cs.DH))
            k, v = cs.dev_randn(g, (B, H, nk, cs.DH), 1.5), cs.dev_randn(g, (B, H, nk, cs.DH))
            o, lse = fa.flash_attention_fwd(q, k, v)
            times = {n: [] for n in libs}
            try:
                for _ in range(2):
                    for name in libs:
                        _native.library = lambda n=name: libs[n]
                        times[name].append(cs.device_ms(
                            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)))
            finally:
                _native.library = lambda: this
            bound = cs.attention_bound(B, H, 8, nk, (), (q, k, v, o, lse, do, q, k, v))[1][0]
            print(f"B={B} H={H} 8 queries, {nk} keys (bound {bound:.4f} ms by bytes): " + "; ".join(
                f"{n} {sum(t) / 2:.4f} ms ({', '.join(f'{x:.4f}' for x in t)})"
                for n, t in times.items()), flush=True)


if __name__ == "__main__":
    main()
