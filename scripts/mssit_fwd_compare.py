#!/usr/bin/env python3
"""MS-SiT's forward chain beside another checkout's, on one NVIDIA GPU.

    python3 scripts/mssit_fwd_compare.py OTHER_CHECKOUT

Builds ``fused_block.cu`` and ``flash_attention.cu`` of OTHER_CHECKOUT's
``surface_vision_transformers_tpu_torch/csrc`` into one temporary library
beside this tree's kernels (the other's ``svt_fused_block``,
``svt_fused_block_train_fwd`` and ``svt_flash_attention_fwd`` must take
this tree's arguments), then at each of the seven MS-SiT folds of a batch of
64 (``chip_smoke.MSSIT_FOLDS``, dh 32) and at SiT-tiny (B = 256, N = 321,
dh 64) times on one timer (``chip_smoke.device_ms``), in the order other,
this, this, other:

- ``fused_block`` (serving) on either library;
- its training forward (``fused_block.train_forward``) on either library;
- the attention forward through ``flash_attention_qkv_fwd`` on either
  library, and SDPA's forward between the pairs;

and prints for each the largest difference between the two libraries'
outputs (every save of the training form) and the share of elements that
differ. Then the sums over a serving batch's twelve blocks. The other
library's chain writes its LayerNorm and MLP hidden scratch at every
width, so its runs get full-size scratch (``fuses_mlp`` is False for them).
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

import chip_smoke as cs  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import flash_attention as fa  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402

ENTRIES = ("svt_fused_block", "svt_fused_block_train_fwd", "svt_flash_attention_fwd",
           "svt_error_string")
CASES = [(f"stage {s} ({Bf}, {N}, {dim})", Bf, N, dim, heads, 32, per)
         for s, Bf, N, dim, heads, per in cs.MSSIT_FOLDS] + [
    ("SiT-tiny (256, 321, 192)", 256, 321, 192, 3, 64, 0)]


class Other:
    """The other library's entries with this tree's C signatures."""

    def __init__(self, lib, this_lib):
        for name in ENTRIES:
            fn, ref = getattr(lib, name), getattr(this_lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            setattr(self, name, fn)


def differ(a, b) -> str:
    """Largest |a - b| over the largest |b|, and the share of elements that
    differ."""
    a, b = a.float(), b.float()
    top = max(b.abs().max().item(), 1e-30)
    return (f"max |this - other| / max |other| {(a - b).abs().max().item() / top:.3g}, "
            f"share differing {(a != b).float().mean().item():.6f}")


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("mssit_fwd_compare: no CUDA device")
    other_csrc = Path(sys.argv[1]).resolve() / "surface_vision_transformers_tpu_torch" / "csrc"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libfwd_other.so"
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                        *(str(other_csrc / f) for f in ("fused_block.cu", "flash_attention.cu"))],
                       check=True, capture_output=True, timeout=900)
        other_lib = Other(ctypes.CDLL(str(so)), this_lib)
    libs = {"other": other_lib, "this": this_lib}
    fuses = fb.fuses_mlp

    def run(name, fn):
        _native.library = lambda: libs[name]
        fb.fuses_mlp = fuses if name == "this" else (lambda dim, mlp, train=False: False)
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib
            fb.fuses_mlp = fuses

    def both(call):
        """(mean ms by library, each reading) in the order other, this, this, other."""
        times = {n: [] for n in libs}
        for n in ("other", "this", "this", "other"):
            times[n].append(run(n, lambda: cs.device_ms(call)))
        return {n: sum(t) / 2 for n, t in times.items()}, times

    def line(label, what, ms, each, extra=""):
        print(f"{label} {what}: this {ms['this']:.4f} ms ({each['this']}), other "
              f"{ms['other']:.4f} ms ({each['other']}), this/other "
              f"{ms['this'] / ms['other']:.3f}{extra}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    totals = {k: {"this": 0.0, "other": 0.0} for k in ("attention", "block", "train")}
    for label, Bf, N, dim, heads, dh, per in CASES:
        mlp, hd = 4 * dim, heads * dh
        with torch.inference_mode():
            # the attention forward, packed qkv (the chains' layout)
            qkv = torch.cat([cs.dev_randn(g, (Bf, N, 2 * hd), 1.5),
                             cs.dev_randn(g, (Bf, N, hd))], -1)
            outs = {n: run(n, lambda: fa.flash_attention_qkv_fwd(qkv, heads)) for n in libs}
            att, att_each = both(lambda: fa.flash_attention_qkv_fwd(qkv, heads))
            q, k, v = fa.split_qkv(qkv, heads)
            sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            line(label, "attention forward", att, att_each,
                 f"; SDPA {sdpa:.4f} ms (this/SDPA {att['this'] / sdpa:.3f}, other/SDPA "
                 f"{att['other'] / sdpa:.3f}); o: {differ(outs['this'][0], outs['other'][0])}; "
                 f"lse: {differ(outs['this'][1], outs['other'][1])}")
            del qkv, q, k, v, outs
            # the block, serving and training forms
            rng = np.random.default_rng(cs.SEED + 13)
            pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
                  for t in cs.block_params(rng, dim, heads, mlp, dh)]
            kw = dict(heads=heads, dim_head=dh)
            x = cs.dev_randn(g, (Bf, N, dim), cs.X_SCALE)
            outs = {n: run(n, lambda: fb.fused_block(x, *pb, **kw)) for n in libs}
            blk, blk_each = both(lambda: fb.fused_block(x, *pb, **kw))
            line(label, f"fused_block (fused MLP: {fuses(dim, mlp)})", blk, blk_each,
                 f"; {differ(outs['this'], outs['other'])}")
            del outs
            trs = {n: run(n, lambda: fb.train_forward(x, *pb, **kw)) for n in libs}
            trn, trn_each = both(lambda: fb.train_forward(x, *pb, **kw))
            saves = "; ".join(f"{k_}: {differ(trs['this'][1][k_], trs['other'][1][k_])}"
                              for k_ in fb.TRAIN_SAVED)
            line(label, "training forward", trn, trn_each,
                 f"; out: {differ(trs['this'][0], trs['other'][0])}; {saves}")
            del trs, x, pb
        torch.cuda.empty_cache()
        for key, ms in (("attention", att), ("block", blk), ("train", trn)):
            for n in libs:
                totals[key][n] += per * ms[n]
    for key, what in (("attention", "attention forwards"), ("block", "fused_block calls"),
                      ("train", "training forwards")):
        t = totals[key]
        print(f"a serving batch's twelve MS-SiT {what}: this {t['this']:.4f} ms, other "
              f"{t['other']:.4f} ms, this/other {t['this'] / t['other']:.3f}", flush=True)


if __name__ == "__main__":
    main()
