#!/usr/bin/env python3
"""MS-SiT's training backward beside another checkout's, on one NVIDIA GPU.

    python3 scripts/mssit_bwd_compare.py OTHER_CHECKOUT

Builds ``fused_block.cu``, ``fused_block_bwd.cu`` and ``flash_attention.cu``
of OTHER_CHECKOUT's ``surface_vision_transformers_tpu_torch/csrc`` into one
temporary library beside this tree's kernels (the other's
``svt_fused_block_bwd``, ``svt_block_bwd_workspace`` and
``svt_flash_attention_bwd`` must take this tree's arguments; its
``svt_flash_attention_bwd_workspace`` may take (B, heads, nq, dh), as
before the resident backward), then at each of the seven MS-SiT folds of a
batch of 64 (``chip_smoke.MSSIT_FOLDS``, dh 32) and at SiT-tiny (B = 256,
N = 321, dh 64):

- the attention backward through ``flash_attention_qkv_bwd`` on either
  library and SDPA's backward, by ``chip_smoke.device_ms`` in the order
  other, this, this, other (SDPA between the pairs);
- ``fused_block_bwd`` after this tree's training forward on either library,
  the same way, and the largest difference between their 12 outputs;
- each part of either chain alone (``chip_smoke.chain_parts``: its device
  time under torch.profiler, mean of 3 calls) beside its byte floor
  (``chip_smoke.part_floors``).

Then both attention backwards and both block backwards summed over a
batch's twelve launches. A library without ``svt_block_bwd_dh_floats``
(from before the LayerNorm epilogues) writes its fp32 dh at every width, so
the other library's runs then get the full dh scratch.
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

ENTRIES = ("svt_fused_block_bwd", "svt_block_bwd_workspace", "svt_flash_attention_bwd",
           "svt_flash_attention_fwd", "svt_error_string")
CASES = [(f"stage {s} ({Bf}, {N}, {dim})", Bf, N, dim, heads, 32, per)
         for s, Bf, N, dim, heads, per in cs.MSSIT_FOLDS] + [
    ("SiT-tiny (256, 321, 192)", 256, 321, 192, 3, 64, 0)]


class Other:
    """The other library's entries with this tree's C signatures; its
    attention workspace entry as it takes its arguments."""

    def __init__(self, lib, this_lib):
        for name in ENTRIES:
            fn, ref = getattr(lib, name), getattr(this_lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            setattr(self, name, fn)
        ws = lib.svt_flash_attention_bwd_workspace
        ws.restype = ctypes.c_longlong
        ws.argtypes = [ctypes.c_int] * 4 if not hasattr(lib, "svt_block_gemm_ln") else [
            ctypes.c_int] * 5
        four = len(ws.argtypes) == 4
        self.svt_flash_attention_bwd_workspace = (
            (lambda B, H, nq, nk, dh: ws(B, H, nq, dh)) if four else ws)
        if hasattr(lib, "svt_block_bwd_dh_floats"):
            dhf = lib.svt_block_bwd_dh_floats
            ref = this_lib.svt_block_bwd_dh_floats
            dhf.argtypes, dhf.restype = ref.argtypes, ref.restype
            self.svt_block_bwd_dh_floats = dhf
        else:
            self.svt_block_bwd_dh_floats = lambda B, N, dim, cls: B * N * dim


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("mssit_bwd_compare: no CUDA device")
    other_csrc = Path(sys.argv[1]).resolve() / "surface_vision_transformers_tpu_torch" / "csrc"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libbwd_other.so"
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                        *(str(other_csrc / f) for f in ("fused_block.cu", "fused_block_bwd.cu",
                                                        "flash_attention.cu", "fused_mlp.cu")
                          if (other_csrc / f).exists())],
                       check=True, capture_output=True, timeout=900)
        other_lib = Other(ctypes.CDLL(str(so)), this_lib)
    libs = {"other": other_lib, "this": this_lib}
    epis = {"other": cs.gemm_epis(Path(sys.argv[1]).resolve()), "this": cs.gemm_epis(ROOT)}

    def run(name, fn):
        _native.library = lambda: libs[name]
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib

    def both(call):
        """(mean ms by library, each reading) in the order other, this, this, other."""
        times = {n: [] for n in libs}
        for n in ("other", "this", "this", "other"):
            times[n].append(run(n, lambda: cs.device_ms(call)))
        return {n: sum(t) / 2 for n, t in times.items()}, times

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    totals = {k: {"this": 0.0, "other": 0.0} for k in ("attention", "block")}
    for label, Bf, N, dim, heads, dh, per in CASES:
        mlp, hd = 4 * dim, heads * dh
        # the attention backward, packed qkv (the chains' and the modular model's layout)
        qkv = torch.cat([cs.dev_randn(g, (Bf, N, 2 * hd), 1.5), cs.dev_randn(g, (Bf, N, hd))], -1)
        do = cs.dev_randn(g, (Bf, N, hd))
        o, lse = fa.flash_attention_qkv_fwd(qkv, heads)
        outs = {n: run(n, lambda: fa.flash_attention_qkv_bwd(qkv, o, lse, do, heads))
                for n in libs}
        diff = ((outs["this"].float() - outs["other"].float()).abs().max()
                / outs["other"].float().abs().max()).item()
        att, att_each = both(lambda: fa.flash_attention_qkv_bwd(qkv, o, lse, do, heads))
        q, k, v = (t.detach().requires_grad_() for t in fa.split_qkv(qkv, heads))
        sdpa_out = F.scaled_dot_product_attention(q, k, v)
        do4 = do.view(Bf, N, heads, dh).transpose(1, 2)
        sdpa = cs.device_ms(lambda: torch.autograd.grad(sdpa_out, (q, k, v), do4,
                                                        retain_graph=True))
        del q, k, v, sdpa_out, outs
        print(f"{label} attention backward: this {att['this']:.4f} ms ({att_each['this']}), "
              f"other {att['other']:.4f} ms ({att_each['other']}), this/other "
              f"{att['this'] / att['other']:.3f}; SDPA backward {sdpa:.4f} ms (this/SDPA "
              f"{att['this'] / sdpa:.3f}, other/SDPA {att['other'] / sdpa:.3f}); max |this - "
              f"other| / max |other| {diff:.3g}", flush=True)
        del qkv, do, o, lse
        # the block backward after this tree's training forward
        rng = np.random.default_rng(cs.SEED + 12)
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in cs.block_params(rng, dim, heads, mlp, dh)]
        kw = dict(heads=heads, dim_head=dh)
        x, gy = cs.dev_randn(g, (Bf, N, dim), cs.X_SCALE), cs.dev_randn(g, (Bf, N, dim), cs.G_SCALE)
        _, sv = fb.train_forward(x, *pb, **kw)

        def call():
            return fb.fused_block_bwd(x, gy, *pb, saved=sv, **kw)

        outs = {n: run(n, call) for n in libs}
        diffs = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                 for a, b in zip(outs["this"], outs["other"])]
        del outs
        blk, blk_each = both(call)
        floors = {n: cs.chain_bytes(Bf, N, dim, heads, mlp, dh, fused_ln=(n == "this") and
                                    fb.ln_in_epilogue(dim))[2] / cs.PEAK_BYTES * 1e3 for n in libs}
        print(f"{label} fused_block_bwd: this {blk['this']:.4f} ms ({blk_each['this']}), other "
              f"{blk['other']:.4f} ms ({blk_each['other']}), this/other "
              f"{blk['this'] / blk['other']:.3f}; chain floor this {floors['this']:.4f} ms, "
              f"other {floors['other']:.4f} ms; max |this - other| / max |other|: dx "
              f"{diffs[0]:.3g}, worst parameter gradient {max(diffs[1:]):.3g}", flush=True)
        for n in ("other", "this"):
            parts = run(n, lambda: cs.chain_parts(call, epis=epis[n]))
            fl = cs.part_floors(parts, Bf, N, dim, heads, mlp, dh)
            print(f"{label} {n} parts (ms, byte floor): " + "; ".join(
                f"{p} {m:.4f}" + ("" if f is None else f" ({f:.4f})")
                for (p, m), f in zip(parts, fl)) + f"; sum {sum(m for _, m in parts):.4f}",
                flush=True)
        for n in libs:
            totals["attention"][n] += per * att[n]
            totals["block"][n] += per * blk[n]
        del x, gy, sv, pb
        torch.cuda.empty_cache()
    for kind, t in totals.items():
        print(f"a batch's twelve {kind} backwards (MS-SiT, blocks a batch x fold time): this "
              f"{t['this']:.4f} ms, other {t['other']:.4f} ms, this/other "
              f"{t['this'] / t['other']:.3f}", flush=True)


if __name__ == "__main__":
    main()
