#!/usr/bin/env python3
"""The CLS block's training backward beside another checkout's, on one NVIDIA GPU.

    python3 scripts/cls_bwd_compare.py OTHER_CHECKOUT [WIDTH]

Builds ``fused_block.cu``, ``fused_block_bwd.cu``, ``flash_attention.cu`` and
``fused_mlp.cu`` of OTHER_CHECKOUT's ``surface_vision_transformers_tpu_torch/csrc`` into one
temporary library beside this tree's kernels (its ``svt_fused_block_cls_bwd``,
``svt_block_bwd_workspace``, ``svt_block_bwd_dh_floats`` and the attention
entries must take this tree's arguments), then at SiT-tiny (B = 256, N = 321,
and N = 328 with valid_len 321), SiT-small width (dim 384, 6 heads, B = 256,
N = 321) and SiT-base (B = 32, N = 1281), dh 64:

- the attention backward of the CLS block's 8 query rows against the N keys
  (``flash_attention_bwd`` on (B, heads, 8 or N, 64) tensors) on either
  library, by ``chip_smoke.device_ms`` in the order other, this, SDPA's
  backward at the same shapes (with the key mask), this, other; the largest
  difference between the two trees' dq, dk, dv and the share of their
  elements whose bits differ;
- ``fused_block_cls_bwd`` after this tree's CLS training forward on either
  library, the same way (without SDPA), the largest difference between their
  12 outputs and the share of elements that differ;
- each part of either chain alone (``chip_smoke.chain_parts``: its device
  time under torch.profiler, mean of 3 calls) beside its byte floor
  (``chip_smoke.cls_part_floors``), and the chain floors
  (``chip_smoke.cls_chain_bytes``: this tree's rule, and LN1 standalone).

WIDTH (``SiT-tiny``, ``SiT-small`` or ``SiT-base``) keeps the cases of that
width only. Needs a CUDA device and nvcc; imports nothing of JAX.
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

ENTRIES = ("svt_fused_block_cls_bwd", "svt_block_bwd_workspace", "svt_block_bwd_dh_floats",
           "svt_flash_attention_bwd", "svt_flash_attention_bwd_workspace",
           "svt_flash_attention_fwd", "svt_error_string")


class Other:
    """The other library's entries, declared with this tree's C signatures."""

    def __init__(self, lib, this_lib, entries=ENTRIES):
        for name in entries:
            fn, ref = getattr(lib, name), getattr(this_lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            setattr(self, name, fn)


def differ(a, b) -> tuple[float, int, int]:
    """(max |a - b| / max |b|, elements whose bits differ, elements)."""
    a, b = a.contiguous(), b.contiguous()
    rel = ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()
    ne = int((a.view(torch.int16 if a.element_size() == 2 else torch.int32)
              != b.view(torch.int16 if b.element_size() == 2 else torch.int32)).sum())
    return rel, ne, a.numel()


def summary(pairs) -> str:
    stats = [differ(a, b) for a, b in pairs]
    ne, n = sum(s[1] for s in stats), sum(s[2] for s in stats)
    return (f"max |this - other| / max |other| {max(s[0] for s in stats):.3g}, "
            f"{ne} of {n} elements ({ne / n:.3g}) differ in their bits")


def main() -> None:
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("cls_bwd_compare: no CUDA device")
    sys.path.insert(0, str(ROOT / "scripts"))
    from bwd_chain_parts import CLS_CASES

    other_csrc = Path(sys.argv[1]).resolve() / "surface_vision_transformers_tpu_torch" / "csrc"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    this_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libcls_other.so"
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                        *(str(other_csrc / f) for f in ("fused_block.cu", "fused_block_bwd.cu",
                                                        "flash_attention.cu", "fused_mlp.cu"))],
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

    def timed(call, sdpa=None):
        """Mean ms by library over other, this, [SDPA], this, other; SDPA's ms."""
        times = {n: [] for n in libs}
        sd = None
        for i, n in enumerate(("other", "this", "this", "other")):
            if i == 2 and sdpa is not None:
                sd = cs.device_ms(sdpa)
            times[n].append(run(n, lambda: cs.device_ms(call)))
        return {n: sum(t) / 2 for n, t in times.items()}, times, sd

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)
    for label, B, N, vl, dim, heads in CLS_CASES:
        if sys.argv[2:] and not label.startswith(sys.argv[2] + " "):
            continue
        mlp, dh = 4 * dim, cs.DH
        # the attention backward alone: 8 query rows against N keys
        q = cs.dev_randn(g, (B, heads, 8, dh), 1.5)
        k, v = cs.dev_randn(g, (B, heads, N, dh), 1.5), cs.dev_randn(g, (B, heads, N, dh))
        do = cs.dev_randn(g, (B, heads, 8, dh))
        o, lse = fa.flash_attention_fwd(q, k, v, vl)
        outs = {n: run(n, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, vl)) for n in libs}
        diff = summary(zip(outs["this"], outs["other"]))
        del outs
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        mask = None if vl == N else (torch.arange(N, device="cuda") < vl).view(1, 1, 1, N)
        sdpa_out = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)
        att, att_each, sdpa = timed(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, vl),
            lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do, retain_graph=True))
        print(f"{label} attention backward (B={B}, H={heads}, 8 queries, {N} keys, valid_len "
              f"{vl}): this {att['this']:.4f} ms ({att_each['this']}), other {att['other']:.4f} "
              f"ms ({att_each['other']}), this/other {att['this'] / att['other']:.3f}; SDPA "
              f"backward {sdpa:.4f} ms (this/SDPA {att['this'] / sdpa:.3f}, other/SDPA "
              f"{att['other'] / sdpa:.3f}); {diff}", flush=True)
        del q, k, v, do, o, lse, qr, kr, vr, sdpa_out
        # the CLS block's backward after this tree's training forward
        rng = np.random.default_rng(cs.SEED + 15)
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in cs.block_params(rng, dim, heads, mlp)]
        kw = dict(heads=heads, dim_head=dh, valid_len=vl)
        x, gy = cs.dev_randn(g, (B, N, dim), cs.X_SCALE), cs.dev_randn(g, (B, 8, dim), cs.G_SCALE)
        _, sv = fb.train_forward(x, *pb, cls=True, **kw)

        def call():
            return fb.fused_block_cls_bwd(x, gy, *pb, saved=sv, **kw)

        outs = {n: run(n, call) for n in libs}
        diff = summary(zip(outs["this"], outs["other"]))
        dx_diff = summary([(outs["this"][0], outs["other"][0])])
        del outs
        blk, blk_each, _ = timed(call)
        floor, before = (cs.cls_chain_bytes(B, N, dim, heads, mlp, ln1_epilogue=e) / cs.PEAK_BYTES
                         * 1e3 for e in (None, False))
        print(f"{label} fused_block_cls_bwd: this {blk['this']:.4f} ms ({blk_each['this']}), "
              f"other {blk['other']:.4f} ms ({blk_each['other']}), this/other "
              f"{blk['this'] / blk['other']:.3f}; chain floor {floor:.4f} ms (LN1 standalone "
              f"{before:.4f}); the 12 outputs: {diff}; dx alone: {dx_diff}", flush=True)
        for n in ("other", "this"):
            parts = run(n, lambda: cs.chain_parts(call, dw_names=cs.CLS_DW_NAMES,
                                                  epis=epis[n]))
            fl = cs.cls_part_floors(parts, B, N, dim, heads, mlp)
            print(f"{label} {n} parts (ms, byte floor): " + "; ".join(
                f"{p} {m:.4f}" + ("" if f is None else f" ({f:.4f})")
                for (p, m), f in zip(parts, fl)) + f"; sum {sum(m for _, m in parts):.4f}",
                flush=True)
        del x, gy, sv, pb
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
