#!/usr/bin/env python3
"""Each part of the block backwards alone, on one NVIDIA GPU.

    python3 scripts/bwd_chain_parts.py [full|cls]

``full`` (and the default): at each of the seven MS-SiT folds of a batch of
64 (``chip_smoke.MSSIT_FOLDS``, dh 32) and at SiT-tiny (B = 256, N = 321,
dh 64), ``fused_block_bwd`` after the training forward. ``cls`` (and the
default): ``fused_block_cls_bwd`` after the CLS training forward at SiT-tiny
(B = 256, N = 321 and N = 328 with valid_len 321), SiT-small width (dim 384,
6 heads, B = 256, N = 321) and SiT-base (B = 32, N = 1281), its 8 query rows
against every key. Each backward is timed whole (``chip_smoke.device_ms``),
then each of its parts alone (``chip_smoke.chain_parts``: every launch's
device time under torch.profiler, one call a session, the mean of the
sessions that saw the same launches) beside the part's byte floor
(``chip_smoke.part_floors``, ``cls_part_floors``), and the sum of the parts
beside the whole; the CLS chain also beside its floor
(``chip_smoke.cls_chain_bytes``, with LN1 in the epilogue where this tree
puts it and with the standalone pass), with its device kernels a call held
to its route (``chip_smoke.cls_kernels``: one few-query attention launch,
LN1 in dkv W_kv's epilogue up to dim 192), its forward's, serving and
training, likewise (``chip_smoke.cls_fwd_kernels``: one few-query forward,
LN1 in the K/V product and Q made in it at dims 96 / 192), and the 8-query
attention forward and backward alone at the CLS shapes held to one launch
of their kernels. ``chip_smoke.py`` phase 29 runs this
script in a process of its own: late in a long run the profiler there
dropped launches. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import flash_attention as fa  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402

CASES = [(f"stage {s} ({Bf}, {N}, {dim})", Bf, N, dim, heads, cs.MSSIT_DH)
         for s, Bf, N, dim, heads, _ in cs.MSSIT_FOLDS] + [
    ("SiT-tiny (256, 321, 192)", 256, 321, 192, 3, 64)]
# the CLS block: (label, B, N, valid_len, dim, heads), dim_head 64, 8 query rows
CLS_CASES = [("SiT-tiny CLS (256, 321, 192)", 256, 321, 321, 192, 3),
             ("SiT-tiny CLS (256, 328 valid 321, 192)", 256, 328, 321, 192, 3),
             ("SiT-small CLS (256, 321, 384)", 256, 321, 321, 384, 6),
             ("SiT-base CLS (32, 1281, 768)", 32, 1281, 1281, 768, 12)]


def report(label, name, whole, parts, floors, extra="") -> None:
    total = sum(m for _, m in parts)
    print(f"{label}: {name} {whole:.4f} ms (device_ms){extra}; each part alone (ms, byte "
          f"floor): " + "; ".join(f"{p} {m:.4f}" + ("" if f is None else f" ({f:.4f})")
                                  for (p, m), f in zip(parts, floors))
          + f"; sum of the parts {total:.4f} ms ({total / whole:.3f} of the whole"
          + ("" if abs(total / whole - 1) < 0.15 else ": the profiler lost launches") + ")",
          flush=True)


def full_cases(g) -> None:
    for label, Bf, N, dim, heads, dh in CASES:
        mlp = 4 * dim
        rng = np.random.default_rng(cs.SEED + 14)
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in cs.block_params(rng, dim, heads, mlp, dh)]
        kw = dict(heads=heads, dim_head=dh)
        x, gy = cs.dev_randn(g, (Bf, N, dim), cs.X_SCALE), cs.dev_randn(g, (Bf, N, dim), cs.G_SCALE)
        _, sv = fb.train_forward(x, *pb, **kw)

        def call():
            return fb.fused_block_bwd(x, gy, *pb, saved=sv, **kw)

        print(f"{label}: timing", file=sys.stderr, flush=True)
        whole = cs.device_ms(call)
        parts = cs.chain_parts(call)
        report(label, "fused_block_bwd", whole, parts,
               cs.part_floors(parts, Bf, N, dim, heads, mlp, dh))
        del x, gy, sv, pb
        torch.cuda.empty_cache()


def cls_cases(g) -> None:
    for label, B, N, vl, dim, heads in CLS_CASES:
        mlp = 4 * dim
        rng = np.random.default_rng(cs.SEED + 14)
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in cs.block_params(rng, dim, heads, mlp)]
        kw = dict(heads=heads, dim_head=cs.DH, valid_len=vl)
        x, gy = cs.dev_randn(g, (B, N, dim), cs.X_SCALE), cs.dev_randn(g, (B, 8, dim), cs.G_SCALE)
        _, sv = fb.train_forward(x, *pb, cls=True, **kw)

        def call():
            return fb.fused_block_cls_bwd(x, gy, *pb, saved=sv, **kw)

        print(f"{label}: timing", file=sys.stderr, flush=True)
        fwd = [cs.cls_fwd_kernels(cs.device_kernels(f), N, dim) for f in (
            lambda: fb.fused_block_cls(x, *pb, **kw),
            lambda: fb.train_forward(x, *pb, cls=True, **kw))]
        print(f"{label}: the CLS forward's device kernels, serving: {fwd[0]}; training: "
              f"{fwd[1]}", flush=True)
        whole = cs.device_ms(call)
        route = cs.cls_kernels(cs.device_kernels(call), N, dim)
        parts = cs.chain_parts(call, dw_names=cs.CLS_DW_NAMES)
        floor, before = (cs.cls_chain_bytes(B, N, dim, heads, mlp, ln1_epilogue=e)
                         for e in (None, False))
        report(label, "fused_block_cls_bwd", whole, parts,
               cs.cls_part_floors(parts, B, N, dim, heads, mlp),
               f" ({route}), chain floor {floor / cs.PEAK_BYTES * 1e3:.4f} ms "
               f"({floor / 1e6:.1f} MB; with LN1 standalone "
               f"{before / cs.PEAK_BYTES * 1e3:.4f} ms, {before / 1e6:.1f} MB)")
        del x, gy, sv, pb
        torch.cuda.empty_cache()


def few_route_cases(g) -> None:
    """The attention forward and backward of 8 query rows
    (``flash_attention_fwd`` / ``_bwd``) at the CLS shapes: one launch a
    call each, of the few-query kernels."""
    for B, H, nq, nk in cs.FEW_BUSY_SHAPES:
        q, do = cs.dev_randn(g, (B, H, nq, cs.DH), 1.5), cs.dev_randn(g, (B, H, nq, cs.DH))
        k, v = cs.dev_randn(g, (B, H, nk, cs.DH), 1.5), cs.dev_randn(g, (B, H, nk, cs.DH))
        kernels = cs.device_kernels(lambda: fa.flash_attention_fwd(q, k, v))
        print(f"flash_attention_fwd B={B} H={H} Nq={nq} Nk={nk}: device kernels a call "
              f"{[n.split('namespace)::')[-1].split('(')[0] for n in kernels]} (must be one "
              "flash_fwd_few_kernel)", flush=True)
        if len(kernels) != 1 or "flash_fwd_few_kernel" not in kernels[0]:
            raise SystemExit("bwd_chain_parts: the few-query forward is not one launch")
        o, lse = fa.flash_attention_fwd(q, k, v)
        kernels = cs.device_kernels(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))
        print(f"flash_attention_bwd B={B} H={H} Nq={nq} Nk={nk}: device kernels a call "
              f"{[n.split('namespace)::')[-1].split('(')[0] for n in kernels]} (must be one "
              "flash_bwd_few_kernel)",
              flush=True)
        if len(kernels) != 1 or "flash_bwd_few_kernel" not in kernels[0]:
            raise SystemExit("bwd_chain_parts: the few-query backward is not one launch")


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("all", "full", "cls"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_chain_parts: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
    if which in ("all", "full"):
        full_cases(g)
    if which in ("all", "cls"):
        few_route_cases(g)
        cls_cases(g)


if __name__ == "__main__":
    main()
