#!/usr/bin/env python3
"""The attention kernels at dh 32 and 64 beside another checkout's, on one NVIDIA GPU.

    python3 scripts/head_width_compare.py OTHER_CHECKOUT

Builds ``flash_attention.cu``, ``fused_block.cu``, ``fused_block_bwd.cu`` and
``fused_mlp.cu`` (and ``flash_attention_widths.cu`` where it has one) of
OTHER_CHECKOUT's ``surface_vision_transformers_tpu_torch/csrc`` into one
temporary library beside this tree's kernels (its attention and block
entries must take this tree's arguments), then, at the shapes whose
route is the same in both trees, calls each through this tree's wrappers on
either library:

- dh 64 (SiT-tiny, 3 heads, B = 256, N = 321): ``flash_attention_qkv``
  forward and backward, the same with dropout 0.1, the CLS block's 8 query
  rows against the 321 keys forward and backward (the few-query kernels),
  the CLS block's training forward and its backward
  (``fused_block_cls_bwd``);
- dh 32 (6 heads at dim 192): ``flash_attention_qkv`` forward and backward
  at N = 321 (the streamed kernels), at N = 80 (MS-SiT's axial fold: the
  resident kernels) at B = 1024, and ``fused_block``'s training forward and
  ``fused_block_bwd`` at SiT-tiny's width.

Each output is held bit for bit against the other tree's (the line says how
many elements differ: 0 is the claim), and each call is timed by
``chip_smoke.device_ms`` in the order other, this, this, other; the line
prints both means and this / other. The 8-query shapes at dh 32 are not
compared: this tree runs them on the few-query kernels, the other on the
streamed ones. Needs a CUDA device and nvcc; imports nothing of JAX.
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
from surface_vision_transformers_tpu_torch.ops import flash_attention as fa  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402

ENTRIES = ("svt_flash_attention_fwd", "svt_flash_attention_bwd",
           "svt_flash_attention_bwd_workspace", "svt_fused_block_train_fwd",
           "svt_fused_block_cls_train_fwd", "svt_fused_block_bwd", "svt_fused_block_cls_bwd",
           "svt_block_bwd_workspace", "svt_block_bwd_dh_floats", "svt_error_string")
SOURCES = ("flash_attention.cu", "fused_block.cu", "fused_block_bwd.cu", "fused_mlp.cu")


class Other:
    """The other library's entries, declared with this tree's C signatures."""

    def __init__(self, lib, this_lib):
        for name in ENTRIES:
            fn, ref = getattr(lib, name), getattr(this_lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            setattr(self, name, fn)


def flat(out):
    """A call's outputs as a list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)] if isinstance(out, (tuple, list)) else (
        [t for t in out.values()] if isinstance(out, dict) else [])


def bits_differ(a: list, b: list) -> tuple[int, int]:
    """(elements whose bits differ, elements) over the paired outputs."""
    ne = n = 0
    for x, y in zip(a, b):
        dt = {2: torch.int16, 4: torch.int32}[x.element_size()]
        ne += int((x.contiguous().view(dt) != y.contiguous().view(dt)).sum())
        n += x.numel()
    return ne, n


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("head_width_compare: no CUDA device")
    other_csrc = Path(sys.argv[1]).resolve() / "surface_vision_transformers_tpu_torch" / "csrc"
    print(cs.card(), flush=True)
    this_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libhw_other.so"
        # the other tree's attention at the other widths, where it has a file for them
        srcs = [other_csrc / f for f in (*SOURCES, "flash_attention_widths.cu")
                if (other_csrc / f).exists()]
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(so),
                        *map(str, srcs)],
                       check=True, capture_output=True, timeout=900)
        libs = {"other": Other(ctypes.CDLL(str(so)), this_lib), "this": this_lib}

    def run(name, fn):
        _native.library = lambda: libs[name]
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib

    def compare(label, call):
        outs = {n: flat(run(n, call)) for n in libs}
        ne, n = bits_differ(outs["this"], outs["other"])
        del outs
        times = {n: [] for n in libs}
        for name in ("other", "this", "this", "other"):
            times[name].append(run(name, lambda: cs.device_ms(call)))
        mean = {n: sum(t) / 2 for n, t in times.items()}
        print(f"{label}: this {mean['this']:.4f} ms ({times['this']}), other "
              f"{mean['other']:.4f} ms ({times['other']}), this/other "
              f"{mean['this'] / mean['other']:.4f}; {ne} of {n} output elements differ in "
              "their bits", flush=True)

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 23)
    B, N = 256, cs.N_TOKENS
    for dh, heads in ((64, 3), (32, 6)):
        hd = heads * dh
        cases = [(B, N)] + ([(1024, 80)] if dh == 32 else [])
        for b, n in cases:
            qkv = torch.cat([cs.dev_randn(g, (b, n, 2 * hd), 1.5), cs.dev_randn(g, (b, n, hd))],
                            -1)
            do = cs.dev_randn(g, (b, n, hd))
            o, lse = fa.flash_attention_qkv_fwd(qkv, heads)
            tag = f"dh {dh}, {heads} heads, B={b} N={n}"
            compare(f"flash_attention_qkv forward ({tag})",
                    lambda: fa.flash_attention_qkv_fwd(qkv, heads))
            compare(f"flash_attention_qkv backward ({tag})",
                    lambda: fa.flash_attention_qkv_bwd(qkv, o, lse, do, heads))
            if dh == 64:
                od, ld = fa.flash_attention_qkv_dropout_fwd(qkv, heads, n, cs.DROP_RATE,
                                                            cs.DROP_SEED)
                compare(f"flash_attention_qkv_dropout forward ({tag})",
                        lambda: fa.flash_attention_qkv_dropout_fwd(qkv, heads, n, cs.DROP_RATE,
                                                                   cs.DROP_SEED))
                compare(f"flash_attention_qkv_dropout backward ({tag})",
                        lambda: fa.flash_attention_qkv_dropout_bwd(
                            qkv, od, ld, do, heads, n, cs.DROP_RATE, cs.DROP_SEED))
                q = cs.dev_randn(g, (b, heads, 8, dh), 1.5)
                k, v = fa.split_qkv(qkv, heads)[1:]
                do8 = cs.dev_randn(g, (b, heads, 8, dh))
                o8, l8 = fa.flash_attention_fwd(q, k, v)
                compare(f"attention forward, 8 queries ({tag})",
                        lambda: fa.flash_attention_fwd(q, k, v))
                compare(f"attention backward, 8 queries ({tag})",
                        lambda: fa.flash_attention_bwd(q, k, v, o8, l8, do8))
                del q, k, v, do8, o8, l8, od, ld
            del qkv, do, o, lse
            torch.cuda.empty_cache()
        # the block chains at SiT-tiny's width: the CLS block at dh 64 (the
        # other tree refuses it at dh 32), the full block at dh 32
        cls = dh == 64
        rng = np.random.default_rng(cs.SEED + 23)
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in cs.block_params(rng, cs.DIM, heads, cs.MLP, dh)]
        kw = dict(heads=heads, dim_head=dh, valid_len=N)
        x = cs.dev_randn(g, (B, N, cs.DIM), cs.X_SCALE)
        gy = cs.dev_randn(g, (B, 8 if cls else N, cs.DIM), cs.G_SCALE)
        _, sv = fb.train_forward(x, *pb, cls=cls, **kw)
        bwd = fb.fused_block_cls_bwd if cls else fb.fused_block_bwd
        name = "fused_block_cls" if cls else "fused_block"
        compare(f"{name} training forward (dh {dh}, {heads} heads, B={B} N={N})",
                lambda: fb.train_forward(x, *pb, cls=cls, **kw))
        compare(f"{name}_bwd (dh {dh}, {heads} heads, B={B} N={N})",
                lambda: bwd(x, gy, *pb, saved=sv, **kw))
        del x, gy, sv, pb
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
