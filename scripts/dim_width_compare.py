#!/usr/bin/env python3
"""The block chains at the main path's widths beside another checkout's, on one NVIDIA GPU.

    python3 scripts/dim_width_compare.py OTHER_CHECKOUT

Builds every ``.cu`` of OTHER_CHECKOUT's
``surface_vision_transformers_tpu_torch/csrc`` (one nvcc a source, all
started together, one link) into a temporary library. Its block entries may
predate the LayerNorm count (``ln_dim``, the argument after ``dim``): each
is called through this tree's wrappers, with that argument dropped where
the other checkout's ``svt_ops.py`` has no ``ln_dim``. At the widths the main
path runs, whose layouts are unpadded in both trees (dims 96, 192, 384 and
768; mlp 384, 768, 1536 and 3072):

- dim 96 (MS-SiT stage 0: 3 x 32, mlp 384; the fused MLP route): the
  serving ``fused_block``, the training forward and ``fused_block_bwd``;
- dim 192 (SiT-tiny: 3 x 64, mlp 768) and dim 384 (SiT-small: 6 x 64, mlp
  1536): ``fused_block``, ``fused_block_cls``, both training forwards and
  both backwards, and at 384 ``fused_block_int8``;
- dim 768 (SiT-base: 12 x 64, mlp 3072) at B = 64: ``fused_block``,
  ``fused_block_cls``, ``fused_block_int8``, the training forward and
  ``fused_block_bwd``.

B = 256 (768: 64), N = 321. Each output is held bit for bit against the
other tree's (the line says how many elements differ: 0 is the claim), and
each call is timed by ``chip_smoke.device_ms`` in the order other, this,
this, other; the line prints both means and this / other. Needs a CUDA
device and nvcc; imports nothing of JAX.
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
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from head_width_compare import bits_differ, flat  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block as fb  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import fused_block_int8 as fbi8  # noqa: E402
from surface_vision_transformers_tpu_torch.serving import svt_ops  # noqa: E402

# The entries the block chains call, and where this tree's ln_dim argument
# sits in each (0-based)
LN_DIM_AT = {"svt_fused_block": 21, "svt_fused_block_cls": 23, "svt_fused_block_int8": 28,
             "svt_fused_block_train_fwd": 26, "svt_fused_block_cls_train_fwd": 28,
             "svt_fused_block_bwd": 41, "svt_fused_block_cls_bwd": 44}
ENTRIES = (*LN_DIM_AT, "svt_block_fused_mlp", "svt_cls_fwd_route", "svt_block_bwd_workspace",
           "svt_block_bwd_dh_floats", "svt_error_string")
# name: (dim, heads, dim_head, mlp, B, cases)
CASES = {"dim 96": (96, 3, 32, 384, 256, ("fused_block", "train")),
         "dim 192": (192, 3, 64, 768, 256, ("fused_block", "fused_block_cls", "train",
                                            "train_cls")),
         "dim 384": (384, 6, 64, 1536, 256, ("fused_block", "fused_block_cls", "train",
                                             "train_cls", "int8")),
         "dim 768": (768, 12, 64, 3072, 64, ("fused_block", "fused_block_cls", "int8", "train"))}


class Other:
    """The other library's entries with this tree's C signatures; where
    ``legacy``, the ln_dim argument is dropped before the call."""

    def __init__(self, lib, this_lib, legacy: bool):
        for name in ENTRIES:
            fn, ref = getattr(lib, name), getattr(this_lib, name)
            at = LN_DIM_AT.get(name) if legacy else None
            args = list(ref.argtypes)
            if at is not None:
                del args[at]
            fn.argtypes, fn.restype = args, ref.restype
            setattr(self, name, fn if at is None else
                    (lambda f, i: lambda *a: f(*a[:i], *a[i + 1:]))(fn, at))


def build_other(csrc: Path, tmp: Path) -> ctypes.CDLL:
    """Every .cu of ``csrc`` compiled in parallel and linked into one
    library."""
    nvcc = _native._nvcc()
    procs = [(subprocess.Popen([nvcc, *_native.NVCC_FLAGS, "-c", "-o", str(tmp / f"{s.stem}.o"),
                                str(s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
              s.name) for s in sorted(csrc.glob("*.cu"))]
    for p, name in procs:
        out = p.communicate(timeout=900)[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the other tree's {name}:\n{out.decode()[-3000:]}")
    so = tmp / "libdw_other.so"
    subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, sorted(tmp.glob("*.o")))],
                   check=True, capture_output=True, timeout=900)
    return ctypes.CDLL(str(so))


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("dim_width_compare: no CUDA device")
    other = Path(sys.argv[1]).resolve()
    legacy = "ln_dim" not in (other / "surface_vision_transformers_tpu_torch" / "serving" /
                              "svt_ops.py").read_text()
    print(cs.card(), f"(the other tree's block entries {'without' if legacy else 'with'} "
          "ln_dim)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    this_lib = _native.library()
    svt_ops.library()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": Other(build_other(other / "surface_vision_transformers_tpu_torch" /
                                           "csrc", Path(tmp)), this_lib, legacy),
                "this": this_lib}

    def run(name, fn):
        _native.library = lambda: libs[name]
        svt_ops._lib = libs[name]
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib
            svt_ops._lib = this_lib

    def compare(label, call):
        """``call(name)`` -> a call of that library's chain."""
        outs = {n: flat(run(n, call(n))) for n in libs}
        ne, n = bits_differ(outs["this"], outs["other"])
        del outs
        times = {n: [] for n in libs}
        for name in ("other", "this", "this", "other"):
            times[name].append(run(name, lambda: cs.device_ms(call(name))))
        mean = {n: sum(t) / 2 for n, t in times.items()}
        print(f"{label}: this {mean['this']:.4f} ms ({times['this']}), other "
              f"{mean['other']:.4f} ms ({times['other']}), this/other "
              f"{mean['this'] / mean['other']:.4f}; {ne} of {n} output elements differ in "
              "their bits", flush=True)

    N = cs.N_TOKENS
    for label, (dim, heads, dh, mlp, B, cases) in CASES.items():
        rng = np.random.default_rng(cs.SEED + 25 + dim)
        p32 = [t.cuda() for t in cs.block_params(rng, dim, heads, mlp, dh)]
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous() for t in p32]
        x = torch.from_numpy(cs.X_SCALE * rng.standard_normal((B, N, dim)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        kw = dict(heads=heads, dim_head=dh)
        tag = f"{label} ({heads} x {dh}, mlp {mlp}), B={B} N={N}"
        for case in cases:
            if case in ("fused_block", "fused_block_cls"):
                kernel = getattr(fb, case)
                with torch.inference_mode():
                    compare(f"{case} {tag}", lambda n: lambda: kernel(x, *pb, **kw))
            elif case == "int8":
                p8, _ = cs.int8_block_params(rng, dim, heads, mlp, dh)
                with torch.inference_mode():
                    compare(f"fused_block_int8 {tag}",
                            lambda n: lambda: fbi8.fused_block_int8(x, *p8, **kw))
                del p8
            else:
                cls = case == "train_cls"
                g = torch.from_numpy((cs.G_SCALE * rng.standard_normal(
                    (B, 8 if cls else N, dim))).astype(np.float32)).to("cuda", torch.bfloat16)
                name = "fused_block_cls" if cls else "fused_block"
                compare(f"{name} training forward {tag}",
                        lambda n: lambda: fb.train_forward(x, *pb, cls=cls, **kw))
                # each library's backward on the saves of its own training forward
                saves = {n: run(n, lambda: fb.train_forward(x, *pb, cls=cls, **kw)[1])
                         for n in libs}
                bwd = fb.fused_block_cls_bwd if cls else fb.fused_block_bwd
                compare(f"{name}_bwd {tag}",
                        lambda n: lambda: bwd(x, g, *pb, saved=saves[n], **kw))
                del g, saves
            torch.cuda.empty_cache()
        del x, pb, p32
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
