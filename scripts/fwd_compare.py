#!/usr/bin/env python3
"""The CLS block's forward and the patch embedding beside another checkout's, on one NVIDIA GPU.

    python3 scripts/fwd_compare.py OTHER_CHECKOUT [cls|embed]

``cls`` (and the default): builds ``fused_block.cu``, ``flash_attention.cu``
and ``fused_mlp.cu`` of OTHER_CHECKOUT's ``surface_vision_transformers_tpu_torch/csrc``
into one temporary library beside this tree's kernels (its
``svt_fused_block_cls``, ``svt_fused_block_cls_train_fwd`` and
``svt_flash_attention_fwd`` must take this tree's arguments), then at
``scripts/fwd_parts.py``'s CLS cases (SiT-tiny B = 256 at N = 321 and N =
328 / valid_len 321, SiT-small width, SiT-base B = 32):

- the attention forward of the CLS block's 8 query rows against the N keys,
  Q given (``flash_attention_fwd`` on (B, heads, 8 or N, 64) tensors), on
  either library by ``chip_smoke.device_ms`` in the order other, this,
  SDPA at the same shapes (with the key mask), this, other; the largest
  difference between the two trees' outputs and the share of elements
  whose bits differ;
- the serving ``svt_fused_block_cls`` and the training form, each called
  with every scratch buffer either tree's chain may touch, the same way
  (without SDPA), with the same differences over the output and every
  save;
- each launch of either serving chain alone (``fwd_parts.launch_parts``).

``embed``: builds OTHER_CHECKOUT's ``patch_embed.cu`` and calls
``svt_patch_embed`` of either library at ``fwd_parts.EMBED_CASES``, fp32
and bf16 x, in the order other, this, index_select + addmm, this, other;
the largest difference and the share of outputs whose bits differ. Needs
a CUDA device and nvcc; imports nothing of JAX.
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
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from cls_bwd_compare import Other, summary  # noqa: E402
from fwd_parts import CLS_CASES, EMBED_CASES, launch_parts  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import _native  # noqa: E402
from surface_vision_transformers_tpu_torch.ops import flash_attention as fa  # noqa: E402

CLS_ENTRIES = ("svt_fused_block_cls", "svt_fused_block_cls_train_fwd", "svt_flash_attention_fwd",
               "svt_error_string")


def build(other_csrc: Path, sources, tmp: str) -> ctypes.CDLL:
    so = Path(tmp) / "libfwd_other.so"
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, f"-I{other_csrc}", "-shared", "-o",
                    str(so), *(str(other_csrc / f) for f in sources)],
                   check=True, capture_output=True, timeout=900)
    return ctypes.CDLL(str(so))


def timed(libs, run, call, third=None):
    """Mean ms by library over other, this, [third], this, other; the third's ms."""
    times = {n: [] for n in libs}
    t3 = None
    for i, n in enumerate(("other", "this", "this", "other")):
        if i == 2 and third is not None:
            t3 = cs.device_ms(third)
        times[n].append(run(n, lambda: cs.device_ms(call)))
    return {n: sum(t) / 2 for n, t in times.items()}, times, t3


def cls_chain(lib, x, pb, heads, vl, train):
    """One CLS forward on ``lib`` with every scratch buffer either tree's
    chain may touch -> (out, saves or scratch, in fused_block's order)."""
    from surface_vision_transformers_tpu_torch.ops import fused_block as fb

    B, N, dim = x.shape
    rows, hd, mlp, H = 8, heads * cs.DH, pb[7].shape[0], heads
    out = x.new_empty((B, rows, dim))
    stream = torch.cuda.current_stream().cuda_stream
    if not train:
        ws = [x.new_empty(s) for s in ((B * N, dim), (B * N, 2 * hd), (B * rows, hd),
                                       (B * rows, hd), (B * rows, dim), (B * rows, mlp))]
        _native.check(lib.svt_fused_block_cls(
            *[t.data_ptr() for t in (x, *pb, out, *ws)], B, N, rows, dim, dim, heads, cs.DH, mlp,
            vl, 1e-5, 0, stream))
        return out, [ws[3]]  # attn
    bf, f32 = torch.bfloat16, torch.float32
    shapes = {"h1": ((B, N, dim), bf), "kv": ((B, N, 2 * hd), bf), "q": ((B, rows, hd), bf),
              "attn": ((B, rows, hd), bf), "lse": ((B, H, rows), f32),
              "x1": ((B, rows, dim), bf), "h2": ((B, rows, dim), bf),
              "fpre": ((B, rows, mlp), f32), "f": ((B, rows, mlp), bf),
              "stats1": ((B, N, 2), f32), "stats2": ((B, rows, 2), f32)}
    sv = [torch.empty(shapes[k][0], dtype=shapes[k][1], device="cuda")
          for k in fb.TRAIN_SAVED_CLS]
    _native.check(lib.svt_fused_block_cls_train_fwd(
        *[t.data_ptr() for t in (x, *pb, out, *sv)], B, N, rows, dim, dim, heads, cs.DH, mlp, vl,
        1e-5, 0, stream))
    return out, sv


def cls_mode(other: Path, smi: str) -> None:
    this_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        other_lib = Other(build(other, ("fused_block.cu", "flash_attention.cu", "fused_mlp.cu"),
                                tmp), this_lib, CLS_ENTRIES)
    libs = {"other": other_lib, "this": this_lib}
    epis = {"other": cs.gemm_epis(other.parents[1]), "this": cs.gemm_epis(ROOT)}

    def run(name, fn):
        _native.library = lambda: libs[name]
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)
    for label, B, N, vl, dim, heads in CLS_CASES:
        mlp, dh = 4 * dim, cs.DH
        q = cs.dev_randn(g, (B, heads, 8, dh), 1.5)
        k, v = cs.dev_randn(g, (B, heads, N, dh), 1.5), cs.dev_randn(g, (B, heads, N, dh))
        outs = {n: run(n, lambda: fa.flash_attention_fwd(q, k, v, vl)) for n in libs}
        diff = summary(zip(outs["this"], outs["other"]))
        mask = None if vl == N else (torch.arange(N, device="cuda") < vl).view(1, 1, 1, N)
        att, each, sdpa = timed(libs, run, lambda: fa.flash_attention_fwd(q, k, v, vl),
                                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        print(f"{label} attention forward (B={B}, H={heads}, 8 queries, {N} keys, valid_len "
              f"{vl}, Q given): this {att['this']:.4f} ms ({each['this']}), other "
              f"{att['other']:.4f} ms ({each['other']}), this/other "
              f"{att['this'] / att['other']:.3f}; SDPA {sdpa:.4f} ms (this/SDPA "
              f"{att['this'] / sdpa:.3f}, other/SDPA {att['other'] / sdpa:.3f}); {diff}",
              flush=True)
        del q, k, v, outs
        rng = np.random.default_rng(cs.SEED + 15)
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in cs.block_params(rng, dim, heads, mlp)]
        x = cs.dev_randn(g, (B, N, dim), cs.X_SCALE)
        for form, train in (("serving", False), ("training", True)):
            outs = {n: run(n, lambda: cls_chain(libs[n], x, pb, heads, vl, train)) for n in libs}
            diff = summary([(outs["this"][0], outs["other"][0])])
            saves = summary(zip(outs["this"][1], outs["other"][1]))
            del outs
            blk, each, _ = timed(libs, run, lambda: cls_chain(_native.library(), x, pb, heads,
                                                              vl, train))
            print(f"{label} fused_block_cls {form}: this {blk['this']:.4f} ms "
                  f"({each['this']}), other {blk['other']:.4f} ms ({each['other']}), "
                  f"this/other {blk['this'] / blk['other']:.3f}; the output: {diff}; "
                  f"{'the saves' if train else 'attn'}: {saves}", flush=True)
        for n in ("other", "this"):
            parts = run(n, lambda: launch_parts(
                lambda: cls_chain(_native.library(), x, pb, heads, vl, False), epis=epis[n]))
            print(f"{label} {n} serving parts (ms): " + "; ".join(
                f"{p} {m:.4f}" for p, m in parts) + f"; sum {sum(m for _, m in parts):.4f}",
                flush=True)
        del x, pb
        torch.cuda.empty_cache()


def embed_mode(other: Path, smi: str) -> None:
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.ops import patch_embed as pe

    this_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        other_lib = build(other, ("patch_embed.cu",), tmp)
    other_lib.svt_patch_embed.argtypes = this_lib.svt_patch_embed.argtypes
    other_lib.svt_patch_embed.restype = ctypes.c_int
    libs = {"other": other_lib, "this": this_lib}
    rng = np.random.default_rng(cs.SEED + 21)
    for sub_ico, B, dim in EMBED_CASES:
        table = load_patch_table(6, sub_ico).indices
        L, V = table.shape
        idx = pe.table_tensor(table, "cuda")
        x32 = torch.from_numpy(rng.standard_normal((B, 4, 40962)).astype(np.float32)).cuda()
        bd = 1.0 / np.sqrt(4 * V)
        kernel = torch.from_numpy(rng.uniform(-bd, bd, (4 * V, dim)).astype(np.float32)).cuda()
        bias = torch.from_numpy(rng.uniform(-bd, bd, dim).astype(np.float32)).cuda()
        w, b = pe.embed_matrix(kernel, bias, V)
        wt = w[:, :4 * V].t()
        for x in (x32, x32.bfloat16()):
            outs = {n: torch.empty((B, L, dim), dtype=torch.bfloat16, device="cuda") for n in libs}

            def call(n):
                _native.check(libs[n].svt_patch_embed(
                    x.data_ptr(), int(x.dtype == torch.float32), idx.data_ptr(), w.data_ptr(),
                    b.data_ptr(), outs[n].data_ptr(), B, 4, 40962, L, V, w.shape[1], dim, 0,
                    torch.cuda.current_stream().cuda_stream))

            def library():  # index_select + addmm
                t = x.index_select(2, idx.reshape(-1)).view(B, 4, L, V).permute(0, 2, 3, 1)
                return torch.addmm(b.bfloat16(), t.reshape(B * L, -1).bfloat16(), wt)

            for n in libs:
                call(n)
            diff = summary([(outs["this"], outs["other"])])
            times = {n: [] for n in libs}
            lib_ms = None
            for i, n in enumerate(("other", "this", "this", "other")):
                if i == 2:
                    lib_ms = cs.device_ms(library)
                times[n].append(cs.device_ms(lambda: call(n)))
            ms = {n: sum(t) / 2 for n, t in times.items()}
            print(f"patch_embed sub-ico {sub_ico} ({L} x {V}) B={B} dim {dim} "
                  f"{str(x.dtype).split('.')[-1]} x: this {ms['this']:.4f} ms ({times['this']}), "
                  f"other {ms['other']:.4f} ms ({times['other']}), this/other "
                  f"{ms['this'] / ms['other']:.3f}; index_select + addmm {lib_ms:.4f} ms "
                  f"(this/library {ms['this'] / lib_ms:.3f}); {diff}", flush=True)
        del x32
        torch.cuda.empty_cache()


def main() -> None:
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["cls"], ["embed"]):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("fwd_compare: no CUDA device")
    other = Path(sys.argv[1]).resolve() / "surface_vision_transformers_tpu_torch" / "csrc"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    if sys.argv[2:] in ([], ["cls"]):
        cls_mode(other, smi)
    if sys.argv[2:] in ([], ["embed"]):
        embed_mode(other, smi)


if __name__ == "__main__":
    main()
