#!/usr/bin/env python3
"""Each part of the CLS block's forward and of the patch embedding alone, on one NVIDIA GPU.

    python3 scripts/fwd_parts.py [cls|embed|all] [EMBED_CHECKOUT]

``cls``: ``fused_block_cls`` (serving) and the CLS training forward
(``train_forward(cls=True)``) at SiT-tiny (B = 256, N = 321 and N = 328
with valid_len 321), SiT-small width (dim 384, 6 heads, B = 256, N = 321)
and SiT-base (B = 32, N = 1281), dh 64: each whole by
``chip_smoke.device_ms``, then each of its launches alone (``launch_parts``:
every launch's device time under torch.profiler, one call a session, the
mean of the sessions that saw the same launches), named by kernel and
epilogue, beside the chain's byte floor (``chip_smoke.cls_fwd_chain_bytes``:
this tree's chain and the eight-launch chain). The 8-query attention
forward (``flash_attention_fwd`` on (B, heads, 8, 64) queries) at the same
shapes: its device kernels a call and its time beside SDPA's.

``embed``: ``patch_embed`` at sub-ico 2 (B = 256, dims 192 and 384),
sub-ico 3 (B = 64, dim 768) and sub-ico 5 (B = 64, dim 96), with float32
and bfloat16 x: the kernel whole, its gather alone and its product alone,
each built from EMBED_CHECKOUT's ``csrc/patch_embed.cu`` (this tree's by
default) with ``-DSVT_EMBED_PART=0, 1, 2``. A source without that switch
(the mma.sync design before the warp-specialised one) gets it by
``part_hooks``: gather alone returns after the gather's barrier (one value
of the tile stored, so the gather stays), product alone writes a constant
tile in place of the gathered one. Both parts are timings, not kernels:
their outputs are wrong. Each by ``chip_smoke.device_ms``, beside the
kernel's byte bound. Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import re
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

# (label, B, N, valid_len, dim, heads), dh 64, 8 query rows
CLS_CASES = [("SiT-tiny CLS (256, 321, 192)", 256, 321, 321, 192, 3),
             ("SiT-tiny CLS (256, 328 valid 321, 192)", 256, 328, 321, 192, 3),
             ("SiT-small CLS (256, 321, 384)", 256, 321, 321, 384, 6),
             ("SiT-base CLS (32, 1281, 768)", 32, 1281, 1281, 768, 12)]
# (sub_ico, B, dim): the embedding's shapes on the main paths
EMBED_CASES = [(2, 256, 192), (2, 256, 384), (3, 64, 768), (5, 64, 96)]

# A launch of the forward chains as torch.profiler names it -> its part.
_KINDS = (("layer_norm_kernel", "LN"), ("fused_mlp_kernel", "MLP (fused)"),
          ("flash_fwd_few", "attention (8 queries)"), ("flash_fwd_kernel", "attention (streamed)"))
_GEMMS = {"F_NONE": ("K/V", "Q"), "F_RES": ("out-proj", "fc2"), "F_GELU": ("fc1",),
          "F_LNA": ("LN1 + K/V",)}


def launch_parts(call, epis=cs.GEMM_EPIS, reps: int = 3) -> list:
    """torch.profiler over ``reps`` calls of ``call``, one a session, after a
    warm-up call and a session that takes whatever an earlier one left:
    each launch's device time in order, the mean over the sessions that saw
    the same launches -> [(part, ms)], or [] when no two did. GEMMs are
    named by epilogue and order (``epis``: the running tree's GEMM_EPIS)."""
    from torch.autograd import DeviceType

    def session(fn):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        return [(e.name, e.time_range.elapsed_us() / 1e3) for e in ev]

    call()
    torch.cuda.synchronize()
    session(lambda: torch.zeros(1, device="cuda").add_(1))
    runs = [session(call) for _ in range(reps)]
    names = [tuple(n for n, _ in r) for r in runs]
    common = max(set(names), key=names.count)
    runs = [r for r, n in zip(runs, names) if n == common]
    if len(runs) < 2 or not common:
        return []
    parts, seen = [], {}
    for i, name in enumerate(common):
        m = re.search(r"gemm_kernel<[^>]*?(\d+)>", name)
        if m:
            epi = epis[int(m[1])]
            k = seen[epi] = seen.get(epi, 0) + 1
            labels = _GEMMS.get(epi, (epi,))
            label = labels[min(k, len(labels)) - 1]
        else:
            label = next((lab for key, lab in _KINDS if key in name), name[:40])
            if label == "LN":  # LN2 the only pass where LN1 ran in the K/V product
                k = seen["LN"] = seen.get("LN", 0) + 1 + ("F_LNA" in seen)
                label = f"LN{k}"
        parts.append((label, sum(r[i][1] for r in runs) / len(runs)))
    return parts


def cls_cases(g) -> None:
    import torch.nn.functional as F

    for label, B, N, vl, dim, heads in CLS_CASES:
        mlp, dh = 4 * dim, cs.DH
        rng = np.random.default_rng(cs.SEED + 15)
        pb = [(t.bfloat16() if t.dim() == 2 else t).contiguous().cuda()
              for t in cs.block_params(rng, dim, heads, mlp)]
        kw = dict(heads=heads, dim_head=dh, valid_len=vl)
        x = cs.dev_randn(g, (B, N, dim), cs.X_SCALE)
        for form, call in (("serving", lambda: fb.fused_block_cls(x, *pb, **kw)),
                           ("training", lambda: fb.train_forward(x, *pb, cls=True, **kw))):
            train = form == "training"
            whole = cs.device_ms(call)
            parts = launch_parts(call)
            now, before = (cs.cls_fwd_chain_bytes(B, N, dim, heads, mlp, train=train, design=d)
                           for d in (None, "eight"))
            total = sum(m for _, m in parts)
            print(f"{label} {form}: whole {whole:.4f} ms (device_ms), {len(parts)} launches "
                  f"(rule: {fb.cls_fwd_launches(N, dim)}); each alone (ms): "
                  + "; ".join(f"{p} {m:.4f}" for p, m in parts)
                  + f"; sum {total:.4f} ({total / whole:.3f} of the whole); chain floor "
                  f"{now / cs.PEAK_BYTES * 1e3:.4f} ms ({now / 1e6:.1f} MB; the eight-launch "
                  f"chain {before / cs.PEAK_BYTES * 1e3:.4f} ms, {before / 1e6:.1f} MB)",
                  flush=True)
        # the 8-query attention forward alone, Q given
        q = cs.dev_randn(g, (B, heads, 8, dh), 1.5)
        k, v = cs.dev_randn(g, (B, heads, N, dh), 1.5), cs.dev_randn(g, (B, heads, N, dh))
        kernels = cs.device_kernels(lambda: fa.flash_attention_fwd(q, k, v, vl))
        ms = cs.device_ms(lambda: fa.flash_attention_fwd(q, k, v, vl))
        mask = None if vl == N else (torch.arange(N, device="cuda") < vl).view(1, 1, 1, N)
        sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        b_ms, b_by = cs.attention_bound(B, heads, 8, vl, (q, k, v, q), (q,))[0]
        print(f"{label} attention forward, 8 queries (Q given): {ms:.4f} ms, SDPA {sdpa:.4f} "
              f"ms ({ms / sdpa:.3f}x), bound {b_ms:.4f} ms by {b_by}; device kernels a call "
              f"{[n.split('namespace)::')[-1].split('(')[0] for n in kernels]}", flush=True)
        del x, pb, q, k, v
        torch.cuda.empty_cache()


def part_hooks(src: str) -> str:
    """The SVT_EMBED_PART switch, inserted into the mma.sync kernel's text
    (the design before the warp-specialised one) where it is missing."""
    if "SVT_EMBED_PART" in src:
        return src
    load = "      for (int c = 0; c < C; ++c) dst[c] = to_bf16(src[(long long)c * G]);\n"
    barrier = "  __syncthreads();\n\n  const int wm = warp >> 1"
    if load not in src or barrier not in src:
        raise SystemExit("fwd_parts: patch_embed.cu is neither designed for SVT_EMBED_PART nor "
                         "the mma.sync kernel part_hooks knows")
    src = src.replace(load, "#if SVT_EMBED_PART == 2\n      for (int c = 0; c < C; ++c) dst[c] = "
                      "__float2bfloat16((float)((r + v + c) & 7));\n#else\n" + load + "#endif\n")
    return src.replace(barrier, "  __syncthreads();\n#if SVT_EMBED_PART == 1\n  if (tid == 0) "
                       "out[(long long)m0 * dim] = sA[(m0 / PE_BM) % PE_BM * lda];\n  return;\n"
                       "#endif\n\n  const int wm = warp >> 1")


def embed_libs(checkout: Path, tmp: Path) -> dict:
    """The checkout's patch_embed.cu built three ways -> {part: ctypes lib}."""
    csrc = checkout / "surface_vision_transformers_tpu_torch" / "csrc"
    src = tmp / "patch_embed.cu"
    src.write_text(part_hooks((csrc / "patch_embed.cu").read_text()))
    jobs = {}
    for part in (0, 1, 2):
        so = tmp / f"libembed{part}.so"
        jobs[part] = (so, subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, f"-DSVT_EMBED_PART={part}", f"-I{csrc}",
             "-shared", "-o", str(so), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for part, (so, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise SystemExit(f"fwd_parts: nvcc failed on part {part}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.svt_patch_embed.argtypes = _native.library().svt_patch_embed.argtypes
        lib.svt_patch_embed.restype = ctypes.c_int
        libs[part] = lib
    return libs


def embed_cases(checkout: Path) -> None:
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table
    from surface_vision_transformers_tpu_torch.ops import patch_embed as pe

    with tempfile.TemporaryDirectory() as tmp:
        libs = embed_libs(checkout, Path(tmp))
        rng = np.random.default_rng(cs.SEED + 21)
        for sub_ico, B, dim in EMBED_CASES:
            table = load_patch_table(6, sub_ico).indices
            L, V = table.shape
            idx = pe.table_tensor(table, "cuda")
            x32 = torch.from_numpy(rng.standard_normal((B, 4, 40962)).astype(np.float32)).cuda()
            w = torch.from_numpy(rng.uniform(-0.05, 0.05, (dim, -(-4 * V // 64) * 64)).astype(
                np.float32)).cuda().bfloat16()
            b = torch.from_numpy(rng.uniform(-0.05, 0.05, dim).astype(np.float32)).cuda()
            out = torch.empty((B, L, dim), dtype=torch.bfloat16, device="cuda")
            for x in (x32, x32.bfloat16()):
                def call(lib):
                    err = lib.svt_patch_embed(
                        x.data_ptr(), int(x.dtype == torch.float32), idx.data_ptr(),
                        w.data_ptr(), b.data_ptr(), out.data_ptr(), B, 4, 40962, L, V,
                        w.shape[1], dim, 0, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"fwd_parts: patch_embed failed (CUDA error {err})")

                ms = {part: cs.device_ms(lambda: call(lib)) for part, lib in libs.items()}
                nbytes = cs.nbytes_of(x, idx, w, b) + out.numel() * 2
                b_ms, b_by = cs.bound_ms(2 * B * L * 4 * V * dim, nbytes)
                print(f"patch_embed sub-ico {sub_ico} ({L} x {V}) B={B} dim {dim} x "
                      f"{str(x.dtype).split('.')[-1]}: whole {ms[0]:.4f} ms, gather alone "
                      f"{ms[1]:.4f}, product alone {ms[2]:.4f}; bound {b_ms:.4f} ms by {b_by} "
                      f"({b_ms / ms[0]:.1%} of the whole)", flush=True)
            del x32, out
            torch.cuda.empty_cache()


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("all", "cls", "embed") or len(sys.argv) > 3:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("fwd_parts: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)
    if which in ("all", "cls"):
        cls_cases(g)
    if which in ("all", "embed"):
        embed_cases(Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT)


if __name__ == "__main__":
    main()
