#!/usr/bin/env python3
"""The wide attention kernels (heads past 128 columns) beside another checkout's, on one NVIDIA GPU.

    python3 scripts/wide_attention_compare.py OTHER_CHECKOUT

Builds ``flash_attention.cu``, ``flash_attention_widths.cu`` and
``flash_attention_wide.cu`` of OTHER_CHECKOUT's
``surface_vision_transformers_tpu_torch/csrc`` into one temporary library
(one nvcc a source, in parallel) beside this tree's kernels (its attention
entries must take this tree's arguments), then calls each case through this
tree's wrappers on either library, at B = 256, N = 321:

- dh 136 (3 heads), 192 (3), 256 (2) and 384 (1): ``flash_attention_qkv``
  forward and backward, the same with dropout 0.1, and the CLS block's 8
  query rows against the 321 keys forward and backward;
- dh 192 on the tiled entry (B = 2, 3 heads, N = 5,121);
- checks of shapes no timing claim rests on: a padded sequence (B = 32, N =
  328, valid_len 321) and a sequence-parallel rank's (161 queries against
  322 keys, valid_len 321) at dh 192, and dh 520 (2 heads, B = 8), where
  the forward's Q streams through its ring instead of staying resident.

Both trees' outputs are held against the plain float32 versions (the
dropout ones fed the kernels' keep mask), within ``chip_smoke.BOUND_STEPS``
bf16 steps at each output's largest value, and not against each other:
where the trees' kernels differ, so may the order of the sums over the head
(the line says whether the two trees' outputs are bitwise equal; no gate).
This tree's outputs must repeat bit for bit over two calls. Each call is
timed by ``chip_smoke.device_ms`` in the order other, this, this, other;
the line prints the four, this / other, SDPA's time (with ``dropout_p``
where the case has dropout) and the bound's share of each tree's time
(``chip_smoke.attention_flops``, each input read and output written once).
Exits 1 if a gate or the repetition fails. Needs a
CUDA device and nvcc; imports nothing of JAX.
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

ENTRIES = ("svt_flash_attention_fwd", "svt_flash_attention_bwd",
           "svt_flash_attention_bwd_workspace")
SOURCES = ("flash_attention.cu", "flash_attention_widths.cu", "flash_attention_wide.cu")
B, N = 256, cs.N_TOKENS
WIDTHS = {136: 3, 192: 3, 256: 2, 384: 1}  # dh: heads
TILED = (192, 3, 2, 5121)  # dh, heads, B, N
CHECKS = {"padded": (192, 3, 32, 328, 328, 321), "sequence-parallel": (192, 3, 32, 161, 322, 321),
          "streamed": (520, 2, 8, 321, 321, 321)}  # dh, heads, B, nq, nk, valid_len


class Other:
    """The other library's entries, declared with this tree's C signatures
    (its error strings are this library's: cudaGetErrorString)."""

    def __init__(self, lib, this_lib):
        for name in ENTRIES:
            fn, ref = getattr(lib, name), getattr(this_lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            setattr(self, name, fn)
        self.svt_error_string = this_lib.svt_error_string


def build_other(csrc: Path, tmp: Path) -> ctypes.CDLL:
    """OTHER's attention sources, one nvcc each in parallel, linked into one
    library."""
    nvcc, jobs = _native._nvcc(), []
    for src in (csrc / f for f in SOURCES):
        obj = tmp / f"{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *_native.NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for src, _, proc in jobs:
        out = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{out}")
    so = tmp / "libwide_other.so"
    subprocess.run([nvcc, "-shared", "-o", str(so), *(str(o) for _, o, _ in jobs)], check=True,
                   timeout=300)
    return ctypes.CDLL(str(so))


def flat(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def bitwise_equal(a: list, b: list) -> bool:
    return all(torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
               for x, y in zip(a, b))


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("wide_attention_compare: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    other_csrc = Path(sys.argv[1]).resolve() / "surface_vision_transformers_tpu_torch" / "csrc"
    print(cs.card(), flush=True)
    this_lib = _native.library()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": Other(build_other(other_csrc, Path(tmp)), this_lib), "this": this_lib}
    failures: list = []

    def run(name, fn):
        _native.library = lambda: libs[name]
        try:
            return fn()
        finally:
            _native.library = lambda: this_lib

    def case(label, call, ref32, sdpa=None, bound=None, timed=True):
        """Gate both trees' outputs of ``call`` against ``ref32``, this
        tree's repetition, and (``timed``) the four timings."""
        outs = {n: flat(run(n, call)) for n in libs}
        again = flat(run("this", call))
        ratio = {n: cs.step_ratio(o, ref32, ref32) for n, o in outs.items()}
        finite = all(bool(torch.isfinite(x.float()).all()) for o in outs.values() for x in o)
        repeat = bitwise_equal(outs["this"], again)
        same = bitwise_equal(outs["this"], outs["other"])
        del outs, again
        line = (f"{label}: worst |err|/bound vs fp32 plain this {ratio['this']:.4g}, other "
                f"{ratio['other']:.4g} (must be <= 1); this tree bitwise over two calls {repeat}; "
                f"bitwise the other tree's {same}")
        if not finite or max(ratio.values()) > 1:
            failures.append(f"{label}: outside the gate")
        if not repeat:
            failures.append(f"{label}: this tree's outputs differ between two calls")
        if timed:
            times = {n: [] for n in libs}
            for name in ("other", "this", "this", "other"):
                times[name].append(run(name, lambda: cs.device_ms(call)))
            mean = {n: sum(t) / 2 for n, t in times.items()}
            line += (f"; device_ms other {times['other'][0]:.4f} / this {times['this'][0]:.4f} / "
                     f"this {times['this'][1]:.4f} / other {times['other'][1]:.4f}, this/other "
                     f"{mean['this'] / mean['other']:.4f}")
            if sdpa is not None:
                s = cs.device_ms(sdpa)
                line += f"; SDPA {s:.4f} (this/SDPA {mean['this'] / s:.3f})"
            if bound is not None:
                line += (f"; bound {bound[0]:.4f} by {bound[1]} ({bound[0] / mean['this']:.1%} of "
                         f"this, {bound[0] / mean['other']:.1%} of other)")
        print(line, flush=True)

    def sep_plain(q, k, v, do, vl, chunk=32):  # float32 plain forward and backward
        parts = []
        for s in range(0, q.shape[0], chunk):
            qq, kk, vv, dd = (x[s:s + chunk].float() for x in (q, k, v, do))
            o, lse = fa.flash_attention_reference(qq, kk, vv, vl)
            parts.append((o, *fa.flash_attention_bwd_reference(qq, kk, vv, o, lse, dd, vl)))
        return [torch.cat(p) for p in zip(*parts)]

    def sdpa_pair(q, k, v, do, **kw):
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qr, kr, vr, **kw)
        return (lambda: F.scaled_dot_product_attention(q, k, v, **kw),
                lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True))

    rng = np.random.default_rng(cs.SEED + 26)
    for dh, heads in WIDTHS.items():
        hd, tag = heads * dh, f"dh {dh}, {heads} heads, B={B} N={N}"
        qkv = torch.cat([cs.bf16_randn(rng, (B, N, 2 * hd), 1.5), cs.bf16_randn(rng, (B, N, hd))],
                        -1)
        do = cs.bf16_randn(rng, (B, N, hd))
        o, lse = fa.flash_attention_qkv_fwd(qkv, heads)
        ref = cs.qkv_plain(fa, qkv, do, N, torch.float32, heads=heads)
        q, k, v = fa.split_qkv(qkv, heads)
        do4 = do.view(B, N, heads, dh).transpose(1, 2)
        s_fwd, s_bwd = sdpa_pair(q, k, v, do4)
        fwd_f, bwd_f = cs.attention_flops(B, heads, N, N, dh)
        case(f"forward ({tag})", lambda: fa.flash_attention_qkv_fwd(qkv, heads)[0], ref[:1],
             s_fwd, cs.bound_ms(fwd_f, cs.nbytes_of(qkv, o, lse)))
        case(f"backward ({tag})", lambda: fa.flash_attention_qkv_bwd(qkv, o, lse, do, heads),
             ref[1:], s_bwd, cs.bound_ms(bwd_f, cs.nbytes_of(qkv, o, lse, do, qkv)))
        del ref, s_fwd, s_bwd

        keep = fa.dropout_keep_mask(cs.DROP_SEED, B, heads, N, N, cs.DROP_RATE, device="cuda")
        od, ld = fa.flash_attention_qkv_dropout_fwd(qkv, heads, N, cs.DROP_RATE, cs.DROP_SEED)
        ref = cs.qkv_plain(fa, qkv, do, N, torch.float32, keep=keep, heads=heads)
        del keep
        s_fwd, s_bwd = sdpa_pair(q, k, v, do4, dropout_p=cs.DROP_RATE)
        case(f"forward, dropout {cs.DROP_RATE} ({tag})",
             lambda: fa.flash_attention_qkv_dropout_fwd(qkv, heads, N, cs.DROP_RATE,
                                                        cs.DROP_SEED)[0],
             ref[:1], s_fwd, cs.bound_ms(fwd_f, cs.nbytes_of(qkv, od, ld)))
        case(f"backward, dropout {cs.DROP_RATE} ({tag})",
             lambda: fa.flash_attention_qkv_dropout_bwd(qkv, od, ld, do, heads, N, cs.DROP_RATE,
                                                        cs.DROP_SEED),
             ref[1:], s_bwd, cs.bound_ms(bwd_f, cs.nbytes_of(qkv, od, ld, do, qkv)))
        del ref, s_fwd, s_bwd, od, ld, qkv, do, do4, o, lse, q, k, v

        q8 = cs.bf16_randn(rng, (B, heads, 8, dh), 1.5)
        k8, v8 = cs.bf16_randn(rng, (B, heads, N, dh), 1.5), cs.bf16_randn(rng, (B, heads, N, dh))
        do8 = cs.bf16_randn(rng, (B, heads, 8, dh))
        o8, l8 = fa.flash_attention_fwd(q8, k8, v8)
        ref = sep_plain(q8, k8, v8, do8, N)
        s_fwd, s_bwd = sdpa_pair(q8, k8, v8, do8)
        fwd_f, bwd_f = cs.attention_flops(B, heads, 8, N, dh)
        tag8 = f"8 queries, dh {dh}, {heads} heads, B={B} N={N}"
        case(f"forward ({tag8})", lambda: fa.flash_attention_fwd(q8, k8, v8)[0], ref[:1], s_fwd,
             cs.bound_ms(fwd_f, cs.nbytes_of(q8, k8, v8, o8, l8)))
        case(f"backward ({tag8})", lambda: fa.flash_attention_bwd(q8, k8, v8, o8, l8, do8),
             ref[1:], s_bwd, cs.bound_ms(bwd_f, cs.nbytes_of(q8, k8, v8, o8, l8, do8, q8, k8, v8)))
        del q8, k8, v8, do8, o8, l8, ref, s_fwd, s_bwd
        torch.cuda.empty_cache()

    dh, heads, bt, nt = TILED
    q, k, v = (cs.bf16_randn(rng, (bt, heads, nt, dh), 1.5 if i < 2 else 1.0) for i in range(3))
    do = cs.bf16_randn(rng, (bt, heads, nt, dh))
    o, lse = fa.flash_attention_tiled_fwd(q, k, v)
    ref = sep_plain(q, k, v, do, nt, chunk=1)
    s_fwd, s_bwd = sdpa_pair(q, k, v, do)
    fwd_f, bwd_f = cs.attention_flops(bt, heads, nt, nt, dh)
    tag = f"tiled entry, dh {dh}, {heads} heads, B={bt} N={nt}"
    case(f"forward ({tag})", lambda: fa.flash_attention_tiled_fwd(q, k, v)[0], ref[:1], s_fwd,
         cs.bound_ms(fwd_f, cs.nbytes_of(q, k, v, o, lse)))
    case(f"backward ({tag})", lambda: fa.flash_attention_tiled_bwd(q, k, v, o, lse, do), ref[1:],
         s_bwd, cs.bound_ms(bwd_f, cs.nbytes_of(q, k, v, o, lse, do, q, k, v)))
    del q, k, v, do, o, lse, ref, s_fwd, s_bwd

    for name, (dh, heads, bc, nq, nk, vl) in CHECKS.items():
        q = cs.bf16_randn(rng, (bc, heads, nq, dh), 1.5)
        k, v = cs.bf16_randn(rng, (bc, heads, nk, dh), 1.5), cs.bf16_randn(rng, (bc, heads, nk, dh))
        do = cs.bf16_randn(rng, (bc, heads, nq, dh))
        o, lse = fa.flash_attention_fwd(q, k, v, vl)
        ref = sep_plain(q, k, v, do, vl)
        tag = f"{name}, dh {dh}, {heads} heads, B={bc} nq={nq} nk={nk} valid_len={vl}"
        case(f"forward ({tag})", lambda: fa.flash_attention_fwd(q, k, v, vl)[0], ref[:1],
             timed=False)
        case(f"backward ({tag})", lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, vl),
             ref[1:], timed=False)
        if nq == nk:  # dropout on the packed entry
            hd = heads * dh
            qkv = torch.cat([cs.bf16_randn(rng, (bc, nq, 2 * hd), 1.5),
                             cs.bf16_randn(rng, (bc, nq, hd))], -1)
            dq = cs.bf16_randn(rng, (bc, nq, hd))
            keep = fa.dropout_keep_mask(cs.DROP_SEED, bc, heads, nq, nq, cs.DROP_RATE,
                                        device="cuda")
            od, ld = fa.flash_attention_qkv_dropout_fwd(qkv, heads, vl, cs.DROP_RATE, cs.DROP_SEED)
            ref = cs.qkv_plain(fa, qkv, dq, vl, torch.float32, keep=keep, heads=heads)
            case(f"dropout {cs.DROP_RATE} forward + backward ({tag})",
                 lambda: (fa.flash_attention_qkv_dropout_fwd(qkv, heads, vl, cs.DROP_RATE,
                                                             cs.DROP_SEED)[0],
                          fa.flash_attention_qkv_dropout_bwd(qkv, od, ld, dq, heads, vl,
                                                             cs.DROP_RATE, cs.DROP_SEED)),
                 ref, timed=False)
        torch.cuda.empty_cache()

    print(f"wide_attention_compare: {len(failures)} failures" +
          "".join(f"\n  {f}" for f in failures), flush=True)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
