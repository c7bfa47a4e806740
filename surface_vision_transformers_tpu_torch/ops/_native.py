"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources in ``csrc/`` compile on first use into ``_build/`` beside this
package, under a name keyed on a hash of the sources and the compiler flags,
so a fresh checkout builds once and an edited source rebuilds. Each ``.cu``
compiles in its own nvcc process, all started together, and one link makes
the library. It has a plain C interface (no PyTorch headers), which keeps
the build to seconds. Nothing is built at import time: the serving
operators (``serving/svt_ops.py``) are bound to ``build`` here and build at
their first launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from surface_vision_transformers_tpu_torch.serving import svt_ops

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
        "(on PATH, under $CUDA_HOME, or at /usr/local/cuda)"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsvt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/`` unless this source hash is already built: one nvcc
    per source in parallel, then a link. The compilers' reports (registers,
    shared memory, spills per kernel) are kept beside the library as
    ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj, log = tmp / f"{src.stem}.o", tmp / f"{src.stem}.log"
            with open(log, "w") as f:
                proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                        stdout=f, stderr=subprocess.STDOUT)
            jobs.append((src, obj, log, proc))
        failed = [src.name for src, _, _, proc in jobs if proc.wait()]
        report = "".join(f"== {src.name}\n{log.read_text()}" for src, _, log, _ in jobs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{report}")
        lib = tmp / out.name
        res = subprocess.run([nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"linking the kernels failed ({res.returncode}):\n{res.stderr}")
        out.with_suffix(".log").write_text(report)
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry's C signature (the
    serving operators' entries as ``serving.svt_ops`` declares them)."""
    lib = svt_ops.declare(ctypes.CDLL(str(build())))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.svt_fused_block_train_fwd.argtypes = [P] * 23 + [I] * 8 + [F, I, P]
    lib.svt_fused_block_train_fwd.restype = I
    lib.svt_fused_block_cls_train_fwd.argtypes = [P] * 24 + [I] * 9 + [F, I, P]
    lib.svt_fused_block_cls_train_fwd.restype = I
    lib.svt_fused_block_bwd.argtypes = [P] * 38 + [I] * 9 + [P]
    lib.svt_fused_block_bwd.restype = I
    lib.svt_fused_block_cls_bwd.argtypes = [P] * 40 + [I] * 10 + [P]
    lib.svt_fused_block_cls_bwd.restype = I
    lib.svt_block_bwd_workspace.argtypes = [I] * 7
    lib.svt_block_bwd_workspace.restype = ctypes.c_longlong
    lib.svt_block_bwd_dh_floats.argtypes = [I] * 4
    lib.svt_block_bwd_dh_floats.restype = ctypes.c_longlong
    lib.svt_block_gemm.argtypes = [I] + [P] * 6 + [I] * 4 + [P]
    lib.svt_block_gemm.restype = I
    lib.svt_block_gemm_nn.argtypes = [I] + [P] * 6 + [I] * 4 + [P]
    lib.svt_block_gemm_nn.restype = I
    lib.svt_block_gemm_ln.argtypes = [I] + [P] * 10 + [I] * 4 + [P]
    lib.svt_block_gemm_ln.restype = I
    lib.svt_block_gemm_ln_workspace.argtypes = [I] * 2
    lib.svt_block_gemm_ln_workspace.restype = ctypes.c_longlong
    lib.svt_block_mlp.argtypes = [P] * 12 + [I] * 3 + [F, I, P]
    lib.svt_block_mlp.restype = I
    lib.svt_block_ln_gemm.argtypes = [P] * 7 + [I] * 3 + [F, I, P]
    lib.svt_block_ln_gemm.restype = I
    lib.svt_block_weight_grad.argtypes = [P] * 4 + [I] * 4 + [P]
    lib.svt_block_weight_grad.restype = I
    lib.svt_block_weight_grad_workspace.argtypes = [I] * 3
    lib.svt_block_weight_grad_workspace.restype = ctypes.c_longlong
    S = [P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong]  # strided operand
    D = [ctypes.c_uint, ctypes.c_uint, F, I]  # dropout: seed, threshold, 1/(1-rate), on
    lib.svt_flash_attention_fwd.argtypes = S * 4 + [P] + [I] * 6 + D + [I, P]
    lib.svt_flash_attention_fwd.restype = I
    lib.svt_flash_attention_bwd.argtypes = S * 5 + [P, P, P] + S * 3 + [I] * 6 + D + [I, P]
    lib.svt_flash_attention_bwd.restype = I
    lib.svt_flash_attention_bwd_workspace.argtypes = [I] * 5
    lib.svt_flash_attention_bwd_workspace.restype = ctypes.c_longlong
    lib.svt_quant_rows.argtypes = [P, I, P, P, I, I, I, P]
    lib.svt_quant_rows.restype = I
    lib.svt_int8_gemm_s32.argtypes = [P, P, P, I, I, I, I, P]
    lib.svt_int8_gemm_s32.restype = I
    lib.svt_int8_block_gemm.argtypes = [I] + [P] * 9 + [I] * 3 + [I, P]
    lib.svt_int8_block_gemm.restype = I
    lib.svt_int8_scan.argtypes = [P, I, P, I, P]
    lib.svt_int8_scan.restype = I
    return lib


svt_ops.bind(build)  # the serving operators build and open the library at their first launch


def check(err: int) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err:
        msg = library().svt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (error {err})")
