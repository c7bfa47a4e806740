"""The W8A8 int8 transformer-block forward: a Hopper kernel chain and its
plain version.

``fused_block_int8`` replaces the TPU kernel
``surface_vision_transformers_tpu/ops/pallas/fused_block_int8.py::
fused_block_int8`` (``_block_kernel_int8``): the four weight GEMMs (QKV,
out-projection, fc1, fc2) in int8 with int32 accumulation, weights int8 per
output channel (``ops.quant.quantize_block_weights``, once per model),
activations quantized per row on the fly; attention, LayerNorms, GELU,
biases and residuals in bf16 / float32. Inference only.

Rounding points, those of ``_block_kernel_int8``: LN1 in float32 and
quantized from float32; qkv dequantized to bf16; the bf16 attention output
quantized; x1 = x + out-proj + bias kept in float32, not rounded; LN2 from
x1 in float32 and quantized; the fc1 output + bias through GELU in float32,
quantized; out = x1 + fc2 + bias, rounded once to x's dtype. Dequantization
is (float(acc) * s_row) * s_col. Two differences are deliberate, as for the
bf16 blocks (ROADMAP queue 3): exact erf-GELU where the TPU kernel has
tanh-GELU, and the shifted softmax where it has the clamped unshifted one.

The kernel (CUDA C++ for ``sm_90a``, ``csrc/fused_block_int8.cu``) is a
chain on the caller's stream: LayerNorm + row quantization, the four int8
GEMMs on ``csrc/gemm.cuh``'s engine (TMA, ``wgmma`` m64n192k32 s8 x s8 ->
s32) with dequantizing epilogues, the streamed attention kernel of
``csrc/flash_attention.cu`` on the packed qkv, and a row-quantization pass
over the attention output (a row's absmax spans every head). fc1 runs
twice: pass 1 keeps each row's max |f| per 192-column tile, pass 2
quantizes f with the row scale those give, so f never lives in device
memory in float32 (``fc1_codes_reference`` is that arithmetic in plain
PyTorch). What bounds it on the card: the kernel source and PERF.md.

Weights: int8 (out, in) contiguous (the torch Linear layout, K contiguous
as the tensor cores' B operand reads it), float32 (out,) scales, float32
LayerNorm parameters and biases.

Dispatch: the operator ``svt::fused_block_int8`` (``serving/svt_ops.py``)
on both devices: CPU tensors run ``fused_block_int8_reference``; CUDA
tensors launch the kernel chain or raise. There is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from surface_vision_transformers_tpu_torch.ops import _native
from surface_vision_transformers_tpu_torch.ops.fused_block import (
    _attention,
    _dispatch,
    _layer_norm,
    check_dim_head,
    check_ln_dim,
    register_plain,
)
from surface_vision_transformers_tpu_torch.ops import quant
from surface_vision_transformers_tpu_torch.ops.quant import int8_mm_reference, int8_product
from surface_vision_transformers_tpu_torch.serving import svt_ops
from surface_vision_transformers_tpu_torch.serving.svt_ops import (
    GEMM_BN,
    INT8_ROW_ALIGN,  # dim and mlp: int8 rows of a multiple of 16 bytes, as TMA reads them
    int8_workspace,
)


def fused_block_int8_reference(
    x, ln1_scale, ln1_bias, q_qkv, s_qkv, q_out, s_out, b_out, ln2_scale, ln2_bias,
    q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5, ln_dim: int | None = None,
):
    """Plain PyTorch ``fused_block_int8``: x (B, N, dim) -> (B, N, dim) in
    x.dtype, keys >= ``valid_len`` masked; ``ln_dim`` as in
    ``ops.fused_block.fused_block_reference`` (the padded layout of
    ``svt_ops.pad_int8_dims``). In float32 only the int8 quantization
    rounds."""
    dt, hd = x.dtype, heads * dim_head
    vl = x.shape[1] if valid_len is None else int(valid_len)
    h = _layer_norm(x, ln1_scale, ln1_bias, ln_eps, n=ln_dim)
    qkv = int8_mm_reference(h, q_qkv, s_qkv).to(dt)
    attn = _attention(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:],
                      heads, dim_head, vl, dt)
    x1 = x.float() + (int8_mm_reference(attn, q_out, s_out) + b_out)
    h2 = _layer_norm(x1, ln2_scale, ln2_bias, ln_eps, n=ln_dim)
    f = F.gelu(int8_mm_reference(h2, q_fc1, s_fc1) + b_fc1)  # exact erf
    return (x1 + (int8_mm_reference(f, q_fc2, s_fc2) + b_fc2)).to(dt)


def _check_cuda_args(x, params, heads, dim_head, valid_len, addresses=True, ln_dim=None):
    """Validate everything the int8 chain assumes; raise on anything else.
    Every dim and mlp_dim: the CUDA kernel lays a width off
    ``INT8_ROW_ALIGN`` out padded (``svt_ops.pad_int8_dims``), or x and the
    parameters come laid out so, with ``ln_dim`` below x's width.
    ``addresses`` False leaves the 16-byte checks to the operator's CUDA
    kernel (``serving.svt_ops``): a traced tensor has no address."""
    (ln1_s, ln1_b, q_qkv, s_qkv, q_out, s_out, b_out, ln2_s, ln2_b,
     q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2) = params
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA int8 block takes bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or (addresses and x.data_ptr() % 16):
        raise ValueError("x must be a contiguous (B, N, dim) tensor on 16 bytes")
    B, N, dim = x.shape
    hd, mlp = heads * dim_head, q_fc1.shape[0]
    check_dim_head(dim_head)
    check_ln_dim(dim, ln_dim, INT8_ROW_ALIGN)
    if not 1 <= valid_len <= N:
        raise ValueError(f"valid_len {valid_len} outside [1, {N}]")
    mats = {"q_qkv": (q_qkv, s_qkv, (3 * hd, dim)), "q_out": (q_out, s_out, (dim, hd)),
            "q_fc1": (q_fc1, s_fc1, (mlp, dim)), "q_fc2": (q_fc2, s_fc2, (dim, mlp))}
    for name, (q, s, shape) in mats.items():
        if tuple(q.shape) != shape or q.dtype != torch.int8:
            raise ValueError(f"{name} must be int8 {shape} (torch Linear layout), got "
                             f"{q.dtype} {tuple(q.shape)}")
        if tuple(s.shape) != (shape[0],) or s.dtype != torch.float32:
            raise ValueError(f"the scales of {name} must be float32 ({shape[0]},), got "
                             f"{s.dtype} {tuple(s.shape)}")
        if addresses and q.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    vectors = {"ln1_scale": (ln1_s, dim), "ln1_bias": (ln1_b, dim), "b_out": (b_out, dim),
               "ln2_scale": (ln2_s, dim), "ln2_bias": (ln2_b, dim), "b_fc1": (b_fc1, mlp),
               "b_fc2": (b_fc2, dim)}
    for name, (v, n) in vectors.items():
        if tuple(v.shape) != (n,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({n},), got {v.dtype} {tuple(v.shape)}")
    for t in params:  # the engine stages scales and biases as float4: 16 bytes
        if t.device != x.device or not t.is_contiguous() or (addresses and t.data_ptr() % 16):
            raise ValueError(f"every parameter must be contiguous, on {x.device} and on "
                             "16 bytes")


def fused_block_int8(
    x, ln1_scale, ln1_bias, q_qkv, s_qkv, q_out, s_out, b_out, ln2_scale, ln2_bias,
    q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5, ln_dim: int | None = None,
):
    """One W8A8 pre-norm block, x (B, N, dim) -> (B, N, dim); parameters
    in the JAX order (codes and scales from ``quantize_block_weights``);
    ``ln_dim`` as in ``ops.fused_block.fused_block`` (a padded layout of
    ``INT8_ROW_ALIGN``). The operator ``svt::fused_block_int8``: its CPU
    kernel is ``fused_block_int8_reference``, its CUDA kernel the chain
    (bfloat16 x, scratch from ``int8_workspace``)."""
    params = (ln1_scale, ln1_bias, q_qkv, s_qkv, q_out, s_out, b_out, ln2_scale,
              ln2_bias, q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2)
    vl = x.shape[1] if valid_len is None else int(valid_len)
    n = x.shape[-1] if ln_dim is None else int(ln_dim)
    if _dispatch(x) == "cuda":
        _check_cuda_args(x, params, heads, dim_head, vl, addresses=False, ln_dim=n)
    return torch.ops.svt.fused_block_int8(x, *params, heads, dim_head, vl, ln_eps, n)


fused_block_int8.launches = 0


register_plain("svt::fused_block_int8", fused_block_int8_reference)
svt_ops.count_into(fused_block_int8=fused_block_int8)


# -- the chain's parts, for holding them bitwise against the plain versions ----


def _on_16(t: torch.Tensor) -> bool:
    """Contiguous, on 16 bytes, rows of a multiple of 16 bytes."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0 \
        and (t.shape[-1] * t.element_size()) % 16 == 0


def quant_rows_kernel(h: torch.Tensor):
    """The chain's row quantizer on a CUDA (M, K) float32 or bfloat16
    tensor, rows of a multiple of 16 bytes -> (int8 (M, K), float32 (M,)
    scales); ``ops.quant.quant_rows`` is its plain version."""
    if not h.is_cuda or h.dim() != 2 or h.dtype not in (torch.float32, torch.bfloat16) \
            or not _on_16(h):
        raise ValueError("h must be a contiguous CUDA (M, K) float32 or bfloat16 tensor on "
                         "16 bytes, its rows a multiple of 16 bytes")
    M, K = h.shape
    q = torch.empty((M, K), dtype=torch.int8, device=h.device)
    s = torch.empty((M,), dtype=torch.float32, device=h.device)
    _native.check(_native.library().svt_quant_rows(
        h.data_ptr(), int(h.dtype == torch.float32), q.data_ptr(), s.data_ptr(), M, K,
        h.device.index, torch.cuda.current_stream(h.device).cuda_stream))
    return q, s


def _check_int8_operands(q_a, q_w):
    for t in (q_a, q_w):
        if not t.is_cuda or t.dtype != torch.int8 or t.dim() != 2 or not _on_16(t):
            raise ValueError("operands must be contiguous CUDA int8 (rows, K) tensors on 16 "
                             f"bytes, K a multiple of {INT8_ROW_ALIGN}")
    if q_w.shape[1] != q_a.shape[1]:
        raise ValueError("q_a (M, K) and q_w (Nout, K) must agree in K")


def int8_gemm_kernel(q_a: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """The chain's int8 GEMM with the int32 accumulators written out: CUDA
    int8 (M, K) rows against int8 (Nout, K) codes -> int32 (M, Nout), K a
    multiple of 16 and Nout of 4; ``ops.quant.int8_product`` is its plain
    version."""
    _check_int8_operands(q_a, q_w)
    M, K = q_a.shape
    n_out = q_w.shape[0]
    if n_out % 4:
        raise ValueError("Nout must be a multiple of 4 (int32 rows on 16 bytes)")
    acc = torch.empty((M, n_out), dtype=torch.int32, device=q_a.device)
    _native.check(_native.library().svt_int8_gemm_s32(
        q_a.data_ptr(), q_w.data_ptr(), acc.data_ptr(), M, n_out, K, q_a.device.index,
        torch.cuda.current_stream(q_a.device).cuda_stream))
    return acc


def fc1_codes_reference(q_a, s_a, q_w, s_w, bias):
    """Plain fc1 and f's quantization as the chain's two passes compute
    them: f = erf-GELU((float(q_a q_w^T) * s_a) * s_w + bias) in float32,
    each row's absmax per ``GEMM_BN`` columns (pass 1), the codes by the
    scale of their maximum (pass 2) -> (int8 (M, Nout), float32 (M,))."""
    acc = int8_product(q_a, q_w).float()
    f = F.gelu(acc * s_a.reshape(-1, 1) * s_w + bias)
    return quant.quant_rows_from_partials(f, quant.row_absmax_partials(f, GEMM_BN))


# svt_int8_block_gemm's products (``csrc/fused_block_int8.cu``)
INT8_GEMMS = {"qkv": 1, "out": 2, "fc1_max": 3, "fc1_q8": 4, "fc2": 5, "fc1_codes": 6}


def int8_block_gemm(kind: str, q_a, s_a, q_w, s_w, bias=None, residual=None, part=None):
    """One of the chain's products alone on CUDA tensors, A = q_a (M, K)
    int8 with row scales s_a (M,), W = q_w (Nout, K) int8 with s_w (Nout,):
    "qkv" -> bf16 dequantized; "out" -> float32 residual (bf16 (M, Nout))
    + (dequantized + bias); "fc1_max" -> fc1's absmax partials
    (ceil(Nout / 192), M); "fc1_q8" (from ``part``) and "fc1_codes" (both
    passes) -> (int8 codes (M, Nout), float32 (M,) scales); "fc2" -> bf16
    residual (float32 (M, Nout)) + (dequantized + bias)."""
    _check_int8_operands(q_a, q_w)
    (M, K), n_out = q_a.shape, q_w.shape[0]
    if n_out % INT8_ROW_ALIGN:
        raise ValueError(f"Nout must be a multiple of {INT8_ROW_ALIGN}")
    dev = q_a.device
    f32 = dict(dtype=torch.float32, device=dev)
    parts = (-(-n_out // GEMM_BN), M)
    need = {"s_a": (s_a, (M,), torch.float32), "s_w": (s_w, (n_out,), torch.float32)}
    if kind != "qkv":
        need["bias"] = (bias, (n_out,), torch.float32)
    if kind in ("out", "fc2"):
        need["residual"] = (residual, (M, n_out),
                            torch.bfloat16 if kind == "out" else torch.float32)
    if kind == "fc1_q8":
        need["part"] = (part, parts, torch.float32)
    for name, (t, shape, dt) in need.items():
        if t is None or tuple(t.shape) != shape or t.dtype != dt or t.device != dev \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kind}: {name} must be a contiguous {dt} {shape} tensor on "
                             f"{dev}, on 16 bytes")
    c = sq = None
    if kind in ("fc1_max", "fc1_q8", "fc1_codes"):
        part = torch.empty(parts, **f32) if part is None else part
        if kind != "fc1_max":
            c = torch.empty((M, n_out), dtype=torch.int8, device=dev)
            sq = torch.empty((M,), **f32)
    else:
        c = torch.empty((M, n_out), dtype=torch.float32 if kind == "out" else torch.bfloat16,
                        device=dev)
    ptrs = [t.data_ptr() if t is not None else None
            for t in (q_a, s_a, q_w, s_w, bias, residual, c, part, sq)]
    _native.check(_native.library().svt_int8_block_gemm(
        INT8_GEMMS[kind], *ptrs, M, n_out, K, dev.index,
        torch.cuda.current_stream(dev).cuda_stream))
    return part if kind == "fc1_max" else (c, sq) if sq is not None else c


def fc1_codes_kernel(q_a, s_a, q_w, s_w, bias):
    """The chain's fc1 and f's quantization (passes 1 and 2) on CUDA
    tensors -> (int8 (M, Nout) codes, float32 (M,) scales);
    ``fc1_codes_reference`` is its plain version."""
    return int8_block_gemm("fc1_codes", q_a, s_a, q_w, s_w, bias)


def int8_scan(scales: torch.Tensor) -> dict:
    """What fc1's epilogues assume of their arithmetic, scanned on the card
    over every float (``svt_int8_scan``): the count of v >= 0 where
    ``gelu_erf`` decreases to the next float (must be 0), the largest
    |gelu_erf| over v < 0 and the bound the kernel takes for it
    (``GELU_NEG_MAX``), and the count of floats v in [0, 128 s], for each
    CUDA float32 scale s, whose code by reciprocal and corrections
    (``quant_code_r``) differs from the code by IEEE division (must be 0)."""
    out = torch.zeros(4, dtype=torch.int32, device=scales.device)
    _native.check(_native.library().svt_int8_scan(
        scales.data_ptr(), scales.numel(), out.data_ptr(), scales.device.index,
        torch.cuda.current_stream(scales.device).cuda_stream))
    o = out.cpu()
    return {"gelu_decreases": int(o[0]), "gelu_neg_max": float(o[1:2].view(torch.float32)),
            "gelu_neg_bound": float(o[3:4].view(torch.float32)), "codes_differ": int(o[2])}
