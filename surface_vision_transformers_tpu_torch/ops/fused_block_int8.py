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
chain on the caller's stream: LayerNorm + row quantization, an int8
tensor-core GEMM (``mma.sync.m16n8k32`` s8 x s8 -> s32) with dequantizing
epilogues, the streamed attention kernel of ``csrc/flash_attention.cu`` on
the packed qkv, and a row-quantization pass over the attention output and
over the GELU output (a row's absmax spans every head and every MLP
column, which no GEMM tile holds). What bounds it on the card: the kernel
source and PERF.md.

Weights: int8 (out, in) contiguous (the torch Linear layout, K contiguous
as the tensor cores' B operand reads it), float32 (out,) scales, float32
LayerNorm parameters and biases.

Dispatch: CPU tensors run ``fused_block_int8_reference``; CUDA tensors
launch the kernel chain or raise. There is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from surface_vision_transformers_tpu_torch.ops import _native
from surface_vision_transformers_tpu_torch.ops.fused_block import (
    _attention,
    _dispatch,
    _layer_norm,
)
from surface_vision_transformers_tpu_torch.ops.quant import int8_mm_reference

INT8_K_STEP = 32  # the s8 MMA's K step: dim, heads * 64 and mlp are multiples


def fused_block_int8_reference(
    x, ln1_scale, ln1_bias, q_qkv, s_qkv, q_out, s_out, b_out, ln2_scale, ln2_bias,
    q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5,
):
    """Plain PyTorch ``fused_block_int8``: x (B, N, dim) -> (B, N, dim) in
    x.dtype, keys >= ``valid_len`` masked. In float32 only the int8
    quantization rounds."""
    dt, hd = x.dtype, heads * dim_head
    vl = x.shape[1] if valid_len is None else int(valid_len)
    h = _layer_norm(x, ln1_scale, ln1_bias, ln_eps)
    qkv = int8_mm_reference(h, q_qkv, s_qkv).to(dt)
    attn = _attention(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:],
                      heads, dim_head, vl, dt)
    x1 = x.float() + (int8_mm_reference(attn, q_out, s_out) + b_out)
    h2 = _layer_norm(x1, ln2_scale, ln2_bias, ln_eps)
    f = F.gelu(int8_mm_reference(h2, q_fc1, s_fc1) + b_fc1)  # exact erf
    return (x1 + (int8_mm_reference(f, q_fc2, s_fc2) + b_fc2)).to(dt)


def _check_cuda_args(x, params, heads, dim_head, valid_len):
    """Validate everything the int8 chain assumes; raise on anything else."""
    (ln1_s, ln1_b, q_qkv, s_qkv, q_out, s_out, b_out, ln2_s, ln2_b,
     q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2) = params
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA int8 block takes bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous (B, N, dim) tensor on 16 bytes")
    B, N, dim = x.shape
    hd, mlp = heads * dim_head, q_fc1.shape[0]
    if dim_head != 64:
        raise NotImplementedError(
            f"the attention kernel is built for dim_head 64, got {dim_head}")
    if dim % INT8_K_STEP or mlp % INT8_K_STEP:
        raise NotImplementedError(
            f"dim and mlp_dim must be multiples of {INT8_K_STEP} (the s8 MMA's K step)")
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
        if q.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    vectors = {"ln1_scale": (ln1_s, dim), "ln1_bias": (ln1_b, dim), "b_out": (b_out, dim),
               "ln2_scale": (ln2_s, dim), "ln2_bias": (ln2_b, dim), "b_fc1": (b_fc1, mlp),
               "b_fc2": (b_fc2, dim)}
    for name, (v, n) in vectors.items():
        if tuple(v.shape) != (n,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({n},), got {v.dtype} {tuple(v.shape)}")
    for t in params:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"every parameter must be contiguous and on {x.device}")


def fused_block_int8(
    x, ln1_scale, ln1_bias, q_qkv, s_qkv, q_out, s_out, b_out, ln2_scale, ln2_bias,
    q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5,
):
    """One W8A8 pre-norm block, x (B, N, dim) -> (B, N, dim); parameters
    in the JAX order (codes and scales from ``quantize_block_weights``).
    CPU tensors run ``fused_block_int8_reference``; CUDA tensors the kernel
    chain (bfloat16 x)."""
    params = (ln1_scale, ln1_bias, q_qkv, s_qkv, q_out, s_out, b_out, ln2_scale,
              ln2_bias, q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2)
    vl = x.shape[1] if valid_len is None else int(valid_len)
    if _dispatch(x) == "cpu":
        return fused_block_int8_reference(x, *params, heads=heads, dim_head=dim_head,
                                          valid_len=vl, ln_eps=ln_eps)
    _check_cuda_args(x, params, heads, dim_head, vl)
    lib = _native.library()
    B, N, dim = x.shape
    hd, mlp, M = heads * dim_head, q_fc1.shape[0], B * N
    dev = x.device
    out = torch.empty_like(x)
    ws = [torch.empty((M, max(dim, hd, mlp)), dtype=torch.int8, device=dev),
          torch.empty((M,), dtype=torch.float32, device=dev),
          x.new_empty((M, 3 * hd)), x.new_empty((M, hd)),
          torch.empty((M, dim), dtype=torch.float32, device=dev),
          torch.empty((M, mlp), dtype=torch.float32, device=dev)]
    _native.check(lib.svt_fused_block_int8(
        *[t.data_ptr() for t in (x, *params, out, *ws)],
        B, N, dim, heads, dim_head, mlp, vl, ln_eps, dev.index,
        torch.cuda.current_stream(dev).cuda_stream))
    fused_block_int8.launches += 1
    return out


fused_block_int8.launches = 0


# -- the chain's parts, for holding them bitwise against the plain versions ----


def quant_rows_kernel(h: torch.Tensor):
    """The chain's row quantizer on a CUDA (M, K) float32 or bfloat16
    tensor -> (int8 (M, K), float32 (M,) scales); ``ops.quant.quant_rows``
    is its plain version."""
    if not h.is_cuda or h.dim() != 2 or not h.is_contiguous() \
            or h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("h must be a contiguous CUDA (M, K) float32 or bfloat16 tensor")
    M, K = h.shape
    q = torch.empty((M, K), dtype=torch.int8, device=h.device)
    s = torch.empty((M,), dtype=torch.float32, device=h.device)
    _native.check(_native.library().svt_quant_rows(
        h.data_ptr(), int(h.dtype == torch.float32), q.data_ptr(), s.data_ptr(), M, K,
        h.device.index, torch.cuda.current_stream(h.device).cuda_stream))
    return q, s


def int8_gemm_kernel(q_a: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """The chain's int8 GEMM with the int32 accumulators written out: CUDA
    int8 (M, K) rows against int8 (Nout, K) codes -> int32 (M, Nout);
    ``ops.quant.int8_product`` is its plain version."""
    M, K = q_a.shape
    n_out = q_w.shape[0]
    for t in (q_a, q_w):
        if not t.is_cuda or t.dtype != torch.int8 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous CUDA int8 tensors on 16 bytes")
    if q_w.shape[1] != K or K % INT8_K_STEP or n_out % 8:
        raise ValueError(f"K must match and be a multiple of {INT8_K_STEP}, Nout of 8")
    acc = torch.empty((M, n_out), dtype=torch.int32, device=q_a.device)
    _native.check(_native.library().svt_int8_gemm_s32(
        q_a.data_ptr(), q_w.data_ptr(), acc.data_ptr(), M, n_out, K, q_a.device.index,
        torch.cuda.current_stream(q_a.device).cuda_stream))
    return acc
