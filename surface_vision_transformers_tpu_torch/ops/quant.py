"""Symmetric int8 quantizers and the integer product, in plain PyTorch.

Counterparts of ``quantize_weight_int8``, ``quantize_block_weights``,
``_quant_rows`` and ``_int8_mm`` in
``surface_vision_transformers_tpu/ops/pallas/fused_block_int8.py``. The JAX
package computes the weight quantizer outside its kernel, so it stays plain
PyTorch here; the row quantizer and the integer product are the plain
versions the CUDA chain (``csrc/fused_block_int8.cu``) is held against.

Bit for bit the JAX arithmetic: scale = max(absmax, 1e-30) / 127 (a float32
division), code = clip(round_half_even(v / scale), -127, 127) (a division,
not a multiply by 127 / absmax; ``torch.round`` rounds half to even, as
``jnp.round`` does).

Weights are in the torch ``nn.Linear`` layout (out, in): the per-output-
channel absmax is a row absmax, so the codes are the JAX (in, out) codes
transposed and the scales are equal.
"""

from __future__ import annotations

import torch

_FLOOR = 1e-30  # the scale of an all-zero row: no division by zero, codes 0


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: CUDA torch turns division by a Python scalar into a
    # multiply by its reciprocal, which is not the IEEE quotient
    return torch.clamp(absmax, min=_FLOOR) / torch.full_like(absmax, 127.0)


def _codes(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)


def _quantize(v: torch.Tensor, absmax: torch.Tensor):
    s = _scale(absmax)
    return _codes(v, s), s


def quantize_weight_int8(w: torch.Tensor):
    """Per-output-channel int8 of an (out, in) weight, from its float32
    values -> (int8 (out, in), float32 (out,) scales)."""
    wf = w.detach().float()
    q, s = _quantize(wf, wf.abs().amax(dim=1, keepdim=True))
    return q.contiguous(), s.reshape(-1).contiguous()


def quantize_block_weights(w_qkv, w_out, w_fc1, w_fc2) -> tuple:
    """The four GEMM weights of one block -> (q_qkv, s_qkv, q_out, s_out,
    q_fc1, s_fc1, q_fc2, s_fc2), the JAX order."""
    out = []
    for w in (w_qkv, w_out, w_fc1, w_fc2):
        out.extend(quantize_weight_int8(w))
    return tuple(out)


def quant_rows(h: torch.Tensor):
    """Dynamic per-row int8 of (..., K) activations, taken in float32 ->
    (int8 (..., K), float32 (..., 1) scales)."""
    hf = h.float()
    return _quantize(hf, hf.abs().amax(dim=-1, keepdim=True))


def row_absmax_partials(h: torch.Tensor, tile: int) -> torch.Tensor:
    """Each row's max |h| over each ``tile``-column slice of (M, K) ``h``,
    taken in float32 -> (ceil(K / tile), M): what the CUDA chain's fc1 pass
    1 writes for f, one partial per row and 192-column GEMM tile."""
    hf = h.float().abs()
    return torch.stack([hf[:, c:c + tile].amax(dim=1) for c in range(0, hf.shape[1], tile)])


def quant_rows_from_partials(h: torch.Tensor, part: torch.Tensor):
    """``quant_rows`` of (M, K) ``h`` with each row's absmax taken as the
    maximum of its partials (T, M) -> (int8 (M, K), float32 (M,) scales):
    the CUDA chain's fc1 pass 2. The maximum is exact in any grouping, so
    these are ``quant_rows``' codes and scales bit for bit."""
    s = _scale(part.amax(dim=0))
    return _codes(h.float(), s.reshape(-1, 1)), s


def int8_product(q_a: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """The exact int32 accumulators of int8 (..., K) rows against int8
    (Nout, K) weights -> (..., Nout). The products run in float64, exact
    while |sum| < 2^53 (here at most 127^2 * K)."""
    acc = q_a.double() @ q_w.double().t()
    return acc.to(torch.int32)


def int8_mm_reference(h: torch.Tensor, q_w: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """The W8A8 product of the JAX ``_int8_mm``: float (..., K) rows
    quantized per row, the integer product against (Nout, K) codes, then
    (float(acc) * s_row) * s_col in float32 -> (..., Nout)."""
    q, s = quant_rows(h)
    return int8_product(q, q_w).float() * s * s_w
