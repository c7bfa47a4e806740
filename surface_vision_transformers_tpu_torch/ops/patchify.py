"""Icosahedral patchification and the patch embedding, in plain PyTorch.

Counterpart of ``surface_vision_transformers_tpu.ops.patchify``: the JAX
package's default (``backend="auto"``) embedding, a vertex gather, then one
contraction over (channel, vertex) against the kernel reordered to (C, V,
dim). The port runs it on the CPU and on the "plain" attention backend; on
CUDA in bf16 the raw-input embedding is the gather-fused kernel of
``ops.patch_embed`` (the JAX ``backend="pallas"`` function).

Token layout is the reference's ``Rearrange('b c n v -> b n (v c)')``:
feature index v * C + c (channel fastest). Kernels are in the JAX layout,
(V * C, dim), so the functions compare one to one with the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def _flat_indices(indices, device) -> torch.Tensor:
    return torch.as_tensor(
        np.ascontiguousarray(np.asarray(indices).reshape(-1)),
        dtype=torch.long, device=device,
    )


def _stats(a, device) -> torch.Tensor:
    """(1, C, 1) or (C,) stats -> flat float32 (C,)."""
    return torch.as_tensor(np.asarray(a, np.float32).reshape(-1), device=device)


def patchify(x: torch.Tensor, indices) -> torch.Tensor:
    """(B, C, G) raw vertex features -> (B, L, V*C) tokens, (v c) order."""
    L, V = np.asarray(indices).shape
    B, C, _ = x.shape
    g = x.index_select(2, _flat_indices(indices, x.device))
    return g.reshape(B, C, L, V).permute(0, 2, 3, 1).reshape(B, L, V * C)


def rearrange_patched(x: torch.Tensor) -> torch.Tensor:
    """(B, C, L, V) pre-patched input -> (B, L, V*C) tokens, (v c) order."""
    B, C, L, V = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, L, V * C)


def fold_normalization(kernel, bias, means, stds, num_vertices: int):
    """Fold per-channel z-scoring into the embedding, in float32:
    ((t - mean) / std) @ W + b == t @ (W / std) + (b - (mean / std) @ W),
    with the stats tiled over the (v c) feature order."""
    mean_flat = _stats(means, kernel.device).repeat(num_vertices)
    std_flat = _stats(stds, kernel.device).repeat(num_vertices)
    kernel = kernel.float()
    return (kernel / std_flat[:, None],
            bias.float() - (mean_flat / std_flat) @ kernel)


def normalize_tokens(tokens: torch.Tensor, means, stds) -> torch.Tensor:
    """Per-channel z-score of (..., V*C) tokens in (v c) order."""
    m, s = _stats(means, tokens.device), _stats(stds, tokens.device)
    reps = tokens.shape[-1] // m.shape[0]
    return (tokens - m.repeat(reps)) / s.repeat(reps)


def embed_weights(kernel, bias, num_vertices: int, *, means=None, stds=None,
                  compute_dtype=torch.bfloat16):
    """(V*C, dim) kernel and (dim,) bias -> the (C, V, dim) kernel and bias
    ``gather_embed`` contracts with, normalisation folded in float32 first,
    then cast to the compute dtype. Computed once per model load."""
    if means is not None:
        kernel, bias = fold_normalization(kernel, bias, means, stds,
                                          num_vertices)
    V = num_vertices
    w_cv = kernel.reshape(V, kernel.shape[0] // V, -1).permute(1, 0, 2)
    return w_cv.to(compute_dtype).contiguous(), bias.to(compute_dtype)


def gather_embed(x: torch.Tensor, flat_indices: torch.Tensor,
                 w_cv: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, C, G) -> (B, L, dim): gather the patch vertices, then contract
    (c, v) against ``w_cv`` (C, V, dim) in its dtype."""
    B, C, _ = x.shape
    V = w_cv.shape[1]
    g = x.index_select(2, flat_indices).reshape(B, C, -1, V).to(w_cv.dtype)
    return torch.einsum("bclv,cvd->bld", g, w_cv) + bias


def fused_patch_embed(x: torch.Tensor, indices, kernel, bias, *, means=None,
                      stds=None, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Patchify + (optional) normalise + embed: (B, C, G) -> (B, L, dim)."""
    w_cv, b = embed_weights(kernel, bias, np.asarray(indices).shape[1],
                            means=means, stds=stds,
                            compute_dtype=compute_dtype)
    return gather_embed(x, _flat_indices(indices, x.device), w_cv, b)
