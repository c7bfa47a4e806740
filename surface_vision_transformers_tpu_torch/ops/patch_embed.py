"""The patch embedding as one kernel: a gather-fused Hopper GEMM and its
plain version.

``patch_embed`` replaces the TPU kernel
``surface_vision_transformers_tpu/ops/pallas/patch_embed.py::
pallas_patch_embed`` (``_embed_kernel``): (B, C, G) raw vertex features ->
the (v c)-ordered patch tokens, rounded to the compute dtype -> tokens @ W
+ b with float32 accumulation and a float32 bias, rounded once to the
compute dtype. Normalisation is folded into W and b by the caller
(``embed_matrix``). This differs from ``ops.patchify.gather_embed``, which
adds a compute-dtype bias after rounding the product, by at most one step
of the compute dtype.

The kernel (CUDA C++ for ``sm_90a``, ``csrc/patch_embed.cu``) gathers
``x[b, c, idx[l, v]]`` into shared memory as its GEMM's A operand, so the
tokens never reach device memory: a persistent, warp-specialised kernel
whose gather warps keep many loads in flight and fill 64-deep K-slices of
the A tile through a ring, while consumer warpgroups run ``wgmma`` on the
slices that have landed against W streamed by TMA, and store by TMA. It
takes W in the torch ``nn.Linear`` layout (dim, V*C), K in (v c) order,
zero-padded to a multiple of ``K_STEP``, and C = 4 channels (a vertex's
channels are one 8-byte piece of the tile); ``embed_plan`` mirrors its
tiling and its shared memory, and shapes it cannot take are refused.

``PatchEmbed`` is its autograd function: the kernel forward on CUDA, a
plain backward (dW = tokens^T dout, db = sum dout, in float32, to the
folded weight and bias, so autograd carries them through
``fold_normalization`` to the ``nn.Linear``); x gets no gradient. The JAX
package has no backward kernel for this function.

Dispatch: CPU tensors run ``patch_embed_reference``; CUDA tensors launch the
kernel (bfloat16 W) or raise. There is no fallback.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch
import torch.nn.functional as F

from surface_vision_transformers_tpu_torch.ops import _native
from surface_vision_transformers_tpu_torch.ops.fused_block import _mm32
from surface_vision_transformers_tpu_torch.ops.patchify import fold_normalization

K_STEP = 64  # the kernel's K slice: W's columns are zero-padded to a multiple
CHANNELS = 4  # the kernel's C: a vertex's channels, 8 bytes of the A tile
_SMEM_MAX = 232448  # an H100 block's shared memory


@functools.cache
def embed_plan(L: int, V: int, kp: int, dim: int) -> types.MappingProxyType:
    """The kernel's tiling at these shapes (``csrc/patch_embed.cu``'s
    ``embed_plan``; ``svt_patch_embed_smem`` gives its ``bytes``): N-tiles
    of ``nb`` = 192 columns (96 at dim <= 96); at dim <= 96 two consumer
    warpgroups on an item's two 64-row halves (``mw`` 2: items of 128
    patches, both reading each W slice), up to 192 one, past it two on
    their own N-tiles (``nw`` 2: items of 64 patches, each consumer making
    ``passes`` passes over the item's ``ks`` K-slices, or, where those do
    not fit the A ring, ``reps`` items a (group, sample), one a pass, each
    gathered again); a W ring of ``sw`` stages an N-part (3 for one
    consumer, 2 for two; at n = 96 every slice it reads, up to 4, loaded
    once); two 8 KB staging boxes a consumer, the group's table rows, and
    an A ring of ``sa`` slices in what an H100 block's shared memory
    leaves, up to 8. ``bytes`` is 0 where fewer than two slices fit.
    Cached, and read-only."""
    nb = 96 if dim <= 96 else 192
    nt = -(-dim // nb)
    mw = 2 if nb == 96 else 1
    nw = 2 if nt > 1 else 1
    ks = kp // K_STEP
    passes = -(-nt // nw)
    rows, w_item = 64 * mw, passes * ks
    slice_bytes = rows * K_STEP * 2
    sw = w_item if nb == 96 and w_item <= 4 else 3 if nw == 1 else 2
    w_bytes, stage_bytes = nw * sw * nb * K_STEP * 2, mw * nw * 2 * 64 * 64 * 2
    rest = w_bytes + stage_bytes + rows * V * 4 + (2 * 8 + 2 * nw * sw) * 8
    sa = min(8, (_SMEM_MAX - 1024 - rest) // slice_bytes)
    reps = passes if passes > 1 and ks > sa else 1
    if reps > 1:
        passes = 1
    nbytes = (max(sa, 0) * slice_bytes + w_bytes + stage_bytes + (rows * V * 4 + 7) // 8 * 8
              + (2 * sa + 2 * nw * sw) * 8 + 1024)
    if sa < 2 or kp % K_STEP or kp < V * CHANNELS:
        nbytes = 0
    return types.MappingProxyType(dict(nb=nb, nt=nt, mw=mw, nw=nw, ks=ks, passes=passes,
                                       reps=reps, sa=sa, sw=sw, bytes=nbytes))


def table_tensor(indices, device) -> torch.Tensor:
    """A (L, V) patch table as a contiguous int32 tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(np.asarray(indices), np.int32), device=device)


def _padded(weight, dt):
    """(dim, K) weight -> (dim, Kp) in ``dt``, K zero-padded to a multiple
    of ``K_STEP``, contiguous."""
    w = weight.to(dt)
    return F.pad(w, (0, -w.shape[1] % K_STEP)).contiguous()


def embed_matrix(kernel, bias, num_vertices: int, *, means=None, stds=None,
                 compute_dtype=torch.bfloat16):
    """(V*C, dim) kernel (the JAX layout, or the Linear weight transposed)
    and (dim,) bias -> ((dim, Kp) weight in ``compute_dtype``, (v c) order,
    zero-padded to a multiple of ``K_STEP``; float32 (dim,) bias), with the
    normalisation folded in float32 first. For serving: prepared once."""
    if means is not None:
        kernel, bias = fold_normalization(kernel, bias, means, stds, num_vertices)
    return _padded(kernel.t(), compute_dtype), bias.float()


def _tokens(x, indices):
    """(B, C, G) -> (B, L, V*C) tokens in (v c) order, gathered through an
    (L, V) integer table tensor."""
    L, V = indices.shape
    B, C, _ = x.shape
    g = x.index_select(2, indices.reshape(-1))
    return g.reshape(B, C, L, V).permute(0, 2, 3, 1).reshape(B, L, V * C)


def patch_embed_reference(x, indices, weight, bias):
    """Plain PyTorch ``patch_embed``: x (B, C, G), ``indices`` (L, V) table
    tensor, weight (dim, >= V*C) in the compute dtype, float32 bias ->
    (B, L, dim) in weight.dtype."""
    tokens = _tokens(x, indices)
    k = tokens.shape[-1]
    out = tokens.to(weight.dtype).float() @ weight[:, :k].float().t() + bias.float()
    return out.to(weight.dtype)


def _check_cuda_args(x, indices, weight, bias):
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, C, G) float32 or bfloat16 tensor")
    B, C, G = x.shape
    if (indices.dim() != 2 or indices.dtype != torch.int32 or not indices.is_contiguous()
            or indices.device != x.device):
        raise ValueError(f"indices must be a contiguous int32 (L, V) tensor on {x.device}")
    V = indices.shape[1]
    dim, kp = weight.shape
    if weight.dtype != torch.bfloat16 or not weight.is_contiguous() or weight.data_ptr() % 16:
        raise TypeError("the CUDA patch-embed kernel takes a contiguous bfloat16 weight")
    if kp % K_STEP or kp < V * C:
        raise ValueError(f"weight must be (dim, Kp), Kp >= {V * C} a multiple of {K_STEP}, "
                         f"got {tuple(weight.shape)}")
    if dim % 8:
        raise NotImplementedError(f"dim must be a multiple of 8, got {dim}")
    if C != CHANNELS:
        raise NotImplementedError(f"the kernel takes {CHANNELS} channels, got {C}")
    if embed_plan(indices.shape[0], V, kp, dim)["bytes"] == 0:
        raise NotImplementedError(
            f"the kernel's tiles at V {V}, Kp {kp}, dim {dim} leave no room for its A ring in an "
            f"H100 block's {_SMEM_MAX} bytes of shared memory (embed_plan)")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (dim,) or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous float32 ({dim},) tensor")
    for t in (weight, bias):
        if t.device != x.device:
            raise ValueError(f"weight and bias must be on {x.device}")


def patch_embed(x, indices, weight, bias):
    """(B, C, G) -> (B, L, dim) embedded patches in weight.dtype; ``indices``
    the (L, V) int32 table (``table_tensor``), weight and bias from
    ``embed_matrix``. CPU tensors run ``patch_embed_reference``; CUDA
    tensors the kernel."""
    if x.device.type == "cpu":
        return patch_embed_reference(x, indices, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"patch_embed runs on cpu or cuda, not {x.device}")
    _check_cuda_args(x, indices, weight, bias)
    B, C, G = x.shape
    L, V = indices.shape
    dim, kp = weight.shape
    out = torch.empty((B, L, dim), dtype=weight.dtype, device=x.device)
    _native.check(_native.library().svt_patch_embed(
        x.data_ptr(), int(x.dtype == torch.float32), indices.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), out.data_ptr(), B, C, G, L, V, kp, dim, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream))
    patch_embed.launches += 1
    return out


patch_embed.launches = 0


class PatchEmbed(torch.autograd.Function):
    """``patch_embed`` with gradients for its weight and bias: forward (x,
    indices, weight (dim, V*C) of any float dtype (the folded kernel,
    transposed), bias, compute dtype ``dt``) -> (B, L, dim) in ``dt``, the
    weight rounded to ``dt`` and padded inside; backward dW = tokens^T dout
    and db = sum dout, float32 products of the ``dt`` operands, in the
    weight's and bias's dtypes. x gets no gradient."""

    @staticmethod
    def forward(ctx, x, indices, weight, bias, dt):
        ctx.save_for_backward(x, indices)
        ctx.dtypes = weight.dtype, bias.dtype
        return patch_embed(x, indices, _padded(weight, dt), bias.float())

    @staticmethod
    def backward(ctx, g):
        x, indices = ctx.saved_tensors
        w_dt, b_dt = ctx.dtypes
        g2 = g.reshape(-1, g.shape[-1])
        tokens = _tokens(x, indices).to(g.dtype).reshape(g2.shape[0], -1)
        dw = _mm32(g2.t().contiguous(), tokens)
        return None, None, dw.to(w_dt), g2.float().sum(0).to(b_dt), None


def patch_embed_train(x, indices, kernel, bias, *, means=None, stds=None,
                      compute_dtype=torch.bfloat16):
    """Differentiable ``patch_embed`` from the (V*C, dim) kernel and bias
    (e.g. the ``nn.Linear``'s weight transposed and its bias): the
    normalisation folded in float32 under autograd, then ``PatchEmbed``."""
    if means is not None:
        kernel, bias = fold_normalization(kernel, bias, means, stds, indices.shape[1])
    return PatchEmbed.apply(x, indices, kernel.t(), bias, compute_dtype)
