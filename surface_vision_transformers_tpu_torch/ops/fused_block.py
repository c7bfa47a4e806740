"""Transformer-block forward and backward: Hopper kernels and plain versions.

The training half (``fused_block_train``, ``fused_block_cls_train`` and
their backwards ``fused_block_bwd`` / ``fused_block_cls_bwd``, CUDA in
``csrc/fused_block_bwd.cu``) is described at its section below.

``fused_block`` replaces the TPU kernel
``surface_vision_transformers_tpu/ops/pallas/fused_block.py::fused_block``
(``_block_kernel``); ``fused_block_cls`` replaces ``fused_block_cls``
(``_block_cls_kernel``) in the same file. Both kernels are CUDA C++ for
``sm_90a`` in ``csrc/fused_block.cu``: a chain of LayerNorm, GEMM and
attention launches on the caller's stream. Every GEMM of the forward and
backward chains runs on one engine (``csrc/gemm.cuh``): a persistent,
warp-specialised kernel whose producer thread loads A and B tiles by TMA
into an mbarrier ring for two consumer warpgroups on ``wgmma`` (m64n192k16,
bf16 in, fp32 accumulators), with fused bias / erf-GELU / residual
epilogues stored by TMA.

What bounds them on the H100: the TPU kernel keeps a whole block in ~96 MB
of VMEM, while an SM has 227 KB of shared memory, so every intermediate
(LN output, QKV, attention output, x1, the MLP hidden) makes a round trip
through HBM, about ten times the bytes of the block's input and output. At
SiT-tiny widths (192) the GEMMs sit below the card's operations-per-byte
line, so those bytes bound them; at SiT-base widths (768) the operations
do. At dims 96 and 192 (``fuses_mlp``) the forward is four launches: LN1
in the qkv product's prologue and the MLP half as one kernel
(``csrc/fused_mlp.cu``), so h, h2 and f stay out of HBM when serving, with
the same bits. Attention is the streamed kernel of ``csrc/flash_attention.cu`` (K and
V through shared memory in 64- or 128-key tiles, any N), which never writes
the score matrix. The CLS variant computes Q, attention and the MLP for the
first ``rows`` (<= 8) rows of each sample only: on ``cls_fwd_route`` its
attention is one few-query launch (``cls_fwd_route``), which at dims 96 /
192 makes Q itself from LN1 of the top rows (``cls_attention_reference``
is its plain version), LN1 running in the K/V product's prologue
(``cls_ln1_in_kv``); elsewhere the Q product reads the top rows of h
through a strided row map (a 3-D TMA map).

Numerics: the TPU kernel's rounding points (bf16 after LN, QKV, P, P.V, x1
and GELU; fp32 LN statistics, scores, softmax sums and epilogues) with exact
erf-GELU and the shifted softmax (see the kernel source).

Weights are in the torch ``nn.Linear`` layout (out, in) -- the reference
checkpoint layout, and the one the kernels' tensor-core B operands read with
K contiguous -- contiguous, in the compute dtype; LayerNorm parameters and
biases are fp32. Prepare them once (``models.fused.prepare_weights``).

Dispatch: tensors on the CPU run the plain PyTorch version beside each
kernel; CUDA tensors launch the kernel or raise. There is no fallback. The
serving forwards ``fused_block`` and ``fused_block_cls`` are the torch
operators ``svt::fused_block`` / ``svt::fused_block_cls``
(``serving/svt_ops.py``) on both devices, so that ``torch.export`` traces
them; the training half calls its kernels directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from surface_vision_transformers_tpu_torch.ops import _native
from surface_vision_transformers_tpu_torch.serving import svt_ops
from surface_vision_transformers_tpu_torch.ops.flash_attention import (
    bwd_workspace_floats,
    check_dim_head,
    count_few_query,
    few_query_fwd,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
    head_cols,
    wide_bwd,
    wide_fwd,
)
from surface_vision_transformers_tpu_torch.serving.svt_ops import (
    ROW_ALIGN,
    crop_heads,
    crop_to,
    pad_block,
    pad_dims,
    pad_to,
)

_CLS_ROWS = svt_ops.CLS_ROWS


# -- plain versions ------------------------------------------------------------


def _layer_norm(x, scale, bias, eps, saved=None, key=None, n=None):
    """fp32 LayerNorm; with ``saved``, (mean, rstd) per row go to saved[key].
    ``n`` below x's width: a padded layout, the statistics over the first n
    columns and zeros past them, as the kernels count."""
    width = x.shape[-1]
    if n is not None and n < width:
        out = _layer_norm(x[..., :n], scale[:n], bias[:n], eps, saved, key)
        return F.pad(out, (0, width - n))
    h = x.float()
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    if saved is not None:
        saved[key] = torch.cat([mu, rstd], -1)
    return (h - mu) * rstd * scale + bias


def _mm(a, w):
    """a @ w.T with exact products and fp32 sums: what the tensor cores do
    with bf16 operands and fp32 accumulators."""
    return a.float() @ w.float().t()


def _heads(t, heads, dim_head):
    """(B, L, H*dh) -> (B, H, L, dh), a view in t's dtype."""
    return t.reshape(t.shape[0], t.shape[1], heads, dim_head).transpose(1, 2)


def _merge_heads(t, dt):
    """(B, H, L, dh) -> (B, L, H*dh) in ``dt``."""
    B, H, L, dh = t.shape
    return t.to(dt).transpose(1, 2).reshape(B, L, H * dh)


def _attention(q, k, v, heads, dim_head, valid_len, dt, saved=None):
    """(B, nq, H*dh) queries against (B, n, H*dh) keys/values in ``dt``:
    ``flash_attention_reference`` per head. With ``saved``, the row
    log-sum-exp (B, H, nq) goes to saved["lse"]."""
    o, lse = flash_attention_reference(
        *(_heads(t, heads, dim_head) for t in (q, k, v)), valid_len)
    if saved is not None:
        saved["lse"] = lse
    return _merge_heads(o, dt)


def mlp_reference(x1, ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2, *,
                  ln_eps: float = 1e-5, saved: dict | None = None, ln_dim: int | None = None):
    """Plain MLP half of the block (``block_mlp``): x1 (..., dim) -> x1 +
    fc2(GELU(fc1(LN2(x1)))) in x1.dtype, rounded where the kernels round
    (h2, f, the output). ``saved``, when a dict, receives h2, fpre, f and
    stats2, as the training forward keeps them. ``ln_dim``: the width LN2
    counts (default x1's; less in a padded layout, ``svt_ops.pad_dims``)."""
    dt = x1.dtype
    h2 = _layer_norm(x1, ln2_scale, ln2_bias, ln_eps, saved, "stats2", ln_dim).to(dt)
    fpre = _mm(h2, w_fc1) + b_fc1
    f = F.gelu(fpre).to(dt)  # exact erf
    if saved is not None:
        saved.update(h2=h2, fpre=fpre, f=f)
    return (x1.float() + (_mm(f, w_fc2) + b_fc2)).to(dt)


def ln_gemm_reference(x, ln_scale, ln_bias, w, *, ln_eps: float = 1e-5,
                      ln_dim: int | None = None):
    """Plain ``block_ln_gemm`` (the qkv product with LN1 in its
    prologue): -> (LN(x) @ w.T rounded to x.dtype, LN(x) rounded, the
    (mean, rstd) of each row, float32 (..., 2)); ``ln_dim`` as in
    ``fused_block_reference``."""
    sv = {}
    h = _layer_norm(x, ln_scale, ln_bias, ln_eps, sv, "stats", ln_dim).to(x.dtype)
    return _mm(h, w).to(x.dtype), h, sv["stats"]


def _out_proj_mlp(x, attn, w_out, b_out, ln2_scale, ln2_bias,
                  w_fc1, b_fc1, w_fc2, b_fc2, eps, dt, saved=None, ln_dim=None):
    x1 = (x.float() + (_mm(attn, w_out) + b_out)).to(dt)
    if saved is not None:
        saved.update(attn=attn, x1=x1)
    return mlp_reference(x1, ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2,
                         ln_eps=eps, saved=saved, ln_dim=ln_dim)


def fused_block_reference(
    x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5, saved: dict | None = None,
    ln_dim: int | None = None,
):
    """Plain PyTorch ``fused_block``: x (B, N, dim) -> (B, N, dim) in
    x.dtype. In float32 nothing is rounded. ``saved``, when a dict, receives
    what the backward reads (``TRAIN_SAVED``), as the training kernel keeps
    it. ``ln_dim``: the width the LayerNorms count (default dim; less where
    x and the parameters are laid out padded, ``svt_ops.pad_dims``: the
    columns past it zero)."""
    dt, hd = x.dtype, heads * dim_head
    vl = x.shape[1] if valid_len is None else int(valid_len)
    qkv, h, stats1 = ln_gemm_reference(x, ln1_scale, ln1_bias, w_qkv, ln_eps=ln_eps,
                                       ln_dim=ln_dim)
    attn = _attention(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:],
                      heads, dim_head, vl, dt, saved)
    if saved is not None:
        saved.update(h1=h, qkv=qkv, stats1=stats1)
    return _out_proj_mlp(x, attn, w_out, b_out, ln2_scale, ln2_bias,
                         w_fc1, b_fc1, w_fc2, b_fc2, ln_eps, dt, saved, ln_dim)


def fused_block_cls_reference(
    x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5, saved: dict | None = None,
    ln_dim: int | None = None,
):
    """Plain PyTorch ``fused_block_cls``: x (B, N, dim) -> the block's first
    min(8, N) output rows (B, rows, dim); row 0 is the CLS token. ``saved``
    and ``ln_dim`` as in ``fused_block_reference`` (``TRAIN_SAVED_CLS``)."""
    dt, hd = x.dtype, heads * dim_head
    rows = min(_CLS_ROWS, x.shape[1])
    vl = x.shape[1] if valid_len is None else int(valid_len)
    h = _layer_norm(x, ln1_scale, ln1_bias, ln_eps, saved, "stats1", ln_dim).to(dt)
    kv = _mm(h, w_qkv[hd:]).to(dt)
    q = _mm(h[:, :rows], w_qkv[:hd]).to(dt)
    attn = _attention(q, kv[..., :hd], kv[..., hd:], heads, dim_head, vl, dt,
                      saved)
    if saved is not None:
        saved.update(h1=h, kv=kv, q=q)
    return _out_proj_mlp(x[:, :rows], attn, w_out, b_out, ln2_scale, ln2_bias,
                         w_fc1, b_fc1, w_fc2, b_fc2, ln_eps, dt, saved, ln_dim)


def cls_attention_reference(x, ln1_scale, ln1_bias, w_q, k, v, *, heads: int,
                            dim_head: int = 64, valid_len: int | None = None,
                            rows: int | None = None, ln_eps: float = 1e-5,
                            saved: dict | None = None):
    """Plain version of the CLS chain's attention launch, which makes its own
    Q (``csrc/flash_attention.cu``'s few-query forward on
    ``cls_fwd_route``): LN1 of each sample's first ``rows`` (default min(8,
    N)) rows of x (B, N, dim), Q = their product with w_q (H*dh, dim),
    rounded to x.dtype where the chain rounds q, then attention against k
    and v (B, N, H*dh) -> attn (B, rows, H*dh) in x.dtype. ``saved``, when
    a dict, receives q and the row log-sum-exp lse (B, H, rows)."""
    dt = x.dtype
    rows = min(_CLS_ROWS, x.shape[1]) if rows is None else rows
    vl = k.shape[1] if valid_len is None else int(valid_len)
    h = _layer_norm(x[:, :rows], ln1_scale, ln1_bias, ln_eps).to(dt)
    q = _mm(h, w_q).to(dt)
    if saved is not None:
        saved["q"] = q
    return _attention(q, k, v, heads, dim_head, vl, dt, saved)


# -- kernel wrappers -------------------------------------------------------------


def check_vectors(vectors: dict, aligned: bool = True) -> None:
    """Raise unless each float32 vector (name: (tensor, length)) has its
    length, is contiguous and, with ``aligned``, starts on 16 bytes: the
    GEMM engine stages biases as float4 (``csrc/gemm.cuh``). The serving
    operators check the address in their CUDA kernels (``serving.svt_ops``):
    a traced tensor has none."""
    for name, (v, n) in vectors.items():
        if tuple(v.shape) != (n,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({n},), got "
                             f"{v.dtype} {tuple(v.shape)}")
        if not v.is_contiguous() or (aligned and v.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and start on 16 bytes "
                             "(the engine loads it as float4)")


def check_ln_dim(dim: int, ln_dim: int | None, align: int = ROW_ALIGN) -> None:
    """Raise unless ``ln_dim`` (the width the LayerNorms count) is dim, or
    less where dim is a padded layout's width (a multiple of ``align``)."""
    if ln_dim is None or ln_dim == dim:
        return
    if not 1 <= ln_dim < dim or dim % align:
        raise ValueError(f"ln_dim {ln_dim} must be dim {dim}, or less where dim is a padded "
                         f"layout's width (a multiple of {align})")


def _check_cuda_args(x, params, heads, dim_head, valid_len, addresses=True, ln_dim=None):
    """Validate everything the kernels assume; raise on anything else. Both
    blocks take the attention kernels' head dims (``check_dim_head``: every
    dim_head >= 1; the weights in the reference layout, which the CUDA
    entries lay out per head in ``head_cols(dim_head)`` columns,
    ``svt_ops.pad_block``) and every dim and mlp_dim (a width off 8 laid
    out padded by the CUDA entries, ``svt_ops.pad_dims``; ``ln_dim`` below
    x's width: x and the parameters come laid out so, ``check_ln_dim``);
    ``addresses`` False leaves the 16-byte checks to the serving operators'
    CUDA kernels."""
    (ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b,
     w_fc1, b_fc1, w_fc2, b_fc2) = params
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA block kernels take bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, N, dim) tensor")
    B, N, dim = x.shape
    hd = heads * dim_head
    mlp = w_fc1.shape[0]
    check_dim_head(dim_head)
    check_ln_dim(dim, ln_dim)
    if not 1 <= valid_len <= N:
        raise ValueError(f"valid_len {valid_len} outside [1, {N}]")
    shapes = {
        "w_qkv": (w_qkv, (3 * hd, dim)), "w_out": (w_out, (dim, hd)),
        "w_fc1": (w_fc1, (mlp, dim)), "w_fc2": (w_fc2, (dim, mlp)),
    }
    for name, (w, shape) in shapes.items():
        if tuple(w.shape) != shape or w.dtype != torch.bfloat16:
            raise ValueError(
                f"{name} must be bfloat16 {shape} (torch Linear layout), got "
                f"{w.dtype} {tuple(w.shape)}")
    check_vectors({"ln1_scale": (ln1_s, dim), "ln1_bias": (ln1_b, dim),
                   "b_out": (b_out, dim), "ln2_scale": (ln2_s, dim),
                   "ln2_bias": (ln2_b, dim), "b_fc1": (b_fc1, mlp),
                   "b_fc2": (b_fc2, dim)}, aligned=addresses)
    for t in params:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("every parameter must be contiguous and on "
                             f"{x.device}")
    if addresses:
        check_tma_operands(x, w_qkv, w_out, w_fc1, w_fc2)


def check_tma_operands(*tensors, cls_rows: int | None = None):
    """Raise on what the GEMM engine's TMA loads do not take: each operand
    must start on 16 bytes (its rows are multiples of 8 values, as the
    entries lay them out), and the CLS block's row count must divide 64, the rows of
    its row-mapped tiles (min(8, N): every N >= 8, or 1, 2, 4)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the block kernels' operands must start on a 16-byte "
                             "boundary (TMA)")
    if cls_rows is not None and 64 % cls_rows:
        raise NotImplementedError(
            f"the CLS block kernels read {cls_rows} rows a sample through 64-row "
            "tiles: the row count must divide 64 (N >= 8, or N in 1, 2, 4)")


def _dispatch(x):
    """'cpu' -> plain version, 'cuda' -> kernel, anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused blocks run on cpu or cuda, not {x.device}")
    return x.device.type


def fused_block(
    x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5, ln_dim: int | None = None,
):
    """One pre-norm transformer block, x (B, N, dim) -> (B, N, dim); keys
    at positions >= ``valid_len`` are masked. ``ln_dim``: the width the
    LayerNorms count, default dim; less where x and the parameters come laid
    out padded (``svt_ops.pad_dims``, zeros past it). The operator
    ``svt::fused_block`` on either device: its CPU kernel is
    ``fused_block_reference``, its CUDA kernel the chain (bfloat16), its
    launches counted in ``launches`` (``serving.svt_ops``)."""
    params = (ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
              w_fc1, b_fc1, w_fc2, b_fc2)
    vl = x.shape[1] if valid_len is None else int(valid_len)
    n = x.shape[-1] if ln_dim is None else int(ln_dim)
    if _dispatch(x) == "cuda":
        _check_cuda_args(x, params, heads, dim_head, vl, addresses=False, ln_dim=n)
    return torch.ops.svt.fused_block(x, *params, heads, dim_head, vl, ln_eps, n)


fused_block.launches = 0


def fused_block_cls(
    x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5, ln_dim: int | None = None,
):
    """The final block under CLS pooling: x (B, N, dim) -> its first
    min(8, N) output rows; ``ln_dim`` as in ``fused_block``. The operator
    ``svt::fused_block_cls``: its CPU kernel is ``fused_block_cls_reference``,
    its CUDA kernel the chain (bfloat16)."""
    params = (ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
              w_fc1, b_fc1, w_fc2, b_fc2)
    vl = x.shape[1] if valid_len is None else int(valid_len)
    n = x.shape[-1] if ln_dim is None else int(ln_dim)
    if _dispatch(x) == "cuda":
        _check_cuda_args(x, params, heads, dim_head, vl, addresses=False, ln_dim=n)
        check_tma_operands(cls_rows=min(_CLS_ROWS, x.shape[1]))
    return torch.ops.svt.fused_block_cls(x, *params, heads, dim_head, vl, ln_eps, n)


fused_block_cls.launches = 0


# -- training: forward with saves, backward --------------------------------------
#
# ``fused_block_train`` / ``fused_block_cls_train`` replace the JAX package's
# ``fused_block_train`` / ``fused_block_cls_train`` (custom VJPs over the TPU
# backward kernels ``_block_bwd`` / ``_block_bwd_split`` and
# ``_block_cls_bwd`` / ``_block_cls_bwd_split``). The forward is the serving
# kernel chain keeping its intermediates (``TRAIN_SAVED``); the backward is
# ``csrc/fused_block_bwd.cu``, the gradient of this port's forward (erf-GELU,
# shifted softmax; see the kernel source). Weight gradients come out in
# float32, in the torch (out, in) layout.
#
# The route of a non-CLS block is a fixed function of its shape
# (``uses_recompute``), chosen where the JAX package chooses: where a Pallas
# backward fits the TPU's VMEM (every width up to SiT-base at N <= 768 --
# SiT-tiny, SiT-small) the chain above runs; beyond (SiT-base on sub-ico 3,
# N = 1,281), where the JAX package falls back to ``jax.vjp`` of
# ``_xla_block_ref(attn="flash")``, the forward is the serving ``fused_block``
# keeping only x and the backward recomputes the block under autograd
# (``fused_block_recompute_bwd``): torch GEMMs and LayerNorms around the
# ``flash_attention`` kernel. The CLS block takes the chain at any N, as the
# JAX package takes ``_block_cls_bwd_split`` there, up to ``_MAX_BWD_DIM``
# width; past it (``cls_uses_recompute``) the recompute route of
# ``fused_block_cls``, as the JAX package sends it to its XLA mirror.

# What the training forward keeps, by name (shapes for x (B, N, dim)):
# h1 (B, N, dim), qkv (B, N, 3hd), attn (B, N, hd), lse (B, H, N) fp32,
# x1, h2 (B, N, dim), fpre (B, N, mlp) fp32, f (B, N, mlp), stats1, stats2
# (B, N, 2) fp32 (LayerNorm mean, rstd). The CLS block keeps kv (B, N, 2hd)
# and q (B, rows, hd) in place of qkv, and x1, h2, fpre, f, attn, stats2 and
# lse on its B*rows top rows only.
TRAIN_SAVED = ("h1", "qkv", "attn", "lse", "x1", "h2", "fpre", "f", "stats1",
               "stats2")
TRAIN_SAVED_CLS = ("h1", "kv", "q", "attn", "lse", "x1", "h2", "fpre", "f",
                   "stats1", "stats2")
_MAX_BWD_DIM = 768  # the LayerNorm backward holds a row in 24 values a lane
CHAIN_MAX_SEQ_LEN = 768
LN_EPILOGUE_MAX_DIM = 192  # the GEMM engine's tile width: a tile holds whole rows
_GEMM_BM, _GEMM_BN, _GEMM_BK, _TARGET_TILES = 128, 192, 64, 132  # csrc/gemm.cuh
# the standalone LayerNorm backward: two rows a group of warps (two warps past dim 384)
_LNB_WARPS, _LNB_CTAS = 8, 132


def ln_in_epilogue(dim: int) -> bool:
    """Whether the backward chain folds its LayerNorm backwards into the
    epilogue of the product that makes dh (``csrc/gemm.cuh``: B_LN2,
    B_LN1), so that dh never reaches device memory: widths up to the
    engine's 192-column tile, whatever the head dim (MS-SiT's stages 0-1,
    SiT-tiny). The CLS block's LN1, whose dh is dkv W_kv over every row
    plus dq W_q on the top rows, adds that small fp32 share, made first, in
    the same epilogue (B_LN1_TOP) where ``cls_ln1_in_epilogue`` says. Wider
    blocks run the standalone LayerNorm backward."""
    return dim <= LN_EPILOGUE_MAX_DIM


def cls_ln1_in_epilogue(N: int, rows: int, dim: int) -> bool:
    """Whether the CLS block's LN1 backward runs in dkv W_kv's epilogue
    (``csrc/gemm.cuh`` B_LN1_TOP; ``cls_ln1_epilogue`` in
    ``csrc/fused_block_bwd.cu``): at ``ln_in_epilogue`` widths where, of an
    epilogue thread's two rows 8 apart, at most one is a top row: rows <= 8
    and N >= rows + 8 (N >= 16 for the 8 top rows). Else dkv W_kv's fp32
    product takes the top rows' dq W_q share and the standalone LayerNorm
    backward reads it."""
    return ln_in_epilogue(dim) and rows <= _CLS_ROWS and N >= rows + 8


FUSED_MLP_DIMS = (96, 192)  # csrc/fused_mlp.cu: fc2's output is one wgmma of n = dim


def fuses_mlp(dim: int, mlp: int, train: bool = False, ln_dim: int | None = None) -> bool:
    """Whether a forward chain (``train``: the training forward) runs LN1 in
    the qkv product's prologue and LN2 -> fc1 -> GELU -> fc2 (+ residual) as
    one kernel (``csrc/fused_mlp.cu``; ``svt_block_fused_mlp``): four
    launches, h, h2 and f kept out of device memory when serving. Serving at
    dims 96 and 192 (MS-SiT's stages 0-1, SiT-tiny), the hidden width a
    multiple of 128 up to 4 dim; the training forward, which writes h1, h2,
    f and fpre all the same, at dim 96 only (at dim 192 the seven launches
    measured faster, PERF.md). Elsewhere, and in the CLS block, the seven
    launches; also in a padded layout (``ln_dim`` below dim: 94 and 188 laid
    out in 96 and 192 columns), since the fused kernels' LayerNorms count
    every column."""
    return ((ln_dim is None or ln_dim == dim) and (dim == 96 or (dim == 192 and not train))
            and mlp % 128 == 0 and 128 <= mlp <= 4 * dim)


def cls_fwd_route(N: int, rows: int, dim_head: int = 64) -> bool:
    """Whether the CLS block's forward runs its attention as the few-query
    kernel (``csrc/flash_attention.cu``; ``cls_fwd_route`` in
    ``csrc/fused_block.cu``): where ``few_query_fwd(rows, N, dim_head)``
    holds, at every head dim the kernels take. Else the streamed
    forward."""
    return few_query_fwd(rows, N, dim_head)


def cls_ln1_in_kv(N: int, rows: int, dim: int, dim_head: int = 64,
                  ln_dim: int | None = None) -> bool:
    """Whether the CLS forward runs LN1 in the K/V product's prologue
    (``csrc/gemm.cuh`` F_LNA: K = dim 96 or 192) and makes Q inside the
    few-query attention's CTAs (LN1 of each sample's top rows and their
    product with the head's W_q), so that neither h (serving) nor q is
    written: on ``cls_fwd_route`` at those dims, up to dh 64 (the CTA makes
    Q^T in one m64 product: C ``few_query_makes_q``). Wider, or wider heads,
    the LayerNorm pass writes h and the Q product reads it (Q made in the
    CTAs took longer there: PERF.md), as in a padded layout (``ln_dim``
    below dim, as ``fuses_mlp``)."""
    return ((ln_dim is None or ln_dim == dim) and cls_fwd_route(N, rows, dim_head)
            and dim in FUSED_MLP_DIMS and dim_head <= 64)


def cls_fwd_launches(N: int, dim: int, dim_head: int = 64, ln_dim: int | None = None) -> int:
    """Device kernels one CLS forward runs, serving or training: where
    ``cls_ln1_in_kv``, six ([LN1 + K/V], the few-query attention with its
    Q, the out-projection, LN2, fc1, fc2: the fused MLP kernel took 1.8x as
    long as these three on the CLS block's 2,048 top rows, PERF.md); else
    eight (LN1, K/V, Q, the attention, out-projection, LN2, fc1, fc2)."""
    return 6 if cls_ln1_in_kv(N, min(_CLS_ROWS, N), dim, dim_head, ln_dim) else 8


def block_bwd_dh_floats(B: int, N: int, dim: int, cls_rows: int = 0) -> int:
    """Floats of fp32 dh scratch the backward chains write
    (``svt_block_bwd_dh_floats``; ``cls_rows``: the CLS block's top rows, 0
    for the full block): B * N * dim where a standalone LayerNorm backward
    reads dh (widths past ``ln_in_epilogue``; the CLS block where
    ``cls_ln1_in_epilogue`` is false), else none."""
    fused = cls_ln1_in_epilogue(N, cls_rows, dim) if cls_rows else ln_in_epilogue(dim)
    return 0 if fused else B * N * dim


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_k(m: int, n: int, k: int) -> int:
    """``gemm::split_k``: the splits of a weight gradient's K."""
    tiles = _cdiv(m, _GEMM_BM) * _cdiv(n, _GEMM_BN)
    most, s = max(1, _cdiv(k, _GEMM_BK) // 8), 1
    while s < most and tiles * s < 0.95 * _TARGET_TILES * _cdiv(tiles * s, _TARGET_TILES):
        s += 1
    chunk = _cdiv(_cdiv(k, s), _GEMM_BK) * _GEMM_BK
    return _cdiv(k, chunk)


def block_bwd_workspace(B: int, N: int, rows: int, dim: int, heads: int, dim_head: int,
                        mlp: int) -> int:
    """Floats of fp32 workspace the backward chains ask for
    (``svt_block_bwd_workspace``): the largest set of split-K or column
    partials one of their steps holds, the CLS block's fp32 dq W_q share
    where rows <= 8 (a full block of so few rows is counted too; with its
    LN1 epilogue's column partials, ``cls_ln1_in_epilogue``), or the
    attention backward's (``bwd_workspace_floats``: none where the resident
    or the few-query kernel runs)."""
    M, Mt, hd = B * N, B * rows, heads * head_cols(dim_head)
    dw = [(dim, mlp, Mt), (mlp, dim, Mt), (dim, hd, Mt), (dim, mlp, M), (mlp, dim, M),
          (dim, hd, M), (3 * hd, dim, M), (hd, dim, Mt), (2 * hd, dim, M)]
    need = max(_split_k(*s) * s[0] * s[1] for s in dw)
    ln_ctas = min(_cdiv(_cdiv(M, 2), _LNB_WARPS), _LNB_CTAS)
    need = max(need, _cdiv(M, _GEMM_BM) * mlp, ln_ctas * 4 * dim)
    if rows <= _CLS_ROWS:
        lnc = min(_cdiv(M, _GEMM_BM), _TARGET_TILES) if cls_ln1_in_epilogue(N, rows, dim) else 0
        need = max(need, Mt * dim + lnc * 2 * dim)
    return max(need, bwd_workspace_floats(B, heads, rows, N, dim_head))


def uses_recompute(n_tokens: int, dim: int) -> bool:
    """Whether a non-CLS block of this shape trains on the recompute route
    (else the chain): beyond ``CHAIN_MAX_SEQ_LEN`` tokens or
    ``_MAX_BWD_DIM`` width."""
    return n_tokens > CHAIN_MAX_SEQ_LEN or dim > _MAX_BWD_DIM


def cls_uses_recompute(dim: int) -> bool:
    """Whether the CLS block trains on the recompute route (else the
    chain): past ``_MAX_BWD_DIM`` width, where the JAX package sends it to
    its XLA mirror too (``_split_cls_bwd_feasible``); at any N the chain,
    as the JAX package takes ``_block_cls_bwd_split``."""
    return dim > _MAX_BWD_DIM


def _gelu_grad(f):
    """d/df of exact-erf GELU at the fp32 pre-activation."""
    return (0.5 * (1.0 + torch.erf(f * 0.7071067811865476))
            + f * 0.3989422804014327 * torch.exp(-0.5 * f * f))


def _tmm(a, b):
    """a^T b over all leading (row) dims, fp32: the weight-gradient
    products (exact products of the operands, fp32 sums)."""
    return a.reshape(-1, a.shape[-1]).float().t() @ b.reshape(-1, b.shape[-1]).float()


def _colsum(t):
    return t.reshape(-1, t.shape[-1]).float().sum(0)


def _ln_bwd(dh, x, stats, scale, ln_dim=None):
    """LayerNorm backward from the kept (mean, rstd): (dx, dscale, dbias).
    ``ln_dim`` below x's width: the padded layout of ``_layer_norm``, zeros
    past it."""
    width = x.shape[-1]
    if ln_dim is not None and ln_dim < width:
        return tuple(F.pad(t, (0, width - ln_dim)) for t in
                     _ln_bwd(dh[..., :ln_dim], x[..., :ln_dim], stats, scale[:ln_dim]))
    n = (x.float() - stats[..., :1]) * stats[..., 1:]
    d = dh * scale
    dx = (d - d.mean(-1, keepdim=True) - n * (d * n).mean(-1, keepdim=True)) \
        * stats[..., 1:]
    return dx, _colsum(dh * n), _colsum(dh)


def _attention_bwd(q, k, v, o, do, lse, heads, dim_head, valid_len, dt):
    """Backward of ``_attention`` from its LSE
    (``flash_attention_bwd_reference`` per head). -> dq, dk, dv."""
    grads = flash_attention_bwd_reference(
        *(_heads(t, heads, dim_head) for t in (q, k, v, o)), lse,
        _heads(do, heads, dim_head), valid_len)
    return tuple(_merge_heads(t, dt) for t in grads)


def _mlp_branch_bwd(g, sv, ln2_s, w_fc1, w_fc2, dt, ln_dim=None):
    """g = dL/dout -> dx1 (fp32) and the MLP / LN2 / out-bias gradients."""
    gf = g.float()
    df1 = (gf @ w_fc2.float()) * _gelu_grad(sv["fpre"])
    df1b = df1.to(dt)
    dx1_ln, d_ln2_s, d_ln2_b = _ln_bwd(df1b.float() @ w_fc1.float(), sv["x1"],
                                       sv["stats2"], ln2_s, ln_dim)
    dx1 = gf + dx1_ln
    grads = dict(d_ln2_s=d_ln2_s, d_ln2_b=d_ln2_b, d_wfc1=_tmm(df1b, sv["h2"]),
                 d_bfc1=_colsum(df1), d_wfc2=_tmm(g, sv["f"]), d_bfc2=_colsum(gf),
                 d_bout=_colsum(dx1))
    return dx1, grads


def _grads_tuple(dx, d_ln1_s, d_ln1_b, d_wqkv, d_wout, gr):
    return (dx, d_ln1_s, d_ln1_b, d_wqkv, d_wout, gr["d_bout"], gr["d_ln2_s"],
            gr["d_ln2_b"], gr["d_wfc1"], gr["d_bfc1"], gr["d_wfc2"], gr["d_bfc2"])


def _block_bwd_plain(x, g, params, sv, heads, dim_head, valid_len, ln_dim=None):
    dt, hd = x.dtype, heads * dim_head
    ln1_s, w_qkv, w_out, ln2_s, w_fc1, w_fc2 = (params[i] for i in (0, 2, 3, 5, 7, 9))
    dx1, gr = _mlp_branch_bwd(g, sv, ln2_s, w_fc1, w_fc2, dt, ln_dim)
    dx1b = dx1.to(dt)
    da = (dx1b.float() @ w_out.float()).to(dt)
    qkv = sv["qkv"]
    dqkv = torch.cat(_attention_bwd(
        qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], sv["attn"], da,
        sv["lse"], heads, dim_head, valid_len, dt), -1)
    dx_ln, d_ln1_s, d_ln1_b = _ln_bwd(dqkv.float() @ w_qkv.float(), x,
                                      sv["stats1"], ln1_s, ln_dim)
    return _grads_tuple((dx1 + dx_ln).to(dt), d_ln1_s, d_ln1_b,
                        _tmm(dqkv, sv["h1"]), _tmm(dx1b, sv["attn"]), gr)


def _block_cls_bwd_plain(x, g, params, sv, heads, dim_head, valid_len, ln_dim=None):
    dt, hd, rows = x.dtype, heads * dim_head, g.shape[1]
    ln1_s, w_qkv, w_out, ln2_s, w_fc1, w_fc2 = (params[i] for i in (0, 2, 3, 5, 7, 9))
    dx1, gr = _mlp_branch_bwd(g, sv, ln2_s, w_fc1, w_fc2, dt, ln_dim)
    dx1b = dx1.to(dt)
    da = (dx1b.float() @ w_out.float()).to(dt)
    kv, h1 = sv["kv"], sv["h1"]
    dq, dk, dv = _attention_bwd(sv["q"], kv[..., :hd], kv[..., hd:], sv["attn"], da,
                                sv["lse"], heads, dim_head, valid_len, dt)
    dkv = torch.cat([dk, dv], -1)
    dh1 = dkv.float() @ w_qkv[hd:].float()
    dh1[:, :rows] += dq.float() @ w_qkv[:hd].float()
    dx_ln, d_ln1_s, d_ln1_b = _ln_bwd(dh1, x, sv["stats1"], ln1_s, ln_dim)
    dx_ln[:, :rows] += dx1
    d_wqkv = torch.cat([_tmm(dq, h1[:, :rows]), _tmm(dkv, h1)], 0)
    return _grads_tuple(dx_ln.to(dt), d_ln1_s, d_ln1_b, d_wqkv,
                        _tmm(dx1b, sv["attn"]), gr)


def fused_block_bwd_reference(
    x, g, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5, ln_dim: int | None = None,
):
    """Plain PyTorch backward of ``fused_block`` at the kernel's rounding
    points: the plain forward (keeping ``TRAIN_SAVED``), then explicit
    gradients. -> (dx, and the 11 parameter gradients in parameter order,
    float32, matrices in the torch (out, in) layout). ``ln_dim`` as in
    ``fused_block_reference``."""
    params = (ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
              w_fc1, b_fc1, w_fc2, b_fc2)
    vl = x.shape[1] if valid_len is None else int(valid_len)
    sv = {}
    fused_block_reference(x, *params, heads=heads, dim_head=dim_head,
                          valid_len=vl, ln_eps=ln_eps, saved=sv, ln_dim=ln_dim)
    return _block_bwd_plain(x, g, params, sv, heads, dim_head, vl, ln_dim)


def fused_block_cls_bwd_reference(
    x, g, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5, ln_dim: int | None = None,
):
    """Plain PyTorch backward of ``fused_block_cls``: g (B, rows, dim) on the
    top rows -> dx (B, N, dim) and the 11 parameter gradients."""
    params = (ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
              w_fc1, b_fc1, w_fc2, b_fc2)
    vl = x.shape[1] if valid_len is None else int(valid_len)
    sv = {}
    fused_block_cls_reference(x, *params, heads=heads, dim_head=dim_head,
                              valid_len=vl, ln_eps=ln_eps, saved=sv, ln_dim=ln_dim)
    return _block_cls_bwd_plain(x, g, params, sv, heads, dim_head, vl, ln_dim)


def _lay_out(x, params, heads, dim_head, vl, n):
    """Check the training entries' arguments and lay them out as the chains
    take them: -> (x, params, width) with x's width and the hidden width
    rounded up to 8 (``svt_ops.pad_dims``, copies only where they are off
    it) and the heads in ``head_cols(dim_head)`` columns; ``width`` x's own
    width."""
    _check_cuda_args(x, params, heads, dim_head, vl, addresses=False, ln_dim=n)
    x, params, width = svt_ops.laid_out(x, params, 7, ROW_ALIGN, pad_dims)
    _check_cuda_args(x, params, heads, dim_head, vl, ln_dim=n)
    return x, pad_block(params, heads, dim_head), width


def train_forward(x, *params, heads: int, dim_head: int,
                  valid_len: int | None = None, ln_eps: float = 1e-5,
                  cls: bool = False, ln_dim: int | None = None):
    """The block forward (``fused_block``, or ``fused_block_cls`` with
    ``cls``) keeping what its backward reads: -> (out, saved dict of
    ``TRAIN_SAVED`` / ``TRAIN_SAVED_CLS``); ``ln_dim`` as in
    ``fused_block``. CPU tensors run the plain version; CUDA tensors the
    forward kernel chain with saves, counted as a launch of ``fused_block``
    / ``fused_block_cls``. Given x at a width off 8 the chain runs on a
    padded copy (``svt_ops.pad_dims``): out is cropped, the saves stay laid
    out, as ``fused_block_bwd`` takes them."""
    vl = x.shape[1] if valid_len is None else int(valid_len)
    n = x.shape[-1] if ln_dim is None else int(ln_dim)
    if _dispatch(x) == "cpu":
        sv = {}
        ref = fused_block_cls_reference if cls else fused_block_reference
        out = ref(x, *params, heads=heads, dim_head=dim_head, valid_len=vl,
                  ln_eps=ln_eps, saved=sv, ln_dim=n)
        return out, sv
    x, params, width = _lay_out(x, params, heads, dim_head, vl, n)
    B, N, dim = x.shape
    hd, mlp, H = heads * head_cols(dim_head), params[7].shape[0], heads
    rows = min(_CLS_ROWS, N) if cls else N
    if cls:
        check_tma_operands(cls_rows=rows)
    lib = _native.library()
    bf, f32 = torch.bfloat16, torch.float32
    shapes = {
        "h1": ((B, N, dim), bf), "qkv": ((B, N, 3 * hd), bf),
        "kv": ((B, N, 2 * hd), bf), "q": ((B, rows, hd), bf),
        "attn": ((B, rows, hd), bf), "lse": ((B, H, rows), f32),
        "x1": ((B, rows, dim), bf), "h2": ((B, rows, dim), bf),
        "fpre": ((B, rows, mlp), f32), "f": ((B, rows, mlp), bf),
        "stats1": ((B, N, 2), f32), "stats2": ((B, rows, 2), f32),
    }
    names = TRAIN_SAVED_CLS if cls else TRAIN_SAVED
    sv = {k: torch.empty(shapes[k][0], dtype=shapes[k][1], device=x.device)
          for k in names}
    out = x.new_empty((B, rows, dim))
    ptrs = [t.data_ptr() for t in (x, *params, out, *(sv[k] for k in names))]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if cls:
        _native.check(lib.svt_fused_block_cls_train_fwd(
            *ptrs, B, N, rows, dim, n, heads, dim_head, mlp, vl, ln_eps,
            x.device.index, stream))
        fused_block_cls.launches += 1
        _count_cls(N, rows, dim, dim_head, n)
        wide_fwd.launches += wide_fwd(dim_head)
    else:
        _native.check(lib.svt_fused_block_train_fwd(
            *ptrs, B, N, dim, n, heads, dim_head, mlp, vl, ln_eps,
            x.device.index, stream))
        fused_block.launches += 1
        _count_fused(fuses_mlp(dim, mlp, train=True, ln_dim=n))
        wide_fwd.launches += wide_fwd(dim_head)
    return crop_to(out, (B, rows, width)).contiguous(), sv


def _check_cuda_bwd_args(x, g, sv, cls):
    """The backward's own checks, on the laid-out x, g and saves."""
    B, N, dim = x.shape
    rows = min(_CLS_ROWS, N) if cls else N
    if dim > _MAX_BWD_DIM:
        raise NotImplementedError(
            f"the backward kernels take dim <= {_MAX_BWD_DIM}, got {dim}")
    if (g.dtype != torch.bfloat16 or tuple(g.shape) != (B, rows, dim)
            or not g.is_contiguous() or g.device != x.device):
        raise ValueError(f"g must be a contiguous bfloat16 {(B, rows, dim)} "
                         f"tensor on {x.device}")
    names = TRAIN_SAVED_CLS if cls else TRAIN_SAVED
    if set(sv) != set(names) or any(
            not sv[k].is_contiguous() or sv[k].device != x.device for k in names):
        raise ValueError(f"saved must hold contiguous {names} on {x.device}")
    check_tma_operands(g, *sv.values(), cls_rows=rows if cls else None)


def _block_bwd(x, g, params, sv, heads, dim_head, valid_len, cls, ln_dim=None):
    vl = x.shape[1] if valid_len is None else int(valid_len)
    n = x.shape[-1] if ln_dim is None else int(ln_dim)
    if _dispatch(x) == "cpu":
        plain = _block_cls_bwd_plain if cls else _block_bwd_plain
        return plain(x, g, params, sv, heads, dim_head, vl, n)
    shapes = [p.shape for p in params]
    x, params, width = _lay_out(x, params, heads, dim_head, vl, n)
    lib = _native.library()
    B, N, dim = x.shape
    hd, mlp = heads * head_cols(dim_head), params[7].shape[0]
    rows = min(_CLS_ROWS, N) if cls else N
    if tuple(g.shape) == (B, rows, width) and g.dtype == torch.bfloat16:
        g = pad_to(g, (B, rows, dim)).contiguous()
    _check_cuda_bwd_args(x, g, sv, cls)
    M, Mr = B * N, B * rows
    dev = x.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx = torch.empty_like(x)
    grads = [f32(*p.shape) for p in params]
    ln1_s, _, w_qkv, w_out, _, ln2_s, _, w_fc1, _, w_fc2, _ = params
    # dh (fp32, M x dim) only where a standalone LayerNorm backward reads it:
    # the library says where, as it sizes the workspace
    dh = f32(max(lib.svt_block_bwd_dh_floats(B, N, dim, rows if cls else 0), 1))
    scratch = [x.new_empty((Mr, mlp)), dh, f32(Mr, dim),
               x.new_empty((Mr, dim)), x.new_empty((Mr, hd))]
    if cls:
        scratch += [x.new_empty((Mr, hd)), x.new_empty((M, 2 * hd))]
    else:
        scratch += [x.new_empty((M, 3 * hd))]
    scratch += [f32(B, heads, rows),
                f32(lib.svt_block_bwd_workspace(B, N, rows, dim, heads,
                                                dim_head, mlp))]
    names = TRAIN_SAVED_CLS if cls else TRAIN_SAVED
    ptrs = [t.data_ptr() for t in (
        x, g, ln1_s, w_qkv, w_out, ln2_s, w_fc1, w_fc2,
        *(sv[k] for k in names), dx, *grads, *scratch)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if cls:
        _native.check(lib.svt_fused_block_cls_bwd(
            *ptrs, B, N, rows, dim, n, heads, dim_head, mlp, vl, dev.index, stream))
        fused_block_cls_bwd.launches += 1
        count_few_query(rows, N, dim_head)  # its attention backward
    else:
        _native.check(lib.svt_fused_block_bwd(
            *ptrs, B, N, dim, n, heads, dim_head, mlp, vl, dev.index, stream))
        fused_block_bwd.launches += 1
    wide_bwd.launches += wide_bwd(dim_head)
    # d_wqkv's rows and d_wout's columns back in the reference layout, then
    # every gradient in its parameter's shape (the padded rows and columns
    # of a width off 8 cropped)
    grads[2] = crop_heads(grads[2], 3 * heads, dim_head, 0)
    grads[3] = crop_heads(grads[3], heads, dim_head, 1)
    grads = [crop_to(t, shape) for t, shape in zip(grads, shapes)]
    return (crop_to(dx, (B, N, width)).contiguous(), *grads)


def fused_block_bwd(x, g, *params, saved, heads: int, dim_head: int,
                    valid_len: int | None = None, ln_dim: int | None = None):
    """Backward of the training ``fused_block``: x and g = dL/dout (B, N,
    dim), the 11 block parameters, ``saved`` from the training forward,
    ``ln_dim`` as there. -> (dx, 11 float32 parameter gradients, in the
    shapes of x and the parameters). CPU tensors run the plain backward;
    CUDA tensors launch the kernel chain (bfloat16)."""
    return _block_bwd(x, g, params, saved, heads, dim_head, valid_len, False, ln_dim)


fused_block_bwd.launches = 0


def fused_block_cls_bwd(x, g, *params, saved, heads: int, dim_head: int,
                        valid_len: int | None = None, ln_dim: int | None = None):
    """Backward of the training ``fused_block_cls``: g (B, rows, dim) ->
    (dx (B, N, dim), 11 float32 parameter gradients). Dispatch as
    ``fused_block_bwd``."""
    return _block_bwd(x, g, params, saved, heads, dim_head, valid_len, True, ln_dim)


fused_block_cls_bwd.launches = 0


# -- the chains' products alone ---------------------------------------------------
#
# Every GEMM of the chains above runs on one engine (``csrc/gemm.cuh``). These
# entries run one product with its epilogue by itself, so that each can be
# held against its plain version and timed at the chain's shapes; the chains
# do not call them. CPU tensors run the plain versions (exact products of the
# operands, float32 sums); CUDA tensors launch the engine or raise.


def _check_gemm_operands(*tensors):
    for t in tensors:
        if (t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous()
                or t.shape[1] % 8):
            raise ValueError("GEMM operands must be contiguous bfloat16 matrices whose "
                             "rows are multiples of 8 values")
    check_tma_operands(*tensors)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def gemm_reference(a, w, bias=None, residual=None, *, gelu=False):
    """Plain ``block_gemm``: (a @ w.T [+ bias, erf-GELU | + bias + residual]
    in float32, the bf16 output; with ``gelu`` also the float32
    pre-activation)."""
    c = _mm(a, w)
    if gelu:
        pre = c + bias
        return F.gelu(pre).to(a.dtype), pre
    if residual is not None:
        c = c + bias + residual.float()
    return c.to(a.dtype)


def block_gemm(a, w, bias=None, residual=None, *, gelu=False):
    """The forward chain's product: a (M, K) @ w.T, w (N, K) in the torch
    Linear layout, bf16 out: plain (qkv), + bias then erf-GELU (fc1, in its
    training form: also the float32 pre-activation), or + bias + residual
    (M, N) (out-projection, fc2). -> C, or (C, pre) with ``gelu``. CPU
    tensors run ``gemm_reference``."""
    if a.device.type == "cpu":
        return gemm_reference(a, w, bias, residual, gelu=gelu)
    _check_gemm_operands(a, w, *([residual] if residual is not None else []))
    (M, K), N = a.shape, w.shape[0]
    if w.shape[1] != K or (residual is not None and tuple(residual.shape) != (M, N)):
        raise ValueError("a (M, K), w (N, K) and the residual (M, N) must agree")
    if bias is not None:
        if bias.device != a.device:
            raise ValueError(f"bias must be on {a.device}")
        check_vectors({"bias": (bias, N)})
    elif gelu or residual is not None:
        raise ValueError("the GELU and residual epilogues add a bias")
    c = a.new_empty((M, N))
    pre = torch.empty((M, N), dtype=torch.float32, device=a.device) if gelu else None
    epi = 1 if gelu else 2 if residual is not None else 0
    ptrs = [t.data_ptr() if t is not None else None
            for t in (a, w, bias, residual, c, pre)]
    _native.check(_native.library().svt_block_gemm(
        epi, *ptrs, M, N, K, a.device.index, _stream(a)))
    return (c, pre) if gelu else c


def gemm_nn_reference(a, w, pre=None, *, out_dtype=torch.bfloat16):
    """Plain ``block_gemm_nn``: a @ w in float32, rounded to ``out_dtype``;
    with ``pre``, times GELU'(pre), with the float32 column sums."""
    c = a.float() @ w.float()
    if pre is None:
        return c.to(out_dtype)
    c = c * _gelu_grad(pre)
    return c.to(a.dtype), c.sum(0)


def block_gemm_nn(a, w, pre=None, *, out_dtype=torch.bfloat16):
    """The backward chain's dX product: a (M, K) @ w, w the torch (out = K,
    in = N) weight read as it lies: float32 C (dh) or bf16 C (da), or with
    ``pre`` (float32 (M, N)) bf16 C * GELU'(pre) and its float32 column sums
    (df1 and d_bfc1: the kernel's sums of each 128-row tile, added here by
    torch). CPU tensors run ``gemm_nn_reference``."""
    if a.device.type == "cpu":
        return gemm_nn_reference(a, w, pre, out_dtype=out_dtype)
    _check_gemm_operands(a, w)
    (M, K), N = a.shape, w.shape[1]
    if w.shape[0] != K:
        raise ValueError("a (M, K) and w (K, N) must agree")
    f32 = dict(dtype=torch.float32, device=a.device)
    if pre is not None:
        if pre.dtype != torch.float32 or tuple(pre.shape) != (M, N) or not pre.is_contiguous():
            raise ValueError("pre must be a contiguous float32 (M, N) tensor")
        c, part = a.new_empty((M, N)), torch.empty((-(-M // 128), N), **f32)
        _native.check(_native.library().svt_block_gemm_nn(
            2, a.data_ptr(), w.data_ptr(), None, c.data_ptr(), pre.data_ptr(),
            part.data_ptr(), M, N, K, a.device.index, _stream(a)))
        return c, part.sum(0)
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    fp32 = out_dtype == torch.float32
    _native.check(_native.library().svt_block_gemm_nn(
        0 if fp32 else 1, a.data_ptr(), w.data_ptr(), c.data_ptr() if fp32 else None,
        None if fp32 else c.data_ptr(), None, None, M, N, K, a.device.index, _stream(a)))
    return c


def gemm_ln_reference(a, w, x, stats, gamma, res):
    """Plain ``block_gemm_ln``: dh = a @ w in float32, then the LayerNorm
    backward of x's rows from their (mean, rstd) plus the residual
    cotangent res -> (out float32, out rounded to bfloat16, column sums
    (2 or 4, dim) float32: sum dh n, sum dh, and where res is bfloat16
    (LN2's form, res = g) sum res and sum out)."""
    out, d_scale, d_bias = _ln_bwd(a.float() @ w.float(), x, stats, gamma)
    out = out + res.float()
    sums = [d_scale, d_bias]
    if res.dtype == torch.bfloat16:
        sums += [_colsum(res), _colsum(out)]
    return out, out.to(torch.bfloat16), torch.stack(sums)


def block_gemm_ln(a, w, x, stats, gamma, res):
    """The backward chain's product with the LayerNorm backward in its
    epilogue (``ln_in_epilogue`` widths): a (M, K) @ w (w the torch (out =
    K, in = dim) weight) is dh, never written; the LayerNorm backward of x
    (M, dim) bf16 from stats (M, 2) float32 and gamma (dim,) float32, plus
    res (M, dim): bf16 (LN2: -> out float32 and bfloat16, 4 column sums)
    or float32 (LN1: -> bfloat16 out, 2 sums; the kernel writes no float32
    out, None in its place).
    The column sums are the kernel's per-CTA partials added in order on the
    card. CPU tensors run ``gemm_ln_reference``."""
    if a.device.type == "cpu":
        return gemm_ln_reference(a, w, x, stats, gamma, res)
    _check_gemm_operands(a, w, x)
    (M, K), dim = a.shape, w.shape[1]
    lnk = 2 if res.dtype == torch.bfloat16 else 1
    if (w.shape[0] != K or tuple(x.shape) != (M, dim) or tuple(res.shape) != (M, dim)
            or not res.is_contiguous() or res.dtype not in (torch.bfloat16, torch.float32)
            or tuple(stats.shape) != (M, 2) or stats.dtype != torch.float32
            or not stats.is_contiguous()):
        raise ValueError("a (M, K), w (K, dim), x and res (M, dim), stats (M, 2) must agree")
    if not ln_in_epilogue(dim):
        raise ValueError(f"the LayerNorm epilogue takes dim <= {LN_EPILOGUE_MAX_DIM}, got {dim}")
    check_vectors({"gamma": (gamma, dim)})
    check_tma_operands(res)
    f32 = dict(dtype=torch.float32, device=a.device)
    lib = _native.library()
    out_f = torch.empty((M, dim), **f32) if lnk == 2 else None
    out_b = a.new_empty((M, dim))
    sums = torch.empty((2 * lnk, dim), **f32)
    part = torch.empty((lib.svt_block_gemm_ln_workspace(M, dim),), **f32)
    _native.check(lib.svt_block_gemm_ln(
        lnk, a.data_ptr(), w.data_ptr(), x.data_ptr(), stats.data_ptr(), gamma.data_ptr(),
        res.data_ptr(), out_f.data_ptr() if out_f is not None else None, out_b.data_ptr(),
        sums.data_ptr(), part.data_ptr(), M, dim, K, a.device.index, _stream(a)))
    return out_f, out_b, sums


def _count_fused(fused: bool) -> None:
    """A forward chain at a ``fuses_mlp`` width launched its LN1 + qkv
    product and its fused MLP once each."""
    if fused:
        block_ln_gemm.launches += 1
        block_mlp.launches += 1


def _count_cls(N: int, rows: int, dim: int, dim_head: int, ln_dim: int | None = None) -> None:
    """A CLS forward chain on ``cls_fwd_route`` launched the few-query
    attention once (``few_query_fwd.launches``), and its [LN1 + K/V] once
    where ``cls_ln1_in_kv`` (``block_ln_gemm.launches``)."""
    if cls_fwd_route(N, rows, dim_head):
        few_query_fwd.launches += 1
        if cls_ln1_in_kv(N, rows, dim, dim_head, ln_dim):
            block_ln_gemm.launches += 1


def block_mlp(x1, ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2, *,
              ln_eps: float = 1e-5, train: bool = False):
    """The forward chain's MLP half as one kernel (``fuses_mlp`` widths):
    x1 (M, dim) bf16 -> x1 + fc2(GELU(fc1(LN2(x1)))), weights in the torch
    Linear layout; with ``train``, -> (out, {h2, stats2, fpre, f}), what the
    training chain keeps. CPU tensors run ``mlp_reference``. ``launches``
    counts the kernel's launches, here and inside the forward chains."""
    if _dispatch(x1) == "cpu":
        sv = {} if train else None
        out = mlp_reference(x1, ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2,
                            ln_eps=ln_eps, saved=sv)
        return (out, sv) if train else out
    _check_gemm_operands(x1, w_fc1, w_fc2)
    (M, dim), mlp = x1.shape, w_fc1.shape[0]
    if tuple(w_fc1.shape) != (mlp, dim) or tuple(w_fc2.shape) != (dim, mlp):
        raise ValueError("x1 (M, dim), w_fc1 (mlp, dim) and w_fc2 (dim, mlp) must agree")
    if not fuses_mlp(dim, mlp, train):
        raise ValueError(f"the fused MLP takes dim in {FUSED_MLP_DIMS} (its training form 96) "
                         f"and mlp a multiple of 128 up to 4 dim, got dim {dim}, mlp {mlp}")
    check_vectors({"ln2_scale": (ln2_scale, dim), "ln2_bias": (ln2_bias, dim),
                   "b_fc1": (b_fc1, mlp), "b_fc2": (b_fc2, dim)})
    f32 = dict(dtype=torch.float32, device=x1.device)
    out = torch.empty_like(x1)
    sv = ({"h2": torch.empty_like(x1), "stats2": torch.empty((M, 2), **f32),
           "fpre": torch.empty((M, mlp), **f32), "f": x1.new_empty((M, mlp))}
          if train else {})
    ptrs = [t.data_ptr() for t in (x1, ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2, out)]
    ptrs += [sv[k].data_ptr() if train else None for k in ("h2", "stats2", "fpre", "f")]
    _native.check(_native.library().svt_block_mlp(
        *ptrs, M, dim, mlp, ln_eps, x1.device.index, _stream(x1)))
    block_mlp.launches += 1
    return (out, sv) if train else out


block_mlp.launches = 0


def block_ln_gemm(x, ln_scale, ln_bias, w, *, ln_eps: float = 1e-5, train: bool = False):
    """The forward chain's qkv product with LN1 in its prologue
    (``fuses_mlp`` widths): x (M, dim) bf16, dim 96 or 192, w (N, dim) ->
    LN(x) @ w.T bf16; with ``train``, -> (C, LN(x) bf16, (mean, rstd) per
    row float32), what the training chain keeps. CPU tensors run
    ``ln_gemm_reference``. ``launches`` counts the kernel's launches, here
    and inside the forward chains."""
    if _dispatch(x) == "cpu":
        c, h, stats = ln_gemm_reference(x, ln_scale, ln_bias, w, ln_eps=ln_eps)
        return (c, h, stats) if train else c
    _check_gemm_operands(x, w)
    (M, K), N = x.shape, w.shape[0]
    if w.shape[1] != K or K not in FUSED_MLP_DIMS:
        raise ValueError(f"x (M, K) and w (N, K) must agree, K in {FUSED_MLP_DIMS}")
    check_vectors({"ln_scale": (ln_scale, K), "ln_bias": (ln_bias, K)})
    c = x.new_empty((M, N))
    h = torch.empty_like(x) if train else None
    stats = torch.empty((M, 2), dtype=torch.float32, device=x.device) if train else None
    _native.check(_native.library().svt_block_ln_gemm(
        *[t.data_ptr() if t is not None else None for t in (x, ln_scale, ln_bias, w, c, h, stats)],
        M, N, K, ln_eps, x.device.index, _stream(x)))
    block_ln_gemm.launches += 1
    return (c, h, stats) if train else c


block_ln_gemm.launches = 0


def weight_grad_reference(a, b):
    """Plain ``block_weight_grad``: a^T b in float32."""
    return a.float().t() @ b.float()


def block_weight_grad(a, b):
    """The backward chain's weight gradient: a (K, Mout)^T @ b (K, Nout)
    over the K token rows, float32 (Mout, Nout); split over K into partials
    that are added in a fixed order. CPU tensors run
    ``weight_grad_reference``."""
    if a.device.type == "cpu":
        return weight_grad_reference(a, b)
    _check_gemm_operands(a, b)
    (K, m_out), n_out = a.shape, b.shape[1]
    if b.shape[0] != K:
        raise ValueError("a (K, Mout) and b (K, Nout) must agree")
    lib = _native.library()
    out = torch.empty((m_out, n_out), dtype=torch.float32, device=a.device)
    part = torch.empty((lib.svt_block_weight_grad_workspace(m_out, n_out, K),),
                       dtype=torch.float32, device=a.device)
    _native.check(lib.svt_block_weight_grad(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(), m_out, n_out, K,
        a.device.index, _stream(a)))
    return out


def _mm32(a, b):
    """a @ b for 2-D operands in the compute dtype, the product in float32:
    what the tensor cores give for bf16 operands with fp32 accumulation."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Linear32(torch.autograd.Function):
    """a @ w.T with both operands rounded to ``dt`` inside and a float32
    product. Its backward rounds the cotangent to ``dt`` and returns float32
    gradients for a and w (cast to their own dtypes by autograd): the
    rounding points of the block chain (bf16 df1, dx1, dqkv; fp32 dh and
    weight gradients)."""

    @staticmethod
    def forward(ctx, a, w, dt):
        ab, wb = a.to(dt), w.to(dt)
        ctx.save_for_backward(ab, wb)
        ctx.dt = dt
        return _mm32(ab.reshape(-1, ab.shape[-1]), wb.t()).reshape(*a.shape[:-1], -1)

    @staticmethod
    def backward(ctx, gc):
        ab, wb = ctx.saved_tensors
        gb = gc.to(ctx.dt).reshape(-1, gc.shape[-1])
        da = _mm32(gb, wb).reshape(ab.shape)
        dw = _mm32(gb.t(), ab.reshape(-1, ab.shape[-1]))
        return da, dw, None


class _Round(torch.autograd.Function):
    """t rounded to ``dt``, kept in t's dtype; the gradient passes unrounded
    (the chain keeps dx1 in float32 across the rounding of x1)."""

    @staticmethod
    def forward(ctx, t, dt):
        return t.to(dt).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def block_recompute(x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale,
                    ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int,
                    dim_head: int, valid_len: int | None = None,
                    ln_eps: float = 1e-5, cls: bool = False, ln_dim: int | None = None):
    """``fused_block`` in torch ops under autograd (the counterpart of the
    JAX package's ``_xla_block_ref(attn="flash")``), at the chain's rounding
    points in x.dtype: bf16 LN outputs, qkv, x1 and GELU output, fp32 fc1
    pre-activation, exact-erf GELU. Attention is ``flash_attention`` (the
    kernel on CUDA). Parameters of any float dtype (matrices cast to x.dtype
    inside, gradients in their own dtypes). ``cls``: ``fused_block_cls``
    (K and V over every row; Q, the attention and the rest on the top
    min(8, N) rows) -> (B, rows, dim). ``ln_dim`` below dim (a padded
    layout, ``svt_ops.pad_dims``): the block of the first ln_dim columns,
    zeros past them (the products take any width)."""
    width = x.shape[-1]
    if ln_dim is not None and ln_dim < width:
        out = block_recompute(x[..., :ln_dim], *crop_dims(
            (ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias, w_fc1, b_fc1,
             w_fc2, b_fc2), ln_dim), heads=heads, dim_head=dim_head, valid_len=valid_len,
            ln_eps=ln_eps, cls=cls)
        return F.pad(out, (0, width - ln_dim))
    dt, (B, N, dim) = x.dtype, x.shape
    vl = N if valid_len is None else int(valid_len)
    xf = x.float()
    h = F.layer_norm(xf, (dim,), ln1_scale.float(), ln1_bias.float(), ln_eps)
    if cls:
        rows, hd = min(_CLS_ROWS, N), heads * dim_head
        kv = _Linear32.apply(h, w_qkv[hd:], dt).to(dt)
        q = _Linear32.apply(h[:, :rows], w_qkv[:hd], dt).to(dt)
        k, v = (t.transpose(1, 2) for t in kv.view(B, N, 2, heads, dim_head).unbind(2))
        q, xf = q.view(B, rows, heads, dim_head).transpose(1, 2), xf[:, :rows]
    else:
        q, k, v = (t.transpose(1, 2) for t in
                   _Linear32.apply(h, w_qkv, dt).to(dt).view(B, N, 3, heads, dim_head).unbind(2))
    attn = flash_attention(q, k, v, vl).transpose(1, 2).flatten(2)
    x1 = _Round.apply(xf + _Linear32.apply(attn, w_out, dt) + b_out.float(), dt)
    h2 = F.layer_norm(x1, (dim,), ln2_scale.float(), ln2_bias.float(), ln_eps)
    f = F.gelu(_Linear32.apply(h2, w_fc1, dt) + b_fc1.float())
    return (x1 + _Linear32.apply(f, w_fc2, dt) + b_fc2.float()).to(dt)


def crop_dims(params, dim: int) -> list:
    """The 11 block parameters at row width ``dim``: ``svt_ops.pad_dims``'s
    padded rows and columns of the width cropped (the hidden width kept)."""
    ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2 = params
    return [ln1_s[:dim], ln1_b[:dim], w_qkv[:, :dim], w_out[:dim], b_out[:dim], ln2_s[:dim],
            ln2_b[:dim], w_fc1[:, :dim], b_fc1, w_fc2[:dim], b_fc2[:dim]]


def fused_block_recompute_bwd(x, g, *params, heads: int, dim_head: int,
                              valid_len: int | None = None, ln_eps: float = 1e-5,
                              cls: bool = False, ln_dim: int | None = None):
    """The recompute route's backward of ``fused_block`` (``cls``:
    ``fused_block_cls``, g (B, min(8, N), dim)): ``block_recompute`` from x,
    then autograd with cotangent g. -> (dx, the 11 parameter gradients in
    the parameters' dtypes). On CUDA, counted in ``launches``."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        ps = [p.detach().requires_grad_() for p in params]
        out = block_recompute(xr, *ps, heads=heads, dim_head=dim_head,
                              valid_len=valid_len, ln_eps=ln_eps, cls=cls, ln_dim=ln_dim)
        grads = torch.autograd.grad(out, [xr, *ps], g)
    if x.device.type == "cuda":
        fused_block_recompute_bwd.launches += 1
    return grads


fused_block_recompute_bwd.launches = 0


class _BlockTrain(torch.autograd.Function):
    """Differentiable block over master parameters of any float dtype: the
    matrices are cast to x.dtype (the compute dtype) inside, the vectors to
    float32, and the gradients come back in the masters' dtypes. The route
    (chain or recompute) follows ``uses_recompute`` (the CLS block:
    ``cls_uses_recompute``) at the width the LayerNorms count."""

    @staticmethod
    def forward(ctx, x, heads, dim_head, valid_len, ln_eps, cls, ln_dim, *masters):
        params = tuple(
            (m.to(x.dtype) if m.dim() == 2 else m.float()).contiguous()
            for m in masters)
        x = x.contiguous()
        vl = x.shape[1] if valid_len is None else int(valid_len)
        n = x.shape[2] if ln_dim is None else int(ln_dim)
        kw = dict(heads=heads, dim_head=dim_head, valid_len=vl, ln_eps=ln_eps, ln_dim=n)
        ctx.dtypes, ctx.cls = [m.dtype for m in masters], cls
        if cls_uses_recompute(n) if cls else uses_recompute(x.shape[1], n):
            ctx.state = (x, masters, None, kw)
            return (fused_block_cls if cls else fused_block)(x, *params, **kw)
        out, sv = train_forward(x, *params, cls=cls, **kw)
        ctx.state = (x, params, sv, kw)
        return out

    @staticmethod
    def backward(ctx, g):
        x, params, sv, kw = ctx.state
        del ctx.state  # the kept activations go as soon as they are used
        g = g.to(x.dtype).contiguous()
        if sv is None:
            dx, *grads = fused_block_recompute_bwd(x, g, *params, cls=ctx.cls, **kw)
        else:
            del kw["ln_eps"]
            bwd = fused_block_cls_bwd if ctx.cls else fused_block_bwd
            dx, *grads = bwd(x, g, *params, saved=sv, **kw)
        return (dx, None, None, None, None, None, None,
                *(d.to(t) for d, t in zip(grads, ctx.dtypes)))


def fused_block_train(x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale,
                      ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int,
                      dim_head: int, valid_len: int | None = None,
                      ln_eps: float = 1e-5, ln_dim: int | None = None):
    """Differentiable ``fused_block`` (the JAX package's
    ``fused_block_train``): x (B, N, dim) in the compute dtype, parameters
    as masters (e.g. float32 ``nn.Parameter``s, torch layout); ``ln_dim``
    as in ``fused_block`` (a model lays its stream and parameters out padded
    with ``svt_ops.pad_dims``, a differentiable copy, so that the masters'
    gradients come back in their own shapes). The backward is
    ``fused_block_bwd``."""
    return _BlockTrain.apply(x, heads, dim_head, valid_len, ln_eps, False, ln_dim,
                             ln1_scale, ln1_bias, w_qkv, w_out, b_out,
                             ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2)


def fused_block_cls_train(x, ln1_scale, ln1_bias, w_qkv, w_out, b_out,
                          ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2, *,
                          heads: int, dim_head: int,
                          valid_len: int | None = None, ln_eps: float = 1e-5,
                          ln_dim: int | None = None):
    """Differentiable ``fused_block_cls`` (the JAX package's
    ``fused_block_cls_train``): x (B, N, dim) -> (B, min(8, N), dim); the
    backward is ``fused_block_cls_bwd``; ``ln_dim`` as in
    ``fused_block_train``."""
    return _BlockTrain.apply(x, heads, dim_head, valid_len, ln_eps, True, ln_dim,
                             ln1_scale, ln1_bias, w_qkv, w_out, b_out,
                             ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2)


# -- the serving operators' CPU kernels and launch counters --------------------------


def register_plain(op: str, reference) -> None:
    """Register ``reference`` (a plain block version, heads, dim_head,
    valid_len, ln_eps and ln_dim by keyword) as the CPU kernel of the block operator
    ``op``, whose schema takes them after the tensors."""

    def kernel(x, *args):
        params, heads, dim_head, valid_len, ln_eps, ln_dim = svt_ops.block_args(x, args)
        return reference(x, *params, heads=heads, dim_head=dim_head, valid_len=valid_len,
                         ln_eps=ln_eps, ln_dim=ln_dim)

    torch.library.register_kernel(op, "cpu", kernel)


register_plain("svt::fused_block", fused_block_reference)
register_plain("svt::fused_block_cls", fused_block_cls_reference)
svt_ops.count_into(fused_block=fused_block, fused_block_cls=fused_block_cls,
                   block_ln_gemm=block_ln_gemm, block_mlp=block_mlp,
                   few_query_fwd=few_query_fwd, wide_fwd=wide_fwd)
