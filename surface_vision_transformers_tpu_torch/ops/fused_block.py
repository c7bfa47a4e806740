"""Transformer-block forward for inference: Hopper kernels and plain versions.

``fused_block`` replaces the TPU kernel
``surface_vision_transformers_tpu/ops/pallas/fused_block.py::fused_block``
(``_block_kernel``); ``fused_block_cls`` replaces ``fused_block_cls``
(``_block_cls_kernel``) in the same file. Both kernels are CUDA C++ for
``sm_90a`` in ``csrc/fused_block.cu``: a chain of LayerNorm, bf16
tensor-core GEMM (``mma.sync``, fp32 accumulation, fused bias / erf-GELU /
residual epilogues) and attention launches on the caller's stream.

What bounds them on the H100: the TPU kernel keeps a whole block in ~96 MB
of VMEM, while an SM has 227 KB of shared memory, so every intermediate
(LN output, QKV, attention output, x1, the MLP hidden) makes a round trip
through HBM, about ten times the bytes of the block's input and output.
Measured at SiT-tiny (PERF.md), the GEMMs reach about a tenth of the bf16
tensor-core peak and stay well under HBM bandwidth: this first version is
bounded by its simple ``mma.sync`` tiling, not by either roofline. The
design keeps what fits on chip per CTA: the attention kernel stages one
(sample, head)'s whole K and V in shared memory (~100 KB at N=321, past the
48 KB default, so it opts into dynamic shared memory) and never writes the
score matrix; the GEMM epilogues fold bias, GELU and the residual into the
store. The CLS variant computes Q, attention and the MLP for the first
``rows`` (<= 8) rows of each sample only, reading them through a strided
row map instead of a gather.

Numerics: the TPU kernel's rounding points (bf16 after LN, QKV, P, P.V, x1
and GELU; fp32 LN statistics, scores, softmax sums and epilogues) with exact
erf-GELU and the shifted softmax (see the kernel source).

Weights are in the torch ``nn.Linear`` layout (out, in) -- the reference
checkpoint layout, and the one the kernels' tensor-core B operands read with
K contiguous -- contiguous, in the compute dtype; LayerNorm parameters and
biases are fp32. Prepare them once (``models.fused.prepare_weights``).

Dispatch: tensors on the CPU run the plain PyTorch version beside each
kernel; CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from surface_vision_transformers_tpu_torch.ops import _native

# Attention stages K and V of one (sample, head) plus a 64-row Q tile, each
# row padded to 72 bf16, in at most the 232,448 bytes of shared memory a
# Hopper block may opt into: keys padded to 32 must satisfy
# (64 + 2 * keys) * 144 <= 232448.
MAX_SEQ_LEN = 768
_CLS_ROWS = 8


# -- plain versions ------------------------------------------------------------


def _layer_norm(x, scale, bias, eps):
    h = x.float()
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + eps) * scale + bias


def _mm(a, w):
    """a @ w.T with exact products and fp32 sums: what the tensor cores do
    with bf16 operands and fp32 accumulators."""
    return a.float() @ w.float().t()


def _attention(q, k, v, heads, dim_head, valid_len, dt):
    """(B, nq, H*dh) queries against (B, n, H*dh) keys/values, keys
    >= valid_len masked; shifted fp32 softmax, P rounded to ``dt`` before
    P.V, the sum divided out after it (as the TPU kernel does)."""
    B = q.shape[0]

    def split(t):
        return t.reshape(B, t.shape[1], heads, dim_head).transpose(1, 2).float()

    s = split(q) @ split(k).transpose(-1, -2) * dim_head ** -0.5
    if valid_len < k.shape[1]:
        s[..., valid_len:] = float("-inf")
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(dt).float() @ split(v)) / p.sum(-1, keepdim=True)
    return o.to(dt).transpose(1, 2).reshape(B, q.shape[1], heads * dim_head)


def _out_proj_mlp(x, attn, w_out, b_out, ln2_scale, ln2_bias,
                  w_fc1, b_fc1, w_fc2, b_fc2, eps, dt):
    x1 = (x.float() + (_mm(attn, w_out) + b_out)).to(dt)
    h2 = _layer_norm(x1, ln2_scale, ln2_bias, eps).to(dt)
    f = F.gelu(_mm(h2, w_fc1) + b_fc1).to(dt)  # exact erf
    return (x1.float() + (_mm(f, w_fc2) + b_fc2)).to(dt)


def fused_block_reference(
    x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5,
):
    """Plain PyTorch ``fused_block``: x (B, N, dim) -> (B, N, dim) in
    x.dtype. In float32 nothing is rounded."""
    dt, hd = x.dtype, heads * dim_head
    vl = x.shape[1] if valid_len is None else int(valid_len)
    h = _layer_norm(x, ln1_scale, ln1_bias, ln_eps).to(dt)
    qkv = _mm(h, w_qkv).to(dt)
    attn = _attention(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:],
                      heads, dim_head, vl, dt)
    return _out_proj_mlp(x, attn, w_out, b_out, ln2_scale, ln2_bias,
                         w_fc1, b_fc1, w_fc2, b_fc2, ln_eps, dt)


def fused_block_cls_reference(
    x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5,
):
    """Plain PyTorch ``fused_block_cls``: x (B, N, dim) -> the block's first
    min(8, N) output rows (B, rows, dim); row 0 is the CLS token."""
    dt, hd = x.dtype, heads * dim_head
    rows = min(_CLS_ROWS, x.shape[1])
    vl = x.shape[1] if valid_len is None else int(valid_len)
    h = _layer_norm(x, ln1_scale, ln1_bias, ln_eps).to(dt)
    kv = _mm(h, w_qkv[hd:]).to(dt)
    q = _mm(h[:, :rows], w_qkv[:hd]).to(dt)
    attn = _attention(q, kv[..., :hd], kv[..., hd:], heads, dim_head, vl, dt)
    return _out_proj_mlp(x[:, :rows], attn, w_out, b_out, ln2_scale, ln2_bias,
                         w_fc1, b_fc1, w_fc2, b_fc2, ln_eps, dt)


# -- kernel wrappers -------------------------------------------------------------


def _check_cuda_args(x, params, heads, dim_head, valid_len):
    """Validate everything the kernels assume; raise on anything else."""
    (ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b,
     w_fc1, b_fc1, w_fc2, b_fc2) = params
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA block kernels take bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (B, N, dim) tensor")
    B, N, dim = x.shape
    hd = heads * dim_head
    mlp = w_fc1.shape[0]
    if dim_head != 64:
        raise NotImplementedError(
            f"the attention kernel is built for dim_head 64, got {dim_head}")
    if dim % 8 or mlp % 8:
        raise NotImplementedError("dim and mlp_dim must be multiples of 8")
    if N > MAX_SEQ_LEN:
        raise NotImplementedError(
            f"sequence length {N} > {MAX_SEQ_LEN}: K/V of one head no longer "
            "fit the attention kernel's shared memory")
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
    vectors = {"ln1_scale": (ln1_s, dim), "ln1_bias": (ln1_b, dim),
               "b_out": (b_out, dim), "ln2_scale": (ln2_s, dim),
               "ln2_bias": (ln2_b, dim), "b_fc1": (b_fc1, mlp),
               "b_fc2": (b_fc2, dim)}
    for name, (v, n) in vectors.items():
        if tuple(v.shape) != (n,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({n},), got "
                             f"{v.dtype} {tuple(v.shape)}")
    for t in params:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("every parameter must be contiguous and on "
                             f"{x.device}")
    for t in (x, w_qkv, w_out, w_fc1, w_fc2):
        if t.data_ptr() % 16:  # the kernels load rows in 16-byte pieces
            raise ValueError("x and the weight matrices must start on a "
                             "16-byte boundary")


def _dispatch(x):
    """'cpu' -> plain version, 'cuda' -> kernel, anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused blocks run on cpu or cuda, not {x.device}")
    return x.device.type


def fused_block(
    x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5,
):
    """One pre-norm transformer block, x (B, N, dim) -> (B, N, dim); keys
    at positions >= ``valid_len`` are masked. CPU tensors run
    ``fused_block_reference``; CUDA tensors run the kernel (bfloat16)."""
    params = (ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
              w_fc1, b_fc1, w_fc2, b_fc2)
    vl = x.shape[1] if valid_len is None else int(valid_len)
    if _dispatch(x) == "cpu":
        return fused_block_reference(x, *params, heads=heads,
                                     dim_head=dim_head, valid_len=vl,
                                     ln_eps=ln_eps)
    _check_cuda_args(x, params, heads, dim_head, vl)
    lib = _native.library()
    B, N, dim = x.shape
    hd, mlp, M = heads * dim_head, w_fc1.shape[0], B * N
    out = torch.empty_like(x)
    ws = [x.new_empty((M, c)) for c in (dim, 3 * hd, hd, dim, mlp)]
    _native.check(lib.svt_fused_block(
        *[t.data_ptr() for t in (x, *params, out, *ws)],
        B, N, dim, heads, dim_head, mlp, vl, ln_eps, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    ))
    fused_block.launches += 1
    return out


fused_block.launches = 0


def fused_block_cls(
    x, ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
    w_fc1, b_fc1, w_fc2, b_fc2, *, heads: int, dim_head: int,
    valid_len: int | None = None, ln_eps: float = 1e-5,
):
    """The final block under CLS pooling: x (B, N, dim) -> its first
    min(8, N) output rows. CPU tensors run ``fused_block_cls_reference``;
    CUDA tensors run the kernel (bfloat16)."""
    params = (ln1_scale, ln1_bias, w_qkv, w_out, b_out, ln2_scale, ln2_bias,
              w_fc1, b_fc1, w_fc2, b_fc2)
    vl = x.shape[1] if valid_len is None else int(valid_len)
    if _dispatch(x) == "cpu":
        return fused_block_cls_reference(x, *params, heads=heads,
                                         dim_head=dim_head, valid_len=vl,
                                         ln_eps=ln_eps)
    _check_cuda_args(x, params, heads, dim_head, vl)
    lib = _native.library()
    B, N, dim = x.shape
    rows = min(_CLS_ROWS, N)
    hd, mlp, Mt = heads * dim_head, w_fc1.shape[0], B * rows
    out = x.new_empty((B, rows, dim))
    ws = [x.new_empty(s) for s in ((B * N, dim), (B * N, 2 * hd), (Mt, hd),
                                   (Mt, hd), (Mt, dim), (Mt, mlp))]
    _native.check(lib.svt_fused_block_cls(
        *[t.data_ptr() for t in (x, *params, out, *ws)],
        B, N, rows, dim, heads, dim_head, mlp, vl, ln_eps, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    ))
    fused_block_cls.launches += 1
    return out


fused_block_cls.launches = 0
