"""Multi-head attention with its row log-sum-exp, forward and backward:
a Hopper kernel and plain versions.

``flash_attention`` replaces the TPU kernel
``surface_vision_transformers_tpu/ops/pallas/flash_attention.py::
flash_attention`` (``_fwd`` / ``_fwd_kernel``, ``_bwd_impl`` /
``_bwd_kernel``) with its layout: q (B, H, Nq, dh), k and v (B, H, Nk, dh),
output (B, H, Nq, dh), Nq may differ from Nk. Keys >= ``valid_len`` are
masked; in the backward, query rows >= ``valid_len`` get P = 0, so their dq
is 0 and they add nothing to dk and dv. The softmax is shifted and in
float32, P is rounded to the input dtype before P.V and the sum divided out
after it; the backward forms P from the kept LSE.

The kernel (CUDA C++ for ``sm_90a``, ``csrc/flash_attention.cu``) streams K
and V through shared memory in tiles with an online softmax, so it takes any
sequence length; dh = 64, bfloat16. It reads its operands through (batch,
head, row) strides, so views of packed activations need no copy, and writes
its outputs as (B, H, N, dh) views of (B, N, H, dh) storage, where merging
the heads back is free. What bounds it, and its times: the kernel source and
PERF.md.

Dispatch: tensors on the CPU run the plain versions beside the kernel; CUDA
tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import torch

from surface_vision_transformers_tpu_torch.ops import _native

_DH = 64


def _masked_scores(q, k, valid_len):
    """fp32 scaled scores (B, H, Nq, Nk), keys >= valid_len at -inf."""
    s = q.float() @ k.float().transpose(-1, -2) * q.shape[-1] ** -0.5
    if valid_len < k.shape[-2]:
        s[..., valid_len:] = float("-inf")
    return s


def flash_attention_reference(q, k, v, valid_len: int | None = None):
    """Plain forward: -> (o (B, H, Nq, dh) in q.dtype, lse (B, H, Nq)
    float32). In float32 nothing is rounded."""
    vl = k.shape[-2] if valid_len is None else int(valid_len)
    s = _masked_scores(q, k, vl)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p.to(q.dtype).float() @ v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, valid_len: int | None = None):
    """Plain backward from the forward's o and lse: P = exp(s - lse) on keys
    and query rows < valid_len (0 elsewhere), delta = rowsum(dO . O),
    dS = P (dP - delta) / sqrt(dh); P and dS rounded to q.dtype before their
    products. -> (dq, dk, dv) in q.dtype."""
    vl = k.shape[-2] if valid_len is None else int(valid_len)
    dt = q.dtype
    p = torch.exp(_masked_scores(q, k, vl) - lse[..., None])
    p[..., vl:, :] = 0.0
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ dof
    ds = (p * (dof @ v.float().transpose(-1, -2) - delta) * q.shape[-1] ** -0.5)
    ds = ds.to(dt).float()
    return ((ds @ k.float()).to(dt), (ds.transpose(-1, -2) @ q.float()).to(dt),
            dv.to(dt))


# -- kernel wrappers -------------------------------------------------------------


def _aligned(t):
    """t, or a contiguous copy where its rows would not start on 16 bytes
    (the kernel loads rows in 16-byte pieces). The caller keeps the result
    alive until the launch is enqueued."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        return t.contiguous()
    return t


def _operand(t):
    """[pointer, batch, head and row strides] of an ``_aligned`` operand."""
    return [t.data_ptr(), *t.stride()[:3]]


def _heads_last_empty(like, n):
    """An empty (B, H, n, dh) view of (B, n, H, dh) storage."""
    B, H, _, dh = like.shape
    return like.new_empty((B, n, H, dh)).transpose(1, 2)


def _check_cuda(q, k, v, valid_len, *extra):
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.dtype != torch.bfloat16 or t.dim() != 4 or t.device != q.device:
            raise ValueError(f"{name} must be a bfloat16 (B, H, N, dh) tensor on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    B, H, _, dh = q.shape
    if dh != _DH:
        raise NotImplementedError(f"the attention kernel is built for dh {_DH}, got {dh}")
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[-1] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if not 1 <= valid_len <= k.shape[2]:
        raise ValueError(f"valid_len {valid_len} outside [1, {k.shape[2]}]")


def _dispatch(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {t.device}")
    return t.device.type


def flash_attention_fwd(q, k, v, valid_len: int | None = None):
    """The forward: -> (o (B, H, Nq, dh), lse (B, H, Nq) float32). CPU
    tensors run ``flash_attention_reference``; CUDA tensors the kernel."""
    vl = k.shape[-2] if valid_len is None else int(valid_len)
    if _dispatch(q) == "cpu":
        return flash_attention_reference(q, k, v, vl)
    _check_cuda(q, k, v, vl)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, H, nq, _ = q.shape
    o = _heads_last_empty(q, nq)
    lse = torch.empty((B, H, nq), dtype=torch.float32, device=q.device)
    _native.check(_native.library().svt_flash_attention_fwd(
        *_operand(q), *_operand(k), *_operand(v), *_operand(o), lse.data_ptr(),
        B, H, nq, k.shape[2], vl, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream))
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, valid_len: int | None = None):
    """The backward from the forward's o and lse and the output cotangent
    do: -> (dq, dk, dv). CPU tensors run ``flash_attention_bwd_reference``;
    CUDA tensors the kernel's two passes."""
    vl = k.shape[-2] if valid_len is None else int(valid_len)
    if _dispatch(q) == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, vl)
    _check_cuda(q, k, v, vl, ("o", o), ("do", do))
    B, H, nq, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o and do must have q's shape")
    if lse.shape != (B, H, nq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(B, H, nq)} tensor")
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    nk = k.shape[2]
    dq, dk, dv = _heads_last_empty(q, nq), _heads_last_empty(k, nk), _heads_last_empty(k, nk)
    delta = torch.empty_like(lse)
    _native.check(_native.library().svt_flash_attention_bwd(
        *_operand(q), *_operand(k), *_operand(v), *_operand(o), *_operand(do),
        lse.data_ptr(), delta.data_ptr(), *_operand(dq), *_operand(dk), *_operand(dv),
        B, H, nq, nk, vl, q.device.index, torch.cuda.current_stream(q.device).cuda_stream))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid_len):
        o, lse = flash_attention_fwd(q, k, v, valid_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.valid_len = valid_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.to(o.dtype), ctx.valid_len)
        return dq, dk, dv, None


def flash_attention(q, k, v, valid_len: int | None = None):
    """Differentiable attention (the JAX package's ``flash_attention``):
    q (B, H, Nq, dh), k and v (B, H, Nk, dh) -> (B, H, Nq, dh); keys >=
    ``valid_len`` (default Nk) masked. Forward ``flash_attention_fwd``,
    backward ``flash_attention_bwd``, which keeps o and the row LSE."""
    return _FlashAttention.apply(q, k, v, valid_len)
