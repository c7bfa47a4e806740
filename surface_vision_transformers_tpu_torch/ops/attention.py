"""Multi-head attention with a plain route and a kernel route.

Counterpart of ``surface_vision_transformers_tpu.ops.attention``
(``xla_attention``, ``multi_head_attention``) over (B, H, N, dh) tensors:

* ``plain_attention`` (the JAX package's ``xla_attention``): float32
  scores, keys >= ``valid_len`` at -inf, softmax in float32, the weights
  rounded to v's dtype before P.V. With an explicit ``keep`` mask it applies
  dropout to the weights, as the reference's attention does.
* ``multi_head_attention``: ``backend="auto"`` takes the kernels
  (``flash_attention``, or ``flash_attention_tiled`` beyond
  ``MAX_PACKED_SEQ`` tokens) for CUDA bfloat16 tensors and the plain route
  otherwise, so float32 compute (the parity mode) is plain, as the JAX
  package's HIGHEST precision is; ``"plain"`` always takes the plain route.
"""

from __future__ import annotations

import torch

from surface_vision_transformers_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_tiled,
)

# Beyond this many tokens the JAX package leaves its single-block kernels for
# ``flash_attention_tiled``; the port's streamed kernels take any length, and
# the same switch keeps each entry counted where the JAX path would call it.
MAX_PACKED_SEQ = 1536
BACKENDS = ("auto", "plain")


def kernel_route(backend: str, t: torch.Tensor, dtype: torch.dtype | None = None) -> bool:
    """Whether ``backend`` sends tensors like ``t`` (computing in ``dtype``,
    default t's) to the kernels."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected one of {BACKENDS}")
    dt = t.dtype if dtype is None else dtype
    return backend == "auto" and t.is_cuda and dt == torch.bfloat16


def plain_attention(q, k, v, valid_len: int | None = None, keep=None, rate: float = 0.0):
    """softmax(q k^T / sqrt(dh)) v, (B, H, N, dh) -> (B, H, Nq, dh) in v's
    dtype; with ``keep`` ((B, H, Nq, Nk) bool) the weights are dropped at
    ``rate`` and the kept ones scaled by 1 / (1 - rate)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if valid_len is not None and valid_len < k.shape[-2]:
        s[..., valid_len:] = float("-inf")
    w = s.softmax(-1).to(v.dtype)
    if keep is not None:
        w = torch.where(keep, w * (1.0 / (1.0 - rate)), 0.0).to(v.dtype)
    return w @ v


def multi_head_attention(q, k, v, valid_len: int | None = None, *, backend: str = "auto"):
    """Dispatching attention: q, k, v (B, H, N, dh) -> (B, H, Nq, dh)."""
    if not kernel_route(backend, q):
        return plain_attention(q, k, v, valid_len)
    if q.shape[2] > MAX_PACKED_SEQ:
        return flash_attention_tiled(q, k, v, valid_len)
    return flash_attention(q, k, v, valid_len)
