"""Sequence parallelism over the mesh's 'model' axis (``tpu.seq_sharding``;
the JAX package's ``Attention._seq_parallel_attention`` and
``Encoder._seq_constraint``).

A SiT's tokens split over the axis: the sequence of N tokens is padded to
Np = m * ceil(N / m) rows and rank r keeps rows [r Np / m, (r + 1) Np / m).
Each rank runs LayerNorm, qkv, the out-projection and the MLP on its own
rows. In attention it all-gathers K|V (``gather_tokens``: 2/3 of qkv) and
runs the attention on its local queries against every key, the rows past N
masked as keys (``valid_len``); the pad rows' outputs are zeroed before the
out-projection, so no gradient reaches their queries. The all-gather's
backward sums each rank's dK|dV over the axis in float32 and keeps its own
rows (the reduce-scatter). Pooling adds the ranks' partial pools
(``seq_sum``): CLS reads row 0, on rank 0; mean pooling sums the valid rows.
Every rank then holds the same prediction and loss. The parameters stay
whole on every rank of the axis; the gradients of those that act on tokens
are summed over it (``ShardedModel.sync_grads``), the head's, computed alike
on every rank from the summed pool, are not.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """The 'model' axis holding the tokens, as one module sees it."""

    group: object
    size: int
    rank: int

    def rows(self, n: int) -> tuple[int, int, int]:
        """(start, stop, padded length) of the rank's rows of n tokens."""
        per = math.ceil(n / self.size)
        return self.rank * per, (self.rank + 1) * per, per * self.size


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        parts = [torch.empty_like(x) for _ in range(sp.size)]
        dist.all_gather(parts, x.contiguous(), group=sp.group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        full = g.float().contiguous()
        dist.all_reduce(full, group=sp.group)
        per = g.shape[1] // sp.size
        return full[:, sp.rank * per:(sp.rank + 1) * per].to(g.dtype), None


class _SeqSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=sp.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_tokens(x: torch.Tensor, sp: SeqGroup) -> torch.Tensor:
    """Every rank's rows of (B, n_local, F) ``x``, in rank order: (B,
    n_local * size, F); the backward sums the gradient over the axis and
    keeps the rank's rows."""
    return _GatherTokens.apply(x, sp)


def seq_sum(x: torch.Tensor, sp: SeqGroup) -> torch.Tensor:
    """The sum over the axis of each rank's partial ``x``; every rank's
    share gets the whole gradient (each computes the same loss from it)."""
    return _SeqSum.apply(x, sp)


def local_rows(h: torch.Tensor, sp: SeqGroup) -> torch.Tensor:
    """The rank's rows of (B, N, F) ``h``, the sequence zero-padded to a
    multiple of the axis."""
    start, stop, padded = sp.rows(h.shape[1])
    if padded > h.shape[1]:
        h = torch.nn.functional.pad(h, (0, 0, 0, padded - h.shape[1]))
    return h[:, start:stop]


def pool(h: torch.Tensor, n: int, mode: str, sp: SeqGroup) -> torch.Tensor:
    """(B, F) float32 pool of the sequence of n tokens whose rank's rows
    are ``h``: row 0 ('cls') or the mean of the n valid rows ('mean')."""
    start = sp.rank * h.shape[1]
    if mode == "cls":
        # row 0 times 0 on the other ranks: every rank's loss then reaches
        # its blocks, so each joins the all-gathers' backward sums
        return seq_sum(h[:, 0].float() * float(start == 0), sp)
    valid = max(0, min(n - start, h.shape[1]))
    return seq_sum(h[:, :valid].float().sum(1), sp) / n


def zero_pad_rows(o: torch.Tensor, n: int, sp: SeqGroup) -> torch.Tensor:
    """(B, n_local, F) ``o`` with the rows past the n valid tokens zeroed."""
    start = sp.rank * o.shape[1]
    if start + o.shape[1] <= n:
        return o
    keep = torch.arange(start, start + o.shape[1], device=o.device) < n
    return torch.where(keep[None, :, None], o, torch.zeros((), dtype=o.dtype, device=o.device))
