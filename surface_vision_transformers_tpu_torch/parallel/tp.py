"""Tensor parallelism over the mesh's 'model' axis (the JAX package's
``_TP_RULES`` under GSPMD, and ``models/sit.py::_tp_heads_attention``).

Each TP parameter holds the rank's slice as a plain tensor
(``parallel.mesh.TP_RULES``): the packed qkv the rank's whole heads of each
of q, k and v, in [q | k | v] order, so the attention kernel
(``flash_attention_qkv``) runs on the rank's heads as it stands; fc1 its
hidden units, the out-projection and fc2 the matching input columns, the
MPP decoders their output features. Rank r of m keeps heads [floor(r H /
m), floor((r + 1) H / m)), so a head count the axis does not divide splits
unevenly (3 heads over 2 ranks: 1 and 2), which computes the function the
JAX package's contiguous column split computes under GSPMD; hidden and
decoder widths split evenly and are refused otherwise. A branch enters
through ``copy_to`` (identity forward, the input gradient summed over the
axis) and leaves through ``reduce_from`` (the partial products summed, in
float32, before the replicated bias). Every other parameter is replicated
and gets the same gradient on every rank of the axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from surface_vision_transformers_tpu_torch.parallel.mesh import tp_rule


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The 'model' axis as one module sees it."""

    group: object
    size: int
    rank: int

    def cols(self, total: int) -> tuple[int, int, int]:
        """(start, stop, total) of the rank's share of ``total`` columns."""
        c = total // self.size
        return self.rank * c, (self.rank + 1) * c, total

    def heads(self, total: int) -> tuple[int, int]:
        """[start, stop) of this rank's whole heads of ``total``."""
        b = head_bounds(total, self.size)
        return b[self.rank], b[self.rank + 1]

    def head_count(self, total: int) -> int:
        """How many of ``total`` heads this rank holds."""
        lo, hi = self.heads(total)
        return hi - lo


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=tp.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """``x`` (replicated) entering a TP branch: its gradient is summed."""
    return _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The sum over the axis of each rank's partial ``x``."""
    return _ReduceFrom.apply(x, tp)


def head_bounds(heads: int, size: int) -> list[int]:
    """The head index each rank's share starts at, and the end: rank r
    holds heads [b[r], b[r + 1])."""
    return [r * heads // size for r in range(size + 1)]


def _part(full: torch.Tensor, name: str, lo: int, hi: int, heads: int | None):
    """Columns (or rows) [lo, hi) of a TP parameter's full value, in units
    of whole heads for the attention's parameters, else of its split dim."""
    if name.endswith("to_qkv.weight"):
        return full.reshape(3, heads, -1, full.shape[-1])[:, lo:hi].reshape(-1, full.shape[-1])
    if heads is not None:  # the out-projection: input columns by heads
        dh = full.shape[1] // heads
        return full[:, lo * dh:hi * dh]
    return full.narrow(tp_rule(name), lo, hi - lo)


def shard_param(full: torch.Tensor, name: str, size: int, rank: int,
                heads: int | None = None) -> torch.Tensor:
    """The rank's slice of a TP parameter's full value (``heads``: the
    head count of the attention that owns it, else None)."""
    if heads is not None:
        b = head_bounds(heads, size)
        return _part(full, name, b[rank], b[rank + 1], heads).clone()
    c = full.shape[tp_rule(name)] // size
    return _part(full, name, rank * c, (rank + 1) * c, None).clone()


def unshard_param(parts: list[torch.Tensor], name: str, heads: int | None = None):
    """A TP parameter's full value from every rank's slice, in rank order."""
    if name.endswith("to_qkv.weight"):
        dim = parts[0].shape[-1]
        return torch.cat([p.reshape(3, -1, dim) for p in parts], 1).reshape(-1, dim)
    return torch.cat(parts, tp_rule(name))


def gather_param(local: torch.Tensor, name: str, tp: TPGroup, heads: int | None = None):
    """The full value of a TP parameter (a collective over the axis). The
    slices of uneven heads differ in size: each is padded to the most heads
    a rank holds for the all-gather and cut back after."""
    if heads is None:
        parts = [torch.empty_like(local) for _ in range(tp.size)]
        dist.all_gather(parts, local.contiguous(), group=tp.group)
        return unshard_param(parts, name, heads)
    b = head_bounds(heads, tp.size)
    mine = b[tp.rank + 1] - b[tp.rank]
    qkv = name.endswith("to_qkv.weight")
    # heads on dim 1: (3, h, dh, dim) for the packed qkv, (dim, h, dh) for to_out
    view = (local.reshape(3, mine, -1, local.shape[-1]) if qkv
            else local.reshape(local.shape[0], mine, -1))
    pad = view.new_zeros((view.shape[0], max(np_ - n for n, np_ in zip(b, b[1:])),
                          *view.shape[2:]))
    pad[:, :mine] = view
    parts = [torch.empty_like(pad) for _ in range(tp.size)]
    dist.all_gather(parts, pad, group=tp.group)
    full = torch.cat([q[:, :hi - lo] for q, lo, hi in zip(parts, b, b[1:])], 1)
    return full.reshape(-1, local.shape[-1]) if qkv else full.reshape(local.shape[0], -1)


def heads_of(model, name: str) -> int | None:
    """The head count of the attention that owns parameter ``name`` (its
    packed qkv or out-projection weight), else None."""
    if not name.endswith(("to_qkv.weight", "to_out.0.weight", "to_out.weight")):
        return None
    owner = name.rsplit(".", 3 if name.endswith("to_out.0.weight") else 2)[0]
    return getattr(model.get_submodule(owner), "heads", None)


def apply_tensor_parallel(model: torch.nn.Module, tp: TPGroup) -> dict[str, int]:
    """Split ``model``'s TP parameters in place (each rank keeps its slice
    of the value it holds, which the seeded init made equal on every rank)
    and hand ``tp`` to its attention, MLP and MPP modules (a SiT's or an
    MS-SiT's). -> {parameter name: split dim}. Heads split whole, unevenly
    where the axis does not divide them; refuses fewer heads than ranks, and
    hidden or decoder widths the axis does not divide."""
    from surface_vision_transformers_tpu_torch.models.mpp import MPP
    from surface_vision_transformers_tpu_torch.models.mpp_mssit import MPPMSSiT
    from surface_vision_transformers_tpu_torch.models.mssit import WindowAttention
    from surface_vision_transformers_tpu_torch.models.sit import Attention, FeedForward

    attns, decoders = (Attention, WindowAttention), (MPP, MPPMSSiT)
    for name, mod in model.named_modules():
        if isinstance(mod, attns) and mod.heads < tp.size:
            raise NotImplementedError(
                f"tensor parallelism splits attention by whole heads: {mod.heads} heads "
                f"leave a rank of tpu.mesh_model={tp.size} without one ({name})")
        if isinstance(mod, FeedForward) and mod.net[0].out_features % tp.size:
            raise NotImplementedError(
                f"mlp_dim {mod.net[0].out_features} does not divide over "
                f"tpu.mesh_model={tp.size} ({name})")
        if isinstance(mod, decoders) and mod.to_original.out_features % tp.size:
            raise NotImplementedError(
                f"the MPP decoder's {mod.to_original.out_features} outputs do not divide "
                f"over tpu.mesh_model={tp.size}")
    split = {}
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            if tp_rule(name) is None:
                continue
            owner, leaf = name.rsplit(".", 1)
            mod = model.get_submodule(owner)
            local = shard_param(p.detach(), name, tp.size, tp.rank, heads_of(model, name))
            setattr(mod, leaf, torch.nn.Parameter(local, requires_grad=p.requires_grad))
            split[name] = tp_rule(name)
    for mod in model.modules():
        if isinstance(mod, (*attns, FeedForward, *decoders)):
            mod.tp = tp
    return split
