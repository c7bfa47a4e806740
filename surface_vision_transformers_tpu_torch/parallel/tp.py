"""Tensor parallelism over the mesh's 'model' axis (the JAX package's
``_TP_RULES`` under GSPMD, and ``models/sit.py::_tp_heads_attention``).

Each TP parameter holds the rank's slice as a plain tensor
(``parallel.mesh.TP_RULES``): the packed qkv the rank's H / model whole
heads of each of q, k and v, in [q | k | v] order, so the attention kernel
(``flash_attention_qkv``) runs on the rank's heads as it stands; fc1 its
hidden units, the out-projection and fc2 the matching input columns, the
MPP decoder its output features. A branch enters through ``copy_to``
(identity forward, the input gradient summed over the axis) and leaves
through ``reduce_from`` (the partial products summed, in float32, before
the replicated bias). Every other parameter is replicated and gets the same
gradient on every rank of the axis.
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


def _split_view(full: torch.Tensor, name: str, heads: int | None):
    """(view, dim) in which a TP parameter's rank slices are contiguous."""
    dim = tp_rule(name)
    if name.endswith("to_qkv.weight"):
        return full.reshape(3, heads, -1), 1
    return full, dim


def shard_param(full: torch.Tensor, name: str, size: int, rank: int,
                heads: int | None = None) -> torch.Tensor:
    """The rank's slice of a TP parameter's full value."""
    view, dim = _split_view(full, name, heads)
    part = view.chunk(size, dim)[rank]
    if name.endswith("to_qkv.weight"):
        return part.reshape(-1, full.shape[-1]).clone()
    return part.clone()


def unshard_param(parts: list[torch.Tensor], name: str, heads: int | None = None):
    """A TP parameter's full value from every rank's slice, in rank order."""
    if name.endswith("to_qkv.weight"):
        dim = parts[0].shape[-1]
        return torch.cat([p.reshape(3, -1, dim) for p in parts], 1).reshape(-1, dim)
    return torch.cat(parts, tp_rule(name))


def gather_param(local: torch.Tensor, name: str, tp: TPGroup, heads: int | None = None):
    """The full value of a TP parameter (a collective over the axis)."""
    parts = [torch.empty_like(local) for _ in range(tp.size)]
    dist.all_gather(parts, local.contiguous(), group=tp.group)
    return unshard_param(parts, name, heads)


def heads_of(model, name: str) -> int | None:
    """The head count of the attention that owns parameter ``name``."""
    if not name.endswith("to_qkv.weight"):
        return None
    return model.get_submodule(name.rsplit(".", 2)[0]).heads


def apply_tensor_parallel(model: torch.nn.Module, tp: TPGroup) -> dict[str, int]:
    """Split ``model``'s TP parameters in place (each rank keeps its slice
    of the value it holds, which the seeded init made equal on every rank)
    and hand ``tp`` to its attention, MLP and MPP modules. -> {parameter
    name: split dim}. Refuses head, hidden or decoder widths the axis does
    not divide."""
    from surface_vision_transformers_tpu_torch.models.mpp import MPP
    from surface_vision_transformers_tpu_torch.models.sit import Attention, FeedForward

    for name, mod in model.named_modules():
        if isinstance(mod, Attention) and mod.heads % tp.size:
            raise NotImplementedError(
                f"tensor parallelism splits attention by whole heads: {mod.heads} heads do "
                f"not divide over tpu.mesh_model={tp.size} ({name}); the JAX package runs "
                "this through GSPMD, the port does not")
        if isinstance(mod, FeedForward) and mod.net[0].out_features % tp.size:
            raise NotImplementedError(
                f"mlp_dim {mod.net[0].out_features} does not divide over "
                f"tpu.mesh_model={tp.size} ({name})")
        if isinstance(mod, MPP) and mod.to_original.out_features % tp.size:
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
        if isinstance(mod, (Attention, FeedForward, MPP)):
            mod.tp = tp
    return split
