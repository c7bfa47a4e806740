"""Tensor parallelism over the mesh's 'model' axis (the JAX package's
``_TP_RULES`` under GSPMD, and ``models/sit.py::_tp_heads_attention``).

Each TP parameter holds the rank's slice as a plain tensor
(``parallel.mesh.TP_RULES``): the packed qkv the rank's whole heads of each
of q, k and v, in [q | k | v] order, so the attention kernel
(``flash_attention_qkv``) runs on the rank's heads as it stands; fc1 its
hidden units, the out-projection and fc2 the matching input columns, the
MPP decoders their output features. Rank r of m keeps heads [floor(r H /
m), floor((r + 1) H / m)), so a head count the axis does not divide splits
unevenly (3 heads over 2 ranks: 1 and 2; 1 head over 2 ranks: none and 1),
which computes the function the JAX package's contiguous column split
computes under GSPMD. A rank that holds no head keeps empty qkv and
out-projection slices: its attention adds nothing, but it joins every
collective of the branch, forward and backward. Hidden and decoder widths
split evenly; a width the axis does not divide is refused with
``ValueError``, as the JAX ``shard_params`` (``jax.device_put``) refuses
it. A branch enters through ``branch_in`` (the rank's slice of its first
product, in the activations' dtype; the input gradient's partial products
made and summed over the axis in float32 and rounded once, as the single
process rounds its one product once) and leaves through ``reduce_from``
(the partial products summed, in float32, before the replicated bias).
Every other parameter is replicated and gets the same gradient on every
rank of the axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

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


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=tp.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _BranchIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, tp):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.tp, ctx.dtypes = tp, (weight.dtype, None if bias is None else bias.dtype)
        return F.linear(x, w, None if bias is None else bias.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.flatten(0, -2)  # (rows, out); out may be 0 on a rank without a head
        # the partial input gradient in float32, summed over the axis, rounded once
        dx = (g2.float() @ w.float()).view(*g.shape[:-1], w.shape[1])
        dist.all_reduce(dx, group=ctx.tp.group)
        dw = db = None
        if ctx.needs_input_grad[1]:  # as autograd makes a linear's, in x's dtype
            dw = (g2.t() @ x.flatten(0, -2)).to(ctx.dtypes[0])
        if ctx.dtypes[1] is not None and ctx.needs_input_grad[2]:
            db = g2.sum(0).to(ctx.dtypes[1])
        return dx.to(x.dtype), dw, db, None


def branch_in(x: torch.Tensor, lin: torch.nn.Linear, tp: TPGroup) -> torch.Tensor:
    """``x`` (replicated) times the rank's slice of ``lin`` (its output
    features), in x's dtype: a TP branch's first product. Its input
    gradient is summed over the axis from float32 partial products."""
    return _BranchIn.apply(x, lin.weight, lin.bias, tp)


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
        return torch.cat([p.reshape(3, p.shape[0] // 3, dim) for p in parts], 1).reshape(-1, dim)
    return torch.cat(parts, tp_rule(name))


def gather_param(local: torch.Tensor, name: str, tp: TPGroup, heads: int | None = None,
                 dim_head: int | None = None):
    """The full value of a TP parameter (a collective over the axis). The
    slices of uneven heads differ in size (a rank may hold none): each is
    padded to the most heads a rank holds for the all-gather and cut back
    after; ``dim_head`` is the heads' width."""
    if heads is None:
        parts = [torch.empty_like(local) for _ in range(tp.size)]
        dist.all_gather(parts, local.contiguous(), group=tp.group)
        return unshard_param(parts, name, heads)
    b = head_bounds(heads, tp.size)
    mine = b[tp.rank + 1] - b[tp.rank]
    qkv = name.endswith("to_qkv.weight")
    # heads on dim 1: (3, h, dh, dim) for the packed qkv, (dim, h, dh) for to_out
    view = (local.reshape(3, mine, dim_head, local.shape[-1]) if qkv
            else local.reshape(local.shape[0], mine, dim_head))
    pad = view.new_zeros((view.shape[0], max(np_ - n for n, np_ in zip(b, b[1:])),
                          *view.shape[2:]))
    pad[:, :mine] = view
    parts = [torch.empty_like(pad) for _ in range(tp.size)]
    dist.all_gather(parts, pad, group=tp.group)
    full = torch.cat([q[:, :hi - lo] for q, lo, hi in zip(parts, b, b[1:])], 1)
    return full.reshape(-1, local.shape[-1]) if qkv else full.reshape(local.shape[0], -1)


def _attention_of(model, name: str):
    """The attention module that owns parameter ``name`` (its packed qkv or
    out-projection weight), else None."""
    if not name.endswith(("to_qkv.weight", "to_out.0.weight", "to_out.weight")):
        return None
    owner = name.rsplit(".", 3 if name.endswith("to_out.0.weight") else 2)[0]
    mod = model.get_submodule(owner)
    return mod if hasattr(mod, "heads") else None


def heads_of(model, name: str) -> int | None:
    """The head count of the attention that owns parameter ``name`` (its
    packed qkv or out-projection weight), else None."""
    mod = _attention_of(model, name)
    return None if mod is None else mod.heads


def dim_head_of(model, name: str) -> int | None:
    """The head width of the attention that owns parameter ``name``, else
    None."""
    mod = _attention_of(model, name)
    return None if mod is None else mod.dim_head


def apply_tensor_parallel(model: torch.nn.Module, tp: TPGroup) -> dict[str, int]:
    """Split ``model``'s TP parameters in place (each rank keeps its slice
    of the value it holds, which the seeded init made equal on every rank)
    and hand ``tp`` to its attention, MLP and MPP modules (a SiT's or an
    MS-SiT's). -> {parameter name: split dim}. Heads split whole, unevenly
    where the axis does not divide them (a rank may hold none); hidden and
    decoder widths the axis does not divide are refused (``ValueError``), as
    the JAX placement refuses them."""
    from surface_vision_transformers_tpu_torch.models.mpp import MPP
    from surface_vision_transformers_tpu_torch.models.mpp_mssit import MPPMSSiT
    from surface_vision_transformers_tpu_torch.models.mssit import WindowAttention
    from surface_vision_transformers_tpu_torch.models.sit import Attention, FeedForward

    attns, decoders = (Attention, WindowAttention), (MPP, MPPMSSiT)
    jax_too = ("; the JAX package's placement (shard_params, jax.device_put) refuses the "
               "same")
    for name, mod in model.named_modules():
        if isinstance(mod, FeedForward) and mod.net[0].out_features % tp.size:
            raise ValueError(
                f"mlp_dim {mod.net[0].out_features} does not divide over "
                f"tpu.mesh_model={tp.size} ({name}){jax_too}")
        if isinstance(mod, decoders) and mod.to_original.out_features % tp.size:
            raise ValueError(
                f"the MPP decoder's {mod.to_original.out_features} outputs do not divide "
                f"over tpu.mesh_model={tp.size}{jax_too}")
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
