"""A model and its training state on a mesh: placement (tensor
parallelism or sequence sharding on 'model', FSDP2 on 'fsdp' beside either
and beside a pipeline, the stages of a pipeline on 'pipe'), the gradient
sums over the batch shards (and over 'model' under sequence sharding, over
'pipe' for the parameters every stage holds), the clip norm, and full state
dicts gathered for checkpoints and laid out again on load, so the files are
the single-process format and a run saved under one mesh resumes under
another or under none.

Under FSDP a parameter is a DTensor over the rank's FSDP mesh
(``Layout.fsdp_mesh``) whose value is what the rank holds without FSDP:
under TP its slice, in a pipeline its stage's. FSDP2 reduce-scatters the
gradients over the batch shards in backward; the sums over 'model' (the
token-acting parameters under sequence sharding) and over 'pipe' (the
shared parameters) then add the local shards, which line up because every
'model' and 'pipe' coordinate shards alike.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from surface_vision_transformers_tpu_torch.parallel.mesh import Layout
from surface_vision_transformers_tpu_torch.parallel.pipeline import Stage, stage_blocks
from surface_vision_transformers_tpu_torch.parallel.seq import SeqGroup
from surface_vision_transformers_tpu_torch.parallel.tp import (
    TPGroup,
    apply_tensor_parallel,
    dim_head_of,
    gather_param,
    heads_of,
    shard_param,
)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view), another tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


class ShardedModel:
    """How one model lies on a mesh: ``split`` {parameter name: dim} of
    its tensor-parallel slices; FSDP2 holds every parameter as a DTensor;
    a pipeline stage holds the embedding, positions, CLS token and head and
    its own blocks (the others are dropped: ``shapes`` keeps the whole
    model's state-dict shapes, ``names`` its parameters' names in order),
    and runs them through ``stage`` (``pipeline.Stage``)."""

    def __init__(self, model: torch.nn.Module, layout: Layout):
        from surface_vision_transformers_tpu_torch.models.sit import Attention, SiT, _PreNorm

        self.model, self.layout = model, layout
        self.tp = (TPGroup(layout.model_group, layout.model_size, layout.model_index)
                   if layout.tp else None)
        self.split: dict[str, int] = {}
        self.shapes = {k: (v.shape, v.dtype) for k, v in model.state_dict().items()}
        self.full_names = [n for n, p in model.named_parameters() if p.requires_grad]
        if self.tp is not None:
            self.split = apply_tensor_parallel(model, self.tp)
        if layout.seq:
            sp = SeqGroup(layout.model_group, layout.model_size, layout.model_index)
            for m in model.modules():
                if isinstance(m, (SiT, Attention)):
                    m.sp = sp
        self.stage = None
        if layout.pipe:  # this stage's blocks only
            mine = stage_blocks(model.depth, layout)
            for i in range(model.depth):
                if i not in mine:
                    model.transformer.layers[i] = torch.nn.ModuleList()
            self.stage = Stage(model, layout)
        if layout.fsdp:
            from torch.distributed.fsdp import fully_shard

            # a unit a pre-norm branch, then the rest. Outside a step every
            # parameter is its shard (the root too: EMA and state dicts read
            # them); a pipeline's units stay whole from a step's first
            # forward to its last backward (``pipeline.train_step``). A TP
            # rank's empty slices (it holds no head) stay out: FSDP2 cannot
            # reduce-scatter an empty gradient, and there is nothing to shard
            keep = layout.pipe
            kw = dict(mesh=layout.fsdp_mesh, reshard_after_forward=not keep,
                      ignored_params={p for p in model.parameters() if not p.numel()})
            for m in model.modules():
                if isinstance(m, _PreNorm):
                    fully_shard(m, **kw)
            fully_shard(self.stage if keep else model, **kw)
        self.names = {id(p): n for n, p in model.named_parameters()}

    def _block_of(self, name: str) -> int | None:
        """The encoder block a pipelined SiT's parameter belongs to, else
        None (a parameter every stage holds)."""
        if not name.startswith("transformer.layers."):
            return None
        return int(name.split(".")[2])

    def _stage_of(self, name: str) -> int | None:
        i = self._block_of(name)
        return None if i is None else i // (self.model.depth // self.layout.pipe_size)

    # -- gradients --------------------------------------------------------------

    @property
    def grad_scale(self) -> float:
        """What the local loss is multiplied by before backward: FSDP2
        averages gradients over the batch shards, and the step needs their
        sum."""
        return float(self.layout.batch_count) if self.layout.fsdp else 1.0

    def _all_reduce(self, grads, group) -> None:
        """Sum ``grads`` (their local shards) over ``group`` in place, in
        one flat all-reduce."""
        grads = [_local(g) for g in grads]
        if not grads or group is None:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def sync_grads(self, params) -> None:
        """Sum the gradients over the batch shards, in one flat all-reduce
        (FSDP2 reduces its own in backward); then, under sequence sharding,
        those of every parameter but the head's over 'model', and in a
        pipeline those of the parameters every stage holds over 'pipe' (a
        stage that did not use one gives zeros)."""
        lay = self.layout
        if lay.seq:
            self._all_reduce([p.grad for p in params if p.grad is not None
                              and not self.names[id(p)].startswith("mlp_head.")],
                             lay.model_group)
        if lay.pipe:
            shared = [p for p in params if self._block_of(self.names[id(p)]) is None]
            for p in shared:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self._all_reduce([p.grad for p in shared], lay.pipe_group)
        if lay.fsdp:
            return
        self._all_reduce([p.grad for p in params if p.grad is not None], lay.batch_group)

    def grad_sq_norm(self, params) -> torch.Tensor:
        """The squared global norm of the gradients of ``params``: each
        slice counted once. An FSDP2 shard's square sum goes over the FSDP
        group, a TP slice's or a pipeline stage's block's over 'model' or
        'pipe' (an FSDP shard of one first over the FSDP group, then over
        that axis); replicated gradients are taken as they are."""
        lay = self.layout
        dev = params[0].device
        zero = torch.zeros((), device=dev)
        # (replicated, split over 'model' / 'pipe'), each apart for FSDP shards
        plain, sharded = [zero, zero], [zero, zero]
        for p in params:
            g = p.grad
            if g is None:
                continue
            name = self.names.get(id(p))
            part = int(name in self.split or (lay.pipe and self._block_of(name) is not None))
            acc = sharded if isinstance(g, DTensor) else plain
            acc[part] = acc[part] + _local(g).float().square().sum()

        def over(x, group):  # every rank of the group joins, with or without a share
            if group is not None:
                x = x.clone()
                dist.all_reduce(x, group=group)
            return x

        part_group = lay.pipe_group if lay.pipe else lay.model_group if lay.tp else None
        return (plain[0] + over(sharded[0], lay.fsdp_group)
                + over(plain[1] + over(sharded[1], lay.fsdp_group), part_group))

    # -- full state ---------------------------------------------------------------

    def _full(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """A parameter's (or moment's) whole value: its FSDP2 shards
        gathered, then its TP slices."""
        if isinstance(value, DTensor):
            value = value.full_tensor()
        if name in self.split:
            return gather_param(value, name, self.tp, heads_of(self.model, name),
                                dim_head_of(self.model, name))
        return value

    def _local(self, name: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """What this rank holds of a whole value, laid out as ``like``: its TP
        slice, then its FSDP2 shard of that."""
        if name in self.split:
            full = shard_param(full, name, self.tp.size, self.tp.rank,
                               heads_of(self.model, name)).to(like.device)
        if isinstance(like, DTensor):
            # every rank holds the whole value: each keeps its shard, no traffic
            return distribute_tensor(full.to(device=like.device, dtype=like.dtype),
                                     like.device_mesh, like.placements, src_data_rank=None)
        return full

    def _from_stage(self, name: str, local, shape, dtype, device) -> torch.Tensor:
        """A pipelined parameter's value (or moment) whole on every stage:
        broadcast over 'pipe' from the stage that holds it (a collective)."""
        lay = self.layout
        owner = self._stage_of(name)
        t = (local.contiguous() if owner == lay.stage
             else torch.empty(shape, dtype=dtype, device=device))
        dist.broadcast(t, lay.pipe_ranks[owner], group=lay.pipe_group)
        return t

    def full_state_dict(self) -> dict:
        """``model.state_dict()`` as the single process holds it (a
        collective: every rank calls it)."""
        own = {k: self._full(k, v) for k, v in self.model.state_dict().items()}
        if not self.layout.pipe:
            return own
        dev = _local(next(self.model.parameters())).device
        return {k: own[k] if self._stage_of(k) is None else
                self._from_stage(k, own.get(k), shape, dtype, dev)
                for k, (shape, dtype) in self.shapes.items()}

    def load_full_state_dict(self, state: dict) -> None:
        """Load a single-process state dict into the sharded model (a
        pipeline stage its own blocks of it)."""
        own = self.model.state_dict()
        self.model.load_state_dict({k: self._local(k, v, own[k]) if k in own else v
                                    for k, v in state.items() if k in own
                                    or not self.layout.pipe})

    def _param_names(self, optimizer) -> list[str]:
        return [self.names[id(p)] for p in optimizer.params]

    def full_optimizer_state(self, optimizer) -> dict:
        """``optimizer.state_dict()`` with every moment whole (a pipeline's
        in the single process's parameter order)."""
        sd = optimizer.state_dict()
        names = self._param_names(optimizer)
        opt = sd["opt"]
        state = {}
        for i, st in opt["state"].items():
            state[i] = {k: (self._full(names[i], v) if isinstance(v, torch.Tensor)
                            and v.dim() else v) for k, v in st.items()}
        if self.layout.pipe:
            state = self._pipe_state(names, state)
            groups = [{**g, "params": list(range(len(self.full_names)))}
                      for g in opt["param_groups"]]
            opt = {**opt, "param_groups": groups}
        return {**sd, "opt": {**opt, "state": state}}

    def _pipe_state(self, names: list[str], state: dict) -> dict:
        """The moments of every parameter of the whole model, by its index
        in the single process's order, each broadcast from the stage that
        holds it (empty before the first step, as on every stage)."""
        if not state:
            return state
        by_name = {names[i]: st for i, st in state.items()}
        like = next(iter(state.values()))
        dev = _local(next(self.model.parameters())).device
        out = {}
        for j, name in enumerate(self.full_names):
            mine = by_name.get(name)
            shape = self.shapes[name][0]
            out[j] = {k: (self._from_stage(name, None if mine is None else mine[k], shape,
                                           v.dtype, dev)
                          if self._stage_of(name) is not None and v.dim() else
                          (mine or like)[k]) for k, v in like.items()}
        return out

    def load_full_optimizer_state(self, optimizer, sd: dict) -> None:
        names = self._param_names(optimizer)
        opt = sd["opt"]
        if self.layout.pipe:  # the stage's parameters' entries, renumbered
            index = {n: j for j, n in enumerate(self.full_names)}
            pick = [index[n] for n in names]
            opt = {**opt, "state": {i: opt["state"][j] for i, j in enumerate(pick)
                                    if j in opt["state"]},
                   "param_groups": [{**g, "params": list(range(len(names)))}
                                    for g in opt["param_groups"]]}
        state = {}
        for i, st in opt["state"].items():
            p = optimizer.params[int(i)]
            state[i] = {k: (self._local(names[int(i)], v, p) if isinstance(v, torch.Tensor)
                            and v.dim() else v) for k, v in st.items()}
        optimizer.load_state_dict({**sd, "opt": {**opt, "state": state}})
