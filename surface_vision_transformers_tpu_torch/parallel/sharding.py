"""A model and its training state on a mesh: placement (tensor
parallelism on 'model', FSDP2 on 'fsdp'), the gradient sum over the batch
shards, the clip norm, and full state dicts gathered for checkpoints and
laid out again on load, so the files are the single-process format and a
run saved under one mesh resumes under another or under none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from surface_vision_transformers_tpu_torch.parallel.mesh import Layout
from surface_vision_transformers_tpu_torch.parallel.tp import (
    TPGroup,
    apply_tensor_parallel,
    gather_param,
    heads_of,
    shard_param,
)


class ShardedModel:
    """How one model lies on a mesh: ``split`` {parameter name: dim} of
    its tensor-parallel slices; FSDP2 holds every parameter as a DTensor."""

    def __init__(self, model: torch.nn.Module, layout: Layout):
        from surface_vision_transformers_tpu_torch.models.mssit import MSSiT
        from surface_vision_transformers_tpu_torch.models.sit import _PreNorm

        self.model, self.layout = model, layout
        self.tp = (TPGroup(layout.model_group, layout.model_size, layout.model_index)
                   if layout.tp else None)
        self.split: dict[str, int] = {}
        if layout.tp and layout.fsdp:
            raise NotImplementedError(
                "FSDP and tensor parallelism together (tpu.mesh_fsdp > 1 with "
                "tpu.mesh_model > 1) are not ported yet")
        if self.tp is not None:
            if any(isinstance(m, MSSiT) for m in model.modules()):
                raise NotImplementedError(
                    "MS-SiT under tensor parallelism (tpu.mesh_model > 1) is not ported yet")
            self.split = apply_tensor_parallel(model, self.tp)
        if layout.fsdp:
            from torch.distributed.fsdp import fully_shard

            mesh = layout.mesh
            sub = mesh["fsdp"] if layout.shape["data"] == 1 else mesh["data", "fsdp"]
            for m in model.modules():  # a unit a pre-norm branch, then the rest
                if isinstance(m, _PreNorm):
                    fully_shard(m, mesh=sub)
            fully_shard(model, mesh=sub)
        self.names = {id(p): n for n, p in model.named_parameters()}

    # -- gradients --------------------------------------------------------------

    @property
    def grad_scale(self) -> float:
        """What the local loss is multiplied by before backward: FSDP2
        averages gradients over the batch shards, and the step needs their
        sum."""
        return float(self.layout.batch_count) if self.layout.fsdp else 1.0

    def sync_grads(self, params) -> None:
        """Sum the gradients over the batch shards, in one flat all-reduce
        (FSDP2 reduces its own in backward)."""
        if self.layout.batch_group is None or self.layout.fsdp:
            return
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.layout.all_reduce(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def grad_sq_norm(self, params) -> torch.Tensor:
        """The squared global norm of the gradients of ``params``: each
        slice counted once (FSDP2 shards and TP slices summed over their
        axis, replicated gradients taken as they are)."""
        rep = fsdp = tp = 0.0
        for p in params:
            g = p.grad
            if g is None:
                continue
            if isinstance(g, DTensor):
                fsdp = fsdp + g.to_local().float().square().sum()
            elif self.names.get(id(p)) in self.split:
                tp = tp + g.float().square().sum()
            else:
                rep = rep + g.float().square().sum()
        total = rep
        for part, group in ((fsdp, self.layout.mesh.get_group("fsdp") if self.layout.fsdp
                             else None), (tp, self.layout.model_group)):
            if isinstance(part, torch.Tensor) and group is not None:
                part = part.clone()
                dist.all_reduce(part, group=group)
                total = total + part
        return torch.as_tensor(total)

    # -- full state ---------------------------------------------------------------

    def _full(self, name: str, value: torch.Tensor) -> torch.Tensor:
        if isinstance(value, DTensor):
            return value.full_tensor()
        if name in self.split:
            return gather_param(value, name, self.tp, heads_of(self.model, name))
        return value

    def _local(self, name: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if isinstance(like, DTensor):
            # every rank holds the whole value: each keeps its shard, no traffic
            return distribute_tensor(full.to(device=like.device, dtype=like.dtype),
                                     like.device_mesh, like.placements, src_data_rank=None)
        if name in self.split:
            return shard_param(full, name, self.tp.size, self.tp.rank,
                               heads_of(self.model, name)).to(like.device)
        return full

    def full_state_dict(self) -> dict:
        """``model.state_dict()`` as the single process holds it (a
        collective: every rank calls it)."""
        return {k: self._full(k, v) for k, v in self.model.state_dict().items()}

    def load_full_state_dict(self, state: dict) -> None:
        """Load a single-process state dict into the sharded model."""
        own = self.model.state_dict()
        self.model.load_state_dict({k: self._local(k, v, own[k]) if k in own else v
                                    for k, v in state.items()})

    def _param_names(self, optimizer) -> list[str]:
        return [self.names[id(p)] for p in optimizer.params]

    def full_optimizer_state(self, optimizer) -> dict:
        """``optimizer.state_dict()`` with every moment whole."""
        sd = optimizer.state_dict()
        names = self._param_names(optimizer)
        opt = sd["opt"]
        state = {}
        for i, st in opt["state"].items():
            state[i] = {k: (self._full(names[i], v) if isinstance(v, torch.Tensor)
                            and v.dim() else v) for k, v in st.items()}
        return {**sd, "opt": {**opt, "state": state}}

    def load_full_optimizer_state(self, optimizer, sd: dict) -> None:
        names = self._param_names(optimizer)
        opt = sd["opt"]
        state = {}
        for i, st in opt["state"].items():
            p = optimizer.params[int(i)]
            state[i] = {k: (self._local(names[int(i)], v, p) if isinstance(v, torch.Tensor)
                            and v.dim() else v) for k, v in st.items()}
        optimizer.load_state_dict({**sd, "opt": {**opt, "state": state}})
