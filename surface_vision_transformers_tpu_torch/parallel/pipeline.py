"""Pipeline parallelism: GPipe over the mesh's 'pipe' axis (counterpart of
``surface_vision_transformers_tpu.parallel.pipeline``).

The encoder's ``depth`` blocks split into ``S`` contiguous stages of
``depth / S`` blocks; stage s lives on the rank at 'pipe' coordinate s and
holds only its own blocks (``ShardedModel`` drops the rest). The embedding,
positions, CLS token and head are held on every stage; stage 0 runs the
embedding (the ``patch_embed`` kernel on raw CUDA bfloat16 input), the
last stage the head, and their gradients are summed over 'pipe' (the JAX
package's replicated ``other`` tree), so every stage updates them alike.

A step splits the rank's rows of the batch into M microbatches
(``tpu.pipe_microbatches``, 0: one a stage) and runs all M forwards, then
all M backwards, in reverse order (fill, then drain: GPipe). Activations go
to the next stage and their gradients come back through ``Handoff``,
point-to-point sends between neighbours. Each stage runs one microbatch
through ``Stage``, one module (the embedding on stage 0, its blocks as the
modular model runs them, with ``flash_attention_qkv`` on CUDA bfloat16, as
the JAX pipeline runs its ``_block_modules``, and the head on the last).
The loss is the JAX ``pipeline_loss``'s: the last stage's weighted sums of
squared and absolute errors over the global weight sum (the batch shards'
total). Evaluation runs the same schedule's forward and hands the last
stage's predictions to every stage.

Under FSDP ('fsdp' > 1 beside 'pipe', a batch axis as in the JAX package)
FSDP2 shards a stage over the ranks at its 'pipe' coordinate: its blocks a
unit each, the ``Stage`` the root unit of the rest. A step unshards each
unit once, at its first microbatch's forward, and keeps it whole until the
last backward; the gradients of the first M - 1 backwards accumulate
unsharded, and the last reduce-scatters them once
(``set_requires_gradient_sync``). Once a step rather than once a
microbatch: the sum is the same and the traffic M times smaller; the
single process, too, adds the microbatches' gradients before the update.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from surface_vision_transformers_tpu_torch.parallel.mesh import Layout


def microbatches(exp) -> int:
    """``tpu.pipe_microbatches``, 0 meaning one a stage."""
    return exp.pipe_microbatches or exp.mesh_pipe


def check_pipeline(exp, encoder, task: str, layout: Layout) -> None:
    """The JAX ``Trainer``'s refusals of a pipelined run, with its
    messages (``ValueError``)."""
    from surface_vision_transformers_tpu_torch.models.sit import SiT

    S = layout.pipe_size
    if task == "mpp":
        raise ValueError(
            "pipeline parallelism (tpu.mesh_pipe > 1) supports "
            "supervised training only; MPP's corruption/recon head "
            "is not stage-sharded")
    if not isinstance(encoder, SiT):
        raise ValueError(
            "pipeline parallelism is implemented for the SiT family "
            "(uniform block stack); MS-SiT's per-stage shapes differ")
    if encoder.dropout or encoder.emb_dropout:
        raise ValueError(
            "pipeline parallelism requires dropout 0 (the staged "
            "schedule is deterministic)")
    if encoder.depth % S:
        raise ValueError(f"depth {encoder.depth} not divisible by mesh_pipe={S}")
    if exp.training.grad_accum > 1:
        raise ValueError(
            "training.grad_accum > 1 with pipeline parallelism is "
            "redundant — tune tpu.pipe_microbatches instead (the "
            "GPipe schedule already microbatches each step)")
    if layout.model_size != 1:
        raise ValueError("pipeline parallelism does not compose with TP here")


def check_batch(B: int, layout: Layout, M: int) -> None:
    """The JAX ``pipeline_loss``'s refusal of a batch of B rows that the
    data shards and the microbatches do not divide."""
    nb = layout.batch_count
    if B % (nb * M):
        raise ValueError(f"batch {B} must divide into data_shards({nb}) x microbatches({M})")


def stage_blocks(depth: int, layout: Layout) -> range:
    """The block indices the rank's stage holds."""
    per = depth // layout.pipe_size
    return range(layout.stage * per, (layout.stage + 1) * per)


class Handoff:
    """Point-to-point transport between this stage and its neighbours in
    its pipeline. Under gloo a CUDA tensor goes through a pinned host
    buffer: gloo's ``send`` / ``recv`` fail on CUDA tensors (``writev``:
    Bad address, ``scripts/gloo_cuda_probe.py`` on an H100), where its
    collectives carry them. Under NCCL a tensor goes as it is. The choice
    is made by the backend's name."""

    def __init__(self, layout: Layout):
        self.ranks, self.stage = layout.pipe_ranks, layout.stage
        self.host = dist.get_backend(layout.pipe_group) == "gloo"

    def send(self, t: torch.Tensor, stage: int) -> None:
        t = t.detach().contiguous()
        if self.host and t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            t = buf
        dist.send(t, self.ranks[stage])

    def recv(self, shape, dtype, device, stage: int) -> torch.Tensor:
        on_host = self.host and torch.device(device).type == "cuda"
        buf = torch.empty(shape, dtype=dtype, device="cpu" if on_host else device,
                          pin_memory=on_host)
        dist.recv(buf, self.ranks[stage])
        return buf.to(device, non_blocking=True) if on_host else buf


class Stage(torch.nn.Module):
    """This rank's stage of a pipelined SiT as one module: ``forward`` runs
    a microbatch through it -- raw or patched input embedded on stage 0,
    an activation (mb, N, dim) handed on elsewhere -- and returns the
    activation to hand on, or on the last stage the predictions (mb,)
    float32. FSDP2's root unit under FSDP."""

    def __init__(self, model, layout: Layout):
        super().__init__()
        self.model = model
        self.blocks = stage_blocks(model.depth, layout)
        self.first, self.last = layout.stage == 0, layout.stage == layout.pipe_size - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        model = self.model
        h = model.embed(x) if self.first else x
        for i in self.blocks:  # as ``_Transformer.forward`` runs them
            attn, ff = model.transformer.layers[i]
            h = h + attn(h)
            h = h + ff(h)
        return model.pool_head(h).reshape(h.shape[0], -1).squeeze(-1) if self.last else h


def _fsdp(stage: Stage) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(stage, FSDPModule)


def _forward(stage: Stage, layout: Layout, handoff: Handoff, x: torch.Tensor, mb: int):
    """One microbatch's forward on this stage: -> (the stage's input, its
    output; on the last stage the predictions (mb,) float32)."""
    S, s = layout.pipe_size, layout.stage
    model = stage.model
    h_in = x
    if s > 0:
        shape = (mb, model.num_patches + 1, model.dim)
        h_in = handoff.recv(shape, model.dtype, x.device, s - 1)
        h_in.requires_grad_(torch.is_grad_enabled())
    out = stage(h_in)
    if s < S - 1:
        handoff.send(out, s + 1)
    return h_in, out


def train_step(stage: Stage, layout: Layout, handoff: Handoff, batch, targets, weights, w_tot,
               M: int, l1: bool, scale: float = 1.0):
    """The GPipe schedule of one step on this rank's rows: every
    microbatch's forward, then every backward (last microbatch first); the
    gradients of the stage's blocks and its share of the shared parameters
    are left in ``.grad`` (under FSDP reduce-scattered once, after the last
    backward; ``scale`` multiplies the loss, as ``ShardedModel.grad_scale``
    asks). -> (this rank's share of the step's loss, of its weighted |err|
    sum), nonzero on the last stage only."""
    S, s = layout.pipe_size, layout.stage
    B = batch.shape[0]
    mb = B // M
    fsdp = _fsdp(stage)
    saved, sq, ab = [], [], []
    for j in range(M):
        sl = slice(j * mb, (j + 1) * mb)
        h_in, out = _forward(stage, layout, handoff, batch[sl], mb)
        if s == S - 1:
            d = out - targets[sl].reshape(out.shape)
            w = weights[sl]
            sq.append((d.square() * w).sum())
            ab.append((d.abs() * w).sum())
        saved.append((h_in, out))
    for j in reversed(range(M)):
        h_in, out = saved[j]
        if fsdp:  # reduce, and reshard, after the last backward only
            stage.set_is_last_backward(j == 0)
            stage.set_reshard_after_backward(j == 0)
            stage.set_requires_gradient_sync(j == 0)
        if s == S - 1:
            ((ab[j] if l1 else sq[j]) / w_tot * scale).backward()
        else:
            g = handoff.recv(out.shape, out.dtype, out.device, s + 1)
            torch.autograd.backward(out, g)
        if s > 0:
            handoff.send(h_in.grad, s - 1)
        saved[j] = None
    if s < S - 1:
        zero = torch.zeros((), device=batch.device)
        return zero, zero.clone()
    sq_sum, ab_sum = torch.stack(sq).sum(), torch.stack(ab).sum()
    return (ab_sum if l1 else sq_sum).detach() / w_tot, ab_sum.detach()


@torch.no_grad()
def predict(stage: Stage, layout: Layout, handoff: Handoff, batch, M: int) -> torch.Tensor:
    """The schedule's forward on this rank's rows (M microbatches where
    they divide the rows, else one) -> the predictions (B,) float32 on every
    stage (broadcast from the last). Under FSDP every unit is back to its
    shard after."""
    B = batch.shape[0]
    M = M if B % M == 0 else 1
    mb = B // M
    outs = [_forward(stage, layout, handoff, batch[j * mb:(j + 1) * mb], mb)[1]
            for j in range(M)]
    if _fsdp(stage):
        from torch.distributed.fsdp import FSDPModule

        for m in stage.modules():
            if isinstance(m, FSDPModule):
                m.reshard()
    last = layout.pipe_size - 1
    preds = (torch.cat(outs).float().contiguous() if layout.stage == last
             else torch.empty(B, dtype=torch.float32, device=batch.device))
    dist.broadcast(preds, layout.pipe_ranks[last], group=layout.pipe_group)
    return preds
