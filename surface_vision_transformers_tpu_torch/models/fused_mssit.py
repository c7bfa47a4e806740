"""An MS-SiT's forward through the block kernels, for serving and for
training (regression and masked-window pretraining).

Counterpart of ``surface_vision_transformers_tpu.models.fused_mssit``
(``fused_mssit_forward``, ``fused_mssit_train_forward``,
``fused_mssit_mpp_loss``). Everything in a pre-norm block but attention is
token-local, and MS-SiT's attention is local to a token group, so a
windowed block on (B, T, dim) is a plain block on the groups folded into
the batch (``models.mssit.fold_tokens``): per stage, each block folds,
runs ``fused_block`` (``fused_block_int8`` where ``quant="int8"`` and the
stage is at least ``models.fused.INT8_MIN_DIM`` wide) and unfolds. The
embedding is the SiT path's (``patch_embed`` for raw input on CUDA in
bf16); the merges between stages (reshape, float32 LayerNorm, bias-free
matmul) and the head (float32 LayerNorm, mean, Linear) stay plain torch, as
the JAX package leaves them to XLA. The training forwards run the same
folds with every block ``fused_block_train`` (the training forward keeping
its activations, the backward ``fused_block_bwd``, both at dh 32), and the
embedding, merges and head under autograd.

At ``mssit_scan_age.yml`` (ico 6, sub-ico 5, dims 96 / 192 / 384 / 768,
heads 3 / 6 / 12 / 24, window 64, ``global_max`` 512, axial cross-mixing)
every block runs at head dim 32: a batch of 64 surfaces launches one
``patch_embed`` and twelve ``fused_block`` (four, and eight
``fused_block_int8``, under int8) on folds of (20,480, 64, 96), (4,096,
320, 96), (5,120, 64, 192), (4,096, 80, 192), (1,280, 64, 384), (4,096, 20,
384) and (64, 320, 768); a training step adds twelve ``fused_block_bwd``
(every fold takes the chain route: ``ops.fused_block.uses_recompute`` is
false at N <= 320 and dim <= 768), and MPP (``mssit_mpp.yml``) embeds the
corrupted tokens with a plain product, so it launches no ``patch_embed``.

A stage whose width is off the kernels' 16-byte rows (``embed_dim`` off 8,
or a hidden width ``int(dim * mlp_ratio)`` off 8; off 16 in an int8 stage)
runs on a padded stream, as ``models.fused`` lays a SiT out: padded at the
stage's entry (stage 0's embedding and positions write it), its blocks'
LayerNorms counting the stage's dim, cropped at its exit, before the
merge.

Differences from the JAX path, by design: the folded groups are not padded
to N % 8 (the kernels mask their ragged edges; the axial fold of stage 2
runs at N = 20, not 24), and the weights are prepared once for serving
(``prepare_mssit_weights``), as ``models.fused.prepare_weights`` does for
a SiT (training casts the float32 masters inside each block, as
``fused_block_train`` does). Meshes and ``scan_blocks`` (a TPU
compile-time knob) raise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from surface_vision_transformers_tpu_torch.models import fused
from surface_vision_transformers_tpu_torch.models.fused import (
    QUANTS,
    _MaskedMSERecon,
    block_layout,
    embed_layout,
    embed_tokens,
    int8_block,
    mat,
    padded_blocks,
    stream_width,
    vec,
)
from surface_vision_transformers_tpu_torch.models.mpp import rows_kw
from surface_vision_transformers_tpu_torch.models.mpp_mssit import (
    MPPMSSiT,
    corruption_window,
)
from surface_vision_transformers_tpu_torch.models.mssit import (
    MSSiT,
    fold_tokens,
    stage_plan,
    unfold_tokens,
)
from surface_vision_transformers_tpu_torch.ops.fused_block import (
    _Linear32,
    fused_block,
    fused_block_train,
)
from surface_vision_transformers_tpu_torch.ops.fused_block_int8 import fused_block_int8
from surface_vision_transformers_tpu_torch.serving.svt_ops import pad_to


@dataclasses.dataclass(frozen=True)
class StageWeights:
    """One stage's parameters laid out for the block kernels."""

    quant: str | None  # "int8" where the stage's blocks run fused_block_int8
    # per block: the 11 fused_block parameters, or the 15 fused_block_int8
    # ones, laid out for the stage's stream of ``width`` columns
    blocks: list
    width: int  # the stage's dim, or more in a padded layout (``stream_width``)
    merge: tuple | None  # float32 LayerNorm (weight, bias), reduce weight; None last


@dataclasses.dataclass(frozen=True)
class MSSiTWeights:
    """An MS-SiT's parameters laid out for ``fused_mssit_forward`` on one
    device."""

    dtype: torch.dtype
    quant: str | None
    raw_embed: tuple | None  # as models.fused.FusedWeights
    embed_kernel: bool
    patched_embed: tuple
    pos_embedding: torch.Tensor
    stages: list  # StageWeights per stage
    head_norm: tuple  # float32 (weight, bias)
    head: tuple  # float32 (weight, bias)


def block_parameters(stage) -> list[tuple]:
    """Per block of an MS-SiT stage, its 11 ``fused_block`` parameters in
    order (the module's own tensors, torch layout)."""
    return [(attn.norm.weight, attn.norm.bias, attn.fn.to_qkv.weight, attn.fn.to_out.weight,
             attn.fn.to_out.bias, ff.norm.weight, ff.norm.bias, ff.fn.net[0].weight,
             ff.fn.net[0].bias, ff.fn.net[3].weight, ff.fn.net[3].bias)
            for attn, ff in stage.blocks]


@torch.no_grad()
def prepare_mssit_weights(model: MSSiT, quant: str | None = None,
                          embed_kernel: bool | None = None) -> MSSiTWeights:
    """Lay out ``model``'s parameters for ``fused_mssit_forward`` on the
    device they are on: matrices in the compute dtype, LayerNorm parameters
    and biases in float32; with ``quant="int8"`` the blocks of every stage at
    least ``INT8_MIN_DIM`` wide as int8 codes and float32 scales (read when
    the weights are prepared). ``embed_kernel`` as in
    ``models.fused.prepare_weights``."""
    if quant not in QUANTS:
        raise ValueError(f"unknown quant mode {quant!r}")
    dt = model.dtype
    stages = []
    for st, stage in zip(stage_plan(model), model.stages):
        q = quant if quant and st["dim"] >= fused.INT8_MIN_DIM else None
        width = stream_width(st["dim"], q)
        blocks = [int8_block(blk, width) if q else block_layout(blk, width, dt)
                  for blk in block_parameters(stage)]
        mg = stage.merge
        merge = (None if mg is None else
                 (vec(mg.norm.weight), vec(mg.norm.bias), mat(mg.reduce.weight, dt)))
        stages.append(StageWeights(quant=q, blocks=blocks, merge=merge, width=width))
    # the embedding and positions write stage 0's stream
    raw_embed, embed_kernel, patched_embed = embed_layout(model, model.patch_embedding,
                                                          embed_kernel, stages[0].width)
    pos = model.pos_embedding
    return MSSiTWeights(
        dtype=dt, quant=quant, raw_embed=raw_embed, embed_kernel=embed_kernel,
        patched_embed=patched_embed,
        pos_embedding=mat(pad_to(pos, (*pos.shape[:-1], stages[0].width)), dt),
        stages=stages, head_norm=(vec(model.head_norm.weight), vec(model.head_norm.bias)),
        head=(vec(model.head.weight), vec(model.head.bias)))


def _unported(mesh, scan_blocks) -> None:
    fused.check_mesh(mesh)
    if scan_blocks:
        raise NotImplementedError("scan_blocks is not ported")


def fused_mssit_forward(model: MSSiT, x: torch.Tensor, weights: MSSiTWeights | None = None,
                        *, quant: str | None = None, mesh=None,
                        scan_blocks: bool = False) -> torch.Tensor:
    """Inference forward: raw (B, C, G), pre-patched (B, C, T0, V) or
    flattened (B, T0, C*V) input -> (B, num_classes) float32. ``weights``
    from ``prepare_mssit_weights`` with the same ``quant`` (prepared here
    when omitted). On CUDA the embedding and every block is a kernel launch;
    on the CPU they run their plain versions."""
    if quant not in QUANTS:
        raise ValueError(f"unknown quant mode {quant!r}")
    _unported(mesh, scan_blocks)
    w = weights if weights is not None else prepare_mssit_weights(model, quant)
    if w.quant != quant:
        raise ValueError(f"weights were prepared for quant={w.quant!r}, not {quant!r}")
    if x.dim() == 3 and x.shape[-1] == model.patch_dim:  # flattened patch tokens
        tokens = F.linear(x.to(w.dtype), *w.patched_embed)
    else:
        tokens = embed_tokens(x, w.raw_embed, w.embed_kernel, w.patched_embed, w.dtype)
    h = tokens + w.pos_embedding
    for st, sw in zip(stage_plan(model), w.stages):
        B, T, dim = h.shape[0], h.shape[1], st["dim"]
        kw = dict(heads=st["heads"], dim_head=dim // st["heads"], ln_dim=dim)
        block = fused_block_int8 if sw.quant else fused_block
        h = pad_to(h, (B, T, sw.width))  # the stage's stream (stage 0's: embedded so)
        for mix, blk in zip(st["mixes"], sw.blocks):
            folded = fold_tokens(h, st["window"], mix)
            out = block(folded, *blk, **kw)
            h = out if folded is h else unfold_tokens(out, B, T, st["window"], mix)
        h = h[..., :dim]
        if sw.merge is not None:
            ln_w, ln_b, reduce = sw.merge
            y = F.layer_norm(h.reshape(B, T // 4, 4 * dim).float(), (4 * dim,), ln_w, ln_b,
                             eps=1e-5)
            h = F.linear(y.to(w.dtype), reduce)
    pooled = F.layer_norm(h.float(), (h.shape[-1],), *w.head_norm, eps=1e-5).mean(dim=1)
    return F.linear(pooled, *w.head)


def _train_stages(model: MSSiT, h: torch.Tensor) -> torch.Tensor:
    """Embedded tokens (B, T0, embed_dim) -> the final stage's tokens, every
    block ``fused_block_train`` on its folds (the JAX ``_stages(train=True)``
    without padding), the merges plain under autograd."""
    for st, stage in zip(stage_plan(model), model.stages):
        B, T, dim = h.shape
        kw = dict(heads=st["heads"], dim_head=dim // st["heads"], ln_dim=dim)
        width = stream_width(dim)  # a padded stream where the widths ask for one
        h = pad_to(h, (B, T, width))
        for mix, blk in zip(st["mixes"], padded_blocks(block_parameters(stage), width)):
            folded = fold_tokens(h, st["window"], mix)
            out = fused_block_train(folded, *blk, **kw)
            h = out if folded is h else unfold_tokens(out, B, T, st["window"], mix)
        h = h[..., :dim]
        if stage.merge is not None:
            h = stage.merge(h)
    return h


def fused_mssit_train_forward(model: MSSiT, x: torch.Tensor, *, mesh=None,
                              scan_blocks: bool = False) -> torch.Tensor:
    """Differentiable forward: raw (B, C, G), pre-patched or flattened input
    -> (B, num_classes) float32, gradients flowing to every parameter of
    ``model`` (the float32 masters, cast to ``model.dtype`` inside each
    block). The embedding is ``model.embed`` on the kernel route (raw input
    on CUDA in bf16: the ``patch_embed`` kernel, its backward plain); every
    block is ``fused_block_train`` (kernels forward and backward on CUDA,
    plain versions on the CPU); merges and head are plain PyTorch under
    autograd."""
    _unported(mesh, scan_blocks)
    return model.head_forward(_train_stages(model, model.embed(x, backend="auto")))


def fused_mssit_mpp_loss(mpp: MPPMSSiT, batch, generator=None, sample_weights=None, *,
                         corruption=None, mesh=None, scan_blocks: bool = False,
                         rows=None):
    """The masked-window MPP loss of ``mpp.forward`` over the fused-block
    encoder, for training (the JAX ``fused_mssit_mpp_loss``): the
    corruption (from ``generator``, or ``corruption`` = (corrupted, mask,
    n_masked) given), the shared embedding of the corrupted tokens, every
    block ``fused_block_train``, the decoder and the masked MSE over B *
    n_masked * W * patch_dim (B the weight sum under ``sample_weights``), as
    one differentiable scalar. Where the corruption window W is a multiple
    of ``up`` (the finest tokens under a final-stage token; at the shipped
    config W = up = 64) the mask is constant on each final-stage token and
    the loss runs through ``models.fused._MaskedMSERecon``, with its own
    backward; else the plain expression under autograd."""
    _unported(mesh, scan_blocks)
    enc = mpp.encoder
    dt, P = enc.dtype, enc.patch_dim
    target = mpp.target(batch)
    W = corruption_window(enc)
    corrupted, mask, n_masked = (corruption if corruption is not None
                                 else mpp.corrupt(target, generator, **rows_kw(rows)))
    feats = _train_stages(enc, enc.embed(corrupted))
    B, T_last = feats.shape[:2]
    up = enc.num_patches // T_last
    maskw = mask.float()
    if sample_weights is not None:
        maskw = maskw * sample_weights[:, None]
        batch_count = torch.clamp(sample_weights.sum(), min=1e-9)
    else:
        batch_count = torch.tensor(float(B), device=target.device)
    inv_denom = 1.0 / (batch_count * n_masked * W * P)
    head = mpp.to_original
    if W % up == 0:
        return _MaskedMSERecon.apply(feats, head.weight, head.bias,
                                     target.reshape(B, T_last, up * P),
                                     maskw.reshape(B, T_last, up)[:, :, 0], inv_denom, dt)
    recon = (_Linear32.apply(feats, head.weight, dt) + head.bias.float()).reshape(
        B, enc.num_patches, P)
    return ((recon - target.float()).square() * maskw[:, :, None]).sum() * inv_denom
