"""A SiT's forward through the fused-block kernels, for serving and for
training (an MS-SiT's serving forward is ``models.fused_mssit``, which
builds on this module's weight layout and quant rule).

Counterpart of ``surface_vision_transformers_tpu.models.fused``
(``fused_forward``, ``predict``, ``fused_train_forward``,
``fused_mpp_loss``). In order: patch embed (raw input on CUDA in bf16: the
gather-fused ``ops.patch_embed`` kernel; else plain PyTorch) -> CLS +
positions -> depth-1 x ``fused_block`` (``fused_block_int8`` under
``quant="int8"``) -> ``fused_block_cls`` (CLS pooling, bf16 under either
quant; under mean pooling every block is ``fused_block`` or
``fused_block_int8``) -> float32 LayerNorm and head.
``fused_train_forward`` is the same chain under autograd, with the blocks'
backward on the backward kernels (``ops.fused_block.fused_block_train``).
``fused_mpp_loss`` is the MPP training loss over the same blocks (every one
``fused_block_train``, no CLS block) and a reconstruction head with its own
backward.

Differences from the JAX path, by design:

* The sequence is not padded. The TPU kernels need N % 8 == 0 (321 -> 328
  with keys >= 321 masked); the CUDA kernels mask their ragged edges, so
  they run at N = 321 and skip the 2% of padding rows.
* No on-device micro-batching (``_INFER_MICROBATCH`` / ``lax.map``): it
  answered a TPU compile and scheduling effect, and an eager launch chain
  over a large batch has neither. A batch runs as one chain.
* Weights are prepared once per model (``prepare_weights``): contiguous
  compute-dtype copies in the kernels' layout, the patch-embedding
  normalisation folded in, and under ``quant="int8"`` the int8 codes and
  scales of every int8 block, quantized from the float32 parameters as the
  JAX package quantizes from its uncast tree. Nothing is transposed or
  quantized per forward.
* A width off the kernels' 16-byte rows (dim or mlp_dim off 8, off 16
  where any block is int8) is laid out padded with zeros
  (``serving.svt_ops.pad_dims``): the embedding, CLS token and positions
  write the padded width, every block runs on that stream with its
  LayerNorms counting ``model.dim`` (``ln_dim``), and the stream is
  cropped once before pooling. Serving pads the weights once; training
  pads the masters by a differentiable copy each step, so their gradients,
  state dicts and checkpoints keep the reference shapes.

``resolve_quant`` is the JAX trainer's crossover rule (``_resolve_quant``):
``tpu.quant: int8`` serves int8 from ``INT8_MIN_DIM`` on and bf16, with a
notice, below it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from surface_vision_transformers_tpu_torch.models.mpp import MPP, mpp_target, rows_kw
from surface_vision_transformers_tpu_torch.models.mssit import MSSiT
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.ops.attention import kernel_route
from surface_vision_transformers_tpu_torch.ops.fused_block import (
    _mm32,
    fused_block,
    fused_block_cls,
    fused_block_cls_train,
    fused_block_train,
)
from surface_vision_transformers_tpu_torch.ops.fused_block_int8 import fused_block_int8
from surface_vision_transformers_tpu_torch.ops.patch_embed import (
    embed_matrix,
    patch_embed,
    patch_embed_train,
)
from surface_vision_transformers_tpu_torch.ops.patchify import (
    embed_weights,
    gather_embed,
    rearrange_patched,
)
from surface_vision_transformers_tpu_torch.ops.quant import quantize_block_weights
from surface_vision_transformers_tpu_torch.serving.svt_ops import (
    INT8_ROW_ALIGN,
    ROW_ALIGN,
    pad_dims,
    pad_int8_dims,
    pad_to,
    padded_width,
)

# The JAX package's int8 crossover (``models/fused_mssit.py::INT8_MIN_DIM``),
# kept so that a config means the same in both packages: ``tpu.quant: int8``
# serves int8 from this width on.
INT8_MIN_DIM = 384
QUANTS = (None, "int8")


def resolve_quant(quant: str, dim: int | None, notice: bool = True) -> str | None:
    """``tpu.quant`` with the crossover applied: "none" -> None (bf16);
    "int8" -> "int8" from ``INT8_MIN_DIM`` on (or for any ``dim`` None:
    a model that gates its own stages), else None and, with ``notice``, one
    printed line saying so."""
    if quant == "none":
        return None
    if quant != "int8":
        raise ValueError(f"unknown quant mode {quant!r}")
    if dim is not None and dim < INT8_MIN_DIM:
        if notice:
            print(f"tpu.quant: int8 requested but dim {dim} < INT8_MIN_DIM "
                  f"{INT8_MIN_DIM}: serving bf16 instead", flush=True)
        return None
    return quant


def serves_fused(model) -> bool:
    """Whether ``model`` serves through the kernels (``fused_forward``, or
    ``fused_mssit_forward`` for an MS-SiT): bfloat16 only, as the JAX
    trainer's ``_use_fused_inference`` routes; any other dtype serves
    through the model's own forward."""
    return model.dtype == torch.bfloat16


def serving_quant(model, quant: str, notice: bool = True) -> str | None:
    """``tpu.quant`` for serving ``model`` where it serves fused, else None
    (the model's own forward takes no quant): a SiT under the crossover rule
    (``resolve_quant``); an MS-SiT as it is, since its stages gate
    themselves by width (the JAX ``_resolve_quant``)."""
    if not serves_fused(model):
        return None
    return resolve_quant(quant, None if isinstance(model, MSSiT) else model.dim, notice)


@dataclasses.dataclass(frozen=True)
class FusedWeights:
    """A SiT's parameters laid out for ``fused_forward`` on one device."""

    dtype: torch.dtype
    # the kernel: (int32 (L, V) table, (dim, Kp) weight, float32 bias);
    # plain: (flat vertex ids, (C, V, dim) kernel, bias)
    raw_embed: tuple | None
    embed_kernel: bool  # raw input through ``patch_embed`` (CUDA, bf16)
    patched_embed: tuple  # ((dim, V*C) weight, bias), compute dtype
    cls_token: torch.Tensor
    pos_embedding: torch.Tensor
    # per block: the 11 fused_block parameters, in order; under quant int8
    # the 15 fused_block_int8 parameters for every block but a CLS one; all
    # laid out at the stream's width (``stream_width``)
    blocks: list
    width: int  # the stream's columns: model.dim, or more in a padded layout
    quant: str | None
    head_norm: tuple  # float32 (weight, bias)
    head: tuple  # float32 (weight, bias)


def block_parameters(model: SiT) -> list[tuple]:
    """Per block, the 11 ``fused_block`` parameters of ``model`` in order
    (the module's own tensors, torch layout)."""
    out = []
    for attn, ff in model.transformer.layers:
        a, m = attn.fn, ff.fn
        out.append((attn.norm.weight, attn.norm.bias, a.to_qkv.weight,
                    a.to_out[0].weight, a.to_out[0].bias, ff.norm.weight,
                    ff.norm.bias, m.net[0].weight, m.net[0].bias,
                    m.net[3].weight, m.net[3].bias))
    return out


def int8_block(blk, width: int | None = None) -> tuple:
    """The 15 ``fused_block_int8`` parameters of one block's 11, its four
    matrices quantized from their float32 values; with ``width``, laid out
    for a stream of that many columns and the hidden width rounded up to
    ``INT8_ROW_ALIGN`` (``pad_int8_dims``: zero codes and scales)."""
    (ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2) = blk
    q_qkv, s_qkv, q_out, s_out, q_fc1, s_fc1, q_fc2, s_fc2 = quantize_block_weights(
        w_qkv, w_out, w_fc1, w_fc2)
    out = (vec(ln1_s), vec(ln1_b), q_qkv, s_qkv, q_out, s_out, vec(b_out), vec(ln2_s),
           vec(ln2_b), q_fc1, s_fc1, vec(b_fc1), q_fc2, s_fc2, vec(b_fc2))
    if width is None:
        return out
    return tuple(pad_int8_dims(out, width, padded_width(w_fc1.shape[0], INT8_ROW_ALIGN)))


def block_layout(blk, width: int, dt, align: int = ROW_ALIGN) -> tuple:
    """One block's 11 parameters as the bf16 kernels take them for a stream
    of ``width`` columns: matrices in ``dt``, vectors in float32, padded
    with zeros to the width and the hidden width rounded up to ``align``
    (``pad_dims``), contiguous."""
    p = [mat(t, dt) if t.dim() == 2 else vec(t) for t in blk]
    return tuple(pad_dims(p, width, padded_width(blk[7].shape[0], align)))


def stream_width(dim: int, quant: str | None = None) -> int:
    """The columns a stream of width ``dim`` is laid out in: dim rounded up
    to 8 values (16 where any block runs int8: its rows are int8)."""
    return padded_width(dim, INT8_ROW_ALIGN if quant == "int8" else ROW_ALIGN)


def padded_blocks(blocks, width: int) -> list:
    """Per block, its 11 parameters (any float dtype) padded for a stream of
    ``width`` columns, the hidden width rounded up to 8 (``pad_dims``, a
    differentiable copy where they are off it): the training forwards'
    layout, made each step from the masters."""
    return [pad_dims(blk, width, padded_width(blk[7].shape[0])) for blk in blocks]


def embed_layout(model, lin, embed_kernel: bool | None = None,
                 width: int | None = None) -> tuple:
    """The embedding ``lin`` of ``model`` (a SiT or an MS-SiT) laid out for
    serving: (raw_embed, embed_kernel, patched_embed) as ``FusedWeights``
    holds them, writing ``width`` columns (default the model's; more:
    zero columns past it). Raw input goes through ``patch_embed`` where
    ``embed_kernel`` says (by default where the weight is on CUDA in
    bfloat16)."""
    dt = model.dtype
    if embed_kernel is None:
        embed_kernel = kernel_route("auto", lin.weight, dt)
    weight, bias = lin.weight.detach(), lin.bias.detach()
    if width is not None:
        weight, bias = pad_to(weight, (width, weight.shape[1])), pad_to(bias, (width,))
    raw_embed = None
    if model.patch_table is not None:
        args = (weight.t(), bias, model.patch_table.shape[1])
        stats = dict(means=model.norm_means, stds=model.norm_stds, compute_dtype=dt)
        if embed_kernel:
            raw_embed = (model.patch_index, *embed_matrix(*args, **stats))
        else:
            flat = model.patch_index.reshape(-1).long()
            raw_embed = (flat, *embed_weights(*args, **stats))
    return raw_embed, embed_kernel, (mat(weight, dt), bias.to(dt))


def embed_tokens(x, raw_embed, embed_kernel, patched_embed, dt) -> torch.Tensor:
    """Raw (B, C, G) or pre-patched (B, C, L, V) input -> (B, L, dim) in
    ``dt`` through an ``embed_layout``: the ``patch_embed`` kernel, the
    plain gather, or the linear embedding of the patched tokens."""
    if x.dim() == 3:
        if raw_embed is None:
            raise ValueError("raw (B, C, G) input requires patch_table to be set")
        return (patch_embed if embed_kernel else gather_embed)(x, *raw_embed)
    return F.linear(rearrange_patched(x).to(dt), *patched_embed)


def mat(w, dt) -> torch.Tensor:
    """A matrix as the kernels take it: contiguous, in the compute dtype."""
    return w.detach().to(dt).contiguous()


def vec(v) -> torch.Tensor:
    """A LayerNorm parameter or bias as the kernels take it: contiguous
    float32."""
    return v.detach().float().contiguous()


@torch.no_grad()
def prepare_weights(model: SiT, quant: str | None = None,
                    embed_kernel: bool | None = None) -> FusedWeights:
    """Lay out ``model``'s parameters for ``fused_forward`` on the device
    they are on: matrices in the compute dtype, LayerNorm parameters and
    biases in float32, all contiguous; with ``quant="int8"`` every block but
    a final CLS one as int8 codes and float32 scales. ``embed_kernel``: raw
    input through ``patch_embed`` (default: on CUDA in bfloat16; a serving
    artifact takes it on either device, ``embed_layout``)."""
    if quant not in QUANTS:
        raise ValueError(f"unknown quant mode {quant!r}")
    dt = model.dtype
    width = stream_width(model.dim, quant)
    raw_embed, embed_kernel, patched_embed = embed_layout(model, model.to_patch_embedding[1],
                                                          embed_kernel, width)
    params = block_parameters(model)
    cls_last = model.pool == "cls"
    align = INT8_ROW_ALIGN if quant == "int8" else ROW_ALIGN
    blocks = []
    for i, blk in enumerate(params):
        if quant == "int8" and not (cls_last and i == len(params) - 1):
            blocks.append(int8_block(blk, width))
        else:
            blocks.append(block_layout(blk, width, dt, align))
    pos = model.pos_embedding
    return FusedWeights(
        dtype=dt,
        raw_embed=raw_embed,
        embed_kernel=embed_kernel,
        quant=quant,
        patched_embed=patched_embed,
        cls_token=mat(pad_to(model.cls_token, (1, 1, width)), dt),
        pos_embedding=mat(pad_to(pos, (*pos.shape[:2], width)), dt),
        blocks=blocks,
        width=width,
        head_norm=(vec(model.mlp_head[0].weight), vec(model.mlp_head[0].bias)),
        head=(vec(model.mlp_head[1].weight), vec(model.mlp_head[1].bias)),
    )


def pure_dp(mesh) -> bool:
    """Whether only the 'data' axis of ``mesh`` (a ``DeviceMesh``) is
    nontrivial: weights replicated, the batch split (the JAX package's
    ``_pure_dp``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        return False
    shape = dict(zip(names, mesh.mesh.shape))
    return "data" in shape and all(int(v) == 1 for k, v in shape.items() if k != "data")


def check_mesh(mesh) -> None:
    """The fused paths run under no mesh or a pure-DP one, where each rank
    runs them on its rows with the replicated weights; FSDP and TP meshes
    take the modular model."""
    if mesh is not None and not pure_dp(mesh):
        raise NotImplementedError(
            "fused paths under a mesh require pure DP with the batch divisible by the data "
            "axis; use the modular model")


def fused_forward(
    model: SiT, x: torch.Tensor, weights: FusedWeights | None = None, *,
    mesh=None, quant: str | None = None, scan_blocks: bool = False,
) -> torch.Tensor:
    """Inference forward: raw (B, C, G) or pre-patched (B, C, L, V) input
    -> (B, num_classes) float32. ``weights`` from ``prepare_weights`` with
    the same ``quant`` (prepared here when omitted). ``quant="int8"``: every
    block but a final CLS one is ``fused_block_int8``. On CUDA the
    embedding and every block is a kernel launch; on the CPU they run their
    plain versions."""
    if quant not in QUANTS:
        raise ValueError(f"unknown quant mode {quant!r}")
    check_mesh(mesh)
    if scan_blocks:
        raise NotImplementedError("scan_blocks is not ported")
    w = weights if weights is not None else prepare_weights(model, quant)
    if w.quant != quant:
        raise ValueError(f"weights were prepared for quant={w.quant!r}, not {quant!r}")
    tokens = embed_tokens(x, w.raw_embed, w.embed_kernel, w.patched_embed, w.dtype)
    B, n = tokens.shape[0], tokens.shape[1]
    h = torch.cat([w.cls_token.expand(B, -1, -1), tokens], dim=1)
    h = h + w.pos_embedding[:, : n + 1]
    kw = dict(heads=model.heads, dim_head=model.dim_head, ln_dim=model.dim)
    cls_last = model.pool == "cls"
    for i, blk in enumerate(w.blocks):
        if cls_last and i == len(w.blocks) - 1:
            h = fused_block_cls(h, *blk, **kw)
        elif quant == "int8":
            h = fused_block_int8(h, *blk, **kw)
        else:
            h = fused_block(h, *blk, **kw)
    h = h[..., :model.dim]  # the stream's padded columns, if any
    pooled = h.mean(dim=1) if model.pool == "mean" else h[:, 0]
    out = F.layer_norm(pooled.float(), (model.dim,), *w.head_norm, eps=1e-5)
    return F.linear(out, *w.head)


def fused_train_forward(model: SiT, x: torch.Tensor, *, mesh=None,
                        scan_blocks: bool = False) -> torch.Tensor:
    """Differentiable forward: raw (B, C, G) or pre-patched (B, C, L, V)
    input -> (B, num_classes) float32, with gradients flowing to every
    parameter of ``model`` (the float32 masters; matrices are cast to
    ``model.dtype`` inside each step). The raw-input embedding is
    ``model.embed_patches`` on the kernel route (``patch_embed`` on CUDA in
    bf16, its backward plain); CLS + positions,
    pooling and head are plain PyTorch under autograd; every block is
    ``fused_block_train`` (the last ``fused_block_cls_train`` under CLS
    pooling): kernels forward and backward on CUDA, plain versions on the
    CPU."""
    check_mesh(mesh)
    if scan_blocks:
        raise NotImplementedError("scan_blocks is not ported")
    dt = model.dtype
    lin = model.to_patch_embedding[1]
    if x.dim() == 3:
        if model.patch_table is None:
            raise ValueError("raw (B, C, G) input requires patch_table to be set")
        tokens = model.embed_patches(x, backend="auto")
    else:
        tokens = F.linear(rearrange_patched(x).to(dt), lin.weight.to(dt),
                          lin.bias.to(dt))
    h = model.embed_tokens(tokens)
    width = stream_width(model.dim)
    h = pad_to(h, (*h.shape[:2], width))
    kw = dict(heads=model.heads, dim_head=model.dim_head, ln_dim=model.dim)
    blocks = padded_blocks(block_parameters(model), width)
    for i, blk in enumerate(blocks):
        last_cls = model.pool == "cls" and i == len(blocks) - 1
        h = (fused_block_cls_train if last_cls else fused_block_train)(h, *blk, **kw)
    h = h[..., :model.dim]
    pooled = h.mean(dim=1) if model.pool == "mean" else h[:, 0]
    norm, head = model.mlp_head
    out = F.layer_norm(pooled.float(), (model.dim,), norm.weight.float(),
                       norm.bias.float(), eps=1e-5)
    return F.linear(out, head.weight.float(), head.bias.float())


def _fused_encoder_blocks(model: SiT, h: torch.Tensor) -> torch.Tensor:
    """Every block of ``model`` as ``fused_block_train`` (no CLS block):
    (B, N, dim) -> (B, N, dim) in the compute dtype (on a padded stream
    where the widths ask for one, ``stream_width``)."""
    width = stream_width(model.dim)
    h = pad_to(h, (*h.shape[:2], width))
    kw = dict(heads=model.heads, dim_head=model.dim_head, ln_dim=model.dim)
    for blk in padded_blocks(block_parameters(model), width):
        h = fused_block_train(h, *blk, **kw)
    return h[..., :model.dim]


class _MaskedMSERecon(torch.autograd.Function):
    """sum(maskw * (h W^T + b - target)^2) * inv_denom with h and W rounded
    to the compute dtype ``cdt`` and a float32 product (the JAX package's
    ``_masked_mse_recon``). Autograd of that expression would keep the
    float32 reconstruction residual and run both gradient GEMMs on a float32
    cotangent; this saves only the masked residual in ``cdt`` and feeds the
    gradient GEMMs ``cdt`` operands. In float32 it is autograd's result.
    ``maskw`` holds the 0/1 mask times any 0/1 sample weights."""

    @staticmethod
    def forward(ctx, h, weight, bias, target, maskw, inv_denom, cdt):
        B, L, dim = h.shape
        hd, wd = h.to(cdt).reshape(-1, dim), weight.to(cdt)
        recon = _mm32(hd, wd.t()) + bias.float()
        d = recon - target.float().reshape(recon.shape)
        masked_d = d * maskw.reshape(-1, 1)
        ctx.save_for_backward(hd, wd, masked_d.to(cdt), inv_denom)
        ctx.meta = h.shape, h.dtype, weight.dtype, bias.dtype
        return (masked_d * d).sum() * inv_denom

    @staticmethod
    def backward(ctx, g):
        hd, wd, masked_d, inv_denom = ctx.saved_tensors
        shape, h_dt, w_dt, b_dt = ctx.meta
        gb = 2.0 * g * inv_denom  # d recon = gb * masked_d
        dh = (_mm32(masked_d, wd) * gb).to(h_dt).reshape(shape)
        dw = (_mm32(masked_d.t(), hd) * gb).to(w_dt)
        db = (masked_d.float().sum(0) * gb).to(b_dt)
        return dh, dw, db, None, None, None, None


def fused_mpp_loss(mpp: MPP, batch, generator=None, sample_weights=None, *,
                   corruption=None, rows=None) -> torch.Tensor:
    """The MPP loss of ``mpp.forward`` over the fused-block encoder, for
    training: corruption (from ``generator``, this rank's ``rows`` of the
    global batch's draws under a mesh, or ``corruption`` = (corrupted,
    mask, n_masked) given), the shared embedding, every block
    ``fused_block_train``, the reconstruction head and the masked MSE over
    B * n_masked * patch_dim (B the weight sum under ``sample_weights``), as
    one differentiable scalar. Kernels on CUDA, plain versions on the CPU."""
    enc = mpp.transformer
    dt = enc.dtype
    target = mpp_target(enc, batch)
    corrupted, mask, n_masked = (corruption if corruption is not None
                                 else mpp.corrupt(target, generator, **rows_kw(rows)))
    lin = enc.to_patch_embedding[1]
    tokens = F.linear(corrupted.to(dt), lin.weight.to(dt), lin.bias.to(dt))
    h = _fused_encoder_blocks(enc, enc.embed_tokens(tokens))[:, 1:]
    maskw = mask.float()
    if sample_weights is not None:
        maskw = maskw * sample_weights[:, None]
        batch_count = torch.clamp(sample_weights.sum(), min=1e-9)
    else:
        batch_count = torch.tensor(float(target.shape[0]), device=target.device)
    inv_denom = 1.0 / (batch_count * n_masked * enc.patch_dim)
    head = mpp.to_original
    return _MaskedMSERecon.apply(h, head.weight, head.bias, target, maskw, inv_denom, dt)


def _device(device) -> torch.device:
    """The requested device; a CUDA request without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


@torch.inference_mode()
def predict(model: SiT | MSSiT, data, *, device, batch_size: int = 256,
            quant: str | None = None) -> np.ndarray:
    """Batched serving on ``device``: (S, ...) numpy input -> (S,
    num_classes) numpy float32. Moves ``model`` to ``device`` and runs it
    over batches of ``batch_size``, the ragged last one padded with zeros. A
    bfloat16 model serves through ``fused_forward`` (an MS-SiT through
    ``models.fused_mssit.fused_mssit_forward``), weights prepared once for
    ``quant``; any other dtype through the model's own forward, where
    ``quant`` has no effect: the JAX ``predict`` and trainer route by dtype
    the same way. Kernels run where ``device`` is CUDA; a CPU device runs
    the plain versions. Asking for CUDA where there is none raises."""
    if quant not in QUANTS:
        raise ValueError(f"unknown quant mode {quant!r}")
    dev = _device(device)
    model.to(dev)
    fused = serves_fused(model)
    forward, w = fused_forward, None
    if fused and isinstance(model, MSSiT):
        # fused_mssit builds on this module, so it is imported here
        from surface_vision_transformers_tpu_torch.models import fused_mssit

        forward, w = (fused_mssit.fused_mssit_forward,
                      fused_mssit.prepare_mssit_weights(model, quant))
    elif fused:
        w = prepare_weights(model, quant)
    n = data.shape[0]
    outs = []
    for s in range(0, n, batch_size):
        chunk = np.asarray(data[s: s + batch_size], dtype=np.float32)
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad, *chunk.shape[1:]), np.float32)])
        x = torch.from_numpy(chunk).to(dev)
        with torch.no_grad():
            out = forward(model, x, w, quant=quant) if fused else model(x)
        outs.append(out.cpu().numpy()[: batch_size - pad])
    return np.concatenate(outs, axis=0)
