"""Masked-patch pretraining (MPP), eager PyTorch.

Counterpart of ``surface_vision_transformers_tpu.models.mpp``
(``exact_count_mask``, ``corrupt_sequence``, ``MPP``): BERT-style corruption
of the patch-token sequence -- exactly ceil(mask_prob * L) positions masked
per row, a swap_prob / (1 - replace_prob) share of them swapped with a
random position of the same row, a replace_prob share then replaced by a
learned mask token -- the shared SiT embedding and encoder on the corrupted
sequence, a linear head back to the patches, and the MSE on the masked
positions over the static denominator B * n_masked * patch_dim.

Randomness comes from an explicit ``torch.Generator`` on the tokens'
device. The swap is a plain gather: the JAX package's one-hot GEMM and
``exact_linear_move`` worked around bf16 MXU passes on the TPU, and a gather
moves float32 values exactly on the GPU. The state dict keeps the reference
layout (``transformer.*``, ``to_original.{weight,bias}``, ``mask_token``),
so reference MPP ``.pth`` files load with ``strict=True``. Training runs
the fused encoder (``models.fused.fused_mpp_loss``); this module is the
modular path (validation, ``run_testing``, dropout, float32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from surface_vision_transformers_tpu_torch.models.sit import DropoutRNG, SiT
from surface_vision_transformers_tpu_torch.ops.patchify import (
    normalize_tokens,
    patchify,
    rearrange_patched,
)
from surface_vision_transformers_tpu_torch.parallel.seq import seq_sum
from surface_vision_transformers_tpu_torch.parallel.tp import branch_in, reduce_from


def rows_kw(rows) -> dict:
    """``{'rows': rows}`` under a mesh, else nothing: a single-process
    corruption keeps its call as it was."""
    return {} if rows is None else {"rows": rows}


def draw(fn, shape, rows=None) -> torch.Tensor:
    """``fn(shape)``; with ``rows`` (a ``parallel.Rows``) drawn at the
    global batch's shape and cut to the rank's rows."""
    return fn(shape) if rows is None else rows.draw(fn, shape)


def exact_count_mask(batch: int, seq_len: int, prob: float, *, generator,
                     device=None, rows=None):
    """(batch, seq_len) bool with exactly ceil(prob * seq_len) True per row,
    the positions uniform (the top-k of uniform draws). -> (mask,
    n_masked)."""
    n_masked = math.ceil(prob * seq_len)
    rand = draw(lambda s: torch.rand(s, generator=generator, device=device),
                (batch, seq_len), rows)
    idx = rand.topk(n_masked, dim=1).indices
    mask = torch.zeros((batch, seq_len), dtype=torch.bool, device=device)
    return mask.scatter_(1, idx, True), n_masked


def corrupt_sequence(tokens, mask_token, *, mask_prob: float, replace_prob: float,
                     swap_prob: float, generator, rows=None):
    """Corrupt (B, L, D) patch tokens. -> (corrupted (B, L, D), mask (B, L)
    bool, n_masked). Positions outside the mask are never touched. With
    ``rows`` every draw is the global batch's, cut to the rank's rows."""
    B, L, D = tokens.shape
    dev = tokens.device

    def uniform():
        return draw(lambda s: torch.rand(s, generator=generator, device=dev), (B, L), rows)

    mask, n_masked = exact_count_mask(B, L, mask_prob, generator=generator, device=dev,
                                      rows=rows)
    corrupted = tokens
    if swap_prob > 0:
        # replace_prob == 1 is reachable; every masked token is replaced then
        swap_sel = mask & (uniform() < swap_prob / max(1.0 - replace_prob, 1e-9))
        rand_idx = draw(lambda s: torch.randint(0, L, s, generator=generator, device=dev),
                        (B, L), rows)
        idx = torch.where(swap_sel, rand_idx, torch.arange(L, device=dev))
        corrupted = corrupted.gather(1, idx[:, :, None].expand(B, L, D))
    repl_sel = mask & (uniform() < replace_prob)
    corrupted = torch.where(repl_sel[:, :, None], mask_token.to(corrupted.dtype), corrupted)
    return corrupted, mask, n_masked


def mpp_target(encoder: SiT, batch):
    """The reconstruction target (B, L, patch_dim) of pre-patched (B, C, L,
    V), raw (B, C, G) (gathered through the encoder's table and normalised
    as its embedding is) or already flattened (B, L, patch_dim) input."""
    if batch.dim() == 4:
        return rearrange_patched(batch)
    if batch.dim() == 3 and batch.shape[-1] == encoder.patch_dim:
        return batch
    if batch.dim() == 3:
        if encoder.patch_table is None:
            raise ValueError("raw (B, C, G) input requires the encoder's patch_table")
        target = patchify(batch, encoder.patch_table)
        if encoder.norm_means is not None:
            target = normalize_tokens(target, encoder.norm_means, encoder.norm_stds)
        return target
    raise ValueError(f"bad MPP input shape {tuple(batch.shape)}")


def masked_mse(recon, target, mask, n_masked: int | None, sample_weights=None, *,
               total=None, whole_mask=None):
    """sum over masked positions of (recon - target)^2 / (B n_masked
    patch_dim); with ``sample_weights`` weight-0 samples count for nothing
    and B is their sum. ``n_masked`` None: the mask's own count. Under
    sequence sharding ``recon``, ``target`` and ``mask`` are a rank's rows:
    ``total`` adds the ranks' sums, and ``whole_mask`` is the sequence's
    mask, whose count the denominator takes."""
    err = (recon - target.float()).square()
    masked = torch.where(mask[:, :, None], err, 0.0)
    if sample_weights is not None:
        masked = masked * sample_weights[:, None, None]
        batch_count = torch.clamp(sample_weights.sum(), min=1e-9)
    else:
        batch_count = target.shape[0]
    num = masked.sum() if total is None else total(masked.sum())
    if n_masked is None:
        count = (mask if whole_mask is None else whole_mask).sum()
        return num / torch.clamp(count * target.shape[-1], min=1)
    return num / (batch_count * n_masked * target.shape[-1])


class MPP(nn.Module):
    """MPP around a (shared) SiT encoder. ``forward(batch, generator)`` ->
    (loss, reconstruction (B, L, patch_dim) float32)."""

    def __init__(self, encoder: SiT, mask_prob: float = 0.75, replace_prob: float = 0.8,
                 swap_prob: float = 0.02):
        super().__init__()
        self.transformer = encoder
        self.mask_prob, self.replace_prob, self.swap_prob = mask_prob, replace_prob, swap_prob
        self.mask_token = nn.Parameter(torch.randn(1, 1, encoder.patch_dim))
        self.to_original = nn.Linear(encoder.dim, encoder.patch_dim)
        self.tp = None  # a ``parallel.tp.TPGroup``: the decoder's outputs split

    @property
    def encoder(self) -> SiT:
        return self.transformer

    def target(self, batch):
        return mpp_target(self.transformer, batch)

    def corrupt(self, target, generator, rows=None):
        return corrupt_sequence(target, self.mask_token, mask_prob=self.mask_prob,
                                replace_prob=self.replace_prob, swap_prob=self.swap_prob,
                                generator=generator, **rows_kw(rows))

    def forward(self, batch, generator=None, *, rng: DropoutRNG | None = None,
                fixed_mask=None, fixed_corrupted=None, sample_weights=None, rows=None):
        """``generator`` draws the corruption (``rows``: this rank's rows of
        the global batch's draws); ``fixed_mask`` / ``fixed_corrupted`` give
        it instead (the loss then divides by the mask's own count); ``rng``
        turns dropout on. Under tensor parallelism the loss is whole and the
        reconstruction the rank's columns; under sequence sharding the loss
        is whole and the reconstruction the rank's token rows."""
        enc = self.transformer
        target = self.target(batch)
        if fixed_mask is not None:
            mask, corrupted, n_masked = fixed_mask, fixed_corrupted, None
        else:
            corrupted, mask, n_masked = self.corrupt(target, generator, **rows_kw(rows))
        lin = enc.to_patch_embedding[1]
        tokens = F.linear(corrupted.to(enc.dtype), lin.weight.to(enc.dtype),
                          lin.bias.to(enc.dtype))
        h = enc.encode_tokens(enc.embed_tokens(tokens, rng=rng), rng=rng)
        if enc.sp is not None:
            return self._seq_loss(h, target, mask, n_masked, sample_weights)
        h = h[:, 1:].float()
        tp = self.tp
        if tp is None:
            recon = F.linear(h, self.to_original.weight.float(), self.to_original.bias.float())
            return masked_mse(recon, target, mask, n_masked, sample_weights), recon
        c0, c1, _ = tp.cols(enc.patch_dim)
        recon = branch_in(h, self.to_original, tp)
        part = masked_mse(recon, target[..., c0:c1], mask, n_masked, sample_weights)
        # each rank's share divides by its own D / model columns
        return reduce_from(part, tp) / tp.size, recon

    def _seq_loss(self, h, target, mask, n_masked, sample_weights):
        """The loss under sequence sharding from the rank's rows ``h`` of
        the encoded sequence (CLS at global row 0, the pad rows past L):
        the rank's tokens decoded, their masked squared errors summed and
        added over 'model' (pad rows and CLS contribute nothing), over the
        JAX denominator; every rank ends with the same loss. -> (loss, the
        rank's tokens' reconstruction)."""
        sp = self.transformer.sp
        start, L = sp.rank * h.shape[1], target.shape[1]
        lo, hi = max(start, 1), min(start + h.shape[1], L + 1)  # the rank's token rows
        hi = max(hi, lo)
        recon = F.linear(h[:, lo - start:hi - start].float(), self.to_original.weight.float(),
                         self.to_original.bias.float())
        loss = masked_mse(recon, target[:, lo - 1:hi - 1], mask[:, lo - 1:hi - 1], n_masked,
                          sample_weights, total=lambda x: seq_sum(x, sp), whole_mask=mask)
        return loss, recon
