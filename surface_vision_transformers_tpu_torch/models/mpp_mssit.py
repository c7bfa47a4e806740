"""Masked-window pretraining (MPP) of an MS-SiT, eager PyTorch.

Counterpart of ``surface_vision_transformers_tpu.models.mpp_mssit``
(``corruption_window``, ``corrupt_window_sequence``, ``mssit_target_tokens``,
``MPPMSSiT``). The unit of corruption is a stage-0 window of ``W`` sibling
patches (a contiguous run of finest-grid tokens): exactly ceil(mask_prob *
nW) windows a sample are masked, a swap_prob / (1 - replace_prob) share of
them swapped with a random window of the same sample, a replace_prob share
then replaced by the learned mask token on every row; all masked windows
are scored. The encoder runs on the corrupted finest-grid tokens and
returns its final-stage tokens (``MSSiT.forward(features=True)``); each
stands for ``up = 4**(stages - 1)`` contiguous finest tokens, so one Linear
``dim_last -> up * patch_dim`` and a reshape decode the finest grid, and the
loss is the MSE over the masked tokens, over B * n_masked * W * patch_dim.

Randomness comes from an explicit ``torch.Generator`` on the tokens'
device, drawn in the JAX package's order (mask, swap choice, swap index,
replacement), so the corruption law is the same but not the bits: tests
hand both packages one corruption through ``fixed_mask`` /
``fixed_corrupted``. The reference ships no MS-SiT, so the state dict is
the port's own: ``encoder.*`` (the ``MSSiT`` layout), ``mask_token``,
``to_original.{weight,bias}`` (``checkpoints.convert.
mpp_mssit_state_dict_from_jax`` maps JAX trees onto it). The encoder's
head, which pretraining never runs, stays in the module and out of the JAX
tree. Training runs the fused encoder (``models.fused_mssit.
fused_mssit_mpp_loss``); this module is the modular path (validation,
``run_testing``, dropout, float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surface_vision_transformers_tpu_torch.models.mpp import (
    draw,
    exact_count_mask,
    masked_mse,
    mpp_target,
    rows_kw,
)
from surface_vision_transformers_tpu_torch.models.mssit import MSSiT
from surface_vision_transformers_tpu_torch.models.sit import DropoutRNG
from surface_vision_transformers_tpu_torch.parallel.tp import branch_in, reduce_from

# The JAX package's name for the reconstruction targets: raw (B, C, G)
# input gathered through the encoder's table (and normalised as its
# embedding is), pre-patched (B, C, T, V) or flattened (B, T, C*V) tokens,
# the same branches as a SiT's.
mssit_target_tokens = mpp_target


def corruption_window(model: MSSiT) -> int:
    """The masking granularity: the stage-0 face-hierarchy window (whether
    or not stage-0 attention runs globally)."""
    T = model.num_patches
    w = min(model.window, 4**model.patch_level, T)
    if w < 1 or T % w:
        raise ValueError(f"window {w} does not divide {T} tokens")
    return w


def corrupt_window_sequence(target, mask_token, *, window: int, mask_prob: float,
                            replace_prob: float, swap_prob: float, generator, rows=None):
    """Corrupt (B, T, P) finest-grid patch tokens a window at a time. ->
    (corrupted (B, T, P), mask (B, T) bool, constant on each window,
    n_masked windows a sample). Windows outside the mask are never
    touched. With ``rows`` every draw is the global batch's, cut to the
    rank's rows."""
    B, T, P = target.shape
    W = min(window, T)
    nW, dev = T // W, target.device

    def uniform():
        return draw(lambda s: torch.rand(s, generator=generator, device=dev), (B, nW), rows)

    wmask, n_masked = exact_count_mask(B, nW, mask_prob, generator=generator, device=dev,
                                       rows=rows)
    wins = target.reshape(B, nW, W * P)
    if swap_prob > 0:
        # replace_prob == 1 is reachable; every masked window is replaced then
        swap_rate = swap_prob / max(1.0 - replace_prob, 1e-9)
        swap_sel = wmask & (uniform() < swap_rate)
        rand_idx = draw(lambda s: torch.randint(0, nW, s, generator=generator, device=dev),
                        (B, nW), rows)
        idx = torch.where(swap_sel, rand_idx, torch.arange(nW, device=dev))
        wins = wins.gather(1, idx[:, :, None].expand(B, nW, W * P))
    repl_sel = wmask & (uniform() < replace_prob)
    token = mask_token.reshape(1, 1, P).to(wins.dtype).repeat(1, 1, W)
    corrupted = torch.where(repl_sel[:, :, None], token, wins).reshape(B, T, P)
    return corrupted, wmask.repeat_interleave(W, dim=1), n_masked


def window_mse(recon, target, mask, n_tokens, sample_weights=None):
    """``models.mpp.masked_mse`` over ``n_tokens`` = n_masked * W masked
    tokens a sample; on a given corruption (``n_tokens`` None) with
    ``sample_weights``, the masked tokens counted by their samples' weights,
    as the JAX ``MPPMSSiT`` counts them (the SiT MPP counts the mask
    alone)."""
    if n_tokens is None and sample_weights is not None:
        err = torch.where(mask[:, :, None], (recon - target.float()).square(), 0.0)
        return (err * sample_weights[:, None, None]).sum() / torch.clamp(
            (sample_weights[:, None] * mask).sum() * target.shape[-1], min=1e-9)
    return masked_mse(recon, target, mask, n_tokens, sample_weights)


def window_mse_cols(recon, target, mask, n_tokens, sample_weights, cols):
    """A tensor-parallel rank's share of ``window_mse``: ``recon`` (B,
    T_last, c1 - c0) its columns ``cols`` = (c0, c1) of the decoder's up *
    P outputs a final-stage token, scored against the same columns of the
    target and of the mask, over ``window_mse``'s whole denominator, so the
    ranks' shares add up to the loss."""
    B, T, P = target.shape
    up = T // recon.shape[1]  # finest tokens a final-stage token
    c0, c1 = cols
    tgt = target.reshape(B, -1, up * P)[..., c0:c1]
    m = mask.reshape(B, -1, up).repeat_interleave(P, -1)[..., c0:c1]
    err = torch.where(m, (recon - tgt.float()).square(), 0.0)
    if sample_weights is not None:
        err = err * sample_weights[:, None, None]
    if n_tokens is None and sample_weights is not None:
        den = torch.clamp((sample_weights[:, None] * mask).sum() * P, min=1e-9)
    elif n_tokens is None:
        den = torch.clamp(mask.sum() * P, min=1)
    else:
        count = B if sample_weights is None else torch.clamp(sample_weights.sum(), min=1e-9)
        den = count * n_tokens * P
    return err.sum() / den


class MPPMSSiT(nn.Module):
    """Masked-window pretraining around a (shared) MS-SiT encoder, with the
    call of ``models.mpp.MPP``: ``forward(batch, generator)`` -> (loss,
    reconstruction (B, T0, patch_dim) float32)."""

    def __init__(self, encoder: MSSiT, mask_prob: float = 0.75, replace_prob: float = 0.8,
                 swap_prob: float = 0.02):
        super().__init__()
        self.encoder = encoder
        self.mask_prob, self.replace_prob, self.swap_prob = mask_prob, replace_prob, swap_prob
        up = 4 ** (encoder.num_stages - 1)  # finest tokens per final-stage token
        self.mask_token = nn.Parameter(torch.randn(1, 1, encoder.patch_dim))
        self.to_original = nn.Linear(encoder.stage_dims()[-1], up * encoder.patch_dim)
        self.tp = None  # a ``parallel.tp.TPGroup``: the decoder's outputs split

    def target(self, batch):
        return mssit_target_tokens(self.encoder, batch)

    def corrupt(self, target, generator, rows=None):
        return corrupt_window_sequence(
            target, self.mask_token, window=corruption_window(self.encoder),
            mask_prob=self.mask_prob, replace_prob=self.replace_prob,
            swap_prob=self.swap_prob, generator=generator, **rows_kw(rows))

    def forward(self, batch, generator=None, *, rng: DropoutRNG | None = None,
                fixed_mask=None, fixed_corrupted=None, sample_weights=None, rows=None):
        """``generator`` draws the corruption; ``fixed_mask`` /
        ``fixed_corrupted`` give it instead (the loss then counts the mask);
        ``rng`` turns dropout on."""
        enc = self.encoder
        target = self.target(batch)
        W = corruption_window(enc)
        if fixed_mask is not None:
            mask, corrupted, n_tokens = fixed_mask, fixed_corrupted, None
        else:
            corrupted, mask, n_masked = self.corrupt(target, generator, **rows_kw(rows))
            n_tokens = n_masked * W
        feats = enc(corrupted, rng=rng, features=True)
        tp = self.tp
        if tp is not None:  # the rank's decoder columns; the loss summed over the axis
            recon = branch_in(feats.float(), self.to_original, tp)
            c0, c1, _ = tp.cols(self.to_original.weight.shape[0] * tp.size)
            part = window_mse_cols(recon, target, mask, n_tokens, sample_weights, (c0, c1))
            return reduce_from(part, tp), recon
        recon = F.linear(feats.float(), self.to_original.weight.float(),
                         self.to_original.bias.float())
        recon = recon.reshape(target.shape[0], enc.num_patches, enc.patch_dim)
        return window_mse(recon, target, mask, n_tokens, sample_weights), recon
