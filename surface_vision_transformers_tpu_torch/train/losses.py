"""Regression losses with sample weights (counterpart of
``surface_vision_transformers_tpu.train.losses``).

The weights let the last partial batch of an epoch be filled with weight-0
rows instead of dropped, keeping each batch's gradient scale that of the
reference's mean over the true batch.
"""

from __future__ import annotations

import torch


def _weighted_mean(err: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return err.mean()
    weights = weights.reshape(-1)
    return (err * weights).sum() / torch.clamp(weights.sum(), min=1e-9)


def weighted_mse(pred, target, weights=None) -> torch.Tensor:
    return _weighted_mean((pred.reshape(-1) - target.reshape(-1)).square(), weights)


def weighted_l1(pred, target, weights=None) -> torch.Tensor:
    return _weighted_mean((pred.reshape(-1) - target.reshape(-1)).abs(), weights)


def get_loss_fn(l1: bool):
    return weighted_l1 if l1 else weighted_mse
