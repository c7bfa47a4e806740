"""Supervised regression training (the regression subset of
``surface_vision_transformers_tpu.train.trainer.Trainer``).

The model holds float32 master parameters on the training device; every
step runs ``models.fused.fused_train_forward`` (bf16 compute, the block
kernels forward and backward on CUDA), a weighted loss, and the optimizer
from ``train.optim``. As in the JAX package:

* an epoch permutes the device-resident dataset once (here from a
  ``torch.Generator`` seeded by ``training.seed``), then reads contiguous
  batches; batch i starts at min(i*bs, n-bs), so the last one re-reads rows
  of the one before and gives them weight 0 (``batch_weights``);
* ``training.grad_accum`` splits a step into microbatches whose gradients
  are combined in proportion to their weight sums (exact for the weighted
  means);
* ``training.ema`` keeps an exponential moving average of the weights that
  evaluation uses.

Not ported here (they raise): MPP pretraining, meshes and pipelines,
augmentation, dropout > 0 (it runs the modular attention path).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch

from surface_vision_transformers_tpu_torch.models.fused import (
    fused_forward,
    fused_train_forward,
    prepare_weights,
)
from surface_vision_transformers_tpu_torch.models.sit import SiT
from surface_vision_transformers_tpu_torch.train.losses import get_loss_fn
from surface_vision_transformers_tpu_torch.train.optim import Optimizer
from surface_vision_transformers_tpu_torch.utils.config import Experiment


@dataclasses.dataclass
class EpochMetrics:
    loss: float
    mae: float

    def as_dict(self) -> dict:
        return {"loss": self.loss, "mae": self.mae}


def batch_weights(n: int, bs: int) -> np.ndarray:
    """(steps, bs) float32 sample weights for clamped contiguous batching:
    batch i reads rows [min(i*bs, n-bs), +bs), so the last batch's first
    steps*bs - n rows repeat rows already seen and weigh 0."""
    steps = math.ceil(n / bs)
    w = np.ones((steps, bs), np.float32)
    w[-1, : steps * bs - n] = 0.0
    return w


class Trainer:
    """Trains ``model`` (a ``SiT`` with float32 parameters, already on its
    device) on regression targets per ``exp``."""

    def __init__(self, exp: Experiment, model: SiT):
        if exp.is_pretraining:
            raise NotImplementedError("MPP pretraining is not ported yet")
        if exp.augment:
            raise NotImplementedError("augmentation is not ported yet")
        if exp.model.dropout or exp.model.emb_dropout:
            raise NotImplementedError(
                "dropout > 0 runs the modular attention path, not ported yet")
        if model.num_classes != 1:
            raise NotImplementedError("the trainer covers scalar regression only")
        self.exp = exp
        self.model = model
        self.loss_fn = get_loss_fn(exp.training.l1loss)
        self.optimizer = Optimizer(exp.optim, model.parameters())
        self.ema_model = copy.deepcopy(model) if exp.training.ema > 0 else None
        self.generator = torch.Generator().manual_seed(exp.training.seed)

    def eval_model(self) -> SiT:
        """The weights evaluation uses: the EMA shadow when enabled."""
        return self.ema_model if self.ema_model is not None else self.model

    def _loss(self, batch, targets, weights):
        preds = fused_train_forward(self.model, batch)
        preds = preds.reshape(preds.shape[0], -1).squeeze(-1)
        loss = self.loss_fn(preds, targets, weights)
        mae = ((preds - targets.reshape(preds.shape)).abs() * weights).sum() / (
            torch.clamp(weights.sum(), min=1e-9))
        return loss, mae

    def optimizer_step(self, batch, targets, weights):
        """One optimizer step on a batch (microbatched under grad_accum).
        -> (loss, weighted |err| sum), device scalars."""
        self.optimizer.zero_grad()
        accum = self.exp.training.grad_accum
        if accum <= 1 or batch.shape[0] % accum:
            loss, mae = self._loss(batch, targets, weights)
            loss.backward()
            loss, mae = loss.detach(), mae.detach()
        else:
            mbs = batch.shape[0] // accum
            w_tot = torch.clamp(weights.sum(), min=1e-9)
            loss = mae = 0.0
            for k in range(accum):
                sl = slice(k * mbs, (k + 1) * mbs)
                l_k, m_k = self._loss(batch[sl], targets[sl], weights[sl])
                w_k = weights[sl].sum()
                (l_k * (w_k / w_tot)).backward()
                loss = loss + l_k.detach() * w_k
                mae = mae + m_k.detach() * w_k
            loss, mae = loss / w_tot, mae / w_tot
        self.optimizer.step()
        if self.ema_model is not None:
            d = self.exp.training.ema
            with torch.no_grad():
                for e, p in zip(self.ema_model.parameters(), self.model.parameters()):
                    e.copy_(e * d + p * (1.0 - d))
        return loss, mae * weights.sum()

    def train_epoch(self, data: torch.Tensor, targets: torch.Tensor) -> EpochMetrics:
        """One pass over ``data`` (on the training device) in a fresh
        permutation. Metrics are fetched from the device once, at the end."""
        n = data.shape[0]
        bs = min(self.exp.training.bs, n)
        perm = torch.randperm(n, generator=self.generator).to(data.device)
        data_p, targets_p = data[perm], targets[perm]
        w = torch.from_numpy(batch_weights(n, bs)).to(data.device)
        losses, mae_sums = [], []
        for i in range(w.shape[0]):
            s = min(i * bs, n - bs)
            loss, mae_sum = self.optimizer_step(data_p[s:s + bs], targets_p[s:s + bs], w[i])
            losses.append(loss)
            mae_sums.append(mae_sum)
        loss = torch.stack(losses).mean().item()
        return EpochMetrics(loss=loss, mae=torch.stack(mae_sums).sum().item() / n)

    @torch.no_grad()
    def evaluate(self, data: torch.Tensor, targets: torch.Tensor):
        """The whole split at ``training.bs_val`` (0 -> ``bs``) through
        ``fused_forward``. -> (EpochMetrics with the MSE as loss,
        predictions in row order as numpy)."""
        model = self.eval_model()
        weights = prepare_weights(model)
        n = data.shape[0]
        bs = min(self.exp.training.bs_val or self.exp.training.bs, n)
        w = torch.from_numpy(batch_weights(n, bs)).to(data.device)
        preds, sq_sum, err_sum = [], 0.0, 0.0
        for i in range(w.shape[0]):
            s = min(i * bs, n - bs)
            p = fused_forward(model, data[s:s + bs], weights)
            p = p.reshape(p.shape[0], -1).squeeze(-1)
            d = p - targets[s:s + bs].reshape(p.shape)
            sq_sum = sq_sum + (d.square() * w[i]).sum()
            err_sum = err_sum + (d.abs() * w[i]).sum()
            preds.append(p)
        preds[-1] = preds[-1][w.shape[0] * bs - n:]  # drop the re-read rows
        flat = torch.cat(preds).cpu().numpy()
        return EpochMetrics(loss=float(sq_sum) / n, mae=float(err_sum) / n), flat
