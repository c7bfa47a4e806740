"""Supervised regression and MPP pretraining (counterpart of
``surface_vision_transformers_tpu.train.trainer.Trainer`` without meshes).

The model holds float32 master parameters on the training device: a ``SiT``
or an ``MSSiT`` for regression, an ``MPP`` around a SiT or an ``MPPMSSiT``
around an MS-SiT for pretraining. Every step runs a forward, a weighted
loss, and the optimizer from ``train.optim``. The route
(``Trainer.uses_fused_train``, the JAX ``_use_fused_train`` without its mesh
terms): bfloat16 compute, no dropout and ``tpu.fused_train`` take the
fused-block kernels forward and backward (``fused_train_forward``,
``fused_mpp_loss``; for an MS-SiT ``fused_mssit_train_forward``,
``fused_mssit_mpp_loss``); everything else -- float32 compute, dropout > 0,
``tpu.fused_train: false`` -- runs the modular model under autograd, its
attention on the attention kernels (``flash_attention_qkv[_dropout]``) for
CUDA bfloat16 (an MS-SiT under dropout on the plain softmax, as in JAX).
Evaluation of an MS-SiT serves it in bfloat16 through
``fused_mssit_forward``, ``tpu.quant`` handed on as it is (its stages gate
themselves by width). As in the JAX package:

* an epoch permutes the device-resident dataset once (here from a
  ``torch.Generator`` seeded by ``training.seed``), then reads contiguous
  batches; batch i starts at min(i*bs, n-bs), so the last one re-reads rows
  of the one before and gives them weight 0 (``batch_weights``);
* ``training.grad_accum`` splits a step into microbatches whose gradients
  are combined in proportion to their weight sums (exact for the weighted
  means);
* ``training.ema`` keeps an exponential moving average of the weights that
  evaluation uses;
* MPP tokenises a dataset once per run (``mpp_tokens``; under augmentation
  each augmented batch instead), draws each step's corruption from a
  generator seeded by ``training.seed``, evaluates with a fixed corruption
  per batch (a generator seeded from (1234, batch index)), reports the loss
  as its metric, and under ``optimize_decoder: false`` leaves
  ``to_original`` and ``mask_token`` untouched;
* with a ``data.augment.SurfaceAugment``, every training batch (never an
  evaluation batch) is augmented before the model, on both routes, its
  draws from a CPU generator seeded by ``training.seed``;
* ``train_epoch_streaming`` / ``evaluate_streaming`` take a
  ``data.pipeline.StreamingLoader`` over a host-resident split instead of a
  device-resident one;
* ``state_dict`` / ``load_state_dict`` carry the whole training state: the
  model, the optimizer's moments and step, the EMA, and every generator
  (epoch permutations, MPP corruption, dropout, augmentation), so a resumed
  run continues the same trajectory;
* dropout masks and attention-kernel seeds come from a ``DropoutRNG``
  seeded by ``training.seed``;
* regression evaluation in bfloat16 serves through ``fused_forward`` with
  ``tpu.quant`` under the crossover rule (``resolve_quant``: int8 from
  ``INT8_MIN_DIM`` on, else bf16 and a notice printed once per trainer).

Not ported: meshes and pipelines.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch

from surface_vision_transformers_tpu_torch.data.augment import SurfaceAugment
from surface_vision_transformers_tpu_torch.data.pipeline import StreamingLoader
from surface_vision_transformers_tpu_torch.models.fused import (
    fused_forward,
    fused_mpp_loss,
    fused_train_forward,
    prepare_weights,
    serves_fused,
    serving_quant,
)
from surface_vision_transformers_tpu_torch.models.fused_mssit import (
    fused_mssit_forward,
    fused_mssit_mpp_loss,
    fused_mssit_train_forward,
    prepare_mssit_weights,
)
from surface_vision_transformers_tpu_torch.models.mpp import MPP
from surface_vision_transformers_tpu_torch.models.mpp_mssit import MPPMSSiT
from surface_vision_transformers_tpu_torch.models.mssit import MSSiT
from surface_vision_transformers_tpu_torch.models.sit import DropoutRNG, SiT
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


def eval_generator(i: int, device) -> torch.Generator:
    """The fixed corruption of MPP evaluation batch ``i`` (the JAX
    package's fold_in(PRNGKey(1234), i))."""
    return torch.Generator(device=device).manual_seed((1234 << 32) + i)


@torch.no_grad()
def evaluate_mpp(model: MPP | MPPMSSiT, tokens: torch.Tensor, bs: int) -> float:
    """The MPP loss over (n, L, patch_dim) ``tokens`` in clamped contiguous
    batches of ``bs``, each with its fixed corruption (``eval_generator``),
    weighted by sample: the modular MPP (or MPPMSSiT), its attention on
    ``flash_attention_qkv`` for CUDA bfloat16."""
    n = tokens.shape[0]
    bs = min(bs, n)
    w = torch.from_numpy(batch_weights(n, bs)).to(tokens.device)
    loss_sum = 0.0
    for i in range(w.shape[0]):
        s = min(i * bs, n - bs)
        loss, _ = model(tokens[s:s + bs], eval_generator(i, tokens.device),
                        sample_weights=w[i])
        loss_sum = loss_sum + loss * w[i].sum()
    return float(loss_sum) / n


class Trainer:
    """Trains ``model`` (float32 parameters, already on its device): a
    ``SiT`` or an ``MSSiT`` on regression targets, or an ``MPP`` (an
    ``MPPMSSiT``) under an MPP config."""

    def __init__(self, exp: Experiment, model: SiT | MSSiT | MPP | MPPMSSiT,
                 augment: SurfaceAugment | None = None):
        self.task = "mpp" if exp.is_pretraining else "regression"
        if isinstance(model, (MPP, MPPMSSiT)) != (self.task == "mpp"):
            raise TypeError(f"a {self.task} config trains "
                            f"{'an MPP' if self.task == 'mpp' else 'a SiT or an MS-SiT'}, "
                            f"got {type(model).__name__}")
        self.encoder = model.encoder if self.task == "mpp" else model
        if self.task == "regression" and model.num_classes != 1:
            raise NotImplementedError("the trainer covers scalar regression only")
        if self.task == "mpp" and not exp.mpp.optimize_decoder:
            # the reference's optimizer never sees the decoder: no update at all
            for p in (model.to_original.weight, model.to_original.bias, model.mask_token):
                p.requires_grad_(False)
        self.exp = exp
        self.model = model
        self.loss_fn = get_loss_fn(exp.training.l1loss)
        self.optimizer = Optimizer(exp.optim, model.parameters())
        self.ema_model = copy.deepcopy(model) if exp.training.ema > 0 else None
        seed = exp.training.seed
        self.generator = torch.Generator().manual_seed(seed)  # epoch permutations
        device = next(model.parameters()).device
        self.corruption = torch.Generator(device=device).manual_seed(seed)
        self.rng = (DropoutRNG(seed, device)
                    if self.encoder.dropout or self.encoder.emb_dropout else None)
        self.augment = augment
        # a stream of its own, apart from the epoch permutations' (seed)
        self.augment_rng = torch.Generator().manual_seed((seed << 32) + 7)
        self._token_cache: dict[int, tuple] = {}
        self._quant_noticed = False

    def uses_fused_train(self) -> bool:
        """The fused-block training route: bfloat16 compute, no dropout,
        ``tpu.fused_train``. Otherwise the modular model under autograd."""
        return (self.exp.fused_train and self.encoder.dtype == torch.bfloat16
                and self.rng is None)

    def serving_quant(self, model) -> str | None:
        """``tpu.quant`` for evaluating ``model`` (``fused.serving_quant``);
        the notice of a fallback to bf16 is printed once per trainer."""
        notice, self._quant_noticed = not self._quant_noticed, True
        return serving_quant(model, self.exp.quant, notice)

    def eval_model(self) -> SiT | MSSiT | MPP | MPPMSSiT:
        """The weights evaluation uses: the EMA shadow when enabled."""
        return self.ema_model if self.ema_model is not None else self.model

    def mpp_tokens(self, data: torch.Tensor) -> torch.Tensor:
        """MPP: the dataset as reconstruction targets (B, L, patch_dim),
        computed once per dataset tensor; other tasks, and MPP under
        augmentation (each augmented batch is tokenised), get ``data``
        back."""
        if (self.task != "mpp" or self.augment is not None
                or (data.dim() == 3 and data.shape[-1] == self.encoder.patch_dim)):
            return data
        cached = self._token_cache.get(id(data))
        if cached is None or cached[0] is not data:
            cached = (data, self.model.target(data))
            self._token_cache[id(data)] = cached
        return cached[1]

    def _loss(self, batch, targets, weights):
        fused = self.uses_fused_train()
        mssit = isinstance(self.encoder, MSSiT)
        if self.task == "mpp":
            if fused:
                loss = (fused_mssit_mpp_loss if mssit else fused_mpp_loss)(
                    self.model, batch, self.corruption, weights)
            else:
                loss, _ = self.model(batch, self.corruption, rng=self.rng,
                                     sample_weights=weights)
            return loss, loss  # MPP has no MAE; the loss stands in
        if fused:
            preds = (fused_mssit_train_forward if mssit else fused_train_forward)(
                self.model, batch)
        else:
            preds = self.model(batch, rng=self.rng)
        preds = preds.reshape(preds.shape[0], -1).squeeze(-1)
        loss = self.loss_fn(preds, targets, weights)
        mae = ((preds - targets.reshape(preds.shape)).abs() * weights).sum() / (
            torch.clamp(weights.sum(), min=1e-9))
        return loss, mae

    def optimizer_step(self, batch, targets, weights):
        """One optimizer step on a batch (microbatched under grad_accum);
        ``targets`` None under MPP. -> (loss, weighted |err| sum), device
        scalars."""
        if self.augment is not None:
            batch = self.augment(batch, self.augment_rng)
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
                l_k, m_k = self._loss(batch[sl], None if targets is None else targets[sl],
                                      weights[sl])
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

    def train_epoch(self, data: torch.Tensor, targets: torch.Tensor | None = None
                    ) -> EpochMetrics:
        """One pass over ``data`` (on the training device) in a fresh
        permutation. Metrics are fetched from the device once, at the end."""
        data = self.mpp_tokens(data)
        n = data.shape[0]
        bs = min(self.exp.training.bs, n)
        perm = torch.randperm(n, generator=self.generator).to(data.device)
        data_p = data[perm]
        targets_p = None if targets is None else targets[perm]
        w = torch.from_numpy(batch_weights(n, bs)).to(data.device)
        losses, mae_sums = [], []
        for i in range(w.shape[0]):
            s = min(i * bs, n - bs)
            loss, mae_sum = self.optimizer_step(
                data_p[s:s + bs], None if targets_p is None else targets_p[s:s + bs], w[i])
            losses.append(loss)
            mae_sums.append(mae_sum)
        loss = torch.stack(losses).mean().item()
        return EpochMetrics(loss=loss, mae=torch.stack(mae_sums).sum().item() / n)

    def _predictor(self, model):
        """Regression serving of ``model`` for evaluation: (B, ...) -> (B,)
        predictions through ``fused_forward`` (``fused_mssit_forward`` for
        an MS-SiT; bfloat16, ``serving_quant``) or the modular model."""
        quant = self.serving_quant(model)
        mssit = isinstance(model, MSSiT)
        forward = fused_mssit_forward if mssit else fused_forward
        if not serves_fused(model):
            return lambda xb: model(xb).reshape(xb.shape[0], -1).squeeze(-1)
        weights = (prepare_mssit_weights if mssit else prepare_weights)(model, quant)
        return lambda xb: forward(model, xb, weights, quant=quant).reshape(
            xb.shape[0], -1).squeeze(-1)

    @torch.no_grad()
    def evaluate(self, data: torch.Tensor, targets: torch.Tensor | None = None):
        """The whole split at ``training.bs_val`` (0 -> ``bs``). Regression:
        ``_predictor`` -> (EpochMetrics with the MSE as loss, predictions
        in row order as numpy). MPP: the modular MPP on each batch's fixed
        corruption -> (EpochMetrics with the loss as both metrics, None)."""
        model = self.eval_model()
        bs_val = self.exp.training.bs_val or self.exp.training.bs
        if self.task == "mpp":
            loss = evaluate_mpp(model, self.mpp_tokens(data), bs_val)
            return EpochMetrics(loss=loss, mae=loss), None
        n = data.shape[0]
        bs = min(bs_val, n)
        w = torch.from_numpy(batch_weights(n, bs)).to(data.device)
        predict = self._predictor(model)
        preds, sq_sum, err_sum = [], 0.0, 0.0
        for i in range(w.shape[0]):
            s = min(i * bs, n - bs)
            p = predict(data[s:s + bs])
            d = p - targets[s:s + bs].reshape(p.shape)
            sq_sum = sq_sum + (d.square() * w[i]).sum()
            err_sum = err_sum + (d.abs() * w[i]).sum()
            preds.append(p)
        preds[-1] = preds[-1][w.shape[0] * bs - n:]  # drop the re-read rows
        flat = torch.cat(preds).cpu().numpy()
        return EpochMetrics(loss=float(sq_sum) / n, mae=float(err_sum) / n), flat

    # -- host-streamed splits --------------------------------------------------

    def train_epoch_streaming(self, loader: StreamingLoader) -> EpochMetrics:
        """One epoch over ``loader`` (its order, its weight-0 padding), one
        optimizer step a batch. Metrics are fetched once, at the end."""
        losses, mae_sums = [], []
        for batch, targets, w in loader:
            loss, mae_sum = self.optimizer_step(
                batch, None if self.task == "mpp" else targets, w)
            losses.append(loss)
            mae_sums.append(mae_sum)
        loss = torch.stack(losses).mean().item()
        return EpochMetrics(loss=loss, mae=torch.stack(mae_sums).sum().item()
                            / loader.num_samples)

    @torch.no_grad()
    def evaluate_streaming(self, loader: StreamingLoader):
        """``evaluate`` over a ``shuffle=False`` loader: the same forward a
        batch, MPP batch i on its fixed corruption; the padding rows weigh 0
        and their predictions are dropped."""
        if loader.shuffle:
            raise ValueError("evaluate_streaming needs a shuffle=False loader")
        model = self.eval_model()
        n = loader.num_samples
        if self.task == "mpp":
            loss_sum = 0.0
            for i, (batch, _, w) in enumerate(loader):
                loss, _ = model(batch, eval_generator(i, batch.device), sample_weights=w)
                loss_sum = loss_sum + loss * w.sum()
            loss = float(loss_sum) / n
            return EpochMetrics(loss=loss, mae=loss), None
        predict = self._predictor(model)
        preds, sq_sum, err_sum = [], 0.0, 0.0
        for batch, targets, w in loader:
            p = predict(batch)
            d = p - targets.reshape(p.shape)
            sq_sum = sq_sum + (d.square() * w).sum()
            err_sum = err_sum + (d.abs() * w).sum()
            preds.append(p.cpu())  # the loader reuses its device buffers
        flat = torch.cat(preds).numpy()[:n]
        return EpochMetrics(loss=float(sq_sum) / n, mae=float(err_sum) / n), flat

    # -- full state ------------------------------------------------------------

    def state_dict(self) -> dict:
        """The whole training state, as tensors and numbers that
        ``torch.load(..., weights_only=True)`` reads back."""
        rng = self.rng
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "ema": None if self.ema_model is None else self.ema_model.state_dict(),
            "generator": self.generator.get_state(),
            "corruption": self.corruption.get_state(),
            "dropout": None if rng is None else {"masks": rng.masks.get_state(),
                                                 "seeds": rng.seeds.get_state()},
            "augment": self.augment_rng.get_state(),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s output (its tensors may lie on the
        CPU). A checkpoint of a run without EMA or dropout leaves the shadow
        seeded from its weights and the dropout generator fresh."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema_model is not None:
            # a checkpoint written without ``training.ema`` seeds the shadow
            # from its weights, as the JAX package's restore does
            self.ema_model.load_state_dict(state["ema"] or state["model"])
        self.generator.set_state(state["generator"])
        self.corruption.set_state(state["corruption"])
        if self.rng is not None and state["dropout"] is not None:
            self.rng.masks.set_state(state["dropout"]["masks"])
            self.rng.seeds.set_state(state["dropout"]["seeds"])
        self.augment_rng.set_state(state["augment"])
