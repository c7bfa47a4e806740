"""Supervised regression and MPP pretraining (counterpart of
``surface_vision_transformers_tpu.train.trainer.Trainer``), in one process
or under a ('data', 'fsdp', 'model') mesh.

The model holds float32 master parameters on the training device: a ``SiT``
or an ``MSSiT`` for regression, an ``MPP`` around a SiT or an ``MPPMSSiT``
around an MS-SiT for pretraining. Every step runs a forward, a weighted
loss, and the optimizer from ``train.optim``. The route
(``Trainer.uses_fused_train``, the JAX ``_use_fused_train``): bfloat16
compute, no dropout, ``tpu.fused_train`` and no mesh or a pure-DP one take the
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
  ``INT8_MIN_DIM`` on, else bf16 and a notice printed once per trainer);
* ``tpu.debug_nans`` (the JAX package's ``jax_debug_nans``) raises
  ``FloatingPointError`` at the first training step or evaluation batch
  whose computation yields a NaN (not an inf, as in JAX): a step checks its
  loss before the backward and every gradient before the update, so the
  parameters stay as they were; in one process the backward runs under
  ``torch.autograd.detect_anomaly(check_nan=True)``, which names the first
  autograd node (a fused kernel's ``autograd.Function`` too) that returns a
  NaN. Under a mesh each rank checks its own rows and every rank raises
  where any finds a NaN (no anomaly mode there: one rank raising inside a
  backward would leave the others in its collectives). With the key off a
  step adds no check and no host sync.

Under a mesh (``parallel.make_mesh``; every rank builds the same seeded
model and calls every method) a step computes what the single process
computes on the same global batch (the JAX ``Trainer`` under the same
mesh): every rank draws what the single process draws -- the epoch
permutation, MPP's corruption, augmentation,
dropout masks (``DropoutRNG.rows``) -- and keeps its rows of the batch
(``parallel.Layout.batch_index_of``: its share of each microbatch under
``grad_accum``, padded at weight 0 where the shards do not divide it). Each
rank's weighted loss sum is divided by the global weight sum and the
gradients are summed over ('data', 'fsdp'): one flat all-reduce under DP
and TP, FSDP2's reduce-scatter (whose mean the loss's scale undoes) under
FSDP. Pure DP keeps the fused kernels on every rank with replicated
weights; FSDP (``fully_shard``), TP (``parallel.tp``; a SiT's, an
MS-SiT's, and their MPP decoders; fewer heads than ranks too) and sequence
sharding (``tpu.seq_sharding``, ``parallel.seq``: SiT regression and MPP;
an MS-SiT, and MPP around one, takes the TP layout there, as the JAX
package's does) run the modular model. A pipeline (``tpu.mesh_pipe > 1``,
``parallel.pipeline``: SiT regression, no dropout, no ``grad_accum``, no
TP, the JAX refusals and messages) runs the GPipe schedule over the
stages, the modular blocks on each, and evaluates through the schedule's
forward. FSDP composes with each of TP, sequence sharding and a pipeline
(``parallel.sharding``): DP x FSDP x TP from the config alone. Evaluation
runs each rank's rows and gathers the predictions, so the metrics are over
the whole split; ``state_dict`` gathers every parameter and moment whole,
so checkpoints are the single-process format. The attention-dropout
kernel's masks under a mesh differ from the single process's (its seed is
offset by the rank's shard).
"""

from __future__ import annotations

import contextlib
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
from surface_vision_transformers_tpu_torch.parallel import pipeline
from surface_vision_transformers_tpu_torch.parallel.mesh import Layout
from surface_vision_transformers_tpu_torch.parallel.sharding import ShardedModel
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


def _rank_rows(layout: Layout, B: int, device, accum: int = 1):
    """(rows, valid) of a batch of B that this rank holds, as tensors."""
    rows, valid = layout.batch_index_of(B, accum)
    return torch.from_numpy(rows).to(device), torch.from_numpy(valid).to(device)


def raise_on_nan(what: str, tensors, layout: Layout | None = None) -> None:
    """``tpu.debug_nans``: raise ``FloatingPointError`` where any of
    ``tensors`` holds a NaN; under a mesh ``layout``, on every rank where any
    rank's do (one host sync; collectives over the mesh's groups)."""
    flag = torch.stack([torch.isnan(_local(t)).any() for t in tensors]).any().float()
    if layout is not None:
        for group in (layout.batch_group, layout.model_group, layout.pipe_group):
            if group is not None:
                torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX,
                                             group=group)
    if flag.item():
        raise FloatingPointError(f"tpu.debug_nans: invalid value (nan) in {what}")


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t`` (a ``DTensor``'s local shard)."""
    return t.to_local() if hasattr(t, "to_local") else t


@contextlib.contextmanager
def nan_anomaly(enabled: bool, where: str):
    """``torch.autograd.detect_anomaly(check_nan=True)`` over the block where
    ``enabled``; its error (the autograd node that returned a NaN) comes out
    as ``FloatingPointError`` naming ``where``."""
    if not enabled:
        yield
        return
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as e:
        if "nan" not in str(e):
            raise
        raise FloatingPointError(f"tpu.debug_nans: invalid value (nan) in {where}: {e}") from e


@torch.no_grad()
def evaluate_mpp(model: MPP | MPPMSSiT, tokens: torch.Tensor, bs: int,
                 layout: Layout | None = None, debug_nans: bool = False) -> float:
    """The MPP loss over (n, L, patch_dim) ``tokens`` in clamped contiguous
    batches of ``bs``, each with its fixed corruption (``eval_generator``),
    weighted by sample: the modular MPP (or MPPMSSiT), its attention on
    ``flash_attention_qkv`` for CUDA bfloat16. Under a mesh ``layout`` each
    rank runs its rows and the sums are added over the batch shards.
    ``debug_nans``: a batch whose loss is NaN raises ``FloatingPointError``."""
    n = tokens.shape[0]
    bs = min(bs, n)
    w = torch.from_numpy(batch_weights(n, bs)).to(tokens.device)
    loss_sum = 0.0
    for i in range(w.shape[0]):
        s = min(i * bs, n - bs)
        gen = eval_generator(i, tokens.device)
        if layout is None:
            loss, _ = model(tokens[s:s + bs], gen, sample_weights=w[i])
            wb = w[i]
        else:
            rows, valid = _rank_rows(layout, bs, tokens.device)
            wb = w[i][rows] * valid
            loss, _ = model(tokens[s:s + bs].index_select(0, rows), gen, sample_weights=wb,
                            rows=layout.micro_rows(bs))
        if debug_nans:
            raise_on_nan(f"the loss of evaluation batch {i} (rows {s}..{s + bs - 1})",
                         [loss], layout)
        loss_sum = loss_sum + loss * wb.sum()
    if layout is not None:
        loss_sum = layout.all_reduce(torch.as_tensor(loss_sum, device=tokens.device))
    return float(loss_sum) / n


class Trainer:
    """Trains ``model`` (float32 parameters, already on its device): a
    ``SiT`` or an ``MSSiT`` on regression targets, or an ``MPP`` (an
    ``MPPMSSiT``) under an MPP config; under ``mesh`` (a ``DeviceMesh``, or
    a ``parallel.Layout`` over one) laid out on it."""

    def __init__(self, exp: Experiment, model: SiT | MSSiT | MPP | MPPMSSiT,
                 augment: SurfaceAugment | None = None, mesh=None):
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
        self.ema_model = copy.deepcopy(model) if exp.training.ema > 0 else None
        # under a mesh: the model (and its EMA shadow) laid out on it
        self.layout = (mesh if isinstance(mesh, Layout) or mesh is None
                       else Layout(mesh, seq=exp.seq_sharding))
        if self.layout is not None and self.layout.seq and isinstance(self.encoder, MSSiT):
            # the JAX MS-SiT takes the sequence fields and uses them nowhere:
            # under tpu.seq_sharding its parameters get the TP placement
            self.layout = self.layout.tensor_parallel()
        self.mesh = None if mesh is None else self.layout.mesh
        self.sharded = self.ema_sharded = self.handoff = None
        if self.layout is not None and self.layout.pipe:
            pipeline.check_pipeline(exp, self.encoder, self.task, self.layout)
            self.handoff = pipeline.Handoff(self.layout)
        if self.layout is not None:
            self.sharded = ShardedModel(model, self.layout)
            if self.ema_model is not None:
                self.ema_sharded = ShardedModel(self.ema_model, self.layout)
        self.optimizer = Optimizer(exp.optim, model.parameters(),
                                   sq_norm=None if mesh is None else self.sharded.grad_sq_norm)
        seed = exp.training.seed
        self.generator = torch.Generator().manual_seed(seed)  # epoch permutations
        device = next(model.parameters()).device
        self.device = device
        self.corruption = torch.Generator(device=device).manual_seed(seed)
        salt = 0 if self.layout is None else self.layout.seed_salt
        self.rng = (DropoutRNG(seed, device, salt)
                    if self.encoder.dropout or self.encoder.emb_dropout else None)
        self.augment = augment
        # a stream of its own, apart from the epoch permutations' (seed)
        self.augment_rng = torch.Generator().manual_seed((seed << 32) + 7)
        self._token_cache: dict[int, tuple] = {}
        self._quant_noticed = False
        self.debug_nans = exp.debug_nans

    def uses_fused_train(self) -> bool:
        """The fused-block training route: bfloat16 compute, no dropout,
        ``tpu.fused_train``, and no mesh or a pure-DP one (FSDP and TP run
        the modular model). Otherwise the modular model under autograd."""
        return (self.exp.fused_train and self.encoder.dtype == torch.bfloat16
                and self.rng is None and (self.layout is None or self.layout.pure_dp))

    def _fused_batch_ok(self, b: int) -> bool:
        """Under a mesh the fused route takes a (micro)batch the batch
        shards divide (the JAX ``_fused_batch_ok``); another takes the
        modular model."""
        return self.layout is None or b % self.layout.batch_count == 0

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

    def _loss(self, batch, targets, weights, rows=None, fused=None):
        """(weighted mean loss, weighted mean |err|) of a (micro)batch;
        ``rows`` its rows of the global batch under a mesh."""
        fused = self.uses_fused_train() if fused is None else fused
        mssit = isinstance(self.encoder, MSSiT)
        if self.task == "mpp":
            if fused:
                loss = (fused_mssit_mpp_loss if mssit else fused_mpp_loss)(
                    self.model, batch, self.corruption, weights, rows=rows)
            else:
                loss, _ = self.model(batch, self.corruption, rng=self.rng,
                                     sample_weights=weights, rows=rows)
            return loss, loss  # MPP has no MAE; the loss stands in
        if fused:
            preds = (fused_mssit_train_forward if mssit else fused_train_forward)(
                self.model, batch, mesh=self.mesh)
        else:
            preds = self.model(batch, rng=self.rng)
        preds = preds.reshape(preds.shape[0], -1).squeeze(-1)
        loss = self.loss_fn(preds, targets, weights)
        mae = ((preds - targets.reshape(preds.shape)).abs() * weights).sum() / (
            torch.clamp(weights.sum(), min=1e-9))
        return loss, mae

    def optimizer_step(self, batch, targets, weights, total: int | None = None):
        """One optimizer step on a batch (microbatched under grad_accum);
        ``targets`` None under MPP. -> (loss, weighted |err| sum), device
        scalars. Under a mesh ``batch``, ``targets`` and ``weights`` are this
        rank's rows (``Layout.batch_index_of``, weight 0 on padding) of a
        global batch of ``total``, and the results this rank's shares of
        the global batch's (summed over the batch shards by the caller)."""
        if self.layout is not None:
            return self._mesh_step(batch, targets, weights, total)
        if self.augment is not None:
            batch = self.augment(batch, self.augment_rng)
        self.optimizer.zero_grad()
        accum = self.exp.training.grad_accum
        with nan_anomaly(self.debug_nans, f"the backward of step {self.optimizer.count}"):
            if accum <= 1 or batch.shape[0] % accum:
                loss, mae = self._loss(batch, targets, weights)
                self._check_loss(loss)
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
                    self._check_loss(l_k, k)
                    w_k = weights[sl].sum()
                    (l_k * (w_k / w_tot)).backward()
                    loss = loss + l_k.detach() * w_k
                    mae = mae + m_k.detach() * w_k
                loss, mae = loss / w_tot, mae / w_tot
        self._check_grads()
        self.optimizer.step()
        self._update_ema()
        return loss, mae * weights.sum()

    def _check_loss(self, loss, micro: int | None = None) -> None:
        """``tpu.debug_nans``: raise where the (micro)batch's loss is NaN,
        before its backward."""
        if self.debug_nans:
            at = "" if micro is None else f", microbatch {micro}"
            raise_on_nan(f"the training loss of step {self.optimizer.count}{at}", [loss],
                         self.layout)

    def _check_grads(self) -> None:
        """``tpu.debug_nans``: raise where a gradient holds a NaN, before the
        update, naming the first such parameter this rank holds."""
        if not self.debug_nans:
            return
        named = [(n, p.grad) for n, p in self.model.named_parameters() if p.grad is not None]
        grads = [g for _, g in named] or [torch.zeros((), device=self.device)]
        try:  # a rank holding no gradient still joins the check
            raise_on_nan("a gradient", grads, self.layout)
        except FloatingPointError:
            bad = next((n for n, g in named if torch.isnan(_local(g)).any()), None)
            raise FloatingPointError(
                f"tpu.debug_nans: invalid value (nan) in the gradient of "
                f"{bad or 'a parameter another rank holds'} at step {self.optimizer.count}"
            ) from None

    def _update_ema(self) -> None:
        if self.ema_model is not None:
            d = self.exp.training.ema
            with torch.no_grad():
                for e, p in zip(self.ema_model.parameters(), self.model.parameters()):
                    e.copy_(e * d + p * (1.0 - d))

    def _mesh_step(self, batch, targets, weights, total: int):
        """``optimizer_step`` under a mesh: the draws are the global
        batch's; each microbatch's weighted loss sum over the global weight
        sum, its gradients summed over the batch shards."""
        lay = self.layout
        accum = lay.accum_steps(total, self.exp.training.grad_accum)
        if self.augment is not None:
            rows, _ = lay.batch_index_of(total, self.exp.training.grad_accum)
            draws = self.augment.draw(total, self.augment_rng)
            batch = self.augment.apply(batch, draws.take(torch.from_numpy(rows)))
        self.optimizer.zero_grad()
        w_tot = torch.clamp(lay.all_reduce(weights.sum().clone()), min=1e-9)
        if lay.pipe:
            return self._pipe_step(batch, targets, weights, total, w_tot)
        mbs, mbl = total // accum, batch.shape[0] // accum
        rows = lay.micro_rows(mbs)
        fused = self.uses_fused_train() and self._fused_batch_ok(mbs)
        scale = self.sharded.grad_scale
        loss = mae = 0.0
        for k in range(accum):
            sl = slice(k * mbl, (k + 1) * mbl)
            if self.rng is not None:
                self.rng.rows = rows
            l_k, m_k = self._loss(batch[sl], None if targets is None else targets[sl],
                                  weights[sl], rows=rows, fused=fused)
            self._check_loss(l_k, k if accum > 1 else None)
            w_k = weights[sl].sum()
            (l_k * (w_k / w_tot * scale)).backward()
            loss = loss + l_k.detach() * w_k
            mae = mae + m_k.detach() * w_k
        if self.rng is not None:
            self.rng.rows = None
        self.sharded.sync_grads(self.optimizer.params)
        self._check_grads()
        self.optimizer.step()
        self._update_ema()
        return loss / w_tot, mae

    def _pipe_step(self, batch, targets, weights, total: int, w_tot):
        """``_mesh_step`` in a pipeline: the GPipe schedule on this rank's
        rows; the step's shares of the loss and |err| sum, which only the
        last stage computes, handed to every stage."""
        lay = self.layout
        M = pipeline.microbatches(self.exp)
        pipeline.check_batch(total, lay, M)
        loss, mae = pipeline.train_step(self.sharded.stage, lay, self.handoff, batch, targets,
                                        weights, w_tot, M, self.exp.training.l1loss,
                                        self.sharded.grad_scale)
        self.sharded.sync_grads(self.optimizer.params)
        self._check_loss(loss)  # the schedule interleaves forwards and backwards
        self._check_grads()
        self.optimizer.step()
        self._update_ema()
        both = torch.stack([loss, mae])
        torch.distributed.all_reduce(both, group=lay.pipe_group)
        return both[0], both[1]

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
        if self.layout is not None:
            rows, valid = _rank_rows(self.layout, bs, data.device, self.exp.training.grad_accum)
        losses, mae_sums = [], []
        for i in range(w.shape[0]):
            s = min(i * bs, n - bs)
            if self.layout is None:
                loss, mae_sum = self.optimizer_step(
                    data_p[s:s + bs], None if targets_p is None else targets_p[s:s + bs],
                    w[i])
            else:
                loss, mae_sum = self.optimizer_step(
                    data_p.index_select(0, rows + s),
                    None if targets_p is None else targets_p.index_select(0, rows + s),
                    w[i][rows] * valid, total=bs)
            losses.append(loss)
            mae_sums.append(mae_sum)
        return self._epoch_metrics(losses, mae_sums, n)

    def _epoch_metrics(self, losses, mae_sums, n: int) -> EpochMetrics:
        """The epoch's mean step loss and MAE from each step's (shares of)
        loss and |err| sum, added over the batch shards under a mesh."""
        both = torch.stack([torch.stack(losses), torch.stack(mae_sums)])
        if self.layout is not None:
            both = self.layout.all_reduce(both)
        return EpochMetrics(loss=both[0].mean().item(), mae=both[1].sum().item() / n)

    def _predictor(self, model):
        """Regression serving of ``model`` for evaluation: (B, ...) -> (B,)
        predictions through ``fused_forward`` (``fused_mssit_forward`` for
        an MS-SiT; bfloat16, ``serving_quant``), the modular model, or in a
        pipeline the schedule's forward."""
        quant = self.serving_quant(model)
        mssit = isinstance(model, MSSiT)
        forward = fused_mssit_forward if mssit else fused_forward
        if self.layout is not None and self.layout.pipe:
            M = pipeline.microbatches(self.exp)
            stage = (self.ema_sharded if model is self.ema_model else self.sharded).stage
            return lambda xb: pipeline.predict(stage, self.layout, self.handoff, xb, M)
        if not serves_fused(model) or not (self.layout is None or self.layout.pure_dp):
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
            loss = evaluate_mpp(model, self.mpp_tokens(data), bs_val, self.layout,
                                self.debug_nans)
            return EpochMetrics(loss=loss, mae=loss), None
        n = data.shape[0]
        bs = min(bs_val, n)
        w = torch.from_numpy(batch_weights(n, bs)).to(data.device)
        predict = self._predictor(model)
        if self.layout is not None:
            rows, _ = _rank_rows(self.layout, bs, data.device)
        preds, sq_sum, err_sum = [], 0.0, 0.0
        for i in range(w.shape[0]):
            s = min(i * bs, n - bs)
            if self.layout is None:
                p = predict(data[s:s + bs])
            else:  # this rank's rows, then every rank's in order
                p = self.layout.gather_rows(predict(data.index_select(0, rows + s)))[:bs]
            self._check_preds(p, f"{i} (rows {s}..{s + bs - 1})")
            d = p - targets[s:s + bs].reshape(p.shape)
            sq_sum = sq_sum + (d.square() * w[i]).sum()
            err_sum = err_sum + (d.abs() * w[i]).sum()
            preds.append(p)
        preds[-1] = preds[-1][w.shape[0] * bs - n:]  # drop the re-read rows
        flat = torch.cat(preds).cpu().numpy()
        return EpochMetrics(loss=float(sq_sum) / n, mae=float(err_sum) / n), flat

    def _check_preds(self, p, batch: str) -> None:
        """``tpu.debug_nans``: raise where an evaluation batch's predictions
        (every rank's, gathered) hold a NaN."""
        if self.debug_nans:
            raise_on_nan(f"the predictions of evaluation batch {batch}", [p])

    # -- host-streamed splits --------------------------------------------------

    def train_epoch_streaming(self, loader: StreamingLoader) -> EpochMetrics:
        """One epoch over ``loader`` (its order, its weight-0 padding), one
        optimizer step a batch. Metrics are fetched once, at the end."""
        losses, mae_sums = [], []
        for batch, targets, w in loader:
            loss, mae_sum = self.optimizer_step(
                batch, None if self.task == "mpp" else targets, w,
                total=loader.batch_size)
            losses.append(loss)
            mae_sums.append(mae_sum)
        return self._epoch_metrics(losses, mae_sums, loader.num_samples)

    @torch.no_grad()
    def evaluate_streaming(self, loader: StreamingLoader):
        """``evaluate`` over a ``shuffle=False`` loader: the same forward a
        batch, MPP batch i on its fixed corruption; the padding rows weigh 0
        and their predictions are dropped."""
        if loader.shuffle:
            raise ValueError("evaluate_streaming needs a shuffle=False loader")
        model = self.eval_model()
        n = loader.num_samples
        lay = self.layout
        if self.task == "mpp":
            loss_sum = 0.0
            for i, (batch, _, w) in enumerate(loader):
                rows = None if lay is None else lay.micro_rows(loader.batch_size)
                loss, _ = model(batch, eval_generator(i, batch.device), sample_weights=w,
                                rows=rows)
                if self.debug_nans:
                    raise_on_nan(f"the loss of evaluation batch {i}", [loss], lay)
                loss_sum = loss_sum + loss * w.sum()
            if lay is not None:
                loss_sum = lay.all_reduce(torch.as_tensor(loss_sum, device=self.device))
            loss = float(loss_sum) / n
            return EpochMetrics(loss=loss, mae=loss), None
        predict = self._predictor(model)
        preds, sq_sum, err_sum = [], 0.0, 0.0
        bs = loader.batch_size
        for i, (batch, targets, w) in enumerate(loader):
            p = predict(batch)
            if lay is not None:  # every rank's rows, in order
                p, targets, w = lay.gather_rows(
                    torch.stack([p.float(), targets.reshape(p.shape), w], 1))[:bs].unbind(1)
            self._check_preds(p, str(i))
            d = p - targets.reshape(p.shape)
            sq_sum = sq_sum + (d.square() * w).sum()
            err_sum = err_sum + (d.abs() * w).sum()
            preds.append(p.cpu())  # the loader reuses its device buffers
        flat = torch.cat(preds).numpy()[:n]
        return EpochMetrics(loss=float(sq_sum) / n, mae=float(err_sum) / n), flat

    # -- full state ------------------------------------------------------------

    def model_state(self, model=None) -> dict:
        """``model``'s (default the trained model's) state dict as the
        single process holds it: under a mesh gathered whole (a collective:
        every rank calls it)."""
        model = self.model if model is None else model
        if self.layout is None:
            return model.state_dict()
        return (self.ema_sharded if model is self.ema_model else self.sharded).full_state_dict()

    def load_model_state(self, state: dict, model=None) -> None:
        """Load a single-process state dict into ``model`` (default the
        trained model), laid out on the mesh where there is one."""
        model = self.model if model is None else model
        if self.layout is None:
            model.load_state_dict(state)
        else:
            (self.ema_sharded if model is self.ema_model else self.sharded
             ).load_full_state_dict(state)

    def state_dict(self) -> dict:
        """The whole training state, as tensors and numbers that
        ``torch.load(..., weights_only=True)`` reads back; under a mesh
        every parameter and moment whole (the single-process format)."""
        rng = self.rng
        return {
            "model": self.model_state(),
            "optimizer": (self.optimizer.state_dict() if self.layout is None else
                          self.sharded.full_optimizer_state(self.optimizer)),
            "ema": None if self.ema_model is None else self.model_state(self.ema_model),
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
        self.load_model_state(state["model"])
        if self.layout is None:
            self.optimizer.load_state_dict(state["optimizer"])
        else:
            self.sharded.load_full_optimizer_state(self.optimizer, state["optimizer"])
        if self.ema_model is not None:
            # a checkpoint written without ``training.ema`` seeds the shadow
            # from its weights, as the JAX package's restore does
            self.load_model_state(state["ema"] or state["model"], self.ema_model)
        self.generator.set_state(state["generator"])
        self.corruption.set_state(state["corruption"])
        if self.rng is not None and state["dropout"] is not None:
            self.rng.masks.set_state(state["dropout"]["masks"])
            self.rng.seeds.set_state(state["dropout"]["seeds"])
        self.augment_rng.set_state(state["augment"])
