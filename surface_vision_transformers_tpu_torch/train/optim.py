"""Optimizers and learning-rate schedules (counterpart of
``surface_vision_transformers_tpu.train.optim``, which builds them with
optax).

``torch.optim`` carries the updates, with the optax chain's semantics:
SGD (momentum, nesterov) and Adam take weight decay as L2 added to the
gradient before the moments (optax ``add_decayed_weights`` first, as torch's
own SGD/Adam do), AdamW decays decoupled and scaled by the step's learning
rate. The schedules are optax's formulas as per-step functions: step k (0
for the first update) uses ``schedule(k)``. A global-norm clip of the raw
gradients runs before the update when ``grad_clip > 0``. The parameters
may be DTensors (FSDP2) or tensor-parallel slices: the updates act on each
rank's shard, and the clip's norm comes from ``sq_norm``, which counts
every shard once.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from surface_vision_transformers_tpu_torch.utils.config import OptimConfig


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(step: int) -> float:
        c = min(step, decay_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * decay + alpha)

    return schedule


def build_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Learning rate at each optimizer step, as the JAX package's
    ``build_schedule``."""
    if cfg.schedule == "constant":
        return lambda step: cfg.lr
    if cfg.schedule == "step":
        return lambda step: cfg.lr * cfg.step_decay ** (step // cfg.step_size)
    if cfg.schedule == "cosine":
        return _cosine(cfg.lr, cfg.cosine_t_max, cfg.cosine_eta_min / cfg.lr)
    if cfg.schedule == "warmup_cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, t_max, eta_min)
        warm = cfg.warmup_steps
        alpha = 0.0 if cfg.lr == 0.0 else cfg.cosine_eta_min / cfg.lr
        cos = _cosine(cfg.lr, cfg.cosine_t_max - warm, alpha)
        return lambda step: (cfg.lr * step / warm if step < warm else cos(step - warm))
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


class Optimizer:
    """One optimizer over ``params``: ``step()`` clips (optionally), sets
    this step's learning rate and applies the update to the ``.grad`` of
    every parameter."""

    def __init__(self, cfg: OptimConfig, params, sq_norm=None):
        self.cfg = cfg
        self.params = [p for p in params if p.requires_grad]
        # params -> the squared global gradient norm (sharded parameters)
        self.sq_norm = sq_norm
        self.schedule = build_schedule(cfg)
        self.count = 0
        wd = cfg.weight_decay
        if cfg.name == "SGD":
            self.opt = torch.optim.SGD(
                self.params, lr=cfg.lr, momentum=cfg.momentum, weight_decay=wd,
                nesterov=cfg.nesterov and cfg.momentum > 0)
        elif cfg.name == "Adam":
            self.opt = torch.optim.Adam(self.params, lr=cfg.lr, weight_decay=wd)
        elif cfg.name == "AdamW":
            self.opt = torch.optim.AdamW(self.params, lr=cfg.lr, weight_decay=wd)
        else:
            raise ValueError(f"unknown optimiser {cfg.name!r}")

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def clip(self) -> None:
        """optax.clip_by_global_norm: g -> g / |g| * max where |g| > max."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.sq_norm is None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        else:
            norm = torch.sqrt(self.sq_norm(self.params))
        if norm > self.cfg.grad_clip:
            from torch.distributed.tensor import DTensor

            for g in grads:  # a DTensor's shard in place
                (g.to_local() if isinstance(g, DTensor) else g).div_(norm).mul_(
                    self.cfg.grad_clip)

    def step(self) -> None:
        if self.cfg.grad_clip > 0:
            self.clip()
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        """The step count and the torch optimizer's state (moments)."""
        return {"count": self.count, "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["opt"])
