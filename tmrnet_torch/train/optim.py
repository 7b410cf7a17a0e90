"""Optimizers, gradient clipping and schedules.

Port of `tmrnet_tpu/train/optim.py`: two learning-rate groups, the slow
one (`slow_modules_for_head`, :60) at lr * trunk_lr_scale and the rest at
lr; SGD with momentum, dampening (the first step undampened), Nesterov and
coupled weight decay, or Adam; StepLR, ReduceLROnPlateau and a constant
rate, set from the host between epochs.

optax's chains (:89-121) are what `torch.optim.SGD` and `torch.optim.Adam`
compute per group: add_decayed_weights + trace(nesterov) or the dampened
trace, then -lr * scale, is torch's SGD (its momentum buffer starts at the
first gradient, as the trace does from zero); add_decayed_weights +
scale_by_adam(0.9, 0.999, 1e-8) is torch's Adam with coupled weight decay.
optax leaves Nesterov out where momentum is 0, torch refuses it, so the
port drops it there. The global-norm clip (`clip_by_global_norm_`) and the
accumulation over micro-batches (optax.MultiSteps) are the train state's
(`train/state.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from tmrnet_torch.config import TrainConfig


def slow_modules_for_head(head: str) -> Sequence[str]:
    """The top-level modules trained at lr * trunk_lr_scale: the backbone
    and the LSTM for the memory heads, the backbone alone otherwise."""
    return (("backbone", "encoder") if head in ("tmr", "nl_only")
            else ("backbone",))


def param_groups(model: torch.nn.Module, slow_modules: Sequence[str]
                 ) -> Dict[str, List[torch.nn.Parameter]]:
    """The model's parameters by group ('slow', 'fast'), in the order of
    `named_parameters`, by their top-level module's name."""
    groups: Dict[str, List[torch.nn.Parameter]] = {"slow": [], "fast": []}
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        groups["slow" if top in slow_modules else "fast"].append(p)
    return groups


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module,
                   slow_modules: Sequence[str] = ("backbone",)
                   ) -> torch.optim.Optimizer:
    """The two-group optimizer of `model`. Each group carries `lr_scale`,
    so `set_learning_rate` sets one base rate for both."""
    if cfg.optimizer == "sgd" and cfg.dampening and cfg.nesterov:
        raise ValueError("nesterov momentum requires zero dampening")
    by_group = param_groups(model, slow_modules)
    groups = [{"params": ps, "lr": cfg.lr * scale, "lr_scale": scale}
              for ps, scale in ((by_group["slow"], cfg.trunk_lr_scale),
                                (by_group["fast"], 1.0))
              if ps]
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(groups, lr=cfg.lr, momentum=cfg.momentum,
                               dampening=cfg.dampening,
                               nesterov=cfg.nesterov and cfg.momentum > 0,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(groups, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float,
                         sliced: Optional[Sequence[bool]] = None,
                         mesh=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: where the global norm |g| of all
    gradients is at least max_norm, every g becomes g / |g| * max_norm
    (torch's clip_grad_norm_ adds 1e-6 to the norm). No host sync. Returns
    the norm. sliced: which gradients are a model group's slices
    (`parallel/tensor.py`, under `mesh`): their squares are summed over
    the model group, a replicated gradient's counted once."""
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    if sliced is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = torch.tensor(list(sliced), device=norms.device)
        squares = norms.square()
        part = torch.where(mask, squares, 0.0).sum()
        dist.all_reduce(part, group=mesh.model_group)
        norm = (torch.where(mask, 0.0, squares).sum() + part).sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The base rate (the last group's, the fast one where there are
    two)."""
    g = optimizer.param_groups[-1]
    return g["lr"] / g["lr_scale"]


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the base rate: each group runs at lr * its lr_scale."""
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_scale"]


@dataclasses.dataclass
class StepSchedule:
    """StepLR: lr = base * gamma^(epoch // step_size)."""

    base_lr: float
    step_size: int
    gamma: float = 0.1

    def __call__(self, epoch: int, _val_metric: float = 0.0) -> float:
        return self.base_lr * (self.gamma ** (epoch // self.step_size))


@dataclasses.dataclass
class PlateauSchedule:
    """ReduceLROnPlateau on the validation loss: lr scaled by `factor`
    after more than `patience` epochs without a relative improvement of
    `threshold`."""

    base_lr: float
    factor: float = 0.1
    patience: int = 2
    threshold: float = 1e-4
    best: float = float("inf")
    bad_epochs: int = 0
    scale: float = 1.0

    def __call__(self, epoch: int, val_metric: float) -> float:
        if val_metric < self.best * (1.0 - self.threshold):
            self.best = val_metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.base_lr * self.scale


def make_schedule(cfg: TrainConfig):
    if cfg.schedule == "step":
        return StepSchedule(cfg.lr, cfg.step_size, cfg.gamma)
    if cfg.schedule == "plateau":
        return PlateauSchedule(cfg.lr, cfg.plateau_factor, cfg.plateau_patience)
    if cfg.schedule == "constant":
        return lambda epoch, val: cfg.lr
    raise ValueError(f"unknown schedule {cfg.schedule!r}")
