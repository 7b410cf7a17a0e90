"""The train state: the model, its optimizer, the step count and the
gradient accumulator.

Port of `tmrnet_tpu/train/state.py` with what optax's wrappers around the
optimizer add (`tmrnet_tpu/train/optim.py:122-133`): `step` counts every
micro-step, as JAX's `state.step` does; with `grad_accum` = k the
optimizer steps on every k-th call of `apply_gradients`, on the running
mean of the k micro-batches' gradients (optax.MultiSteps' Welford mean),
and the global-norm clip acts on what reaches the optimizer. The model's
BatchNorm statistics update in its forward, on every micro-step.

With a data mesh (`mesh`), the gradients that reach the optimizer are
summed over the ranks, once per optimizer step (after the accumulation,
before the clip): a plain all-reduce of the gradients laid end to end
(`parallel/mesh.py::all_reduce_sum_`), a sum and not
DistributedDataParallel's mean, since the loss sums over the global
batch. The clip then sees the global gradient, as JAX's global-view
gradient is clipped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from tmrnet_torch.parallel.mesh import DataMesh, all_reduce_sum_
from tmrnet_torch.train.optim import clip_by_global_norm_


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    grad_accum: int = 1
    grad_clip: float = 0.0
    mesh: Optional[DataMesh] = None
    # micro-steps since the last optimizer step, and their mean gradients
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def apply_gradients(self) -> None:
        """After `loss.backward()`: take this micro-batch's gradients (a
        parameter without one counts as zero) into the step."""
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        self.step += 1
        if self.grad_accum > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(p) for p in params]
            for acc, g in zip(self.acc_grads, grads):
                acc.add_((g - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.grad_accum:
                self.optimizer.zero_grad(set_to_none=True)
                return
            grads = self.acc_grads
            self.acc_grads, self.mini_step = None, 0
        if self.mesh is not None:
            all_reduce_sum_(grads, self.mesh)
        if self.grad_clip > 0:
            clip_by_global_norm_(grads, self.grad_clip)
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """Everything but the model's weights: the optimizer's state, the
        step and the accumulator."""
        return {"optimizer": self.optimizer.state_dict(), "step": self.step,
                "mini_step": self.mini_step,
                "acc_grads": (None if self.acc_grads is None else
                              [a.detach().cpu() for a in self.acc_grads])}

    def load_state_dict(self, d: dict) -> None:
        self.optimizer.load_state_dict(d["optimizer"])
        self.step = int(d["step"])
        self.mini_step = int(d["mini_step"])
        dev = self.params[0].device
        self.acc_grads = (None if d["acc_grads"] is None else
                          [a.to(dev) for a in d["acc_grads"]])
