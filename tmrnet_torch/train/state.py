"""The train state: the model, its optimizer, the step count and the
gradient accumulator.

Port of `tmrnet_tpu/train/state.py` with what optax's wrappers around the
optimizer add (`tmrnet_tpu/train/optim.py:122-133`): `step` counts every
micro-step, as JAX's `state.step` does; with `grad_accum` = k the
optimizer steps on every k-th call of `apply_gradients`, on the running
mean of the k micro-batches' gradients (optax.MultiSteps' Welford mean),
and the global-norm clip acts on what reaches the optimizer. The model's
BatchNorm statistics update in its forward, on every micro-step.

With a mesh (`mesh`), the gradients that reach the optimizer are summed
over the data group, once per optimizer step (after the accumulation,
before the clip): a plain all-reduce of the gradients laid end to end
(`parallel/mesh.py::all_reduce_sum_`), a sum and not
DistributedDataParallel's mean, since the loss sums over the global
batch. The clip then sees the global gradient, as JAX's global-view
gradient is clipped. Under tensor parallelism (model_parallel M > 1,
`parallel/tensor.py`) a sliced parameter's gradient is the rank's slice
and is summed over the data group alone; a replicated parameter's
gradient is the same on every rank of a model group up to the rounding
of cuDNN's backward, so it is taken from each model group's first rank:
the others zero theirs and one all-reduce over the world sums them, which
keeps the replicated parameters bit-equal across the model group. The
clip's norm counts each sliced gradient's squares over the model group
and a replicated one once. `whole_state` and `load_whole_state` give the
checkpoints whole tensors (a collective over the model group).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from tmrnet_torch.parallel import tensor as tp
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
        sliced = [tp.shard_of(p) is not None for p in params]
        if self.mesh is not None and any(sliced):
            mesh = self.mesh
            rep = [g for g, s in zip(grads, sliced) if not s]
            if mesh.model_index:
                for g in rep:
                    g.zero_()
            all_reduce_sum_(rep, mesh)
            all_reduce_sum_([g for g, s in zip(grads, sliced) if s], mesh,
                            mesh.data_group)
        elif self.mesh is not None:
            all_reduce_sum_(grads, self.mesh)
        if self.grad_clip > 0:
            clip_by_global_norm_(grads, self.grad_clip, sliced if any(sliced)
                                 else None, self.mesh)
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

    def whole_state(self):
        """(the model's state dict, `state_dict()`) with every tensor of a
        sliced parameter whole: a collective over the model group, which
        every rank calls; the two as they are where nothing is sliced."""
        if not tp.is_sharded(self.model):
            return self.model.state_dict(), self.state_dict()
        params = self.params
        train = self.state_dict()
        train["optimizer"] = tp.whole_optimizer_state(self.optimizer, params)
        if self.acc_grads is not None:
            train["acc_grads"] = [a.cpu() for a in tp.whole_tensors(
                self.acc_grads, params)]
        return tp.whole_model_state(self.model), train

    def load_whole_state(self, model_state: dict, train: dict) -> None:
        """`whole_state`'s two, cut to this rank's slices."""
        params = self.params
        self.model.load_state_dict(tp.slice_model_state(self.model,
                                                        model_state),
                                   strict=True)
        train = dict(train)
        train["optimizer"] = tp.slice_optimizer_state(train["optimizer"],
                                                      params)
        if train["acc_grads"] is not None:
            train["acc_grads"] = tp.slice_tensors(train["acc_grads"], params)
        self.load_state_dict(train)
