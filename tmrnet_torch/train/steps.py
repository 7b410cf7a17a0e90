"""Train and eval steps.

Port of `tmrnet_tpu/train/steps.py` (:26-114): a train step is the forward
with `train=True` (BatchNorm on batch statistics, dropout masks from the
step's generator), the class-weighted CE on the clip's last frame, the
backward and the state's optimizer update; an eval step scores without
touching the state. Clips may arrive as uint8 and are prepared on the card
(`DevicePrep`, the uint8 wire of `data.device_normalize`). Metrics stay on
the card until the loop fetches them.

Stage 1: train_step(state, clips, labels, generator), eval_step(state,
clips, labels). Stage 2: the same with the (B, window, hidden) memory after
the clips.

With a mesh (`parallel/mesh.py`), a train step's clips are the rows of
this rank's data index in the global batch: the forward and backward run
inside `batch_shard` (BatchNorm on the global batch's statistics, dropout
masks of the global batch's shape), a 'mean' loss divides by the sample
weights summed over the data group, and the state sums the gradients
(`TrainState.mesh`). Under tensor parallelism the model makes its model
group's collectives itself (`parallel/tensor.py`). Its metrics are this
rank's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tmrnet_torch.parallel.mesh import (DataMesh, all_reduce_sum_,
                                        batch_shard, shard_of)
from tmrnet_torch.train.losses import weighted_cross_entropy
from tmrnet_torch.train.state import TrainState


def _make_steps(class_weights, loss_reduction: str = "sum",
                label_smoothing: float = 0.0,
                prep: Optional[Callable] = None,
                mesh: Optional[DataMesh] = None) -> Tuple[Callable, Callable]:
    weights = {}

    def w_on(device):
        if class_weights is None:
            return None
        if device not in weights:
            weights[device] = torch.as_tensor(
                np.asarray(class_weights, np.float32), device=device)
        return weights[device]

    def forward(state, inputs, labels, train, generator=None):
        clips = inputs[0] if prep is None else prep(inputs[0])
        out = state.model(clips, *inputs[1:], train=train, generator=generator)
        logits = out[:, -1, :] if out.dim() == 3 else out
        w = w_on(logits.device)
        if train and mesh is not None and loss_reduction == "mean":
            # the global batch's weighted mean: this rank's sum over the
            # weights of every rank's samples
            total = weighted_cross_entropy(logits.detach(), labels, w,
                                           "weight")
            all_reduce_sum_([total], mesh, mesh.data_group)
            loss = (weighted_cross_entropy(logits, labels, w, "sum",
                                           label_smoothing)
                    / torch.clamp(total, min=1e-12))
        else:
            loss = weighted_cross_entropy(logits, labels, w, loss_reduction,
                                          label_smoothing)
        return logits, loss, w

    def counts(logits, labels):
        preds = logits.argmax(dim=-1)
        valid = labels >= 0          # negative labels mark batch padding
        return preds, ((preds == labels) & valid).sum(), valid.sum()

    def train_step(state: TrainState, *args) -> Dict[str, torch.Tensor]:
        *inputs, labels, generator = args
        shard = None if mesh is None else shard_of(mesh, labels.shape[0])
        with batch_shard(shard):
            logits, loss, _ = forward(state, inputs, labels, True, generator)
            loss.backward()
        state.apply_gradients()
        _, correct, count = counts(logits.detach(), labels)
        return {"loss": loss.detach(), "correct": correct, "count": count}

    @torch.no_grad()
    def eval_step(state: TrainState, *args) -> Dict[str, torch.Tensor]:
        *inputs, labels = args
        logits, loss, w = forward(state, inputs, labels, False)
        preds, correct, count = counts(logits, labels)
        return {
            "loss": loss,
            # per-sample losses let the loop mask batch padding exactly
            "losses": weighted_cross_entropy(logits, labels, w, "none",
                                             label_smoothing),
            "correct": correct, "count": count, "preds": preds,
            "probs": torch.softmax(logits.float(), dim=-1),
        }

    return train_step, eval_step


def make_stage1_steps(class_weights=None, loss_reduction: str = "sum",
                      label_smoothing: float = 0.0,
                      prep: Optional[Callable] = None,
                      mesh: Optional[DataMesh] = None
                      ) -> Tuple[Callable, Callable]:
    """Steps for MemoryBankModel: train_step(state, clips, labels,
    generator), eval_step(state, clips, labels). prep: the clips' cast and
    normalization on the card (DevicePrep), for the uint8 feed. mesh: the
    data mesh the clips are a rank's rows of (the state's too)."""
    return _make_steps(class_weights, loss_reduction, label_smoothing, prep,
                       mesh)


def make_stage2_steps(class_weights=None, loss_reduction: str = "sum",
                      label_smoothing: float = 0.0,
                      prep: Optional[Callable] = None,
                      mesh: Optional[DataMesh] = None
                      ) -> Tuple[Callable, Callable]:
    """Steps for TMRNet: train_step(state, clips, memory, labels,
    generator), eval_step(state, clips, memory, labels)."""
    return _make_steps(class_weights, loss_reduction, label_smoothing, prep,
                       mesh)
