"""Losses: class-weighted cross entropy on the clip's last frame.

Port of `tmrnet_tpu/train/losses.py` (:17-63): sklearn's 'balanced' class
weights (numpy, copied) and the weighted CE, summed by default, that the
reference scores on the last frame of each clip. Negative labels mark batch
padding: they add no loss and no weight.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def balanced_class_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """w_c = n_samples / (n_classes_present * count_c), as sklearn's
    compute_class_weight('balanced'); a class absent from the data weighs
    0 (it adds no loss anyway)."""
    labels = np.asarray(labels).ravel()
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    n_present = int((counts > 0).sum())
    with np.errstate(divide="ignore"):
        w = labels.size / (max(n_present, 1) * counts)
    w[~np.isfinite(w)] = 0.0
    return w.astype(np.float32)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           reduction: str = "sum",
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """CE over (..., num_classes) logits in f32 with per-class weights.
    'sum' is torch's CrossEntropyLoss(weight=, reduction='sum'); 'mean' the
    weighted mean (sum / the sum of the sample weights); 'none' per sample;
    'weight' the sum of the sample weights alone (what 'mean' divides by).
    Label smoothing mixes the one-hot target with the uniform one."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    onehot = F.one_hot(safe.long(), num_classes).float()
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    per_sample = -(onehot * logp).sum(dim=-1) * valid.float()
    if class_weights is not None:
        w = class_weights.to(per_sample)[safe.long()] * valid.float()
        per_sample = per_sample * w
    else:
        w = valid.float()
    if reduction == "sum":
        return per_sample.sum()
    if reduction == "mean":
        return per_sample.sum() / torch.clamp(w.sum(), min=1e-12)
    if reduction == "weight":
        return w.sum()
    if reduction == "none":
        return per_sample
    raise ValueError(f"unknown reduction {reduction!r}")
