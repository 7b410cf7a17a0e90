"""Clip-level classification metrics, as the reference trainers' sklearn
report computes them (`train_singlenet_phase_1fc.py:655-658`).

Own copy of `tmrnet_tpu/eval/metrics.py::classification_metrics`
(:376-403), numpy only. The relaxed-boundary protocol scoring (`evaluate`)
comes with the CLI's scoring commands.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def classification_metrics(labels: np.ndarray, preds: np.ndarray,
                           num_classes: int) -> Dict[str, np.ndarray]:
    """Per-class precision, recall and f1, accuracy and the confusion
    matrix; a class never predicted (or never present) scores 0, as
    sklearn's zero_division=0. Labels or predictions outside
    [0, num_classes) raise: a -1 padding label would otherwise wrap to the
    last class."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    for name, arr in (("labels", labels), ("preds", preds)):
        if arr.size and (arr.min() < 0 or arr.max() >= num_classes):
            raise ValueError(f"{name} outside [0, {num_classes}): "
                             f"min={arr.min()} max={arr.max()}")
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels, preds), 1)
    tp = np.diag(cm).astype(np.float64)
    pred_tot = cm.sum(axis=0).astype(np.float64)
    gt_tot = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(pred_tot > 0, tp / pred_tot, 0.0)
        rec = np.where(gt_tot > 0, tp / gt_tot, 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    return {
        "precision": prec,
        "recall": rec,
        "f1": f1,
        "accuracy": float(tp.sum() / max(1, cm.sum())),
        "confusion": cm,
    }
