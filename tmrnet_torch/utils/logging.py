"""Metric logging and timers.

Port of `tmrnet_tpu/utils/logging.py` (`MetricLogger` :18-139, `Timer`
:142-151): a line on stdout per call, a `metrics.jsonl` under the log
directory, TensorBoard scalars where `torch.utils.tensorboard` imports
(:36-44), sample frames as images and a confusion matrix per epoch.
Under data parallelism over processes (`torch.distributed` initialized
before the logger is made, as the CLI does), every rank computes the same
numbers and rank 0 alone writes files; each rank still prints its lines
unless quiet, as JAX's processes do (:20-31).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 use_tensorboard: bool = True, quiet: bool = False):
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_rank() != 0:
            log_dir = None      # one writer of metrics.jsonl and the events
        self.log_dir = log_dir
        self.quiet = quiet
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(log_dir)
                except Exception:
                    self._tb = None

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        flat = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        if not self.quiet:
            body = " ".join(f"{k}={v:.6g}" for k, v in flat.items())
            print(f"[step {step}] {body}", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **flat}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)

    def log_images(self, step: int, tag: str, images) -> None:
        """Frames (N, H, W, 3), uint8, float in [0, 1] or normalized float
        (min-max rescaled), to TensorBoard and as one PNG strip under
        <log_dir>/images/ (where PIL imports). Nothing without a log_dir."""
        if self.log_dir is None:
            return
        arr = np.asarray(images)
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
            lo, hi = float(arr.min()), float(arr.max())
            if lo < 0.0 or hi > 1.0:
                arr = (arr - lo) / max(hi - lo, 1e-9)
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        if self._tb is not None:
            self._tb.add_images(tag, arr, step, dataformats="NHWC")
        try:
            from PIL import Image

            img_dir = os.path.join(self.log_dir, "images")
            os.makedirs(img_dir, exist_ok=True)
            strip = arr.transpose(1, 0, 2, 3).reshape(
                arr.shape[1], arr.shape[0] * arr.shape[2], arr.shape[3])
            safe = tag.replace("/", "_")
            Image.fromarray(strip).save(
                os.path.join(img_dir, f"{safe}_{step:08d}.png"))
        except ImportError:
            pass

    def log_confusion_matrix(self, step: int, labels, preds,
                             num_classes: int, tag: str = "confusion") -> None:
        """The confusion matrix (pairs out of range, such as the -1 of
        padding, dropped) to the JSONL, and row-normalized as an image."""
        labels = np.asarray(labels).ravel()
        preds = np.asarray(preds).ravel()
        ok = ((labels >= 0) & (labels < num_classes)
              & (preds >= 0) & (preds < num_classes))
        cm = np.zeros((num_classes, num_classes), np.int64)
        np.add.at(cm, (labels[ok], preds[ok]), 1)
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"step": step, tag: cm.tolist()}) + "\n")
            self._jsonl.flush()
        row = cm.astype(np.float64)
        row /= np.maximum(row.sum(axis=1, keepdims=True), 1)
        img = (row * 255).astype("uint8")[..., None].repeat(3, axis=-1)
        img = img.repeat(16, axis=0).repeat(16, axis=1)
        self.log_images(step, tag, img[None])

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


class Timer:
    """Wall-clock timer with a frames/s count."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.frames = 0

    def add_frames(self, n: int) -> None:
        self.frames += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def fps(self) -> float:
        return self.frames / max(self.elapsed, 1e-9)
