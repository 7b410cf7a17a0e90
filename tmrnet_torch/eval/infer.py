"""Clip inference engine.

Port of `tmrnet_tpu/eval/infer.py` (`memoryless_head` :41-52,
`ClipInference` :65-192). Each batch runs prep -> memory-window gather ->
forward -> f32 softmax -> argmax on the card, with softmax averaging over
crops for multi-crop batches. `run()` takes an iterable of host batches
`(clips_uint8, labels, rows, pad)` and the per-row first-row table
(`FeatureBank.first_rows`); the window rows are computed on the host as in
JAX (:146-154). The dataset and loader come in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.device import resolve_device
from tmrnet_torch.memory.lfb import FeatureBank, memory_window_rows
from tmrnet_torch.models.tmrnet import build_model


def memoryless_head(head: str) -> bool:
    """True for heads scored frame-only, with no feature bank. The 'lfb'
    extractor emits features, not logits, and cannot be scored."""
    if head == "lfb":
        raise ValueError(
            "model.head='lfb' is the feature extractor (emits (B, hidden) "
            "features, not logits) and cannot be scored; use head 'stage1' "
            "for the frame-only baseline or 'tmr'/'nl_only' for memory heads")
    return head not in ("tmr", "nl_only")


@dataclasses.dataclass
class InferenceResult:
    """Per-clip predictions in clip row order."""

    preds: np.ndarray          # (num_clips,) argmax phase ids
    scores: np.ndarray         # (num_clips, num_classes) softmax
    rows: np.ndarray           # (num_clips,) bank rows
    accuracy: float            # clip-level accuracy vs last-frame labels


class ClipInference:
    """Batched clip inference with the memory-window gather on the card.

    state_dict: the model's weights (folded when cfg.model.folded), e.g.
    from `models.convert.from_jax_variables`, loaded with strict=True.
    fused_kernel: "block" or "tiled", the folded identity blocks' kernel
    (`models/tmrnet.py::build_backbone`); the same state dict serves both.
    """

    def __init__(self, cfg: ExperimentConfig,
                 state_dict: Mapping[str, torch.Tensor],
                 bank: Optional[FeatureBank] = None, device="cuda",
                 fused_kernel: str = "block"):
        self.device = resolve_device(device)
        if memoryless_head(cfg.model.head):
            raise ValueError(f"head {cfg.model.head!r} is not ported "
                             f"(tmr, nl_only)")
        if bank is None:
            raise ValueError(
                f"head {cfg.model.head!r} reads the feature bank; pass one")
        if bank.features.device != self.device:
            raise ValueError(f"bank on {bank.features.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.window = cfg.memory.window
        self.model = build_model(cfg.model, self.device, fused_kernel)
        self.model.load_state_dict(dict(state_dict), strict=True)
        self.prep = DevicePrep(cfg.data, cfg.model.compute_dtype, self.device)
        self.bank = bank

    @torch.inference_mode()
    def infer(self, clips: torch.Tensor, idx: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """clips (B, T, H, W, 3) and window rows idx (B, window), both on the
        engine's device -> (argmax (B,), f32 softmax (B, classes))."""
        memory = self.bank.features[idx]
        logits = self.model(self.prep(clips), memory)
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.argmax(dim=-1), probs

    def window_rows(self, rows: np.ndarray, first_rows: np.ndarray) -> np.ndarray:
        return memory_window_rows(rows, first_rows[rows], self.window)

    def run(self, batches: Iterable, first_rows) -> InferenceResult:
        """batches: (clips, labels, rows, pad) host batches; clips uint8
        (B, T, H, W, 3), or (B, ncrops, T, H, W, 3) for multi-crop; the last
        `pad` entries are padding. first_rows: per-row first-row table."""
        if isinstance(first_rows, torch.Tensor):
            first_rows = first_rows.cpu().numpy()
        first_rows = np.asarray(first_rows, np.int64)
        preds_all, scores_all, rows_all, labels_all = [], [], [], []
        for clips, labels, rows, pad in batches:
            rows = np.asarray(rows, np.int64)
            ncrops = 1
            if clips.ndim == 6:
                ncrops = clips.shape[1]
                clips = clips.reshape((-1,) + clips.shape[2:])
            idx = self.window_rows(np.repeat(rows, ncrops), first_rows)
            clips_d = torch.from_numpy(np.ascontiguousarray(clips)).to(self.device)
            _, probs = self.infer(clips_d, torch.from_numpy(idx).to(self.device))
            probs = probs.cpu().numpy()
            if ncrops > 1:
                probs = probs.reshape(len(rows), ncrops, -1).mean(axis=1)
            b = len(rows) - pad
            preds_all.append(np.argmax(probs[:b], axis=-1))
            scores_all.append(probs[:b])
            rows_all.append(rows[:b])
            labels_all.append(np.asarray(labels)[:b])
        preds = np.concatenate(preds_all)
        labels = np.concatenate(labels_all)
        return InferenceResult(
            preds=preds, scores=np.concatenate(scores_all),
            rows=np.concatenate(rows_all),
            accuracy=float((preds == labels).mean()) if preds.size else 0.0)
