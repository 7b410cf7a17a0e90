"""Long-term Feature Bank (LFB) on the card.

Port of `tmrnet_tpu/memory/lfb.py` (FeatureBank :36-74, update_bank :77-81,
gather_memory_windows :84-96, save_bank/load_bank :133-186 for `.npz`) and
of `memory_window_rows` (`tmrnet_tpu/data/indexing.py:77-91`). The bank is
a `(num_rows, feature_dim)` tensor written in place; a clip's memory window
is gathered on the device:

    rows_window = max(row - k, first_row_of_video)   k = 1..window
    lt = bank[rows_window]
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from tmrnet_torch.device import resolve_device


def clips_per_video(seq_len: int, video_lengths: Sequence[int]) -> np.ndarray:
    """Number of clip positions (= bank rows) per video."""
    lengths = np.asarray(video_lengths, dtype=np.int64)
    return np.maximum(lengths + 1 - seq_len, 0)


def video_first_rows(seq_len: int, video_lengths: Sequence[int]) -> np.ndarray:
    """First bank row of each video (exclusive cumsum of clips_per_video)."""
    cpv = clips_per_video(seq_len, video_lengths)
    if cpv.size == 0:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate([[0], np.cumsum(cpv)[:-1]]).astype(np.int64)


def memory_window_rows(rows, first_rows, window: int):
    """Clamped memory window rows, shape rows.shape + (window,), ordered
    k = 1..window (most recent first), never before the video's first row.
    Takes numpy arrays or torch tensors and returns the same kind."""
    rows = rows[..., None]
    first = first_rows[..., None]
    if isinstance(rows, torch.Tensor):
        ks = torch.arange(1, window + 1, dtype=rows.dtype, device=rows.device)
        return torch.maximum(rows - ks, first.to(rows.dtype))
    ks = np.arange(1, window + 1, dtype=rows.dtype)
    return np.maximum(rows - ks, first)


@dataclasses.dataclass
class FeatureBank:
    """features: (num_rows, feature_dim); first_rows: (num_rows,) int32, the
    first bank row of each row's video."""

    features: torch.Tensor
    first_rows: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.features.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]

    @staticmethod
    def create(seq_len: int, video_lengths: Sequence[int], feature_dim: int,
               dtype=torch.float32, device="cuda") -> "FeatureBank":
        dev = resolve_device(device)
        cpv = clips_per_video(seq_len, video_lengths)
        n = int(cpv.sum())
        firsts = np.repeat(video_first_rows(seq_len, video_lengths), cpv)[:n]
        return FeatureBank(
            features=torch.zeros((n, feature_dim), dtype=dtype, device=dev),
            first_rows=torch.as_tensor(firsts.astype(np.int32), device=dev))


def update_bank(features: torch.Tensor, rows: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """Write freshly extracted clip features into their rows, in place
    (the JAX package returns a new, donated array instead)."""
    rows = rows.to(device=features.device, dtype=torch.long)
    return features.index_copy_(0, rows, values.to(features.dtype))


def gather_memory_windows(features: torch.Tensor, rows: torch.Tensor,
                          first_rows: torch.Tensor, window: int) -> torch.Tensor:
    """(B,) rows -> (B, window, F), most recent clip first, clamped at each
    video's first row.

    CONTRACT: first_rows is BATCH-ALIGNED: first_rows[i] is the first row of
    rows[i]'s video, i.e. callers index the per-row table first
    (`bank.first_rows[rows]`), never pass the whole table."""
    if first_rows.shape != rows.shape:
        raise ValueError(f"first_rows {tuple(first_rows.shape)} must align "
                         f"with rows {tuple(rows.shape)}")
    idx = memory_window_rows(rows.long(), first_rows.long(), window)
    return features[idx]


def save_bank(path: str, bank: FeatureBank) -> None:
    """Write the bank as `.npz` (features + first_rows), the file the JAX
    package writes. A bf16 bank is written as float32 (numpy has no bf16)."""
    if path.endswith((".pkl", ".pickle")):
        raise ValueError("the reference .pkl bank format is not ported")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    feats = bank.features.detach().cpu()
    if feats.dtype == torch.bfloat16:
        feats = feats.float()
    np.savez_compressed(path, features=feats.numpy(),
                        first_rows=bank.first_rows.detach().cpu().numpy()
                        .astype(np.int32))


def load_bank(path: str, dtype=torch.float32, device="cuda") -> FeatureBank:
    """Read an `.npz` bank written by either package."""
    if path.endswith((".pkl", ".pickle")):
        raise ValueError("the reference .pkl bank format is not ported")
    dev = resolve_device(device)
    with np.load(path) as z:
        feats = torch.from_numpy(np.asarray(z["features"], np.float32))
        firsts = torch.from_numpy(np.asarray(z["first_rows"], np.int32))
    return FeatureBank(features=feats.to(device=dev, dtype=dtype),
                       first_rows=firsts.to(dev))
