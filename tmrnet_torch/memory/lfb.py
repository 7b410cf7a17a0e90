"""Long-term Feature Bank (LFB) on the card.

Port of `tmrnet_tpu/memory/lfb.py` (FeatureBank :36-74, update_bank :77-81,
gather_memory_windows :84-96, save_bank/load_bank :133-186, the `.npz`
of either package and the reference's g_LFB `.pkl`), with the row algebra
of `data/indexing.py` (`memory_window_rows`). The bank is
a `(num_rows, feature_dim)` tensor written in place; a clip's memory window
is gathered on the device:

    rows_window = max(row - k, first_row_of_video)   k = 1..window
    lt = bank[rows_window]
"""

from __future__ import annotations

import collections
import dataclasses
import io
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from tmrnet_torch.data.indexing import (clips_per_video, memory_window_rows,
                                       video_first_rows)
from tmrnet_torch.device import resolve_device


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


def _is_pickle(path: str) -> bool:
    return path.endswith((".pkl", ".pickle"))


def _tensor_from_bytes(b: bytes):
    """A pickled tensor's storage, read under torch's weights-only rules."""
    return torch.load(io.BytesIO(b), weights_only=True)


# What a pickled float array or tensor refers to, and nothing else; numpy
# 1 and 2 name the array's rebuild by different modules.
_NP_RECONSTRUCT = np.ndarray.__reduce__(np.zeros(0))[0]
_BANK_GLOBALS = {
    ("numpy._core.multiarray", "_reconstruct"): _NP_RECONSTRUCT,
    ("numpy.core.multiarray", "_reconstruct"): _NP_RECONSTRUCT,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("torch._utils", "_rebuild_tensor_v2"): torch._utils._rebuild_tensor_v2,
    ("torch.storage", "_load_from_bytes"): _tensor_from_bytes,
    ("collections", "OrderedDict"): collections.OrderedDict,
}


class _BankUnpickler(pickle.Unpickler):
    """Reads a pickled numpy array or torch tensor; refuses any other
    global, so a bank file cannot run code."""

    def find_class(self, module, name):
        try:
            return _BANK_GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"a bank pickle holds an array or a tensor, not "
                f"{module}.{name}") from None


def save_bank(path: str, bank: FeatureBank) -> None:
    """Write the bank as `.npz` (features + first_rows), the file the JAX
    package writes; a `.pkl`/`.pickle` path writes the reference's g_LFB
    format instead, a pickled float32 numpy array of the features
    (reference `train_non-local_mutiConv_resnet.py:752-756`). A bf16 bank is
    written as float32 (numpy has no bf16)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    feats = bank.features.detach().cpu().float().numpy()
    if _is_pickle(path):
        with open(path, "wb") as f:
            pickle.dump(feats, f)
        return
    np.savez_compressed(path, features=feats,
                        first_rows=bank.first_rows.detach().cpu().numpy()
                        .astype(np.int32))


def load_bank(path: str, dtype=torch.float32, device="cuda",
              seq_len: Optional[int] = None,
              video_lengths: Optional[Sequence[int]] = None) -> FeatureBank:
    """Read an `.npz` bank written by either package, or the reference's
    g_LFB `.pkl` (a pickled (num_rows, F) numpy array or torch tensor,
    reference `train_non-local_mutiConv_resnet.py:752-765`), read under an
    allowlist that refuses any other object. A pickle holds no first rows: given seq_len and video_lengths they are rebuilt and the
    row count checked, else they are zeros (the engines take first rows
    from the clip positions, not from the bank)."""
    dev = resolve_device(device)
    if _is_pickle(path):
        with open(path, "rb") as f:
            arr = _BankUnpickler(f).load()
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().float().numpy()
        arr = np.asarray(arr, np.float32)
        if arr.ndim != 2:
            raise ValueError(f"{path}: expected a 2-D feature array, "
                             f"got shape {arr.shape}")
        if seq_len is not None and video_lengths is not None:
            cpv = clips_per_video(seq_len, video_lengths)
            want = int(cpv.sum())
            if want != arr.shape[0]:
                raise ValueError(
                    f"{path}: {arr.shape[0]} rows but the videos imply "
                    f"{want} clip positions (sum of len+1-seq per video): "
                    f"a bank of another dataset or seq_len")
            firsts = np.repeat(video_first_rows(seq_len, video_lengths),
                               cpv)[:want]
        else:
            firsts = np.zeros((arr.shape[0],), np.int64)
        feats = torch.from_numpy(arr)
        firsts = torch.from_numpy(firsts.astype(np.int32))
    else:
        with np.load(path) as z:
            feats = torch.from_numpy(np.asarray(z["features"], np.float32))
            firsts = torch.from_numpy(np.asarray(z["first_rows"], np.int32))
    return FeatureBank(features=feats.to(device=dev, dtype=dtype),
                       first_rows=firsts.to(dev))
