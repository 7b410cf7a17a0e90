"""Packed raw frames, the read side: one uint8 `(N, H, W, 3)` `.npy` per
video, a frame addressed as `<file>.npy#<index>`.

Port of `tmrnet_tpu/data/packed.py` (`is_packed_path`, `split_packed_path`,
`load_packed_frame`, :35-75). A frame read is a memmap slice and a copy, no
codec. The memmap handles are opened once a process and shared by every
thread (reads of a read-only memmap are thread-safe); a lock guards their
opening. Numpy only: decode threads call this and never touch torch.
"""

from __future__ import annotations

import threading
from typing import Tuple

import numpy as np

_SEP = ".npy#"

_OPEN: dict = {}
_LOCK = threading.Lock()


def is_packed_path(path: str) -> bool:
    return _SEP in path


def split_packed_path(path: str) -> Tuple[str, int]:
    """'<file>.npy#<idx>' -> (file, idx). Raises ValueError if malformed."""
    file, _, idx = path.rpartition("#")
    if not file.endswith(".npy"):
        raise ValueError(f"not a packed frame path: {path!r}")
    return file, int(idx)


def load_packed_frame(path: str) -> np.ndarray:
    """One frame of a packed video, as an owned uint8 copy."""
    file, idx = split_packed_path(path)
    mm = _OPEN.get(file)
    if mm is None:
        with _LOCK:
            mm = _OPEN.get(file)
            if mm is None:
                mm = np.load(file, mmap_mode="r")
                if mm.ndim != 4:
                    raise ValueError(
                        f"{file}: packed video must be (N,H,W,C), "
                        f"got shape {mm.shape}")
                _OPEN[file] = mm
    if not 0 <= idx < len(mm):
        raise IndexError(f"{file}: frame {idx} out of range (N={len(mm)})")
    return np.array(mm[idx])
