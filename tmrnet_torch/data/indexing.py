"""Clip-index algebra: clip starts, bank rows and memory windows.

Own copy of `tmrnet_tpu/data/indexing.py` (`clip_start_indices` :30,
`expand_clip_indices` :47, `clips_per_video` :56, `video_first_rows` :62,
`rows_to_video_ids` :70, `memory_window_rows` :77, `quirk_window_table`
:94, `memory_window_rows_reference` :104-129), numpy and torch only.

A video of n frames has n + 1 - seq_len clip positions (bank rows); a
clip's memory window is the `window` rows before it, most recent first,
in one of two modes:
  clamped (default): row[k] = max(r - k, first_row(video)), never before
      the video's first row (the paper's intent; a closed form, gathered
      on the device);
  reference quirk: the reference's dict walk (`get_long_feature`,
      `train_non-local_mutiConv_resnet.py:298-326`), whose lookback crosses
      into the previous video through its seq_len - 1 tail frames; a host
      table, `memory.compat_cross_video`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def clip_start_indices(seq_len: int, video_lengths: Sequence[int]) -> np.ndarray:
    """Global frame indices at which a seq_len-frame clip may start, none
    crossing a video boundary (reference `get_useful_start_idx`)."""
    starts: List[np.ndarray] = []
    base = 0
    for n in video_lengths:
        if n >= seq_len:
            starts.append(base + np.arange(n + 1 - seq_len, dtype=np.int64))
        base += n
    if not starts:
        return np.zeros((0,), dtype=np.int64)
    return np.concatenate(starts)


def expand_clip_indices(starts: Sequence[int], seq_len: int) -> np.ndarray:
    """Flat per-frame indices [s, ..., s + seq_len - 1] per start (the
    reference's SeqSampler feed)."""
    starts = np.asarray(starts, dtype=np.int64)
    return (starts[:, None] + np.arange(seq_len, dtype=np.int64)[None, :]).reshape(-1)


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


def rows_to_video_ids(num_rows: int, seq_len: int,
                      video_lengths: Sequence[int]) -> np.ndarray:
    """The video of each bank row."""
    cpv = clips_per_video(seq_len, video_lengths)
    return np.repeat(np.arange(len(cpv), dtype=np.int64), cpv)[:num_rows]


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


def quirk_window_table(seq_len: int, video_lengths: Sequence[int],
                       window: int) -> np.ndarray:
    """The (num_rows, window) reference-quirk window rows of a whole
    dataset, indexed per batch as table[rows]."""
    starts = clip_start_indices(seq_len, video_lengths)
    return memory_window_rows_reference(starts, seq_len, video_lengths, window)


def memory_window_rows_reference(start_frames: Sequence[int], seq_len: int,
                                 video_lengths: Sequence[int],
                                 window: int) -> np.ndarray:
    """The reference's window rows by its dict walk: the clip starting
    `k + 1` frames earlier where that frame starts a clip, else the last
    row found so far (cross-video lookback included)."""
    all_starts = clip_start_indices(seq_len, video_lengths)
    start_to_row = {int(s): i for i, s in enumerate(all_starts.tolist())}
    out = np.zeros((len(start_frames), window), dtype=np.int64)
    for b, s in enumerate(start_frames):
        s = int(s)
        last_valid = start_to_row[s]
        for k in range(window):
            row = start_to_row.get(s - k - 1)
            if row is not None:
                last_valid = row
            out[b, k] = last_valid
    return out
