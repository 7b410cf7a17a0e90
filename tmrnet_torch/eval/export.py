"""Prediction export: per-video phase files for the relaxed-boundary scorer
(reference `eval/python/export_phase_copy.py`).

Own copy of `tmrnet_tpu/eval/export.py` (`export_predictions` :21-65,
`load_exported` :68-91) over the port's `data/indexing.py` and
`data/manifests.py`. A test video's first seq_len-1 frame positions have
no clip prediction; they are padded with phase 0, as the reference pads
them (`:56-60`). Rows are `fps*k <TAB> phase`, with no header, in a
parallel gt-phase tree, and the reference's count invariant
num_labels == num_preds + (seq-1)*num_videos is checked (`:32`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tmrnet_torch.data.indexing import clips_per_video
from tmrnet_torch.data.manifests import Manifest
from tmrnet_torch.eval.metrics import read_phase_file, write_phase_file


def export_predictions(
    manifest: Manifest,
    clip_preds: np.ndarray,
    seq_len: int,
    pred_dir: str,
    gt_dir: Optional[str] = None,
    fps: int = 25,
    video_name_fmt: str = "{vid}-phase.txt",
) -> Dict[str, float]:
    """clip_preds: every clip's prediction in bank-row order (video-major).
    Writes one file per video; returns the frame accuracy of the padded
    streams (reference `:83-89`), the videos and the frames."""
    lengths = manifest.video_lengths
    num_clips = clips_per_video(seq_len, lengths).tolist()
    expected = sum(num_clips)
    if len(clip_preds) != expected:
        raise ValueError(
            f"prediction count mismatch: got {len(clip_preds)}, expected "
            f"{expected} (= sum of per-video clip counts); the reference "
            f"invariant num_labels == num_preds + (seq-1)*num_videos fails")

    os.makedirs(pred_dir, exist_ok=True)
    if gt_dir:
        os.makedirs(gt_dir, exist_ok=True)

    correct = total = ofs = 0
    for video, n_clip in zip(manifest.videos, num_clips):
        per_frame = np.concatenate([
            np.zeros(min(seq_len - 1, len(video)), np.int64),
            np.asarray(clip_preds[ofs:ofs + n_clip], np.int64),
        ])
        ofs += n_clip
        name = video_name_fmt.format(vid=video.video_id)
        write_phase_file(os.path.join(pred_dir, name), per_frame, fps=fps)
        if gt_dir:
            write_phase_file(os.path.join(gt_dir, name), video.labels, fps=fps)
        correct += int((per_frame == video.labels[: len(per_frame)]).sum())
        total += len(per_frame)
    return {"frame_accuracy": correct / max(total, 1),
            "num_videos": len(lengths), "num_frames": total}


def load_exported(pred_dir: str, gt_dir: str,
                  video_ids: Sequence[str],
                  video_name_fmt: str = "{vid}-phase.txt",
                  phase_names: Optional[Sequence[str]] = None,
                  matlab_compat: bool = False
                  ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The exported (gt, pred) label streams of `video_ids`. phase_names:
    the protocol's name -> id order for name-labelled gt files (M2CAI's
    maps the shared names to other ids); matlab_compat drops each file's
    first row, as `ReadPhaseLabel.m:8` does."""
    gts, preds = [], []
    for vid in video_ids:
        name = video_name_fmt.format(vid=vid)
        _, g = read_phase_file(os.path.join(gt_dir, name), phase_names,
                               matlab_compat)
        _, p = read_phase_file(os.path.join(pred_dir, name), phase_names,
                               matlab_compat)
        if g.shape != p.shape:
            raise ValueError(f"gt/pred length mismatch for {vid}")
        gts.append(g)
        preds.append(p)
    return gts, preds
