"""The Long-term Feature Bank build.

Port of `tmrnet_tpu/train/loop.py::build_lfb` (:589-684),
`framewise_transform_for_video_build` (:687-700), `load_video_frames`
(:703-722) and the body of `_build_lfb_video` (:725-760). Two engines
fill the same bank, one row per clip position:
- clip: the frozen extractor (head `lfb`) over every clip of a dataset,
  `data.batch_clips` clips a batch through a `ClipLoader` and
  `device_prefetch`, each batch's rows written with `update_bank` (a
  padded last batch writes only its real rows);
- video: per video, `VideoInference.bank_features` (the extractor's
  backbone once per frame, its LSTM over every sliding window);
  `build_lfb_video` takes the videos' frames or zero-arg loaders of them.
Both run on one card (JAX's `mesh=` waits for multi-GPU work).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.data.device_feed import DevicePrep, device_prefetch
from tmrnet_torch.data.pipeline import ClipDataset, ClipLoader
from tmrnet_torch.device import resolve_device
from tmrnet_torch.eval.infer import (VideoInference, corpus_lengths,
                                     load_video, load_weights)
from tmrnet_torch.memory.lfb import FeatureBank, load_bank, save_bank, update_bank


def build_lfb(cfg: ExperimentConfig,
              extractor_state_dict: Mapping[str, torch.Tensor],
              ds: ClipDataset, cache_path: Optional[str] = None,
              force: bool = False, engine: str = "clip", device="cuda",
              fused_kernel: str = "block") -> FeatureBank:
    """The bank of a dataset from the frozen extractor's weights (head
    `lfb`: trunk and LSTM), f32, on `device`. The `.npz` at `cache_path`
    (default `memory.cache_path`) is read instead where it exists, under
    `memory.load_cached` and unless `force`; a build writes it.

    engine 'clip' runs the extractor over every clip with the dataset's
    transform; 'video' runs its backbone once per frame and needs a
    deterministic frame-wise transform (`EvalTransform` crop types 1/2/3).
    The two give the same features up to rounding. fused_kernel as in
    `ClipInference`."""
    path = cache_path or cfg.memory.cache_path
    if path and os.path.exists(path) and cfg.memory.load_cached and not force:
        return load_bank(path, device=device)
    if engine == "video":
        tf = framewise_transform_for_video_build(ds)
        videos = ds.manifest.videos
        loaders = [(lambda v=v: _transformed(tf, load_video_frames(ds, v)))
                   for v in videos]
        return build_lfb_video(cfg, extractor_state_dict, loaders,
                               lengths=[len(v) for v in videos],
                               cache_path=path, device=device,
                               fused_kernel=fused_kernel)
    if engine != "clip":
        raise ValueError(f"unknown engine {engine!r} (want clip or video)")
    dev = resolve_device(device)
    model = load_weights(dataclasses.replace(cfg.model, head="lfb"),
                         extractor_state_dict, dev, fused_kernel)
    prep = DevicePrep(cfg.data, cfg.model.compute_dtype, dev)
    bank = FeatureBank.create(ds.seq_len, ds.manifest.video_lengths,
                              cfg.model.hidden_dim, device=dev)
    d = cfg.data
    loader = ClipLoader(ds, d.batch_clips, shuffle=False,
                        num_workers=d.num_workers, prefetch=d.prefetch,
                        use_processes=d.use_process_workers)
    with torch.inference_mode():
        for clips, _, rows, pad in device_prefetch(loader.epoch(0), device=dev,
                                                   array_indices=(0, 2)):
            b = len(rows) - pad
            update_bank(bank.features, rows[:b], model(prep(clips))[:b])
    if path:
        save_bank(path, bank)
    return bank


def _transformed(tf, frames: np.ndarray) -> np.ndarray:
    return frames if tf is None else tf(frames)


def framewise_transform_for_video_build(ds: ClipDataset):
    """The dataset's transform, checked for the video engine: it runs once
    over a whole video, so it must act frame by frame and deterministically
    (`EvalTransform` crop types 1/2/3, or none)."""
    if not hasattr(ds, "manifest"):
        raise ValueError("engine='video' needs a frame-manifest dataset")
    tf = ds.transform
    if tf is not None and getattr(tf, "crop_type", None) not in (1, 2, 3):
        raise ValueError(
            "engine='video' needs a deterministic frame-wise transform "
            f"(EvalTransform crop types 1/2/3); got {type(tf).__name__}")
    return tf


def load_video_frames(ds: ClipDataset, video) -> np.ndarray:
    """One video's raw uint8 frames (N, H, W, 3) through the dataset's
    loader, a frame that fails to load zero-filled under error_policy
    'zeros' as `ClipDataset.get_clip` does."""
    out = []
    for p in video.frame_paths:
        try:
            out.append(ds.frame_loader(p))
        except Exception:
            if getattr(ds, "error_policy", "raise") != "zeros":
                raise
            out.append(None)
    shape = next((f.shape for f in out if f is not None), None)
    if shape is None:
        raise ValueError(f"video {video.video_id}: every frame failed "
                         f"to decode")
    return np.stack([f if f is not None else np.zeros(shape, np.uint8)
                     for f in out])


def build_lfb_video(cfg: ExperimentConfig,
                    extractor_state_dict: Mapping[str, torch.Tensor],
                    videos: Sequence, lengths: Optional[Sequence[int]] = None,
                    cache_path: Optional[str] = None, device="cuda",
                    fused_kernel: str = "block") -> FeatureBank:
    """One bank row per clip position of each video, in order (f32, as
    JAX's). videos: (N_i, H, W, 3) frames (uint8 raw, as the wire carries
    them, or float), host or device, or zero-arg loaders of them, which
    need `lengths` and are checked against them. cache_path: where to
    write the bank (`.npz`), if given."""
    ns = corpus_lengths(videos, lengths)
    engine = VideoInference(
        cfg.replace(model=dataclasses.replace(cfg.model, head="lfb")),
        extractor_state_dict, extractor_state_dict, device=device,
        fused_kernel=fused_kernel)
    bank = FeatureBank.create(cfg.data.sequence_length, ns,
                              cfg.model.hidden_dim, device=engine.device)
    row = 0
    for i, video in enumerate(videos):
        vals = engine.bank_features(load_video(video, ns[i], i))
        k = vals.shape[0]
        if k:
            update_bank(bank.features,
                        torch.arange(row, row + k, device=engine.device), vals)
        row += k
    if cache_path:
        save_bank(cache_path, bank)
    return bank
