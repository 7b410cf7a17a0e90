"""The Long-term Feature Bank build by the video engine.

Port of the body of `tmrnet_tpu/train/loop.py::_build_lfb_video`
(:725-760): per video, `VideoInference.bank_features` (the extractor's
backbone once per frame, its LSTM over every sliding window), written into
a `FeatureBank` with `update_bank`, then optionally saved. Where JAX takes a
dataset, this takes the videos' frames or zero-arg loaders of them, plus
their lengths: the same computation until the data layer is ported. The
dataset-taking `build_lfb` (:589) and its clip engine come with the data
layer.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.eval.infer import VideoInference, corpus_lengths, load_video
from tmrnet_torch.memory.lfb import FeatureBank, save_bank, update_bank


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
