"""The wire convention for frames arriving on the card.

Port of `tmrnet_tpu/data/device_feed.py::DevicePrep` (:67-92): uint8 frames
are cast to the compute dtype and, under `device_normalize`, become
(x - mean*255) / (std*255) in that dtype; float frames are only cast.
"""

from __future__ import annotations

import torch

from tmrnet_torch.config import DataConfig
from tmrnet_torch.device import torch_dtype


class DevicePrep:
    def __init__(self, data_cfg: DataConfig, compute_dtype, device):
        self.cdt = torch_dtype(compute_dtype)
        self.mean = torch.tensor(data_cfg.mean, dtype=self.cdt,
                                 device=device) * 255.0
        self.std = torch.tensor(data_cfg.std, dtype=self.cdt,
                                device=device) * 255.0
        self.dev_norm = data_cfg.device_normalize

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        if frames.dtype == torch.uint8:
            frames = frames.to(self.cdt)
            if self.dev_norm:
                frames = (frames - self.mean) / self.std
        elif frames.dtype != self.cdt:
            frames = frames.to(self.cdt)
        return frames
