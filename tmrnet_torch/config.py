"""Configuration for the PyTorch port: the fields of the JAX package's
`ModelConfig`, `MemoryConfig` and `DataConfig` that clip inference reads.

Own copy of those fields (names, defaults, meaning) of
`tmrnet_tpu/config.py` (ModelConfig :97-123, MemoryConfig :200-210,
DataConfig mean/std/device_normalize :81-92), so the port never imports the
JAX package. Later slices add the fields they read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# Cholec80 normalization constants (reference `meanStd.py:27-63`).
CHOLEC80_MEAN: Tuple[float, float, float] = (0.41757566, 0.26098573, 0.25888634)
CHOLEC80_STD: Tuple[float, float, float] = (0.21938758, 0.1983, 0.19342837)


@dataclass(frozen=True)
class DataConfig:
    """Input normalization: uint8 frames are cast to the compute dtype and,
    under `device_normalize`, become (x - mean*255) / (std*255) on the card."""

    mean: Tuple[float, float, float] = CHOLEC80_MEAN
    std: Tuple[float, float, float] = CHOLEC80_STD
    device_normalize: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Backbone + temporal head architecture."""

    backbone: str = "resnet50"  # resnet50 | tiny (tests)
    # ResNet stage depths; (3,4,6,3) = ResNet-50.
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    hidden_dim: int = 512  # LSTM hidden size
    num_classes: int = 7
    # 'tmr' (TimeConv + NLBlock memory head) or 'nl_only' (NLBlock alone).
    head: str = "tmr"
    compute_dtype: str = "bfloat16"  # bfloat16 on the card; float32 for parity
    # Inference-only: BatchNorm pre-folded into conv weights (models/fold_bn).
    folded: bool = False


@dataclass(frozen=True)
class MemoryConfig:
    """Long-term Feature Bank settings."""

    window: int = 30


@dataclass(frozen=True)
class ExperimentConfig:
    """The sections of the JAX ExperimentConfig that clip inference reads."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
