"""Configuration for the PyTorch port: the fields of the JAX package's
`ModelConfig`, `MemoryConfig`, `DataConfig` and `EvalConfig` that the
inference engines read.

Own copy of those fields (names, defaults, meaning) of
`tmrnet_tpu/config.py` (ModelConfig :97-123, MemoryConfig :200-210,
DataConfig sequence_length :61 and mean/std/device_normalize :81-92,
EvalConfig backbone_chunk :214-236), so the port never imports the JAX
package. Later slices add the fields they read.
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

    # Frames per clip: the reference runs 10-frame 1-fps clips.
    sequence_length: int = 10
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
    # 'stage1' (trunk + LSTM + fc on every step), 'lfb' (trunk + LSTM, the
    # last step's features), 'tmr' (TimeConv + NLBlock memory head) or
    # 'nl_only' (NLBlock alone).
    head: str = "tmr"
    compute_dtype: str = "bfloat16"  # bfloat16 on the card; float32 for parity
    # Inference-only: BatchNorm pre-folded into conv weights (models/fold_bn).
    folded: bool = False


@dataclass(frozen=True)
class MemoryConfig:
    """Long-term Feature Bank settings."""

    window: int = 30


@dataclass(frozen=True)
class EvalConfig:
    """Inference settings."""

    # The video engines run the backbone over frame chunks of this many
    # frames: 0 = auto (`eval/infer.py::plan_trunk_chunk`), -1 = never
    # (all frames of a call at once), > 0 = that many.
    backbone_chunk: int = 0


@dataclass(frozen=True)
class ExperimentConfig:
    """The sections of the JAX ExperimentConfig that the engines read."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
