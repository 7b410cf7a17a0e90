"""TMRNet model heads.

Port of `tmrnet_tpu/models/tmrnet.py` (ClipEncoder :32-47, MemoryBankModel
:50-68, LFBExtractor :71-83, TMRNet :86-124, build_model :145-159): the
stage-1 head `stage1` (an fc over every LSTM step), the LFB extractor `lfb`
(the last LSTM step) and the memory heads `tmr` (TimeConv + NLBlock) and
`nl_only` (NLBlock alone). The module tree follows the flax parameter tree:
the backbone sits at the top level (`backbone.*`) and the clip encoder
holds only the LSTM (`encoder.lstm.*`). Every model takes `train=`
(BatchNorm on batch statistics, dropout on) and a `generator` for the
dropout masks, at flax's places: stage1 after the LSTM, before `fc`
(:60-67); tmr and nl_only after `fc_h_c` (:118-124) and in the NLBlock.

`init_state_dict` draws fresh weights from flax's initialisers, as
`model.init` would give them in distribution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm

from tmrnet_torch.config import ModelConfig
from tmrnet_torch.device import resolve_device, torch_dtype
from tmrnet_torch.models.blocks import (NLBlock, TimeConv, column_linear,
                                        dense, dropout, row_linear)
from tmrnet_torch.models.lstm import LSTM
from tmrnet_torch.models.resnest import ResNeSt, SplitAttention
from tmrnet_torch.models.resnet import ResNet
from tmrnet_torch.parallel.tensor import shard_of

HEADS = ("stage1", "lfb", "tmr", "nl_only")


class ClipEncoder(nn.Module):
    """LSTM over per-frame backbone features; the backbone is passed in,
    because its parameters live at the model's top level as in flax."""

    def __init__(self, input_dim: int, hidden_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lstm = LSTM(input_dim, hidden_dim, compute_dtype)

    def forward(self, backbone: nn.Module, clips: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """clips (B, T, H, W, 3) -> (B, T, hidden)."""
        b, t = clips.shape[:2]
        feats = backbone(clips.reshape((b * t,) + tuple(clips.shape[2:])),
                         train)
        return self.lstm(feats.reshape(b, t, -1))[0]


class MemoryBankModel(nn.Module):
    """Stage-1 model: logits for every step, (B, T, classes)."""

    def __init__(self, backbone: nn.Module, num_classes: int = 7,
                 hidden_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.2):
        super().__init__()
        self.backbone = backbone
        self.encoder = ClipEncoder(backbone.num_features, hidden_dim,
                                   compute_dtype)
        self.fc = nn.Linear(hidden_dim, num_classes)
        self.dropout = dropout

    def forward(self, clips: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ys = self.encoder(self.backbone, clips, train)
        return dense(self.fc, dropout(ys, self.dropout, train, generator))


class LFBExtractor(nn.Module):
    """Clip-feature extractor for the LFB build: the last LSTM step,
    (B, hidden)."""

    def __init__(self, backbone: nn.Module, hidden_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = backbone
        self.encoder = ClipEncoder(backbone.num_features, hidden_dim,
                                   compute_dtype)

    def forward(self, clips: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.encoder(self.backbone, clips, train)[:, -1, :]


class TMRNet(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int = 7,
                 hidden_dim: int = 512, use_time_conv: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.5, dropout_nl: float = 0.2):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.backbone = backbone
        self.encoder = ClipEncoder(backbone.num_features, hidden_dim,
                                   compute_dtype)
        self.time_conv = (TimeConv(hidden_dim, compute_dtype)
                          if use_time_conv else None)
        self.nl_block = NLBlock(hidden_dim, compute_dtype, dropout_nl)
        self.fc_h_c = nn.Linear(2 * hidden_dim, hidden_dim)
        self.fc_c = nn.Linear(hidden_dim, num_classes)
        self.dropout = dropout

    def head(self, st: torch.Tensor, memory: torch.Tensor, train: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The memory head: clip embeddings St (B, hidden) and their memory
        windows (B, window, hidden) -> logits (B, classes) in St's dtype.
        The clip, video and stream engines all score through it."""
        lt = memory.to(st.dtype)
        if self.time_conv is not None:
            lt = self.time_conv(lt)
        y = torch.cat([st, self.nl_block(st, lt, train, generator)], dim=-1)
        # Reference order: fc_h_c -> dropout -> relu -> fc_c. Under tensor
        # parallelism fc_h_c is column-parallel and fc_c row-parallel: the
        # rank's columns of fc_h_c feed its rows of fc_c, one sum after.
        shard = shard_of(self.fc_h_c.weight)
        y = column_linear(self.fc_h_c, y, keep_slice=True)
        cols = None
        if shard is not None:
            whole = y.shape[-1] * shard.size
            cols = (*shard.bounds(whole), whole)
        y = dropout(y, self.dropout, train, generator, cols)
        return row_linear(self.fc_c, torch.relu(y))

    def forward(self, clips: torch.Tensor, long_feature: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """clips (B, T, H, W, 3); long_feature (B, window, hidden)
        -> logits (B, classes) in the compute dtype."""
        ys = self.encoder(self.backbone, clips, train)
        return self.head(ys[:, -1, :], long_feature, train, generator)


def build_backbone(cfg: ModelConfig, fused_kernel: str = "block"
                   ) -> nn.Module:
    """The backbone of `cfg`: ResNet (`resnet50`, `tiny`) or ResNeSt
    (`resnest50`, stem width 32 whatever `cfg.width`, as JAX builds it).
    fused_kernel: the folded ResNet identity blocks' kernel, "block" or
    "tiled" (`models/resnet.py`; JAX's `fused_tmr_apply(kernel=...)`,
    `tmrnet_tpu/experimental/fused_resnet.py:111-144`). A keyword, not a
    config field: JAX's ModelConfig has none. ResNeSt checks it and runs
    neither kernel: it has no identity block they compute.
    `cfg.remat` recomputes each ResNet bottleneck in the backward pass;
    ResNeSt ignores it, as JAX's `build_backbone` passes it none
    (`tmrnet_tpu/models/tmrnet.py:134-138`)."""
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.backbone == "resnet50":
        return ResNet(tuple(cfg.stage_sizes), cfg.width, cfg.folded, cdt,
                      fused_kernel, cfg.remat)
    if cfg.backbone == "resnest50":
        return ResNeSt(tuple(cfg.stage_sizes), cfg.width, cfg.folded, cdt,
                       fused_kernel)
    if cfg.backbone == "tiny":
        return ResNet((1, 1), 8, cfg.folded, cdt, fused_kernel, cfg.remat)
    raise ValueError(f"unknown backbone {cfg.backbone!r}")


def _build_on_meta(cfg: ModelConfig, fused_kernel: str = "block") -> nn.Module:
    if cfg.head not in HEADS:
        raise ValueError(f"unknown head {cfg.head!r} (want one of {HEADS})")
    cdt = torch_dtype(cfg.compute_dtype)
    with torch.device("meta"):
        backbone = build_backbone(cfg, fused_kernel)
        if cfg.head == "stage1":
            return MemoryBankModel(backbone, cfg.num_classes, cfg.hidden_dim,
                                   cdt, cfg.dropout_stage1)
        if cfg.head == "lfb":
            return LFBExtractor(backbone, cfg.hidden_dim, cdt)
        return TMRNet(backbone, cfg.num_classes, cfg.hidden_dim,
                      use_time_conv=(cfg.head == "tmr"), compute_dtype=cdt,
                      dropout=cfg.dropout_head, dropout_nl=cfg.dropout_nl)


def state_shapes(cfg: ModelConfig) -> dict:
    """The state dict's names and shapes of the model of `cfg`."""
    return {k: tuple(v.shape)
            for k, v in _build_on_meta(cfg).state_dict().items()}


def build_model(cfg: ModelConfig, device="cuda",
                fused_kernel: str = "block") -> nn.Module:
    """ModelConfig -> the head's model on `device`, its weights zero until
    loaded (`load_state_dict`, e.g. from `models.convert.from_jax_variables`);
    fused_kernel as in `build_backbone`."""
    dev = resolve_device(device)
    model = _build_on_meta(cfg, fused_kernel)
    model = model.to_empty(device=dev)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
    return model.eval()


# flax's truncated normal draws in [-2, 2] and rescales so that the
# variance is the one asked for.
_TRUNC_STD = 0.87962566103423978


def init_state_dict(cfg: ModelConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Fresh unfolded weights for the model of `cfg`, on the CPU, from a
    torch generator at `seed`, drawn from the distributions of flax's
    initialisers in the JAX modules: convs lecun-normal (truncated normal,
    variance 1/fan_in, fan_in = k*k*Cin/groups or k*Cin), Dense kernels
    xavier-uniform but ResNeSt's split-attention `fc1`/`fc2` lecun-normal
    (flax Dense's default), the LSTM's kernels xavier-normal (truncated,
    variance 2/(fan_in + fan_out)), every bias and BN shift 0, BN (2-D and
    1-D) and LayerNorm scales 1, BN running means 0 and variances 1. The
    draws are not JAX's: the distributions are."""
    model = build_model(dataclasses.replace(cfg, folded=False), device="cpu")
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def init_weights_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """`model`'s weights drawn in place from `gen` by the distributions of
    `init_state_dict` (everything else zero)."""

    def trunc_normal_(t, variance):
        std = math.sqrt(variance) / _TRUNC_STD
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)

    lecun_dense = {id(fc) for m in model.modules()
                   if isinstance(m, SplitAttention) for fc in (m.fc1, m.fc2)}
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Conv1d)):
                w = module.weight
                trunc_normal_(w, 1.0 / (w[0].numel()))
            elif id(module) in lecun_dense:
                trunc_normal_(module.weight, 1.0 / module.in_features)
            elif isinstance(module, nn.Linear):
                fan_in, fan_out = module.in_features, module.out_features
                lim = math.sqrt(6.0 / (fan_in + fan_out))
                module.weight.uniform_(-lim, lim, generator=gen)
            elif isinstance(module, LSTM):
                for w in (module.weight_ih, module.weight_hh):
                    trunc_normal_(w, 2.0 / (w.shape[0] + w.shape[1]))
            elif isinstance(module, (_BatchNorm, nn.LayerNorm)):
                module.weight.fill_(1.0)
                if isinstance(module, _BatchNorm):
                    module.running_var.fill_(1.0)
    return model
