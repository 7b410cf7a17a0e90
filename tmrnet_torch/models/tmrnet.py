"""TMRNet model heads, for inference.

Port of `tmrnet_tpu/models/tmrnet.py` (ClipEncoder :32-47, MemoryBankModel
:50-68, LFBExtractor :71-83, TMRNet :86-124, build_model :145-159): the
stage-1 head `stage1` (an fc over every LSTM step), the LFB extractor `lfb`
(the last LSTM step) and the memory heads `tmr` (TimeConv + NLBlock) and
`nl_only` (NLBlock alone). The module tree follows the flax parameter tree:
the backbone sits at the top level (`backbone.*`) and the clip encoder
holds only the LSTM (`encoder.lstm.*`). Inference only: the dropouts are
identities.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tmrnet_torch.config import ModelConfig
from tmrnet_torch.device import resolve_device, torch_dtype
from tmrnet_torch.models.blocks import NLBlock, TimeConv, dense
from tmrnet_torch.models.lstm import LSTM
from tmrnet_torch.models.resnet import ResNet

HEADS = ("stage1", "lfb", "tmr", "nl_only")


class ClipEncoder(nn.Module):
    """LSTM over per-frame backbone features; the backbone is passed in,
    because its parameters live at the model's top level as in flax."""

    def __init__(self, input_dim: int, hidden_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lstm = LSTM(input_dim, hidden_dim, compute_dtype)

    def forward(self, backbone: nn.Module, clips: torch.Tensor) -> torch.Tensor:
        """clips (B, T, H, W, 3) -> (B, T, hidden)."""
        b, t = clips.shape[:2]
        feats = backbone(clips.reshape((b * t,) + tuple(clips.shape[2:])))
        return self.lstm(feats.reshape(b, t, -1))[0]


class MemoryBankModel(nn.Module):
    """Stage-1 model: logits for every step, (B, T, classes)."""

    def __init__(self, backbone: ResNet, num_classes: int = 7,
                 hidden_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = backbone
        self.encoder = ClipEncoder(backbone.num_features, hidden_dim,
                                   compute_dtype)
        self.fc = nn.Linear(hidden_dim, num_classes)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        return dense(self.fc, self.encoder(self.backbone, clips))


class LFBExtractor(nn.Module):
    """Clip-feature extractor for the LFB build: the last LSTM step,
    (B, hidden)."""

    def __init__(self, backbone: ResNet, hidden_dim: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = backbone
        self.encoder = ClipEncoder(backbone.num_features, hidden_dim,
                                   compute_dtype)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.backbone, clips)[:, -1, :]


class TMRNet(nn.Module):
    def __init__(self, backbone: ResNet, num_classes: int = 7,
                 hidden_dim: int = 512, use_time_conv: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.backbone = backbone
        self.encoder = ClipEncoder(backbone.num_features, hidden_dim,
                                   compute_dtype)
        self.time_conv = (TimeConv(hidden_dim, compute_dtype)
                          if use_time_conv else None)
        self.nl_block = NLBlock(hidden_dim, compute_dtype)
        self.fc_h_c = nn.Linear(2 * hidden_dim, hidden_dim)
        self.fc_c = nn.Linear(hidden_dim, num_classes)

    def head(self, st: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """The memory head: clip embeddings St (B, hidden) and their memory
        windows (B, window, hidden) -> logits (B, classes) in St's dtype.
        The clip, video and stream engines all score through it."""
        lt = memory.to(st.dtype)
        if self.time_conv is not None:
            lt = self.time_conv(lt)
        y = torch.cat([st, self.nl_block(st, lt)], dim=-1)
        # Reference order: fc_h_c -> dropout -> relu -> fc_c.
        y = torch.relu(dense(self.fc_h_c, y))
        return dense(self.fc_c, y)

    def forward(self, clips: torch.Tensor,
                long_feature: torch.Tensor) -> torch.Tensor:
        """clips (B, T, H, W, 3); long_feature (B, window, hidden)
        -> logits (B, classes) in the compute dtype."""
        ys = self.encoder(self.backbone, clips)
        return self.head(ys[:, -1, :], long_feature)


def build_backbone(cfg: ModelConfig, fused_kernel: str = "block") -> ResNet:
    """fused_kernel: the folded identity blocks' kernel, "block" or "tiled"
    (`models/resnet.py`; JAX's `fused_tmr_apply(kernel=...)`,
    `tmrnet_tpu/experimental/fused_resnet.py:111-144`). A keyword, not a
    config field: JAX's ModelConfig has none."""
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.backbone == "resnet50":
        return ResNet(tuple(cfg.stage_sizes), cfg.width, cfg.folded, cdt,
                      fused_kernel)
    if cfg.backbone == "tiny":
        return ResNet((1, 1), 8, cfg.folded, cdt, fused_kernel)
    raise ValueError(f"backbone {cfg.backbone!r} is not ported")


def build_model(cfg: ModelConfig, device="cuda",
                fused_kernel: str = "block") -> nn.Module:
    """ModelConfig -> the head's model on `device`, its weights zero until
    loaded (`load_state_dict`, e.g. from `models.convert.from_jax_variables`);
    fused_kernel as in `build_backbone`."""
    dev = resolve_device(device)
    if cfg.head not in HEADS:
        raise ValueError(f"unknown head {cfg.head!r} (want one of {HEADS})")
    cdt = torch_dtype(cfg.compute_dtype)
    with torch.device("meta"):
        backbone = build_backbone(cfg, fused_kernel)
        if cfg.head == "stage1":
            model = MemoryBankModel(backbone, cfg.num_classes, cfg.hidden_dim,
                                    cdt)
        elif cfg.head == "lfb":
            model = LFBExtractor(backbone, cfg.hidden_dim, cdt)
        else:
            model = TMRNet(backbone, cfg.num_classes, cfg.hidden_dim,
                           use_time_conv=(cfg.head == "tmr"),
                           compute_dtype=cdt)
    model = model.to_empty(device=dev)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
    return model.eval()
