"""ResNeSt backbone (split-attention ResNet), NHWC at the interface.

Port of `tmrnet_tpu/models/resnest.py` (SplitAttention :38-81,
ResNeStBottleneck :84-121, ResNeSt :124-160): radix-2 split attention in
each bottleneck, a deep 3-conv stem of fixed width 32 (JAX's build passes
no `stem_width`), an average pool after the split-attention conv in
strided blocks (avd: 3x3, stride s, padding 1, the padded zeros counted)
and an s x s average pool before the shortcut's 1x1 conv (avg_down: VALID,
floor; the official package's ceil_mode and count_include_pad=False are
not JAX's, and JAX is followed). At odd sizes a strided block's two pools
disagree on the output size and the residual add raises, in both packages.

Frames come in as (N, H, W, 3); activations stay in `channels_last`
memory, as in `models/resnet.py`, whose `conv` and `batch_norm` helpers
every layer goes through. Rounding follows JAX's: each conv and Dense
rounds to the compute dtype, the global pool is taken in it, the radix
softmax runs at f32 or wider (bf16 is upcast, f64 stays f64) and is
rounded back, and the weighting of the splits runs in the compute dtype.

The trunk runs on `torch.nn.functional` (cuDNN on the card) in both
packages: ResNeSt has no identity block that `fused_bottleneck` or
`fused_bottleneck_tiled` computes (its middle conv is a split-attention
conv, not a 3x3 conv), so `kernel` is checked and otherwise unused, and a
ResNeSt forward launches neither.

Names follow the flax tree: `stem_conv1..3`, `stem_bn1..3`,
`layer{l}_{i}.conv1/bn1`, `.splat.conv/bn0/fc1/bn1/fc2`, `.conv3/bn3`,
`.downsample_conv/bn`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmrnet_torch.models.blocks import dense
from tmrnet_torch.models.resnet import (BN_EPS, EXPANSION, batch_norm,
                                        check_fused_kernel, conv)

STEM_WIDTH = 32
RADIX = 2
REDUCTION = 4
# The split attention's hidden width never drops below this.
MIN_INTER = 32


def _identity(layer_name, y):
    return y


class SplitAttention(nn.Module):
    """SplAtConv2d: a grouped 3x3 conv (groups * RADIX groups) making
    RADIX splits of `channels`, weighted per channel by an rSoftMax over
    the radix axis of an attention computed from their pooled sum."""

    def __init__(self, in_channels: int, channels: int, groups: int = 1,
                 folded: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.groups = channels, groups
        self.folded = folded
        self.compute_dtype = compute_dtype
        inter = max(in_channels * RADIX // REDUCTION, MIN_INTER)
        self.conv = nn.Conv2d(in_channels, channels * RADIX, 3, 1, 1,
                              groups=groups * RADIX, bias=folded)
        self.fc1 = nn.Linear(channels, inter)
        self.fc2 = nn.Linear(inter, channels * RADIX)
        if not folded:
            self.bn0 = nn.BatchNorm2d(channels * RADIX, eps=BN_EPS)
            self.bn1 = nn.BatchNorm1d(inter, eps=BN_EPS)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (B, Cin, H, W) -> (B, channels, H, W), in the compute dtype."""
        c, r, g = self.channels, RADIX, self.groups
        bn = _identity if self.folded else (
            lambda name, y: batch_norm(getattr(self, name), y, train))
        x = x.to(self.compute_dtype)
        y = torch.relu(bn("bn0", conv(self.conv, x)))        # (B, C*r, H, W)
        b = y.shape[0]
        splits = y.view(b, r, c, *y.shape[2:])               # radix-major
        gap = splits.sum(dim=1).mean(dim=(2, 3))             # (B, C)
        a = torch.relu(bn("bn1", dense(self.fc1, gap)))
        a = dense(self.fc2, a).reshape(b, g, r, c // g)      # cardinality-major
        sdt = torch.promote_types(a.dtype, torch.float32)
        a = torch.softmax(a.to(sdt), dim=2).to(y.dtype)
        a = a.transpose(1, 2).reshape(b, r, c, 1, 1)         # radix-major
        return (splits * a).sum(dim=1)


class ResNeStBottleneck(nn.Module):
    def __init__(self, in_feats: int, planes: int, strides: int = 1,
                 folded: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        out_feats = planes * EXPANSION
        self.strides = strides
        self.folded = folded
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(in_feats, planes, 1, bias=folded)
        self.splat = SplitAttention(planes, planes, folded=folded,
                                    compute_dtype=compute_dtype)
        self.conv3 = nn.Conv2d(planes, out_feats, 1, bias=folded)
        self.projection = strides != 1 or in_feats != out_feats
        if self.projection:
            self.downsample_conv = nn.Conv2d(in_feats, out_feats, 1,
                                             bias=folded)
        if not folded:
            self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
            self.bn3 = nn.BatchNorm2d(out_feats, eps=BN_EPS)
            if self.projection:
                self.downsample_bn = nn.BatchNorm2d(out_feats, eps=BN_EPS)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (N, C, H, W) in channels_last memory; train: BatchNorm on the
        batch's statistics, updating the running ones (unfolded only)."""
        s = self.strides
        bn = _identity if self.folded else (
            lambda name, y: batch_norm(getattr(self, name), y, train))
        x = x.to(self.compute_dtype)
        y = torch.relu(bn("bn1", conv(self.conv1, x)))
        y = self.splat(y, train)
        if s > 1:                                  # avd, after the SplAt conv
            y = F.avg_pool2d(y, 3, s, 1)
        y = bn("bn3", conv(self.conv3, y))
        residual = x
        if self.projection:
            if s > 1:                              # avg_down
                residual = F.avg_pool2d(residual, s, s)
            residual = bn("downsample_bn",
                          conv(self.downsample_conv, residual))
        return torch.relu(y + residual)


class ResNeSt(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, folded: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 kernel: str = "block"):
        super().__init__()
        check_fused_kernel(kernel)
        self.stage_sizes = tuple(stage_sizes)
        self.width = width
        self.folded = folded
        self.compute_dtype = compute_dtype
        sw = STEM_WIDTH
        for i, (cin, cout, s) in enumerate(
                ((3, sw, 2), (sw, sw, 1), (sw, 2 * sw, 1)), start=1):
            setattr(self, f"stem_conv{i}",
                    nn.Conv2d(cin, cout, 3, s, 1, bias=folded))
            if not folded:
                setattr(self, f"stem_bn{i}", nn.BatchNorm2d(cout, eps=BN_EPS))
        in_feats = 2 * sw
        for l, n_blocks in enumerate(self.stage_sizes):
            planes = width * 2 ** l
            for i in range(n_blocks):
                strides = 2 if l > 0 and i == 0 else 1
                self.add_module(f"layer{l + 1}_{i}", ResNeStBottleneck(
                    in_feats, planes, strides, folded, compute_dtype))
                in_feats = planes * EXPANSION
        self.num_features = in_feats

    def activation_elements(self, h: int, w: int) -> int:
        """Elements of the largest activation one h x w frame makes: the
        stem's widest conv output, a stage's output, or a strided block's
        split-attention conv output, which runs before its pool at the
        stage's input size (each stride 2 rounds up)."""
        half = lambda n: -(-n // 2)
        h, w = half(h), half(w)
        most = h * w * self.stem_conv3.out_channels
        h, w = half(h), half(w)                       # the max-pool
        for l in range(len(self.stage_sizes)):
            planes = self.width * 2 ** l
            if l:
                most = max(most, h * w * planes * RADIX)
                h, w = half(h), half(w)
            most = max(most, h * w * planes * EXPANSION)
        return most

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (N, H, W, 3) -> (N, num_features); train as in
        `ResNeStBottleneck.forward` (a folded backbone is for inference
        only)."""
        if train and self.folded:
            raise ValueError("a folded backbone is for inference only; "
                             "train the unfolded one")
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        for i in (1, 2, 3):
            x = conv(getattr(self, f"stem_conv{i}"), x)
            if not self.folded:
                x = batch_norm(getattr(self, f"stem_bn{i}"), x, train)
            x = torch.relu(x)
        x = F.max_pool2d(x, 3, 2, 1)
        for l, n_blocks in enumerate(self.stage_sizes):
            for i in range(n_blocks):
                x = getattr(self, f"layer{l + 1}_{i}")(x, train)
        return x.mean(dim=(2, 3))
