"""ResNet v1.5 backbone (the stride on the 3x3 conv), NHWC at the interface.

Port of `tmrnet_tpu/models/resnet.py:21-99`. Frames come in as (N, H, W, 3)
and activations stay in `channels_last` memory, so a block's input viewed as
NHWC is contiguous. Unfolded, every conv is followed by BatchNorm in eval
mode (eps 1e-5). Folded (BN pre-folded into the convs, `models/fold_bn.py`),
every stride-1 identity block runs as one fused-bottleneck kernel, the
role `tmrnet_tpu/experimental/fused_resnet.py::apply_fused_resnet` (:68-108)
plays in JAX; the stem and the strided/projection blocks stay on
`torch.nn.functional.conv2d`, as JAX leaves them to XLA. ResNet-50 has 12
such identity blocks. `kernel` picks the fused kernel as
`apply_fused_resnet(kernel=...)` does (:87-105): "block" sends every
identity block to `fused_bottleneck`; "tiled" sends those with C < 2048 to
`fused_bottleneck_tiled` (10 in ResNet-50) and the others (stage 4's 2) to
`fused_bottleneck`.

Names follow the flax tree: `conv1`, `bn1`, `layer{l}_{i}.conv1..3`,
`.bn1..3`, `.downsample_conv`, `.downsample_bn`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmrnet_torch.experimental.fused_bottleneck import fused_bottleneck
from tmrnet_torch.experimental.fused_bottleneck_tiled import fused_bottleneck_tiled

EXPANSION = 4
BN_EPS = 1e-5
FUSED_KERNELS = ("block", "tiled")
# Identity blocks this wide stay on the block kernel under kernel="tiled"
# (fused_resnet.py:91: the TPU's VMEM could not hold stage 4's weights twice).
TILED_MAX_C = 2048


def check_fused_kernel(kernel: str) -> str:
    if kernel not in FUSED_KERNELS:
        raise ValueError(f"fused kernel {kernel!r}: want one of {FUSED_KERNELS}")
    return kernel


def conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.conv2d(x, layer.weight.to(x.dtype), bias, layer.stride,
                    layer.padding)


def batch_norm(layer: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm with its parameters cast to x's dtype."""
    cast = lambda t: t.to(x.dtype)
    return F.batch_norm(x, cast(layer.running_mean), cast(layer.running_var),
                        cast(layer.weight), cast(layer.bias), False, 0.0,
                        BN_EPS)


class Bottleneck(nn.Module):
    def __init__(self, in_feats: int, planes: int, strides: int = 1,
                 folded: bool = False, kernel: str = "block"):
        super().__init__()
        out_feats = planes * EXPANSION
        self.strides = strides
        self.folded = folded
        self.kernel = check_fused_kernel(kernel)
        mk = lambda i, o, k, s, p: nn.Conv2d(i, o, k, s, p, bias=folded)
        self.conv1 = mk(in_feats, planes, 1, 1, 0)
        self.conv2 = mk(planes, planes, 3, strides, 1)
        self.conv3 = mk(planes, out_feats, 1, 1, 0)
        self.projection = strides != 1 or in_feats != out_feats
        if self.projection:
            self.downsample_conv = mk(in_feats, out_feats, 1, strides, 0)
        if not folded:
            self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
            self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
            self.bn3 = nn.BatchNorm2d(out_feats, eps=BN_EPS)
            if self.projection:
                self.downsample_bn = nn.BatchNorm2d(out_feats, eps=BN_EPS)

    def fused_weights(self, dtype: torch.dtype):
        """(w1 (C, P), b1, w2 (3, 3, P, P), b2, w3 (P, C), b3) for the
        fused kernel: weights in `dtype`, biases in f32."""
        w = lambda layer, perm: layer.weight.permute(*perm).to(dtype).contiguous()
        b = lambda layer: layer.bias.float().contiguous()
        return (w(self.conv1, (2, 3, 1, 0))[0, 0], b(self.conv1),
                w(self.conv2, (2, 3, 1, 0)), b(self.conv2),
                w(self.conv3, (2, 3, 1, 0))[0, 0], b(self.conv3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W) in channels_last memory."""
        if self.folded and not self.projection:
            xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            op = (fused_bottleneck_tiled
                  if self.kernel == "tiled" and xh.shape[-1] < TILED_MAX_C
                  else fused_bottleneck)
            y = op(xh, *self.fused_weights(x.dtype))
            return y.permute(0, 3, 1, 2)
        bn = (lambda name, y: y) if self.folded else (
            lambda name, y: batch_norm(getattr(self, name), y))
        y = torch.relu(bn("bn1", conv(self.conv1, x)))
        y = torch.relu(bn("bn2", conv(self.conv2, y)))
        y = bn("bn3", conv(self.conv3, y))
        residual = x
        if self.projection:
            residual = bn("downsample_bn", conv(self.downsample_conv, x))
        return torch.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, folded: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 kernel: str = "block"):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.folded = folded
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=folded)
        if not folded:
            self.bn1 = nn.BatchNorm2d(width, eps=BN_EPS)
        in_feats = width
        for l, n_blocks in enumerate(self.stage_sizes):
            planes = width * 2 ** l
            for i in range(n_blocks):
                strides = 2 if l > 0 and i == 0 else 1
                self.add_module(f"layer{l + 1}_{i}", Bottleneck(
                    in_feats, planes, strides, folded, kernel))
                in_feats = planes * EXPANSION
        self.num_features = in_feats

    def activation_elements(self, h: int, w: int) -> int:
        """Elements of the largest activation one h x w frame makes: the
        stem's conv output or a stage's output (each stride 2 rounds up)."""
        half = lambda n: -(-n // 2)
        h, w = half(h), half(w)
        most = h * w * self.conv1.out_channels
        h, w = half(h), half(w)                       # the max-pool
        for l in range(len(self.stage_sizes)):
            if l:
                h, w = half(h), half(w)
            most = max(most, h * w * self.conv1.out_channels * 2 ** l
                       * EXPANSION)
        return most

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) -> (N, num_features)."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = conv(self.conv1, x)
        if not self.folded:
            x = batch_norm(self.bn1, x)
        x = F.max_pool2d(torch.relu(x), 3, 2, 1)
        for l, n_blocks in enumerate(self.stage_sizes):
            for i in range(n_blocks):
                x = getattr(self, f"layer{l + 1}_{i}")(x)
        return x.mean(dim=(2, 3))
