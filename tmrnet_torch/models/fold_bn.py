"""BatchNorm folding for inference, on the port's state dicts.

Port of `tmrnet_tpu/models/fold_bn.py` (`_fold_pair` / `fold_resnet`
:22-50, `fold_resnest` :53-87, `fold_variables` :90-105). In eval mode
BatchNorm is an affine map, so it folds into the preceding conv (torch
layout (O, I, kh, kw)) or Linear ((O, I)), row by output row:

    w'[o] = w[o] * g[o]          g = scale / sqrt(var + eps)
    b'[o] = bias[o] - mean[o] * g[o]   (+ layer_bias[o] * g[o])

The result loads into the same backbone built with `folded=True`.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor


def _fold_pair(state: Dict[str, Tensor], conv: str, bn: str,
               eps: float) -> Dict[str, Tensor]:
    g = state[f"{bn}.weight"] / torch.sqrt(state[f"{bn}.running_var"] + eps)
    w = state[f"{conv}.weight"]
    weight = w * g.reshape((-1,) + (1,) * (w.dim() - 1))
    bias = state[f"{bn}.bias"] - state[f"{bn}.running_mean"] * g
    if f"{conv}.bias" in state:
        bias = bias + state[f"{conv}.bias"] * g
    return {f"{conv}.weight": weight, f"{conv}.bias": bias}


def fold_resnet(state: Dict[str, Tensor], eps: float = 1e-5
                ) -> Dict[str, Tensor]:
    """Unfolded ResNet state (keys relative to the backbone) -> folded."""
    out = _fold_pair(state, "conv1", "bn1", eps)
    blocks = sorted({k.split(".")[0] for k in state if k.startswith("layer")})
    for name in blocks:
        for c in ("conv1", "conv2", "conv3"):
            out.update(_fold_pair(state, f"{name}.{c}",
                                  f"{name}.{c.replace('conv', 'bn')}", eps))
        if f"{name}.downsample_conv.weight" in state:
            out.update(_fold_pair(state, f"{name}.downsample_conv",
                                  f"{name}.downsample_bn", eps))
    return out


def fold_resnest(state: Dict[str, Tensor], eps: float = 1e-5
                 ) -> Dict[str, Tensor]:
    """Unfolded ResNeSt state (keys relative to the backbone) -> folded:
    the deep stem's three convs, each block's conv1, conv3 and shortcut,
    and in its split attention the grouped conv (bn0) and the Linear fc1
    (bn1); fc2 passes through."""
    out: Dict[str, Tensor] = {}
    for i in (1, 2, 3):
        out.update(_fold_pair(state, f"stem_conv{i}", f"stem_bn{i}", eps))
    blocks = sorted({k.split(".")[0] for k in state if k.startswith("layer")})
    for name in blocks:
        for c, bn in (("conv1", "bn1"), ("conv3", "bn3"),
                      ("splat.conv", "splat.bn0"), ("splat.fc1", "splat.bn1")):
            out.update(_fold_pair(state, f"{name}.{c}", f"{name}.{bn}", eps))
        for p in ("weight", "bias"):
            out[f"{name}.splat.fc2.{p}"] = state[f"{name}.splat.fc2.{p}"]
        if f"{name}.downsample_conv.weight" in state:
            out.update(_fold_pair(state, f"{name}.downsample_conv",
                                  f"{name}.downsample_bn", eps))
    return out


def fold_variables(state: Dict[str, Tensor], backbone_key: str = "backbone",
                   eps: float = 1e-5) -> Dict[str, Tensor]:
    """Fold the backbone of a whole model's state dict; every other entry
    passes through. ResNet or ResNeSt by the keys: a deep stem
    (`stem_conv1.weight`) is ResNeSt."""
    prefix = backbone_key + "."
    backbone = {k[len(prefix):]: v for k, v in state.items()
                if k.startswith(prefix)}
    out = {k: v for k, v in state.items() if not k.startswith(prefix)}
    fold = fold_resnest if "stem_conv1.weight" in backbone else fold_resnet
    out.update({prefix + k: v for k, v in fold(backbone, eps).items()})
    return out
