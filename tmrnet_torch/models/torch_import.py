"""Reference `.pth` checkpoints in and out of the port.

Port of `tmrnet_tpu/models/torch_import.py` (`load_torch_state_dict`
:33-48, `convert_reference_checkpoint` :145-197 with the ResNet trunk
:91-119, the ResNeSt trunk :200-250, LSTM :82-88, NLBlock :122-132 and
TimeConv :135-142, `export_reference_checkpoint` :279-381). The reference
trainers name their modules `share.conv1`, `share.layer1.0...`,
`lstm.weight_ih_l0`, `nl_block.linear1..4`, `time_conv.timeconv1..3`,
`fc`, `fc_h_c` and `fc_c` (reference `train_singlenet_phase_1fc.py:
201-232`, `train_non-local_mutiConv_resnet.py:208-253`); the ResNeSt
trainer's trunk is the resnest package's (`train_non-local_mutiConv_
resnest.py:24,207-210`). Both sides are torch layouts, so the map only
renames, apart from LayerNorm's (1, F) weight, which becomes (F,), and
the split attention's 1x1 convs (O, I, 1, 1), which become Linear (O, I):

    share.conv1 / share.bn1               -> backbone.conv1 / backbone.bn1
    share.layer{l}.{i}.conv{c} / .bn{c}   -> backbone.layer{l}_{i}.conv{c} / .bn{c}
    share.layer{l}.{i}.downsample.0 / .1  -> backbone.layer{l}_{i}.downsample_conv / _bn
    lstm.{weight,bias}_{ih,hh}_l0         -> encoder.lstm.{weight,bias}_{ih,hh}
    nl_block.linear1..4                   -> nl_block.query / key / value / out
    nl_block.layer_norm                   -> nl_block.layer_norm
    time_conv.timeconv1..3                -> time_conv.conv_k3 / conv_k5 / conv_k7
    fc, fc_h_c, fc_c                      -> the same names

A ResNeSt trunk (a deep stem, `conv1.0.weight`) maps as

    share.conv1.0 / .1, conv1.3 / .4, conv1.6 / share.bn1
                                          -> backbone.stem_conv1 / stem_bn1 .. 3
    share.layer{l}.{i}.conv1 / .bn1, .conv3 / .bn3
                                          -> backbone.layer{l}_{i}.conv1 / ...
    share.layer{l}.{i}.conv2.conv / .bn0 / .fc1 / .bn1 / .fc2
                                          -> backbone.layer{l}_{i}.splat.(same)
    share.layer{l}.{i}.downsample.1 / .2  -> ....downsample_conv / _bn
                                             (downsample.0 is the pool)

Every BatchNorm gets `num_batches_tracked` 0, as `models/convert.py`
gives it (eval mode never reads it). What differs by design from JAX: JAX
merges a partial checkpoint over a fresh PRNGKey(0) init (`merge_variables`
:383), which the port cannot reproduce; `require_complete` raises instead
and names the missing keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from tmrnet_torch.config import ModelConfig

Tensor = torch.Tensor


def load_torch_state_dict(path: str) -> Dict[str, Tensor]:
    """A `.pth`/`.pt` file as a flat name -> CPU tensor dict, unwrapping a
    `{"state_dict": ...}` wrapper and DataParallel `module.` prefixes."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = _tensor(v)
    return out


def _tensor(v) -> Tensor:
    if isinstance(v, Tensor):
        return v.detach().cpu().contiguous()
    return torch.from_numpy(np.array(np.asarray(v), order="C"))


def _bn(sd, src: str, dst: str, out: Dict[str, Tensor]) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{name}"] = _tensor(sd[f"{src}.{name}"])
    out[f"{dst}.num_batches_tracked"] = torch.tensor(0)


def _linear(sd, src: str, dst: str, out: Dict[str, Tensor]) -> None:
    out[f"{dst}.weight"] = _tensor(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])


def convert_resnet_trunk(sd: Mapping[str, Any],
                         stage_sizes: Sequence[int] = (3, 4, 6, 3),
                         prefix: str = "share.") -> Dict[str, Tensor]:
    """A torchvision-style ResNet trunk -> the port's `backbone.*` keys."""
    out: Dict[str, Tensor] = {}
    out["backbone.conv1.weight"] = _tensor(sd[f"{prefix}conv1.weight"])
    _bn(sd, f"{prefix}bn1", "backbone.bn1", out)
    for l, n_blocks in enumerate(stage_sizes, start=1):
        for i in range(n_blocks):
            src, dst = f"{prefix}layer{l}.{i}", f"backbone.layer{l}_{i}"
            for c in (1, 2, 3):
                out[f"{dst}.conv{c}.weight"] = _tensor(sd[f"{src}.conv{c}.weight"])
                _bn(sd, f"{src}.bn{c}", f"{dst}.bn{c}", out)
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.downsample_conv.weight"] = _tensor(
                    sd[f"{src}.downsample.0.weight"])
                _bn(sd, f"{src}.downsample.1", f"{dst}.downsample_bn", out)
    return out


# The resnest package's deep stem: conv1.{0,3,6} are convs, conv1.{1,4}
# and the trunk's bn1 their BatchNorms.
_RESNEST_STEM = (("conv1.0", "conv1.1"), ("conv1.3", "conv1.4"),
                 ("conv1.6", "bn1"))
_SPLAT_BNS = ("bn0", "bn1")
_SPLAT_FCS = ("fc1", "fc2")


def convert_resnest_trunk(sd: Mapping[str, Any],
                          stage_sizes: Sequence[int] = (3, 4, 6, 3),
                          prefix: str = "share.") -> Dict[str, Tensor]:
    """A resnest-package ResNeSt trunk -> the port's `backbone.*` keys."""
    out: Dict[str, Tensor] = {}
    for i, (c, bn) in enumerate(_RESNEST_STEM, start=1):
        out[f"backbone.stem_conv{i}.weight"] = _tensor(
            sd[f"{prefix}{c}.weight"])
        _bn(sd, f"{prefix}{bn}", f"backbone.stem_bn{i}", out)
    for l, n_blocks in enumerate(stage_sizes, start=1):
        for i in range(n_blocks):
            src, dst = f"{prefix}layer{l}.{i}", f"backbone.layer{l}_{i}"
            for c in (1, 3):
                out[f"{dst}.conv{c}.weight"] = _tensor(sd[f"{src}.conv{c}.weight"])
                _bn(sd, f"{src}.bn{c}", f"{dst}.bn{c}", out)
            out[f"{dst}.splat.conv.weight"] = _tensor(
                sd[f"{src}.conv2.conv.weight"])
            for bn in _SPLAT_BNS:
                _bn(sd, f"{src}.conv2.{bn}", f"{dst}.splat.{bn}", out)
            for fc in _SPLAT_FCS:
                out[f"{dst}.splat.{fc}.weight"] = _tensor(
                    sd[f"{src}.conv2.{fc}.weight"])[:, :, 0, 0].contiguous()
                out[f"{dst}.splat.{fc}.bias"] = _tensor(
                    sd[f"{src}.conv2.{fc}.bias"])
            if f"{src}.downsample.1.weight" in sd:
                out[f"{dst}.downsample_conv.weight"] = _tensor(
                    sd[f"{src}.downsample.1.weight"])
                _bn(sd, f"{src}.downsample.2", f"{dst}.downsample_bn", out)
    return out


def convert_reference_checkpoint(sd: Mapping[str, Any], head: str,
                                 stage_sizes: Sequence[int] = (3, 4, 6, 3)
                                 ) -> Dict[str, Tensor]:
    """A reference `.pth` state dict -> the port's state dict (unfolded)
    for `head` ('stage1' | 'lfb' | 'tmr' | 'nl_only'): the keys the
    checkpoint holds, as JAX's conversion picks them. The trunk is a
    ResNeSt where it has a deep stem (`conv1.0.weight`), else a ResNet. A
    bare ImageNet trunk (torchvision's resnet50 or the resnest package's
    resnest50: no `share.` prefix, no LSTM) converts to the backbone
    alone; its 1000-class `fc` is dropped."""
    resnest = "share.conv1.0.weight" in sd or "conv1.0.weight" in sd
    prefix = ("share." if "share.conv1.0.weight" in sd
              or "share.conv1.weight" in sd else "")
    trunk = convert_resnest_trunk if resnest else convert_resnet_trunk
    out = trunk(sd, stage_sizes, prefix)
    if "lstm.weight_ih_l0" not in sd:
        return out
    for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        out[f"encoder.lstm.{name}"] = _tensor(sd[f"lstm.{name}_l0"])
    if head == "stage1" and "fc.weight" in sd:
        _linear(sd, "fc", "fc", out)
    if head in ("tmr", "nl_only"):
        if "nl_block.linear1.weight" in sd:
            for i, name in enumerate(("query", "key", "value", "out"), start=1):
                _linear(sd, f"nl_block.linear{i}", f"nl_block.{name}", out)
            for name in ("weight", "bias"):
                out[f"nl_block.layer_norm.{name}"] = _tensor(
                    sd[f"nl_block.layer_norm.{name}"]).reshape(-1)
        if "time_conv.timeconv1.weight" in sd:
            for k, name in ((1, "conv_k3"), (2, "conv_k5"), (3, "conv_k7")):
                _linear(sd, f"time_conv.timeconv{k}", f"time_conv.{name}", out)
        for name in ("fc_h_c", "fc_c"):
            if f"{name}.weight" in sd:
                _linear(sd, name, name, out)
    return out


def require_complete(state: Mapping[str, Tensor], cfg: ModelConfig) -> None:
    """Raise where `state` lacks a key the model of `cfg` (unfolded) needs,
    or holds one of another shape; the error names them."""
    from tmrnet_torch.models.tmrnet import state_shapes

    want = state_shapes(dataclasses.replace(cfg, folded=False))
    missing = sorted(k for k in want if k not in state)
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} keys that head "
                       f"{cfg.head!r} needs (the port does not fill them "
                       f"from a fresh init): {', '.join(missing)}")
    bad = [f"{k} {tuple(state[k].shape)} (want {want[k]})" for k in want
           if tuple(state[k].shape) != want[k]]
    if bad:
        raise ValueError(f"checkpoint shapes differ from the model's: "
                         f"{', '.join(bad)}")


def export_reference_checkpoint(state: Mapping[str, Tensor], head: str,
                                stage_sizes: Sequence[int] = (3, 4, 6, 3)
                                ) -> Dict[str, Tensor]:
    """The inverse of `convert_reference_checkpoint`: the port's unfolded
    state dict -> a reference-format state dict (`share.*` names), the
    keys JAX's export writes, a ResNeSt trunk (a `backbone.stem_conv1`)
    in the resnest package's naming; save it with `torch.save`."""
    sd: Dict[str, Tensor] = {}

    def bn(src, dst):
        for name in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{dst}.{name}"] = state[f"{src}.{name}"]

    def linear(src, dst):
        sd[f"{dst}.weight"] = state[f"{src}.weight"]
        if f"{src}.bias" in state:
            sd[f"{dst}.bias"] = state[f"{src}.bias"]

    resnest = "backbone.stem_conv1.weight" in state
    if resnest:
        for i, (c, b) in enumerate(_RESNEST_STEM, start=1):
            sd[f"share.{c}.weight"] = state[f"backbone.stem_conv{i}.weight"]
            bn(f"backbone.stem_bn{i}", f"share.{b}")
    else:
        sd["share.conv1.weight"] = state["backbone.conv1.weight"]
        bn("backbone.bn1", "share.bn1")
    # the shortcut's conv and BN: downsample.1 / .2 behind ResNeSt's pool
    down = (1, 2) if resnest else (0, 1)
    for l, n_blocks in enumerate(stage_sizes, start=1):
        for i in range(n_blocks):
            src, dst = f"backbone.layer{l}_{i}", f"share.layer{l}.{i}"
            for c in ((1, 3) if resnest else (1, 2, 3)):
                sd[f"{dst}.conv{c}.weight"] = state[f"{src}.conv{c}.weight"]
                bn(f"{src}.bn{c}", f"{dst}.bn{c}")
            if resnest:
                sd[f"{dst}.conv2.conv.weight"] = state[
                    f"{src}.splat.conv.weight"]
                for b in _SPLAT_BNS:
                    bn(f"{src}.splat.{b}", f"{dst}.conv2.{b}")
                for fc in _SPLAT_FCS:
                    sd[f"{dst}.conv2.{fc}.weight"] = state[
                        f"{src}.splat.{fc}.weight"][:, :, None, None]
                    sd[f"{dst}.conv2.{fc}.bias"] = state[
                        f"{src}.splat.{fc}.bias"]
            if f"{src}.downsample_conv.weight" in state:
                sd[f"{dst}.downsample.{down[0]}.weight"] = state[
                    f"{src}.downsample_conv.weight"]
                bn(f"{src}.downsample_bn", f"{dst}.downsample.{down[1]}")
    for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
        sd[f"lstm.{name}_l0"] = state[f"encoder.lstm.{name}"]
    if head == "stage1" and "fc.weight" in state:
        linear("fc", "fc")
    if head in ("tmr", "nl_only"):
        if "nl_block.query.weight" in state:
            for i, name in enumerate(("query", "key", "value", "out"), start=1):
                linear(f"nl_block.{name}", f"nl_block.linear{i}")
            for name in ("weight", "bias"):
                sd[f"nl_block.layer_norm.{name}"] = state[
                    f"nl_block.layer_norm.{name}"].reshape(1, -1)
        if "time_conv.conv_k3.weight" in state:
            for k, name in ((1, "conv_k3"), (2, "conv_k5"), (3, "conv_k7")):
                linear(f"time_conv.{name}", f"time_conv.timeconv{k}")
        for name in ("fc_h_c", "fc_c"):
            if f"{name}.weight" in state:
                linear(name, name)
    return {k: v.detach().cpu().contiguous() for k, v in sd.items()}
