"""Reference `.pth` interop and the g_LFB `.pkl` bank in the port, against
the JAX package's.

A reference-format state dict is built by JAX's
`export_reference_checkpoint` from seeded flax variables, for each head.
The port's `convert_reference_checkpoint` must give, key for key and bit
for bit, what `from_jax_variables` makes of JAX's conversion; the port's
export must give back the reference dict exactly (and equal JAX's export).
A real `torch.save` with a `state_dict` wrapper and DataParallel `module.`
prefixes loads through `load_torch_state_dict`. A checkpoint missing a key
the head needs raises. A ResNeSt trunk in the resnest package's naming
(`share.` or a bare ImageNet trunk) converts as JAX's conversion does, and
the port's export of a ResNeSt model equals JAX's and reads back to the
same state dict. `.pkl` banks (numpy and torch)
load as JAX's do, a wrong row count raises, and a pickle of any other
object is refused. Exact comparisons: the
map only renames."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tmrnet_tpu.memory import lfb as jax_lfb
from tmrnet_tpu.models import torch_import as jax_import
from tmrnet_torch.config import ModelConfig
from tmrnet_torch.memory import lfb
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.torch_import import (
    convert_reference_checkpoint,
    export_reference_checkpoint,
    load_torch_state_dict,
    require_complete,
)
from tmrnet_torch.models.tmrnet import build_model

STAGES = (1, 1, 1, 1)
HEADS = ["stage1", "lfb", "tmr", "nl_only"]


def _cfg(head, backbone="resnet50"):
    return ModelConfig(backbone=backbone, stage_sizes=STAGES, width=8,
                       hidden_dim=16, num_classes=5, head=head,
                       compute_dtype="float32")


def _reference(head, seed=3, backbone="resnet50"):
    variables = random_variables(_cfg(head, backbone), seed)
    return variables, jax_import.export_reference_checkpoint(variables, head,
                                                             STAGES)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("head", HEADS)
def test_convert_equals_jax_conversion_and_exports_back(head):
    _, sd = _reference(head)
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    state = convert_reference_checkpoint(torch_sd, head, STAGES)
    _assert_same(state, from_jax_variables(
        jax_import.convert_reference_checkpoint(sd, head, STAGES)))
    # numpy values convert the same
    _assert_same(convert_reference_checkpoint(sd, head, STAGES), state)
    require_complete(state, _cfg(head))
    build_model(_cfg(head), device="cpu").load_state_dict(state, strict=True)
    back = export_reference_checkpoint(state, head, STAGES)
    _assert_same(back, torch_sd)


@pytest.mark.parametrize("head", HEADS)
def test_resnest_export_equals_jax_and_reads_back(head):
    """The port's export of a ResNeSt state dict equals JAX's export of
    the same variables (the deep stem as `conv1.{0,1,3,4,6}` and `bn1`,
    the split attention's fc1 / fc2 as 1x1 convs, the shortcut at
    `downsample.{1,2}`), and the import reads it back to the state dict,
    which the model loads."""
    variables, want = _reference(head, seed=5, backbone="resnest50")
    state = from_jax_variables(variables)
    sd = export_reference_checkpoint(state, head, STAGES)
    _assert_same(sd, {k: torch.from_numpy(v) for k, v in want.items()})
    assert sd["share.layer1.0.conv2.fc1.weight"].dim() == 4
    assert "share.layer2.0.downsample.1.weight" in sd
    back = convert_reference_checkpoint(sd, head, STAGES)
    _assert_same(back, state)
    build_model(_cfg(head, "resnest50"), device="cpu").load_state_dict(
        back, strict=True)


@pytest.mark.parametrize("wrap", ["bare", "state_dict", "module_prefix"])
def test_load_torch_state_dict_unwraps(tmp_path, wrap):
    _, sd = _reference("tmr")
    torch_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    obj = {"bare": torch_sd,
           "state_dict": {"state_dict": torch_sd, "epoch": 3},
           "module_prefix": {"module." + k: v for k, v in torch_sd.items()}
           }[wrap]
    path = str(tmp_path / "ref.pth")
    torch.save(obj, path)
    loaded = load_torch_state_dict(path)
    _assert_same(loaded, torch_sd)
    _assert_same(convert_reference_checkpoint(loaded, "tmr", STAGES),
                 from_jax_variables(jax_import.convert_reference_checkpoint(
                     jax_import.load_torch_state_dict(path), "tmr", STAGES)))


@pytest.mark.parametrize("case", ["missing_head", "missing_lstm", "shape",
                                  "resnest_share", "resnest_bare"])
def test_incomplete_or_unported_checkpoints_raise(case):
    if case.startswith("resnest"):
        # a resnest-package trunk, with the `share.` prefix and the head or
        # as a bare ImageNet trunk with a 1000-class fc: JAX's conversion,
        # and a missing key named as a ResNet one is
        _, sd = _reference("tmr", backbone="resnest50")
        if case == "resnest_bare":
            sd = {k[len("share."):]: v for k, v in sd.items()
                  if k.startswith("share.")}
            sd["fc.weight"] = np.zeros((1000, 64), np.float32)
        state = convert_reference_checkpoint(
            {k: torch.from_numpy(v) for k, v in sd.items()}, "tmr", STAGES)
        _assert_same(state, from_jax_variables(
            jax_import.convert_reference_checkpoint(sd, "tmr", STAGES)))
        cfg = _cfg("tmr", "resnest50")
        if case == "resnest_share":
            require_complete(state, cfg)
            del state["backbone.layer2_0.splat.bn1.running_var"]
            missing = "backbone.layer2_0.splat.bn1.running_var"
        else:
            assert all(k.startswith("backbone.") for k in state)
            missing = "encoder.lstm.weight_ih"
        with pytest.raises(KeyError, match=missing):
            require_complete(state, cfg)
        return
    _, sd = _reference("tmr")
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    if case == "missing_head":
        del sd["fc_c.weight"], sd["time_conv.timeconv2.bias"]
        state = convert_reference_checkpoint(sd, "tmr", STAGES)
        with pytest.raises(KeyError, match="time_conv.conv_k5.bias"):
            require_complete(state, _cfg("tmr"))
    elif case == "missing_lstm":
        # an ImageNet-style trunk alone: the backbone converts, the rest is
        # named missing
        sd = {k: v for k, v in sd.items() if k.startswith("share.")}
        state = convert_reference_checkpoint(sd, "tmr", STAGES)
        assert all(k.startswith("backbone.") for k in state)
        with pytest.raises(KeyError, match="encoder.lstm.weight_ih"):
            require_complete(state, _cfg("tmr"))
    else:
        state = convert_reference_checkpoint(sd, "tmr", STAGES)
        with pytest.raises(ValueError, match="fc_c.weight"):
            require_complete(state, dataclasses.replace(_cfg("tmr"),
                                                        num_classes=7))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_pkl_bank_loads_as_jax_does(tmp_path, kind):
    seq, lengths = 3, [5, 7, 2]
    rows = int(lfb.clips_per_video(seq, lengths).sum())
    feats = np.random.default_rng(4).standard_normal((rows, 16), np.float32)
    path = str(tmp_path / f"g_LFB_{kind}.pkl")
    with open(path, "wb") as f:
        pickle.dump(torch.from_numpy(feats) if kind == "torch" else feats, f)
    for kw in ({}, dict(seq_len=seq, video_lengths=lengths)):
        got = lfb.load_bank(path, device="cpu", **kw)
        want = jax_lfb.load_bank(path, **kw)
        np.testing.assert_array_equal(got.features.numpy(),
                                      np.asarray(want.features))
        np.testing.assert_array_equal(got.first_rows.numpy(),
                                      np.asarray(want.first_rows))
    with pytest.raises(ValueError, match="clip positions"):
        lfb.load_bank(path, device="cpu", seq_len=seq, video_lengths=[5, 6])
    # the port's .pkl is the reference's format: JAX reads it back
    out = str(tmp_path / "port.pkl")
    lfb.save_bank(out, lfb.FeatureBank(torch.from_numpy(feats).bfloat16(),
                                       torch.zeros(rows, dtype=torch.int32)))
    with open(out, "rb") as f:
        arr = pickle.load(f)
    assert isinstance(arr, np.ndarray) and arr.dtype == np.float32
    np.testing.assert_array_equal(
        np.asarray(jax_lfb.load_bank(out).features),
        torch.from_numpy(feats).bfloat16().float().numpy())
    assert jnp.asarray(arr).shape == (rows, 16)


class _RunsCode:
    """A pickle that would call a function on load."""

    def __reduce__(self):
        return (print, ("a bank pickle ran code",))


def test_pkl_bank_refuses_what_is_not_an_array(tmp_path):
    """The port reads a `.pkl` bank under an allowlist (a numpy array or a
    torch tensor); any other global in the file is refused before it is
    called."""
    path = str(tmp_path / "g_LFB.pkl")
    with open(path, "wb") as f:
        pickle.dump(_RunsCode(), f)
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        lfb.load_bank(path, device="cpu")
