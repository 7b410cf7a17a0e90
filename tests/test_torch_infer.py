"""The port's ClipInference (CPU) against the JAX ClipInference's per-batch
step on the same bank, rows and uint8 clips; the uint8 wire convention
against JAX's DevicePrep; multi-crop averaging and padding."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import MemoryConfig as JaxMemoryConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.data.device_feed import DevicePrep as JaxDevicePrep
from tmrnet_tpu.data.indexing import memory_window_rows as jax_window_rows
from tmrnet_tpu.eval.infer import ClipInference as JaxClipInference
from tmrnet_tpu.memory.lfb import FeatureBank as JaxFeatureBank
from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
from tmrnet_torch.data.device_feed import DevicePrep
from tmrnet_torch.eval.infer import ClipInference, memoryless_head
from tmrnet_torch.memory.lfb import FeatureBank
from tmrnet_torch.models.convert import from_jax_variables

torch.set_num_threads(2)

HID, WIN, SEQ, HW, ROWS = 16, 6, 3, 32, 40
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
             num_classes=7, head="tmr", compute_dtype="float32")


def _setup(head="tmr"):
    model_kw = dict(MODEL, head=head)
    jcfg = JaxExperimentConfig(
        data=JaxDataConfig(device_normalize=True),
        model=JaxModelConfig(**model_kw), memory=JaxMemoryConfig(window=WIN))
    model = jax_build_model(jcfg.model)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, SEQ, HW, HW, 3)),
                           jnp.zeros((1, WIN, HID)))
    rng = np.random.RandomState(1)
    feats = rng.randn(ROWS, HID).astype(np.float32)
    firsts = np.repeat(np.array([0, 25], np.int32), [25, 15])
    jbank = JaxFeatureBank(jnp.asarray(feats), jnp.asarray(firsts))
    tcfg = ExperimentConfig(data=DataConfig(device_normalize=True),
                            model=ModelConfig(**model_kw),
                            memory=MemoryConfig(window=WIN))
    tbank = FeatureBank(torch.from_numpy(feats), torch.from_numpy(firsts))
    state = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    return (JaxClipInference(jcfg, variables, jbank),
            ClipInference(tcfg, state, tbank, device="cpu"), firsts, rng)


@pytest.mark.parametrize("head", ["tmr", "nl_only"])
def test_clip_inference_matches_jax_per_batch(head):
    jeng, teng, firsts, rng = _setup(head)
    clips = rng.randint(0, 256, (4, SEQ, HW, HW, 3)).astype(np.uint8)
    rows = np.array([3, 0, 27, 39])
    idx = jax_window_rows(rows, firsts[rows], WIN).astype(np.int32)
    want_pred, want_probs = jeng._infer(jeng.variables, jeng._features,
                                        jnp.asarray(clips), jnp.asarray(idx))
    res = teng.run([(clips, np.zeros(4, np.int64), rows, 0)], firsts)
    np.testing.assert_allclose(res.scores, np.asarray(want_probs), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(res.preds, np.asarray(want_pred))
    np.testing.assert_array_equal(res.rows, rows)


def test_multicrop_and_padding():
    _, teng, firsts, rng = _setup()
    crops = rng.randint(0, 256, (3, 2, SEQ, HW, HW, 3)).astype(np.uint8)
    rows = np.array([5, 30, 30])
    labels = np.array([1, 2, 0])
    res = teng.run([(crops, labels, rows, 1)], firsts)
    assert res.scores.shape == (2, 7) and res.preds.shape == (2,)
    flat = crops.reshape((-1,) + crops.shape[2:])
    idx = teng.window_rows(np.repeat(rows, 2), firsts)
    _, probs = teng.infer(torch.from_numpy(flat), torch.from_numpy(idx))
    want = probs.numpy().reshape(3, 2, -1).mean(axis=1)[:2]
    np.testing.assert_allclose(res.scores, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_prep_matches_jax(norm, dtype):
    frames = np.random.RandomState(2).randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    want = JaxDevicePrep(JaxDataConfig(device_normalize=norm), dtype)(
        jnp.asarray(frames))
    got = DevicePrep(DataConfig(device_normalize=norm), dtype, "cpu")(
        torch.from_numpy(frames))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_memoryless_head_rule():
    assert not memoryless_head("tmr") and not memoryless_head("nl_only")
    assert memoryless_head("stage1")
    with pytest.raises(ValueError, match="feature extractor"):
        memoryless_head("lfb")
