"""The engines and the `test` command on a ResNeSt trunk (CPU) against the
JAX package's: `VideoInference.run_video` and `bank_features`, one
`StreamingInference` step after a full clip, and `python -m tmrnet_torch
test --set model.backbone=resnest50` against `python -m tmrnet_tpu test`
with the same arguments over the same reference `.pth` files (written by
JAX's export in the resnest package's naming) and packed frames.

ResNeSt at stage sizes (1, 1) and width 8 (its stem is 32 / 32 / 64 wide
whatever the width), hidden 16, f32, sequence_length 4, window 4.
Tolerance 1e-4 (rtol and atol) on probabilities, features and state: the
same math, summed in another order by XLA and PyTorch's CPU kernels."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu import cli as jax_cli
from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import EvalConfig as JaxEvalConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import CHOLEC80_PHASES
from tmrnet_tpu.config import MemoryConfig as JaxMemoryConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.eval.infer import VideoInference as JaxVideoInference
from tmrnet_tpu.eval.stream import StreamingInference as JaxStreamingInference
from tmrnet_tpu.models.torch_import import export_reference_checkpoint
from tmrnet_torch import cli
from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
from tmrnet_torch.eval.infer import VideoInference
from tmrnet_torch.eval.stream import StreamingInference
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.resnest import ResNeSt

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, WIN, HID, HW, CLASSES = 4, 4, 16, 32, 5
LENGTHS = (3, 9, 14)
MODEL = dict(backbone="resnest50", stage_sizes=(1, 1), width=8,
             hidden_dim=HID, num_classes=CLASSES, head="tmr",
             compute_dtype="float32")


def _configs():
    jcfg = JaxExperimentConfig(
        data=JaxDataConfig(device_normalize=True, sequence_length=SEQ),
        model=JaxModelConfig(**MODEL), memory=JaxMemoryConfig(window=WIN))
    tcfg = ExperimentConfig(
        data=DataConfig(device_normalize=True, sequence_length=SEQ),
        model=ModelConfig(**MODEL), memory=MemoryConfig(window=WIN))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    return (random_variables(ModelConfig(**MODEL), 21),
            random_variables(ModelConfig(**dict(MODEL, head="lfb")), 22))


def _tree(v):
    return jax.tree_util.tree_map(jnp.asarray, v)


def test_run_video_and_bank_features_match_jax(weights):
    jcfg, tcfg = _configs()
    variables, extractor = weights
    port = VideoInference(tcfg, from_jax_variables(variables),
                          from_jax_variables(extractor), device="cpu",
                          backbone_chunk=5)
    assert isinstance(port.model.backbone, ResNeSt)
    jeng = JaxVideoInference(jcfg, _tree(variables), _tree(extractor),
                             pad_frames=16, bucket_step=8)
    rng = np.random.default_rng(23)
    for n in LENGTHS:
        video = rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
        preds, probs = port.run_video(video)
        want_preds, want_probs = jeng.run_video(video)
        assert probs.shape == (max(0, n - SEQ + 1), CLASSES)
        np.testing.assert_allclose(probs, np.asarray(want_probs), **TOL)
        np.testing.assert_array_equal(preds, np.asarray(want_preds))
        if n >= SEQ:
            np.testing.assert_allclose(port.bank_features(video).numpy(),
                                       np.asarray(jeng.bank_features(video)),
                                       **TOL)


def test_stream_step_matches_jax(weights):
    """SEQ steps of 2 streams, the second inactive at the first step: the
    last step's outputs (valid for stream 0 only) and the whole state."""
    jcfg, tcfg = _configs()
    variables, extractor = weights
    jax_stream = JaxStreamingInference(jcfg, _tree(variables), _tree(extractor))
    port = StreamingInference(tcfg, from_jax_variables(variables),
                              from_jax_variables(extractor), device="cpu")
    frames = np.random.default_rng(24).integers(
        0, 256, (SEQ, 2, HW, HW, 3), dtype=np.uint8)
    jstate, state = jax_stream.init_state(2), port.init_state(2)
    for t in range(SEQ):
        active = [True, t > 0]
        jstate, jp, jpr, jv = jax_stream.step(jstate, frames[t], active=active)
        state, p, pr, v = port.step(state, frames[t], active=active)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert v.numpy().tolist() == [True, False]
    np.testing.assert_allclose(pr.numpy()[0], np.asarray(jpr)[0], **TOL)
    assert int(p[0]) == int(jp[0])
    for a, b in zip((state.ext_ring, state.tmr_ring, state.bank_ring,
                     state.count), (jstate.ext_ring, jstate.tmr_ring,
                                    jstate.bank_ring, jstate.count)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_cli_test_matches_jax(tmp_path):
    """`test --set model.backbone=resnest50` over a config written with
    the tiny ResNet: the override picks the trunk, the `.pth` files hold
    the resnest package's names. The corpus engine in both packages, the
    port's video engine too."""
    cfg = JaxExperimentConfig(
        data=JaxDataConfig(sequence_length=SEQ, resize=40, crop_size=HW,
                           test_crop_type=1, device_normalize=True,
                           batch_clips=8, num_workers=2),
        model=JaxModelConfig(**dict(MODEL, backbone="tiny")),
        memory=JaxMemoryConfig(window=WIN), eval=JaxEvalConfig(batch_clips=8))
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    for name, head, seed in (("model", "tmr", 31), ("extractor", "lfb", 32)):
        variables = random_variables(ModelConfig(**dict(MODEL, head=head)), seed)
        sd = export_reference_checkpoint(variables, head, (1, 1))
        assert "share.conv1.0.weight" in sd
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   tmp_path / f"{name}.pth")
    (tmp_path / "frames").mkdir()
    (tmp_path / "ann").mkdir()
    rng = np.random.default_rng(33)
    lengths = (11, 6, 2)
    for v, n in enumerate(lengths):
        np.save(tmp_path / "frames" / f"video{v + 1:02d}.npy",
                rng.integers(0, 256, (n, 40, 40, 3), dtype=np.uint8))
        rows = [f"{25 * k}\t{CHOLEC80_PHASES[(k // 3 + v) % CLASSES]}\n"
                for k in range(n)]
        (tmp_path / "ann" / f"video{v + 1:02d}-phase.txt").write_text(
            "Frame\tPhase\n" + "".join(rows))
    common = ["--config", str(tmp_path / "cfg.json"),
              "--set", "model.backbone=resnest50"]
    assert cli.main(["manifest", *common[:2], "--frames",
                     str(tmp_path / "frames"), "--annotations",
                     str(tmp_path / "ann"), "--out",
                     str(tmp_path / "m.pkl")]) == 0
    test = ["test", *common, "--manifest", str(tmp_path / "m.pkl"),
            "--torch-ckpt", str(tmp_path / "model.pth"),
            "--extractor-torch-ckpt", str(tmp_path / "extractor.pth")]
    runs = {"jax": (jax_cli.main, ["--engine", "corpus", "--set",
                                   "mesh.data_parallel=1"]),
            "corpus": (cli.main, ["--engine", "corpus", "--device", "cpu"]),
            "video": (cli.main, ["--engine", "video", "--device", "cpu"])}
    out = {}
    for name, (main, extra) in runs.items():
        assert main([*test, *extra, "--out", str(tmp_path / f"{name}.npz")]) == 0
        with np.load(tmp_path / f"{name}.npz") as z:
            out[name] = {k: z[k] for k in ("preds", "scores", "rows")}
    clips = sum(max(0, n - SEQ + 1) for n in lengths)
    assert out["jax"]["scores"].shape == (clips, CLASSES)
    for name in ("corpus", "video"):
        np.testing.assert_allclose(out[name]["scores"], out["jax"]["scores"],
                                   rtol=0, atol=TOL["atol"])
        np.testing.assert_array_equal(out[name]["preds"], out["jax"]["preds"])
        np.testing.assert_array_equal(out[name]["rows"], out["jax"]["rows"])
