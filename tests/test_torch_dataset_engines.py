"""The port's dataset-taking engines (CPU, f32) against the JAX package's
on the same packed manifest, transform and weights:
`ClipInference.run(ds)` (head tmr with clamped windows and under
`memory.compat_cross_video`, ten-crop, head stage1, a float and a uint8
wire) and `build_lfb` (the clip engine and `engine="video"`), with the
padded last batch of a 35-clip dataset in 8-clip batches.

Tiny backbone, f32, sequence_length 4, window 4, weights from the port's
seeded flax-layout variables on both sides. Predictions equal; scores
within 1e-4 absolute; bank features within 1e-4 of max |feature| (the same
math, summed in another order by XLA and PyTorch's CPU kernels)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import EvalConfig as JaxEvalConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import MemoryConfig as JaxMemoryConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.data import manifests as jax_manifests
from tmrnet_tpu.data import pipeline as jax_pipeline
from tmrnet_tpu.data import transforms as jax_transforms
from tmrnet_tpu.eval.infer import ClipInference as JaxClipInference
from tmrnet_tpu.memory.lfb import FeatureBank as JaxFeatureBank
from tmrnet_tpu.train.loop import build_lfb as jax_build_lfb
from tmrnet_torch.config import DataConfig, EvalConfig, ExperimentConfig
from tmrnet_torch.config import MemoryConfig, ModelConfig
from tmrnet_torch.data import manifests, pipeline, transforms
from tmrnet_torch.eval.infer import ClipInference
from tmrnet_torch.memory.lfb import FeatureBank
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.train.loop import build_lfb

torch.set_num_threads(2)

SEQ, WIN, HID, HW, CROP, CLASSES, BATCH = 4, 4, 16, 40, 32, 5, 8
LENGTHS = (13, 4, 9, 3, 21)          # 35 clip positions
ATOL = 1e-4
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
             num_classes=CLASSES, head="tmr", compute_dtype="float32")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Packed videos, each package's manifest of them, the seeded weights
    (model heads tmr and stage1, the extractor) and a seeded bank."""
    d = tmp_path_factory.mktemp("engines")
    rng = np.random.default_rng(21)
    out = {"manifest": {}}
    for mod in (manifests, jax_manifests):
        videos = []
        for v, n in enumerate(LENGTHS):
            path = d / f"v{v}.npy"
            if not path.exists():
                np.save(path, rng.integers(0, 256, (n, HW, HW, 3),
                                           dtype=np.uint8))
            videos.append(mod.VideoRecord(
                f"v{v}", [f"{path}#{j}" for j in range(n)],
                ((np.arange(n) + v) % CLASSES).astype(np.int64)))
        out["manifest"][mod] = mod.Manifest(videos)
    out["weights"] = {head: random_variables(ModelConfig(**dict(MODEL, head=head)),
                                             seed)
                      for head, seed in (("tmr", 1), ("stage1", 2), ("lfb", 3))}
    out["bank"] = rng.standard_normal((35, HID), dtype=np.float32)
    out["dir"] = d
    return out


def _configs(head="tmr", crop=1, device_normalize=True, compat=False, **data):
    model = dict(MODEL, head=head)
    data = dict(sequence_length=SEQ, resize=HW, crop_size=CROP,
                test_crop_type=crop, device_normalize=device_normalize,
                num_workers=2, batch_clips=BATCH, **data)
    mem = dict(window=WIN, compat_cross_video=compat)
    jcfg = JaxExperimentConfig(data=JaxDataConfig(**data),
                               model=JaxModelConfig(**model),
                               memory=JaxMemoryConfig(**mem),
                               eval=JaxEvalConfig(batch_clips=BATCH))
    tcfg = ExperimentConfig(data=DataConfig(**data), model=ModelConfig(**model),
                            memory=MemoryConfig(**mem),
                            eval=EvalConfig(batch_clips=BATCH))
    return jcfg, tcfg


def _datasets(world, cfg):
    d = cfg.data
    tf = dict(crop_size=d.crop_size, resize=d.resize, crop_type=d.test_crop_type,
              normalize=not d.device_normalize)
    port = pipeline.ClipDataset(world["manifest"][manifests], SEQ,
                                transform=transforms.EvalTransform(**tf))
    jax_ds = jax_pipeline.ClipDataset(world["manifest"][jax_manifests], SEQ,
                                      transform=jax_transforms.EvalTransform(**tf))
    return port, jax_ds


@pytest.mark.parametrize("head,crop,device_normalize,compat", [
    ("tmr", 1, True, False),
    ("tmr", 1, False, True),            # a float wire, the cross-video table
    ("nl_only", 10, True, False),       # ten-crop, softmax averaged
    ("stage1", 1, True, False),         # no bank
])
def test_run_ds_matches_jax(world, head, crop, device_normalize, compat):
    jcfg, tcfg = _configs(head, crop, device_normalize, compat)
    variables = world["weights"]["stage1" if head == "stage1" else "tmr"]
    if head == "nl_only":
        variables = dict(variables, params={
            k: v for k, v in variables["params"].items() if k != "time_conv"})
    feats = world["bank"]
    firsts = np.zeros(len(feats), np.int32)     # run(ds) reads the dataset's
    memoryless = head == "stage1"
    jbank = None if memoryless else JaxFeatureBank(jnp.asarray(feats),
                                                   jnp.asarray(firsts))
    tbank = None if memoryless else FeatureBank(torch.from_numpy(feats),
                                                torch.from_numpy(firsts))
    port_ds, jax_ds = _datasets(world, tcfg)
    want = JaxClipInference(jcfg, jax.tree_util.tree_map(jnp.asarray, variables),
                            jbank).run(jax_ds)
    got = ClipInference(tcfg, from_jax_variables(variables), tbank,
                        device="cpu").run(port_ds)
    assert got.scores.shape == (35, CLASSES) == want.scores.shape
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got.preds, want.preds)
    np.testing.assert_array_equal(got.rows, np.arange(35))
    assert got.accuracy == want.accuracy == float(
        (got.preds == port_ds.clip_labels).mean())


def test_run_ds_compat_reads_the_quirk_table(world):
    """Under compat_cross_video the first clip of a video reads the last
    rows of the one before, so its scores differ from the clamped run's;
    rows past the first `window` of every video score the same."""
    runs = {}
    for compat in (False, True):
        _, tcfg = _configs(compat=compat)
        ds, _ = _datasets(world, tcfg)
        feats = torch.from_numpy(world["bank"])
        runs[compat] = ClipInference(
            tcfg, from_jax_variables(world["weights"]["tmr"]),
            FeatureBank(feats, torch.zeros(35, dtype=torch.int32)),
            device="cpu").run(ds)
    first = ds.first_rows
    inside = np.arange(35) - first >= WIN + SEQ
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(runs[False].scores[inside],
                                  runs[True].scores[inside])
    assert not np.allclose(runs[False].scores[10], runs[True].scores[10])


@pytest.mark.parametrize("engine", ["clip", "video"])
def test_build_lfb_matches_jax(world, tmp_path, engine):
    jcfg, tcfg = _configs()
    port_ds, jax_ds = _datasets(world, tcfg)
    ext = world["weights"]["lfb"]
    want = jax_build_lfb(jcfg, jax.tree_util.tree_map(jnp.asarray, ext), jax_ds,
                         cache_path=str(tmp_path / "jax.npz"), engine=engine)
    got = build_lfb(tcfg, from_jax_variables(ext), port_ds,
                    cache_path=str(tmp_path / "port.npz"), engine=engine,
                    device="cpu")
    want_f = np.asarray(want.features)
    assert got.features.shape == (35, HID) and got.features.dtype == torch.float32
    np.testing.assert_allclose(got.features.numpy(), want_f, rtol=0,
                               atol=ATOL * np.abs(want_f).max())
    np.testing.assert_array_equal(got.first_rows.numpy(),
                                  np.asarray(want.first_rows))
    assert (tmp_path / "port.npz").exists()


def test_build_lfb_engines_agree_and_cache(world, tmp_path):
    """The clip and video engines build the same bank; a cached `.npz` is
    read back under load_cached (even for other weights) and rebuilt under
    force; a transform that is not frame-wise is refused by the video
    engine."""
    _, tcfg = _configs(device_normalize=False)
    ds, _ = _datasets(world, tcfg)
    ext = from_jax_variables(world["weights"]["lfb"])
    path = str(tmp_path / "bank.npz")
    clip = build_lfb(tcfg, ext, ds, cache_path=path, device="cpu")
    video = build_lfb(tcfg, ext, ds, cache_path=str(tmp_path / "v.npz"),
                      engine="video", device="cpu")
    scale = clip.features.abs().max().item()
    torch.testing.assert_close(video.features, clip.features, rtol=0,
                               atol=ATOL * scale)
    other = from_jax_variables(random_variables(
        ModelConfig(**dict(MODEL, head="lfb")), 99))
    cached = build_lfb(tcfg, other, ds, cache_path=path, device="cpu")
    assert torch.equal(cached.features, clip.features)
    rebuilt = build_lfb(tcfg, other, ds, cache_path=path, force=True,
                        device="cpu")
    assert not torch.allclose(rebuilt.features, clip.features)
    no_cache = tcfg.replace(memory=dataclasses.replace(tcfg.memory,
                                                       load_cached=False))
    fresh = build_lfb(no_cache, ext, ds, cache_path=path, device="cpu")
    torch.testing.assert_close(fresh.features, clip.features, rtol=0, atol=0)
    random_crop = pipeline.ClipDataset(ds.manifest, SEQ,
                                       transform=transforms.EvalTransform(
                                           crop_size=CROP, resize=HW,
                                           crop_type=0))
    with pytest.raises(ValueError, match="frame-wise"):
        build_lfb(tcfg, ext, random_crop, cache_path=str(tmp_path / "x.npz"),
                  engine="video", device="cpu")
