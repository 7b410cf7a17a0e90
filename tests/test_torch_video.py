"""The port's video and corpus engines (CPU) against the JAX package's
`VideoInference` on the same uint8 frames and weights; against the port's
own clip engine; chunked against unchunked; the bank build against JAX's
`build_lfb(engine="video")`; stage-1 clip scoring against JAX's memoryless
step; `bucket_frames` and the auto trunk chunk.

Tiny backbone, f32, sequence_length 4, window 4, weights from the port's
seeded flax-layout variables on both sides. Tolerance 1e-4 (rtol and atol)
on probabilities and features: the same math, summed in another order by
XLA and PyTorch's CPU kernels."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tmrnet_tpu.config import DataConfig as JaxDataConfig
from tmrnet_tpu.config import ExperimentConfig as JaxExperimentConfig
from tmrnet_tpu.config import MemoryConfig as JaxMemoryConfig
from tmrnet_tpu.config import ModelConfig as JaxModelConfig
from tmrnet_tpu.data.manifests import Manifest, VideoRecord
from tmrnet_tpu.data.pipeline import ClipDataset, array_frame_loader
from tmrnet_tpu.eval.infer import ClipInference as JaxClipInference
from tmrnet_tpu.eval.infer import VideoInference as JaxVideoInference
from tmrnet_tpu.memory.lfb import load_bank as jax_load_bank
from tmrnet_tpu.train.loop import build_lfb as jax_build_lfb
from tmrnet_torch.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
from tmrnet_torch.eval.infer import (
    ClipInference,
    VideoInference,
    plan_trunk_chunk,
)
from tmrnet_torch.memory.lfb import load_bank
from tmrnet_torch.models.convert import from_jax_variables, random_variables
from tmrnet_torch.models.resnet import ResNet
from tmrnet_torch.train.loop import build_lfb_video

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, WIN, HID, HW, CLASSES = 4, 4, 16, 24, 5
# Below, at and above seq; 8 -> 9 crosses a bucket of JAX's engine (8 -> 16
# at pad_frames 16); 19 is past pad_frames (a multiple of bucket_step 8).
LENGTHS = (3, 4, 7, 8, 9, 19)
MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=HID,
             num_classes=CLASSES, head="tmr", compute_dtype="float32")


def _variables(head, seed):
    return random_variables(ModelConfig(**dict(MODEL, head=head)), seed)


def _configs(head="tmr"):
    model = dict(MODEL, head=head)
    jcfg = JaxExperimentConfig(
        data=JaxDataConfig(device_normalize=True, sequence_length=SEQ),
        model=JaxModelConfig(**model), memory=JaxMemoryConfig(window=WIN))
    tcfg = ExperimentConfig(
        data=DataConfig(device_normalize=True, sequence_length=SEQ),
        model=ModelConfig(**model), memory=MemoryConfig(window=WIN))
    return jcfg, tcfg


def _jax_tree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _port(tcfg, variables, extractor, **kw):
    return VideoInference(tcfg, from_jax_variables(variables),
                          from_jax_variables(extractor), device="cpu", **kw)


@pytest.fixture(scope="module")
def setup():
    """Weights, frames and JAX's run_video / bank_features of each video."""
    jcfg, tcfg = _configs()
    variables, extractor = _variables("tmr", 1), _variables("lfb", 2)
    rng = np.random.default_rng(3)
    videos = [rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
              for n in LENGTHS]
    jeng = JaxVideoInference(jcfg, _jax_tree(variables), _jax_tree(extractor),
                             pad_frames=16, bucket_step=8)
    want = [jeng.run_video(v) for v in videos]
    bank = [np.asarray(jeng.bank_features(v)) for v in videos]
    return dict(tcfg=tcfg, variables=variables, extractor=extractor,
                videos=videos, want=want, bank=bank)


def _run(mode, setup):
    videos = setup["videos"]
    if mode == "chunked":
        eng = _port(setup["tcfg"], setup["variables"], setup["extractor"],
                    backbone_chunk=3)
        return [eng.run_video(v) for v in videos]
    if mode == "never_chunked":
        cfg = setup["tcfg"].replace(eval=dataclasses.replace(
            setup["tcfg"].eval, backbone_chunk=-1))
        return _port(cfg, setup["variables"], setup["extractor"]
                     ).run_videos(videos)
    eng = _port(setup["tcfg"], setup["variables"], setup["extractor"])
    if mode == "run_video":
        return [eng.run_video(v) for v in videos]
    if mode == "run_video_tensor":
        return [eng.run_video(torch.from_numpy(v)) for v in videos]
    if mode == "run_videos":
        return eng.run_videos(videos)
    if mode == "run_corpus":    # 50 frames in blocks of 16: 3 full + a tail
        return eng.run_corpus(videos, chunk=16)
    calls = []
    lazy = [(lambda i=i: (calls.append(i), videos[i])[1])
            for i in range(len(videos))]
    got = eng.run_corpus(lazy, lengths=LENGTHS, chunk=16)
    assert calls == list(range(len(videos)))      # each loaded once, in order
    return got


@pytest.mark.parametrize("mode", ["run_video", "run_video_tensor",
                                  "run_videos", "run_corpus",
                                  "run_corpus_lazy", "chunked",
                                  "never_chunked"])
def test_video_engine_matches_jax(setup, mode):
    got = _run(mode, setup)
    assert len(got) == len(LENGTHS)
    for n, (preds, probs), (want_p, want_pr) in zip(LENGTHS, got, setup["want"]):
        k = max(0, n - SEQ + 1)
        assert preds.shape == (k,) and probs.shape == (k, CLASSES)
        assert preds.dtype == np.int64 and probs.dtype == np.float32
        np.testing.assert_allclose(probs, want_pr, **TOL)
        np.testing.assert_array_equal(preds, want_p)


def test_bank_features_match_jax(setup):
    eng = _port(setup["tcfg"], setup["variables"], setup["extractor"])
    for video, want in zip(setup["videos"], setup["bank"]):
        got = eng.bank_features(video)
        assert got.shape == (max(0, len(video) - SEQ + 1), HID)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_run_corpus_refuses_a_wrong_length(setup):
    eng = _port(setup["tcfg"], setup["variables"], setup["extractor"])
    videos = setup["videos"]
    with pytest.raises(ValueError, match="lengths is required"):
        eng.run_corpus([lambda: videos[0]])
    with pytest.raises(ValueError, match="loader returned 3 frames, declared 5"):
        eng.run_corpus([lambda: videos[0]], lengths=[5])


def _manifest(videos):
    store, records = {}, []
    for v, frames in enumerate(videos):
        paths = [f"v{v}/f{j}" for j in range(len(frames))]
        store.update(zip(paths, frames))
        records.append(VideoRecord(f"v{v}", paths,
                                   np.zeros(len(frames), np.int64)))
    return Manifest(records), store


def test_build_lfb_video_matches_jax(setup, tmp_path):
    jcfg, _ = _configs()
    videos = setup["videos"]
    manifest, store = _manifest(videos)
    ds = ClipDataset(manifest, SEQ, frame_loader=array_frame_loader(store))
    want = jax_build_lfb(jcfg, _jax_tree(setup["extractor"]), ds,
                         cache_path=str(tmp_path / "jax.npz"), engine="video")
    lazy = [(lambda v=v: v) for v in videos]
    got = build_lfb_video(setup["tcfg"], from_jax_variables(setup["extractor"]),
                          lazy, lengths=LENGTHS, device="cpu",
                          cache_path=str(tmp_path / "port.npz"))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features),
                               **TOL)
    np.testing.assert_array_equal(got.first_rows.numpy(),
                                  np.asarray(want.first_rows))
    # each package reads the other's cache
    mine = jax_load_bank(str(tmp_path / "port.npz"))
    theirs = load_bank(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_allclose(np.asarray(mine.features), got.features.numpy())
    np.testing.assert_allclose(theirs.features.numpy(), np.asarray(want.features))
    with pytest.raises(ValueError, match="declared 9"):
        build_lfb_video(setup["tcfg"], from_jax_variables(setup["extractor"]),
                        [lambda: videos[0]], lengths=[9], device="cpu")


def test_video_engine_matches_clip_engine(setup):
    """Every clip position of every video through the clip engine (its bank
    built by build_lfb_video) against run_video on the same frames."""
    tcfg, videos = setup["tcfg"], setup["videos"]
    bank = build_lfb_video(tcfg, from_jax_variables(setup["extractor"]),
                           videos, device="cpu")
    clip = ClipInference(tcfg, from_jax_variables(setup["variables"]), bank,
                         device="cpu")
    eng = _port(tcfg, setup["variables"], setup["extractor"])
    firsts = bank.first_rows.numpy()
    row = 0
    for video in videos:
        preds, probs = eng.run_video(video)
        k = len(preds)
        if not k:
            continue
        clips = np.stack([video[i:i + SEQ] for i in range(k)])
        rows = np.arange(row, row + k)
        res = clip.run_batches([(clips, np.zeros(k), rows, 0)], firsts)
        np.testing.assert_allclose(res.scores, probs, **TOL)
        np.testing.assert_array_equal(res.preds, preds)
        row += k
    assert row == bank.num_rows


def test_clip_inference_stage1_matches_jax():
    jcfg, tcfg = _configs("stage1")
    variables = _variables("stage1", 4)
    jeng = JaxClipInference(jcfg, _jax_tree(variables))
    clips = np.random.default_rng(5).integers(0, 256, (3, SEQ, HW, HW, 3),
                                              dtype=np.uint8)
    want_pred, want_probs = jeng._infer(jeng.variables, jeng._features,
                                        jnp.asarray(clips),
                                        jnp.zeros((3, 1), jnp.int32))
    port = ClipInference(tcfg, from_jax_variables(variables), device="cpu")
    res = port.run_batches([(clips, np.zeros(3), np.arange(3), 1)])
    np.testing.assert_allclose(res.scores, np.asarray(want_probs)[:2], **TOL)
    np.testing.assert_array_equal(res.preds, np.asarray(want_pred)[:2])


def test_bucket_frames_equal_jax(setup):
    jcfg, _ = _configs()
    jeng = JaxVideoInference(jcfg, None, None)     # JAX's default buckets
    eng = _port(setup["tcfg"], setup["variables"], setup["extractor"])
    ns = list(range(1, 4200, 7)) + [2047, 2048, 2049, 3072, 3073, 5500]
    assert [eng.bucket_frames(n) for n in ns] == [jeng.bucket_frames(n)
                                                  for n in ns]


def test_trunk_chunk_limits_from_shapes(setup):
    r50 = ResNet((3, 4, 6, 3), 64)
    per_frame = r50.activation_elements(224, 224)
    assert per_frame == 112 * 112 * 64 == 56 * 56 * 256
    # 2,674 frames put a tensor past 2^31 elements: the index limit gives 2,048
    assert (2**31 - 1) // per_frame == 2674
    assert plan_trunk_chunk(per_frame, 2) == 2048
    assert plan_trunk_chunk(per_frame, 2, available_bytes=80 * 2**30) == 2048
    # 8 GiB allocatable: 4 live bf16 activations a frame in half of it
    assert plan_trunk_chunk(per_frame, 2, available_bytes=8 * 2**30) == 512
    assert plan_trunk_chunk(10, 2) == 32768          # fused_bottleneck's 65,535
    with pytest.raises(ValueError, match="exceed the trunk's limits"):
        plan_trunk_chunk(per_frame, 2, available_bytes=2**20)
    # odd sizes round each stride-2 step up: stem 13x12x8, stage 1 7x6x32
    assert ResNet((1, 1), 8).activation_elements(25, 23) == 7 * 6 * 32
    # the engine: explicit, never (the whole call), auto (no memory query
    # on the CPU)
    tcfg, var, ext = setup["tcfg"], setup["variables"], setup["extractor"]
    assert _port(tcfg, var, ext, backbone_chunk=5).trunk_chunk(40, (24, 24)) == 5
    assert _port(tcfg, var, ext, backbone_chunk=-1).trunk_chunk(40, (24, 24)) == 40
    tiny = (2**31 - 1) // ResNet((1, 1), 8).activation_elements(24, 24)
    assert _port(tcfg, var, ext).trunk_chunk(40, (24, 24)) == min(
        32768, 1 << (tiny.bit_length() - 1))
