"""The port's frame loading and test-time transforms against the JAX
package's on the same arrays: `load_frame` on packed `.npy#idx` paths and
on a PNG written by cv2, `EvalTransform` for every crop type with and
without `normalize`. Exact: both are the same numpy and cv2 calls."""

import sys

import numpy as np
import pytest

from tmrnet_tpu.data import pipeline as jax_pipeline
from tmrnet_tpu.data import transforms as jax_transforms
from tmrnet_torch.data import packed, pipeline, transforms


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A packed video of 4 frames of 250x250 and the same frame as PNG."""
    d = tmp_path_factory.mktemp("frames")
    frames = np.random.default_rng(5).integers(0, 256, (4, 250, 250, 3),
                                               dtype=np.uint8)
    np.save(d / "v.npy", frames)
    import cv2

    cv2.imwrite(str(d / "f.png"), cv2.cvtColor(frames[2], cv2.COLOR_RGB2BGR))
    return d, frames


def test_load_frame_matches_jax(video):
    d, frames = video
    for t in range(4):
        path = f"{d}/v.npy#{t}"
        got = pipeline.load_frame(path)
        np.testing.assert_array_equal(got, jax_pipeline.load_frame(path))
        np.testing.assert_array_equal(got, frames[t])
        got[...] = 0                      # an owned copy
    np.testing.assert_array_equal(pipeline.load_frame(f"{d}/v.npy#1"), frames[1])
    png = pipeline.load_frame(f"{d}/f.png")
    np.testing.assert_array_equal(png, jax_pipeline.load_frame(f"{d}/f.png"))
    np.testing.assert_array_equal(png, frames[2])     # PNG is lossless
    assert packed.split_packed_path(f"{d}/v.npy#3") == (f"{d}/v.npy", 3)
    with pytest.raises(IndexError, match="out of range"):
        pipeline.load_frame(f"{d}/v.npy#4")
    with pytest.raises(ValueError, match="not a packed frame path"):
        packed.split_packed_path(f"{d}/v.png#1")


def test_image_files_need_cv2_packed_frames_do_not(video, monkeypatch):
    d, frames = video
    monkeypatch.setitem(sys.modules, "cv2", None)      # import cv2 fails
    with pytest.raises(ImportError, match="cv2"):
        pipeline.load_frame(f"{d}/f.png")
    np.testing.assert_array_equal(pipeline.load_frame(f"{d}/v.npy#0"), frames[0])
    monkeypatch.setattr(transforms, "_HAS_CV2", False)
    clip = frames[:2]
    assert transforms.resize_clip(clip, (250, 250)) is clip   # no-op, no cv2
    with pytest.raises(RuntimeError, match="cv2"):
        transforms.resize_clip(clip, (224, 224))
    # crop type 1 on prepared 250x250 frames needs no cv2
    got = transforms.EvalTransform(normalize=False)(clip)
    np.testing.assert_array_equal(got, clip[:, 13:237, 13:237])


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("crop_type,size", [(0, (250, 250)), (1, (250, 250)),
                                            (1, (240, 300)), (2, (250, 250)),
                                            (3, (260, 200)), (5, (250, 250)),
                                            (10, (250, 250))])
def test_eval_transform_matches_jax(crop_type, size, normalize):
    clip = np.random.default_rng(crop_type).integers(
        0, 256, (3,) + size + (3,), dtype=np.uint8)
    kw = dict(crop_size=224, resize=250, crop_type=crop_type,
              normalize=normalize)
    got = transforms.EvalTransform(**kw)(clip, epoch=1, clip_id=7)
    want = jax_transforms.EvalTransform(**kw)(clip, epoch=1, clip_id=7)
    assert got.dtype == want.dtype == (np.float32 if normalize else np.uint8)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert transforms.EvalTransform(**kw).num_crops == \
        jax_transforms.EvalTransform(**kw).num_crops


def test_pad_or_crop_matches_jax():
    rng = np.random.default_rng(9)
    for h, w in ((200, 260), (224, 224), (300, 100)):
        clip = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(transforms.pad_or_crop(clip, 224),
                                      jax_transforms.pad_or_crop(clip, 224))
