"""The port's native preprocess (`tmrnet_torch/data/native.py` over its own
copy of `tmrnet_data.cc`) against the JAX package's bindings, on the CPU.

JAX's `native.available()` is asserted first, so that its numpy fallback
cannot stand in for the library. Then, bit for bit: `preprocess_batch`
(per-frame crops and flips), `resize_bilinear` and `cutmargin_bbox`
(a content box, and none on a black frame) equal JAX's; the bounds check
refuses a crop outside the frame; `TrainTransform(use_native=True)` equals
JAX's (normalize on, crop and flip) and lands within 1e-6 of the numpy
path; the CLI's training dataset follows `data.use_native_preproc`.
Builds: the library's name carries a hash of its source; threads that
build at once leave one whole library and no temporary file; a source
that does not compile raises with the compiler's output.
"""

import threading

import numpy as np
import pytest

from tmrnet_tpu.data import native as jax_native
from tmrnet_tpu.data import transforms as jax_transforms
from tmrnet_torch import cli
from tmrnet_torch.config import DataConfig, ExperimentConfig
from tmrnet_torch.data import native, transforms
from tmrnet_torch.data.manifests import Manifest, VideoRecord

MEAN = np.array([0.41757566, 0.26098573, 0.25888634], np.float32)
STD = np.array([0.21938758, 0.1983, 0.19342837], np.float32)


def test_jax_library_is_built():
    assert jax_native.available()


def _frames(seed, n=5, h=48, w=56):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def test_preprocess_batch_equals_jax():
    assert jax_native.available()
    frames = _frames(1)
    rng = np.random.default_rng(2)
    ys = rng.integers(0, 48 - 32 + 1, 5)
    xs = rng.integers(0, 56 - 32 + 1, 5)
    flip = rng.integers(0, 2, 5).astype(np.uint8)
    for threads in (0, 1, 3):
        got = native.preprocess_batch(frames, ys, xs, 32, flip, MEAN, STD,
                                      num_threads=threads)
        want = jax_native.preprocess_batch(frames, ys, xs, 32, flip, MEAN,
                                           STD, num_threads=threads)
        assert got.dtype == np.float32 and got.shape == (5, 32, 32, 3)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside the frame"):
        native.preprocess_batch(frames, ys + 48, xs, 32, flip, MEAN, STD)


@pytest.mark.parametrize("size", [(32, 40), (97, 61)])
def test_resize_bilinear_equals_jax(size):
    assert jax_native.available()
    frames = _frames(3)
    got = native.resize_bilinear(frames, *size)
    want = jax_native.resize_bilinear(frames, *size)
    assert got.shape == (5,) + size + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_cutmargin_bbox_equals_jax():
    assert jax_native.available()
    img = np.zeros((90, 120, 3), np.uint8)
    img[20:70, 30:100] = _frames(4, 1, 50, 70)[0] // 2 + 100
    got = native.cutmargin_bbox(img)
    assert got is not None and got == jax_native.cutmargin_bbox(img)
    assert native.cutmargin_bbox(np.zeros((40, 40, 3), np.uint8)) is None
    assert jax_native.cutmargin_bbox(np.zeros((40, 40, 3), np.uint8)) is None


@pytest.mark.parametrize("epoch,clip_id", [(0, 0), (3, 17)])
def test_train_transform_equals_jax(epoch, clip_id):
    assert jax_native.available()
    clip = _frames(5 + clip_id, 4, 40, 40)
    kw = dict(crop_size=32, resize=40, use_flip=False)
    got = transforms.TrainTransform(**kw, use_native=True)(clip, epoch,
                                                           clip_id)
    want = jax_transforms.TrainTransform(**kw, use_native=True)(
        clip, epoch, clip_id)
    np.testing.assert_array_equal(got, want)
    plain = transforms.TrainTransform(**kw)(clip, epoch, clip_id)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6)
    # under device_normalize the uint8 clip goes out first, in both
    u8 = transforms.TrainTransform(**kw, use_native=True,
                                   normalize=False)(clip, epoch, clip_id)
    assert u8.dtype == np.uint8


@pytest.mark.parametrize("use_native", [True, False])
def test_cli_training_dataset_follows_the_config(use_native):
    cfg = ExperimentConfig(data=DataConfig(use_native_preproc=use_native))
    ds = cli.train_dataset(cfg, Manifest([VideoRecord(
        "v", [f"f{i}" for i in range(12)], np.zeros(12, np.int64))]))
    assert ds.transform.use_native is use_native
    assert ExperimentConfig.from_json(cfg.to_json()) == cfg


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out, errors = [], []

    def build():
        try:
            out.append(native._build())
        except Exception as e:          # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors and len(set(out)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [out[0].name]
    assert out[0].name.startswith("libtmrnet_data_")


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "tmrnet_data.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native._build()
