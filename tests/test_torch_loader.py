"""The port's ClipDataset and ClipLoader against the JAX package's on the
same packed manifest and transform: every batch (clips, labels, rows, pad)
equal bit for bit, with thread and forked-process workers, shuffled and
unshuffled, with a padded last batch and drop_remainder, at test crop
types 0, 1 and 5; the zero fill of a frame that fails to load; forked
workers open their own memmap handles; `device_prefetch` on the CPU; and
`classification_metrics` equal to JAX's."""

import concurrent.futures
import multiprocessing

import numpy as np
import pytest
import torch

from tmrnet_tpu.data import manifests as jax_manifests
from tmrnet_tpu.data import pipeline as jax_pipeline
from tmrnet_tpu.data import transforms as jax_transforms
from tmrnet_tpu.eval.metrics import classification_metrics as jax_metrics
from tmrnet_torch.data import manifests, packed, pipeline, transforms
from tmrnet_torch.data.device_feed import device_prefetch
from tmrnet_torch.eval.metrics import classification_metrics

SEQ, HW, CROP = 4, 40, 32
# 10 + 1 + 6 + 18 = 35 clip positions; the 3-frame video has none.
LENGTHS = (13, 4, 9, 3, 21)


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """Packed videos of 40x40 uint8 frames and each package's manifest of
    them (the same paths and labels)."""
    d = tmp_path_factory.mktemp("packs")
    rng = np.random.default_rng(11)
    out = {}
    for mod in (manifests, jax_manifests):
        videos = []
        for v, n in enumerate(LENGTHS):
            path = d / f"video{v:02d}.npy"
            if not path.exists():
                np.save(path, rng.integers(0, 256, (n, HW, HW, 3),
                                           dtype=np.uint8))
            labels = (np.arange(n) * 3 + v) % 7
            videos.append(mod.VideoRecord(
                f"video{v:02d}", [f"{path}#{j}" for j in range(n)],
                labels.astype(np.int64)))
        out[mod] = mod.Manifest(videos)
    return out


def _datasets(packs, crop, normalize, **kw):
    tf = dict(crop_size=CROP, resize=HW, crop_type=crop, base_seed=5,
              normalize=normalize)
    port = pipeline.ClipDataset(packs[manifests], SEQ,
                                transform=transforms.EvalTransform(**tf), **kw)
    jax = jax_pipeline.ClipDataset(packs[jax_manifests], SEQ,
                                   transform=jax_transforms.EvalTransform(**tf),
                                   **kw)
    return port, jax


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == 4
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]


@pytest.mark.parametrize("crop,normalize", [(0, False), (1, False), (1, True),
                                            (5, False)])
@pytest.mark.parametrize("processes", [False, True])
def test_loader_batches_equal_jax(packs, crop, normalize, processes):
    port, jax = _datasets(packs, crop, normalize)
    assert port.num_clips == jax.num_clips == 35
    np.testing.assert_array_equal(port.first_rows, jax.first_rows)
    np.testing.assert_array_equal(port.clip_labels, jax.clip_labels)
    assert [port.clip_location(r) for r in range(35)] == \
        [jax.clip_location(r) for r in range(35)]
    for shuffle, drop, epoch in ((False, False, 0), (True, False, 3),
                                 (True, True, 1)):
        kw = dict(shuffle=shuffle, num_workers=3, prefetch=2, seed=9,
                  drop_remainder=drop, use_processes=processes)
        loader = pipeline.ClipLoader(port, 8, **kw)
        got = list(loader.epoch(epoch))
        want = list(jax_pipeline.ClipLoader(jax, 8, **kw).epoch(epoch))
        _assert_batches_equal(got, want)
        assert len(got) == len(loader) == (4 if drop else 5)
        if not drop:                # the last batch: 3 rows and 5 repeats
            clips, labels, rows, pad = got[-1]
            assert pad == 5 and (labels[3:] == -1).all()
            assert (rows[3:] == rows[2]).all()
            np.testing.assert_array_equal(clips[3], clips[2])
        shape = (8,) + ((5,) if crop == 5 else ()) + (SEQ, CROP, CROP, 3)
        assert got[0][0].shape == shape
        assert got[0][0].dtype == (np.float32 if normalize else np.uint8)


def test_epochs_shuffle_apart(packs):
    port, _ = _datasets(packs, 1, False)
    loader = pipeline.ClipLoader(port, 35, shuffle=True, seed=2)
    rows = [next(loader.epoch(e))[2] for e in (0, 1)]
    assert sorted(rows[0]) == list(range(35))
    assert not np.array_equal(rows[0], rows[1])


def test_zero_fill_equals_jax(packs):
    """A frame that fails to load is zeros under 'zeros' (both packages),
    and raises under 'raise'."""
    bad = packs[manifests].videos[0].frame_paths[2]

    def flaky(path):
        if path == bad:
            raise IOError("corrupt frame")
        return packed.load_packed_frame(path)

    port, jax = _datasets(packs, 1, False, frame_loader=flaky)
    for row in (0, 2, 3):
        clip, label = port.get_clip(row)
        want, want_label = jax.get_clip(row)
        np.testing.assert_array_equal(clip, want)
        assert label == want_label
        if row <= 2:
            assert not clip[2 - row].any()
    strict, _ = _datasets(packs, 1, False, frame_loader=flaky,
                          error_policy="raise")
    with pytest.raises(IOError, match="corrupt"):
        strict.get_clip(1)


def _handles_in_child(path):
    before = len(packed._OPEN)
    packed.load_packed_frame(path)
    return before, len(packed._OPEN), packed._LOCK.locked()


def test_forked_worker_opens_its_own_handles(packs):
    path = packs[manifests].videos[0].frame_paths[0]
    packed.load_packed_frame(path)
    assert packed.split_packed_path(path)[0] in packed._OPEN
    with packed._LOCK:          # held by this process at the fork
        ctx = multiprocessing.get_context("fork")
        with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
            before, after, locked = pool.submit(_handles_in_child, path).result(
                timeout=60)
    assert (before, after, locked) == (0, 1, False)


def test_device_prefetch_on_cpu():
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (2, 3), dtype=np.uint8),
                torch.arange(3, dtype=torch.bfloat16), np.arange(2), "tag", k)
               for k in range(5)]
    got = list(device_prefetch(iter(batches), device="cpu",
                               array_indices=(0, 1)))
    assert len(got) == 5
    for (a, b, rows, tag, k), want in zip(got, batches):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), want[0])
        assert b.dtype == torch.bfloat16 and torch.equal(b, want[1])
        assert rows is want[2] and tag == "tag" and k == want[4]
    every = next(device_prefetch([(np.ones(2), np.zeros(1))], device="cpu"))
    assert all(isinstance(t, torch.Tensor) for t in every)
    with pytest.raises(TypeError, match="bare array"):
        next(device_prefetch([np.ones(2)], device="cpu"))


@pytest.mark.parametrize("classes", [3, 7])
def test_classification_metrics_equal_jax(classes):
    rng = np.random.default_rng(classes)
    labels = rng.integers(0, classes, 200)
    preds = np.where(rng.random(200) < 0.6, labels, rng.integers(0, classes, 200))
    preds = np.minimum(preds, classes - 2)      # the last class never predicted
    got = classification_metrics(labels, preds, classes)
    want = jax_metrics(labels, preds, classes)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    assert got["precision"][classes - 1] == 0.0
    for bad in (np.array([0, -1]), np.array([0, classes])):
        with pytest.raises(ValueError, match="outside"):
            classification_metrics(bad, np.zeros(2, int), classes)
        with pytest.raises(ValueError, match="outside"):
            classification_metrics(np.zeros(2, int), bad, classes)
