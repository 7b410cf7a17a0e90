"""The port's decode and cut-margin layer (`tmrnet_torch/data/video.py`,
`data/cutmargin.py`) and `prepare` against JAX's on mp4s written by
cv2: the same PNG names and pixels, packed `.npy` files byte-equal, the
same boxes through cv2, through numpy and through the port's C++ library,
the same clips from `VideoClipReader` (a padded tail included), and
`prepare` file for file (PNG trees and `--pack`, two workers, the lines in
the videos' order). Without cv2 `resize_square` raises by name; without a
decoder `prepare` exits naming both before it lists or writes anything."""

import os
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from tmrnet_tpu import cli as jax_cli
from tmrnet_tpu.data import cutmargin as jax_cut
from tmrnet_tpu.data import video as jax_video
from tmrnet_torch import cli
from tmrnet_torch.data import cutmargin, native, video


def _write_mp4(path, frames, fps=25):
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                          (w, h))
    assert out.isOpened()
    for f in frames:
        out.write(f)
    out.release()


def _margin_frames(n, seed, h=72, w=96):
    """Frames with black margins of a few widths around noisy content, and
    some hot pixels in the margin (the median must drop them)."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        t, l = 4 + i % 7, 12 + i % 9
        f[t:h - 5, l:w - 14] = rng.integers(40, 256, (h - 5 - t, w - 14 - l, 3))
        f[1, 2] = 255
        frames.append(f)
    return frames


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp4")
    (d / "vids").mkdir()
    _write_mp4(d / "vids" / "video01.mp4", _margin_frames(60, 1))
    _write_mp4(d / "vids" / "video02.mp4", _margin_frames(80, 2, 64, 80))
    _write_mp4(d / "vids" / "video10.mp4", _margin_frames(5, 3, 40, 40))
    (d / "vids" / "notes.txt").write_text("not a video")
    (d / "bad").mkdir()
    open(d / "bad" / "empty.mp4", "wb").close()     # no decoder opens it
    return d


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_probe_and_frames_match_jax(videos):
    path = str(videos / "vids" / "video02.mp4")
    assert video.probe_num_frames(path) == jax_video.probe_num_frames(path)
    got = list(video.iter_video_frames(path, stride=7))
    want = list(jax_video.iter_video_frames(path, stride=7))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cut", [True, False])
def test_extract_frames_match_jax(videos, tmp_path, cut):
    path = str(videos / "vids" / "video01.mp4")
    got = video.extract_frames(path, str(tmp_path / "port"), stride=25,
                               size=40, cut_margin=cut)
    want = jax_video.extract_frames(path, str(tmp_path / "jax"), stride=25,
                                    size=40, cut_margin=cut)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == ["frame0.png", "frame25.png",
                                               "frame50.png"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(cv2.imread(g), cv2.imread(w))


@pytest.mark.parametrize("cut", [True, False])
def test_extract_frames_packed_byte_equal(videos, tmp_path, cut):
    path = str(videos / "vids" / "video02.mp4")
    n = video.extract_frames_packed(path, str(tmp_path / "p.npy"), stride=9,
                                    size=36, cut_margin=cut)
    m = jax_video.extract_frames_packed(path, str(tmp_path / "j.npy"),
                                        stride=9, size=36, cut_margin=cut)
    assert n == m == 9
    assert (tmp_path / "p.npy").read_bytes() == (tmp_path / "j.npy").read_bytes()
    assert not (tmp_path / "p.npy.tmp").exists()
    arr = np.load(tmp_path / "p.npy")
    assert arr.shape == (9, 36, 36, 3) and arr.dtype == np.uint8


def test_empty_video_writes_nothing(videos, tmp_path, monkeypatch):
    """A file no decoder opens raises as JAX's does and leaves no pack or
    placeholder; a video that decodes to no frame returns 0 and writes
    nothing."""
    bad = str(videos / "bad" / "empty.mp4")
    out = str(tmp_path / "empty.npy")
    errors = []
    for mod in (video, jax_video):
        with pytest.raises(Exception) as e:
            mod.extract_frames_packed(bad, out, stride=25, size=32)
        errors.append(type(e.value))
        assert not os.path.exists(out) and not os.path.exists(out + ".tmp")
    assert errors[0] == errors[1]
    monkeypatch.setattr(video, "_iter_all_frames", lambda path: iter(()))
    good = str(videos / "vids" / "video01.mp4")
    assert video.extract_frames_packed(good, out, stride=25, size=32) == 0
    assert not os.path.exists(out) and not os.path.exists(out + ".tmp")
    assert video.extract_frames(good, str(tmp_path / "d"), size=32) == []


def test_npy_header_matches_jax():
    for shape in [(1, 8, 8, 3), (123, 250, 250, 3), (999999, 2, 2, 3)]:
        assert video._npy_uint8_header(shape) == jax_video._npy_uint8_header(
            shape)


@pytest.mark.parametrize("path", ["cv2", "numpy"])
def test_margin_bbox_matches_jax_and_native(path, monkeypatch):
    rng = np.random.default_rng(6)
    frames = _margin_frames(12, 5) + [
        rng.integers(40, 256, (40, 18, 3), dtype=np.uint8)  # under 2*guard
        for _ in range(4)]
    frames.append(np.zeros((50, 60, 3), np.uint8))          # all black
    if path == "numpy":
        monkeypatch.setattr(cutmargin, "_HAS_CV2", False)
        monkeypatch.setattr(jax_cut, "_HAS_CV2", False)
    boxes = 0
    for f in frames:
        got = cutmargin.margin_bbox(f)
        assert got == jax_cut.margin_bbox(f)
        assert got == native.cutmargin_bbox(f)
        np.testing.assert_array_equal(cutmargin.cut_black_margin(f),
                                      jax_cut.cut_black_margin(f))
        boxes += got is not None
    assert boxes == 12      # the narrow frames and the black one have none


def test_resize_square_needs_cv2(monkeypatch):
    img = np.zeros((30, 40, 3), np.uint8)
    np.testing.assert_array_equal(cutmargin.resize_square(img, 20),
                                  jax_cut.resize_square(img, 20))
    monkeypatch.setattr(cutmargin, "_HAS_CV2", False)
    with pytest.raises(RuntimeError, match="cv2"):
        cutmargin.resize_square(img, 20)


@pytest.mark.parametrize("claimed", [None, 3])
def test_reader_clips_match_jax(videos, claimed):
    """Every clip of a reader over two videos, in order and then
    backwards; `claimed` sampled frames past the true end pad the tail
    with the last decoded frame, as JAX's reader does."""
    paths = [str(videos / "vids" / f"video0{i}.mp4") for i in (1, 2)]
    counts = [3, 9] if claimed is None else [3 + claimed, 9 + claimed]
    port = video.VideoClipReader(paths, counts, 2, stride=9)
    jax = jax_video.VideoClipReader(paths, counts, 2, stride=9)
    assert port.num_clips == jax.num_clips
    order = list(range(port.num_clips))
    for i in order + order[::-1]:
        assert port.locate(i) == jax.locate(i)
        np.testing.assert_array_equal(port.read_clip(i), jax.read_clip(i))
    assert port.short_reads == jax.short_reads
    assert (port.short_reads > 0) == (claimed is not None)


def test_reader_pickles(videos):
    import pickle

    paths = [str(videos / "vids" / "video01.mp4")]
    reader = video.VideoClipReader(paths, [7], 3, stride=9)
    first = reader.read_clip(0)
    again = pickle.loads(pickle.dumps(reader))
    np.testing.assert_array_equal(again.read_clip(0), first)


def _prepare(main, vids, out, extra, capsys):
    assert main(["prepare", "--videos", str(vids), "--out", str(out),
                 "--size", "32", "--stride", "10", "--workers", "2",
                 *extra]) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("extra", [[], ["--pack"], ["--no-cutmargin"]])
def test_prepare_matches_jax(videos, tmp_path, capsys, extra):
    vids = videos / "vids"
    got = _prepare(cli.main, vids, tmp_path / "port", extra, capsys)
    want = _prepare(jax_cli.main, vids, tmp_path / "jax", extra, capsys)
    assert [x.split(" -> ")[0] for x in got] == [
        x.split(" -> ")[0] for x in want] == [
        "video01: 6 frames", "video02: 8 frames", "video10: 1 frames"]
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port == jax and port
    if "--pack" in extra:
        assert sorted(port) == ["video01.npy", "video02.npy", "video10.npy"]


def test_prepare_without_a_decoder_lists_nothing(videos, tmp_path,
                                                 monkeypatch):
    for mod in ("cv2", "av", "imageio", "imageio.v3"):
        monkeypatch.setitem(sys.modules, mod, None)
    listed = []
    real = os.listdir
    monkeypatch.setattr(os, "listdir", lambda p=".": listed.append(p) or
                        real(p))
    assert video.available_decoders() == []
    for extra in ([], ["--pack"]):
        with pytest.raises(SystemExit, match="imageio\\+pyav.*cv2"):
            cli.main(["prepare", "--videos", str(videos / "vids"), "--out",
                      str(tmp_path / "out"), *extra])
    assert listed == [] and not (tmp_path / "out").exists()
    with pytest.raises(video.NoDecoderError, match="imageio\\+pyav.*cv2"):
        video.require_decoder()
