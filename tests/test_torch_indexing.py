"""The port's clip-index algebra, manifests and the pack side against the
JAX package's, on the cases of `tests/test_indexing.py`,
`tests/test_manifests.py` and `tests/test_packed.py`: equal results, and
manifest pickles and CSVs that each package writes and the other reads.
Exact: the same numpy on both sides."""

import pickle

import numpy as np
import pytest

from tmrnet_tpu.config import CHOLEC80_PHASES as JAX_PHASES
from tmrnet_tpu.data import indexing as jax_indexing
from tmrnet_tpu.data import manifests as jax_manifests
from tmrnet_tpu.data import packed as jax_packed
from tmrnet_torch.config import CHOLEC80_PHASES, M2CAI_PHASES
from tmrnet_torch.data import indexing, manifests, packed

LENGTHS = [[50], [30, 45, 12], [10, 10], [100, 9, 40], [3, 9, 10, 11], []]
SEQ = 10


def test_phase_names_equal_jax():
    from tmrnet_tpu.config import M2CAI_PHASES as JAX_M2CAI

    assert CHOLEC80_PHASES == JAX_PHASES and M2CAI_PHASES == JAX_M2CAI


@pytest.mark.parametrize("lengths", LENGTHS)
def test_row_algebra_equals_jax(lengths):
    for name in ("clip_start_indices", "clips_per_video", "video_first_rows"):
        got = getattr(indexing, name)(SEQ, lengths)
        want = getattr(jax_indexing, name)(SEQ, lengths)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype, name
    n = int(indexing.clips_per_video(SEQ, lengths).sum())
    np.testing.assert_array_equal(
        indexing.rows_to_video_ids(n, SEQ, lengths),
        jax_indexing.rows_to_video_ids(n, SEQ, lengths))
    starts = indexing.clip_start_indices(SEQ, lengths)
    np.testing.assert_array_equal(indexing.expand_clip_indices(starts, SEQ),
                                  jax_indexing.expand_clip_indices(starts, SEQ))


@pytest.mark.parametrize("lengths", LENGTHS[:4] + [[40, 50]])
@pytest.mark.parametrize("window", [1, 5, 12, 30])
def test_windows_equal_jax(lengths, window):
    """The clamped windows over every row, and the reference-quirk table
    (cross-video lookback and gap filling) of the whole dataset."""
    rows = np.arange(int(indexing.clips_per_video(SEQ, lengths).sum()))
    firsts = np.repeat(indexing.video_first_rows(SEQ, lengths),
                       indexing.clips_per_video(SEQ, lengths))
    np.testing.assert_array_equal(
        indexing.memory_window_rows(rows, firsts, window),
        jax_indexing.memory_window_rows(rows, firsts, window))
    got = indexing.quirk_window_table(SEQ, lengths, window)
    np.testing.assert_array_equal(
        got, jax_indexing.quirk_window_table(SEQ, lengths, window))
    assert got.shape == (len(rows), window)


def test_quirk_crosses_videos_as_the_reference():
    """The first clip of video 2 (tests/test_indexing.py): its own row for
    the 9 tail frames, then video 1's last rows."""
    lengths, window = [40, 50], 12
    r = int(indexing.video_first_rows(SEQ, lengths)[1])
    ref = indexing.quirk_window_table(SEQ, lengths, window)[r]
    np.testing.assert_array_equal(ref, [r] * 9 + [30, 29, 28])


def test_lfb_uses_the_indexing_copy():
    from tmrnet_torch.memory import lfb

    for name in ("clips_per_video", "video_first_rows", "memory_window_rows"):
        assert getattr(lfb, name) is getattr(indexing, name)


def _toy(mod, n_videos=3, base=20):
    vids = []
    for i in range(n_videos):
        n = base + i * 5
        paths = [f"/data/video{i:02d}/frame{25 * j}.png" for j in range(n)]
        vids.append(mod.VideoRecord(f"video{i:02d}", paths,
                                    (np.arange(n) % 7).astype(np.int64)))
    return mod.Manifest(vids)


def _same(a, b):
    assert [v.video_id for v in a.videos] == [v.video_id for v in b.videos]
    assert a.flat_paths() == b.flat_paths()
    np.testing.assert_array_equal(a.flat_labels(), b.flat_labels())
    assert a.video_lengths == b.video_lengths


@pytest.mark.parametrize("writer,reader", [(manifests, jax_manifests),
                                           (jax_manifests, manifests)])
@pytest.mark.parametrize("form", ["3-list", "6-list", "csv"])
def test_manifest_files_cross_packages(tmp_path, writer, reader, form):
    """One package writes, the other reads; the bytes of a pickle equal."""
    train, val = _toy(writer, 3), _toy(writer, 2, base=12)
    p = str(tmp_path / ("m.csv" if form == "csv" else "m.pkl"))
    if form == "csv":
        writer.save_csv_manifest(p, train)
        _same(reader.load_csv_manifest(p), train)
        return
    writer.save_pickle_manifest(p, train, val if form == "6-list" else None)
    got_train, got_val = reader.load_pickle_manifest(p)
    _same(got_train, train)
    if form == "6-list":
        _same(got_val, val)
    else:
        assert got_val is None
    other = str(tmp_path / "other.pkl")
    reader.save_pickle_manifest(other, got_train, got_val)
    with open(p, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("data", [
    [["a", "b"], [[3, 9], [5, 9]], [2]],                       # two columns
    [["t/a.jpg", "t/b.jpg"], ["v/c.jpg"], [[0], [1]], [[2]], [2], [1]],
    [["t/a.jpg", "t/b.jpg"], [[0], [1]], ["v/c.jpg"], [[2]], [2], [1]],
    [[[f"cutMargin/{v + 40}/{25 * k}.jpg", (k // 2) % 7]
      for k in range(4 + v)] for v in range(3)],               # nested
    [["x/a.npy#0", "x/a.npy#1"], np.array([[1], [2]]), np.array([2])],
], ids=["two-column", "reference-6", "legacy-6", "nested", "numpy"])
def test_reference_pickles_load_as_jax(tmp_path, data):
    p = str(tmp_path / "ref.pkl")
    with open(p, "wb") as f:
        pickle.dump(data, f)
    for got, want in zip(manifests.load_pickle_manifest(p),
                         jax_manifests.load_pickle_manifest(p)):
        if want is None:
            assert got is None
        else:
            _same(got, want)


def test_manifest_pickle_refuses_code(tmp_path):
    p = str(tmp_path / "evil.pkl")
    with open(p, "wb") as f:
        pickle.dump([print, [1], [1]], f)
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        manifests.load_pickle_manifest(p)
    with open(p, "wb") as f:
        pickle.dump([["a"], [[1]], [2]], f)     # num_each disagrees
    with pytest.raises(ValueError, match="count mismatch"):
        manifests.load_pickle_manifest(p)


def _annotated_frames(tmp_path):
    """Frame dirs (video01, 4 s; video02, 6 s) at 25 fps numbering, a
    packed video of 5 frames, bare-number dirs 1/2/10, hidden files, and
    one video without annotations."""
    import cv2

    frames, ann = tmp_path / "frames", tmp_path / "ann"
    ann.mkdir()
    rng = np.random.default_rng(0)
    for vid, nsec in [("video01", 4), ("video02", 6), ("1", 1), ("2", 2),
                      ("10", 1)]:
        d = frames / vid
        d.mkdir(parents=True)
        with open(ann / f"{vid}-phase.txt", "w") as f:
            f.write("Frame\tPhase\n")
            for k in range(nsec * 25):
                f.write(f"{k}\t{CHOLEC80_PHASES[(k // 13) % 7]}\n")
        for k in range(0, nsec * 25, 5):
            cv2.imwrite(str(d / f"frame{k}.png"),
                        np.zeros((4, 4, 3), np.uint8))
        (d / ".DS_Store").touch()
    np.save(frames / "video03.npy", rng.integers(0, 256, (5, 4, 4, 3),
                                                 dtype=np.uint8))
    with open(ann / "video03-phase.txt", "w") as f:
        f.write("Frame\tPhase\n" + "".join(f"{k}\t{k % 7}\n"
                                           for k in range(0, 125, 25)))
    (frames / "orphan").mkdir()
    return str(frames), str(ann)


def test_manifest_walk_equals_jax(tmp_path):
    frames, ann = _annotated_frames(tmp_path)
    got = manifests.build_manifest_from_frames(frames, ann, CHOLEC80_PHASES)
    want = jax_manifests.build_manifest_from_frames(frames, ann, JAX_PHASES)
    _same(got, want)
    # numeric order on the trailing number, as the reference's get_dirs2
    assert [v.video_id for v in got.videos] == ["1", "video01", "2",
                                                "video02", "video03", "10"]
    assert got.videos[4].frame_paths[2] == f"{frames}/video03.npy#2"
    np.testing.assert_array_equal(got.videos[4].labels, np.arange(0, 125, 25) % 7)
    for stride in (5, 50):
        _same(manifests.build_manifest_from_frames(frames, ann, CHOLEC80_PHASES,
                                                   sample_stride=stride),
              jax_manifests.build_manifest_from_frames(frames, ann, JAX_PHASES,
                                                       sample_stride=stride))
    assert manifests.read_phase_annotation(
        f"{ann}/video01-phase.txt", {n: i for i, n in enumerate(CHOLEC80_PHASES)}
    ) == jax_manifests.read_phase_annotation(
        f"{ann}/video01-phase.txt", {n: i for i, n in enumerate(JAX_PHASES)})
    a, b = manifests.split_manifest(got, (0, 2), (2, 6))
    assert [v.video_id for v in a.videos] == ["1", "video01"]
    assert len(b.videos) == 4


def _mem_manifest(mod, lengths, hw=8):
    rng = np.random.default_rng(3)
    frames, videos = {}, []
    for v, n in enumerate(lengths):
        paths = [f"v{v}/f{j}" for j in range(n)]
        for p in paths:
            frames[p] = rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
        videos.append(mod.VideoRecord(f"vid{v:02d}", paths,
                                      rng.integers(0, 7, n).astype(np.int64)))
    return mod.Manifest(videos), frames.__getitem__


def test_pack_manifest_equals_jax(tmp_path):
    """The same `.npy` bytes and records as JAX's packer; the packed
    frames read back through both packages' loaders."""
    lengths = [7, 0, 3]
    m, loader = _mem_manifest(manifests, lengths)
    jm, _ = _mem_manifest(jax_manifests, lengths)
    got = packed.pack_manifest(m, str(tmp_path / "port"), loader=loader)
    want = jax_packed.pack_manifest(jm, str(tmp_path / "jax"), loader=loader)
    assert [v.video_id for v in got.videos] == [v.video_id for v in want.videos]
    for g, w in zip(got.videos, want.videos):
        assert [p.replace("/port/", "/jax/") for p in g.frame_paths] == \
            w.frame_paths
        np.testing.assert_array_equal(g.labels, w.labels)
    for vid in ("vid00", "vid02"):
        a = (tmp_path / "port" / f"{vid}.npy").read_bytes()
        assert a == (tmp_path / "jax" / f"{vid}.npy").read_bytes()
    assert not list((tmp_path / "port").glob("*.tmp"))
    for p in got.videos[0].frame_paths:
        np.testing.assert_array_equal(packed.load_packed_frame(p),
                                      jax_packed.load_packed_frame(p))
        np.testing.assert_array_equal(packed.load_packed_frame(p),
                                      loader(m.videos[0].frame_paths[
                                          int(p.rpartition("#")[2])]))
    assert packed.packed_file_of(got.videos[0].frame_paths[0]) == \
        str(tmp_path / "port" / "vid00.npy")
    assert packed.packed_file_of("/x/frame.png") is None


def test_pack_refuses_duplicates_and_bad_frames(tmp_path):
    m, loader = _mem_manifest(manifests, [2, 2])
    m.videos[1].video_id = "vid00"
    with pytest.raises(ValueError, match="duplicate video ids"):
        packed.pack_manifest(m, str(tmp_path), loader=loader)
    bad = {"a": np.zeros((4, 4, 3), np.uint8), "b": np.zeros((5, 4, 3), np.uint8)}
    rec = manifests.VideoRecord("odd", ["a", "b"], np.zeros(2, np.int64))
    with pytest.raises(ValueError, match="uniform frames"):
        packed.pack_video(rec, str(tmp_path), bad.__getitem__)
    assert list(tmp_path.iterdir()) == []          # no .tmp, no .npy left
    rec = manifests.VideoRecord("f", ["a"], np.zeros(1, np.int64))
    with pytest.raises(ValueError, match="uint8"):
        packed.pack_video(rec, str(tmp_path),
                          lambda p: np.zeros((4, 4, 3), np.float32))
