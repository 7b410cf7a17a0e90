"""Dataset manifests: the reference's pickle formats, the fork's CSV, and
manifests built by walking frame directories and packed videos.

Own copy of `tmrnet_tpu/data/manifests.py` (`VideoRecord` and `Manifest`
:32-63, the 6-list, 3-list and nested pickles with one- or two-column
labels `load_pickle_manifest` :107 and `save_pickle_manifest` :150, CSV
:169-203, `read_phase_annotation` :220, `build_manifest_from_frames` :236,
`split_manifest` :295), numpy only. A file either package writes, the
other reads.

Everything converges on `Manifest`: an ordered list of `VideoRecord`
(video id, frame paths, per-frame phase labels), from which the clip rows
and the loaders derive.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class VideoRecord:
    video_id: str
    frame_paths: List[str]
    labels: np.ndarray  # (num_frames,) int64 phase ids

    def __len__(self) -> int:
        return len(self.frame_paths)


@dataclasses.dataclass
class Manifest:
    videos: List[VideoRecord]

    @property
    def video_lengths(self) -> List[int]:
        return [len(v) for v in self.videos]

    @property
    def num_frames(self) -> int:
        return sum(self.video_lengths)

    def flat_paths(self) -> List[str]:
        return [p for v in self.videos for p in v.frame_paths]

    def flat_labels(self) -> np.ndarray:
        if not self.videos:
            return np.zeros((0,), dtype=np.int64)
        return np.concatenate([v.labels for v in self.videos])

    def subset(self, indices: Sequence[int]) -> "Manifest":
        return Manifest([self.videos[i] for i in indices])


def _labels_list(labels: np.ndarray) -> List[List[int]]:
    # The reference pickles labels as per-frame [phase] rows (sometimes with a
    # tool-label column dropped); we write the 1-element form.
    return [[int(x)] for x in labels.tolist()]


def _parse_labels(raw) -> np.ndarray:
    arr = np.asarray(raw)
    if arr.ndim == 2:  # rows like [phase] or [phase, tool...]
        arr = arr[:, 0] if arr.shape[1] >= 1 else arr.ravel()
    return arr.astype(np.int64)


def _group_by_video(paths: List[str], labels: np.ndarray,
                    num_each: Sequence[int]) -> List[VideoRecord]:
    if sum(int(n) for n in num_each) != len(paths) or \
            len(paths) != len(labels):
        # a truncated/corrupt pickle would otherwise load silently with
        # dropped frames and plausible-but-wrong downstream numbers
        raise ValueError(
            f"manifest count mismatch: num_each sums to "
            f"{sum(int(n) for n in num_each)}, got {len(paths)} paths / "
            f"{len(labels)} labels")
    videos = []
    ofs = 0
    for i, n in enumerate(num_each):
        n = int(n)
        vid_paths = paths[ofs:ofs + n]
        vid = _video_id_from_path(vid_paths[0]) if vid_paths else str(i)
        videos.append(VideoRecord(vid, vid_paths, labels[ofs:ofs + n].copy()))
        ofs += n
    return videos


def _video_id_from_path(path: str) -> str:
    if ".npy#" in path:  # packed frame (data/packed.py): id is the file stem
        return os.path.splitext(
            os.path.basename(path.rpartition("#")[0]))[0]
    parent = os.path.basename(os.path.dirname(path))
    return parent or os.path.splitext(os.path.basename(path))[0]


# What a manifest pickle may refer to: numpy arrays and scalars (labels
# written through numpy), beside the lists, strings and ints of the
# reference's files; numpy 1 and 2 name the rebuilds by different modules.
_MANIFEST_GLOBALS = {
    (mod, name): obj
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
    for name, obj in (("_reconstruct", np.ndarray.__reduce__(np.zeros(0))[0]),
                      ("scalar", np.int64(0).__reduce__()[0]))
}
_MANIFEST_GLOBALS.update({("numpy", "ndarray"): np.ndarray,
                          ("numpy", "dtype"): np.dtype})


class _ManifestUnpickler(pickle.Unpickler):
    """Reads lists, strings, numbers and numpy arrays; refuses any other
    global, so a manifest file cannot run code."""

    def find_class(self, module, name):
        try:
            return _MANIFEST_GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"a manifest pickle holds lists, strings, numbers and "
                f"arrays, not {module}.{name}") from None


def load_pickle_manifest(path: str) -> Tuple[Manifest, Optional[Manifest]]:
    """Load a reference pickle. Returns (primary, secondary):
    6-list -> (train, val); 3-list -> (test, None).

    The reference's 6-list is grouped by KIND, not by split
    (`Training TMRNet/get_paths_labels.py:126-139` appends train_paths,
    val_paths, train_labels, val_labels, train_num, val_num). Files written
    by earlier versions of the JAX package used a split-grouped order
    (train_paths, train_labels, ...); both load — the layout is detected by
    which slots hold path strings."""
    with open(path, "rb") as f:
        data = _ManifestUnpickler(f).load()
    # get_paths_labels.py's intermediate cholec80.pkl: one list per video of
    # [path, label(, tool...)] rows (`:83-87`; export_phase_copy.py consumes
    # it directly). Detected by nesting depth (a 3/6-list's first element is
    # a flat list of path strings), so a 3- or 6-video file still parses.
    if (data and all(isinstance(v, (list, tuple)) for v in data)
            and len(data[0]) and isinstance(data[0][0], (list, tuple))):
        videos = []
        for i, info in enumerate(data):
            paths = [row[0] for row in info]
            labels = np.asarray([int(row[1]) for row in info], np.int64)
            vid = _video_id_from_path(paths[0]) if paths else str(i)
            videos.append(VideoRecord(vid, paths, labels))
        return Manifest(videos), None
    if len(data) == 6:
        def is_paths(x):
            return bool(len(x)) and isinstance(list(x)[0], str)

        if is_paths(data[2]) and not is_paths(data[1]):
            # the JAX package's legacy split-grouped layout
            tr_paths, tr_labels, va_paths, va_labels, tr_num, va_num = data
        else:  # reference kind-grouped layout
            tr_paths, va_paths, tr_labels, va_labels, tr_num, va_num = data
        train = Manifest(_group_by_video(list(tr_paths), _parse_labels(tr_labels), tr_num))
        val = Manifest(_group_by_video(list(va_paths), _parse_labels(va_labels), va_num))
        return train, val
    if len(data) == 3:
        paths, labels, num_each = data
        return Manifest(_group_by_video(list(paths), _parse_labels(labels), num_each)), None
    raise ValueError(f"unrecognized pickle manifest with {len(data)} elements")


def save_pickle_manifest(path: str, train: Manifest,
                         val: Optional[Manifest] = None) -> None:
    """Write the reference's 6-list (train+val) or 3-list (test) pickle."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if val is not None:
        # reference kind-grouped order (`get_paths_labels.py:126-139`):
        # paths, paths, labels, labels, nums, nums
        data = [
            train.flat_paths(), val.flat_paths(),
            _labels_list(train.flat_labels()), _labels_list(val.flat_labels()),
            train.video_lengths, val.video_lengths,
        ]
    else:
        data = [train.flat_paths(), _labels_list(train.flat_labels()),
                train.video_lengths]
    with open(path, "wb") as f:
        pickle.dump(data, f)


def load_csv_manifest(path: str) -> Manifest:
    """Load the fork's CSV (columns frame,class,id), grouping rows by id in
    first-appearance order (matching pandas groupby-on-ordered-input)."""
    import csv

    by_vid: Dict[str, Tuple[List[str], List[int]]] = {}
    order: List[str] = []
    with open(path, "r", newline="") as f:
        for row in csv.DictReader(f):
            vid = str(row["id"])
            if vid not in by_vid:
                by_vid[vid] = ([], [])
                order.append(vid)
            by_vid[vid][0].append(row["frame"])
            by_vid[vid][1].append(int(row["class"]))
    return Manifest([
        VideoRecord(v, by_vid[v][0], np.asarray(by_vid[v][1], dtype=np.int64))
        for v in order
    ])


def save_csv_manifest(path: str, manifest: Manifest) -> None:
    import csv

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "class", "id"])
        for v in manifest.videos:
            for p, lab in zip(v.frame_paths, v.labels.tolist()):
                w.writerow([p, int(lab), v.video_id])


_FRAME_NUM_RE = re.compile(r"(\d+)")


def _frame_number(fname: str) -> int:
    m = _FRAME_NUM_RE.findall(os.path.splitext(os.path.basename(fname))[0])
    return int(m[-1]) if m else -1


def _natural_key(name: str):
    """Video-name sort key: numeric on the trailing number, so the
    reference's bare-number cutMargin dirs ('1'..'80') order 1,2,..,10,..
    like its `sort(key=int)` (`get_paths_labels.py::get_dirs2`) — a lexical
    sort would put '10' before '2' and silently shift the train/val split
    membership. Zero-padded names ('video01') are unaffected."""
    m = _FRAME_NUM_RE.findall(os.path.splitext(name)[0])
    return (0, int(m[-1]), name) if m else (1, 0, name)


def read_phase_annotation(ann_path: str,
                          name_to_id: Dict[str, int]) -> Dict[int, int]:
    """Parse a `frame_idx <TAB> PhaseName` annotation txt (header tolerated)
    into frame index -> phase id."""
    frame_to_phase: Dict[int, int] = {}
    with open(ann_path, "r") as f:
        for li, line in enumerate(f):
            parts = line.split()
            if len(parts) < 2 or (li == 0 and not parts[0].isdigit()):
                continue
            lab = parts[1]
            frame_to_phase[int(parts[0])] = (
                int(lab) if lab.isdigit() else name_to_id[lab])
    return frame_to_phase


def build_manifest_from_frames(
    data_root: str,
    annotation_root: str,
    phase_names: Sequence[str],
    sample_stride: int = 25,
    annotation_pattern: str = "{vid}-phase.txt",
) -> Manifest:
    """Walk `data_root/<video>/` frame dirs + per-video phase annotation txts,
    keeping frames whose number is a multiple of sample_stride (1 fps from
    25 fps source), like `Training TMRNet/get_paths_labels.py:46-82`.

    Annotation txts have a header then `frame_idx <TAB> PhaseName` rows at
    source fps; the phase of kept frame k is the row at frame index k.

    `data_root/<video>.npy` packs (data/packed.py::pack_video, or the JAX
    package's `prepare --pack`)
    are walked alongside frame dirs: pack frame j maps to source frame
    sample_stride*j and emits the packed path '<video>.npy#<j>'.
    """
    name_to_id = {n: i for i, n in enumerate(phase_names)}
    videos: List[VideoRecord] = []
    for entry in sorted(os.listdir(data_root), key=_natural_key):
        vdir = os.path.join(data_root, entry)
        if entry.startswith("."):
            continue
        packed = entry.endswith(".npy") and os.path.isfile(vdir)
        if not packed and not os.path.isdir(vdir):
            continue
        vid = os.path.splitext(entry)[0] if packed else entry
        ann_path = os.path.join(annotation_root, annotation_pattern.format(vid=vid))
        if not os.path.exists(ann_path):
            continue
        frame_to_phase = read_phase_annotation(ann_path, name_to_id)
        paths, labels = [], []
        if packed:
            # a packed video: frame j of the .npy is source frame
            # sample_stride*j (packs keep every stride-th frame)
            n = int(np.load(vdir, mmap_mode="r").shape[0])
            for j in range(n):
                num = sample_stride * j
                if num not in frame_to_phase:
                    continue
                paths.append(f"{vdir}#{j}")
                labels.append(frame_to_phase[num])
        else:
            for fname in sorted(os.listdir(vdir), key=_frame_number):
                if fname.startswith("."):
                    continue
                num = _frame_number(fname)
                if num < 0 or num % sample_stride != 0:
                    continue
                if num not in frame_to_phase:
                    continue
                paths.append(os.path.join(vdir, fname))
                labels.append(frame_to_phase[num])
        if paths:
            videos.append(VideoRecord(vid, paths, np.asarray(labels, dtype=np.int64)))
    return Manifest(videos)


def split_manifest(manifest: Manifest, *ranges: Tuple[int, int]) -> List[Manifest]:
    """Split by video position: split_manifest(m, (0,32), (32,40)) mirrors the
    reference's 32-train/8-val split (`get_paths_labels.py:106-122`)."""
    return [Manifest(manifest.videos[a:b]) for a, b in ranges]
