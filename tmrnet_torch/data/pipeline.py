"""The host input pipeline: frame loading, the clip dataset and the
prefetching clip loader.

Port of `tmrnet_tpu/data/pipeline.py` (`load_frame` :29-44, `ClipDataset`
:47-121, `_assemble_batch` :124-142, `ClipLoader` :154-242,
`VideoClipDataset` :244-313, `array_frame_loader` :314). The unit of work
is a clip row (one bank position): its frames are loaded (through an LRU cache, since consecutive
clips share seq_len - 1 frames), transformed as `(clip, epoch, row)`, and
batched to (B, T, H, W, 3), or (B, ncrops, T, H, W, 3) for multi-crop. A
padded last batch repeats its last row with label -1. Workers are threads
or forked processes; numpy only, so a worker never touches torch or the
card. Under data parallelism each process assembles only its own rows of
every (seeded, identical) global batch (`local_rows`).
"""

from __future__ import annotations

import dataclasses
import functools
import multiprocessing
import queue
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tmrnet_torch.data.indexing import clips_per_video, video_first_rows
from tmrnet_torch.data.manifests import Manifest
from tmrnet_torch.data.packed import is_packed_path, load_packed_frame


def load_frame(path: str) -> np.ndarray:
    """One frame as RGB uint8 (H, W, 3). `<file>.npy#<idx>` paths read a
    packed video (numpy only); any other path is an image file decoded by
    cv2, which raises ImportError where cv2 is missing: nothing else decodes
    in its place."""
    if is_packed_path(path):
        return load_packed_frame(path)
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(f"decoding the image file {path!r} needs cv2 "
                          f"(opencv-python), which is not installed; packed "
                          f"frames (<file>.npy#<index>) need no decoder"
                          ) from exc
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"failed to decode {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


@dataclasses.dataclass
class ClipDataset:
    """Clip-level view of a Manifest: row r -> (frames, last-frame label).

    transform: (clip, epoch, row) -> array, applied after the cache.
    frame_loader: a frame path -> (H, W, 3) uint8 (an in-memory loader in
    tests). error_policy: 'zeros' fills a frame that fails to load with
    zeros (the reference's fallback), 'raise' raises. frame_cache: LRU
    entries over the raw frames (1,024 frames of 250x250x3 ~ 190 MB; 0 =
    none); transforms never mutate their input.
    """

    manifest: Manifest
    seq_len: int
    transform: Optional[Callable] = None
    frame_loader: Callable[[str], np.ndarray] = load_frame
    error_policy: str = "zeros"
    frame_cache: int = 1024

    def __post_init__(self):
        if self.frame_cache:
            self.frame_loader = functools.lru_cache(
                maxsize=self.frame_cache)(self.frame_loader)
        lengths = self.manifest.video_lengths
        self._cpv = clips_per_video(self.seq_len, lengths)
        self._first_rows = video_first_rows(self.seq_len, lengths)
        self._row_video = np.repeat(np.arange(len(lengths)), self._cpv)
        self._row_offset = (np.concatenate([np.arange(c) for c in self._cpv])
                            if len(lengths) else np.zeros(0, int))
        self._clip_labels = None

    @property
    def num_clips(self) -> int:
        return int(self._cpv.sum())

    @property
    def first_rows(self) -> np.ndarray:
        """Per-row first row of its video (the clamped memory windows)."""
        return np.repeat(self._first_rows, self._cpv)

    @property
    def clip_labels(self) -> np.ndarray:
        """Per-row last-frame labels from the manifest alone (no decode)."""
        if self._clip_labels is None:
            self._clip_labels = np.asarray(
                [int(self.manifest.videos[v].labels[o + self.seq_len - 1])
                 for v, o in zip(self._row_video, self._row_offset)],
                np.int64)
        return self._clip_labels

    def clip_location(self, row: int) -> Tuple[int, int]:
        """row -> (video index, start frame within the video)."""
        return int(self._row_video[row]), int(self._row_offset[row])

    def get_clip(self, row: int, epoch: int = 0) -> Tuple[np.ndarray, int]:
        vid_i, start = self.clip_location(row)
        video = self.manifest.videos[vid_i]
        frames: List[Optional[np.ndarray]] = []
        for j in range(start, start + self.seq_len):
            try:
                frames.append(self.frame_loader(video.frame_paths[j]))
            except Exception:
                if self.error_policy == "raise":
                    raise
                frames.append(None)     # zeros once a shape is known
        shape = next((f.shape for f in frames if f is not None), (256, 256, 3))
        clip = np.stack([f if f is not None else np.zeros(shape, np.uint8)
                         for f in frames])
        if self.transform is not None:
            clip = self.transform(clip, epoch, row)
        return clip, int(video.labels[start + self.seq_len - 1])


def _assemble_batch(ds: ClipDataset, batch_rows: np.ndarray, epoch: int,
                    batch: int, local: Optional[Tuple[int, int]] = None):
    """One batch of `batch` rows: a short batch repeats its last row, and
    the repeats' labels are -1. Returns (clips, labels, rows, pad); clips
    stay uint8 where the transform left them so (the card normalizes),
    else float32. local=(lo, hi): clips and labels of the padded batch's
    rows [lo, hi) only; rows and pad stay the global batch's."""
    pad = batch - len(batch_rows)
    padded = np.concatenate([batch_rows, np.repeat(batch_rows[-1:], pad)])
    lo, hi = local if local is not None else (0, batch)
    clips, labels = zip(*(ds.get_clip(int(r), epoch) for r in padded[lo:hi]))
    labels = np.asarray(labels, np.int64)
    labels[np.arange(lo, hi) >= len(batch_rows)] = -1
    clips = np.stack(clips)
    if clips.dtype != np.uint8:
        clips = clips.astype(np.float32, copy=False)
    return clips, labels, padded, pad


_PROC_DS = None     # the dataset of a worker process, set once per child


def _proc_init(ds):
    global _PROC_DS
    _PROC_DS = ds


def _proc_make_batch(batch_rows, epoch, batch, local=None):
    return _assemble_batch(_PROC_DS, batch_rows, epoch, batch, local)


class ClipLoader:
    """Prefetching batch iterator over clip rows: `epoch(e)` yields (clips,
    labels, rows, pad), `prefetch` batches in flight on `num_workers`
    workers. shuffle permutes the rows by a Philox stream with the epoch in
    the high counter word (successive epochs' streams never overlap);
    drop_remainder drops a short last batch instead of padding it.

    Workers are threads (decode and the numpy transforms release the GIL)
    or, with use_processes, forked processes: the dataset reaches them by
    the fork, not by pickling, and each batch comes back pickled. A forked
    worker runs numpy only, so forking after the card is initialised is
    safe.

    local_rows=(lo, hi): each batch's clips and labels cover only its rows
    [lo, hi) (`parallel/mesh.py::process_local_bounds`); `rows` and `pad`
    stay global. Every process derives the same batches and decodes only
    its own part of each."""

    def __init__(self, dataset: ClipDataset, batch_clips: int,
                 shuffle: bool = False, num_workers: int = 8,
                 prefetch: int = 2, seed: int = 0, drop_remainder: bool = False,
                 use_processes: bool = False,
                 local_rows: Optional[Tuple[int, int]] = None):
        self.ds = dataset
        self.batch = batch_clips
        self.shuffle = shuffle
        self.workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.use_processes = use_processes
        self.local_rows = local_rows

    def __len__(self) -> int:
        n = self.ds.num_clips
        return n // self.batch if self.drop_remainder else -(-n // self.batch)

    def _pool(self):
        if self.use_processes:
            return ProcessPoolExecutor(
                self.workers, mp_context=multiprocessing.get_context("fork"),
                initializer=_proc_init, initargs=(self.ds,))
        return ThreadPoolExecutor(self.workers)

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray, int]]:
        rows = np.arange(self.ds.num_clips)
        if self.shuffle:
            np.random.Generator(
                np.random.Philox(key=np.uint64(self.seed),
                                 counter=[0, 0, 0, np.uint64(epoch)])
            ).shuffle(rows)
        if self.drop_remainder:
            rows = rows[: len(rows) - len(rows) % self.batch]
        batches = [rows[i:i + self.batch]
                   for i in range(0, len(rows), self.batch)]
        if not batches:
            return
        with self._pool() as pool:
            if self.use_processes:
                submit = lambda b: pool.submit(_proc_make_batch, b, epoch,
                                               self.batch, self.local_rows)
            else:
                submit = lambda b: pool.submit(_assemble_batch, self.ds, b,
                                               epoch, self.batch,
                                               self.local_rows)
            futs = queue.Queue()
            it = iter(batches)
            for _ in range(self.prefetch):
                b = next(it, None)
                if b is not None:
                    futs.put(submit(b))
            while not futs.empty():
                yield futs.get().result()
                b = next(it, None)
                if b is not None:
                    futs.put(submit(b))


@dataclasses.dataclass
class VideoClipDataset:
    """ClipDataset's interface over video files (the fork's video-direct
    path, the reference's HystDataset, `test-resnet.py:139-203`): row r ->
    (the clip that `reader` decodes, transformed, and the label of its
    last frame), from per-video labels at the sampled-frame rate.

    Port of `tmrnet_tpu/data/pipeline.py:244-297`, with `clip_labels`
    (JAX's has none; the port's trainers read it) from the label arrays
    alone. It pickles (the reader drops its per-thread cursors), and
    process workers reach it by the fork as they reach a ClipDataset."""

    reader: "object"  # tmrnet_torch.data.video.VideoClipReader
    labels: Sequence[np.ndarray]  # per-video labels at sampled-frame rate
    transform: Optional[Callable] = None

    def __post_init__(self):
        nf = self.reader.num_frames
        if len(self.labels) != len(nf):
            raise ValueError("labels must have one array per video")
        for lab, n in zip(self.labels, nf):
            if len(lab) < n:
                raise ValueError("label array shorter than sampled frames")
        # the reader's cumulative clip counts are the one source of the
        # clip-count algebra
        cpv = np.diff(self.reader._cum)
        firsts = self.reader._cum[:-1].astype(np.int64)
        self._first_rows = np.repeat(firsts, cpv)
        self._clip_labels = None

    @property
    def seq_len(self) -> int:
        return self.reader.seq_len

    @property
    def num_clips(self) -> int:
        return self.reader.num_clips

    @property
    def first_rows(self) -> np.ndarray:
        return self._first_rows

    @property
    def clip_labels(self) -> np.ndarray:
        """Per-row last-frame labels from the label arrays (no decode)."""
        if self._clip_labels is None:
            cpv = np.diff(self.reader._cum)
            self._clip_labels = np.concatenate(
                [np.asarray(lab, np.int64)[self.seq_len - 1:][:c]
                 for lab, c in zip(self.labels, cpv)]
            ) if len(cpv) else np.zeros(0, np.int64)
        return self._clip_labels

    def clip_location(self, row: int) -> Tuple[int, int]:
        return self.reader.locate(row)

    def get_clip(self, row: int, epoch: int = 0) -> Tuple[np.ndarray, int]:
        vid, start = self.reader.locate(row)
        clip = self.reader.read_clip(row)
        if self.transform is not None:
            clip = self.transform(clip, epoch, row)
        label = int(self.labels[vid][start + self.reader.seq_len - 1])
        return clip, label

    @property
    def manifest(self) -> "_VideoManifestView":
        """A manifest-shaped view (video_lengths, flat_labels) for the
        trainers' class weighting, the bank's layout and the memory
        windows."""
        return _VideoManifestView(self)


@dataclasses.dataclass
class _VideoManifestView:
    ds: VideoClipDataset

    @property
    def video_lengths(self):
        return [int(n) for n in self.ds.reader.num_frames]

    def flat_labels(self) -> np.ndarray:
        return np.concatenate([
            np.asarray(lab[:n], np.int64)
            for lab, n in zip(self.ds.labels, self.ds.reader.num_frames)
        ]) if len(self.ds.labels) else np.zeros(0, np.int64)


def array_frame_loader(frames_by_path):
    """In-memory loader for tests: dict path -> uint8 array."""

    def load(path: str) -> np.ndarray:
        return frames_by_path[path]

    return load
