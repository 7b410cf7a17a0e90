"""Packed raw frames: one uint8 `(N, H, W, 3)` `.npy` per video, a frame
addressed as `<file>.npy#<index>`.

Port of `tmrnet_tpu/data/packed.py` (`is_packed_path`, `split_packed_path`,
`packed_file_of`, `load_packed_frame` :35-75; the pack side, `pack_video`
:73 and `pack_manifest` :122). A frame read is a memmap slice and a copy,
no codec. The memmap handles are opened once a process and shared by every
thread (reads of a read-only memmap are thread-safe); a lock guards their
opening. A forked loader worker starts with an empty table and a fresh
lock, so it opens its own handles. Numpy only: decode threads and worker
processes call this and never touch torch.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np

from tmrnet_torch.data.manifests import Manifest, VideoRecord

_SEP = ".npy#"

_OPEN: dict = {}
_LOCK = threading.Lock()


def _forget_handles_in_child() -> None:
    """After a fork: the parent's handles and its lock (which another
    thread may have held at the fork) stay behind."""
    global _LOCK
    _OPEN.clear()
    _LOCK = threading.Lock()


os.register_at_fork(after_in_child=_forget_handles_in_child)


def is_packed_path(path: str) -> bool:
    return _SEP in path


def split_packed_path(path: str) -> Tuple[str, int]:
    """'<file>.npy#<idx>' -> (file, idx). Raises ValueError if malformed."""
    file, _, idx = path.rpartition("#")
    if not file.endswith(".npy"):
        raise ValueError(f"not a packed frame path: {path!r}")
    return file, int(idx)


def packed_file_of(path: str) -> Optional[str]:
    """The `.npy` of a packed frame path, else None (the frame path itself
    is never a file on disk)."""
    return split_packed_path(path)[0] if is_packed_path(path) else None


def load_packed_frame(path: str) -> np.ndarray:
    """One frame of a packed video, as an owned uint8 copy."""
    file, idx = split_packed_path(path)
    mm = _OPEN.get(file)
    if mm is None:
        with _LOCK:
            mm = _OPEN.get(file)
            if mm is None:
                mm = np.load(file, mmap_mode="r")
                if mm.ndim != 4:
                    raise ValueError(
                        f"{file}: packed video must be (N,H,W,C), "
                        f"got shape {mm.shape}")
                _OPEN[file] = mm
    if not 0 <= idx < len(mm):
        raise IndexError(f"{file}: frame {idx} out of range (N={len(mm)})")
    return np.array(mm[idx])


def pack_video(video: VideoRecord, out_dir: str,
               loader: Optional[Callable[[str], np.ndarray]] = None
               ) -> VideoRecord:
    """Pack one video's frames into `<out_dir>/<video_id>.npy`; returns its
    record with packed paths (labels shared). Frames are written one at a
    time through a memmap into `<video_id>.npy.tmp`, renamed when complete,
    so a killed pack leaves no valid-looking `.npy` with zero frames."""
    if loader is None:
        from tmrnet_torch.data.pipeline import load_frame as loader
    if not video.frame_paths:
        return VideoRecord(video.video_id, [], video.labels)
    out = os.path.join(out_dir, f"{video.video_id}.npy")
    first = np.asarray(loader(video.frame_paths[0]))
    if first.dtype != np.uint8:
        raise ValueError(f"{video.video_id}: packed frames must be uint8, "
                         f"the loader returned {first.dtype}")
    n = len(video.frame_paths)
    tmp = out + ".tmp"          # no .npy suffix: manifest walks skip it
    try:
        mm = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=np.uint8, shape=(n,) + first.shape)
        mm[0] = first
        for j in range(1, n):
            frame = np.asarray(loader(video.frame_paths[j]))
            if frame.shape != first.shape:
                raise ValueError(
                    f"{video.video_id}: frame {j} is {frame.shape}, expected "
                    f"{first.shape}: a packed video needs uniform frames")
            mm[j] = frame
        mm.flush()
        del mm
        os.replace(tmp, out)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return VideoRecord(video.video_id,
                       [f"{out}#{j}" for j in range(n)], video.labels)


def pack_manifest(manifest: Manifest, out_dir: str,
                  workers: Optional[int] = None,
                  loader: Optional[Callable[[str], np.ndarray]] = None
                  ) -> Manifest:
    """Pack every video of a manifest (videos in parallel threads); returns
    the packed manifest, same order, ids and labels. Duplicate video ids
    would overwrite each other's `.npy` and are refused."""
    ids = [v.video_id for v in manifest.videos]
    if len(set(ids)) != len(ids):
        dup = sorted({i for i in ids if ids.count(i) > 1})
        raise ValueError(f"duplicate video ids {dup}: packed files are "
                         f"named <video_id>.npy and would collide")
    os.makedirs(out_dir, exist_ok=True)
    workers = workers or min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as pool:
        packed = list(pool.map(
            lambda v: pack_video(v, out_dir, loader), manifest.videos))
    return Manifest(packed)
