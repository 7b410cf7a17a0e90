"""Video decode and offline preprocessing (the reference's L0 layer).

Port of `tmrnet_tpu/data/video.py` (the decoders :25-56,
`probe_num_frames` :59, `iter_video_frames` :76, `extract_frames` :83,
`extract_frames_packed` :106 with `_npy_uint8_header` :167,
`VideoClipReader` :183-280). `extract_frames` mirrors `code/
video2frame_cutmargin.py`: decode a video, keep every `stride`-th frame
(25 -> 1 fps), cut the black margins, resize to 250x250 and write PNGs;
`extract_frames_packed` writes the same frames as one raw uint8 `.npy`
(`data/packed.py`'s layout). `VideoClipReader` is the video-direct
dataset's reader (the reference's HystDataset, `Training TMRNet/
test-resnet.py:139-203`): global clip index -> (video, start frame) via
cumulative frame counts, with a zeros fallback on decode errors.

Decoders: imageio with its pyav plugin where both import, else cv2's
bundled ffmpeg. `require_decoder` raises, naming both, where neither
imports; every command that decodes calls it before it lists a directory
or probes a file, and nothing decodes another way.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from tmrnet_torch.data.cutmargin import cut_black_margin, resize_square


class NoDecoderError(RuntimeError):
    """Neither imageio with pyav nor cv2 imports on this host."""


def available_decoders() -> List[str]:
    """The decoders that import here, in the order they are tried."""
    found = []
    try:
        import av  # noqa: F401
        import imageio.v3  # noqa: F401

        found.append("imageio+pyav")
    except ImportError:
        pass
    try:
        import cv2  # noqa: F401

        found.append("cv2")
    except ImportError:
        pass
    return found


def require_decoder() -> List[str]:
    """The decoders that import, or NoDecoderError naming both where none
    does: a video is decoded by imageio+pyav or by cv2, and by nothing
    else."""
    found = available_decoders()
    if not found:
        raise NoDecoderError(
            "decoding videos needs imageio+pyav (the imageio and av "
            "packages) or cv2 (opencv-python), and neither imports on this "
            "host; decode elsewhere (prepare --pack) and train from the "
            "packed frames' manifest")
    return found


def _iter_frames_imageio(path: str) -> Iterator[np.ndarray]:
    import imageio.v3 as iio

    for frame in iio.imiter(path, plugin="pyav"):
        yield np.asarray(frame)


def _iter_frames_cv2(path: str) -> Iterator[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cv2 cannot open {path}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def _iter_all_frames(path: str) -> Iterator[np.ndarray]:
    """Decode backend selection: imageio/pyav if installed, else cv2's
    bundled ffmpeg (both are C decode paths)."""
    try:
        yield from _iter_frames_imageio(path)
        return
    except ImportError:
        pass
    yield from _iter_frames_cv2(path)


def probe_num_frames(path: str) -> int:
    try:
        import imageio.v3 as iio

        meta = iio.improps(path, plugin="pyav")
        n = getattr(meta, "n_images", None) or getattr(meta, "shape", (0,))[0]
        return int(n)
    except Exception:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        finally:
            cap.release()


def iter_video_frames(path: str, stride: int = 25) -> Iterator[np.ndarray]:
    """Yield every stride-th frame as RGB uint8."""
    for i, frame in enumerate(_iter_all_frames(path)):
        if i % stride == 0:
            yield frame


def extract_frames(
    video_path: str,
    out_dir: str,
    stride: int = 25,
    size: int = 250,
    cut_margin: bool = True,
) -> List[str]:
    """Decode -> 1 fps -> cutmargin -> 250x250 -> PNG files named by source
    frame index (frame<25*k>.png), matching the reference's on-disk layout."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for k, frame in enumerate(iter_video_frames(video_path, stride)):
        if cut_margin:
            frame = cut_black_margin(frame)
        frame = resize_square(frame, size)
        out = os.path.join(out_dir, f"frame{stride * k}.png")
        cv2.imwrite(out, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        written.append(out)
    return written


def extract_frames_packed(
    video_path: str,
    out_npy: str,
    stride: int = 25,
    size: int = 250,
    cut_margin: bool = True,
) -> int:
    """Decode -> 1 fps -> cutmargin -> size² -> ONE raw uint8 .npy
    (data/packed.py layout), skipping the reference's PNG tree and its
    per-frame decode tax on every later read. Written to a temp file and
    renamed, so a crash never leaves a half-written pack. Returns the
    frame count (0 writes nothing).

    Frames stream straight to disk (peak host memory = one frame): the
    frame count isn't known until decode ends, so a fixed-size npy header
    placeholder is written first and rewritten with the real shape at the
    end. A long Cholec80 video is ~1 GB raw — buffering it per worker
    would put `prepare --pack --workers` (default one per core) at tens
    of GB on a many-core host."""
    n = 0
    tmp = out_npy + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(b"\x00" * _NPY_HEADER_BYTES)  # placeholder, fixed size
            for frame in iter_video_frames(video_path, stride):
                if cut_margin:
                    frame = cut_black_margin(frame)
                frame = np.ascontiguousarray(
                    resize_square(frame, size).astype(np.uint8, copy=False))
                if n == 0:
                    first_shape = frame.shape
                f.write(frame.tobytes())
                n += 1
            if n == 0:
                raise _EmptyVideo
            f.seek(0)
            f.write(_npy_uint8_header((n,) + first_shape))
        os.replace(tmp, out_npy)
    except _EmptyVideo:
        _remove_quiet(tmp)
        return 0
    except BaseException:
        _remove_quiet(tmp)
        raise
    return n


def _remove_quiet(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


class _EmptyVideo(Exception):
    """Internal: decode produced zero frames (write nothing, return 0)."""


_NPY_HEADER_BYTES = 128  # 64-byte aligned; fits any (n,h,w,c) uint8 shape


def _npy_uint8_header(shape: Tuple[int, ...]) -> bytes:
    """A v1.0 .npy header for a C-order uint8 array, padded to exactly
    _NPY_HEADER_BYTES so it can be rewritten in place once the leading
    dimension is known (numpy's own writer pads to a shape-dependent
    size). Format per numpy.lib.format: magic, version, little-endian
    header length, then the dict literal space-padded to end in \\n."""
    head = ("{'descr': '|u1', 'fortran_order': False, "
            f"'shape': {tuple(int(d) for d in shape)!r}, }}").encode("latin1")
    pad = _NPY_HEADER_BYTES - 10 - len(head)  # magic(6)+version(2)+len(2)
    if pad < 1:
        raise ValueError(f"shape {shape} overflows the fixed npy header")
    head += b" " * (pad - 1) + b"\n"
    return (b"\x93NUMPY\x01\x00"
            + len(head).to_bytes(2, "little") + head)


_INHERITED_CURSORS: list = []


class VideoClipReader:
    """Read seq_len-frame clips straight from video files.

    Clip index space matches the frame-dir path: each video of n sampled
    frames contributes n + 1 - seq_len clips. Decode failures return zeros
    (reference fallback behavior).

    Access cost: a per-thread sequential cursor with a seq_len-frame
    sampled-frame buffer makes in-order access (the loaders' epoch order,
    the video engines, streaming) O(stride) decoded frames per clip —
    consecutive clips reuse their seq_len-1 overlapping frames from the
    buffer instead of re-decoding the video from frame 0 (which made an
    epoch O(n^2) in decoded frames). Backward random access reopens the
    video (O(start), the old cost). The buffer holds seq_len RAW decoded
    frames per worker thread. A forked worker process opens its own
    cursor and leaves its copy of the parent's alone: that holds a decoder
    whose threads did not survive the fork (JAX's reader reads from the
    copy, and closing it hangs).

    A video that ends before its metadata frame count (cv2's
    CAP_PROP_FRAME_COUNT routinely overcounts on VFR containers) pads the
    clip tail by repeating the last decoded frame — not silent zeros
    against real labels — and counts it in `short_reads`."""

    def __init__(self, video_paths: Sequence[str], num_frames: Sequence[int],
                 seq_len: int, stride: int = 25,
                 error_policy: str = "zeros"):
        import threading

        self.paths = list(video_paths)
        self.num_frames = np.asarray(num_frames, np.int64)
        self.seq_len = seq_len
        self.stride = stride
        self.error_policy = error_policy
        self.short_reads = 0     # clips tail-padded past the true video end
        self._tls = threading.local()
        cpv = np.maximum(self.num_frames + 1 - seq_len, 0)
        self._cum = np.concatenate([[0], np.cumsum(cpv)])

    def __getstate__(self):
        # the per-thread cursors stay with their threads (a process
        # worker opens its own)
        state = dict(self.__dict__)
        del state["_tls"]
        return state

    def __setstate__(self, state):
        import threading

        self.__dict__.update(state)
        self._tls = threading.local()

    @property
    def num_clips(self) -> int:
        return int(self._cum[-1])

    def locate(self, clip_index: int) -> Tuple[int, int]:
        """global clip index -> (video index, start sampled-frame index)."""
        v = int(np.searchsorted(self._cum, clip_index, side="right") - 1)
        return v, int(clip_index - self._cum[v])

    def _read_sampled(self, v: int, start: int) -> list:
        """Sampled frames [start, start+seq_len) of video v via the
        per-thread cursor; raises IOError('short read') when the range
        cannot be served at all."""
        seq, stride = self.seq_len, self.stride
        need = list(range(start, start + seq))
        st = getattr(self._tls, "st", None)
        if st is not None and st["pid"] != os.getpid():
            # a forked worker's copy of its parent's cursor: kept, never
            # closed (its decoder's threads stayed with the parent, and
            # releasing it would wait for them)
            _INHERITED_CURSORS.append(st)
            st = None
        if st is not None and st["v"] == v:
            missing = [k for k in need if k not in st["buf"]]
            if not missing:
                return [st["buf"][k] for k in need]
            if missing[0] * stride < st["raw"]:
                st = None            # behind the cursor, not buffered
        else:
            st = None
        if st is None:
            st = {"v": v, "it": _iter_all_frames(self.paths[v]),
                  "raw": 0, "buf": {}, "pid": os.getpid()}
            self._tls.st = st
        last_raw = (start + seq - 1) * stride
        try:
            while st["raw"] <= last_raw:
                frame = next(st["it"])
                raw, st["raw"] = st["raw"], st["raw"] + 1
                if raw % stride == 0:
                    k = raw // stride
                    st["buf"][k] = np.asarray(frame)
                    for old_k in [kk for kk in st["buf"] if kk <= k - seq]:
                        del st["buf"][old_k]
        except StopIteration:
            # video ended before its metadata count (probe overcount)
            pass
        got = [k for k in need if k in st["buf"]]
        if not got:
            self._tls.st = None      # don't reuse a drained iterator
            raise IOError("short read")
        if len(got) < seq:
            # tail-pad with the last decoded frame instead of silently
            # zero-filling frames that real labels will be attached to
            self.short_reads += 1
            last = st["buf"][got[-1]]
            return [st["buf"].get(k, last) for k in need]
        return [st["buf"][k] for k in need]

    def read_clip(self, clip_index: int) -> np.ndarray:
        v, start = self.locate(clip_index)
        try:
            return np.stack(self._read_sampled(v, start))
        except Exception:
            self._tls.st = None      # a failed decode poisons the cursor
            if self.error_policy == "raise":
                raise
            return np.zeros((self.seq_len, 256, 256, 3), np.uint8)
