"""ctypes bindings to the port's native preprocessing library.

Port of `tmrnet_tpu/data/native.py` over the port's own copy of the C++
source, `tmrnet_torch/native/tmrnet_data.cc`: `cutmargin_bbox` (grayscale,
threshold, 19x19 binary median, content box), `resize_bilinear` (batched
uint8 RGB) and `preprocess_batch` (crop, optional horizontal flip and the
u8 -> f32 normalization in one threaded pass per frame). The library is
built at first use with `g++` and the flags of JAX's `native/Makefile`
into the kernels' build directory (`kernels/build.py::BUILD_DIR`), under
a name that carries a hash of the source, the flags and the compiler; a
build goes to a temporary name and is renamed into place, so processes
that build at once each leave a whole library. Where JAX falls back to
numpy when the library cannot be built, this module raises with the
compiler's output: the config asked for the native path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tmrnet_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "tmrnet_data.cc"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native preprocess "
                           f"({SOURCE.name}) is built with it")
    return cxx


def _lib_path(cxx: str) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libtmrnet_data_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    cxx = _compiler()
    out = _lib_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The library, built at the first call; raises where it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.tmr_cutmargin_bbox.restype = ctypes.c_int
        lib.tmr_cutmargin_bbox.argtypes = [u8p] + [ctypes.c_int] * 5 + [i32p]
        lib.tmr_resize_bilinear_u8.restype = None
        lib.tmr_resize_bilinear_u8.argtypes = [u8p] + [ctypes.c_int] * 5 + [
            u8p, ctypes.c_int]
        lib.tmr_preprocess_batch.restype = None
        lib.tmr_preprocess_batch.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p,
            ctypes.c_int, u8p, f32p, f32p, f32p, ctypes.c_int]
        _lib = lib
        return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def cutmargin_bbox(image: np.ndarray, threshold: int = 15,
                   median_ksize: int = 19, guard: int = 10
                   ) -> Optional[Tuple[int, int, int, int]]:
    """The content box (y0, y1, x0, x1) of an (H, W, 3) uint8 frame, None
    where nothing passes the threshold."""
    lib = load_library()
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    bbox = np.zeros(4, np.int32)
    rc = lib.tmr_cutmargin_bbox(_u8(image), h, w, threshold, median_ksize,
                                guard, _i32(bbox))
    if rc != 0:
        return None
    return tuple(int(x) for x in bbox)


def resize_bilinear(frames: np.ndarray, oh: int, ow: int,
                    num_threads: int = 0) -> np.ndarray:
    """frames: (n, ih, iw, 3) uint8 -> (n, oh, ow, 3) uint8."""
    lib = load_library()
    frames = np.ascontiguousarray(frames, np.uint8)
    n, ih, iw = frames.shape[:3]
    out = np.empty((n, oh, ow, 3), np.uint8)
    lib.tmr_resize_bilinear_u8(_u8(frames), n, ih, iw, oh, ow, _u8(out),
                               num_threads)
    return out


def preprocess_batch(frames: np.ndarray, crop_y: np.ndarray,
                     crop_x: np.ndarray, crop: int, flip: np.ndarray,
                     mean, std, num_threads: int = 0) -> np.ndarray:
    """Crop, flip and normalize in one pass. frames (n, ih, iw, 3) uint8 ->
    (n, crop, crop, 3) float32; crop_y, crop_x and flip per frame."""
    frames = np.ascontiguousarray(frames, np.uint8)
    n, ih, iw = frames.shape[:3]
    crop_y = np.ascontiguousarray(crop_y, np.int32)
    crop_x = np.ascontiguousarray(crop_x, np.int32)
    # the C code checks no bounds: an offset outside the frame would read
    # outside the buffer
    if n and (crop_y.min() < 0 or crop_x.min() < 0
              or crop_y.max() + crop > ih or crop_x.max() + crop > iw):
        raise ValueError(
            f"crop window outside the frame: crop={crop}, frames "
            f"{ih}x{iw}, offsets y[{crop_y.min()},{crop_y.max()}] "
            f"x[{crop_x.min()},{crop_x.max()}]")
    flip = np.ascontiguousarray(flip, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib = load_library()
    out = np.empty((n, crop, crop, 3), np.float32)
    lib.tmr_preprocess_batch(_u8(frames), n, ih, iw, _i32(crop_y),
                             _i32(crop_x), crop, _u8(flip), _f32(mean),
                             _f32(std), _f32(out), num_threads)
    return out
