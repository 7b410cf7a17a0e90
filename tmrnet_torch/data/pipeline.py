"""Frame loading.

Port of `tmrnet_tpu/data/pipeline.py::load_frame` (:29-44). The clip
dataset and loader come with the rest of the data layer.
"""

from __future__ import annotations

import numpy as np

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
