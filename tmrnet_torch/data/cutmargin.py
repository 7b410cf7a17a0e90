"""Black-margin cropping of endoscopic frames.

Port of `tmrnet_tpu/data/cutmargin.py` (`_binary_majority` :24,
`margin_bbox` :42, `cut_black_margin` :88, `resize_square` :98). It
reimplements the reference's `change_size()` (`code/video2frame_
cutmargin.py:20-48`) without its interpreted pixel loops: grayscale ->
binary threshold (15) -> 19x19 median blur -> bounding box of the nonzero
rows and columns (with a 10-pixel guard band on the column scan) -> crop.
cv2 does the grayscale and the median where it is installed; without it,
numpy does both with the same results (BT.601 luma, a majority vote),
and `data/native.py::cutmargin_bbox` is a third path to the same box.
`resize_square` is cv2's INTER_AREA and raises where cv2 is missing (JAX
falls back to a nearest-neighbour resize, which gives other frames).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

try:
    import cv2  # noqa: F401

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False


def _binary_majority(mask: np.ndarray, k: int) -> np.ndarray:
    """cv2.medianBlur on a binary image == majority vote in the k x k
    window; numpy via a 2-D integral image (clipped windows with the
    full-window threshold, as the native path does; conservative at the
    borders, which are black margin anyway)."""
    h, w = mask.shape
    integ = np.zeros((h + 1, w + 1), np.int32)
    np.cumsum(np.cumsum(mask, axis=0), axis=1, out=integ[1:, 1:])
    r = k // 2
    y0 = np.clip(np.arange(h) - r, 0, h)
    y1 = np.clip(np.arange(h) + r + 1, 0, h)
    x0 = np.clip(np.arange(w) - r, 0, w)
    x1 = np.clip(np.arange(w) + r + 1, 0, w)
    counts = (integ[y1][:, x1] - integ[y1][:, x0]
              - integ[y0][:, x1] + integ[y0][:, x0])
    return counts > (k * k) // 2


def margin_bbox(image: np.ndarray, threshold: int = 15,
                blur_ksize: int = 19, guard: int = 10
                ) -> Optional[Tuple[int, int, int, int]]:
    """Bounding box (row0, row1, col0, col1) of non-black content, or None
    if the frame is entirely black (the reference returns the input
    unchanged).

    The reference's semantics: both the row and the column extents come
    from pixels whose column lies in the [guard, width-guard) band, and
    the crop excludes the max row and column (the reference slices [min,
    min+(max-min))). Frames narrower than 2*guard have an empty scan band
    -> None, like the reference's empty edge list."""
    if image.ndim == 3:
        if _HAS_CV2:
            import cv2

            gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
        else:
            # ITU-R BT.601 luma, the weights cv2.cvtColor uses
            w_ = np.array([0.299, 0.587, 0.114], np.float32)
            gray = np.clip(np.round(image.astype(np.float32) @ w_),
                           0, 255).astype(np.uint8)
    else:
        gray = image
    binary = (gray > threshold).astype(np.uint8)
    if _HAS_CV2:
        import cv2

        mask = cv2.medianBlur(binary * 255, blur_ksize) > 0
    else:
        # the raw threshold mask without the median would let one hot
        # pixel in the margin expand the box: majority-filter it
        mask = _binary_majority(binary.astype(bool), blur_ksize)

    h, w = mask.shape
    band = mask[:, guard:w - guard]          # empty when w <= 2*guard
    ys, xs = np.nonzero(band)
    if ys.size == 0:
        return None
    r0, r1 = int(ys.min()), int(ys.max())
    c0, c1 = int(xs.min()) + guard, int(xs.max()) + guard
    # exclusive of the max row/col, like the reference's width/height
    return r0, max(r1, r0 + 1), c0, max(c1, c0 + 1)


def cut_black_margin(image: np.ndarray, threshold: int = 15,
                     blur_ksize: int = 19, guard: int = 10) -> np.ndarray:
    """Crop away black margins; the input unchanged if all-black."""
    bbox = margin_bbox(image, threshold, blur_ksize, guard)
    if bbox is None:
        return image
    r0, r1, c0, c1 = bbox
    return image[r0:r1, c0:c1]


def resize_square(image: np.ndarray, size: int = 250) -> np.ndarray:
    """Resize to (size, size) by cv2's INTER_AREA, the reference's
    preprocessing target. Raises where cv2 is missing: no other resize
    gives the same frames."""
    if not _HAS_CV2:
        raise RuntimeError("resize_square needs cv2 (opencv-python) for "
                           "its INTER_AREA resize, which is not installed; "
                           "no other resize gives the same frames")
    import cv2

    return cv2.resize(image, (size, size), interpolation=cv2.INTER_AREA)
