"""The test-time transform stack, as pure numpy functions of a clip.

Port of `tmrnet_tpu/data/transforms.py` (`clip_rng` :30,
`random_crop_per_frame` :60, `center_crop` :75, `five_crop` :128,
`ten_crop` :139, `pad_or_crop` :146, `resize_clip` :158, `normalize` :215,
`EvalTransform` :334-392). Clips are (T, H, W, 3) uint8 arrays. The resize
is cv2's and returns early when the size already matches, so prepared
250x250 frames under crop type 1 need no cv2. The training transforms come
with training.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from tmrnet_torch.config import CHOLEC80_MEAN, CHOLEC80_STD

try:
    import cv2

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False


def clip_rng(epoch: int, clip_id: int, base_seed: int = 0) -> np.random.Generator:
    """The generator of one (epoch, clip): epoch and clip id in the high
    Philox counter words, so that adjacent clips' streams do not overlap."""
    return np.random.Generator(
        np.random.Philox(key=np.uint64(base_seed),
                         counter=[0, 0, np.uint64(clip_id),
                                  np.uint64(epoch)]))


def random_crop_per_frame(clip: np.ndarray, size: int,
                          rng: np.random.Generator) -> np.ndarray:
    """An independent crop offset per frame (the reference's test crop 0,
    torchvision RandomCrop per image)."""
    t, h, w = clip.shape[:3]
    if h == size and w == size:
        return clip
    ys = rng.integers(0, h - size + 1, size=t)
    xs = rng.integers(0, w - size + 1, size=t)
    return np.stack([clip[i, y:y + size, x:x + size]
                     for i, (y, x) in enumerate(zip(ys, xs))])


def center_crop(clip: np.ndarray, size: int) -> np.ndarray:
    h, w = clip.shape[1:3]
    y, x = (h - size) // 2, (w - size) // 2
    return clip[:, y:y + size, x:x + size]


def five_crop(clip: np.ndarray, size: int) -> np.ndarray:
    """Four corners + center -> (5, T, size, size, C) (torchvision
    FiveCrop, the reference's test crop 5)."""
    t, h, w = clip.shape[:3]
    tl = clip[:, :size, :size]
    tr = clip[:, :size, w - size:]
    bl = clip[:, h - size:, :size]
    br = clip[:, h - size:, w - size:]
    return np.stack([tl, tr, bl, br, center_crop(clip, size)])


def ten_crop(clip: np.ndarray, size: int) -> np.ndarray:
    """FiveCrop + the same flipped horizontally -> (10, T, size, size, C)
    (torchvision TenCrop, the reference's test crop 10)."""
    five = five_crop(clip, size)
    return np.concatenate([five, five[:, :, :, ::-1]], axis=0)


def pad_or_crop(clip: np.ndarray, size: int) -> np.ndarray:
    """Center pad-or-crop to (size, size)."""
    t, h, w = clip.shape[:3]
    out = np.zeros((t, size, size, clip.shape[3]), clip.dtype)
    sy, dy = (max(0, (h - size) // 2), max(0, (size - h) // 2))
    sx, dx = (max(0, (w - size) // 2), max(0, (size - w) // 2))
    ch, cw = min(h, size), min(w, size)
    out[:, dy:dy + ch, dx:dx + cw] = clip[:, sy:sy + ch, sx:sx + cw]
    return out


def resize_clip(clip: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Every frame to `size` (H, W) by cv2's bilinear resize; the clip
    itself where it has that size already."""
    if clip.shape[1:3] == tuple(size):
        return clip
    if not _HAS_CV2:
        raise RuntimeError("resize requires cv2")
    out = np.empty((clip.shape[0], size[0], size[1], clip.shape[3]),
                   dtype=clip.dtype)
    for i in range(clip.shape[0]):
        out[i] = cv2.resize(clip[i], (size[1], size[0]),
                            interpolation=cv2.INTER_LINEAR)
    return out


def normalize(clip: np.ndarray, mean: Sequence[float],
              std: Sequence[float]) -> np.ndarray:
    """uint8 [0, 255] -> float32 normalized (ToTensor + Normalize)."""
    x = clip.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@dataclasses.dataclass
class EvalTransform:
    """crop_type 0: a random crop per frame / 1: center crop / 2 or 3:
    resize only / 5: five-crop / 10: ten-crop (reference
    `train_memorybank.py:101-127`; 2 and 3 are two reference scripts'
    numbers of one stack). Types 5 and 10 return (ncrops, T, size, size,
    C).
    normalize=False returns the cropped uint8, for the card to normalize
    (`data.device_normalize`)."""

    crop_size: int = 224
    resize: int = 250
    crop_type: int = 1
    mean: Sequence[float] = CHOLEC80_MEAN
    std: Sequence[float] = CHOLEC80_STD
    base_seed: int = 0
    normalize: bool = True

    @property
    def num_crops(self) -> int:
        return {5: 5, 10: 10}.get(self.crop_type, 1)

    def _finish(self, clip: np.ndarray) -> np.ndarray:
        if not self.normalize:
            return clip
        return normalize(clip, self.mean, self.std)

    def __call__(self, clip: np.ndarray, epoch: int = 0, clip_id: int = 0
                 ) -> np.ndarray:
        if self.crop_type in (2, 3):
            # the reference's crop 2 resizes straight to the crop size
            return self._finish(
                resize_clip(clip, (self.crop_size, self.crop_size)))
        clip = resize_clip(clip, (self.resize, self.resize))
        if self.crop_type == 0:
            clip = random_crop_per_frame(
                clip, self.crop_size, clip_rng(epoch, clip_id, self.base_seed))
        elif self.crop_type == 1:
            clip = center_crop(clip, self.crop_size)
        elif self.crop_type == 5:
            return self._finish(five_crop(clip, self.crop_size))
        elif self.crop_type == 10:
            return self._finish(ten_crop(clip, self.crop_size))
        else:
            raise ValueError(f"unsupported crop_type {self.crop_type}")
        return self._finish(clip)
