"""The train- and test-time transform stacks, as pure numpy functions of a
clip and its (epoch, clip) seed.

Port of `tmrnet_tpu/data/transforms.py` (`clip_rng` :30, `random_crop`
:50, `random_crop_per_frame` :60, `center_crop` :75,
`random_horizontal_flip` :81, `random_rotation` :88, `random_resized_crop`
:105, `five_crop` :128, `ten_crop` :139, `pad_or_crop` :146,
`resize_clip` :158, the colour jitter :175-212, `normalize` :215,
`TrainTransform` :225-289, `random_choice_frames`, `VideoTrainTransform`
and `VideoEvalTransform` :291-331, `EvalTransform` :334-392). Clips are (T, H, W,
3) uint8 arrays. The resize is cv2's and returns early when the size
already matches, so prepared 250x250 frames need no cv2 to be resized. The
rotation and the hue shift are cv2's too: where cv2 is missing they raise
(JAX's skip them), so a training stack without cv2 runs with
`data.use_flip=false` (crop and flip only). `TrainTransform(use_native=
True)` normalizes through the port's C++ library (`data/native.py`), as
JAX's does (:277-288).
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


def _need_cv2(what: str) -> None:
    if not _HAS_CV2:
        raise RuntimeError(f"{what} requires cv2 (opencv-python), which is "
                           f"not installed; train with data.use_flip=false "
                           f"for the crop and flip alone")


def random_crop(clip: np.ndarray, size: int,
                rng: np.random.Generator) -> np.ndarray:
    """One crop offset for the whole clip."""
    t, h, w = clip.shape[:3]
    if h == size and w == size:
        return clip
    y = int(rng.integers(0, h - size + 1))
    x = int(rng.integers(0, w - size + 1))
    return clip[:, y:y + size, x:x + size]


def random_horizontal_flip(clip: np.ndarray, rng: np.random.Generator,
                           prob: float = 0.5) -> np.ndarray:
    if rng.random() < prob:
        return clip[:, :, ::-1]
    return clip


def random_rotation(clip: np.ndarray, degrees: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Every frame rotated by one integer angle in [-degrees, degrees]
    about its centre (cv2, bilinear, zero border)."""
    angle = int(rng.integers(-int(degrees), int(degrees) + 1))
    if angle == 0:
        return clip
    _need_cv2("the rotation")
    h, w = clip.shape[1:3]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    out = np.empty_like(clip)
    for i in range(clip.shape[0]):
        out[i] = cv2.warpAffine(clip[i], m, (w, h), flags=cv2.INTER_LINEAR,
                                borderValue=0)
    return out


def random_resized_crop(clip: np.ndarray, size: int, rng: np.random.Generator,
                        scale: Tuple[float, float] = (0.2, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                        ) -> np.ndarray:
    """RandomResizedCrop shared across the clip: ten tries at an area and
    aspect ratio that fit, else the centre square; resized to size."""
    t, h, w = clip.shape[:3]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = float(np.exp(log_r))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            y = int(rng.integers(0, h - ch + 1))
            x = int(rng.integers(0, w - cw + 1))
            return resize_clip(clip[:, y:y + ch, x:x + cw], (size, size))
    return resize_clip(center_crop(clip, min(h, w)), (size, size))


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


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1.0 - factor) * b, 0, 255)


def _grayscale(clip_f: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma, as PIL's convert('L')."""
    g = (clip_f[..., 0] * 0.299 + clip_f[..., 1] * 0.587
         + clip_f[..., 2] * 0.114)
    return g[..., None]


def color_jitter(clip: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.1, contrast: float = 0.1,
                 saturation: float = 0.1, hue: float = 0.05) -> np.ndarray:
    """One jitter for the whole clip: brightness, contrast, saturation,
    then a hue shift in HSV (cv2), in the reference's order."""
    bf = rng.uniform(1 - brightness, 1 + brightness)
    cf = rng.uniform(1 - contrast, 1 + contrast)
    sf = rng.uniform(1 - saturation, 1 + saturation)
    hf = rng.uniform(-hue, hue)

    x = clip.astype(np.float32)
    x = np.clip(x * bf, 0, 255)
    mean_gray = _grayscale(x).mean(axis=(1, 2, 3), keepdims=True)
    x = _blend(x, mean_gray, cf)
    x = _blend(x, _grayscale(x), sf)
    if abs(hf) > 1e-6:
        _need_cv2("the hue jitter")
        u8 = x.astype(np.uint8)
        for i in range(u8.shape[0]):
            hsv = cv2.cvtColor(u8[i], cv2.COLOR_RGB2HSV)
            # cv2's hue runs over [0, 180); the factor is in turns
            hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                           + int(round(hf * 180))) % 180
            u8[i] = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
        x = u8.astype(np.float32)
    return x.astype(clip.dtype)


def normalize(clip: np.ndarray, mean: Sequence[float],
              std: Sequence[float]) -> np.ndarray:
    """uint8 [0, 255] -> float32 normalized (ToTensor + Normalize)."""
    x = clip.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@dataclasses.dataclass
class TrainTransform:
    """Resize(250) -> RandomCrop(224) [-> ColorJitter] -> Flip
    [-> Rotation] -> Normalize, one draw per clip from clip_rng(epoch,
    clip_id). use_flip is the reference's --flip: it gates the jitter and
    the rotation; the flip runs in both stacks. normalize=False stops
    before the normalization and returns the uint8 clip, the exact wire of
    `data.device_normalize` (every step before it is uint8 -> uint8).
    use_native: the normalization through the C++ library
    (`data/native.py::preprocess_batch`, crop and flip already applied),
    the same values as numpy's; it builds the library at first use and
    raises where it cannot."""

    crop_size: int = 224
    resize: int = 250
    use_flip: bool = True
    rotate_degrees: float = 5.0
    jitter: float = 0.1
    hue: float = 0.05
    mean: Sequence[float] = CHOLEC80_MEAN
    std: Sequence[float] = CHOLEC80_STD
    base_seed: int = 0
    use_native: bool = False
    normalize: bool = True

    def __call__(self, clip: np.ndarray, epoch: int, clip_id: int) -> np.ndarray:
        rng = clip_rng(epoch, clip_id, self.base_seed)
        clip = resize_clip(clip, (self.resize, self.resize))
        clip = random_crop(clip, self.crop_size, rng)
        if self.use_flip:
            clip = color_jitter(clip, rng, self.jitter, self.jitter,
                                self.jitter, self.hue)
        clip = random_horizontal_flip(clip, rng)
        if self.use_flip:
            clip = random_rotation(clip, self.rotate_degrees, rng)
        if not self.normalize:
            return np.ascontiguousarray(clip)
        if self.use_native:
            from tmrnet_torch.data import native

            z = np.zeros(clip.shape[0], np.int32)
            return native.preprocess_batch(
                clip, z, z, clip.shape[1], z.astype(np.uint8),
                np.asarray(self.mean, np.float32),
                np.asarray(self.std, np.float32))
        return normalize(clip, self.mean, self.std)


def random_choice_frames(clip: np.ndarray, num_frames: int,
                         rng) -> np.ndarray:
    """The fork's RandomChoice frame subsampler (`test-resnet.py:258-270`):
    num_frames indices drawn with replacement, sorted, from the clip
    (commented out in every published fork transform stack; an opt-in
    knob with the same semantics)."""
    if num_frames <= 0:
        return clip
    idx = np.sort(rng.integers(0, clip.shape[0], size=num_frames))
    return clip[idx]


@dataclasses.dataclass
class VideoTrainTransform:
    """The fork's video-direct train stack (`test-resnet.py:206-236`): the
    optional RandomChoice frame subsample, a clip-shared
    RandomResizedCrop(crop_size, scale) and the scaling to float32 [0, 1]
    (no mean or std; the card casts it and normalizes nothing)."""

    crop_size: int = 224
    scale: Tuple[float, float] = (0.2, 1.0)
    base_seed: int = 0
    num_frames: int = -1  # >0 enables the fork's RandomChoice subsampler

    def __call__(self, clip: np.ndarray, epoch: int, clip_id: int) -> np.ndarray:
        rng = clip_rng(epoch, clip_id, self.base_seed)
        clip = random_choice_frames(clip, self.num_frames, rng)
        clip = random_resized_crop(clip, self.crop_size, rng, self.scale)
        return clip.astype(np.float32) / 255.0


@dataclasses.dataclass
class VideoEvalTransform:
    """The fork's video-direct eval stack: a centre pad-or-crop and the
    scaling to float32 [0, 1]."""

    crop_size: int = 224

    def __call__(self, clip: np.ndarray, epoch: int = 0, clip_id: int = 0
                 ) -> np.ndarray:
        return pad_or_crop(clip, self.crop_size).astype(np.float32) / 255.0


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
