"""Dataset channel statistics (the reference's meanStd.py tool,
`Training memory bank model/meanStd.py:27-63`): `python -m tmrnet_torch
stats`.

Own copy of `tmrnet_tpu/data/stats.py` (`resize_224` :25, `channel_stats`
:33), numpy and PIL only. The reference's procedure is PER-IMAGE
aggregation: each image is resized to 224x224, ToTensor-scaled to [0,1],
reduced to a per-channel mean and a per-channel std (population, over that
image's pixels), and the tool reports the mean over images of each
(`meanStd.py:53-61`). The std is therefore the average WITHIN-image std:
it carries no between-image variance term. The normalization constants
used throughout the reference (`train_memorybank.py:80`) were produced by
exactly this procedure, so `channel_stats` reproduces it by default;
`per_image=False` gives the true population mean/std over all pixels
instead.

Both modes stream in one pass with float64 accumulators. The resize is
PIL's bilinear one, as the reference's and JAX's: where PIL is missing it
raises, since another resize gives other statistics.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


def resize_224(img: np.ndarray) -> np.ndarray:
    """PIL bilinear resize to 224x224, matching meanStd.py's
    `transforms.Resize((224, 224))` preprocessing (`meanStd.py:32-36`)."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("the 224x224 resize of `stats` is PIL's bilinear "
                          "one, and PIL (pillow) is not installed; pass "
                          "--no-resize to take the frames as they are"
                          ) from exc

    return np.asarray(Image.fromarray(img).resize((224, 224), Image.BILINEAR))


def channel_stats(
    frames: Iterable[np.ndarray], per_image: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """frames: iterable of HxWx3 uint8 arrays -> (mean, std) in [0,1] scale.

    per_image=True (default): mean over images of per-image channel means and
    of per-image channel stds, the reference meanStd.py aggregate.
    per_image=False: population mean/std over all pixels pooled together
    (at uint8/255 value range the raw-moment variance is exact to ~1e-12;
    the clamp below only guards the theoretical negative-epsilon case).
    """
    n = 0
    s = np.zeros(3, np.float64)
    ss = np.zeros(3, np.float64)
    for img in frames:
        x = img.reshape(-1, img.shape[-1]).astype(np.float64) / 255.0
        if per_image:
            n += 1
            s += x.mean(axis=0)
            ss += x.std(axis=0)  # population std within this image
        else:
            n += x.shape[0]
            s += x.sum(axis=0)
            ss += (x * x).sum(axis=0)
    if n == 0:
        raise ValueError("no frames")
    mean = s / n
    if per_image:
        std = ss / n
    else:
        var = ss / n - mean * mean
        std = np.sqrt(np.maximum(var, 0))
    return mean.astype(np.float32), std.astype(np.float32)
