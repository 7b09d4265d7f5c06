"""ImageNet colour normalisation of stacked frames (pure NumPy, HWC with
3F channels): the part of the JAX package's host augmentation
(back2future_tpu/data/augment.py:27-45) that the port's API and wire
decode use. Constants from donkey.lua:35-38."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def color_normalize(img: np.ndarray,
                    mean: np.ndarray = IMAGENET_MEAN,
                    std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    """(img - mean) / std per 3-channel frame group (transforms.lua:33-45)."""
    f = img.shape[-1] // 3
    out = img - np.tile(mean, f)
    out /= np.tile(std, f)
    return out
