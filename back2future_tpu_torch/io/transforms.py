"""Flow-aware geometric transforms (pure NumPy).

Reference: flowExtensions.lua:334-363 — rotating or rescaling a flow field
must also rotate/rescale the flow *vectors*, not just resample the raster.

The port's copy of back2future_tpu/io/transforms.py.
"""

from __future__ import annotations

import numpy as np


def _rotate_raster_nearest(img: np.ndarray, angle: float) -> np.ndarray:
    """Rotate (H, W, C) raster about its center, nearest-neighbor sampling,
    zero fill — semantics of torch `image.rotate(..., 'simple')`."""
    h, w = img.shape[:2]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ca, sa = np.cos(angle), np.sin(angle)
    # inverse mapping: source = R(-angle) @ (dst - c) + c
    xs = ca * (xx - cx) + sa * (yy - cy) + cx
    ys = -sa * (xx - cx) + ca * (yy - cy) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.zeros_like(img)
    out[valid] = img[yi[valid], xi[valid]]
    return out


def rotate_flow(flow: np.ndarray, angle: float) -> np.ndarray:
    """Rotate the raster and the flow vectors (flowExtensions.lua:334-343)."""
    rot = _rotate_raster_nearest(np.asarray(flow, np.float32), angle)
    u, v = rot[..., 0].copy(), rot[..., 1].copy()
    fu = np.cos(-angle) * u - np.sin(-angle) * v
    fv = np.sin(-angle) * u + np.cos(-angle) * v
    return np.stack([fu, fv], axis=-1)


def scale_flow(flow: np.ndarray, scale: float, order: str = "simple") -> np.ndarray:
    """Resample the flow raster by `scale` and multiply magnitudes by `scale`
    (flowExtensions.lua:345-352)."""
    from ..data.resample import resize  # lazy: data layer owns resampling

    h, w = flow.shape[:2]
    oh, ow = int(round(h * scale)), int(round(w * scale))
    return resize(np.asarray(flow, np.float32), oh, ow, mode=order) * scale
