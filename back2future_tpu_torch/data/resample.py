"""Host-side raster resize (pure NumPy), the two modes of torch's
`image.scale` that the reference's library mode uses (back2future.lua):

  'simple'   — nearest neighbour (flow and occlusion maps, where
               interpolating across motion boundaries would corrupt them)
  'bilinear' — bilinear with the align-corners mapping
               `src = dst*(in-1)/(out-1)`, the convention of the
               reference's ScaleBHWD kernel (extras/spybhwd/ScaleBHWD.cu:6-20)

The NumPy path of back2future_tpu/data/resample.py:70-113 (f64 source
coordinates and weights); the port has no native host resampler.
"""

from __future__ import annotations

import numpy as np


def resize(img: np.ndarray, out_h: int, out_w: int, mode: str = "bilinear") -> np.ndarray:
    """Resize an (H, W) or (H, W, C) array to (out_h, out_w)."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        out = img.copy()
    elif mode == "simple":
        ys = np.minimum((np.arange(out_h) * (h / out_h)).astype(np.int64), h - 1)
        xs = np.minimum((np.arange(out_w) * (w / out_w)).astype(np.int64), w - 1)
        out = img[ys[:, None], xs[None, :]]
    elif mode == "bilinear":
        ys = np.arange(out_h) * ((h - 1) / max(out_h - 1, 1))
        xs = np.arange(out_w) * ((w - 1) / max(out_w - 1, 1))
        y0 = np.floor(ys).astype(np.int64)
        x0 = np.floor(xs).astype(np.int64)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        im = img.astype(np.float32)
        row0, row1 = im[y0], im[y1]   # gather each source-row set once
        top = row0[:, x0] * (1 - wx) + row0[:, x1] * wx
        bot = row1[:, x0] * (1 - wx) + row1[:, x1] * wx
        out = top * (1 - wy) + bot * wy
        if np.issubdtype(img.dtype, np.floating):
            out = out.astype(img.dtype)
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    return out[..., 0] if squeeze else out
