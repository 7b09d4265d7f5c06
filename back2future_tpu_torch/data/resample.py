"""Host-side raster resize (pure NumPy), the two modes of torch's
`image.scale` that the reference's library mode uses (back2future.lua):

  'simple'   — nearest neighbour (flow and occlusion maps, where
               interpolating across motion boundaries would corrupt them)
  'bilinear' — bilinear with the align-corners mapping
               `src = dst*(in-1)/(out-1)`, the convention of the
               reference's ScaleBHWD kernel (extras/spybhwd/ScaleBHWD.cu:6-20)

The NumPy paths of back2future_tpu/data/resample.py (`resize`, :70-113,
and the windowed transforms of the augmentation fast path, :114-220):
f64 source coordinates, rotation maps and weights. The port keeps no copy
of the JAX package's native resampler (runtime/src/resample.cc, f32
weights); these are the paths that file calls the exact arithmetic of the
full-plane transforms, and tests/test_torch_data.py holds them bit for bit
against the JAX package with its native library switched off.
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


# ------------------------------------------------------------------ windowed
# Window-evaluated transforms for the augmentation fast path
# (augment.augment_sample_cropped): each computes only the output
# rectangle [oy, oy+wh) x [ox, ox+ww) of the virtual full output plane,
# with the exact arithmetic of the corresponding full-plane
# implementation (f64 rotation maps + round-half-even; the f64 bilinear
# weights of `resize`), so fast and slow paths agree bit for bit.

def rotate_nearest_window(src: np.ndarray, angle: float, oy: int, ox: int,
                          wh: int, ww: int, flip_h: bool = False,
                          flip_v: bool = False) -> np.ndarray:
    """Nearest rotation of (H,W,C) about the full-image center, evaluated
    at output rows [oy,oy+wh) x cols [ox,ox+ww); source flips folded in
    (flips precede rotation in the augmentation order); zero fill both
    for out-of-image output coords (integer-translate folding) and
    out-of-image nearest sources."""
    h, w, c = src.shape
    yg = np.arange(oy, oy + wh, dtype=np.int64)[:, None]
    xg = np.arange(ox, ox + ww, dtype=np.int64)[None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ca, sa = np.cos(angle), np.sin(angle)
    xs = ca * (xg - cx) + sa * (yg - cy) + cx
    ys = -sa * (xg - cx) + ca * (yg - cy) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    ok = ((yg >= 0) & (yg < h) & (xg >= 0) & (xg < w)
          & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))
    xsrc = np.clip(w - 1 - xi if flip_h else xi, 0, w - 1)
    ysrc = np.clip(h - 1 - yi if flip_v else yi, 0, h - 1)
    out = src[ysrc, xsrc]
    out[~ok] = 0
    return out


def resize_bilinear_window(srcbuf: np.ndarray, ih: int, iw: int,
                           oh: int, ow: int, oy: int, ox: int,
                           wh: int, ww: int, by0: int = 0, bx0: int = 0,
                           flip_h: bool = False, flip_v: bool = False
                           ) -> np.ndarray:
    """Align-corners bilinear (ih,iw)->(oh,ow) on an output window.
    `srcbuf` holds rows [by0,by0+bh) x [bx0,bx0+bw) of the virtual
    source. Flips are only valid with a full source buffer."""
    bh, bw, c = srcbuf.shape
    ys = np.arange(oy, oy + wh) * ((ih - 1) / max(oh - 1, 1))
    xs = np.arange(ox, ox + ww) * ((iw - 1) / max(ow - 1, 1))
    y0 = np.minimum(np.floor(ys).astype(np.int64), ih - 1)
    x0 = np.minimum(np.floor(xs).astype(np.int64), iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    if flip_v:
        y0, y1 = ih - 1 - y0, ih - 1 - y1
    if flip_h:
        x0, x1 = iw - 1 - x0, iw - 1 - x1
    yb0 = np.clip(y0 - by0, 0, bh - 1)
    yb1 = np.clip(y1 - by0, 0, bh - 1)
    xb0 = np.clip(x0 - bx0, 0, bw - 1)
    xb1 = np.clip(x1 - bx0, 0, bw - 1)
    im = srcbuf.astype(np.float32)
    top = im[yb0][:, xb0] * (1 - wx) + im[yb0][:, xb1] * wx
    bot = im[yb1][:, xb0] * (1 - wx) + im[yb1][:, xb1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(srcbuf.dtype, np.floating):
        out = out.astype(srcbuf.dtype)
    return out


def resize_nearest_window(src: np.ndarray, oh: int, ow: int, oy: int,
                          ox: int, wh: int, ww: int, flip_h: bool = False,
                          flip_v: bool = False) -> np.ndarray:
    """Nearest resize (src dims)->(oh,ow) evaluated on an output window,
    source flips folded in."""
    ih, iw, c = src.shape
    ys = np.minimum((np.arange(oy, oy + wh) * (ih / oh)).astype(np.int64),
                    ih - 1)
    xs = np.minimum((np.arange(ox, ox + ww) * (iw / ow)).astype(np.int64),
                    iw - 1)
    if flip_v:
        ys = ih - 1 - ys
    if flip_h:
        xs = iw - 1 - xs
    return src[ys[:, None], xs[None, :]]
