"""Host-side raster resampling, the two modes of torch's `image.scale`
that the reference's library mode uses (back2future.lua):

  'simple'   — nearest neighbour (flow and occlusion maps, where
               interpolating across motion boundaries would corrupt them)
  'bilinear' — bilinear with the align-corners mapping
               `src = dst*(in-1)/(out-1)`, the convention of the
               reference's ScaleBHWD kernel (extras/spybhwd/ScaleBHWD.cu:6-20)

The port's copy of back2future_tpu/data/resample.py. On float32 input
`resize` and the windowed transforms of the augmentation fast path run
the C++ functions of runtime/src/resample.cc (built by
runtime/host_build.py, which raises if the build fails), as the JAX
package's do (f32 weights); the full-plane resizes split their rows over
`host_threads()` threads. Any other dtype takes the NumPy path, as in
the JAX package (f64 coordinates, maps and weights).

The NumPy paths stay as the C++ functions' twins: inside `numpy_twins()`
(the environment variable B2F_HOST_TWINS=1, which threads and spawned
workers see too) every float32 call here and `augment.preprocess` take
them instead. Only tests and chip_smoke.py set it:
tests/test_torch_data.py holds the twins bit for bit against the JAX
package's NumPy paths, tests/test_torch_native_resample.py the C++
functions bit for bit against the JAX package's library.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Optional

import numpy as np

from ..runtime.host_build import host_threads, load_library

TWINS_ENV = "B2F_HOST_TWINS"

_LIB: Optional[ctypes.CDLL] = None
_FP = ctypes.POINTER(ctypes.c_float)


def twins_active() -> bool:
    """True inside `numpy_twins()`."""
    return os.environ.get(TWINS_ENV) == "1"


@contextlib.contextmanager
def numpy_twins():
    """Run the host resampling and photometric pipeline on their NumPy
    twins inside the block (for tests and chip_smoke.py only)."""
    before = os.environ.get(TWINS_ENV)
    os.environ[TWINS_ENV] = "1"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(TWINS_ENV, None)
        else:
            os.environ[TWINS_ENV] = before


def native_lib() -> ctypes.CDLL:
    """The library of runtime/src/resample.cc with its signatures set."""
    global _LIB
    if _LIB is None:
        lib = load_library("resample")
        i64 = ctypes.c_int64
        for fn in (lib.resize_bilinear_f32, lib.resize_nearest_f32):
            fn.restype = None
            fn.argtypes = [_FP, _FP] + [i64] * 6
        lib.rotate_nearest_window_f32.restype = None
        lib.rotate_nearest_window_f32.argtypes = (
            [_FP, _FP] + [i64] * 3 + [ctypes.c_double] + [i64] * 6)
        lib.resize_bilinear_window_f32.restype = None
        lib.resize_bilinear_window_f32.argtypes = [_FP, _FP] + [i64] * 15
        lib.resize_nearest_window_f32.restype = None
        lib.resize_nearest_window_f32.argtypes = [_FP, _FP] + [i64] * 11
        lib.photo_pipeline_f32.restype = None
        lib.photo_pipeline_f32.argtypes = [
            _FP, i64, i64, i64, ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_double), i64,
            _FP, i64, _FP, _FP, i64]
        _LIB = lib
    return _LIB


def native_for(dtype) -> Optional[ctypes.CDLL]:
    """The library for an input of `dtype`: float32 outside
    `numpy_twins()`; None (the NumPy path) otherwise."""
    if dtype != np.float32 or twins_active():
        return None
    return native_lib()


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def resize(img: np.ndarray, out_h: int, out_w: int, mode: str = "bilinear") -> np.ndarray:
    """Resize an (H, W) or (H, W, C) array to (out_h, out_w)."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    lib = native_for(img.dtype)
    if (h, w) == (out_h, out_w):
        out = img.copy()
    elif lib is not None and mode in ("bilinear", "simple"):
        src = np.ascontiguousarray(img)
        out = np.empty((out_h, out_w, img.shape[2]), np.float32)
        fn = lib.resize_bilinear_f32 if mode == "bilinear" else lib.resize_nearest_f32
        fn(_fp(src), _fp(out), h, w, img.shape[2], out_h, out_w, host_threads())
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
# rectangle [oy, oy+wh) x [ox, ox+ww) of the virtual full output plane.
# The C++ functions on float32 input; the NumPy twins replicate the exact
# arithmetic of the corresponding full-plane NumPy path (f64 rotation
# maps + round-half-even; the f64 bilinear weights of `resize`'s twin),
# the C++ ones that of the C++ full-plane functions (the f32 weights of
# resize_bilinear_f32), so fast and slow paths agree bit for bit on
# either backend.

def rotate_nearest_window(src: np.ndarray, angle: float, oy: int, ox: int,
                          wh: int, ww: int, flip_h: bool = False,
                          flip_v: bool = False) -> np.ndarray:
    """Nearest rotation of (H,W,C) about the full-image center, evaluated
    at output rows [oy,oy+wh) x cols [ox,ox+ww); source flips folded in
    (flips precede rotation in the augmentation order); zero fill both
    for out-of-image output coords (integer-translate folding) and
    out-of-image nearest sources."""
    h, w, c = src.shape
    lib = native_for(src.dtype)
    if lib is not None:
        src = np.ascontiguousarray(src)
        out = np.empty((wh, ww, c), np.float32)
        lib.rotate_nearest_window_f32(_fp(src), _fp(out), h, w, c, float(angle), int(flip_h),
                                      int(flip_v), oy, ox, wh, ww)
        return out
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
    lib = native_for(srcbuf.dtype)
    if lib is not None:
        srcbuf = np.ascontiguousarray(srcbuf)
        out = np.empty((wh, ww, c), np.float32)
        lib.resize_bilinear_window_f32(_fp(srcbuf), _fp(out), bh, bw, by0, bx0, ih, iw, c, oh,
                                       ow, int(flip_h), int(flip_v), oy, ox, wh, ww)
        return out
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
    lib = native_for(src.dtype)
    if lib is not None:
        src = np.ascontiguousarray(src)
        out = np.empty((wh, ww, c), np.float32)
        lib.resize_nearest_window_f32(_fp(src), _fp(out), ih, iw, c, oh, ow, int(flip_h),
                                      int(flip_v), oy, ox, wh, ww)
        return out
    ys = np.minimum((np.arange(oy, oy + wh) * (ih / oh)).astype(np.int64),
                    ih - 1)
    xs = np.minimum((np.arange(ox, ox + ww) * (iw / ow)).astype(np.int64),
                    iw - 1)
    if flip_v:
        ys = ih - 1 - ys
    if flip_h:
        xs = iw - 1 - xs
    return src[ys[:, None], xs[None, :]]
