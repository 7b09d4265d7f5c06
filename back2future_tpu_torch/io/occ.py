"""Three-state occlusion derivation from depth + flow.

Reference: flowExtensions.lua:172-239 (`getOCC`) — forward/backward z-buffer
splatting followed by a 3x3 median filter. States: 0 = occluded backward
(pixel disappears toward the past), 0.5 = visible, 1 = occluded forward.

The port's copy of back2future_tpu/io/occ.py. The reference iterates
pixels column-major with last-writer-wins z-buffer updates; that traversal
order is part of the observable behavior, so the splatting is inherently
sequential. `get_occ` runs the exact-parity C++ loop
(runtime/src/getocc.cc, built by runtime/host_build.py, which raises if
the build fails: no fallback). `get_occ_reference` is the pure-Python
oracle (minutes per frame, occ.py:1-12), kept as the semantic
specification and held equal to `get_occ` in tests/test_torch_io.py.
"""

from __future__ import annotations

import math

import numpy as np


def _round_torch_1based(zero_based: float, disp: float) -> int:
    """torch.round (C round(): half away from zero) applied in the
    reference's 1-based frame — getOCC rounds x_1based + flow
    (flowExtensions.lua:184-185), and half-away rounding is not
    shift-invariant at negative .5 ties, so the frame shift must sit
    inside the round. Returns a 0-based coordinate."""
    v = zero_based + 1.0 + disp
    return int(math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)) - 1


def _median_lower(vals: np.ndarray) -> float:
    """torch :median() — the ceil(n/2)-th smallest (lower median)."""
    v = np.sort(vals, axis=None)
    return float(v[(v.size + 1) // 2 - 1])


def get_occ(depth: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """depth (H, W); flow (H, W, 2) [u, v] -> occlusion (H, W) in {0, .5, 1}."""
    import ctypes

    from ..runtime.host_build import load_library

    depth = np.ascontiguousarray(depth, np.float64)
    flow = np.ascontiguousarray(flow, np.float64)
    h, w = depth.shape
    assert flow.shape == (h, w, 2), flow.shape
    occ = np.empty((h, w), np.float64)
    dptr = ctypes.POINTER(ctypes.c_double)
    load_library("getocc").get_occ_f64(
        depth.ctypes.data_as(dptr), flow.ctypes.data_as(dptr),
        occ.ctypes.data_as(dptr), ctypes.c_int64(h), ctypes.c_int64(w))
    return occ


def get_occ_reference(depth: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Pure-Python oracle for get_occ (exact flowExtensions.lua:172-239
    semantics; slow — for tests and spec only)."""
    depth = np.asarray(depth, np.float64)
    flow = np.asarray(flow, np.float64)
    h, w = depth.shape
    fwd_pixel = np.full((h, w), -1, np.int64)
    fwd_z = np.zeros((h, w))
    bwd_pixel = np.full((h, w), -1, np.int64)
    bwd_z = np.zeros((h, w))
    occ = np.full((h, w), 0.5)

    # Column-major traversal with linear id i = x*h + y (0-based), matching
    # the reference's (x-1)*h + (y-1).
    for x in range(w):
        for y in range(h):
            i = x * h + y
            u, v = flow[y, x, 0], flow[y, x, 1]
            for direction in (1, -1):
                xf = _round_torch_1based(x, direction * u)
                yf = _round_torch_1based(y, direction * v)
                pix = fwd_pixel if direction == 1 else bwd_pixel
                zbuf = fwd_z if direction == 1 else bwd_z
                state = 1.0 if direction == 1 else 0.0
                if 0 <= xf < w and 0 <= yf < h:
                    if pix[yf, xf] == -1:
                        pix[yf, xf] = i
                        zbuf[yf, xf] = depth[y, x]
                    elif depth[y, x] - zbuf[yf, xf] < -0.1:
                        # current pixel is closer: previous occupant is occluded
                        occ_x = pix[yf, xf] // h
                        occ_y = pix[yf, xf] % h
                        occ[occ_y, occ_x] = state
                        pix[yf, xf] = i
                        zbuf[yf, xf] = depth[y, x]
                    else:
                        occ[y, x] = state
                else:
                    occ[y, x] = state

    # 3x3 median filter with replicated borders handled by window clipping
    # (flowExtensions.lua:230-237)
    src = occ.copy()
    out = np.empty_like(occ)
    for y in range(h):
        y0, y1 = max(y - 1, 0), min(y + 1, h - 1) + 1
        for x in range(w):
            x0, x1 = max(x - 1, 0), min(x + 1, w - 1) + 1
            out[y, x] = _median_lower(src[y0:y1, x0:x1])
    return out
