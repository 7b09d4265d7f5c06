"""Flow-field visualization (HSL colour coding; pure NumPy).

Reference: flowExtensions.lua:17-150 — hue encodes direction, saturation
encodes magnitude, lightness varies inversely with saturation (null flow =
white).

The port's copy of back2future_tpu/io/viz.py.
"""

from __future__ import annotations

import numpy as np


def compute_norm(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Flow magnitude (flowExtensions.lua:17-31)."""
    return np.sqrt(u.astype(np.float64) ** 2 + v.astype(np.float64) ** 2)


def compute_angle(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Flow direction in degrees in [0, 360) with the reference's quadrant
    conventions (flowExtensions.lua:41-69)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        base = np.degrees(np.arctan(np.abs(v / u)))
    base = np.nan_to_num(base, nan=0.0)
    ang = base.copy()
    ang = np.where((u >= 0) & (v < 0), 360.0 - base, ang)
    ang = np.where((u < 0) & (v >= 0), 180.0 - base, ang)
    ang = np.where((u < 0) & (v < 0), 180.0 + base, ang)
    ang = np.where((u == 0) & (v >= 0), 90.0, ang)
    ang = np.where((u == 0) & (v <= 0), 270.0, ang)
    return ang


def _hsl_to_rgb(hsl: np.ndarray) -> np.ndarray:
    """HSL (all in [0,1], hue wraps) -> RGB, matching torch image.hsl2rgb."""
    h, s, l = hsl[..., 0] % 1.0, hsl[..., 1], hsl[..., 2]
    c = (1.0 - np.abs(2.0 * l - 1.0)) * s
    hp = h * 6.0
    x = c * (1.0 - np.abs(hp % 2.0 - 1.0))
    z = np.zeros_like(c)
    conds = [
        (hp < 1, np.stack([c, x, z], -1)),
        ((hp >= 1) & (hp < 2), np.stack([x, c, z], -1)),
        ((hp >= 2) & (hp < 3), np.stack([z, c, x], -1)),
        ((hp >= 3) & (hp < 4), np.stack([z, x, c], -1)),
        ((hp >= 4) & (hp < 5), np.stack([x, z, c], -1)),
        ((hp >= 5), np.stack([c, z, x], -1)),
    ]
    rgb = np.zeros(hsl.shape, np.float64)
    for cond, val in conds:
        rgb = np.where(cond[..., None], val, rgb)
    m = (l - c / 2.0)[..., None]
    return np.clip(rgb + m, 0.0, 1.0)


def field2rgb(norm: np.ndarray, angle: np.ndarray, max_norm: float | None = None):
    """(norm, angle) -> (H, W, 3) float RGB in [0,1]
    (flowExtensions.lua:81-124)."""
    saturate = max_norm is not None
    mx = max(float(max_norm) if saturate else float(norm.max()), 1e-2)
    hsl = np.zeros(norm.shape + (3,), np.float64)
    hsl[..., 0] = angle / 360.0
    sat = norm / mx
    if saturate:
        sat = np.tanh(sat)
    hsl[..., 1] = sat
    hsl[..., 2] = 1.0 - 0.5 * sat
    return _hsl_to_rgb(hsl), mx


def xy2rgb(flow: np.ndarray, max_norm: float | None = None):
    """(H, W, 2) flow -> (H, W, 3) RGB visualization
    (flowExtensions.lua:134-150)."""
    flow = np.asarray(flow)
    u, v = flow[..., 0], flow[..., 1]
    return field2rgb(compute_norm(u, v), compute_angle(u, v), max_norm)
