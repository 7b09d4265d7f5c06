"""Shared helpers of the criterion library (counterpart of
back2future_tpu/losses/common.py)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def coord_grid(b: int, h: int, w: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """1-indexed pixel-coordinate image (B, H, W, 2) = (x, y)
    (e.g. criterions/OBCCriterion.lua:54-56)."""
    x = torch.arange(1, w + 1, dtype=dtype, device=device).view(1, 1, w).expand(b, h, w)
    y = torch.arange(1, h + 1, dtype=dtype, device=device).view(1, h, 1).expand(b, h, w)
    return torch.stack([x, y], dim=-1)


def in_image_mask(tcoord: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B,H,W) float mask of target coords inside [1,w]x[1,h]
    (criterions/OBCCriterion.lua:97-101). Carries no gradient."""
    tx, ty = tcoord[..., 0], tcoord[..., 1]
    m = (tx >= 1) & (ty >= 1) & (tx <= w) & (ty <= h)
    return m.to(tcoord.dtype)


def gaussian3_kernel() -> np.ndarray:
    """3x3 normalized gaussian of torch image.gaussian{size=3,normalize=true}
    (sigma = 0.25 * size; criterions/MSSIML1Criterion.lua:36)."""
    d = np.array([-1.0, 0.0, 1.0])
    g = np.exp(-((d / 0.75) ** 2) / 2.0)
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def gaussian3_center_weight() -> float:
    return float(gaussian3_kernel()[1, 1])


def depthwise_gauss3(x: torch.Tensor) -> torch.Tensor:
    """Replication-pad 1 + depthwise 3x3 gaussian filter (NHWC), matching the
    reference's SpatialReplicationPadding + per-channel SpatialConvolution
    (criterions/MSSIML1Criterion.lua:37-43)."""
    c = x.shape[-1]
    k = torch.from_numpy(gaussian3_kernel()).to(x.device, x.dtype)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    return F.conv2d(xp, k.expand(c, 1, 3, 3), groups=c).permute(0, 2, 3, 1)


def fwd_diff_y(x: torch.Tensor) -> torch.Tensor:
    """Forward difference along H; zeros in the last row
    (criterions/SmoothnessCriterion.lua:45)."""
    return F.pad(x[:, 1:] - x[:, :-1], (0, 0, 0, 0, 0, 1))


def fwd_diff_x(x: torch.Tensor) -> torch.Tensor:
    """Forward difference along W; zeros in the last column."""
    return F.pad(x[:, :, 1:] - x[:, :, :-1], (0, 0, 0, 1))
