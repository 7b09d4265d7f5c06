"""Shared helpers of the criterion library (counterpart of
back2future_tpu/losses/common.py).

Row bands (parallel/spatial.py): at a level the net computes in row
bands, a criterion gets this slot's rows of each tensor and the level's
`Band` (None for a whole level). Its value covers the band's own rows;
what a row reads of its neighbours comes from `rows_halo`, one row of
each neighbouring band, with the image's edge row repeated past the
image's edge, as the whole image's replicate padding has it. A whole
level takes the same path with its own edge rows repeated, so the two
compute the same sums. The coordinates and the out-of-image test use the
band's first row and the level's whole height (`coord_grid`, `rows_of`),
and the normalisations the level's whole size (`numel_of`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.spatial import Band, halo_rows


def coord_grid(b: int, h: int, w: int, dtype=torch.float32,
               device=None, y0: int = 0) -> torch.Tensor:
    """1-indexed pixel-coordinate image (B, H, W, 2) = (x, y) of image rows
    y0 .. y0 + h - 1 (e.g. criterions/OBCCriterion.lua:54-56)."""
    x = torch.arange(1, w + 1, dtype=dtype, device=device).view(1, 1, w).expand(b, h, w)
    y = torch.arange(y0 + 1, y0 + h + 1, dtype=dtype, device=device).view(1, h, 1).expand(b, h, w)
    return torch.stack([x, y], dim=-1)


def in_image_mask(tcoord: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B,H,W) float mask of target coords inside [1,w]x[1,h], h the
    image's whole height (criterions/OBCCriterion.lua:97-101). Carries no
    gradient."""
    tx, ty = tcoord[..., 0], tcoord[..., 1]
    m = (tx >= 1) & (ty >= 1) & (tx <= w) & (ty <= h)
    return m.to(tcoord.dtype)


def rows_of(t: torch.Tensor, band: Optional[Band]) -> int:
    """The level's rows in all: the band's level, or `t`'s own."""
    return t.shape[1] if band is None else band.height


def numel_of(t: torch.Tensor, band: Optional[Band]) -> int:
    """The elements of the whole level of which `t` holds the rows."""
    return t.numel() // max(t.shape[1], 1) * rows_of(t, band)


def first_row(band: Optional[Band]) -> bool:
    """Whether the rows start at the image's first row."""
    return band is None or band.first


def last_row(band: Optional[Band]) -> bool:
    """Whether the rows end at the image's last row."""
    return band is None or band.last


def rows_halo(x: torch.Tensor, band: Optional[Band], grad: bool = True) -> torch.Tensor:
    """(B, h, ...) -> (B, h + 2, ...): the row above, the rows, the row
    below; past the image's edge its edge row again. With `grad` the
    neighbours' rows carry their gradient back to their owners
    (`halo_rows`); without, they are constants and only `x` gets one."""
    src = x if grad else x.detach()
    nb = src if band is None else halo_rows(src, 1, band.comm)
    above = src[:, :1] if first_row(band) else nb[:, :1]
    below = src[:, -1:] if last_row(band) else nb[:, -1:]
    return torch.cat([above, x, below], dim=1)


def own_rows(xh: torch.Tensor) -> torch.Tensor:
    """The rows of a `rows_halo` tensor without its halo."""
    return xh[:, 1:-1]


def unhalo_grad(g: torch.Tensor) -> torch.Tensor:
    """The gradient of a `rows_halo` tensor (no gradient on its halo)
    from its own rows' gradient."""
    return F.pad(g, (0, 0) * (g.dim() - 2) + (1, 1))


def diff_down(xh: torch.Tensor) -> torch.Tensor:
    """Forward differences along H of a `rows_halo` tensor, from the row
    above to the last own row (h + 1 rows: row i + 1 is own row i's);
    zero in the image's last row (criterions/SmoothnessCriterion.lua:45)."""
    return xh[:, 1:] - xh[:, :-1]


def gaussian3_kernel() -> np.ndarray:
    """3x3 normalized gaussian of torch image.gaussian{size=3,normalize=true}
    (sigma = 0.25 * size; criterions/MSSIML1Criterion.lua:36)."""
    d = np.array([-1.0, 0.0, 1.0])
    g = np.exp(-((d / 0.75) ** 2) / 2.0)
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def gaussian3_center_weight() -> float:
    return float(gaussian3_kernel()[1, 1])


def gauss3_rows(xh: torch.Tensor) -> torch.Tensor:
    """The depthwise 3x3 gaussian of the own rows of a `rows_halo` tensor
    (NHWC), columns replication-padded."""
    c = xh.shape[-1]
    k = torch.from_numpy(gaussian3_kernel()).to(xh.device, xh.dtype)
    xp = F.pad(xh.permute(0, 3, 1, 2), (1, 1, 0, 0), mode="replicate")
    return F.conv2d(xp, k.expand(c, 1, 3, 3), groups=c).permute(0, 2, 3, 1)


def depthwise_gauss3(x: torch.Tensor) -> torch.Tensor:
    """Replication-pad 1 + depthwise 3x3 gaussian filter (NHWC), matching the
    reference's SpatialReplicationPadding + per-channel SpatialConvolution
    (criterions/MSSIML1Criterion.lua:37-43)."""
    return gauss3_rows(rows_halo(x, None))


def fwd_diff_x(x: torch.Tensor) -> torch.Tensor:
    """Forward difference along W; zeros in the last column."""
    return F.pad(x[:, :, 1:] - x[:, :, :-1], (0, 0, 0, 1))
