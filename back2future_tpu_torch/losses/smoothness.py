"""Smoothness criterions (counterpart of back2future_tpu/losses/smoothness.py).

First- and second-order contrast-sensitive smoothness have
autodiff-consistent reference backwards (the contrast weights depend only
on the target, which receives no gradient), so they are plain
differentiable functions. The KL criterion's reference backward applies
analytic formulas on eps-clamped values without zeroing clamped entries,
so under `reference_grads=True` it is an autograd Function.

On a row band (losses/common.py) each takes the band's rows and its
`Band`: the differences along H and the KL's neighbours read one row of
each neighbouring band (`rows_halo`), the normalisations use the whole
level's size, and the KL's hand-written backward gives each of the
band's rows its whole gradient, the terms of the row above included.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from .common import (diff_down, first_row, fwd_diff_x, last_row, numel_of, own_rows, rows_halo,
                     unhalo_grad)
from .penalty import make_penalty

_CS = 20.0  # contrast sensitivity (SmoothnessCriterion.lua:25)


@dataclasses.dataclass(frozen=True)
class SmoothConfig:
    penalty: str = "Quadratic"
    size_average: bool = True
    second_order: bool = False
    reference_grads: bool = True


def _weight(d: torch.Tensor) -> torch.Tensor:
    """exp(-20 * mean |d|) over the channels."""
    return torch.exp(-_CS * d.abs().mean(-1, keepdim=True))


def smoothness(flow: torch.Tensor, target: torch.Tensor, cfg: SmoothConfig,
               band=None) -> torch.Tensor:
    """First-order contrast-sensitive smoothness
    (criterions/SmoothnessCriterion.lua:28-73)."""
    p = make_penalty(cfg.penalty)
    gy, gx = diff_down(rows_halo(flow, band))[:, 1:], fwd_diff_x(flow)
    with torch.no_grad():
        wy = _weight(diff_down(rows_halo(target, band, grad=False))[:, 1:])
        wx = _weight(fwd_diff_x(target))
    buf = (p.apply(gx) * wx + p.apply(gy) * wy).sum()
    if cfg.size_average:
        buf = buf / numel_of(flow, band)
    return buf


def _edge_rows_zero(t: torch.Tensor, band) -> torch.Tensor:
    """`t` with its rows zero that are the image's first or last."""
    parts = [t]
    if first_row(band):
        parts = [torch.zeros_like(t[:, :1]), t[:, 1:]]
    if last_row(band):
        parts[-1] = parts[-1][:, :-1]
        parts.append(torch.zeros_like(t[:, :1]))
    return torch.cat(parts, dim=1) if len(parts) > 1 else t


def _two_sided_weights_x(t: torch.Tensor) -> torch.Tensor:
    """exp(-20 * ig), ig the two-sided accumulated mean |target gradient|
    along W: ig[1:] += mean|t[1:] - t[:-1]|, ig[1:-1] += mean|t[1:-1] - t[2:]|
    (SecondOrderSmoothnessCriterion.lua:49-56)."""
    n = t.shape[2]
    ig = torch.zeros(t.shape[:3] + (1,), dtype=t.dtype, device=t.device)
    ig.narrow(2, 1, n - 1).add_(torch.diff(t, dim=2).abs().mean(-1, keepdim=True))
    back = (t.narrow(2, 1, n - 2) - t.narrow(2, 2, n - 2)).abs().mean(-1, keepdim=True)
    ig.narrow(2, 1, n - 2).add_(back)
    return torch.exp(-_CS * ig)


def _two_sided_weights_y(target: torch.Tensor, band) -> torch.Tensor:
    """The same along H from the rows around each row: the difference
    with the row above (none above the image's first row), plus the one
    with the row below (none below its last, nor in its first row)."""
    th = rows_halo(target, band, grad=False)
    t = own_rows(th)
    up = (t - th[:, :-2]).abs().mean(-1, keepdim=True)
    down = _edge_rows_zero((t - th[:, 2:]).abs().mean(-1, keepdim=True), band)
    return torch.exp(-_CS * (up + down))


def second_order_smoothness(flow: torch.Tensor, target: torch.Tensor,
                            cfg: SmoothConfig, band=None) -> torch.Tensor:
    """Second-order variant on 2u_i - u_{i-1} - u_{i+1} with two-sided
    image-gradient weights (criterions/SecondOrderSmoothnessCriterion.lua)."""
    p = make_penalty(cfg.penalty)
    fh = rows_halo(flow, band)
    gy = _edge_rows_zero(2 * fh[:, 1:-1] - fh[:, :-2] - fh[:, 2:], band)
    gx = F.pad(2 * flow[:, :, 1:-1] - flow[:, :, :-2] - flow[:, :, 2:], (0, 0, 1, 1))
    with torch.no_grad():
        wy, wx = _two_sided_weights_y(target, band), _two_sided_weights_x(target)
    buf = (p.apply(gx) * wx + p.apply(gy) * wy).sum()
    if cfg.size_average:
        buf = buf / numel_of(flow, band)
    return buf


def make_flow_smoothness(cfg: SmoothConfig):
    """fn(flow, target, band=None) -> scalar."""
    fn = second_order_smoothness if cfg.second_order else smoothness
    return functools.partial(fn, cfg=cfg)


# --------------------------------------------------------------------------
# KL divergence between neighbouring occlusion pixels
# (criterions/KLDivergenceCriterion.lua)
# --------------------------------------------------------------------------

_KL_EPS = 5e-2


def _kl_padded(occ_h):
    """A `rows_halo` occlusion map replication-padded by 1 column and
    clamped below at eps (KLDivergenceCriterion.lua:36-40)."""
    pp = F.pad(occ_h.permute(0, 3, 1, 2), (1, 1, 0, 0), mode="replicate").permute(0, 2, 3, 1)
    return torch.clamp(pp, min=_KL_EPS)


def _kl_weights(target_h):
    """(wy of the rows from the one above the band to its last, wx of the
    own rows) from a `rows_halo` target."""
    with torch.no_grad():
        return _weight(diff_down(target_h)), _weight(fwd_diff_x(own_rows(target_h)))


def _kl_value(occ_h, target_h, size_average, band):
    b, h2, w, c = occ_h.shape
    h = h2 - 2
    nz = _kl_padded(occ_h)
    lg = torch.log(nz)
    pc, lc = nz[:, 1:1 + h, 1:1 + w], lg[:, 1:1 + h, 1:1 + w]
    pd, ld = nz[:, 2:2 + h, 1:1 + w], lg[:, 2:2 + h, 1:1 + w]    # down neighbour
    pr, lr = nz[:, 1:1 + h, 2:2 + w], lg[:, 1:1 + h, 2:2 + w]    # right neighbour
    gy = (lc - ld) * pc + (ld - lc) * pd
    gx = (lc - lr) * pc + (lr - lc) * pr
    wy, wx = _kl_weights(target_h)
    buf = (gx * wx + gy * wy[:, 1:]).sum()
    return c / numel_of(pc, band) * buf if size_average else buf


class _KLFn(torch.autograd.Function):
    """KL smoothness with the reference backward (smoothness.py:139-168):
    the analytic formulas on the clamped values, to occ only. occ comes
    as a `rows_halo` tensor whose halo rows take no gradient."""

    @staticmethod
    def forward(ctx, occ_h, target_h, size_average, band):
        ctx.size_average, ctx.band = size_average, band
        ctx.save_for_backward(occ_h, target_h)
        return _kl_value(occ_h, target_h, size_average, band)

    @staticmethod
    def backward(ctx, g):
        occ_h, target_h = ctx.saved_tensors
        band = ctx.band
        b, h2, w, c = occ_h.shape
        h = h2 - 2
        nz = _kl_padded(occ_h)
        lg = torch.log(nz)
        pc, lc = nz[:, 1:1 + h, 1:1 + w], lg[:, 1:1 + h, 1:1 + w]
        pd, ld = nz[:, 2:2 + h, 1:1 + w], lg[:, 2:2 + h, 1:1 + w]
        pr, lr = nz[:, 1:1 + h, 2:2 + w], lg[:, 1:1 + h, 2:2 + w]
        pu, lu = nz[:, 0:h, 1:1 + w], lg[:, 0:h, 1:1 + w]          # up neighbour
        pl, ll = nz[:, 1:1 + h, 0:w], lg[:, 1:1 + h, 0:w]          # left neighbour
        wy_up, wx = _kl_weights(target_h)
        wy, wy_up = wy_up[:, 1:], wy_up[:, :-1]
        if first_row(band):   # no weight on the image's first row
            wy_up = torch.cat([torch.ones_like(wy_up[:, :1]), wy_up[:, 1:]], dim=1)
        # the reference's analytic formulas on clamped values
        # (KLDivergenceCriterion.lua:84-103)
        gy = (lc - ld + 1.0 - pd / pc) * wy
        gy = gy + (-pu / pc + lc - lu + 1.0) * wy_up
        gx = (lc - lr + 1.0 - pr / pc) * wx
        tmp = -pl / pc + lc - ll + 1.0
        tmp[:, :, 1:] *= wx[:, :, :-1]
        gx = gx + tmp
        norm = (c / numel_of(pc, band)) if ctx.size_average else 1.0
        return unhalo_grad((gx + gy) * norm * g), None, None, None


@functools.lru_cache(maxsize=None)
def make_kl_smoothness(size_average: bool = True, reference_grads: bool = True):
    """fn(occ, target, band=None) -> scalar: the contrast-weighted KL
    divergence between neighbouring occlusion pixels; the target gets no
    gradient."""

    def kl(occ, target, band=None):
        occ_h = rows_halo(occ, band, grad=not reference_grads)
        target_h = rows_halo(target, band, grad=False)
        if reference_grads:
            return _KLFn.apply(occ_h, target_h, size_average, band)
        return _kl_value(occ_h, target_h, size_average, band)

    return kl
