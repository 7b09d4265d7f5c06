"""Photometric criterions (counterpart of back2future_tpu/losses/photometric.py).

OBCC, occlusion-aware brightness constancy (criterions/OBCCriterion.lua),
the criterion of the hard recipe; OBGCC, brightness + gradient constancy
(criterions/OBGCCriterion.lua), the criterion of the soft fine-tune
recipe; MBCC, brightness constancy without occlusion masking
(criterions/MBCCriterion.lua), what `-pme_criterion BCC` runs; the SSIM
family, MSSIM(L1) and its occlusion-aware OSSIM(L1)
(criterions/MSSIML1Criterion.lua, OSSIML1Criterion.lua); and the
2-frame `bcc` and `ssim`. Under `reference_grads=True` each of the
multi-frame criteria is an autograd Function with the reference's
hand-written backward, which deviates from the true gradient
(photometric.py:129-165, 212-256, 285-305, 386-434):

  * the occlusion gradient also receives the constant out-of-image
    penalty (OBCCriterion.lua:180-190);
  * no gradient goes to the flow or the target: flow only matters through
    the out-of-image masks and learns through the model's warps;
  * OBGCC only: the brightness term enters the forward without `alpha`
    but the backward with it (OBGCCriterion.lua:97 vs :202); the
    per-frame image-gradient buffers accumulate across frames without
    being re-zeroed (OBGCCriterion.lua:91-92), while each frame's
    gradient comes from its own term alone; and the occlusion gradient
    carries the image-gradient transpose structure (OBGCCriterion.lua:
    215-219);
  * the SSIM family: the backward takes the centre-Gaussian-weight
    approximation of the SSIM derivative and omits the 1/(mx-mn) chain of
    the min/max normalisation (MSSIML1Criterion.lua:218-224).

With `reference_grads=False` each is plain autograd of the same value.

On a row band (losses/common.py) each criterion takes the band's rows and
its `Band`: the value covers the band's rows, OBGCC's image gradients and
the SSIM family's Gaussians read one row of each neighbouring band. The
hand-written backwards give each of the band's rows its whole gradient,
the terms of the row above included, so no gradient crosses to another
slot; plain autograd sends the neighbours' rows theirs through
`rows_halo`. The SSIM family's min and max are the global batch's, taken
over every rank (parallel/distributed.py `all_reduce_max`), as the JAX
package takes them over its global batch array.

Group layout (NHWC): flow (B,H,W,2); flow_past (B,H,W,2) or None; occ
(B,H,W,2) with channel 0 = "visible or past occluded" (torch channel 1) and
channel 1 = "visible or future occluded" (torch channel 2); warped = tuple
of F-1 images (B,H,W,C) in frame order; target = reference frame (B,H,W,C).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..parallel.distributed import all_reduce_max
from .common import (coord_grid, diff_down, first_row, fwd_diff_x,
                     gauss3_rows, gaussian3_center_weight, in_image_mask, own_rows, rows_halo,
                     rows_of, unhalo_grad)
from .penalty import make_penalty

# occ channel used to weight a frame: past frames -> torch ch2 (ours 1),
# future frames -> torch ch1 (ours 0)  (OBCCriterion.lua:86-92)
_OCC_PAST, _OCC_FUTURE = 1, 0


@dataclasses.dataclass(frozen=True)
class PhotoConfig:
    frames: int = 3
    penalty: str = "Quadratic"
    size_average: bool = True
    past_flow: bool = False
    penalty_out: float = 1.0
    alpha: float = 1.0   # OBGCC brightness / SSIM mix weight
    beta: float = 1.0    # OBGCC x-gradient weight
    gamma: float = 1.0   # OBGCC y-gradient weight
    reference_grads: bool = True


def _frame_flow_k(cfg, f: int, flow, flow_past, scale):
    """Per-frame displacement field k*flow*scale for the out-of-image test
    (OBCCriterion.lua:79-89; MBCCriterion.lua:70-81 for F=2)."""
    ref = 0.5 * (cfg.frames - 1)
    if cfg.frames == 2:
        return flow * scale
    if f <= ref:
        fl = flow_past if (cfg.past_flow and flow_past is not None) else flow
        return (f - ref - 1) * fl * scale
    return (f - ref) * flow * scale


def _masks(cfg, flow, flow_past, scale, band):
    """Per-frame out-of-image masks (B,h,W) of the flow's rows, frame
    index 1..F-1; no gradient."""
    b, h, w = flow.shape[:3]
    with torch.no_grad():
        coord = coord_grid(b, h, w, flow.dtype, flow.device, 0 if band is None else band.y0)
        return {f: in_image_mask(coord + _frame_flow_k(cfg, f, flow, flow_past, scale),
                                 rows_of(flow, band), w)
                for f in range(1, cfg.frames)}


def _norms(cfg, target, band):
    b, _, w, c = target.shape
    inner = 1.0 / (c * (cfg.frames - 1))
    size_norm = (1.0 / (b * rows_of(target, band) * w)) if cfg.size_average else 1.0
    return inner, size_norm


def _occ_w(occ, f, ref):
    """Occlusion weight channel for warped frame f, or None when the model
    has no occlusion head (frames==2 / no_occ): the criterion then
    degrades to its unmasked (MBCC-style) behaviour."""
    if occ is None:
        return None
    return occ[..., _OCC_PAST if f <= ref else _OCC_FUTURE]


def _obcc_value(cfg, scale, band, flow, flow_past, occ, warped, target):
    p = make_penalty(cfg.penalty)
    ref = 0.5 * (cfg.frames - 1)
    inner, size_norm = _norms(cfg, target, band)
    masks = _masks(cfg, flow, flow_past, scale, band)
    acc = 0.0
    for f in range(1, cfg.frames):
        photo = p.apply(warped[f - 1] - target).sum(-1)
        ow = _occ_w(occ, f, ref)
        m = masks[f]
        masked = photo * m if ow is None else photo * ow * m
        acc = acc + masked + (1.0 - m) * cfg.penalty_out
    return acc.sum() * inner * size_norm


class _OBCCFn(torch.autograd.Function):
    """OBCC with the reference backward (photometric.py:137-163): gradients
    to occ (with the out-of-image constant) and to the warped frames only."""

    @staticmethod
    def forward(ctx, cfg, scale, band, flow, flow_past, occ, target, *warped):
        ctx.cfg, ctx.scale, ctx.band = cfg, scale, band
        ctx.save_for_backward(flow, flow_past, occ, target, *warped)
        return _obcc_value(cfg, scale, band, flow, flow_past, occ, warped, target)

    @staticmethod
    def backward(ctx, g):
        cfg, scale, band = ctx.cfg, ctx.scale, ctx.band
        flow, flow_past, occ, target, *warped = ctx.saved_tensors
        p = make_penalty(cfg.penalty)
        ref = 0.5 * (cfg.frames - 1)
        inner, size_norm = _norms(cfg, target, band)
        masks = _masks(cfg, flow, flow_past, scale, band)
        scale_all = g * inner * size_norm
        d_occ = None if occ is None else torch.zeros_like(occ)
        d_warped = []
        for f in range(1, cfg.frames):
            img = warped[f - 1]
            ch = _OCC_PAST if f <= ref else _OCC_FUTURE
            m = masks[f]
            if occ is not None:
                photo = p.apply(img - target).sum(-1)
                # occ grad includes the out-of-image penalty constant
                # (OBCCriterion.lua:180-190) — reference quirk
                d_occ[..., ch] += (photo * m + (1.0 - m) * cfg.penalty_out) * scale_all
            gi = p.der(img - target) * m[..., None]
            if occ is not None:
                gi = gi * occ[..., ch][..., None]
            d_warped.append(gi * scale_all)
        return (None, None, None, None, None, d_occ, None, *d_warped)


def make_obcc(cfg: PhotoConfig, scale: float):
    """OBCC at one level: fn(flow, flow_past, occ, warped, target, band=None)
    -> scalar."""

    def obcc(flow, flow_past, occ, warped, target, band=None):
        if cfg.reference_grads:
            return _OBCCFn.apply(cfg, scale, band, flow, flow_past, occ, target, *warped)
        return _obcc_value(cfg, scale, band, flow, flow_past, occ, warped, target)

    return obcc


def _obgcc_terms(cfg, warped_h, target_h):
    """Per-frame (diff, buffer_gx, buffer_gy) with the reference's
    cross-frame gradient-buffer accumulation (OBGCCriterion.lua:91-92),
    from `rows_halo` frames, on the rows from the one above the band to
    its last (row i + 1 is own row i)."""
    tgt = target_h[:, :-1]
    tgt_gx, tgt_gy = fwd_diff_x(tgt), diff_down(target_h)
    acc_gx = acc_gy = torch.zeros_like(tgt)
    out = []
    for f in range(1, cfg.frames):
        img_h = warped_h[f - 1]
        img = img_h[:, :-1]
        acc_gx = acc_gx + fwd_diff_x(img)
        acc_gy = acc_gy + diff_down(img_h)
        out.append((img - tgt, acc_gx - tgt_gx, acc_gy - tgt_gy))
    return out


def _obgcc_value(cfg, scale, band, flow, flow_past, occ, warped_h, target_h):
    p = make_penalty(cfg.penalty)
    ref = 0.5 * (cfg.frames - 1)
    inner, size_norm = _norms(cfg, own_rows(target_h), band)
    masks = _masks(cfg, flow, flow_past, scale, band)
    acc = 0.0
    for f, (diff, bgx, bgy) in enumerate(_obgcc_terms(cfg, warped_h, target_h), start=1):
        # no alpha on the brightness term in the reference forward
        # (OBGCCriterion.lua:96-105)
        tmp = (p.apply(diff).sum(-1) + cfg.beta * p.apply(bgx).sum(-1)
               + cfg.gamma * p.apply(bgy).sum(-1))[:, 1:]
        ow = _occ_w(occ, f, ref)
        m = masks[f]
        masked = tmp * m if ow is None else tmp * ow * m
        acc = acc + masked + (1.0 - m) * cfg.penalty_out
    return acc.sum() * inner * size_norm


def _transpose_diff(v, dx, dy, first):
    """v - dy - dx + dy of the row above + dx of the column to the left,
    on the own rows: the transpose of the forward differences
    (OBGCCriterion.lua:200-219). v, dx, dy cover the rows from the one
    above the band (`_obgcc_terms`), whose dy reaches the first own row
    unless it is the image's first."""
    above = dy[:, :-1]
    if first:
        above = torch.cat([torch.zeros_like(above[:, :1]), above[:, 1:]], dim=1)
    out = v[:, 1:] - dy[:, 1:] - dx[:, 1:] + above
    out[:, :, 1:] += dx[:, 1:, :-1]
    return out


class _OBGCCFn(torch.autograd.Function):
    """OBGCC with the reference backward (photometric.py:220-256):
    gradients to occ and to the warped frames only. The frames come as
    `rows_halo` tensors whose halo rows take no gradient."""

    @staticmethod
    def forward(ctx, cfg, scale, band, flow, flow_past, occ, target_h, *warped_h):
        ctx.cfg, ctx.scale, ctx.band = cfg, scale, band
        ctx.save_for_backward(flow, flow_past, occ, target_h, *warped_h)
        return _obgcc_value(cfg, scale, band, flow, flow_past, occ, warped_h, target_h)

    @staticmethod
    def backward(ctx, g):
        cfg, scale, band = ctx.cfg, ctx.scale, ctx.band
        flow, flow_past, occ, target_h, *warped_h = ctx.saved_tensors
        p = make_penalty(cfg.penalty)
        ref = 0.5 * (cfg.frames - 1)
        first = first_row(band)
        inner, size_norm = _norms(cfg, own_rows(target_h), band)
        masks = _masks(cfg, flow, flow_past, scale, band)
        scale_all = g * inner * size_norm
        d_occ = None if occ is None else torch.zeros_like(occ)
        d_warped = []
        for f, (diff, bgx, bgy) in enumerate(_obgcc_terms(cfg, warped_h, target_h), start=1):
            ch = _OCC_PAST if f <= ref else _OCC_FUTURE
            m = masks[f]
            # image gradient, alpha included (OBGCCriterion.lua:200-212)
            gi = _transpose_diff(cfg.alpha * p.der(diff), p.der(bgx) * cfg.beta,
                                 p.der(bgy) * cfg.gamma, first) * m[..., None]
            if occ is not None:
                gi = gi * occ[..., ch][..., None]
            d_warped.append(unhalo_grad(gi * scale_all))
            if occ is not None:
                # occlusion gradient with the transpose structure and the
                # out-of-image penalty (OBGCCriterion.lua:215-219,239-250)
                ob = _transpose_diff(cfg.alpha * p.apply(diff).sum(-1),
                                     p.apply(bgx).sum(-1) * cfg.beta,
                                     p.apply(bgy).sum(-1) * cfg.gamma, first)
                d_occ[..., ch] += (ob * m + (1.0 - m) * cfg.penalty_out) * scale_all
        return (None, None, None, None, None, d_occ, None, *d_warped)


def make_obgcc(cfg: PhotoConfig, scale: float):
    """OBGCC at one level: fn(flow, flow_past, occ, warped, target,
    band=None) -> scalar."""

    def obgcc(flow, flow_past, occ, warped, target, band=None):
        grad = not cfg.reference_grads
        target_h = rows_halo(target, band, grad)
        warped_h = [rows_halo(w, band, grad) for w in warped]
        if cfg.reference_grads:
            return _OBGCCFn.apply(cfg, scale, band, flow, flow_past, occ, target_h, *warped_h)
        return _obgcc_value(cfg, scale, band, flow, flow_past, occ, warped_h, target_h)

    return obgcc


# --------------------------------------------------------------------------
# MBCC — brightness constancy without occlusion masking
# (criterions/MBCCriterion.lua)
# --------------------------------------------------------------------------

def _mbcc_value(cfg, scale, band, flow, flow_past, warped, target):
    p = make_penalty(cfg.penalty)
    inner, size_norm = _norms(cfg, target, band)
    masks = _masks(cfg, flow, flow_past, scale, band)
    acc = 0.0
    for f in range(1, cfg.frames):
        acc = acc + p.apply(warped[f - 1] - target).sum(-1) * masks[f]
    return acc.sum() * inner * size_norm


class _MBCCFn(torch.autograd.Function):
    """MBCC with the reference backward (photometric.py:293-302): gradients
    to the warped frames only."""

    @staticmethod
    def forward(ctx, cfg, scale, band, flow, flow_past, target, *warped):
        ctx.cfg, ctx.scale, ctx.band = cfg, scale, band
        ctx.save_for_backward(flow, flow_past, target, *warped)
        return _mbcc_value(cfg, scale, band, flow, flow_past, warped, target)

    @staticmethod
    def backward(ctx, g):
        cfg, scale, band = ctx.cfg, ctx.scale, ctx.band
        flow, flow_past, target, *warped = ctx.saved_tensors
        p = make_penalty(cfg.penalty)
        inner, size_norm = _norms(cfg, target, band)
        masks = _masks(cfg, flow, flow_past, scale, band)
        d_warped = [p.der(warped[f - 1] - target) * masks[f][..., None] * g * inner * size_norm
                    for f in range(1, cfg.frames)]
        return (None, None, None, None, None, None, *d_warped)


@functools.lru_cache(maxsize=None)
def make_mbcc(cfg: PhotoConfig, scale: float):
    """MBCC at one level: fn(flow, flow_past, occ, warped, target,
    band=None) -> scalar; occ is not read."""

    def mbcc(flow, flow_past, occ, warped, target, band=None):
        if cfg.reference_grads:
            return _MBCCFn.apply(cfg, scale, band, flow, flow_past, target, *warped)
        return _mbcc_value(cfg, scale, band, flow, flow_past, warped, target)

    return mbcc


# --------------------------------------------------------------------------
# SSIM family (criterions/MSSIML1Criterion.lua, OSSIML1Criterion.lua)
# --------------------------------------------------------------------------

_C1 = 0.01 ** 2  # (0.01 L)^2 with L=1
_C2 = 0.03 ** 2


def _minmax(*arrays):
    """The min and max over every element of `arrays` on every rank, which
    together hold the global batch (module docstring): one collective for
    both; no gradient."""
    with torch.no_grad():
        mn = torch.stack([a.min() for a in arrays]).min()
        mx = torch.stack([a.max() for a in arrays]).max()
        neg_mn, mx = all_reduce_max(torch.stack([-mn, mx])).unbind()
    return -neg_mn, mx


def _ssim_terms(img_n_h, target_n_h, mu_y, sigma_y):
    """The SSIM maps of the own rows from normalised `rows_halo` frames."""
    mu_x = gauss3_rows(img_n_h)
    sigma_x = gauss3_rows(img_n_h * img_n_h) - mu_x * mu_x
    sigma_xy = gauss3_rows(img_n_h * target_n_h) - mu_x * mu_y
    ssim_l = (2 * mu_x * mu_y + _C1) / (mu_x * mu_x + mu_y * mu_y + _C1)
    ssim_cs = (2 * sigma_xy + _C2) / (sigma_x + sigma_y + _C2)
    return mu_x, sigma_x, ssim_l, ssim_cs


def _ssim_penalty(cfg):
    """SSIM variants default to L1 (their ctor, MSSIML1Criterion.lua:28),
    but model.lua:189-193 swaps in L1/Lorentzian when -pme_penalty names
    one; any other value (e.g. the 'Quadratic' default) keeps L1."""
    return make_penalty(cfg.penalty if cfg.penalty in ("L1", "Lorentzian") else "L1")


def _ssim_normalization(cfg, occlusion_aware, flow_past, occ, warped, target):
    """(min, max - min). MSSIM: min/max over target + every input after
    the future flow — the past flow (when past_flow), occ, and the warped
    frames (MSSIML1Criterion.lua:62-68); OSSIM: target + warped images
    only (OSSIML1Criterion.lua:61-67). The tensors are the own rows."""
    if occlusion_aware:
        mn, mx = _minmax(target, *warped)
    else:
        extra = ()
        if cfg.past_flow and flow_past is not None:
            extra += (flow_past,)
        if occ is not None and cfg.frames > 2:
            extra += (occ,)
        mn, mx = _minmax(target, *extra, *warped)
    return mn, mx - mn


def _ssim_target(target_h, mn, rng):
    """(target_n_h, mu_y, sigma_y) of the normalised target."""
    target_n_h = (target_h - mn) / rng
    mu_y = gauss3_rows(target_n_h)
    sigma_y = gauss3_rows(target_n_h * target_n_h) - mu_y * mu_y
    return target_n_h, mu_y, sigma_y


def _ssim_value(cfg, scale, occlusion_aware, band, norm, flow, flow_past, occ, warped_h,
                target_h):
    p = _ssim_penalty(cfg)
    ref = 0.5 * (cfg.frames - 1)
    target = own_rows(target_h)
    inner, size_norm = _norms(cfg, target, band)
    masks = _masks(cfg, flow, flow_past, scale, band)
    mn, rng = norm
    target_n_h, mu_y, sigma_y = _ssim_target(target_h, mn, rng)
    acc = 0.0
    for f in range(1, cfg.frames):
        img_n_h = (warped_h[f - 1] - mn) / rng
        _, _, ssim_l, ssim_cs = _ssim_terms(img_n_h, target_n_h, mu_y, sigma_y)
        tmp = (cfg.alpha * (1.0 - ssim_l * ssim_cs).sum(-1)
               + (1 - cfg.alpha) * p.apply(own_rows(img_n_h) - own_rows(target_n_h)).sum(-1))
        m = masks[f]
        if occlusion_aware:
            ow = _occ_w(occ, f, ref)
            tmp = (tmp * m if ow is None else tmp * ow * m) + (1.0 - m) * cfg.penalty_out
        else:
            tmp = tmp * m
        acc = acc + tmp
    return acc.sum() * inner * size_norm


class _SSIMFn(torch.autograd.Function):
    """MSSIM / OSSIM with the reference backward (photometric.py:394-431):
    the centre-weight approximation of the SSIM derivative, gradients to
    the warped frames and (OSSIM) to occ. The frames come as `rows_halo`
    tensors whose halo rows take no gradient; the min and max of the
    forward are kept."""

    @staticmethod
    def forward(ctx, cfg, scale, occlusion_aware, band, norm, flow, flow_past, occ, target_h,
                *warped_h):
        ctx.cfg, ctx.scale, ctx.occlusion_aware = cfg, scale, occlusion_aware
        ctx.band, ctx.norm = band, norm
        ctx.save_for_backward(flow, flow_past, occ, target_h, *warped_h)
        return _ssim_value(cfg, scale, occlusion_aware, band, norm, flow, flow_past, occ,
                           warped_h, target_h)

    @staticmethod
    def backward(ctx, g):
        cfg, scale, occlusion_aware = ctx.cfg, ctx.scale, ctx.occlusion_aware
        band, (mn, rng) = ctx.band, ctx.norm
        flow, flow_past, occ, target_h, *warped_h = ctx.saved_tensors
        p = _ssim_penalty(cfg)
        ref = 0.5 * (cfg.frames - 1)
        gw = gaussian3_center_weight()
        inner, size_norm = _norms(cfg, own_rows(target_h), band)
        masks = _masks(cfg, flow, flow_past, scale, band)
        target_n_h, mu_y, sigma_y = _ssim_target(target_h, mn, rng)
        target_n = own_rows(target_n_h)
        scale_all = g * inner * size_norm
        occ_grad = occlusion_aware and occ is not None
        d_occ = torch.zeros_like(occ) if occ_grad else None
        d_warped = []
        for f in range(1, cfg.frames):
            img_n_h = (warped_h[f - 1] - mn) / rng
            img_n = own_rows(img_n_h)
            mu_x, sigma_x, ssim_l, ssim_cs = _ssim_terms(img_n_h, target_n_h, mu_y, sigma_y)
            # centre-weight derivative approximation (MSSIML1Criterion.lua:216-224)
            d_l = 2 * gw * (mu_y - mu_x * ssim_l) / (mu_x * mu_x + mu_y * mu_y + _C1)
            d_cs = 2 * gw * ((target_n - mu_y) - ssim_cs * (img_n - mu_x)) \
                / (sigma_x + sigma_y + _C2)
            gi = (-cfg.alpha * (d_l * ssim_cs + ssim_l * d_cs)
                  + (1 - cfg.alpha) * p.der(img_n - target_n))
            m = masks[f]
            gi = gi * m[..., None]
            if occ_grad:
                ch = _OCC_PAST if f <= ref else _OCC_FUTURE
                per_pix = (cfg.alpha * (1.0 - ssim_l * ssim_cs).sum(-1)
                           + (1 - cfg.alpha) * p.apply(img_n - target_n).sum(-1))
                d_occ[..., ch] += (per_pix * m + (1.0 - m) * cfg.penalty_out) * scale_all
                gi = gi * occ[..., ch][..., None]
            d_warped.append(unhalo_grad(gi * scale_all))
        return (None, None, None, None, None, None, None, d_occ, None, *d_warped)


def _make_ssim(cfg: PhotoConfig, scale: float, occlusion_aware: bool):

    def crit(flow, flow_past, occ, warped, target, band=None):
        norm = _ssim_normalization(cfg, occlusion_aware, flow_past, occ, warped, target)
        grad = not cfg.reference_grads
        target_h = rows_halo(target, band, grad)
        warped_h = [rows_halo(w, band, grad) for w in warped]
        if cfg.reference_grads:
            return _SSIMFn.apply(cfg, scale, occlusion_aware, band, norm, flow, flow_past, occ,
                                 target_h, *warped_h)
        return _ssim_value(cfg, scale, occlusion_aware, band, norm, flow, flow_past, occ,
                           warped_h, target_h)

    return crit


@functools.lru_cache(maxsize=None)
def make_mssim_l1(cfg: PhotoConfig, scale: float):
    """MSSIM(L1) at one level: fn(flow, flow_past, occ, warped, target,
    band=None) -> scalar."""
    return _make_ssim(cfg, scale, occlusion_aware=False)


@functools.lru_cache(maxsize=None)
def make_ossim_l1(cfg: PhotoConfig, scale: float):
    """OSSIM(L1), the occlusion-aware variant, at one level."""
    return _make_ssim(cfg, scale, occlusion_aware=True)


# --------------------------------------------------------------------------
# Simple 2-frame variants (criterions/BCCriterion.lua, SSIMCriterion.lua)
# --------------------------------------------------------------------------

def bcc(input_img, target, penalty="Quadratic"):
    """Plain brightness constancy mean penalty (BCCriterion.lua:26-36).
    The reference backward references an undefined buffer (latent bug,
    BCCriterion.lua:48); this is the working analytic gradient."""
    p = make_penalty(penalty)
    return p.apply(input_img - target).sum() / input_img.numel()


def ssim(input_img, target, size_average=True):
    """2-frame SSIM criterion (SSIMCriterion.lua:40-77); autograd gradient."""
    mn, mx = _minmax(input_img, target)
    rng = mx - mn
    x = (input_img - mn) / rng
    y_h = rows_halo((target - mn) / rng, None)
    mu_y = gauss3_rows(y_h)
    sigma_y = gauss3_rows(y_h * y_h) - mu_y * mu_y
    _, _, ssim_l, ssim_cs = _ssim_terms(rows_halo(x, None), y_h, mu_y, sigma_y)
    val = (0.5 * (1.0 - ssim_l * ssim_cs)).sum()
    return val / x.numel() if size_average else val
