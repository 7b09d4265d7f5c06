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

Group layout (NHWC): flow (B,H,W,2); flow_past (B,H,W,2) or None; occ
(B,H,W,2) with channel 0 = "visible or past occluded" (torch channel 1) and
channel 1 = "visible or future occluded" (torch channel 2); warped = tuple
of F-1 images (B,H,W,C) in frame order; target = reference frame (B,H,W,C).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .common import (coord_grid, depthwise_gauss3, fwd_diff_x, fwd_diff_y,
                     gaussian3_center_weight, in_image_mask)
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


def _masks(cfg, flow, flow_past, scale, h, w):
    """Per-frame out-of-image masks (B,H,W), frame index 1..F-1; no gradient."""
    with torch.no_grad():
        coord = coord_grid(flow.shape[0], h, w, flow.dtype, flow.device)
        return {f: in_image_mask(coord + _frame_flow_k(cfg, f, flow, flow_past, scale), h, w)
                for f in range(1, cfg.frames)}


def _norms(cfg, target):
    b, h, w, c = target.shape
    inner = 1.0 / (c * (cfg.frames - 1))
    size_norm = (1.0 / (b * h * w)) if cfg.size_average else 1.0
    return inner, size_norm


def _occ_w(occ, f, ref):
    """Occlusion weight channel for warped frame f, or None when the model
    has no occlusion head (frames==2 / no_occ): the criterion then
    degrades to its unmasked (MBCC-style) behaviour."""
    if occ is None:
        return None
    return occ[..., _OCC_PAST if f <= ref else _OCC_FUTURE]


def _obcc_value(cfg, scale, flow, flow_past, occ, warped, target):
    p = make_penalty(cfg.penalty)
    ref = 0.5 * (cfg.frames - 1)
    b, h, w, c = target.shape
    inner, size_norm = _norms(cfg, target)
    masks = _masks(cfg, flow, flow_past, scale, h, w)
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
    def forward(ctx, cfg, scale, flow, flow_past, occ, target, *warped):
        ctx.cfg, ctx.scale = cfg, scale
        ctx.save_for_backward(flow, flow_past, occ, target, *warped)
        return _obcc_value(cfg, scale, flow, flow_past, occ, warped, target)

    @staticmethod
    def backward(ctx, g):
        cfg, scale = ctx.cfg, ctx.scale
        flow, flow_past, occ, target, *warped = ctx.saved_tensors
        p = make_penalty(cfg.penalty)
        ref = 0.5 * (cfg.frames - 1)
        b, h, w, c = target.shape
        inner, size_norm = _norms(cfg, target)
        masks = _masks(cfg, flow, flow_past, scale, h, w)
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
        return (None, None, None, None, d_occ, None, *d_warped)


def make_obcc(cfg: PhotoConfig, scale: float):
    """OBCC at one level: fn(flow, flow_past, occ, warped, target) -> scalar."""

    def obcc(flow, flow_past, occ, warped, target):
        if cfg.reference_grads:
            return _OBCCFn.apply(cfg, scale, flow, flow_past, occ, target, *warped)
        return _obcc_value(cfg, scale, flow, flow_past, occ, warped, target)

    return obcc


def _obgcc_terms(cfg, warped, target):
    """Per-frame (diff, buffer_gx, buffer_gy) with the reference's
    cross-frame gradient-buffer accumulation (OBGCCriterion.lua:91-92)."""
    tgt_gx, tgt_gy = fwd_diff_x(target), fwd_diff_y(target)
    acc_gx = acc_gy = torch.zeros_like(target)
    out = []
    for f in range(1, cfg.frames):
        img = warped[f - 1]
        acc_gx = acc_gx + fwd_diff_x(img)
        acc_gy = acc_gy + fwd_diff_y(img)
        out.append((img - target, acc_gx - tgt_gx, acc_gy - tgt_gy))
    return out


def _obgcc_value(cfg, scale, flow, flow_past, occ, warped, target):
    p = make_penalty(cfg.penalty)
    ref = 0.5 * (cfg.frames - 1)
    b, h, w, c = target.shape
    inner, size_norm = _norms(cfg, target)
    masks = _masks(cfg, flow, flow_past, scale, h, w)
    acc = 0.0
    for f, (diff, bgx, bgy) in enumerate(_obgcc_terms(cfg, warped, target), start=1):
        # no alpha on the brightness term in the reference forward
        # (OBGCCriterion.lua:96-105)
        tmp = (p.apply(diff).sum(-1) + cfg.beta * p.apply(bgx).sum(-1)
               + cfg.gamma * p.apply(bgy).sum(-1))
        ow = _occ_w(occ, f, ref)
        m = masks[f]
        masked = tmp * m if ow is None else tmp * ow * m
        acc = acc + masked + (1.0 - m) * cfg.penalty_out
    return acc.sum() * inner * size_norm


def _transpose_diff(v, dx, dy):
    """v - dy - dx + dy shifted one row down + dx shifted one column right:
    the transpose of the forward differences (OBGCCriterion.lua:200-219)."""
    out = v - dy - dx
    out[:, 1:] += dy[:, :-1]
    out[:, :, 1:] += dx[:, :, :-1]
    return out


class _OBGCCFn(torch.autograd.Function):
    """OBGCC with the reference backward (photometric.py:220-256):
    gradients to occ and to the warped frames only."""

    @staticmethod
    def forward(ctx, cfg, scale, flow, flow_past, occ, target, *warped):
        ctx.cfg, ctx.scale = cfg, scale
        ctx.save_for_backward(flow, flow_past, occ, target, *warped)
        return _obgcc_value(cfg, scale, flow, flow_past, occ, warped, target)

    @staticmethod
    def backward(ctx, g):
        cfg, scale = ctx.cfg, ctx.scale
        flow, flow_past, occ, target, *warped = ctx.saved_tensors
        p = make_penalty(cfg.penalty)
        ref = 0.5 * (cfg.frames - 1)
        b, h, w, c = target.shape
        inner, size_norm = _norms(cfg, target)
        masks = _masks(cfg, flow, flow_past, scale, h, w)
        scale_all = g * inner * size_norm
        d_occ = None if occ is None else torch.zeros_like(occ)
        d_warped = []
        for f, (diff, bgx, bgy) in enumerate(_obgcc_terms(cfg, warped, target), start=1):
            ch = _OCC_PAST if f <= ref else _OCC_FUTURE
            m = masks[f]
            # image gradient, alpha included (OBGCCriterion.lua:200-212)
            gi = _transpose_diff(cfg.alpha * p.der(diff), p.der(bgx) * cfg.beta,
                                 p.der(bgy) * cfg.gamma) * m[..., None]
            if occ is not None:
                gi = gi * occ[..., ch][..., None]
            d_warped.append(gi * scale_all)
            if occ is not None:
                # occlusion gradient with the transpose structure and the
                # out-of-image penalty (OBGCCriterion.lua:215-219,239-250)
                ob = _transpose_diff(cfg.alpha * p.apply(diff).sum(-1),
                                     p.apply(bgx).sum(-1) * cfg.beta,
                                     p.apply(bgy).sum(-1) * cfg.gamma)
                d_occ[..., ch] += (ob * m + (1.0 - m) * cfg.penalty_out) * scale_all
        return (None, None, None, None, d_occ, None, *d_warped)


def make_obgcc(cfg: PhotoConfig, scale: float):
    """OBGCC at one level: fn(flow, flow_past, occ, warped, target) -> scalar."""

    def obgcc(flow, flow_past, occ, warped, target):
        if cfg.reference_grads:
            return _OBGCCFn.apply(cfg, scale, flow, flow_past, occ, target, *warped)
        return _obgcc_value(cfg, scale, flow, flow_past, occ, warped, target)

    return obgcc


# --------------------------------------------------------------------------
# MBCC — brightness constancy without occlusion masking
# (criterions/MBCCriterion.lua)
# --------------------------------------------------------------------------

def _mbcc_value(cfg, scale, flow, flow_past, warped, target):
    p = make_penalty(cfg.penalty)
    h, w = target.shape[1], target.shape[2]
    inner, size_norm = _norms(cfg, target)
    masks = _masks(cfg, flow, flow_past, scale, h, w)
    acc = 0.0
    for f in range(1, cfg.frames):
        acc = acc + p.apply(warped[f - 1] - target).sum(-1) * masks[f]
    return acc.sum() * inner * size_norm


class _MBCCFn(torch.autograd.Function):
    """MBCC with the reference backward (photometric.py:293-302): gradients
    to the warped frames only."""

    @staticmethod
    def forward(ctx, cfg, scale, flow, flow_past, target, *warped):
        ctx.cfg, ctx.scale = cfg, scale
        ctx.save_for_backward(flow, flow_past, target, *warped)
        return _mbcc_value(cfg, scale, flow, flow_past, warped, target)

    @staticmethod
    def backward(ctx, g):
        cfg, scale = ctx.cfg, ctx.scale
        flow, flow_past, target, *warped = ctx.saved_tensors
        p = make_penalty(cfg.penalty)
        h, w = target.shape[1], target.shape[2]
        inner, size_norm = _norms(cfg, target)
        masks = _masks(cfg, flow, flow_past, scale, h, w)
        d_warped = [p.der(warped[f - 1] - target) * masks[f][..., None] * g * inner * size_norm
                    for f in range(1, cfg.frames)]
        return (None, None, None, None, None, *d_warped)


@functools.lru_cache(maxsize=None)
def make_mbcc(cfg: PhotoConfig, scale: float):
    """MBCC at one level: fn(flow, flow_past, occ, warped, target) -> scalar;
    occ is not read."""

    def mbcc(flow, flow_past, occ, warped, target):
        if cfg.reference_grads:
            return _MBCCFn.apply(cfg, scale, flow, flow_past, target, *warped)
        return _mbcc_value(cfg, scale, flow, flow_past, warped, target)

    return mbcc


# --------------------------------------------------------------------------
# SSIM family (criterions/MSSIML1Criterion.lua, OSSIML1Criterion.lua)
# --------------------------------------------------------------------------

_C1 = 0.01 ** 2  # (0.01 L)^2 with L=1
_C2 = 0.03 ** 2


def _minmax(*arrays):
    """The min and max over every element of `arrays`; no gradient."""
    with torch.no_grad():
        mn = torch.stack([a.min() for a in arrays]).min()
        mx = torch.stack([a.max() for a in arrays]).max()
    return mn, mx


def _ssim_terms(img_n, target_n, mu_y, sigma_y):
    mu_x = depthwise_gauss3(img_n)
    sigma_x = depthwise_gauss3(img_n * img_n) - mu_x * mu_x
    sigma_xy = depthwise_gauss3(img_n * target_n) - mu_x * mu_y
    ssim_l = (2 * mu_x * mu_y + _C1) / (mu_x * mu_x + mu_y * mu_y + _C1)
    ssim_cs = (2 * sigma_xy + _C2) / (sigma_x + sigma_y + _C2)
    return mu_x, sigma_x, ssim_l, ssim_cs


def _ssim_penalty(cfg):
    """SSIM variants default to L1 (their ctor, MSSIML1Criterion.lua:28),
    but model.lua:189-193 swaps in L1/Lorentzian when -pme_penalty names
    one; any other value (e.g. the 'Quadratic' default) keeps L1."""
    return make_penalty(cfg.penalty if cfg.penalty in ("L1", "Lorentzian") else "L1")


def _ssim_normalization(cfg, occlusion_aware, flow_past, occ, warped, target):
    """MSSIM: min/max over target + every input after the future flow —
    the past flow (when past_flow), occ, and the warped frames
    (MSSIML1Criterion.lua:62-68); OSSIM: target + warped images only
    (OSSIML1Criterion.lua:61-67)."""
    if occlusion_aware:
        return _minmax(target, *warped)
    extra = ()
    if cfg.past_flow and flow_past is not None:
        extra += (flow_past,)
    if occ is not None and cfg.frames > 2:
        extra += (occ,)
    return _minmax(target, *extra, *warped)


def _ssim_setup(cfg, occlusion_aware, flow_past, occ, warped, target):
    """(mn, rng, target_n, mu_y, sigma_y) of the normalised target."""
    mn, mx = _ssim_normalization(cfg, occlusion_aware, flow_past, occ, warped, target)
    rng = mx - mn
    target_n = (target - mn) / rng
    mu_y = depthwise_gauss3(target_n)
    sigma_y = depthwise_gauss3(target_n * target_n) - mu_y * mu_y
    return mn, rng, target_n, mu_y, sigma_y


def _ssim_value(cfg, scale, occlusion_aware, flow, flow_past, occ, warped, target):
    p = _ssim_penalty(cfg)
    ref = 0.5 * (cfg.frames - 1)
    h, w = target.shape[1], target.shape[2]
    inner, size_norm = _norms(cfg, target)
    masks = _masks(cfg, flow, flow_past, scale, h, w)
    mn, rng, target_n, mu_y, sigma_y = _ssim_setup(cfg, occlusion_aware, flow_past, occ,
                                                   warped, target)
    acc = 0.0
    for f in range(1, cfg.frames):
        img_n = (warped[f - 1] - mn) / rng
        _, _, ssim_l, ssim_cs = _ssim_terms(img_n, target_n, mu_y, sigma_y)
        tmp = (cfg.alpha * (1.0 - ssim_l * ssim_cs).sum(-1)
               + (1 - cfg.alpha) * p.apply(img_n - target_n).sum(-1))
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
    the warped frames and (OSSIM) to occ."""

    @staticmethod
    def forward(ctx, cfg, scale, occlusion_aware, flow, flow_past, occ, target, *warped):
        ctx.cfg, ctx.scale, ctx.occlusion_aware = cfg, scale, occlusion_aware
        ctx.save_for_backward(flow, flow_past, occ, target, *warped)
        return _ssim_value(cfg, scale, occlusion_aware, flow, flow_past, occ, warped, target)

    @staticmethod
    def backward(ctx, g):
        cfg, scale, occlusion_aware = ctx.cfg, ctx.scale, ctx.occlusion_aware
        flow, flow_past, occ, target, *warped = ctx.saved_tensors
        p = _ssim_penalty(cfg)
        ref = 0.5 * (cfg.frames - 1)
        gw = gaussian3_center_weight()
        h, w = target.shape[1], target.shape[2]
        inner, size_norm = _norms(cfg, target)
        masks = _masks(cfg, flow, flow_past, scale, h, w)
        mn, rng, target_n, mu_y, sigma_y = _ssim_setup(cfg, occlusion_aware, flow_past, occ,
                                                       warped, target)
        scale_all = g * inner * size_norm
        occ_grad = occlusion_aware and occ is not None
        d_occ = torch.zeros_like(occ) if occ_grad else None
        d_warped = []
        for f in range(1, cfg.frames):
            img_n = (warped[f - 1] - mn) / rng
            mu_x, sigma_x, ssim_l, ssim_cs = _ssim_terms(img_n, target_n, mu_y, sigma_y)
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
            d_warped.append(gi * scale_all)
        return (None, None, None, None, None, d_occ, None, *d_warped)


def _make_ssim(cfg: PhotoConfig, scale: float, occlusion_aware: bool):

    def crit(flow, flow_past, occ, warped, target):
        if cfg.reference_grads:
            return _SSIMFn.apply(cfg, scale, occlusion_aware, flow, flow_past, occ, target,
                                 *warped)
        return _ssim_value(cfg, scale, occlusion_aware, flow, flow_past, occ, warped, target)

    return crit


@functools.lru_cache(maxsize=None)
def make_mssim_l1(cfg: PhotoConfig, scale: float):
    """MSSIM(L1) at one level: fn(flow, flow_past, occ, warped, target) -> scalar."""
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
    y = (target - mn) / rng
    mu_y = depthwise_gauss3(y)
    sigma_y = depthwise_gauss3(y * y) - mu_y * mu_y
    _, _, ssim_l, ssim_cs = _ssim_terms(x, y, mu_y, sigma_y)
    val = (0.5 * (1.0 - ssim_l * ssim_cs)).sum()
    return val / x.numel() if size_average else val
