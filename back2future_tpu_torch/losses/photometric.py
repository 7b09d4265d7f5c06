"""Photometric criterions (counterpart of back2future_tpu/losses/photometric.py).

OBCC, occlusion-aware brightness constancy (criterions/OBCCriterion.lua),
the criterion of the hard recipe, and OBGCC, brightness + gradient
constancy (criterions/OBGCCriterion.lua), the criterion of the soft
fine-tune recipe. Under `reference_grads=True` each is an autograd
Function with the reference's hand-written backward, which deviates from
the true gradient (photometric.py:129-165, 212-256):

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
    215-219).

With `reference_grads=False` each is plain autograd of the same value. The
other criteria of the family (BCC/MBCC, the SSIM variants) are not ported
yet (ROADMAP.md queue 1 item 8).

Group layout (NHWC): flow (B,H,W,2); flow_past (B,H,W,2) or None; occ
(B,H,W,2) with channel 0 = "visible or past occluded" (torch channel 1) and
channel 1 = "visible or future occluded" (torch channel 2); warped = tuple
of F-1 images (B,H,W,C) in frame order; target = reference frame (B,H,W,C).
"""

from __future__ import annotations

import dataclasses

import torch

from .common import coord_grid, fwd_diff_x, fwd_diff_y, in_image_mask
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
