"""Evaluation metrics (counterpart of back2future_tpu/train/metrics.py:18-86;
train.lua:337-414, test.lua:183-262).

Full-resolution EPE (x flownet_factor), EPE split into occluded /
non-occluded regions, the KITTI Fl-all outlier rate, and occlusion
accuracy (overall + per state) and F1, with the reference's three
decodings by predicted-occ channel count. Every result is a 0-d tensor on
the inputs' device; nothing is read on the host. Ties decode as in JAX:
`torch.round` rounds half to even like `jnp.round`, and `argmax` takes
the first maximum in both.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..losses.supervised import epe_map


def decode_occ(occ_pred: torch.Tensor) -> torch.Tensor:
    """Predicted occ map -> sharp 3-state {0, 0.5, 1} (train.lua:379-389)."""
    c = occ_pred.shape[-1]
    if c == 1:
        return torch.round(occ_pred[..., 0] * 2.0) / 2.0
    if c == 3:
        return torch.argmax(occ_pred, dim=-1).float() / 2.0
    # 2-channel softmax head: round((1 - occ1) + occ2) * 0.5
    return torch.round((1.0 - occ_pred[..., 0]) + occ_pred[..., 1]) * 0.5


def _safe_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = torch.sum(mask)
    return torch.where(n > 0, torch.sum(values * mask) / torch.clamp(n, min=1.0),
                       torch.zeros_like(n))


def fl_all(epe_px: torch.Tensor, flow_gt_px: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """KITTI Fl-all outlier rate: EPE > 3 px AND > 5% of gt magnitude."""
    mag = torch.sqrt(torch.sum(flow_gt_px ** 2, dim=-1))
    outlier = ((epe_px > 3.0) & (epe_px > 0.05 * mag)).to(epe_px.dtype)
    return _safe_mean(outlier, mask)


def occ_f1(occ_pred_sharp: torch.Tensor, occ_label: torch.Tensor) -> torch.Tensor:
    """F1 of occlusion detection: positive = not visible (label != 0.5)."""
    pred = occ_pred_sharp != 0.5
    gt = occ_label != 0.5
    tp = torch.sum((pred & gt).float())
    fp = torch.sum((pred & ~gt).float())
    fn = torch.sum((~pred & gt).float())
    return 2 * tp / torch.clamp(2 * tp + fp + fn, min=1.0)


def full_res_metrics(flow_pred: torch.Tensor, occ_pred: Optional[torch.Tensor], batch: Dict,
                     flownet_factor: float, size_average: bool) -> Dict[str, torch.Tensor]:
    """Metrics on the finest-level outputs vs full-res ground truth.

    batch: 'flow_gt' (B,H,W,2) (already / flownet_factor), 'occ_gt'
    (B,H,W,2) with channel 0 = frames-occ label, channel 1 = 3-frame occ
    (train.lua:346,392), 'mask' (B,H,W). `size_average` is unused, as in
    the JAX package."""
    mask = batch["mask"]
    m = epe_map(flow_pred, batch["flow_gt"], mask)
    npix = torch.sum(mask)
    epe = torch.sum(m) / torch.clamp(npix, min=1.0) * flownet_factor

    # occ/non-occ split uses the 3-frame occlusion labels (train.lua:346-375)
    lbl3 = batch["occ_gt"][..., 1]
    vis = (lbl3 == 0.5).to(m.dtype)
    occluded = 1.0 - vis
    epe_nocc = _safe_mean(m * flownet_factor, vis * mask)
    epe_occ = _safe_mean(m * flownet_factor, occluded * mask)

    out = {"epe": epe, "epe_nocc": epe_nocc, "epe_occ": epe_occ,
           "fl_all": fl_all(m * flownet_factor, batch["flow_gt"] * flownet_factor, mask)}

    if occ_pred is not None:
        sharp = decode_occ(occ_pred)
        lbl = batch["occ_gt"][..., 0]
        correct = (sharp == lbl).to(m.dtype)
        out["occ_acc"] = torch.mean(correct)
        out["occ_acc_bwd"] = _safe_mean(correct, (lbl == 0.0).to(m.dtype))
        out["occ_acc_vis"] = _safe_mean(correct, (lbl == 0.5).to(m.dtype))
        out["occ_acc_fwd"] = _safe_mean(correct, (lbl == 1.0).to(m.dtype))
        out["occ_f1"] = occ_f1(sharp, lbl)
    return out
