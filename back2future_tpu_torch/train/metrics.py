"""Evaluation metrics (counterpart of back2future_tpu/train/metrics.py:18-86;
train.lua:337-414, test.lua:183-262).

Full-resolution EPE (x flownet_factor), EPE split into occluded /
non-occluded regions, the KITTI Fl-all outlier rate, and occlusion
accuracy (overall + per state) and F1, with the reference's three
decodings by predicted-occ channel count. Every result is a 0-d tensor on
the inputs' device; nothing is read on the host. Ties decode as in JAX:
`torch.round` rounds half to even like `jnp.round`, and `argmax` takes
the first maximum in both.

Under data parallelism each metric is the global batch's: every ratio's
numerator and denominator are summed over the ranks first (one
all-reduce of the stacked sums), so ranks that hold different mask
counts weigh as the global batch does: over the world when the flow is
a row band (given its `Band`: the spatial group's ranks share its rows
out, each on its rows of the ground truth), else over the data group
(the world without a spatial axis; a spatial group's ranks then compute
their slot's metrics alike).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..losses.supervised import epe_map
from ..parallel.distributed import all_reduce_data, all_reduce_sum, data_count, process_count


def decode_occ(occ_pred: torch.Tensor) -> torch.Tensor:
    """Predicted occ map -> sharp 3-state {0, 0.5, 1} (train.lua:379-389)."""
    c = occ_pred.shape[-1]
    if c == 1:
        return torch.round(occ_pred[..., 0] * 2.0) / 2.0
    if c == 3:
        return torch.argmax(occ_pred, dim=-1).float() / 2.0
    # 2-channel softmax head: round((1 - occ1) + occ2) * 0.5
    return torch.round((1.0 - occ_pred[..., 0]) + occ_pred[..., 1]) * 0.5


def _masked_sums(values: torch.Tensor, mask: torch.Tensor):
    """(sum of values over the mask, the mask's sum): a masked mean's
    numerator and denominator."""
    return torch.sum(values * mask), torch.sum(mask)


def _safe_ratio(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), torch.zeros_like(n))


def _reduced(band) -> bool:
    """Whether the metrics' sums are reduced over ranks (module docstring)."""
    return (data_count() if band is None else process_count()) > 1


def _global_sums(sums: Dict[str, torch.Tensor], band) -> Dict[str, torch.Tensor]:
    """`sums` summed over the ranks that share the global batch out, in
    one all-reduce; as they are on one rank."""
    if not _reduced(band):
        return sums
    reduce = all_reduce_data if band is None else all_reduce_sum
    total = reduce(torch.stack([v.float() for v in sums.values()]))
    return dict(zip(sums, total.unbind()))


def _fl_all_outliers(epe_px: torch.Tensor, flow_gt_px: torch.Tensor) -> torch.Tensor:
    mag = torch.sqrt(torch.sum(flow_gt_px ** 2, dim=-1))
    return ((epe_px > 3.0) & (epe_px > 0.05 * mag)).to(epe_px.dtype)


def fl_all(epe_px: torch.Tensor, flow_gt_px: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """KITTI Fl-all outlier rate: EPE > 3 px AND > 5% of gt magnitude."""
    return _safe_ratio(*_masked_sums(_fl_all_outliers(epe_px, flow_gt_px), mask))


def _f1_counts(occ_pred_sharp: torch.Tensor, occ_label: torch.Tensor):
    pred = occ_pred_sharp != 0.5
    gt = occ_label != 0.5
    return (torch.sum((pred & gt).float()), torch.sum((pred & ~gt).float()),
            torch.sum((~pred & gt).float()))


def _f1(tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor) -> torch.Tensor:
    return 2 * tp / torch.clamp(2 * tp + fp + fn, min=1.0)


def occ_f1(occ_pred_sharp: torch.Tensor, occ_label: torch.Tensor) -> torch.Tensor:
    """F1 of occlusion detection: positive = not visible (label != 0.5)."""
    return _f1(*_f1_counts(occ_pred_sharp, occ_label))


def full_res_metrics(flow_pred: torch.Tensor, occ_pred: Optional[torch.Tensor], batch: Dict,
                     flownet_factor: float, size_average: bool,
                     band=None) -> Dict[str, torch.Tensor]:
    """Metrics on the finest-level outputs vs full-res ground truth.

    batch: 'flow_gt' (B,H,W,2) (already / flownet_factor), 'occ_gt'
    (B,H,W,2) with channel 0 = frames-occ label, channel 1 = 3-frame occ
    (train.lua:346,392), 'mask' (B,H,W), whole; with a `band`, the
    outputs are its rows. `size_average` is unused, as in the JAX
    package."""
    batch = {k: batch[k] if band is None else band.rows(batch[k])
             for k in ("flow_gt", "occ_gt", "mask")}
    mask = batch["mask"]
    m = epe_map(flow_pred, batch["flow_gt"], mask)
    m_px = m * flownet_factor
    # occ/non-occ split uses the 3-frame occlusion labels (train.lua:346-375)
    vis = (batch["occ_gt"][..., 1] == 0.5).to(m.dtype)
    occluded = 1.0 - vis
    sums = {"epe": torch.sum(m), "npix": torch.sum(mask)}
    sums["nocc"], sums["n_nocc"] = _masked_sums(m_px, vis * mask)
    sums["occ"], sums["n_occ"] = _masked_sums(m_px, occluded * mask)
    sums["fl"], sums["n_fl"] = _masked_sums(
        _fl_all_outliers(m_px, batch["flow_gt"] * flownet_factor), mask)
    if occ_pred is not None:
        sharp = decode_occ(occ_pred)
        lbl = batch["occ_gt"][..., 0]
        correct = (sharp == lbl).to(m.dtype)
        for key, state in (("bwd", 0.0), ("vis", 0.5), ("fwd", 1.0)):
            sums[key], sums[f"n_{key}"] = _masked_sums(correct, (lbl == state).to(m.dtype))
        sums["tp"], sums["fp"], sums["fn"] = _f1_counts(sharp, lbl)
        if _reduced(band):
            sums["correct"] = torch.sum(correct)
            sums["n_correct"] = torch.tensor(float(correct.numel()), device=correct.device)
    sums = _global_sums(sums, band)

    out = {"epe": sums["epe"] / torch.clamp(sums["npix"], min=1.0) * flownet_factor,
           "epe_nocc": _safe_ratio(sums["nocc"], sums["n_nocc"]),
           "epe_occ": _safe_ratio(sums["occ"], sums["n_occ"]),
           "fl_all": _safe_ratio(sums["fl"], sums["n_fl"])}
    if occ_pred is not None:
        out["occ_acc"] = (sums["correct"] / sums["n_correct"] if _reduced(band)
                          else torch.mean(correct))
        for key in ("bwd", "vis", "fwd"):
            out[f"occ_acc_{key}"] = _safe_ratio(sums[key], sums[f"n_{key}"])
        out["occ_f1"] = _f1(sums["tp"], sums["fp"], sums["fn"])
    return out
