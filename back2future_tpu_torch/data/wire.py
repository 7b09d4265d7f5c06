"""Compact host->device wire format for training batches (counterpart of
back2future_tpu/data/wire.py).

`--wire compact` ships a batch in its information-carrying width: images
as uint8 (the sources are 8-bit PNGs; jittered floats are re-quantized to
the 8-bit grid), flow_gt and occ_gt as float16, mask as uint8. ImageNet
normalisation (donkey.lua:35-38) is deferred to the device. `--wire f32`
(the default) ships the host-normalised float batch unchanged.

`encode_batch` (wire.py:41-60) runs on the host, in the loader's workers.
`decode_batch` (wire.py:63-83) runs on the device, at the start of the
train step: a u8 image batch gets the deferred normalisation per
3-channel group (augment.color_normalize semantics) and the other compact
fields become f32; an f32-wire batch passes through untouched, so every
step can call it. torch is imported inside `decode_batch` only, so that
the loader's worker processes import this module without it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .augment import IMAGENET_MEAN, IMAGENET_STD

WIRE_FORMATS = ("f32", "compact")


def encode_batch(batch: Dict[str, np.ndarray], wire: str) -> Dict[str, np.ndarray]:
    """Host-side: pack an UNNORMALIZED float batch (images in [0,1]) into
    the compact wire dtypes. No-op for wire='f32' (whose images are
    already host-normalized)."""
    if wire == "f32":
        return batch
    if wire != "compact":
        raise ValueError(f"unknown wire format {wire!r} (use {WIRE_FORMATS})")
    out = dict(batch)
    out["images"] = np.clip(np.rint(batch["images"] * 255.0), 0, 255).astype(np.uint8)
    if "flow_gt" in batch:
        out["flow_gt"] = batch["flow_gt"].astype(np.float16)
    if "occ_gt" in batch:
        out["occ_gt"] = batch["occ_gt"].astype(np.float16)
    if "mask" in batch:
        out["mask"] = np.rint(batch["mask"]).astype(np.uint8)
    return out


def decode_batch(batch):
    """Device-side: undo `encode_batch` on a dict of tensors."""
    import torch

    images = batch["images"]
    if images.dtype != torch.uint8:
        return batch
    nf = images.shape[-1] // 3
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).reshape(-1).repeat(nf)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32).reshape(-1).repeat(nf)
    out = dict(batch)
    out["images"] = (images.float() / 255.0 - mean.to(images.device)) / std.to(images.device)
    for k in ("flow_gt", "occ_gt", "mask"):
        if k in batch:
            out[k] = batch[k].float()
    return out
