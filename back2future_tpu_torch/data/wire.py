"""Device-side decode of the compact wire format (counterpart of
back2future_tpu/data/wire.py:63-83; the host-side `encode_batch` is not
ported yet).

A u8 image batch gets the deferred ImageNet normalisation per 3-channel
group on the device (augment.color_normalize semantics,
donkey.lua:35-38); the other compact fields become f32. An f32-wire batch
passes through untouched, so every step can call `decode_batch`.
"""

from __future__ import annotations

from typing import Dict

import torch

from .augment import IMAGENET_MEAN, IMAGENET_STD


def decode_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
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
