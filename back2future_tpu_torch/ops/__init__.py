"""NHWC tensor ops of the port (counterpart of back2future_tpu.ops).

The cost volume and the warp are hand-written CUDA kernels on CUDA
tensors and plain torch twins on CPU tensors; `plain_ops()` routes CUDA
tensors through the twins, to compare the two on the card.
"""

from .cost_volume import cost_volume, cost_volume_multi, cost_volume_reference
from .pyramid import (
    avg_pool2,
    resize_bilinear,
    resize_nearest,
    spatial_softmax,
    subsample2,
    upsample_bilinear2x,
    upsample_nearest2x,
)
from .route import plain_ops
from .warp import warp_bilinear, warp_bilinear_reference

__all__ = [
    "warp_bilinear",
    "warp_bilinear_reference",
    "cost_volume",
    "cost_volume_multi",
    "cost_volume_reference",
    "avg_pool2",
    "subsample2",
    "upsample_nearest2x",
    "upsample_bilinear2x",
    "resize_bilinear",
    "resize_nearest",
    "spatial_softmax",
    "plain_ops",
]
