"""NHWC tensor ops of the port (counterpart of back2future_tpu.ops).

The cost volume and the warp, forward and backward, are hand-written
CUDA kernels on CUDA tensors and plain torch twins on CPU tensors;
`plain_ops()` routes CUDA tensors through the twins, to compare the two
on the card. `*_backward_cuda` launch the backward kernels alone.
"""

from .cost_volume import (
    cost_volume, cost_volume_backward_cuda, cost_volume_backward_reference, cost_volume_multi,
    cost_volume_reference,
)
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
from .warp import (
    warp_bilinear, warp_bilinear_backward_cuda, warp_bilinear_backward_reference,
    warp_bilinear_reference,
)

__all__ = [
    "warp_bilinear",
    "warp_bilinear_reference",
    "warp_bilinear_backward_reference",
    "warp_bilinear_backward_cuda",
    "cost_volume",
    "cost_volume_multi",
    "cost_volume_reference",
    "cost_volume_backward_reference",
    "cost_volume_backward_cuda",
    "avg_pool2",
    "subsample2",
    "upsample_nearest2x",
    "upsample_bilinear2x",
    "resize_bilinear",
    "resize_nearest",
    "spatial_softmax",
    "plain_ops",
]
