"""NHWC tensor ops of the port (counterpart of back2future_tpu.ops).

The cost volume and the warp, forward and backward, and the fused
feature stem's forward are hand-written CUDA kernels on CUDA tensors and
plain torch twins on CPU tensors; `plain_ops()` routes CUDA tensors
through the twins, to compare the two on the card. `*_backward_cuda` and
`stem_unit_cuda` launch kernels alone.
"""

from .cost_volume import (
    cost_volume, cost_volume_backward_cuda, cost_volume_backward_cuda_cores,
    cost_volume_backward_reference, cost_volume_bwd_bf16_info, cost_volume_cuda_cores,
    cost_volume_fwd_bf16_info, cost_volume_gshift_reference,
    cost_volume_multi, cost_volume_reference, dref_form,
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
from .stem import (
    fused_stem, stem_eligible, stem_enabled, stem_reference, stem_unit_a_cuda_cores,
    stem_unit_cuda, unit_params, unit_reference,
)
from .warp import (
    warp_bilinear, warp_bilinear_backward_cuda, warp_bilinear_backward_reference,
    warp_bilinear_backward_thread, warp_bilinear_reference, warp_dimages_routes,
    warp_bwd_tiled_info,
)

__all__ = [
    "warp_bilinear",
    "warp_bilinear_reference",
    "warp_bilinear_backward_reference",
    "warp_bilinear_backward_cuda",
    "warp_bilinear_backward_thread",
    "warp_dimages_routes",
    "warp_bwd_tiled_info",
    "cost_volume",
    "cost_volume_multi",
    "cost_volume_reference",
    "cost_volume_backward_reference",
    "cost_volume_backward_cuda",
    "cost_volume_backward_cuda_cores",
    "cost_volume_gshift_reference",
    "dref_form",
    "cost_volume_bwd_bf16_info",
    "cost_volume_cuda_cores",
    "cost_volume_fwd_bf16_info",
    "avg_pool2",
    "subsample2",
    "upsample_nearest2x",
    "upsample_bilinear2x",
    "resize_bilinear",
    "resize_nearest",
    "spatial_softmax",
    "plain_ops",
    "fused_stem",
    "stem_eligible",
    "stem_enabled",
    "stem_reference",
    "stem_unit_a_cuda_cores",
    "stem_unit_cuda",
    "unit_params",
    "unit_reference",
]
