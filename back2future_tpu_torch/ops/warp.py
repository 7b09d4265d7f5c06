"""Bilinear warping with pixel-offset flow semantics (forward).

Counterpart of back2future_tpu/ops/warp.py; semantics of the reference's
modified CUDA sampler (extras/stnbhwd/BilinearSamplerBHWD.cu:6-20,41-115):
the flow value is a pixel-space offset added to the output pixel
coordinate, the source coordinate is clamped to the image border, and the
+1 corners that fall outside the image get weight exactly 0.

Unlike the JAX package, the coordinates and weights are computed in f32
whatever the image dtype, as the Torch7 reference did: in bf16 the pixel
grid itself rounds (spacing 2.0 from 256 to 512), which loses the
sub-pixel part of the flow at the wide pyramid levels. The flow is cast
to the image dtype first, as in the JAX package.

Layout: NHWC images (B, H, W, C); flow (B, H, W, 2) with channels (u, v)
= (x-offset, y-offset).

`warp_bilinear` runs the hand-written CUDA kernel (csrc/warp_fwd.cu) on
CUDA tensors and its plain twin `warp_bilinear_reference` on CPU tensors.
Forward only: the reference flow gradient (`reference_grads=True`) and
the image-gradient kernel come with the training slice, so a warp that
would need a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime.cuda_build import Kernel
from .route import DTYPE_CODES, check_kernel_input, ptr, stream_ptr, use_kernel

_KERNEL = Kernel("b2f_warp_bilinear_fwd",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def warp_bilinear_reference(images: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel: clamped f32 source coordinates,
    four corner gathers, f32 weighted sum, in the image dtype."""
    b, h, w, c = images.shape
    fl = flow.float()
    gy = torch.arange(h, dtype=torch.float32, device=flow.device).view(1, h, 1)
    gx = torch.arange(w, dtype=torch.float32, device=flow.device).view(1, 1, w)
    xc = torch.clamp(fl[..., 0] + gx, 0.0, w - 1.0)
    yc = torch.clamp(fl[..., 1] + gy, 0.0, h - 1.0)
    x0f, y0f = torch.floor(xc), torch.floor(yc)
    wx = (1.0 - (xc - x0f)).unsqueeze(-1)
    wy = (1.0 - (yc - y0f)).unsqueeze(-1)
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    bi = torch.arange(b, device=images.device).view(b, 1, 1)
    im = images.float()
    out = (wx * wy * im[bi, y0, x0] + (1 - wx) * wy * im[bi, y0, x1]
           + wx * (1 - wy) * im[bi, y1, x0] + (1 - wx) * (1 - wy) * im[bi, y1, x1])
    return out.to(images.dtype)


def warp_bilinear(images: torch.Tensor, flow: torch.Tensor, *,
                  reference_grads: bool = True) -> torch.Tensor:
    """Warp `images` by pixel-offset `flow` (NHWC; see module docstring).

    `reference_grads` selects the gradient the training slice will give
    (the reference's flow-gradient formula, or plain autodiff through the
    clamp); the forward is the same either way. With reference gradients
    not yet ported, an input that requires grad raises
    NotImplementedError; on the CPU with `reference_grads=False` the twin
    differentiates as plain autodiff."""
    if images.dim() != 4 or flow.dim() != 4 or flow.shape[-1] != 2 \
            or flow.shape[:3] != images.shape[:3]:
        raise ValueError(f"expected NHWC images and (B,H,W,2) flow of the "
                         f"same size, got {tuple(images.shape)} / "
                         f"{tuple(flow.shape)}")
    needs_grad = torch.is_grad_enabled() and (images.requires_grad
                                              or flow.requires_grad)
    if needs_grad and reference_grads:
        raise NotImplementedError(
            "warp_bilinear: the reference flow gradient lands with the "
            "training-step slice of the port")
    flow = flow.to(images.dtype)
    if not use_kernel(images):
        return warp_bilinear_reference(images, flow)
    if flow.device != images.device:
        raise ValueError(f"images on {images.device}, flow on {flow.device}")
    b, h, w, c = images.shape
    check_kernel_input("warp_bilinear images", images, images.shape, images.dtype)
    check_kernel_input("warp_bilinear flow", flow, (b, h, w, 2), images.dtype)
    out = torch.empty_like(images)
    if out.numel() == 0:
        return out
    with torch.cuda.device(images.device):
        _KERNEL(ptr(images), ptr(flow), ptr(out), DTYPE_CODES[images.dtype],
                b, h, w, c, stream_ptr(images.device))
    return out
