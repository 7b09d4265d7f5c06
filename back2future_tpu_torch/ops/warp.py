"""Bilinear warping with pixel-offset flow semantics, and its gradients.

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

The gradient (`warp.py:190-246`): the image gradient is the exact
transpose of the gather; the flow gradient is, with
`reference_grads=True`, the reference's bilinear finite-difference
formula at the *clamped* coordinate, not zeroed where it clamps
(BilinearSamplerBHWD.cu:287-295), and with `reference_grads=False` the
autodiff gradient of `_warp_autodiff`: the same formula zeroed where the
coordinate clamps (the two differ from JAX only at exact clamp ties).

Layout: NHWC images (B, H, W, C); flow (B, H, W, 2) with channels (u, v)
= (x-offset, y-offset).

`warp_bilinear` is an autograd Function. On CUDA tensors its forward is
the hand-written gather of csrc/warp_fwd_tiled.cu (lane groups that read
and write whole pixel rows in 16-byte packs, or at C = 3 a thread per
pixel that reads each corner pair as one span; both walk the pixels
over a persistent grid) and its backward the kernels of
csrc/warp_bwd_tiled.cu: the image gradient K4 (tiles whose adds are
summed per window pixel in shared memory, or added directly, by block
where the launch's grid holds 1.5 blocks an SM or more, else added
directly; launched only when the images need a gradient) and the flow gradient
W-dflow (a thread per pixel at C = 3, lane groups otherwise); on CPU
tensors the plain twins `warp_bilinear_reference` and
`warp_bilinear_backward_reference` run instead.
`warp_bilinear_fwd_thread` and `warp_bilinear_backward_thread` keep the
first design's kernels (csrc/warp_fwd.cu, csrc/warp_bwd.cu) callable for
comparison on the card, `warp_fwd_tiled_info` and `warp_bwd_tiled_info`
report what the build made of the new ones, and
`warp_dimages_routes` runs K4 with its routes chosen by the caller and a
count of its window-route blocks.
"""

from __future__ import annotations

import ctypes

from typing import Optional, Tuple

import torch

from ..runtime.cuda_build import Kernel, query
from .route import DTYPE_CODES, check_kernel_input, ptr, stream_ptr, use_kernel

_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_FWD = Kernel("b2f_warp_bilinear_fwd", _FWD_ARGS)   # (img, flow, out, dtype, B, H, W, C, stream)
# the first design's gather: for comparison only, nothing on any path
_FWD_THREAD = Kernel("b2f_warp_bilinear_fwd_thread", _FWD_ARGS)
_DIMAGES_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DIMAGES = Kernel("b2f_warp_bilinear_dimages",   # (flow, g, d_img f32, dtype, B, H, W, C, stream)
                  _DIMAGES_ARGS)
# K4 with (route, route counts) before the stream; and the first design's
# K4: for comparison only, nothing on any path
_DIMAGES_ROUTES = Kernel("b2f_warp_bilinear_dimages_routes",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
_DIMAGES_THREAD = Kernel("b2f_warp_bilinear_dimages_thread", _DIMAGES_ARGS)
# (img, flow, g, d_flow, dtype, B, H, W, C, reference_grads, stream)
_DFLOW_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DFLOW = Kernel("b2f_warp_bilinear_dflow", _DFLOW_ARGS)
# the first design's W-dflow: for comparison only, nothing on any path
_DFLOW_THREAD = Kernel("b2f_warp_bilinear_dflow_thread", _DFLOW_ARGS)


def _corners(flow: torch.Tensor, h: int, w: int):
    """f32 source coordinates of every output pixel: the corner indices
    (+1 corners clamped into the image), the left-column / top-row
    weights (B, H, W), and the masks of +1 corners inside the image and
    of clamped coordinates."""
    fl = flow.float()
    gy = torch.arange(h, dtype=torch.float32, device=flow.device).view(1, h, 1)
    gx = torch.arange(w, dtype=torch.float32, device=flow.device).view(1, 1, w)
    xs, ys = fl[..., 0] + gx, fl[..., 1] + gy
    xc, yc = torch.clamp(xs, 0.0, w - 1.0), torch.clamp(ys, 0.0, h - 1.0)
    x0f, y0f = torch.floor(xc), torch.floor(yc)
    wx, wy = 1.0 - (xc - x0f), 1.0 - (yc - y0f)
    x0, y0 = x0f.long(), y0f.long()
    x1_in, y1_in = x0 + 1 <= w - 1, y0 + 1 <= h - 1
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    clamped = ((xs < 0) | (xs > w - 1), (ys < 0) | (ys > h - 1))
    return (x0, y0, x1, y1), (wx, wy), (x1_in, y1_in), clamped


def warp_bilinear_reference(images: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel: clamped f32 source coordinates,
    four corner gathers, f32 weighted sum, in the image dtype."""
    b, h, w, c = images.shape
    (x0, y0, x1, y1), (wx, wy), _, _ = _corners(flow, h, w)
    wx, wy = wx.unsqueeze(-1), wy.unsqueeze(-1)
    bi = torch.arange(b, device=images.device).view(b, 1, 1)
    im = images.float()
    out = (wx * wy * im[bi, y0, x0] + (1 - wx) * wy * im[bi, y0, x1]
           + wx * (1 - wy) * im[bi, y1, x0] + (1 - wx) * (1 - wy) * im[bi, y1, x1])
    return out.to(images.dtype)


def _forward(kernel: Kernel, images: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    b, h, w, c = images.shape
    out = torch.empty_like(images)
    with torch.cuda.device(images.device):
        kernel(ptr(images), ptr(flow), ptr(out), DTYPE_CODES[images.dtype], b, h, w, c,
               stream_ptr(images.device))
    return out


def warp_bilinear_fwd_thread(images: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The first design's gather (csrc/warp_fwd.cu) on CUDA tensors, `flow`
    in the image dtype: kept to compare the two on the card."""
    b, h, w, _ = images.shape
    check_kernel_input("warp_bilinear images", images, images.shape, images.dtype)
    check_kernel_input("warp_bilinear flow", flow, (b, h, w, 2), images.dtype)
    return _forward(_FWD_THREAD, images, flow)


def _info(symbol: str, kernel: int, dtype: torch.dtype) -> dict:
    """Registers and local memory per thread, static shared memory per
    block and resident blocks per SM of a kernel, by a query entry point
    of the library."""
    vals = [ctypes.c_int() for _ in range(4)]
    query(symbol, [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4, kernel,
          DTYPE_CODES[dtype], *map(ctypes.byref, vals))
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


# the kernels that `warp_fwd_tiled_info` reports (csrc/warp_fwd_tiled.cu)
FWD_TILED_KERNELS = ("rows", "c32", "c64", "c96", "c128", "elements")


def warp_fwd_tiled_info(kernel: str = "c32", dtype: torch.dtype = torch.bfloat16) -> dict:
    """What the build and the runtime made of a kernel of
    csrc/warp_fwd_tiled.cu: the rows kernel of C = 3 ("rows"), the lanes
    kernel with 16-byte packs at C = 32, 64, 96 or 128 ("c32" .. "c128"),
    or with single elements at any C ("elements"). Registers and local
    memory per thread, static shared memory per block, resident blocks
    per SM."""
    return _info("b2f_warp_fwd_tiled_info", FWD_TILED_KERNELS.index(kernel), dtype)


def warp_bilinear_backward_reference(images: torch.Tensor, flow: torch.Tensor,
                                     g: torch.Tensor, reference_grads: bool = True
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the backward kernels, for the output gradient
    `g` (B, H, W, C): (d_images in the image dtype, d_flow in the flow
    dtype), f32 sums, no autograd. d_images adds w*g at the four corners
    (+1 corners outside the image have weight exactly 0); d_flow is the
    reference formula (module docstring), zeroed where the coordinate
    clamps when `reference_grads` is False."""
    b, h, w, c = images.shape
    (x0, y0, x1, y1), (wx, wy), (x1_in, y1_in), (x_cl, y_cl) = _corners(flow, h, w)
    gf, im = g.float(), images.float()
    base = torch.arange(b, device=images.device).view(b, 1, 1) * h
    corners = (((y0, x0), wx * wy, None), ((y0, x1), (1 - wx) * wy, x1_in),
               ((y1, x0), wx * (1 - wy), y1_in), ((y1, x1), (1 - wx) * (1 - wy), x1_in & y1_in))
    d_img = torch.zeros(b * h * w, c, dtype=torch.float32, device=images.device)
    dots = []
    for (yy, xx), weight, inside in corners:
        idx = ((base + yy) * w + xx).reshape(-1)
        d_img.index_add_(0, idx, (weight.unsqueeze(-1) * gf).reshape(-1, c))
        dot = (im.reshape(-1, c)[idx].reshape(b, h, w, c) * gf).sum(-1)
        dots.append(dot if inside is None else torch.where(inside, dot, 0.0))
    tl, tr, bl, br = dots
    dfx = -wy * tl + wy * tr - (1 - wy) * bl + (1 - wy) * br
    dfy = -wx * tl + wx * bl - (1 - wx) * tr + (1 - wx) * br
    if not reference_grads:
        dfx, dfy = torch.where(x_cl, 0.0, dfx), torch.where(y_cl, 0.0, dfy)
    d_flow = torch.stack([dfx, dfy], dim=-1)
    return d_img.reshape(b, h, w, c).to(images.dtype), d_flow.to(flow.dtype)


def _backward(dimages: Kernel, dflow: Kernel, images: torch.Tensor, flow: torch.Tensor,
              g: torch.Tensor, reference_grads: bool, need: Tuple[bool, bool]
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    b, h, w, c = images.shape
    check_kernel_input("warp_bilinear images", images, images.shape, images.dtype)
    check_kernel_input("warp_bilinear flow", flow, (b, h, w, 2), images.dtype)
    check_kernel_input("warp_bilinear grad", g, images.shape, images.dtype)
    code, stream = DTYPE_CODES[images.dtype], stream_ptr(images.device)
    d_images = d_flow = None
    with torch.cuda.device(images.device):
        if need[0]:
            acc = torch.zeros(images.shape, dtype=torch.float32, device=images.device)
            dimages(ptr(flow), ptr(g), ptr(acc), code, b, h, w, c, stream)
            d_images = acc.to(images.dtype)
        if need[1]:
            d_flow = torch.empty_like(flow)
            dflow(ptr(images), ptr(flow), ptr(g), ptr(d_flow), code, b, h, w, c,
                  int(reference_grads), stream)
    return d_images, d_flow


def warp_bilinear_backward_cuda(images: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                                reference_grads: bool = True,
                                need: Tuple[bool, bool] = (True, True)
                                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward kernels on CUDA tensors: (d_images by K4 into a zeroed
    f32 buffer, cast once; d_flow by W-dflow), each None where `need`
    says so; `flow` and `g` in the image dtype."""
    return _backward(_DIMAGES, _DFLOW, images, flow, g, reference_grads, need)


def warp_bilinear_backward_thread(images: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                                  reference_grads: bool = True,
                                  need: Tuple[bool, bool] = (True, True)
                                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The same on the first design's kernels (csrc/warp_bwd.cu), CUDA
    tensors only: kept to compare the two on the card."""
    return _backward(_DIMAGES_THREAD, _DFLOW_THREAD, images, flow, g, reference_grads, need)


# K4's routes as `warp_dimages_routes` allows them: as the path does (the
# window route for a block whose box fits, where the grid holds 1.5
# blocks an SM or more), direct on every block, or the window route
# wherever the box fits
K4_ROUTES = ("grid", "direct", "window")


def warp_dimages_routes(flow: torch.Tensor, g: torch.Tensor, route: str = "grid"
                        ) -> Tuple[torch.Tensor, int, int]:
    """K4 on CUDA tensors with its routes allowed by `route` (K4_ROUTES),
    for comparing them: (the f32 image gradient, the blocks that took the
    window route, all blocks)."""
    b, h, w, c = g.shape
    check_kernel_input("warp_bilinear flow", flow, (b, h, w, 2), g.dtype)
    check_kernel_input("warp_bilinear grad", g, g.shape, g.dtype)
    acc = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    routes = torch.zeros(2, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        _DIMAGES_ROUTES(ptr(flow), ptr(g), ptr(acc), DTYPE_CODES[g.dtype], b, h, w, c,
                        K4_ROUTES.index(route), ptr(routes), stream_ptr(g.device))
    window, blocks = routes.tolist()
    return acc, window, blocks


# the kernels that `warp_bwd_tiled_info` reports (csrc/warp_bwd_tiled.cu)
TILED_KERNELS = ("dimages", "dflow_rows", "dflow_lanes", "dimages_direct")


def warp_bwd_tiled_info(kernel: str = "dimages", dtype: torch.dtype = torch.bfloat16) -> dict:
    """What the build and the runtime made of a kernel of
    csrc/warp_bwd_tiled.cu: K4 with 4-channel packs and the window route
    ("dimages") or direct on every block ("dimages_direct"), W-dflow at
    C = 3 ("dflow_rows") or in lane groups of 4 with 16-byte packs
    ("dflow_lanes"). Registers and local memory per thread, static shared
    memory per block, resident blocks per SM."""
    return _info("b2f_warp_bwd_tiled_info", TILED_KERNELS.index(kernel), dtype)


class _WarpFn(torch.autograd.Function):
    """The gather's forward; backward of the flow gradient (W-dflow) and,
    only when the images need it, the image-gradient scatter (K4). The
    route (kernel or twin) is fixed in the forward."""

    @staticmethod
    def forward(ctx, images, flow, reference_grads):
        ctx.reference_grads = reference_grads
        ctx.kernel = use_kernel(images)
        ctx.save_for_backward(images, flow)
        if not ctx.kernel:
            return warp_bilinear_reference(images, flow)
        return _forward(_FWD, images, flow)

    @staticmethod
    def backward(ctx, g):
        images, flow = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        g = g.to(images.dtype).contiguous()
        if ctx.kernel:
            d_images, d_flow = warp_bilinear_backward_cuda(images, flow, g,
                                                           ctx.reference_grads, need)
        else:
            d_images, d_flow = warp_bilinear_backward_reference(images, flow, g,
                                                                ctx.reference_grads)
        return d_images if need[0] else None, d_flow if need[1] else None, None


def warp_bilinear(images: torch.Tensor, flow: torch.Tensor, *,
                  reference_grads: bool = True) -> torch.Tensor:
    """Warp `images` by pixel-offset `flow` (NHWC; see module docstring).

    `reference_grads` selects the flow gradient (the reference's formula,
    or autodiff through the clamp); the forward and the image gradient are
    the same either way."""
    if images.dim() != 4 or flow.dim() != 4 or flow.shape[-1] != 2 \
            or flow.shape[:3] != images.shape[:3]:
        raise ValueError(f"expected NHWC images and (B,H,W,2) flow of the "
                         f"same size, got {tuple(images.shape)} / "
                         f"{tuple(flow.shape)}")
    flow = flow.to(images.dtype)
    if use_kernel(images):
        if flow.device != images.device:
            raise ValueError(f"images on {images.device}, flow on {flow.device}")
        b, h, w, c = images.shape
        check_kernel_input("warp_bilinear images", images, images.shape, images.dtype)
        check_kernel_input("warp_bilinear flow", flow, (b, h, w, 2), images.dtype)
        if images.numel() == 0:
            return torch.empty_like(images)
    return _WarpFn.apply(images, flow, reference_grads)
