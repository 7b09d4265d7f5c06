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

The row window (`y0`): the flow and the output may cover only the rows
y0 .. y0 + h - 1 of the images, a band of a row-sharded image
(parallel/spatial.py). Output row y then computes exactly what row y0 + y
of the whole-image warp computes: its source coordinate is (y0 + y) + v
in f32, and the clamp and the +1 corners' mask use the images' height.
The image gradient covers every row of the images. `y0 = 0` with flow and
images of one height is the whole-image warp.

`warp_bilinear` calls the op `b2f::warp_bilinear` (ops/route.py). Its
CUDA implementation is the hand-written gather of csrc/warp_fwd_tiled.cu
(lane groups that read and write whole pixel rows in 16-byte packs, or
at C = 3 a thread per pixel that reads each corner pair as one span;
both walk the pixels over a persistent grid), its CPU implementation the
plain twin `warp_bilinear_reference`, and its fake the output's shape.
Its Autograd kernel (`register_function`, ops/route.py) calls two ops
of csrc/warp_bwd_tiled.cu: `b2f::warp_dimages`, the image gradient K4
(called only when the images need a gradient), and `b2f::warp_dflow`,
the flow gradient W-dflow (a thread per pixel at C = 3, lane groups
otherwise; `reference_grads` an argument); their CPU implementations are
the twins `warp_dimages_reference` and `warp_dflow_reference`. K4 adds
into a zeroed f32 accumulator, cast once to g's dtype. At every C but 3
it runs tiles of 4-channel quads whose adds are summed per window pixel
in shared memory, or added directly, by block where the launch's grid
holds 1.5 blocks an SM or more, else added directly. At C = 3 (the image
warps) it runs a kernel of its own, a thread per pixel, that sums its
tile's adds per window pixel with f32 shared atomics and flushes them in
16-byte reductions of 4 pixels into an accumulator of exactly 3 channels.
`warp_bilinear_fwd_thread` and `warp_bilinear_backward_thread` keep the
first design's kernels (csrc/warp_fwd.cu, csrc/warp_bwd.cu) callable for
comparison on the card, `warp_fwd_tiled_info` and `warp_bwd_tiled_info`
report what the build made of the new ones, and `warp_dimages_route`
and `warp_dimages_routes` run K4 by a route the caller chooses
(K4_ROUTES: the quad tiles at C = 3 among them), the second with a count
of its window-route blocks; these call the library by ctypes, not as
ops.
"""

from __future__ import annotations

import ctypes

from typing import Optional, Tuple

import torch

from ..runtime.cuda_build import Kernel, query
from .route import (DTYPE_CODES, below_autograd, check_kernel_input, define, plain_active, ptr,
                    register_function, stream_ptr, use_kernel)

_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# (img, flow, out, dtype, B, H, W, C, H_src, y0, stream)
_FWD = Kernel("b2f_warp_bilinear_fwd", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
              + [ctypes.c_void_p])
# the first design's gather: for comparison only, nothing on any path
_FWD_THREAD = Kernel("b2f_warp_bilinear_fwd_thread", _FWD_ARGS)
_DIMAGES_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# (flow, g, d_img f32, dtype, B, H, W, C, H_src, y0, stream)
_DIMAGES = Kernel("b2f_warp_bilinear_dimages", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p])
# K4 with (route, route counts) before the stream; and the first design's
# K4: for comparison only, nothing on any path
_DIMAGES_ROUTES = Kernel("b2f_warp_bilinear_dimages_routes",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)
_DIMAGES_THREAD = Kernel("b2f_warp_bilinear_dimages_thread", _DIMAGES_ARGS)
_DFLOW_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# (img, flow, g, d_flow, dtype, B, H, W, C, H_src, y0, reference_grads, stream)
_DFLOW = Kernel("b2f_warp_bilinear_dflow", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                + [ctypes.c_void_p])
# the first design's W-dflow: for comparison only, nothing on any path
_DFLOW_THREAD = Kernel("b2f_warp_bilinear_dflow_thread", _DFLOW_ARGS)


def _corners(flow: torch.Tensor, h: int, w: int, y0: int = 0):
    """f32 source coordinates of every output pixel: the corner indices
    (+1 corners clamped into the image), the left-column / top-row
    weights (B, H_out, W), and the masks of +1 corners inside the image
    and of clamped coordinates. `h` is the images' height; output row y
    is image row y0 + y (the row window, module docstring)."""
    fl = flow.float()
    h_out = flow.shape[1]
    gy = torch.arange(y0, y0 + h_out, dtype=torch.float32, device=flow.device).view(1, h_out, 1)
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


def warp_bilinear_reference(images: torch.Tensor, flow: torch.Tensor,
                            y0: int = 0) -> torch.Tensor:
    """Plain torch twin of the kernel: clamped f32 source coordinates,
    four corner gathers, f32 weighted sum, in the image dtype; the output
    has the flow's rows, row y at image row `y0` + y."""
    b, h, w, c = images.shape
    (x0, y0, x1, y1), (wx, wy), _, _ = _corners(flow, h, w, y0)
    wx, wy = wx.unsqueeze(-1), wy.unsqueeze(-1)
    bi = torch.arange(b, device=images.device).view(b, 1, 1)
    im = images.float()
    out = (wx * wy * im[bi, y0, x0] + (1 - wx) * wy * im[bi, y0, x1]
           + wx * (1 - wy) * im[bi, y1, x0] + (1 - wx) * (1 - wy) * im[bi, y1, x1])
    return out.to(images.dtype)


def _forward(kernel: Kernel, images: torch.Tensor, flow: torch.Tensor,
             *window: int) -> torch.Tensor:
    """`kernel` on CUDA tensors into a new (B, H_out, W, C) output; the
    gather's `window` is (H_src, y0), the first design's is empty."""
    b, h_src, w, c = images.shape
    h = flow.shape[1]
    check_kernel_input("warp_bilinear images", images, images.shape, images.dtype)
    check_kernel_input("warp_bilinear flow", flow, (b, h, w, 2), images.dtype)
    out = torch.empty((b, h, w, c), dtype=images.dtype, device=images.device)
    with torch.cuda.device(images.device):
        kernel(ptr(images), ptr(flow), ptr(out), DTYPE_CODES[images.dtype], b, h, w, c, *window,
               stream_ptr(images.device))
    return out


def warp_bilinear_fwd_thread(images: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The first design's gather (csrc/warp_fwd.cu) on CUDA tensors, `flow`
    in the image dtype and of the images' size: kept to compare the two
    on the card."""
    check_kernel_input("warp_bilinear flow", flow, (*images.shape[:3], 2), images.dtype)
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


def _dimages_sum(flow: torch.Tensor, g: torch.Tensor, h: int, y0: int = 0) -> torch.Tensor:
    """The image gradient (B, h, W, C) of images of `h` rows for the
    output gradient `g` (B, H_out, W, C) of the window at `y0`: w*g added
    at the four corners (+1 corners outside the image have weight exactly
    0), in f32."""
    b, _, w, c = g.shape
    (x0, y0, x1, y1), (wx, wy), _, _ = _corners(flow, h, w, y0)
    gf = g.float()
    base = torch.arange(b, device=g.device).view(b, 1, 1) * h
    corners = (((y0, x0), wx * wy), ((y0, x1), (1 - wx) * wy),
               ((y1, x0), wx * (1 - wy)), ((y1, x1), (1 - wx) * (1 - wy)))
    d_img = torch.zeros(b * h * w, c, dtype=torch.float32, device=g.device)
    for (yy, xx), weight in corners:
        idx = ((base + yy) * w + xx).reshape(-1)
        d_img.index_add_(0, idx, (weight.unsqueeze(-1) * gf).reshape(-1, c))
    return d_img.reshape(b, h, w, c)


def warp_dimages_reference(flow: torch.Tensor, g: torch.Tensor, h_src: int = -1,
                           y0: int = 0) -> torch.Tensor:
    """Plain torch twin of K4, for the output gradient `g` in the image
    dtype: the gradient of images of `h_src` rows (-1: g's rows) for the
    window at `y0`, f32 sums, in g's dtype, no autograd."""
    return _dimages_sum(flow, g, g.shape[1] if h_src < 0 else h_src, y0).to(g.dtype)


def warp_dflow_reference(images: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                         reference_grads: bool = True, y0: int = 0) -> torch.Tensor:
    """Plain torch twin of W-dflow, for the output gradient `g` of the
    window at `y0`: the reference formula (module docstring), zeroed where
    the coordinate clamps when `reference_grads` is False; f32 sums, in
    the flow dtype, no autograd."""
    b, h, w, c = images.shape
    h_out = flow.shape[1]
    (x0, y0, x1, y1), (wx, wy), (x1_in, y1_in), (x_cl, y_cl) = _corners(flow, h, w, y0)
    gf, im = g.float(), images.float()
    base = torch.arange(b, device=images.device).view(b, 1, 1) * h
    corners = (((y0, x0), None), ((y0, x1), x1_in), ((y1, x0), y1_in), ((y1, x1), x1_in & y1_in))
    dots = []
    for (yy, xx), inside in corners:
        idx = ((base + yy) * w + xx).reshape(-1)
        dot = (im.reshape(-1, c)[idx].reshape(b, h_out, w, c) * gf).sum(-1)
        dots.append(dot if inside is None else torch.where(inside, dot, 0.0))
    tl, tr, bl, br = dots
    dfx = -wy * tl + wy * tr - (1 - wy) * bl + (1 - wy) * br
    dfy = -wx * tl + wx * bl - (1 - wx) * tr + (1 - wx) * br
    if not reference_grads:
        dfx, dfy = torch.where(x_cl, 0.0, dfx), torch.where(y_cl, 0.0, dfy)
    return torch.stack([dfx, dfy], dim=-1).to(flow.dtype)


def warp_bilinear_backward_reference(images: torch.Tensor, flow: torch.Tensor,
                                     g: torch.Tensor, reference_grads: bool = True,
                                     y0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the backward kernels, for the output gradient
    `g` (B, H_out, W, C) of the window at `y0`: (d_images in the image
    dtype, d_flow in the flow dtype), f32 sums, no autograd
    (`warp_dimages_reference`, `warp_dflow_reference`)."""
    return (_dimages_sum(flow, g, images.shape[1], y0).to(images.dtype),
            warp_dflow_reference(images, flow, g, reference_grads, y0))


def _check_backward(images: torch.Tensor, flow: torch.Tensor, g: torch.Tensor) -> None:
    b, _, w, c = images.shape
    h = flow.shape[1]
    check_kernel_input("warp_bilinear images", images, images.shape, images.dtype)
    check_kernel_input("warp_bilinear flow", flow, (b, h, w, 2), images.dtype)
    check_kernel_input("warp_bilinear grad", g, (b, h, w, c), images.dtype)


def _launch_dimages(kernel: Kernel, flow: torch.Tensor, g: torch.Tensor,
                    *args: int) -> torch.Tensor:
    """`kernel` into a zeroed f32 image gradient, cast once to g's dtype;
    K4's `args` are (H_src, y0[, route, routes]), the first design's are
    empty (H_src is g's rows)."""
    b, h, w, c = g.shape
    acc = torch.zeros((b, args[0] if args else h, w, c), dtype=torch.float32,
                      device=g.device)
    with torch.cuda.device(g.device):
        kernel(ptr(flow), ptr(g), ptr(acc), DTYPE_CODES[g.dtype], b, h, w, c, *args,
               stream_ptr(g.device))
    return acc.to(g.dtype)


def _launch_dflow(kernel: Kernel, images: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                  reference_grads: bool, *window: int) -> torch.Tensor:
    """`kernel` into a new flow gradient; W-dflow's `window` is (H_src,
    y0), the first design's is empty."""
    b, _, w, c = images.shape
    d_flow = torch.empty_like(flow)
    with torch.cuda.device(images.device):
        kernel(ptr(images), ptr(flow), ptr(g), ptr(d_flow), DTYPE_CODES[images.dtype], b,
               flow.shape[1], w, c, *window, int(reference_grads), stream_ptr(images.device))
    return d_flow


def warp_bilinear_backward_thread(images: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                                  reference_grads: bool = True,
                                  need: Tuple[bool, bool] = (True, True)
                                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward on the first design's kernels (csrc/warp_bwd.cu), CUDA
    tensors only: (d_images into a zeroed f32 buffer, cast once; d_flow),
    each None where `need` says so; `flow` and `g` in the image dtype and
    of the images' size. Kept to compare them with `b2f::warp_dimages` and
    `b2f::warp_dflow` on the card."""
    _check_backward(images, flow, g)
    check_kernel_input("warp_bilinear grad", g, images.shape, images.dtype)
    d_images = _launch_dimages(_DIMAGES_THREAD, flow, g) if need[0] else None
    d_flow = (_launch_dflow(_DFLOW_THREAD, images, flow, g, reference_grads) if need[1]
              else None)
    return d_images, d_flow


# K4's routes (csrc/warp_bwd_tiled.cu Route), each by the kernel of its C
# (the pixel kernel at C = 3, the quad tiles elsewhere): "grid" the
# path's; for comparing them only, direct on every block, or the window
# wherever the box fits; and "quads", the quad tiles by their grid at any
# C, as the path took them at C = 3 before the pixel kernel
K4_ROUTES = ("grid", "direct", "window", "quads")


def _check_dimages(flow: torch.Tensor, g: torch.Tensor) -> None:
    b, h, w, _ = g.shape
    check_kernel_input("warp_bilinear grad", g, g.shape, g.dtype)
    check_kernel_input("warp_bilinear flow", flow, (b, h, w, 2), g.dtype)


def warp_dimages_route(flow: torch.Tensor, g: torch.Tensor, route: str, h_src: int = -1,
                       y0: int = 0) -> torch.Tensor:
    """K4 on CUDA tensors by the caller's `route` (K4_ROUTES), through the
    path's wrapper (zero-fill, kernel, one cast): the image gradient in g's
    dtype, of images of `h_src` rows (-1: g's) for the window at `y0`. For
    timing the routes against each other; nothing is synchronised."""
    _check_dimages(flow, g)
    h = g.shape[1] if h_src < 0 else h_src
    return _launch_dimages(_DIMAGES_ROUTES, flow, g, h, y0, K4_ROUTES.index(route), None)


def warp_dimages_routes(flow: torch.Tensor, g: torch.Tensor, route: str = "grid",
                        h_src: int = -1, y0: int = 0) -> Tuple[torch.Tensor, int, int]:
    """K4 on CUDA tensors by `route` (K4_ROUTES), counting its blocks:
    (the f32 image gradient of images of `h_src` rows (-1: g's) for the
    window at `y0`, the blocks that took the window route, all blocks)."""
    _check_dimages(flow, g)
    b, h, w, c = g.shape
    h = h if h_src < 0 else h_src
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=g.device)
    routes = torch.zeros(2, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        _DIMAGES_ROUTES(ptr(flow), ptr(g), ptr(acc), DTYPE_CODES[g.dtype], b, g.shape[1], w, c,
                        h, y0, K4_ROUTES.index(route), ptr(routes), stream_ptr(g.device))
    window, blocks = routes.tolist()
    return acc, window, blocks


# the kernels that `warp_bwd_tiled_info` reports (csrc/warp_bwd_tiled.cu)
TILED_KERNELS = ("dimages", "dflow_rows", "dflow_lanes", "dimages_direct", "dimages_c3")


def warp_bwd_tiled_info(kernel: str = "dimages", dtype: torch.dtype = torch.bfloat16) -> dict:
    """What the build and the runtime made of a kernel of
    csrc/warp_bwd_tiled.cu: K4 with 4-channel packs and the window route
    ("dimages") or direct on every block ("dimages_direct"), K4's C = 3
    pixel kernel ("dimages_c3"), W-dflow at C = 3 ("dflow_rows") or in
    lane groups of 4 with 16-byte packs ("dflow_lanes"). Registers and
    local memory per thread, static shared memory per block, resident
    blocks per SM."""
    return _info("b2f_warp_bwd_tiled_info", TILED_KERNELS.index(kernel), dtype)


def _fwd_kernel(images: torch.Tensor, flow: torch.Tensor, reference_grads: bool,
                y0: int = 0) -> torch.Tensor:
    """The gather on CUDA tensors: `b2f::warp_bilinear`'s CUDA implementation."""
    return _forward(_FWD, images, flow, images.shape[1], y0)


def _dimages_kernel(flow: torch.Tensor, g: torch.Tensor, h_src: int = -1,
                    y0: int = 0) -> torch.Tensor:
    """K4 on CUDA tensors: `b2f::warp_dimages`'s CUDA implementation."""
    _check_dimages(flow, g)
    return _launch_dimages(_DIMAGES, flow, g, g.shape[1] if h_src < 0 else h_src, y0)


def _dflow_kernel(images: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                  reference_grads: bool, y0: int = 0) -> torch.Tensor:
    """W-dflow on CUDA tensors: `b2f::warp_dflow`'s CUDA implementation."""
    _check_backward(images, flow, g)
    return _launch_dflow(_DFLOW, images, flow, g, reference_grads, images.shape[1], y0)


# the twins are looked up when called (a test counts their calls)
_WARP = define("warp_bilinear",
               "(Tensor images, Tensor flow, bool reference_grads, int y0=0) -> Tensor",
               lambda images, flow, reference_grads, y0=0:
                   warp_bilinear_reference(images, flow, y0),
               _fwd_kernel,
               lambda images, flow, reference_grads, y0=0:
                   images.new_empty((*flow.shape[:3], images.shape[3])))
_DIMAGES_OP = define("warp_dimages", "(Tensor flow, Tensor g, int h_src=-1, int y0=0) -> Tensor",
                     lambda *a: warp_dimages_reference(*a), _dimages_kernel,
                     lambda flow, g, h_src=-1, y0=0:
                         g.new_empty((g.shape[0], g.shape[1] if h_src < 0 else h_src,
                                      *g.shape[2:])))
_DFLOW_OP = define("warp_dflow",
                   "(Tensor images, Tensor flow, Tensor g, bool reference_grads, int y0=0) "
                   "-> Tensor",
                   lambda *a: warp_dflow_reference(*a), _dflow_kernel,
                   lambda images, flow, g, reference_grads, y0=0: torch.empty_like(flow))


class _WarpGrad(torch.autograd.Function):
    """`b2f::warp_bilinear`'s Autograd kernel (`register_function`): the op
    below autograd; the flow gradient by W-dflow and, only when the
    images need it, the image gradient by K4, or the twins on the plain
    route, which the forward records."""

    @staticmethod
    def forward(ctx, images, flow, reference_grads, y0=0):
        ctx.args = (reference_grads, y0)
        ctx.plain = plain_active()
        ctx.save_for_backward(images, flow)
        return below_autograd(torch.ops.b2f.warp_bilinear.default, images, flow, reference_grads,
                              y0)

    @staticmethod
    def backward(ctx, g):
        images, flow = ctx.saved_tensors
        reference_grads, y0 = ctx.args
        need = ctx.needs_input_grad[:2]
        g = g.to(images.dtype).contiguous()
        if ctx.plain:
            d_images, d_flow = warp_bilinear_backward_reference(images, flow, g,
                                                                reference_grads, y0)
        else:
            d_images = _DIMAGES_OP(flow, g, images.shape[1], y0) if need[0] else None
            d_flow = _DFLOW_OP(images, flow, g, reference_grads, y0) if need[1] else None
        return d_images if need[0] else None, d_flow if need[1] else None, None, None


register_function("warp_bilinear", _WarpGrad)


def warp_bilinear(images: torch.Tensor, flow: torch.Tensor, *,
                  reference_grads: bool = True, y0: int = 0) -> torch.Tensor:
    """Warp `images` by pixel-offset `flow` (NHWC; see module docstring):
    the op `b2f::warp_bilinear`.

    `reference_grads` selects the flow gradient (the reference's formula,
    or autodiff through the clamp); the forward and the image gradient are
    the same either way. `y0` is the row window's first row: the flow
    covers image rows y0 .. y0 + flow rows - 1 (0 with a flow of the
    images' size)."""
    if images.dim() != 4 or flow.dim() != 4 or flow.shape[-1] != 2 \
            or flow.shape[0] != images.shape[0] or flow.shape[2] != images.shape[2] \
            or not 0 <= y0 <= images.shape[1] - flow.shape[1]:
        raise ValueError(f"expected NHWC images and a (B,H,W,2) flow of the "
                         f"same size, or of a row window at y0={y0} inside the images, "
                         f"got {tuple(images.shape)} / {tuple(flow.shape)}")
    flow = flow.to(images.dtype)
    if use_kernel(images):
        if flow.device != images.device:
            raise ValueError(f"images on {images.device}, flow on {flow.device}")
        if flow.numel() == 0 or images.numel() == 0:
            return images.new_empty((*flow.shape[:3], images.shape[3]))
    return _WARP(images, flow, reference_grads, y0)
