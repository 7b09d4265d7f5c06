"""Multi-frame cost volume with frame-distance displacement dilation.

Counterpart of back2future_tpu/ops/cost_volume.py; semantics of the
reference CostVolMulti (models/CostVolMulti.lua:49-108): for each window
displacement (qx, qy) of a win x win grid, dilated by the frame distance
k+1 and mirrored for past frames (`fwd=False`), the cost at reference
pixel p is sum_c ref(p) * frame(p - q), zero outside the overlap,
accumulated over frames and normalised by C * num_frames. Output channel
i enumerates qx outer, qy inner: i = qx_idx * win + qy_idx.

Layout: NHWC; output (B, H, W, win*win) in the input dtype.

`cost_volume` is an autograd Function (the port of the `custom_vjp` of
`cost_volume_pallas`). On CUDA tensors its forward is the hand-written
kernel behind `b2f_cost_volume_fwd` (the Pallas `_fwd_kernel`: bf16 on
the tensor cores, csrc/cost_volume_fwd_mma.cu; f32 on the CUDA cores,
csrc/cost_volume_fwd.cu) and its backward the kernels of `_dref_kernel`
and `_dframe_kernel`, each launched only for an input that needs its
gradient: bf16 on the tensor cores (csrc/cost_volume_bwd_mma.cu, one
kernel body for both: d_frame is d_ref's form on the shifted gradient,
see `cost_volume_gshift_reference`), f32 on the CUDA cores
(csrc/cost_volume_bwd.cu); on CPU tensors the plain twins
`cost_volume_reference` and `cost_volume_backward_reference` run
instead. The op is bilinear, so the
twins' sums are its exact gradient; the output gradient is cast to the
input dtype first, as in the JAX rule, and every sum is f32, rounded once.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..runtime.cuda_build import Kernel, query
from .route import DTYPE_CODES, check_kernel_input, ptr, stream_ptr, use_kernel

# (a, b, out, dtype, B, H, W, C, win, dilation, fwd, scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_FWD = Kernel("b2f_cost_volume_fwd", _ARGTYPES)
# the CUDA-core forward in both dtypes (the bf16 design before the tensor
# cores), for timing beside `_FWD`; nothing on the serving or train path
_FWD_CUDA_CORES = Kernel("b2f_cost_volume_fwd_cuda_cores", _ARGTYPES)
_DREF = Kernel("b2f_cost_volume_dref", _ARGTYPES)
_DFRAME = Kernel("b2f_cost_volume_dframe", _ARGTYPES)
# the CUDA-core backward in both dtypes (the bf16 design before the tensor
# cores), for timing beside `_DREF` / `_DFRAME`; nothing on any path
_DREF_CUDA_CORES = Kernel("b2f_cost_volume_dref_cuda_cores", _ARGTYPES)
_DFRAME_CUDA_CORES = Kernel("b2f_cost_volume_dframe_cuda_cores", _ARGTYPES)
KERNEL_WINDOWS = (3, 5, 7, 9)  # win sizes the kernel is instantiated for


def displacements(win: int, dilation: int, fwd: bool) -> List[Tuple[int, int]]:
    """(qy, qx) per output channel, in reference channel order."""
    n = (win - 1) // 2
    sign = 1 if fwd else -1
    return [(sign * qy * dilation, sign * qx * dilation)
            for qx in range(-n, n + 1) for qy in range(-n, n + 1)]


def cost_volume_reference(ref: torch.Tensor, frame: torch.Tensor, win: int,
                          dilation: int = 1, fwd: bool = True,
                          scale: float = 1.0) -> torch.Tensor:
    """Plain torch twin of the kernel: one shifted product per
    displacement, summed over channels in f32, times `scale`, in the
    input dtype."""
    b, h, w, c = ref.shape
    pad = (win - 1) // 2 * dilation
    padded = F.pad(frame.float(), (0, 0, pad, pad, pad, pad))
    r = ref.float()
    costs = [(r * padded[:, pad - qy:pad - qy + h, pad - qx:pad - qx + w]).sum(-1)
             for qy, qx in displacements(win, dilation, fwd)]
    return (torch.stack(costs, dim=-1) * scale).to(ref.dtype)


def dref_form(g: torch.Tensor, frame: torch.Tensor, win: int, dilation: int = 1,
              fwd: bool = True, scale: float = 1.0) -> torch.Tensor:
    """The d_ref transpose, summed in f32, times `scale`, in the input
    dtype: out[y,x] = sum_q g[y,x,q] * frame[y-qy, x-qx], frame pixels
    outside the image 0. Also d_frame's form, on the shifted gradient
    with the direction mirrored (see `cost_volume_gshift_reference`)."""
    b, h, w, c = frame.shape
    pad = (win - 1) // 2 * dilation
    gf = g.float()
    frame_p = F.pad(frame.float(), (0, 0, pad, pad, pad, pad))
    out = torch.zeros(b, h, w, c, dtype=torch.float32, device=frame.device)
    for q, (qy, qx) in enumerate(displacements(win, dilation, fwd)):
        out += gf[..., q:q + 1] * frame_p[:, pad - qy:pad - qy + h, pad - qx:pad - qx + w]
    return (out * scale).to(frame.dtype)


def cost_volume_gshift_reference(g: torch.Tensor, win: int, dilation: int = 1,
                                 fwd: bool = True) -> torch.Tensor:
    """The shifted output gradient g'[y,x,q] = g[y+qy, x+qx, q], 0 where
    (y+qy, x+qx) is outside the image. Since the op is bilinear, d_frame =
    dref_form(g', ref, win, dilation, not fwd): the form the bf16 d_frame
    kernel computes, reading g' in place from its haloed tile of g."""
    b, h, w, _ = g.shape
    pad = (win - 1) // 2 * dilation
    g_p = F.pad(g, (0, 0, pad, pad, pad, pad))
    planes = [g_p[:, pad + qy:pad + qy + h, pad + qx:pad + qx + w, q]
              for q, (qy, qx) in enumerate(displacements(win, dilation, fwd))]
    return torch.stack(planes, dim=-1)


def cost_volume_backward_reference(g: torch.Tensor, ref: torch.Tensor,
                                   frame: torch.Tensor, win: int, dilation: int = 1,
                                   fwd: bool = True, scale: float = 1.0
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the backward kernels: for the output gradient
    `g` (B, H, W, win*win), explicit shifted products summed in f32,
    times `scale`, in the input dtype (no autograd):
      d_ref[y,x]   = sum_q g[y,x,q]       * frame[y-qy, x-qx]   (dref_form)
      d_frame[y,x] = sum_q g[y+qy,x+qx,q] * ref[y+qy, x+qx]"""
    b, h, w, c = ref.shape
    pad = (win - 1) // 2 * dilation
    gf, r = g.float(), ref.float()
    d_frame_p = torch.zeros(b, h + 2 * pad, w + 2 * pad, c, dtype=torch.float32,
                            device=ref.device)
    for q, (qy, qx) in enumerate(displacements(win, dilation, fwd)):
        d_frame_p[:, pad - qy:pad - qy + h, pad - qx:pad - qx + w] += gf[..., q:q + 1] * r
    d_frame = d_frame_p[:, pad:pad + h, pad:pad + w]
    return dref_form(g, frame, win, dilation, fwd, scale), (d_frame * scale).to(frame.dtype)


def _launch(kernel: Kernel, a: torch.Tensor, b_: torch.Tensor, out_channels: int,
            win: int, dilation: int, fwd: bool, scale: float) -> torch.Tensor:
    """Run one cost-volume kernel on (a, b_) of shape (B, H, W, *) into a
    fresh (B, H, W, out_channels) tensor of b_'s dtype."""
    bsz, h, w, c = b_.shape
    out = torch.empty((bsz, h, w, out_channels), dtype=b_.dtype, device=b_.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(b_.device):
        kernel(ptr(a), ptr(b_), ptr(out), DTYPE_CODES[b_.dtype], bsz, h, w, c, win,
               dilation, int(fwd), scale, stream_ptr(b_.device))
    return out


def cost_volume_cuda_cores(ref: torch.Tensor, frame: torch.Tensor, win: int,
                           dilation: int = 1, fwd: bool = True,
                           scale: float = 1.0) -> torch.Tensor:
    """The forward on the CUDA-core kernel, f32 or bf16, CUDA tensors only
    (no autograd): the bf16 design that the tensor-core kernel replaced,
    kept to compare the two on the card."""
    if win not in KERNEL_WINDOWS:
        raise ValueError(f"cost_volume kernel: win {win} not in {KERNEL_WINDOWS}")
    for name, t in (("ref", ref), ("frame", frame)):
        check_kernel_input(f"cost_volume {name}", t, ref.shape, ref.dtype)
    return _launch(_FWD_CUDA_CORES, ref, frame, win * win, win, dilation, fwd, scale)


def _bf16_info(symbol: str, *first: int) -> dict:
    vals = [ctypes.c_int() for _ in range(4)]
    query(symbol, [ctypes.c_int] * len(first) + [ctypes.POINTER(ctypes.c_int)] * 4, *first,
          *map(ctypes.byref, vals))
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def cost_volume_fwd_bf16_info() -> dict:
    """What the build and the runtime made of K1's bf16 kernel
    (csrc/cost_volume_fwd_mma.cu) at win 9, dilation 1: registers and
    local memory per thread, dynamic shared memory per block, resident
    blocks per SM."""
    return _bf16_info("b2f_cost_volume_fwd_bf16_info")


def cost_volume_bwd_bf16_info(dframe: bool = False) -> dict:
    """The same for the bf16 backward kernel (csrc/cost_volume_bwd_mma.cu)
    at win 9: its d_ref instantiation (K2), or its d_frame one (K3)."""
    return _bf16_info("b2f_cost_volume_bwd_bf16_info", int(dframe))


def _check_backward_inputs(g, ref, frame, win):
    shape = tuple(ref.shape)
    if win not in KERNEL_WINDOWS:
        raise ValueError(f"cost_volume kernel: win {win} not in {KERNEL_WINDOWS}")
    check_kernel_input("cost_volume grad", g, shape[:3] + (win * win,), ref.dtype)
    for name, t in (("ref", ref), ("frame", frame)):
        check_kernel_input(f"cost_volume {name}", t, shape, ref.dtype)


def cost_volume_backward_cuda(g: torch.Tensor, ref: torch.Tensor, frame: torch.Tensor,
                              win: int, dilation: int = 1, fwd: bool = True,
                              scale: float = 1.0, need: Tuple[bool, bool] = (True, True)
                              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward kernels on CUDA tensors: (d_ref by K2, d_frame by K3),
    each None where `need` says so; `g` in the input dtype. bf16 runs the
    tensor-core kernels, f32 the CUDA-core ones."""
    _check_backward_inputs(g, ref, frame, win)
    c = ref.shape[-1]
    d_ref = _launch(_DREF, g, frame, c, win, dilation, fwd, scale) if need[0] else None
    d_frame = _launch(_DFRAME, g, ref, c, win, dilation, fwd, scale) if need[1] else None
    return d_ref, d_frame


def cost_volume_backward_cuda_cores(g: torch.Tensor, ref: torch.Tensor, frame: torch.Tensor,
                                    win: int, dilation: int = 1, fwd: bool = True,
                                    scale: float = 1.0, need: Tuple[bool, bool] = (True, True)
                                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward on the CUDA-core kernels, f32 or bf16, CUDA tensors
    only (no autograd): the bf16 design that the tensor-core kernel
    replaced, kept to compare the two on the card."""
    _check_backward_inputs(g, ref, frame, win)
    c = ref.shape[-1]
    d_ref = _launch(_DREF_CUDA_CORES, g, frame, c, win, dilation, fwd, scale) \
        if need[0] else None
    d_frame = _launch(_DFRAME_CUDA_CORES, g, ref, c, win, dilation, fwd, scale) \
        if need[1] else None
    return d_ref, d_frame


class _CostVolumeFn(torch.autograd.Function):
    """Kernel 1 forward; K2 (d_ref) and K3 (d_frame) backward, `scale`
    folded in. The route (kernel or twin) is fixed in the forward."""

    @staticmethod
    def forward(ctx, ref, frame, win, dilation, fwd, scale):
        ctx.args = (win, dilation, fwd, scale)
        ctx.kernel = use_kernel(ref)
        ctx.save_for_backward(ref, frame)
        if not ctx.kernel:
            return cost_volume_reference(ref, frame, win, dilation, fwd, scale)
        return _launch(_FWD, ref, frame, win * win, win, dilation, fwd, scale)

    @staticmethod
    def backward(ctx, g):
        ref, frame = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        g = g.to(ref.dtype).contiguous()
        if ctx.kernel:
            d_ref, d_frame = cost_volume_backward_cuda(g, ref, frame, *ctx.args, need=need)
        else:
            d_ref, d_frame = cost_volume_backward_reference(g, ref, frame, *ctx.args)
        return d_ref if need[0] else None, d_frame if need[1] else None, \
            None, None, None, None


def cost_volume(ref: torch.Tensor, frame: torch.Tensor, win: int,
                dilation: int = 1, fwd: bool = True,
                scale: float = 1.0) -> torch.Tensor:
    """Single-frame cost volume term, times `scale` (1: unnormalised, as
    the JAX `cost_volume`), differentiable in `ref` and `frame`. The CUDA
    kernels on CUDA tensors, the twins on CPU tensors."""
    if ref.shape != frame.shape or ref.dim() != 4:
        raise ValueError(f"expected two equal NHWC shapes, got "
                         f"{tuple(ref.shape)} vs {tuple(frame.shape)}")
    if win % 2 != 1 or dilation < 1:
        raise ValueError(f"win must be odd and dilation >= 1, got "
                         f"win={win} dilation={dilation}")
    if use_kernel(ref):
        if frame.device != ref.device:
            raise ValueError(f"ref on {ref.device}, frame on {frame.device}")
        if win not in KERNEL_WINDOWS:
            raise ValueError(f"cost_volume kernel: win {win} not in {KERNEL_WINDOWS}")
        for name, t in (("ref", ref), ("frame", frame)):
            check_kernel_input(f"cost_volume {name}", t, ref.shape, ref.dtype)
    return _CostVolumeFn.apply(ref, frame, win, dilation, fwd, scale)


def cost_volume_multi(ref: torch.Tensor, frames: Sequence[torch.Tensor],
                      win: int, fwd: bool = True) -> torch.Tensor:
    """Multi-frame cost volume w.r.t. `ref`, normalised by C * len(frames).

    `frames[k]` is the frame at temporal distance k+1 from the reference
    (future if fwd, past otherwise); its displacements are dilated by k+1
    and mirrored for past frames (CostVolMulti.lua:62-74). The
    normalisation is applied inside each term (one pass per frame)."""
    scale = 1.0 / (ref.shape[-1] * len(frames))
    acc = None
    for k, frame in enumerate(frames):
        cv = cost_volume(ref, frame, win, dilation=k + 1, fwd=fwd, scale=scale)
        acc = cv if acc is None else acc + cv
    return acc
