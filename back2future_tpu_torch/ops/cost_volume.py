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
csrc/cost_volume_fwd.cu) and its
backward the kernels of csrc/cost_volume_bwd.cu (`_dref_kernel`,
`_dframe_kernel`), each launched only for an input that needs its
gradient; on CPU tensors the plain twins `cost_volume_reference` and
`cost_volume_backward_reference` run instead. The op is bilinear, so the
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


def cost_volume_backward_reference(g: torch.Tensor, ref: torch.Tensor,
                                   frame: torch.Tensor, win: int, dilation: int = 1,
                                   fwd: bool = True, scale: float = 1.0
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the backward kernels: for the output gradient
    `g` (B, H, W, win*win), explicit shifted products summed in f32,
    times `scale`, in the input dtype (no autograd):
      d_ref[y,x]   = sum_q g[y,x,q]       * frame[y-qy, x-qx]
      d_frame[y,x] = sum_q g[y+qy,x+qx,q] * ref[y+qy, x+qx]"""
    b, h, w, c = ref.shape
    pad = (win - 1) // 2 * dilation
    gf, r = g.float(), ref.float()
    frame_p = F.pad(frame.float(), (0, 0, pad, pad, pad, pad))
    d_ref = torch.zeros(b, h, w, c, dtype=torch.float32, device=ref.device)
    d_frame_p = torch.zeros_like(frame_p)
    for q, (qy, qx) in enumerate(displacements(win, dilation, fwd)):
        gq = gf[..., q:q + 1]
        d_ref += gq * frame_p[:, pad - qy:pad - qy + h, pad - qx:pad - qx + w]
        d_frame_p[:, pad - qy:pad - qy + h, pad - qx:pad - qx + w] += gq * r
    d_frame = d_frame_p[:, pad:pad + h, pad:pad + w]
    return (d_ref * scale).to(ref.dtype), (d_frame * scale).to(frame.dtype)


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


def cost_volume_fwd_bf16_info() -> dict:
    """What the build and the runtime made of K1's bf16 kernel
    (csrc/cost_volume_fwd_mma.cu) at win 9, dilation 1: registers and
    local memory per thread, dynamic shared memory per block, resident
    blocks per SM."""
    vals = [ctypes.c_int() for _ in range(4)]
    query("b2f_cost_volume_fwd_bf16_info", [ctypes.POINTER(ctypes.c_int)] * 4,
          *map(ctypes.byref, vals))
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def cost_volume_backward_cuda(g: torch.Tensor, ref: torch.Tensor, frame: torch.Tensor,
                              win: int, dilation: int = 1, fwd: bool = True,
                              scale: float = 1.0, need: Tuple[bool, bool] = (True, True)
                              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward kernels on CUDA tensors: (d_ref by K2, d_frame by K3),
    each None where `need` says so; `g` in the input dtype."""
    shape = tuple(ref.shape)
    check_kernel_input("cost_volume grad", g, shape[:3] + (win * win,), ref.dtype)
    for name, t in (("ref", ref), ("frame", frame)):
        check_kernel_input(f"cost_volume {name}", t, shape, ref.dtype)
    c = shape[-1]
    d_ref = _launch(_DREF, g, frame, c, win, dilation, fwd, scale) if need[0] else None
    d_frame = _launch(_DFRAME, g, ref, c, win, dilation, fwd, scale) if need[1] else None
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
