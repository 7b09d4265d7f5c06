"""Multi-frame cost volume with frame-distance displacement dilation.

Counterpart of back2future_tpu/ops/cost_volume.py; semantics of the
reference CostVolMulti (models/CostVolMulti.lua:49-108): for each window
displacement (qx, qy) of a win x win grid, dilated by the frame distance
k+1 and mirrored for past frames (`fwd=False`), the cost at reference
pixel p is sum_c ref(p) * frame(p - q), zero outside the overlap,
accumulated over frames and normalised by C * num_frames. Output channel
i enumerates qx outer, qy inner: i = qx_idx * win + qy_idx.

Layout: NHWC; output (B, H, W, win*win) in the input dtype.

`cost_volume` calls the op `b2f::cost_volume` (ops/route.py), the port
of `cost_volume_pallas` and its `custom_vjp`. Its CUDA implementation is
the hand-written kernel behind `b2f_cost_volume_fwd` (the Pallas
`_fwd_kernel`: bf16 on the tensor cores, csrc/cost_volume_fwd_mma.cu;
f32 on the CUDA cores, csrc/cost_volume_fwd.cu), its CPU implementation
the plain twin `cost_volume_reference`, and its fake the output's shape.
Its Autograd kernel (`register_function`, ops/route.py) calls
`b2f::cost_volume_dref` and `b2f::cost_volume_dframe`, the kernels of
`_dref_kernel` and `_dframe_kernel`, each only for an input that needs
its gradient: bf16 on the tensor cores (csrc/cost_volume_bwd_mma.cu, one
kernel body for both: d_frame is d_ref's form on the shifted gradient,
see `cost_volume_gshift_reference`), f32 on the CUDA cores
(csrc/cost_volume_bwd.cu); their CPU implementations are the twins
`dref_form` and `dframe_reference`. The op is bilinear, so the twins'
sums are its exact gradient; the output gradient is cast to the input
dtype first, as in the JAX rule, and every sum is f32, rounded once.

On a row band of a sharded level (`cost_volume_multi(..., comm=)`,
parallel/spatial.py) each term runs the same op on the band extended by
the (win//2) * dilation rows its displacements reach: the frame by a
halo of the neighbouring bands' rows (zeros at the image's edge), the
reference by zero rows (an output row reads only its own reference
row), and the output is cropped back to the band. The halo rows' d_frame
goes back to their owners and is summed there; their d_ref is zero, as
the cropped rows' gradient is. No kernel changes.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel.spatial import Comm, halo_rows
from ..runtime.cuda_build import Kernel, query
from .route import (DTYPE_CODES, below_autograd, check_kernel_input, define, plain_active, ptr,
                    register_function, stream_ptr, use_kernel)

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


def dframe_reference(g: torch.Tensor, ref: torch.Tensor, win: int, dilation: int = 1,
                     fwd: bool = True, scale: float = 1.0) -> torch.Tensor:
    """Plain torch twin of the d_frame kernel, summed in f32, times
    `scale`, in the input dtype: d_frame[y,x] = sum_q g[y+qy,x+qx,q] *
    ref[y+qy, x+qx], as explicit shifted products."""
    b, h, w, c = ref.shape
    pad = (win - 1) // 2 * dilation
    gf, r = g.float(), ref.float()
    d_frame_p = torch.zeros(b, h + 2 * pad, w + 2 * pad, c, dtype=torch.float32,
                            device=ref.device)
    for q, (qy, qx) in enumerate(displacements(win, dilation, fwd)):
        d_frame_p[:, pad - qy:pad - qy + h, pad - qx:pad - qx + w] += gf[..., q:q + 1] * r
    d_frame = d_frame_p[:, pad:pad + h, pad:pad + w]
    return (d_frame * scale).to(ref.dtype)


def cost_volume_backward_reference(g: torch.Tensor, ref: torch.Tensor,
                                   frame: torch.Tensor, win: int, dilation: int = 1,
                                   fwd: bool = True, scale: float = 1.0
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the backward kernels: for the output gradient
    `g` (B, H, W, win*win), explicit shifted products summed in f32,
    times `scale`, in the input dtype (no autograd):
      d_ref[y,x]   = sum_q g[y,x,q]       * frame[y-qy, x-qx]   (dref_form)
      d_frame[y,x] = sum_q g[y+qy,x+qx,q] * ref[y+qy, x+qx]     (dframe_reference)"""
    return (dref_form(g, frame, win, dilation, fwd, scale),
            dframe_reference(g, ref, win, dilation, fwd, scale))


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
    _check_inputs(ref, frame, win)
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


def _check_window(win: int) -> None:
    if win not in KERNEL_WINDOWS:
        raise ValueError(f"cost_volume kernel: win {win} not in {KERNEL_WINDOWS}")


def _check_inputs(ref, frame, win):
    _check_window(win)
    for name, t in (("ref", ref), ("frame", frame)):
        check_kernel_input(f"cost_volume {name}", t, ref.shape, ref.dtype)


def _check_grad_inputs(g, other, win):
    _check_window(win)
    check_kernel_input("cost_volume input", other, other.shape, other.dtype)
    check_kernel_input("cost_volume grad", g, tuple(other.shape[:3]) + (win * win,), other.dtype)


def _fwd_kernel(ref, frame, win, dilation, fwd, scale):
    """K1 on CUDA tensors: `b2f::cost_volume`'s CUDA implementation."""
    _check_inputs(ref, frame, win)
    return _launch(_FWD, ref, frame, win * win, win, dilation, fwd, scale)


def _dref_kernel(g, frame, win, dilation, fwd, scale):
    """K2 on CUDA tensors: `b2f::cost_volume_dref`'s CUDA implementation."""
    _check_grad_inputs(g, frame, win)
    return _launch(_DREF, g, frame, frame.shape[-1], win, dilation, fwd, scale)


def _dframe_kernel(g, ref, win, dilation, fwd, scale):
    """K3 on CUDA tensors: `b2f::cost_volume_dframe`'s CUDA implementation."""
    _check_grad_inputs(g, ref, win)
    return _launch(_DFRAME, g, ref, ref.shape[-1], win, dilation, fwd, scale)


# the twins are looked up when called (a test counts their calls)
_CV_SCHEMA = "(Tensor {}, Tensor {}, int win, int dilation, bool fwd, float scale) -> Tensor"
_COST_VOLUME = define(
    "cost_volume", _CV_SCHEMA.format("ref", "frame"), lambda *a: cost_volume_reference(*a),
    _fwd_kernel,
    lambda ref, frame, win, dilation, fwd, scale: ref.new_empty((*ref.shape[:3], win * win)))
_DREF_OP = define(
    "cost_volume_dref", _CV_SCHEMA.format("g", "frame"), lambda *a: dref_form(*a),
    _dref_kernel, lambda g, frame, win, dilation, fwd, scale: torch.empty_like(frame))
_DFRAME_OP = define(
    "cost_volume_dframe", _CV_SCHEMA.format("g", "ref"), lambda *a: dframe_reference(*a),
    _dframe_kernel, lambda g, ref, win, dilation, fwd, scale: torch.empty_like(ref))


class _CostVolumeGrad(torch.autograd.Function):
    """`b2f::cost_volume`'s Autograd kernel (`register_function`): the op
    below autograd; d_ref by K2 and d_frame by K3, each only where it is
    needed, or the twins on the plain route, which the forward records;
    `scale` folded in."""

    @staticmethod
    def forward(ctx, ref, frame, win, dilation, fwd, scale):
        ctx.args = (win, dilation, fwd, scale)
        ctx.plain = plain_active()
        ctx.save_for_backward(ref, frame)
        return below_autograd(torch.ops.b2f.cost_volume.default, ref, frame, win, dilation, fwd,
                              scale)

    @staticmethod
    def backward(ctx, g):
        ref, frame = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        g = g.to(ref.dtype).contiguous()
        if ctx.plain:
            d_ref, d_frame = cost_volume_backward_reference(g, ref, frame, *ctx.args)
        else:
            d_ref = _DREF_OP(g, frame, *ctx.args) if need[0] else None
            d_frame = _DFRAME_OP(g, ref, *ctx.args) if need[1] else None
        return d_ref if need[0] else None, d_frame if need[1] else None, \
            None, None, None, None


register_function("cost_volume", _CostVolumeGrad)


def cost_volume_backward_cuda_cores(g: torch.Tensor, ref: torch.Tensor, frame: torch.Tensor,
                                    win: int, dilation: int = 1, fwd: bool = True,
                                    scale: float = 1.0, need: Tuple[bool, bool] = (True, True)
                                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward on the CUDA-core kernels, f32 or bf16, CUDA tensors
    only (no autograd): (d_ref, d_frame), each None where `need` says so;
    the bf16 design that the tensor-core kernels of `b2f::cost_volume_dref`
    and `b2f::cost_volume_dframe` replaced, kept to compare the two on the
    card."""
    _check_inputs(ref, frame, win)
    _check_grad_inputs(g, ref, win)
    c = ref.shape[-1]
    d_ref = _launch(_DREF_CUDA_CORES, g, frame, c, win, dilation, fwd, scale) if need[0] else None
    d_frame = (_launch(_DFRAME_CUDA_CORES, g, ref, c, win, dilation, fwd, scale) if need[1]
               else None)
    return d_ref, d_frame


def cost_volume(ref: torch.Tensor, frame: torch.Tensor, win: int,
                dilation: int = 1, fwd: bool = True,
                scale: float = 1.0) -> torch.Tensor:
    """Single-frame cost volume term, times `scale` (1: unnormalised, as
    the JAX `cost_volume`), differentiable in `ref` and `frame`: the op
    `b2f::cost_volume`, the CUDA kernels on CUDA tensors, the twins on
    CPU tensors."""
    if ref.shape != frame.shape or ref.dim() != 4:
        raise ValueError(f"expected two equal NHWC shapes, got "
                         f"{tuple(ref.shape)} vs {tuple(frame.shape)}")
    if win % 2 != 1 or dilation < 1:
        raise ValueError(f"win must be odd and dilation >= 1, got "
                         f"win={win} dilation={dilation}")
    if use_kernel(ref) and frame.device != ref.device:
        raise ValueError(f"ref on {ref.device}, frame on {frame.device}")
    return _COST_VOLUME(ref, frame, win, dilation, fwd, scale)


def cost_volume_multi(ref: torch.Tensor, frames: Sequence[torch.Tensor],
                      win: int, fwd: bool = True, comm: Optional[Comm] = None) -> torch.Tensor:
    """Multi-frame cost volume w.r.t. `ref`, normalised by C * len(frames).

    `frames[k]` is the frame at temporal distance k+1 from the reference
    (future if fwd, past otherwise); its displacements are dilated by k+1
    and mirrored for past frames (CostVolMulti.lua:62-74). The
    normalisation is applied inside each term (one pass per frame).
    With `comm`, the inputs are row bands (module docstring)."""
    scale = 1.0 / (ref.shape[-1] * len(frames))
    acc = None
    for k, frame in enumerate(frames):
        if comm is None:
            cv = cost_volume(ref, frame, win, dilation=k + 1, fwd=fwd, scale=scale)
        else:
            p = (win - 1) // 2 * (k + 1)
            cv = cost_volume(F.pad(ref, (0, 0, 0, 0, p, p)), halo_rows(frame, p, comm), win,
                             dilation=k + 1, fwd=fwd, scale=scale)[:, p:p + ref.shape[1]]
        acc = cv if acc is None else acc + cv
    return acc
