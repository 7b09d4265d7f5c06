"""Multi-frame cost volume with frame-distance displacement dilation.

Counterpart of back2future_tpu/ops/cost_volume.py; semantics of the
reference CostVolMulti (models/CostVolMulti.lua:49-108): for each window
displacement (qx, qy) of a win x win grid, dilated by the frame distance
k+1 and mirrored for past frames (`fwd=False`), the cost at reference
pixel p is sum_c ref(p) * frame(p - q), zero outside the overlap,
accumulated over frames and normalised by C * num_frames. Output channel
i enumerates qx outer, qy inner: i = qx_idx * win + qy_idx.

Layout: NHWC; output (B, H, W, win*win) in the input dtype.

`cost_volume` runs the hand-written CUDA kernel (csrc/cost_volume_fwd.cu,
the port of the Pallas `_fwd_kernel`) on CUDA tensors and its plain twin
`cost_volume_reference` on CPU tensors. Forward only: the backward
kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..runtime.cuda_build import Kernel
from .route import DTYPE_CODES, check_kernel_input, ptr, stream_ptr, use_kernel

_KERNEL = Kernel("b2f_cost_volume_fwd", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_void_p])
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


def cost_volume(ref: torch.Tensor, frame: torch.Tensor, win: int,
                dilation: int = 1, fwd: bool = True,
                scale: float = 1.0) -> torch.Tensor:
    """Single-frame cost volume term, times `scale` (1: unnormalised, as
    the JAX `cost_volume`). The CUDA kernel on CUDA tensors, the twin on
    CPU tensors."""
    if ref.shape != frame.shape or ref.dim() != 4:
        raise ValueError(f"expected two equal NHWC shapes, got "
                         f"{tuple(ref.shape)} vs {tuple(frame.shape)}")
    if win % 2 != 1 or dilation < 1:
        raise ValueError(f"win must be odd and dilation >= 1, got "
                         f"win={win} dilation={dilation}")
    if not use_kernel(ref):
        return cost_volume_reference(ref, frame, win, dilation, fwd, scale)
    if frame.device != ref.device:
        raise ValueError(f"ref on {ref.device}, frame on {frame.device}")
    if win not in KERNEL_WINDOWS:
        raise ValueError(f"cost_volume kernel: win {win} not in {KERNEL_WINDOWS}")
    b, h, w, c = ref.shape
    for name, t in (("ref", ref), ("frame", frame)):
        check_kernel_input(f"cost_volume {name}", t, ref.shape, ref.dtype)
    out = torch.empty((b, h, w, win * win), dtype=ref.dtype, device=ref.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(ref.device):
        _KERNEL(ptr(ref), ptr(frame), ptr(out), DTYPE_CODES[ref.dtype],
                b, h, w, c, win, dilation, int(fwd), scale, stream_ptr(ref.device))
    return out


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
