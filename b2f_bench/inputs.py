"""Seeded input triplets, rendered on the device.

The benchmark's own copy of the RoamingImages renderer (the program's
data/roaming.py `render_scene`): per scene, a smooth random background
texture drifting at a constant velocity and foreground rectangles with
textures of their own moving linearly over it, painted back to front,
every frame sampled bilinearly at sub-pixel offsets, so that the frames
carry real, fractional motion and occlusions. Textures are sums of
random fields at blob sizes 64, 16 and 4 pixels, upsampled bilinearly
and stretched to [0, 1]. Every scene has the same number of layers, so
every seed does the same work. The frames are normalised as the
program's loader normalises them (ImageNet mean and std) and stacked
along channels: (N, H, W, 3 * frames), float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .weights import sub_seed

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OCTAVES = ((64, 1.0), (16, 0.5), (4, 0.25))


def _textures(gen, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 3, h, w) smooth random RGB fields in [0, 1]."""
    tex = torch.zeros(n, 3, h, w, device=device)
    for blob, amp in OCTAVES:
        coarse = torch.rand(n, 3, max(h // blob, 2), max(w // blob, 2), generator=gen,
                            device=device)
        tex += amp * F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)
    lo = tex.amin(dim=(1, 2, 3), keepdim=True)
    hi = tex.amax(dim=(1, 2, 3), keepdim=True)
    return (tex - lo) / (hi - lo).clamp_min(1e-6)


def _sample(tex: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """tex (n, 3, th, tw) at pixel coordinates ys (n, h) and xs (n, w),
    bilinear, clamped to the border: (n, 3, h, w)."""
    th, tw = tex.shape[-2:]
    gy = (ys.clamp(0, th - 1) / (th - 1) * 2 - 1)[:, :, None].expand(-1, -1, xs.shape[1])
    gx = (xs.clamp(0, tw - 1) / (tw - 1) * 2 - 1)[:, None, :].expand(-1, ys.shape[1], -1)
    grid = torch.stack([gx, gy], dim=-1)
    return F.grid_sample(tex, grid, mode="bilinear", padding_mode="border", align_corners=True)


def render(seed: int, n: int, height: int, width: int, frames: int, layers: int,
           max_speed: float, device, block: int = 16) -> torch.Tensor:
    """`n` scenes of `frames` frames drawn from `seed`: (n, H, W, 3F)
    normalised float32 on `device`, rendered `block` scenes at a time."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "inputs"))
    out = torch.empty(n, height, width, 3 * frames, device=device)
    mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)
    rc = (frames - 1) // 2
    margin = int(max_speed * rc) + 2
    ys = torch.arange(height, dtype=torch.float32, device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    for s0 in range(0, n, block):
        m = min(block, n - s0)

        def uniform(lo, hi, *shape):
            return lo + (hi - lo) * torch.rand(m, *shape, generator=gen, device=device)

        bg = _textures(gen, m, height + 2 * margin, width + 2 * margin, device)
        bg_v = uniform(-max_speed / 2, max_speed / 2, 2)               # (vx, vy)
        lh = uniform(height / 4, height / 2, layers).floor()
        lw = uniform(width / 4, width / 2, layers).floor()
        tex = _textures(gen, m * layers, height // 2, width // 2, device).view(
            m, layers, 3, height // 2, width // 2)
        p0 = torch.stack([uniform(0, 1, layers) * (width - lw / 2) - lw / 4,
                          uniform(0, 1, layers) * (height - lh / 2) - lh / 4], dim=-1)
        v = uniform(-max_speed, max_speed, layers, 2)
        for t in range(-rc, frames - rc):
            frame = _sample(bg, ys[None] + margin - bg_v[:, 1:2] * t,
                            xs[None] + margin - bg_v[:, 0:1] * t)
            for k in reversed(range(layers)):      # back to front: layer 0 is the nearest
                ly = ys[None] - (p0[:, k, 1:2] + v[:, k, 1:2] * t)
                lx = xs[None] - (p0[:, k, 0:1] + v[:, k, 0:1] * t)
                cover = (((ly >= 0) & (ly <= lh[:, k:k + 1] - 1))[:, :, None]
                         & ((lx >= 0) & (lx <= lw[:, k:k + 1] - 1))[:, None, :])
                patch = _sample(tex[:, k], ly, lx)
                frame = torch.where(cover[:, None], patch, frame)
            f = t + rc
            out[s0:s0 + m, ..., 3 * f:3 * f + 3] = ((frame - mean) / std).permute(0, 2, 3, 1)
    return out
