"""Library inference API: `init(...) -> FlowEstimator`, the port of
back2future_tpu/api.py (the reference's library mode, back2future.lua:47-130).

The numpy pre- and post-processing is a copy of the JAX package's
(back2future_tpu/api.py:35-102): frames are channel-stacked,
ImageNet-normalised and snapped DOWN to the /64 grid; the finest-level
flow is nearest-resized back with u scaled by W/W64 and v by H/H64, and
the occlusion softmax is thresholded at OCC_THRESHOLD. The returned flow
is in raw network units (multiply by `flownet_factor`, 20, for pixels).

The forward runs under `torch.inference_mode()` with
`with_warped=False`: the image warps feed only the training losses.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .data.augment import color_normalize
from .data.resample import resize
from .models import PWCConfig, PWCNet
from .models.pwc import DTYPES

Results = Tuple[np.ndarray, np.ndarray, np.ndarray]

OCC_THRESHOLD = 0.6666  # back2future.lua:40

# Reference pretrained-name -> converted checkpoint path (back2future.lua:100-110),
# as in back2future_tpu/api.py
PRETRAINED_PATHS = {
    "Ours-Hard": "models/RoamingImages_H",
    "Ours-Soft-ft-KITTI": "models/RoamingImages_H_KITTI_S",
    "Ours-Soft-ft-Sintel": "models/RoamingImages_H_Sintel_S",
}


def _round_down_64(x: int) -> int:
    return max(x - (x % 64), 64)


def _preprocess_triplets(frame_stacks, frames: int):
    """compute_flow preprocessing (back2future.lua:48-71): stack,
    channel-concat, ImageNet-normalise, snap to the /64 grid.

    Returns (imgs (B, H64, W64, 3F) float32, n, height, width)."""
    if len(frame_stacks) != frames:
        raise ValueError(f"model expects {frames} frames, got {len(frame_stacks)} "
                         f"image stacks")
    stacks = [np.stack([np.asarray(im, np.float32) for im in ims])
              if not isinstance(ims, np.ndarray) else
              np.asarray(ims, np.float32) for ims in frame_stacks]
    imgs = np.concatenate(stacks, axis=-1)          # (B, H, W, 3F)
    if imgs.shape[-1] != 3 * frames:
        raise ValueError(f"model expects {frames} frames ({3 * frames} channels), "
                         f"got {imgs.shape[-1]}")
    imgs = color_normalize(imgs)
    n, height, width = imgs.shape[:3]
    fine_h, fine_w = _round_down_64(height), _round_down_64(width)
    if (fine_h, fine_w) != (height, width):
        imgs = np.stack([resize(im, fine_h, fine_w, "bilinear") for im in imgs])
    return imgs, n, height, width


def _postprocess_results(flow_b, occ_b, n: int, height: int, width: int) -> Results:
    """compute_flow postprocessing (back2future.lua:77-91): resize the
    flow back with its components rescaled, threshold and resize the
    occlusions. Models without an occlusion head (two-frame / no_occ)
    return all-False masks."""
    flow_b = np.asarray(flow_b, np.float32)[:n]
    sc_h = height / flow_b.shape[1]
    sc_w = width / flow_b.shape[2]
    flows = np.empty((n, height, width, 2), np.float32)
    fwd_occs = np.zeros((n, height, width), bool)
    bwd_occs = np.zeros((n, height, width), bool)
    occ_b = None if occ_b is None else np.asarray(occ_b, np.float32)[:n]
    for i in range(n):
        f = resize(flow_b[i], height, width, "simple")
        f[..., 0] *= sc_w
        f[..., 1] *= sc_h
        flows[i] = f
        if occ_b is None:
            continue
        # channel 1 (index 0) past/backward, channel 2 (index 1) future/forward
        fwd_occs[i] = resize((occ_b[i, ..., 1] >= OCC_THRESHOLD).astype(np.float32),
                             height, width, "simple") > 0.5
        bwd_occs[i] = resize((occ_b[i, ..., 0] >= OCC_THRESHOLD).astype(np.float32),
                             height, width, "simple") > 0.5
    return flows, fwd_occs, bwd_occs


def _numpy(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.float().cpu().numpy()


class FlowEstimator:
    """compute_flow over one PWCNet on one device."""

    def __init__(self, net: PWCNet, device: torch.device):
        self.net = net.eval()
        self.config: PWCConfig = net.cfg
        self.device = device

    def _finest(self, outputs) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        g = outputs[0]
        return _numpy(g["flow"]), _numpy(g["occ"])

    def __call__(self, *ims: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """compute_flow (back2future.lua:47-95): one (H, W, 3) image in
        [0,1] per model frame. Returns (flow (H,W,2) float32 raw network
        units, fwd_occ (H,W) bool, bwd_occ (H,W) bool)."""
        flows, fwd_occs, bwd_occs = self.compute_flow_batch(
            *(np.asarray(im, np.float32)[None] for im in ims))
        return flows[0], fwd_occs[0], bwd_occs[0]

    def compute_flow_batch(self, *frame_stacks) -> Results:
        """One argument per model frame, each (B, H, W, 3) (or a list of
        (H, W, 3) images) in [0,1]; one forward serves the whole batch.
        Returns (flows (B,H,W,2), fwd_occs (B,H,W), bwd_occs (B,H,W))."""
        imgs, n, height, width = _preprocess_triplets(frame_stacks, self.config.frames)
        with torch.inference_mode():
            x = torch.from_numpy(imgs).to(self.device)
            flow, occ = self._finest(self.net(x, with_warped=False))
        return _postprocess_results(flow, occ, n, height, width)

    def compute_flow_video(self, frames) -> Results:
        """`frames` is a whole (N, H, W, 3) sequence in [0,1] (or a list of
        (H, W, 3) images), N >= frames. Results for all N-F+1 sliding
        F-frame windows, each equal to compute_flow on that window, with
        every frame's feature pyramid computed once. Window t covers
        frames[t:t+F], flow at its reference (centre) frame."""
        F = self.config.frames
        arr = (np.asarray(frames, np.float32) if isinstance(frames, np.ndarray)
               else np.stack([np.asarray(f, np.float32) for f in frames]))
        if arr.ndim != 4 or arr.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) video frames, got {arr.shape}")
        if arr.shape[0] < F:
            raise ValueError(f"need at least frames={F} video frames, got "
                             f"{arr.shape[0]}")
        arr = color_normalize(arr)
        n, height, width = arr.shape[:3]
        fine_h, fine_w = _round_down_64(height), _round_down_64(width)
        if (fine_h, fine_w) != (height, width):
            arr = np.stack([resize(im, fine_h, fine_w, "bilinear") for im in arr])
        w = n - F + 1
        with torch.inference_mode():
            frames_t = torch.from_numpy(arr).to(self.device)
            cs_all = self.net.pyramid(frames_t)
            cs = {f: {l: feat[f - 1:f - 1 + w] for l, feat in cs_all.items()}
                  for f in range(1, F + 1)}
            x = torch.cat([frames_t[f - 1:f - 1 + w] for f in range(1, F + 1)], dim=-1)
            flow, occ = self._finest(self.net.from_pyramids(x, cs, with_warped=False))
        return _postprocess_results(flow, occ, w, height, width)


def _checkpoint(model) -> str:
    """The checkpoint path of a pretrained name or a path, as the JAX
    package resolves it; FileNotFoundError with its message when nothing
    is there."""
    path = PRETRAINED_PATHS.get(str(model), str(model))
    if not Path(path).exists():
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (for reference pretrained names, "
            f"convert the .t7 with tools/convert_t7.py first)")
    return path


def _load(path: str) -> Tuple[dict, PWCConfig]:
    """(params, PWCConfig) of the checkpoint at `path` (a model_<e> file
    or a directory, newest wins; back2future_tpu/api.py:473-487). The API
    serves the PWC family only: another netType raises the JAX package's
    ValueError from the options alone, before any module is built."""
    from .train.checkpoint import checkpoint_options, load_model_checkpoint, resolve_checkpoint

    file = resolve_checkpoint(path)
    opt = checkpoint_options(file)
    if opt is not None and opt.netType == "spynet":
        raise ValueError(
            f"checkpoint at {path!r} was trained with netType="
            f"SPyNetConfig; load() serves the PWC family only")
    return load_model_checkpoint(file, opt)


def init(model: Union[None, str, Path, Tuple[dict, PWCConfig]] = "Ours-Soft-ft-KITTI",
         device="cuda", dtype: str = "", seed: int = 0) -> FlowEstimator:
    """Build a FlowEstimator on `device`.

    `model` is either
      * a reference pretrained name ("Ours-Hard", "Ours-Soft-ft-KITTI",
        the default, "Ours-Soft-ft-Sintel") or a checkpoint path (a
        directory, newest model_<e> wins, or a model_<e>.pt /
        model_<e>.msgpack file, the latter written by the JAX package),
        as in the JAX package: FileNotFoundError when no checkpoint is
        there;
      * a (params, PWCConfig) pair: `params` a flax-named tree of numpy
        arrays (models.bridge) or a `state_dict`, `PWCConfig` the
        port's; or
      * None: random weights from `torch.Generator().manual_seed(seed)`,
        the flagship 3-frame config (frames 3, levels 7, win 9, skip 2).

    `dtype` ("bfloat16" / "float32") overrides the compute dtype; the
    default is the config's own (a checkpoint's options.json), and
    bfloat16 for random weights. `device` "cuda" with no card raises.
    """
    if model is not None and not isinstance(model, tuple):
        model = _load(_checkpoint(model))
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init(device='cuda'): no CUDA device is available")
    if dtype and dtype not in DTYPES:
        raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {dtype!r}")
    generator = torch.Generator().manual_seed(seed)
    if model is None:
        config = PWCConfig(dtype=DTYPES[dtype or "bfloat16"])
        net = PWCNet(config, generator=generator)
    elif len(model) == 2:
        from .train.checkpoint import load_params

        params, config = model
        if not isinstance(config, PWCConfig):
            raise TypeError(f"expected the port's PWCConfig, got {type(config)}")
        if dtype:
            config = dataclasses.replace(config, dtype=DTYPES[dtype])
        net = PWCNet(config, generator=generator)
        load_params(net, params)
    else:
        raise TypeError(f"model as a tuple must be (params, PWCConfig), got {len(model)} items")
    return FlowEstimator(net.to(device), device)
