"""Per-sample loading hooks: the trainHook/testHook pipeline.

Rebuilds the reference donkey hooks (donkey.lua:183-392 train,
donkey.lua:433-513 test) as pure functions of a `SampleSpec` and an
explicit RNG:

  load frame window -> gt flow/valid + 2-channel occlusion (or zero-flow /
  0.5-occ placeholders) -> optional gaussian noise -> [augment: flips,
  rotations/translations, scale, crop, photometric jitter | normalize
  only] -> flow / flownet_factor -> make_data (optional global scale,
  random-or-center crop, stack).

Outputs are NHWC-layout slices: images (H, W, 3F) float32, target
(H, W, 4) = [flow_u, flow_v, occ_frames, occ_3], mask (H, W).

The port's copy of back2future_tpu/data/sample.py, with both augmentation
paths and the `B2F_FAST_AUGMENT` switch; tests/test_torch_data.py holds
its samples bit for bit against the JAX package's NumPy path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Tuple

import numpy as np

from ..io import load_flow
from ..io.flow_io import load_disp
from .augment import (augment_sample, augment_sample_cropped,
                      color_normalize, gaussian_noise, preprocess,
                      sample_geometric)
from .manifest import SampleSpec
from .resample import resize


def _fast_augment_enabled() -> bool:
    """Windowed-augmentation fast path; B2F_FAST_AUGMENT=0 falls back to
    the full-resolution reference path (they are tested identical)."""
    return os.environ.get("B2F_FAST_AUGMENT", "1").strip().lower() not in (
        "0", "false", "no", "off")


Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """The option subset the hooks consume (from the port's config.Options)."""
    frames: int = 3
    ground_truth: bool = False
    augment: int = 0
    gaussian_noise: float = 0.0
    normalize_images: int = 1
    flownet_factor: float = 20.0
    scale: float = 1.0          # global -scale applied in make_data
    fine_height: int = 320      # crop target (opt.fineHeight/Width)
    fine_width: int = 640
    load_height: int = 320      # augmentation crop target (opt.loadSize)
    load_width: int = 640
    rand_crop: int = 1
    wire: str = "f32"           # 'compact' defers normalization to the
    #                             device and packs u8/f16 (data/wire.py)

    @classmethod
    def from_options(cls, opt) -> "SampleConfig":
        return cls(frames=opt.frames, ground_truth=opt.ground_truth,
                   augment=opt.augment, gaussian_noise=opt.gaussian_noise,
                   normalize_images=opt.normalize_images,
                   flownet_factor=opt.flownet_factor, scale=opt.scale,
                   fine_height=opt.fineHeight, fine_width=opt.fineWidth,
                   load_height=opt.loadSize[1], load_width=opt.loadSize[2],
                   rand_crop=opt.rand_crop, wire=getattr(opt, "wire", "f32"))

    @property
    def deterministic(self) -> bool:
        """True when `train_sample` consumes no rng draws that affect its
        output: no photometric/geometric augmentation, no noise, and no
        random crop (make_data only reads rng when rand_crop == 1). A
        deterministic hook's samples are pure functions of the index, so
        the loader may memoize them across epochs (PrefetchLoader)."""
        return (self.augment == 0 and self.gaussian_noise == 0
                and self.rand_crop != 1)

    @property
    def defer_normalize(self) -> bool:
        """Compact wire ships [0,1] images; ImageNet normalization moves
        into the train step (wire.decode_batch). config.derive()
        guarantees normalize_images==1 here, so the trainHook/testHook
        normalization behavior stays identical."""
        return self.wire == "compact"

    @property
    def ref0(self) -> int:
        """0-based reference frame position in the window."""
        return 0 if self.frames == 2 else (self.frames - 1) // 2


def default_image_loader(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] (donkey.lua:97-100). PNGs go through
    the port's own codec and never reach PIL; other formats (JPEG etc.)
    need PIL, imported here only, and raise a clear ImportError where it
    is not installed."""
    from ..io.png16 import read_png

    if str(path).endswith(".png"):
        img = read_png(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"{path}: only PNG frames decode without PIL, and PIL is not "
                "installed") from e

        img = np.asarray(Image.open(path).convert("RGB"))
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def load_ground_truth(spec: SampleSpec, cfg: SampleConfig,
                      h: int, w: int) -> Arrays:
    """gt flow + valid mask + 2-channel occlusion with 0.5 fallback
    (donkey.lua:219-257)."""
    if not cfg.ground_truth or spec.flow_pattern is None:
        flow = np.zeros((h, w, 2), np.float32)
        occ = np.full((h, w, 2), 0.5, np.float32)
        mask = np.ones((h, w), np.float32)
        return flow, occ, mask

    flow, valid = load_flow(spec.flow_path())
    fh, fw = flow.shape[:2]
    occ_n_path, occ_3_path = spec.occ_paths(cfg.frames)

    def load_occ(path):
        if path is not None and os.path.exists(path):
            return load_disp(path)
        return np.full((fh, fw), 0.5, np.float32)

    occ = np.stack([load_occ(occ_n_path), load_occ(occ_3_path)], axis=-1)
    mask = valid if valid is not None else np.ones((fh, fw), np.float32)
    return flow.astype(np.float32), occ.astype(np.float32), mask.astype(np.float32)


def _scale_flow_raster(flow: np.ndarray, oh: int, ow: int,
                       sc: float) -> np.ndarray:
    """Bilinear flow resample with magnitude rescale by the ORIGINAL
    scale factor (donkey.lua:112-118 scaleFlow: the reference passes
    float iH*scaleFactor, so its `sc = height/flow:size(2)` is exactly
    scaleFactor; deriving sc from the truncated integer raster dims here
    would instead trip its aspect-ratio assert for most resolutions)."""
    return resize(flow, oh, ow, "bilinear") * sc


def make_data(images: np.ndarray, flow: np.ndarray, occ: np.ndarray,
              mask: np.ndarray, cfg: SampleConfig,
              rng: Optional[np.random.Generator]) -> Arrays:
    """Optional global scale + random/center crop + target stack
    (donkey.lua:120-155)."""
    if cfg.scale != 1.0:
        ih, iw = images.shape[:2]
        sh, sw = int(ih * cfg.scale), int(iw * cfg.scale)
        images = resize(images, sh, sw, "bilinear")
        mask = resize(mask, sh, sw, "bilinear")
        flow = _scale_flow_raster(flow, sh, sw, cfg.scale)
        occ = resize(occ, sh, sw, "simple")

    ih, iw = images.shape[:2]
    oh, ow = cfg.fine_height, cfg.fine_width
    if ih < oh or iw < ow:
        # the reference crashes inside image.crop here (donkey.lua:358-365
        # asserts crop dims); a silent short crop would train at the wrong
        # resolution while configs/logs claim (oh, ow)
        raise ValueError(
            f"sample ({ih}x{iw}) smaller than the fine/crop size "
            f"({oh}x{ow}) — check -fineHeight/-fineWidth/-scale/-cropHeight")
    if cfg.rand_crop == 1 and rng is not None:
        y0 = int(np.floor(rng.uniform(0, max(ih - oh, 1e-6))))
        x0 = int(np.floor(rng.uniform(0, max(iw - ow, 1e-6))))
    else:  # center crop
        y0, x0 = (ih - oh) // 2, (iw - ow) // 2
    sl = np.s_[y0:y0 + oh, x0:x0 + ow]
    target = np.concatenate([flow[sl], occ[sl]], axis=-1)
    return (np.ascontiguousarray(images[sl], dtype=np.float32),
            np.ascontiguousarray(target, dtype=np.float32),
            np.ascontiguousarray(mask[sl], dtype=np.float32))


def train_sample(spec: SampleSpec, cfg: SampleConfig,
                 rng: np.random.Generator,
                 image_loader: Callable[[str], np.ndarray] = default_image_loader,
                 ) -> Arrays:
    """The trainHook (donkey.lua:183-392)."""
    frames = [image_loader(p) for p in spec.image_paths(cfg.frames)]
    h, w = frames[0].shape[:2]
    flow, occ, mask = load_ground_truth(spec, cfg, h, w)

    if cfg.gaussian_noise > 0:
        frames = [gaussian_noise(f, rng, cfg.gaussian_noise) for f in frames]

    if cfg.augment == 1:
        params = sample_geometric(rng, h, w, cfg.load_height, cfg.load_width)
        if _fast_augment_enabled():
            # windowed evaluation of augment + load crop (bit-identical
            # to the slow path below; tests/test_torch_data.py A/Bs them)
            images, flow, occ, mask = augment_sample_cropped(
                frames, flow, occ, mask, params, cfg.ref0,
                cfg.load_height, cfg.load_width)
        else:
            images, flow, occ, mask = augment_sample(
                frames, flow, occ, mask, params, cfg.ref0)
            # crop to loadSize then photometric jitter (donkey.lua:346-358)
            y0, x0 = params.crop_y, params.crop_x
            ih, iw = images.shape[:2]
            y0 = min(y0, max(ih - cfg.load_height, 0))
            x0 = min(x0, max(iw - cfg.load_width, 0))
            sl = np.s_[y0:y0 + cfg.load_height, x0:x0 + cfg.load_width]
            images, flow, occ, mask = images[sl], flow[sl], occ[sl], mask[sl]
        images = preprocess(images, rng,
                            normalize=(cfg.normalize_images == 1
                                       and not cfg.defer_normalize))
    else:
        images = np.concatenate(frames, axis=-1)
        if cfg.normalize_images == 1 and not cfg.defer_normalize:
            images = color_normalize(images)

    if cfg.flownet_factor != 1:
        flow = flow / cfg.flownet_factor

    return make_data(images, flow, occ, mask, cfg, rng)


def test_sample(spec: SampleSpec, cfg: SampleConfig,
                image_loader: Callable[[str], np.ndarray] = default_image_loader,
                ) -> Arrays:
    """The testHook: load + normalize + center crop, no jitter
    (donkey.lua:433-513). Normalization is UNCONDITIONAL here, matching
    the reference quirk (donkey.lua:510 applies ColorNormalize with no
    normalize_images guard, while trainHook's Preprocess honors the
    flag) — so -normalize_images 0 trains raw but validates normalized,
    exactly like the reference."""
    frames = [image_loader(p) for p in spec.image_paths(cfg.frames)]
    h, w = frames[0].shape[:2]
    flow, occ, mask = load_ground_truth(spec, cfg, h, w)
    if cfg.flownet_factor != 1:
        flow = flow / cfg.flownet_factor
    images = np.concatenate(frames, axis=-1)
    if not cfg.defer_normalize:
        images = color_normalize(images)
    return make_data(images, flow, occ, mask, cfg, rng=None)
