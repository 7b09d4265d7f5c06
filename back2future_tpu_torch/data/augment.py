"""Host-side augmentation (pure NumPy, HWC with 3F stacked channels).

Photometric pipeline semantics follow the reference's fb.resnet-style
transforms generalized to 3F-channel stacks (transforms.lua:195-328):
per-3-channel-group grayscale/brightness/contrast/saturation applied in a
random order, AlexNet PCA lighting, ImageNet color normalization
(mean/std and PCA constants: donkey.lua:35-46).

Geometric pipeline semantics follow trainHook (donkey.lua:269-354):
coupled flips with flow-sign fixes, per-frame rotations r1 ± f*r2 with a
rotation-induced flow field, per-frame translations ±f*t, random scale in
[1,2) with flow-magnitude scaling, random crop.

All randomness flows through an explicit `np.random.Generator` so samples
are reproducible per worker seed (data.lua:32-37 seeds each donkey with
manualSeed+idx).

The port's copy of back2future_tpu/data/augment.py, on its NumPy paths
only: `preprocess` is the NumPy branch of augment.py:136-140 (the JAX
package's native photometric kernel is not copied), drawing the same rng
stream in the same order. tests/test_torch_data.py holds every function
bit for bit against the JAX package with its native library off.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# ImageNet statistics (donkey.lua:35-38)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# AlexNet PCA lighting constants (donkey.lua:39-46)
PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]], np.float32)


# ------------------------------------------------------------------ photometric

def color_normalize(img: np.ndarray,
                    mean: np.ndarray = IMAGENET_MEAN,
                    std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    """(img - mean) / std per 3-channel frame group (transforms.lua:33-45)."""
    f = img.shape[-1] // 3
    out = img - np.tile(mean, f)
    out /= np.tile(std, f)
    return out


def _luma_groups(img: np.ndarray) -> np.ndarray:
    """Per-group Rec601 luma, (H, W, F) (transforms.lua:227-235)."""
    h, w, c = img.shape
    g = img.reshape(h, w, c // 3, 3)
    return g[..., 0] * 0.299 + g[..., 1] * 0.587 + g[..., 2] * 0.114


# reference jitter strengths (donkey.lua:161-166)
JITTER_VAR = 0.02
PCA_ALPHASTD = 0.1


def jitter_brightness(img, var, rng):
    # blend toward zero == plain scale (consumes the same rng draw)
    return img * float(1.0 + rng.normal(0, var))


def jitter_contrast(img, var, rng):
    h, w, c = img.shape
    # each group blends toward the mean of its own gray channel; the
    # target is a per-group scalar — broadcast it instead of
    # materializing a full-size target array
    means = _luma_groups(img).mean(axis=(0, 1))
    alpha = float(1.0 + rng.normal(0, var))
    out = img * alpha
    out.reshape(h, w, c // 3, 3)[...] += (
        means * (1.0 - alpha)).astype(img.dtype)[None, None, :, None]
    return out


def jitter_saturation(img, var, rng):
    h, w, c = img.shape
    alpha = float(1.0 + rng.normal(0, var))
    out = img * alpha
    out.reshape(h, w, c // 3, 3)[...] += (
        _luma_groups(img) * (1.0 - alpha))[..., None]
    return out


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = JITTER_VAR, contrast: float = JITTER_VAR,
                 saturation: float = JITTER_VAR) -> np.ndarray:
    """Brightness/contrast/saturation in a random order
    (transforms.lua:292-328 with donkey.lua:161-166 strengths)."""
    ops = [lambda x: jitter_brightness(x, brightness, rng),
           lambda x: jitter_contrast(x, contrast, rng),
           lambda x: jitter_saturation(x, saturation, rng)]
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return img


def pca_lighting(img: np.ndarray, rng: np.random.Generator,
                 alphastd: float = PCA_ALPHASTD) -> np.ndarray:
    """AlexNet PCA lighting noise, same RGB shift added to every frame
    group (transforms.lua:195-217)."""
    if alphastd == 0:
        return img
    alpha = rng.normal(0, alphastd, size=3).astype(np.float32)
    rgb = (PCA_EIGVEC * alpha[None, :] * PCA_EIGVAL[None, :]).sum(axis=1)
    f = img.shape[-1] // 3
    return img + np.tile(rgb.astype(img.dtype), f)


def preprocess(img: np.ndarray, rng: np.random.Generator,
               normalize: bool = True) -> np.ndarray:
    """Training photometric pipeline (donkey.lua:158-179): colour jitter
    (a permutation, then one normal per jitter op), PCA lighting (three
    normals), then optional ImageNet normalisation."""
    img = color_jitter(img, rng)
    img = pca_lighting(img, rng)
    if normalize:
        img = color_normalize(img)
    return img


def gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                   sigma: float) -> np.ndarray:
    """Additive noise with the reference's in-range *gate* — out-of-[0,1]
    pixels are zeroed, not clipped (donkey.lua:259-266)."""
    noisy = img + rng.standard_normal(img.shape).astype(img.dtype) * sigma
    gate = ((noisy >= 0) & (noisy <= 1)).astype(img.dtype)
    return noisy * gate


# ------------------------------------------------------------------ geometric

def rotate_nearest(img: np.ndarray, angle: float) -> np.ndarray:
    """Rotate (H,W,C) about the center, nearest sampling, zero fill —
    torch `image.rotate(..., 'simple')` semantics used by trainHook."""
    if angle == 0.0:
        return img
    h, w = img.shape[:2]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ca, sa = np.cos(angle), np.sin(angle)
    xs = ca * (xx - cx) + sa * (yy - cy) + cx
    ys = -sa * (xx - cx) + ca * (yy - cy) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.zeros_like(img)
    out[valid] = img[yi[valid], xi[valid]]
    return out


def translate(img: np.ndarray, tx: float, ty: float) -> np.ndarray:
    """Integer-pixel translate with zero fill (torch image.translate)."""
    txi, tyi = int(round(tx)), int(round(ty))
    out = np.zeros_like(img)
    h, w = img.shape[:2]
    ys0, ys1 = max(0, tyi), min(h, h + tyi)
    xs0, xs1 = max(0, txi), min(w, w + txi)
    out[ys0:ys1, xs0:xs1] = img[ys0 - tyi:ys1 - tyi, xs0 - txi:xs1 - txi]
    return out


def rotation_flow_field(h: int, w: int, r2: float) -> np.ndarray:
    """Flow induced by an inter-frame rotation delta r2 about the image
    center (donkey.lua:297-305): u(y) = (y+1 - H/2)*r2, v(x) = -(x+1 - W/2)*r2
    (+1 keeps the reference's 1-based pixel convention)."""
    u = ((np.arange(h, dtype=np.float32) + 1.0) - h / 2.0) * r2
    v = -(((np.arange(w, dtype=np.float32) + 1.0) - w / 2.0) * r2)
    out = np.empty((h, w, 2), np.float32)
    out[..., 0] = u[:, None]
    out[..., 1] = v[None, :]
    return out


def rotate_flow_vectors(flow: np.ndarray, angle: float) -> np.ndarray:
    """Rotate flow *vectors* by -angle (donkey.lua:309-313). Scalars are
    python floats (weak NumPy promotion) so f32 flow stays f32 — an
    np.float64 scalar would silently promote the whole downstream flow
    pipeline to f64."""
    u, v = flow[..., 0], flow[..., 1]
    ca, sa = float(np.cos(angle)), float(np.sin(angle))
    fu = ca * u + sa * v
    fv = -sa * u + ca * v
    return np.stack([fu, fv], axis=-1)


@dataclasses.dataclass
class GeometricParams:
    """Sampled augmentation parameters (for reproducibility/testing)."""
    hflip: bool
    vflip: bool
    tx: float
    ty: float
    r1: float
    r2: float
    scale: float
    crop_y: int
    crop_x: int


def sample_geometric(rng: np.random.Generator, ih: int, iw: int,
                     oh: int, ow: int) -> GeometricParams:
    """Sample the trainHook augmentation parameters (donkey.lua:276-351)."""
    hflip = rng.random() > 0.5
    vflip = rng.random() > 0.5
    tx, ty = 10.0 * rng.random(2)
    r1 = rng.uniform(-0.2, 0.2)
    r2 = rng.uniform(-0.1, 0.1)
    sc = rng.uniform(1.0, 2.0)
    sh, sw = int(round(ih * sc)), int(round(iw * sc))
    crop_y = int(np.floor(rng.uniform(1, max(sh - oh, 1 + 1e-6))))
    crop_x = int(np.floor(rng.uniform(1, max(sw - ow, 1 + 1e-6))))
    return GeometricParams(hflip, vflip, tx, ty, r1, r2, sc, crop_y, crop_x)


def augment_sample(frames: list, flow: np.ndarray, occ: np.ndarray,
                   mask: np.ndarray, params: GeometricParams,
                   ref0: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Apply the geometric augmentation (donkey.lua:269-354).

    frames: list of (H,W,3) images; ref0: 0-based reference frame index.
    Returns (images stacked HxWx3F, flow, occ, mask) after flips,
    rotation/translation, scale and crop — photometric jitter is applied
    by the caller afterwards, matching the reference order.
    """
    from .resample import resize

    h, w = frames[0].shape[:2]

    if params.hflip:
        frames = [f[:, ::-1] for f in frames]
        flow = flow[:, ::-1].copy()
        flow[..., 0] *= -1
        occ = occ[:, ::-1]
        mask = mask[:, ::-1]
    if params.vflip:
        frames = [f[::-1] for f in frames]
        flow = flow[::-1].copy()
        flow[..., 1] *= -1
        occ = occ[::-1]
        mask = mask[::-1]

    # rotation-induced flow, raster rotation, vector rotation
    flow = flow + rotation_flow_field(h, w, params.r2)
    flow = rotate_nearest(flow, params.r1)
    flow = rotate_flow_vectors(flow, params.r1)

    frames = list(frames)
    nf = len(frames)
    frames[ref0] = rotate_nearest(frames[ref0], params.r1)
    mask = rotate_nearest(mask[..., None] if mask.ndim == 2 else mask, params.r1)
    win = (nf - 1) // 2 if nf > 2 else 1
    for f in range(1, win + 1):
        if nf > 2:
            past = rotate_nearest(frames[ref0 - f], params.r1 - f * params.r2)
            frames[ref0 - f] = translate(past, -f * params.tx, -f * params.ty)
        if ref0 + f < nf:
            fut = rotate_nearest(frames[ref0 + f], params.r1 + f * params.r2)
            frames[ref0 + f] = translate(fut, f * params.tx, f * params.ty)

    flow = flow.copy()
    flow[..., 0] += params.tx
    flow[..., 1] += params.ty

    images = np.concatenate(frames, axis=-1)

    # random scale in [1,2): flow magnitudes scale with the raster
    # (donkey.lua:339-345)
    if params.scale != 1.0:
        sh, sw = int(round(h * params.scale)), int(round(w * params.scale))
        images = resize(images, sh, sw, "bilinear")
        mask = resize(mask, sh, sw, "bilinear")
        occ = resize(occ, sh, sw, "simple")
        flow = resize(flow, sh, sw, "bilinear") * params.scale

    return images, flow, occ, (mask[..., 0] if mask.ndim == 3 else mask)


def _frame_transforms(params: GeometricParams, nf: int, ref0: int):
    """Per-frame (angle, int_shift) exactly as augment_sample applies
    them: r1 for the reference, r1 ± f*r2 and ±f*(tx,ty) for neighbors
    (donkey.lua:293-325)."""
    angles = {ref0: params.r1}
    shifts = {ref0: (0, 0)}
    win = (nf - 1) // 2 if nf > 2 else 1
    for f in range(1, win + 1):
        if nf > 2:
            angles[ref0 - f] = params.r1 - f * params.r2
            shifts[ref0 - f] = (int(round(-f * params.tx)),
                                int(round(-f * params.ty)))
        if ref0 + f < nf:
            angles[ref0 + f] = params.r1 + f * params.r2
            shifts[ref0 + f] = (int(round(f * params.tx)),
                                int(round(f * params.ty)))
    return angles, shifts


def augment_sample_cropped(frames: list, flow: np.ndarray, occ: np.ndarray,
                           mask: np.ndarray, params: GeometricParams,
                           ref0: int, lh: int, lw: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
    """augment_sample + the load crop, evaluated only on the crop's
    preimage windows — bit-identical results at a fraction of the work.

    The slow path materializes every stage at full (then scaled, up to
    2x) resolution and crops last; this path walks the crop window
    backwards through scale -> translate -> rotate -> flip, evaluating
    each stage only where the next one reads (the windowed transforms of
    data/resample.py). Flips fold into the
    gather indices, integer translations into window offsets, and the
    rotation-induced flow field is evaluated analytically at the
    rotation's source coordinates. Exactness is tested against
    augment_sample in tests/test_torch_data.py."""
    from .resample import (resize_bilinear_window, resize_nearest_window,
                           rotate_nearest_window)

    h, w = frames[0].shape[:2]
    hf, vf = params.hflip, params.vflip
    sc = params.scale
    sh, sw = ((int(round(h * sc)), int(round(w * sc)))
              if sc != 1.0 else (h, w))
    # load-crop origin, with train_sample's clamping; slices may come up
    # short when the scaled image is smaller than the crop (mirrors the
    # slow path's short slices)
    y0 = min(params.crop_y, max(sh - lh, 0))
    x0 = min(params.crop_x, max(sw - lw, 0))
    lh = min(lh, sh - y0)
    lw = min(lw, sw - x0)

    # rotation-stage window: preimage of the crop under the align-corners
    # bilinear scale ((h,w) -> (sh,sw)), plus the +1 bilinear neighbor
    if sc != 1.0:
        sy = (h - 1) / max(sh - 1, 1)
        sx = (w - 1) / max(sw - 1, 1)
        ry0 = int(np.floor(y0 * sy))
        rx0 = int(np.floor(x0 * sx))
        ry1 = min(int(np.floor((y0 + lh - 1) * sy)) + 2, h)
        rx1 = min(int(np.floor((x0 + lw - 1) * sx)) + 2, w)
    else:
        ry0, rx0, ry1, rx1 = y0, x0, y0 + lh, x0 + lw
    wh, ww = ry1 - ry0, rx1 - rx0

    def scaled(buf, mode="bilinear"):
        """Crop window of the (sh,sw)-scaled virtual plane of `buf`
        (a (wh,ww,C) window buffer at offset (ry0,rx0))."""
        if sc == 1.0:
            return buf
        if mode == "bilinear":
            return resize_bilinear_window(buf, h, w, sh, sw, y0, x0, lh, lw,
                                          by0=ry0, bx0=rx0)
        raise AssertionError(mode)

    # frames: flips fold into the rotation gather, integer translations
    # into the window offset (the kernel zero-fills outside the image,
    # which IS translate's fill)
    angles, shifts = _frame_transforms(params, len(frames), ref0)
    rot_frames = [
        rotate_nearest_window(frames[i], angles[i],
                              ry0 - shifts[i][1], rx0 - shifts[i][0],
                              wh, ww, hf, vf)
        for i in range(len(frames))]
    images = scaled(np.concatenate(rot_frames, axis=-1))

    # flow: gather raw flow at the rotation source, fix flip signs, add
    # the rotation-induced field evaluated at the source coords, rotate
    # the vectors, add the translation, then scale (x magnitude)
    fw = rotate_nearest_window(flow, params.r1, ry0, rx0, wh, ww, hf, vf)
    if hf:
        fw[..., 0] *= -1
    if vf:
        fw[..., 1] *= -1
    yg = np.arange(ry0, ry1, dtype=np.int64)[:, None]
    xg = np.arange(rx0, rx1, dtype=np.int64)[None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ca, sa = np.cos(params.r1), np.sin(params.r1)
    xs = ca * (xg - cx) + sa * (yg - cy) + cx
    ys = -sa * (xg - cx) + ca * (yg - cy) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    # rotation_flow_field's arithmetic, at the gathered source coords
    fu = ((yi.astype(np.float32) + 1.0) - h / 2.0) * params.r2
    fv = -(((xi.astype(np.float32) + 1.0) - w / 2.0) * params.r2)
    okf = ok.astype(np.float32)
    fw[..., 0] += fu * okf
    fw[..., 1] += fv * okf
    u, v = fw[..., 0], fw[..., 1]
    caf, saf = float(ca), float(sa)  # python-float scalars: keep f32
    fw = np.stack([caf * u + saf * v, -saf * u + caf * v], axis=-1)
    fw[..., 0] += params.tx
    fw[..., 1] += params.ty
    flow_out = scaled(fw)
    if sc != 1.0:
        flow_out = flow_out * sc

    # mask: rotated by r1 (no translate), bilinear-scaled
    m3 = mask[..., None] if mask.ndim == 2 else mask
    mw = rotate_nearest_window(m3, params.r1, ry0, rx0, wh, ww, hf, vf)
    mask_out = scaled(mw)[..., 0]

    # occ: flipped + nearest-scaled only (augment_sample never rotates or
    # translates it — reference quirk)
    if sc != 1.0:
        occ_out = resize_nearest_window(occ, sh, sw, y0, x0, lh, lw, hf, vf)
    else:
        occ_f = occ[:, ::-1] if hf else occ
        occ_f = occ_f[::-1] if vf else occ_f
        occ_out = np.ascontiguousarray(occ_f[y0:y0 + lh, x0:x0 + lw])

    return images, flow_out, occ_out, mask_out
