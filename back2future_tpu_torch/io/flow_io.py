"""Optical-flow file formats (pure NumPy).

Conventions: flow arrays are (H, W, 2) float32 with channel order (u, v) =
(x-displacement, y-displacement), matching the channel order of the
reference's CHW tensors (flowExtensions.lua: channel 1 = x, channel 2 = y).

Formats (reference: flowExtensions.lua:241-332):
  .flo   Middlebury: float32 magic 202021.25, int32 w, int32 h, h*w*(u,v)
  .pfm   Sintel:     'PF'/'Pf' header, endianness from scale sign, vflipped
  .png   KITTI:      16-bit RGB; flow = (v_uint16 - 2^15)/64, ch3 = valid
  .disp  occlusion:  .flo-like single band

The port's copy of back2future_tpu/io/flow_io.py; tests/test_torch_io.py
holds the files each package writes byte for byte equal.
"""

from __future__ import annotations

import struct

import numpy as np

from .png16 import read_png, write_png

TAG_FLOAT = 202021.25


def load_flow(path):
    """Dispatch by extension (flowExtensions.lua:241-252).

    Returns (flow, valid): flow (H, W, 2) float32; valid (H, W) float32 or
    None when the format carries no validity mask.
    """
    s = str(path)
    if s.endswith(".flo"):
        return load_flo(s), None
    if s.endswith(".pfm"):
        return load_pfm(s), None
    if s.endswith(".png"):
        return load_kitti_png(s)
    raise ValueError(f"unknown flow format: {s}")


def load_flo(path) -> np.ndarray:
    with open(path, "rb") as f:
        tag = struct.unpack("<f", f.read(4))[0]
        if abs(tag - TAG_FLOAT) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {tag}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<f", TAG_FLOAT))
        f.write(struct.pack("<ii", w, h))
        f.write(np.ascontiguousarray(flow).tobytes())


def load_disp(path) -> np.ndarray:
    """Single-band .flo-like occlusion map -> (H, W) float32
    (flowExtensions.lua:152-170)."""
    with open(path, "rb") as f:
        tag = struct.unpack("<f", f.read(4))[0]
        if abs(tag - TAG_FLOAT) > 1e-3:
            raise ValueError(f"{path}: bad .disp magic {tag}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(h * w * 4), np.float32)
    return data.reshape(h, w).copy()


def write_disp(path, disp: np.ndarray) -> None:
    disp = np.asarray(disp, np.float32)
    h, w = disp.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<f", TAG_FLOAT))
        f.write(struct.pack("<ii", w, h))
        f.write(np.ascontiguousarray(disp).tobytes())


def load_pfm(path) -> np.ndarray:
    """Sintel PFM flow -> (H, W, 2) float32 (flowExtensions.lua:289-313)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        nbands = 3 if color else 1
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(h * w * nbands * 4), dtype)
    img = data.reshape(h, w, nbands)[::-1]  # PFM rows are bottom-to-top
    if nbands == 1:
        img = np.repeat(img, 2, axis=-1)
    return np.ascontiguousarray(img[..., :2]).astype(np.float32)


def write_pfm(path, flow: np.ndarray, scale: float = -1.0) -> None:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    nb = 1 if flow.ndim == 2 else flow.shape[2]
    if nb == 2:  # pad to 3 bands for 'PF'
        flow = np.concatenate([flow, np.zeros((h, w, 1), np.float32)], axis=-1)
        nb = 3
    header = b"PF\n" if nb == 3 else b"Pf\n"
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{w} {h}\n".encode())
        f.write(f"{scale}\n".encode())
        data = flow[::-1]
        f.write(np.ascontiguousarray(data, "<f4" if scale < 0 else ">f4").tobytes())


def load_kitti_png(path):
    """KITTI 16-bit flow PNG -> ((H, W, 2) flow, (H, W) valid)
    (flowExtensions.lua:315-323)."""
    img = read_png(path)
    if img.dtype != np.uint16 or img.shape[-1] < 3:
        raise ValueError(f"{path}: expected 16-bit 3-channel KITTI flow PNG")
    raw = img.astype(np.float32)
    flow = (raw[..., :2] - 2.0 ** 15) / 64.0
    valid = (raw[..., 2] > 0).astype(np.float32)
    return flow, valid


def write_kitti_png(path, flow: np.ndarray, valid=None) -> None:
    flow = np.asarray(flow, np.float32)
    h, w, _ = flow.shape
    if valid is None:
        valid = np.ones((h, w), np.float32)
    enc = np.zeros((h, w, 3), np.uint16)
    q = np.clip(flow * 64.0 + 2.0 ** 15, 0, 65535)
    enc[..., :2] = q.astype(np.uint16)
    enc[..., 2] = (np.asarray(valid) > 0).astype(np.uint16)
    write_png(path, enc)
