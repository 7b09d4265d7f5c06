"""Minimal PNG codec with full 16-bit support (zlib + NumPy + C++ filters).

The port's copy of back2future_tpu/io/png16.py. PIL silently truncates
16-bit RGB PNGs to 8 bits, which destroys KITTI flow maps (they encode
flow as `(v*65535 - 2^15)/64` per channel — reference:
flowExtensions.lua:315-323). This module decodes/encodes non-interlaced
8/16-bit grayscale and RGB(A) PNGs exactly. Scanline de-filtering (the
byte-sequential part) and the encoder's Up filter run in
runtime/src/pngfilter.cc, built by runtime/host_build.py; a failed build
raises. `_defilter_python` (png16.py:24-56) stays as the oracle the
tests hold the C++ loop against: its Average and Paeth branches loop per
byte, far too slow for real images.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..runtime.host_build import load_library

_PNG_SIG = b"\x89PNG\r\n\x1a\n"

# color type -> number of channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _defilter_python(lines: np.ndarray, ftypes: np.ndarray, bpp: int) -> None:
    """Pure-Python PNG scanline reconstruction (in place): the oracle of
    the C++ de-filter."""
    h, stride = lines.shape
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        line = lines[y].astype(np.int32)
        ft = int(ftypes[y])
        if ft == 0:
            pass
        elif ft == 1:  # Sub — per-lane prefix sum mod 256
            n = stride // bpp
            lanes = line[: n * bpp].reshape(n, bpp)
            line[: n * bpp] = np.cumsum(lanes, axis=0).reshape(-1) & 0xFF
        elif ft == 2:  # Up
            line = (line + prev) & 0xFF
        elif ft == 3:  # Average
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else 0
                line[x] = (line[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for x in range(stride):
                a = line[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ft}")
        lines[y] = line.astype(np.uint8)
        prev = line


def _defilter(lines: np.ndarray, ftypes: np.ndarray, bpp: int) -> None:
    lib = load_library("pngfilter")
    rc = lib.b2f_png_defilter(
        lines.ctypes.data_as(np.ctypeslib.ctypes.c_void_p),
        ftypes.ctypes.data_as(np.ctypeslib.ctypes.c_void_p),
        np.ctypeslib.ctypes.c_int64(lines.shape[0]),
        np.ctypeslib.ctypes.c_int64(lines.shape[1]),
        np.ctypeslib.ctypes.c_int64(bpp),
    )
    if rc != 0:
        raise ValueError("bad PNG filter type")


def read_png(path) -> np.ndarray:
    """Decode a PNG file to an (H, W, C) uint8 or uint16 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")

    pos = 8
    ihdr = None
    idat = []
    palette = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: missing IHDR")
    width, height, depth, color, _comp, _filt, interlace = ihdr
    if interlace != 0:
        raise NotImplementedError("interlaced PNG not supported")
    if depth not in (8, 16):
        raise NotImplementedError(f"bit depth {depth} not supported")
    nch = _CHANNELS[color]
    bpp = max(1, nch * depth // 8)  # bytes per pixel (>=1 for filtering)
    stride = (width * nch * depth + 7) // 8

    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    expect = height * (stride + 1)
    if raw.size != expect:
        raise ValueError(f"{path}: bad IDAT size {raw.size} != {expect}")
    raw = raw.reshape(height, stride + 1)
    ftypes = np.ascontiguousarray(raw[:, 0])
    lines = np.ascontiguousarray(raw[:, 1:])
    _defilter(lines, ftypes, bpp)

    if depth == 16:
        img = lines.view(">u2").reshape(height, width, nch).astype(np.uint16)
    else:
        img = lines.reshape(height, width, nch)
    if color == 3:  # palette
        img = palette[img[..., 0]]
    return img


def write_png(path, img: np.ndarray) -> None:
    """Encode an (H, W) or (H, W, C) uint8/uint16 array as a PNG file."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    if img.dtype == np.uint16:
        depth = 16
        rows = np.ascontiguousarray(img.astype(">u2")).view(np.uint8).reshape(h, -1)
    elif img.dtype == np.uint8:
        depth = 8
        rows = np.ascontiguousarray(img).reshape(h, -1)
    else:
        raise TypeError(f"dtype {img.dtype} not supported (uint8/uint16)")
    stride = rows.shape[1]

    out = np.empty((h, stride + 1), np.uint8)
    load_library("pngfilter").b2f_png_filter_up(
        rows.ctypes.data_as(np.ctypeslib.ctypes.c_void_p),
        out.ctypes.data_as(np.ctypeslib.ctypes.c_void_p),
        np.ctypeslib.ctypes.c_int64(h),
        np.ctypeslib.ctypes.c_int64(stride),
    )
    raw = out.tobytes()

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    blob = (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(blob)
