"""Reader of the msgpack files that flax writes (`flax.serialization.to_bytes`),
in pure Python and numpy, so that the port loads the JAX package's
`model_<e>.msgpack` / `optimState_<e>.msgpack` checkpoints
(back2future_tpu/train/checkpoint.py:34-41) without flax or the `msgpack`
package.

Flax writes a plain msgpack map (its state dict: nested maps with string
keys) whose array leaves are ext records:
  * ext 1, an ndarray: the payload is itself msgpack, the triple
    (shape, dtype name, C-order bytes);
  * ext 3, a numpy scalar: the same payload, read here as a 0-d array;
  * ext 2, a Python complex: not read (ValueError).
`bfloat16` arrays are read as uint16 and widened exactly to float32.
Arrays past flax's 1 GiB chunk limit are written as
`__msgpack_chunked_array__` maps, which this reader refuses (ValueError),
as it refuses an unknown dtype, an unknown ext code, trailing bytes and a
truncated file.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_FIXEXT_SIZES = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_UINTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
_INTS = {0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.data) - self.pos} left")
        out, self.pos = self.data[self.pos:end], end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, b: int, base: int) -> int:
        """Length of a str8/16/32 (or bin, array, map) family member."""
        return self.unpack((">B", ">H", ">I")[b - base])

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if 0xc4 <= b <= 0xc6:
            return bytes(self.take(self.length(b, 0xc4)))
        if 0xc7 <= b <= 0xc9:
            n = self.length(b, 0xc7)
            return self.ext(self.unpack(">b"), n)
        if b == 0xca:
            return self.unpack(">f")
        if b == 0xcb:
            return self.unpack(">d")
        if b in _UINTS:
            return self.unpack(_UINTS[b])
        if b in _INTS:
            return self.unpack(_INTS[b])
        if b in _FIXEXT_SIZES:
            return self.ext(self.unpack(">b"), _FIXEXT_SIZES[b])
        if 0xd9 <= b <= 0xdb:
            return self.str(self.length(b, 0xd9))
        if b in (0xdc, 0xdd):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xdc else ">I"))]
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax chunked arrays (leaves over 1 GiB) are not supported")
        return out

    def ext(self, code: int, n: int) -> np.ndarray:
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(payload)
            if code == _EXT_NPSCALAR and arr.shape != ():
                raise ValueError(f"numpy scalar record of shape {arr.shape}")
            return arr
        if code == _EXT_COMPLEX:
            raise ValueError("complex scalars (msgpack ext 2) are not supported")
        raise ValueError(f"unknown msgpack ext type {code}")


def _dtype(name) -> np.dtype:
    if isinstance(name, bytes):
        name = name.decode("ascii")
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"unknown dtype {name!r} in an ndarray record") from None
    if dtype.hasobject or dtype.fields is not None:
        raise ValueError(f"unsupported dtype {name!r} in an ndarray record")
    return dtype


def _ndarray(payload: bytes) -> np.ndarray:
    """An ext 1/3 payload, msgpack (shape, dtype name, C-order bytes), as a
    writable array; bfloat16 widened exactly to float32."""
    reader = _Reader(payload)
    record = reader.value()
    if reader.pos != len(payload) or not (isinstance(record, list) and len(record) == 3):
        raise ValueError("malformed ndarray record")
    shape, name, buffer = record
    shape = tuple(int(s) for s in shape)
    bf16 = name in ("bfloat16", b"bfloat16")
    dtype = np.dtype("<u2") if bf16 else _dtype(name)
    if len(buffer) != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"ndarray record of shape {shape} {name!r} holds {len(buffer)} bytes")
    arr = np.frombuffer(buffer, dtype=dtype).reshape(shape)
    if bf16:   # the high half of a float32
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.copy()


def msgpack_restore(data: bytes) -> Any:
    """Decode flax msgpack bytes to nested dicts of numpy arrays and
    Python scalars (the counterpart of `flax.serialization.msgpack_restore`)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after the msgpack object")
    return out


def load(path: str | Path) -> Any:
    """`msgpack_restore` of a file."""
    return msgpack_restore(Path(path).read_bytes())
