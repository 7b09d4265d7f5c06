"""Torch7 serialization (.t7) reader/writer (pure Python, numpy only).

The port's own copy of back2future_tpu/io/t7.py, held against it by
tests/test_torch_t7.py.

Implements the subset of the Torch7 binary format needed to ingest the
reference's pretrained checkpoints (README.md:49-52: Ours-Hard /
Ours-Soft-ft-KITTI / Ours-Soft-ft-Sintel, saved with torch.save) and to
round-trip synthetic fixtures in tests.

Format (little-endian, binary mode):
  object     := int32 tag, payload
  tag        := 0 nil | 1 number | 2 string | 3 table | 4 torch class |
                5 boolean | 6/7/8 function (skipped)
  number     := float64
  string     := int32 length, bytes
  table      := int32 heap-id, [int32 npairs, (key obj, value obj)*]
  torch      := int32 heap-id, [version string "V <n>", classname string,
                class payload]
  Tensor     := int32 ndim, int64[ndim] size, int64[ndim] stride,
                int64 storage_offset (1-based), Storage object (or nil)
  Storage    := int64 numel, raw elementwise data

Tensors are materialized as NumPy arrays (respecting strides/offset);
nn modules deserialize to plain dicts {"torch_type": classname, ...attrs}.
Heap ids implement reference sharing — cloned modules whose weights share
a Storage resolve to the SAME NumPy array object.
"""

from __future__ import annotations

import contextlib
import struct
import sys
from pathlib import Path
from typing import Any, BinaryIO, Dict

import numpy as np


@contextlib.contextmanager
def _deep_recursion(limit: int = 50000):
    """Serialized nngraph gModules chain nodes through children/mapindex
    references hundreds deep; the recursive reader/writer needs more
    stack than CPython's default 1000 frames."""
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, limit))
    try:
        yield
    finally:
        sys.setrecursionlimit(old)

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8
TYPE_LEGACY_RECUR_FUNCTION = 7

_TENSOR_DTYPES = {
    "torch.FloatTensor": np.float32,
    "torch.DoubleTensor": np.float64,
    "torch.CudaTensor": np.float32,
    "torch.CudaDoubleTensor": np.float64,
    "torch.CudaHalfTensor": np.float16,
    "torch.HalfTensor": np.float16,
    "torch.ByteTensor": np.uint8,
    "torch.CharTensor": np.int8,
    "torch.ShortTensor": np.int16,
    "torch.IntTensor": np.int32,
    "torch.LongTensor": np.int64,
}
_STORAGE_DTYPES = {k.replace("Tensor", "Storage"): v
                   for k, v in _TENSOR_DTYPES.items()}


class T7Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.heap: Dict[int, Any] = {}

    # ---- primitives
    def _i32(self) -> int:
        return struct.unpack("<i", self.f.read(4))[0]

    def _i64(self) -> int:
        return struct.unpack("<q", self.f.read(8))[0]

    def _f64(self) -> float:
        return struct.unpack("<d", self.f.read(8))[0]

    def _string(self) -> str:
        n = self._i32()
        return self.f.read(n).decode("latin-1")

    # ---- objects
    def read(self) -> Any:
        tag = self._i32()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            v = self._f64()
            return int(v) if v.is_integer() else v
        if tag == TYPE_STRING:
            return self._string()
        if tag == TYPE_BOOLEAN:
            return self._i32() == 1
        if tag == TYPE_TABLE:
            return self._read_table()
        if tag == TYPE_TORCH:
            return self._read_torch()
        if tag in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                   TYPE_LEGACY_RECUR_FUNCTION):
            return self._read_function(tag)
        raise ValueError(f"bad t7 type tag {tag} at {self.f.tell()}")

    def _read_table(self) -> Any:
        idx = self._i32()
        if idx in self.heap:
            return self.heap[idx]
        out: Dict[Any, Any] = {}
        self.heap[idx] = out
        n = self._i32()
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        # tables with contiguous integer keys 1..n become lists
        if out and all(isinstance(k, int) for k in out) \
                and sorted(out) == list(range(1, len(out) + 1)):
            lst = [out[i] for i in range(1, len(out) + 1)]
            self.heap[idx] = lst
            return lst
        return out

    def _read_torch(self) -> Any:
        idx = self._i32()
        if idx in self.heap:
            return self.heap[idx]
        version = self._string()
        if version.startswith("V "):
            cls = self._string()
        else:  # pre-versioning files: the string IS the class name
            cls = version
        if cls in _TENSOR_DTYPES:
            placeholder: Dict[str, Any] = {}
            self.heap[idx] = placeholder
            arr = self._read_tensor(_TENSOR_DTYPES[cls])
            self.heap[idx] = arr
            return arr
        if cls in _STORAGE_DTYPES:
            arr = self._read_storage(_STORAGE_DTYPES[cls])
            self.heap[idx] = arr
            return arr
        # generic torch class (nn modules, nngraph nodes, ...)
        obj: Dict[str, Any] = {"torch_type": cls}
        self.heap[idx] = obj
        payload = self.read()
        if isinstance(payload, dict):
            obj.update(payload)
        else:
            obj["payload"] = payload
        return obj

    def _read_tensor(self, dtype) -> np.ndarray:
        nd = self._i32()
        size = [self._i64() for _ in range(nd)]
        stride = [self._i64() for _ in range(nd)]
        offset = self._i64() - 1  # 1-based
        storage = self.read()
        if storage is None or nd == 0:
            return np.zeros(size, dtype)
        return np.lib.stride_tricks.as_strided(
            storage[offset:],
            shape=size,
            strides=[s * storage.itemsize for s in stride]).copy()

    def _read_storage(self, dtype) -> np.ndarray:
        n = self._i64()
        return np.frombuffer(self.f.read(n * np.dtype(dtype).itemsize),
                             dtype=dtype).copy()

    def _read_function(self, tag: int) -> Any:
        idx = self._i32()
        if tag != TYPE_FUNCTION and idx in self.heap:
            return self.heap[idx]
        if tag == TYPE_FUNCTION:
            size = idx  # plain functions have no heap id; idx IS the size
            self.f.read(size)
            return {"torch_type": "function"}
        size = self._i32()
        self.f.read(size)
        obj = {"torch_type": "function"}
        self.heap[idx] = obj
        obj["upvalues"] = self.read()
        return obj


def load_t7(path: str | Path) -> Any:
    with open(path, "rb") as f, _deep_recursion():
        return T7Reader(f).read()


class T7Writer:
    """Writes the same subset (for tests and checkpoint export)."""

    def __init__(self, f: BinaryIO):
        self.f = f
        self._next_id = 1
        self._ids: Dict[int, int] = {}
        # id() keys are only valid while the object is alive — pin every
        # registered object so CPython cannot recycle an id mid-write
        self._keepalive: list = []

    def _i32(self, v: int):
        self.f.write(struct.pack("<i", v))

    def _i64(self, v: int):
        self.f.write(struct.pack("<q", v))

    def _string(self, s: str):
        b = s.encode("latin-1")
        self._i32(len(b))
        self.f.write(b)

    def write(self, obj: Any):
        if obj is None:
            self._i32(TYPE_NIL)
        elif isinstance(obj, bool):
            self._i32(TYPE_BOOLEAN)
            self._i32(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self._i32(TYPE_NUMBER)
            self.f.write(struct.pack("<d", float(obj)))
        elif isinstance(obj, str):
            self._i32(TYPE_STRING)
            self._string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, (dict, list)):
            self._write_table_or_class(obj)
        else:
            raise TypeError(f"cannot serialize {type(obj)}")

    def _heap_id(self, obj, kind: str = "obj") -> tuple:
        key = (kind, id(obj))
        if key in self._ids:
            return self._ids[key], True
        self._keepalive.append(obj)
        self._ids[key] = self._next_id
        self._next_id += 1
        return self._ids[key], False

    def _write_table_or_class(self, obj):
        if isinstance(obj, dict) and "torch_type" in obj:
            cls = obj["torch_type"]
            self._i32(TYPE_TORCH)
            hid, seen = self._heap_id(obj)
            self._i32(hid)
            if seen:
                return
            self._string("V 1")
            self._string(cls)
            payload = {k: v for k, v in obj.items() if k != "torch_type"}
            self.write(payload)
            return
        self._i32(TYPE_TABLE)
        hid, seen = self._heap_id(obj)
        self._i32(hid)
        if seen:
            return
        items = (list(enumerate(obj, start=1)) if isinstance(obj, list)
                 else list(obj.items()))
        self._i32(len(items))
        for k, v in items:
            self.write(k)
            self.write(v)

    def _write_tensor(self, arr: np.ndarray):
        cls = None
        for name, dt in _TENSOR_DTYPES.items():
            if name.startswith("torch.Cuda"):
                continue
            if np.dtype(dt) == arr.dtype:
                cls = name
                break
        if cls is None:
            raise TypeError(f"no torch tensor class for dtype {arr.dtype}")
        self._i32(TYPE_TORCH)
        hid, seen = self._heap_id(arr)
        self._i32(hid)
        if seen:
            return
        self._string("V 1")
        self._string(cls)
        arr_c = np.ascontiguousarray(arr)
        self._i32(arr_c.ndim)
        for s in arr_c.shape:
            self._i64(s)
        strides = [st // arr_c.itemsize for st in arr_c.strides]
        for s in strides:
            self._i64(s)
        self._i64(1)  # storage offset, 1-based
        # storage object (shared when the same array object recurs)
        self._i32(TYPE_TORCH)
        sid, sseen = self._heap_id(arr_c, "storage")
        self._i32(sid)
        if not sseen:
            self._string("V 1")
            self._string(cls.replace("Tensor", "Storage"))
            self._i64(arr_c.size)
            self.f.write(arr_c.tobytes())


def save_t7(path: str | Path, obj: Any) -> None:
    with open(path, "wb") as f, _deep_recursion():
        T7Writer(f).write(obj)
