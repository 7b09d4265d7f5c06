"""Build-on-demand loader for the port's CUDA kernels.

Counterpart of `back2future_tpu/runtime/native.py`: every `csrc/*.cu` is
compiled by `nvcc` for `sm_90a` (one `nvcc` per source, all started
together) and linked into ONE shared library with a plain C interface,
cached in `back2future_tpu_torch/_build/` under a hash of the sources and
flags (so an edited source rebuilds), and loaded with `ctypes`. Unlike the host runtime there is no fallback: the kernels are
only ever asked for on a CUDA tensor, so a missing `nvcc` or a failed
build raises.

Each C entry point is wrapped in a `Kernel`, which checks the returned
`cudaError_t` and counts its launches (`KERNELS` holds them all by name,
so a run can show that its main path went through each kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of back2future_tpu_torch cannot be built")


def _sources() -> Sequence[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libb2f_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/*.cu` unless the library for these sources exists;
    return its path. The sources compile in parallel, one `nvcc` each,
    and are linked with `nvcc -shared`. The `-Xptxas -v` report
    (registers, shared memory, spills per kernel) is kept beside the
    library as `<name>.log`. Raises RuntimeError if `nvcc` is missing or
    fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = {src: BUILD_DIR / f"{tag}.{src.stem}.o" for src in sorted(SRC_DIR.glob("*.cu"))}
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)] for src, obj in objs.items()]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    tmp = so.with_name(f"{tag}.tmp.so")
    try:
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(cmd, log, proc.returncode) for cmd, log, proc in zip(cmds, logs, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"[code {rc}] {' '.join(cmd)}\n{log}" for cmd, log, rc in failed))
        link = [nvcc, "-shared", *map(str, objs.values()), "-o", str(tmp)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {res.returncode}:\n"
                               f"{' '.join(link)}\n{res.stdout}{res.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs.values():
            obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    return so


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.b2f_error_string.argtypes = [ctypes.c_int]
            lib.b2f_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


class Kernel:
    """One C entry point of the kernel library, with its launch count.

    Calling it launches the kernel (the C function returns
    `cudaGetLastError()` right after the launch); a non-zero code
    raises, and only a launch that was accepted adds one to `launches`.
    """

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[symbol] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = _library().b2f_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0
