"""Build-on-demand loader for the port's host C++ helpers.

Counterpart of `back2future_tpu/runtime/native.py` for the two helpers
the data path needs: `runtime/src/getocc.cc` (the z-buffer occlusion of
io/occ.py) and `runtime/src/pngfilter.cc` (the PNG scanline filters of
io/png16.py). Each is compiled by g++ into its own shared library with
`-O3 -shared -fPIC -std=c++17` and no OpenMP (the JAX package's
`-fopenmp` build needs `libgomp.spec`, which a toolchain may lack; the one
OpenMP loop of getocc.cc, the median filter, runs serially here). The
library goes into the gitignored `back2future_tpu_torch/_build/` under a
hash of its source, the compiler and the flags, is written under a
temporary name and moved into place with `os.replace` (so processes
that build at once never load a partial file), and is loaded with `ctypes`.

Unlike native.py there is no quiet fallback: a missing compiler or a
failed build raises, so no data path silently drops to the slow Python
oracles. The sources stay out of `csrc/`, whose every `.cu` file
`cuda_build.py` links into the kernel library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

CXX = os.environ.get("CXX", "g++")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where the library of `runtime/src/<name>.cc` for the current
    source, compiler and flags lives."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update((SRC_DIR / f"{name}.cc").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `runtime/src/<name>.cc` unless its library exists; return
    the library's path. Raises RuntimeError if the compiler is missing or
    fails."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [CXX, *CXX_FLAGS, str(SRC_DIR / f"{name}.cc"), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"host build of {name}: compiler not found ({e})") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build of {name} failed with code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `runtime/src/<name>.cc`, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib
