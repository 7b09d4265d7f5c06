"""Build-on-demand loader for the port's host C++ helpers.

Counterpart of `back2future_tpu/runtime/native.py` for the three helpers
the host side needs: `runtime/src/resample.cc` (the resizes, the
windowed transforms and the photometric pipeline of data/resample.py and
data/augment.py), `runtime/src/getocc.cc` (the z-buffer occlusion of
io/occ.py) and `runtime/src/pngfilter.cc` (the PNG scanline filters of
io/png16.py). Each is compiled by g++ into its own shared library with
the JAX package's flags less `-fopenmp` (which needs `libgomp.spec`, and
a toolchain may lack it), plus `-pthread`: the row loops that JAX runs
under OpenMP run on std::thread here (`runtime/src/parallel_rows.h`),
their thread count an argument chosen by `host_threads()`.
`-march=native` is kept, since the FMA contractions it allows decide
whether the resizes match the JAX package's library bit for bit; so a
library's hash covers the host CPU's model and flags too, and a build
directory shared between hosts never loads a library built for another
CPU. The library goes into the gitignored `back2future_tpu_torch/_build/`
under a hash of its sources, the compiler, the flags and the CPU, is
written under a temporary name and moved into place with `os.replace`
(so processes that build at once never load a partial file), and is
loaded with `ctypes`.

Unlike native.py there is no quiet fallback: a missing compiler or a
failed build raises, so no data path silently drops to the slow Python
oracles or the NumPy twins. The sources stay out of `csrc/`, whose every
`.cu` file `cuda_build.py` links into the kernel library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

CXX = os.environ.get("CXX", "g++")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def host_threads() -> int:
    """The thread count of the helpers' row loops, chosen as OpenMP
    chooses its default: the first entry of `OMP_NUM_THREADS` where it is
    set, else the CPUs this process may run on."""
    first = os.environ.get("OMP_NUM_THREADS", "").split(",")[0].strip()
    if first.isdigit() and int(first) > 0:
        return int(first)
    return len(os.sched_getaffinity(0))


_CPU_KEYS = ("model name", "flags", "vendor_id", "cpu family", "model", "Features",
             "CPU implementer", "CPU architecture", "CPU variant", "CPU part")


def cpu_signature() -> str:
    """What `-march=native` builds for: the machine type and the CPU
    lines of /proc/cpuinfo that name the model and its features (x86:
    `model name`, `flags`; Arm: `CPU part`, `Features`), each once."""
    lines = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            lines += [line.strip() for line in f
                      if line.split(":", 1)[0].strip() in _CPU_KEYS]
    except OSError:
        pass
    return "\n".join(dict.fromkeys(lines))


def library_path(name: str) -> Path:
    """Where the library of `runtime/src/<name>.cc` for the current
    sources (the file and the directory's headers), compiler, flags and
    host CPU lives."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, cpu_signature())).encode())
    for src in (SRC_DIR / f"{name}.cc", *sorted(SRC_DIR.glob("*.h"))):
        h.update(src.read_bytes())
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
