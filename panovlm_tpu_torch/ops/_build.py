"""Build and load the port's CUDA kernels.

The kernels are compiled at first use, from the sources in this checkout
only, with nvcc into a shared library that has a plain C interface, loaded
with ctypes. The library lands in `build/torch_kernels/` at the repository
root (listed in .gitignore), named by a hash of the source and the flags, so
an edited source rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "knn.cu",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None   # wall time of the nvcc run in this process, or None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(PATH and /usr/local/cuda/bin searched)")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpanovlm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing. Returns the library path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    build_seconds = time.time() - t0
    os.replace(tmp, out)   # atomic: a concurrent loader never sees a partial file
    return out


def load():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.knn_launch.restype = ci
        lib.knn_launch.argtypes = [vp, vp, vp, vp, vp, vp,        # q qm t tm qr tr
                                   ci, ci, ci, ci, ci, ci,        # B Q T D k ring
                                   ci, ci, ci, ci,                # drs
                                   vp, vp, vp, vp, vp]            # outs, stream
        _lib = lib
    return _lib
