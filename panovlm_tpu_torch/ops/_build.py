"""Build and load the port's CUDA kernels.

The kernels are compiled at first use, from the sources in this checkout
only: one nvcc per source, all started together, each into an object file,
then linked by nvcc into one shared library with a plain C interface,
loaded with ctypes. The library lands in `build/torch_kernels/` at the repository
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
SOURCES = (_PKG / "csrc" / "knn.cu", _PKG / "csrc" / "knn_desc.cu",
           _PKG / "csrc" / "volscore.cu")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None   # wall time of the nvcc run in this process, or None
build_log = ""         # nvcc's -Xptxas -v report (registers, spills) of that run


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


def _check_rc(cmd, rc, stdout, stderr):
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing. Returns the library path."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, str(src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in cmds]
        outs = [p.communicate() for p in procs]
        tmp = os.path.join(tmpdir, out.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        for cmd, p, (so, se) in zip(cmds, procs, outs):
            _check_rc(cmd, p.returncode, so, se)
        build_log = "".join(se for _, se in outs)
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_rc(link, proc.returncode, proc.stdout, proc.stderr)
        os.replace(tmp, out)   # atomic: a concurrent loader never sees a partial file
    build_seconds = time.time() - t0
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
        lib.knn_desc_launch.restype = ci
        lib.knn_desc_launch.argtypes = [vp, vp, vp, vp,              # q qm t tm
                                        ci, ci, ci, ci, ci, ci,      # B Q T D k reverse
                                        vp, vp, vp, vp, vp]          # norms outs keys stream
        lib.volscore_launch.restype = ci
        ll, cf = ctypes.c_longlong, ctypes.c_float
        lib.volscore_launch.argtypes = [vp, ll, ll,                 # vol, strides
                                        vp, vp, vp, vp,             # depth nrm rays gray
                                        ctypes.POINTER(ci), ci,     # host offsets, T
                                        ci, ci, ci, ci, ci,         # V C D H W
                                        cf, cf, cf, cf, cf,         # inv0 1/inv_step dmin dmax 1/(2s^2)
                                        vp, vp]                     # out, stream
        _lib = lib
    return _lib
