"""The port's native scan reader (ctypes, no pybind11).

`pvruntime.cpp` beside this file is compiled with g++ at first use into
`build/native/` at the repository root (listed in .gitignore), named by a
hash of the source, and loaded with ctypes. Every entry point has a numpy
fallback (io/pointcloud.py), so the port still reads scans where no
compiler is available. The LSD line detector (`lsd.cpp`, `native/lsd.py`)
is built the same way and has no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

log = logging.getLogger("panovlm")

_SRC = Path(__file__).resolve().parent / "pvruntime.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "native"

_lib = None
_tried = False


def library_path(src: Path = _SRC) -> Path:
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{h}.so"


def compile_library(src: Path) -> Path:
    """Compile `src` into build/native/ unless its hash is built already.
    Raises when the compiler fails."""
    out = library_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        # no FMA contraction: the LSD reproduces OpenCV's float arithmetic
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-ffp-contract=off", "-pthread", str(src), "-o", tmp],
                       check=True, capture_output=True, timeout=240)
        os.replace(tmp, out)   # atomic: a concurrent loader never sees a partial file
        return out
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build() -> Path | None:
    """Compile the scan reader if missing. Returns its path, or None when
    the compiler fails."""
    try:
        return compile_library(_SRC)
    except Exception as e:  # toolchain missing: the numpy readers take over
        log.warning("native build failed: %s", e)
        return None


def get():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    fptr = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    lib.pv_read_pcd.restype = ctypes.c_long
    lib.pv_read_pcd.argtypes = [ctypes.c_char_p, fptr, ctypes.POINTER(ctypes.c_int)]
    lib.pv_read_ply.restype = ctypes.c_long
    lib.pv_read_ply.argtypes = lib.pv_read_pcd.argtypes
    lib.pv_free.argtypes = [ctypes.c_void_p]
    lib.pv_prefetch_create.restype = ctypes.c_void_p
    lib.pv_prefetch_create.argtypes = [ctypes.c_int]
    lib.pv_prefetch_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_long]
    lib.pv_prefetch_poll.restype = ctypes.c_long
    lib.pv_prefetch_poll.argtypes = [ctypes.c_void_p, fptr,
                                     ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.pv_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def _take_array(lib, data_ptr, rows, cols):
    buf = np.ctypeslib.as_array(data_ptr, shape=(rows, cols)).copy()
    lib.pv_free(data_ptr)
    return buf


def read_cloud_native(path: str):
    """Read pcd/ply via the native reader; None if unavailable/failed."""
    lib = get()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_float)()
    cols = ctypes.c_int()
    fn = lib.pv_read_ply if path.endswith(".ply") else lib.pv_read_pcd
    n = fn(path.encode(), ctypes.byref(data), ctypes.byref(cols))
    if n < 0:
        return None
    return _take_array(lib, data, n, cols.value)


class ScanPrefetcher:
    """Threaded file prefetch: `for arr in ScanPrefetcher(paths): ...`
    yields each file's (N, C) float32 array in submission order (None where
    the native read failed)."""

    def __init__(self, paths, n_threads: int = 4):
        self._lib = get()
        self._paths = list(paths)
        if self._lib is None:
            self._h = None
            return
        self._h = self._lib.pv_prefetch_create(n_threads)
        for i, p in enumerate(self._paths):
            self._lib.pv_prefetch_submit(self._h, str(p).encode(), i)

    def __iter__(self):
        import time
        if self._h is None:  # fallback: synchronous numpy reads
            from ..io import pointcloud
            for p in self._paths:
                yield pointcloud.load_cloud(p)
            return
        pending = {}
        next_id = 0
        n = len(self._paths)
        while next_id < n:
            if next_id in pending:
                yield pending.pop(next_id)
                next_id += 1
                continue
            data = ctypes.POINTER(ctypes.c_float)()
            rows = ctypes.c_long()
            cols = ctypes.c_int()
            got = self._lib.pv_prefetch_poll(self._h, ctypes.byref(data),
                                             ctypes.byref(rows), ctypes.byref(cols))
            if got < 0:
                time.sleep(0.002)
                continue
            arr = _take_array(self._lib, data, rows.value, cols.value) \
                if rows.value >= 0 else None
            pending[got] = arr

    def close(self):
        if self._h is not None:
            self._lib.pv_prefetch_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
