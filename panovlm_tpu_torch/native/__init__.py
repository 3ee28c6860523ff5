"""The port's native scan reader (ctypes, no pybind11).

`pvruntime.cpp` beside this file is compiled with g++ at first use into
`build/native/` at the repository root (listed in .gitignore), named by a
hash of the source, and loaded with ctypes. Every entry point has a numpy
fallback (io/pointcloud.py), so the port still reads scans where no
compiler is available. The LSD line detector (`lsd.cpp`, `native/lsd.py`),
the JPEG and PNG decoders, the LK flow, the SIFT detector (`sift.cpp`,
`native/sift.py`) and the decoders of BMP, PxM / PAM / PFM, Sun raster and
TIFF (`HostDecoder`: `bmp.cpp`, `pxm.cpp`, `sunras.cpp`, `tiff.cpp`, the
last linked with zlib) are built the same way and have no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("panovlm")

_SRC = Path(__file__).resolve().parent / "pvruntime.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "native"

_lib = None
_tried = False


def library_path(src: Path = _SRC, flags: tuple = (), libs: tuple = ()) -> Path:
    """Where `src` built with the extra g++ `flags` and linked with `libs`
    lives: named by a hash of the source, the local headers it includes,
    the flags and the libraries."""
    text = src.read_bytes()
    for name in re.findall(rb'#include "([^"]+)"', text):
        text += (src.parent / name.decode()).read_bytes()
    h = hashlib.sha256(text + " ".join(flags + libs).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{h}.so"


def compile_library(src: Path, flags: tuple = (), libs: tuple = ()) -> Path:
    """Compile `src` (with the extra g++ `flags`, linked with `libs` such as
    "-lz") into build/native/ unless its hash is built already. Raises
    when the compiler fails."""
    out = library_path(src, flags, libs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        # no FMA contraction: the LSD, the LK flow and the SIFT reproduce
        # OpenCV's float arithmetic, each fused step written out
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        "-ffp-contract=off", "-pthread", *flags, str(src), *libs, "-o", tmp],
                       check=True, capture_output=True, timeout=240)
        os.replace(tmp, out)   # atomic: a concurrent loader never sees a partial file
        return out
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class Cv2Refuses(NotImplementedError):
    """A file of a kind that cv2.imread gives no image for either (a
    hierarchical, 12-bit or 2-component JPEG, an RLE Sun raster, a PFM
    read with another channel count than its own, ...): the decoder
    refuses it as OpenCV does."""


class Cv2Raises(RuntimeError):
    """A file for which cv2.imread raises cv2.error instead of giving no
    image: imgcodecs' validateInputImageSize refuses its size (a side of 0
    or less or over 2^20 pixels, or over 2^30 pixels). load_mask lets it
    through, as the JAX package's load_mask does cv2's error."""


MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


class HostDecoder:
    """One of the host decoders with cv2.imread's bits that share
    imgcodecs.h: `<name>.cpp` beside this file, built at first use (linked
    with `libs`), its entry points pv_<name>_info and pv_<name>_decode
    called through ctypes (which releases the GIL). Return codes 1 and 2
    (cv2 gives no image) raise Cv2Refuses and ValueError, 3 MemoryError,
    4 (a kind of file cv2 reads and the port does not yet) a plain
    NotImplementedError."""

    ERRORS = {1: Cv2Refuses, 2: ValueError, 3: MemoryError, 4: NotImplementedError}

    def __init__(self, name: str, libs: tuple = ()):
        self.name = name
        self.libs = libs
        self.src = Path(__file__).resolve().parent / f"{name}.cpp"
        self._lib = None
        self._lock = threading.Lock()

    def get(self):
        """The loaded library, built on first use. Raises when g++ fails."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(compile_library(self.src, libs=self.libs)))
                pint = ctypes.POINTER(ctypes.c_int)
                info = getattr(lib, f"pv_{self.name}_info")
                info.restype = ctypes.c_int
                info.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, pint, pint,
                                 ctypes.c_char_p, ctypes.c_int]
                dec = getattr(lib, f"pv_{self.name}_decode")
                dec.restype = ctypes.c_int
                dec.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_int]
                self._lib = (info, dec)
        return self._lib

    def _check(self, rc: int, err) -> None:
        if rc:
            raise self.ERRORS.get(rc, RuntimeError)(err.value.decode(errors="replace"))

    def decode(self, data: bytes, color: bool) -> np.ndarray:
        """cv2.imread of the file's bytes: uint8 (H, W) for a gray read,
        (H, W, 3) RGB for a colour read."""
        info, dec = self.get()
        src = np.frombuffer(data, np.uint8)
        err = ctypes.create_string_buffer(256)
        h, w = ctypes.c_int(), ctypes.c_int()
        self._check(info(src.ctypes.data, src.size, int(color), ctypes.byref(h),
                         ctypes.byref(w), err, len(err)), err)
        h, w = h.value, w.value
        if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE and w * h <= MAX_PIXELS):
            raise Cv2Raises(f"{w} x {h} pixels: cv2.imread raises for this size")
        out = np.empty((h, w, 3) if color else (h, w), np.uint8)
        self._check(dec(src.ctypes.data, src.size, int(color), out.ctypes.data, err,
                        len(err)), err)
        return out


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
