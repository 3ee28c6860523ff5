"""The port's baseline JPEG decoder: `jpeg.cpp` through ctypes.

The library is compiled with g++ at first use into `build/native/` (see
`native/__init__.py`). There is no fallback: when the build fails, reading
a JPEG raises. The C call releases the GIL, so callers decode frames in
parallel on threads (io/images.load_images).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import compile_library

_SRC = Path(__file__).resolve().parent / "jpeg.cpp"
_lib = None
_lock = threading.Lock()
_ERRORS = {1: NotImplementedError, 2: ValueError, 3: MemoryError}


def get():
    """The loaded library, built on first use. Raises when g++ fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_library(_SRC)))
            pint = ctypes.POINTER(ctypes.c_int)
            lib.pv_jpeg_info.restype = ctypes.c_int
            lib.pv_jpeg_info.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                                         pint, pint, pint, pint, ctypes.c_char_p, ctypes.c_int]
            lib.pv_jpeg_decode.restype = ctypes.c_int
            lib.pv_jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
    return _lib


def _check(rc: int, err) -> None:
    if rc == 0:
        return
    msg = err.value.decode(errors="replace")
    if rc == 1:
        msg += "; the port decodes baseline and extended sequential Huffman JPEG only (ROADMAP.md)"
    raise _ERRORS.get(rc, RuntimeError)(msg)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform for EXIF Orientation 1-8 (other values: as is)."""
    t = img.swapaxes(0, 1) if orientation in (5, 6, 7, 8) else img
    if orientation in (2, 3, 6, 7):
        t = t[:, ::-1]
    if orientation in (3, 4, 7, 8):
        t = t[::-1]
    return np.ascontiguousarray(t)


def decode(data: bytes, color: bool) -> np.ndarray:
    """cv2.imread of JPEG bytes: uint8 (H, W) for a gray read (the Y plane),
    (H, W, 3) RGB for a colour read, turned by the EXIF orientation."""
    lib = get()
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    h, w, ch, orient = (ctypes.c_int() for _ in range(4))
    _check(lib.pv_jpeg_info(src.ctypes.data, src.size, int(color), ctypes.byref(h),
                            ctypes.byref(w), ctypes.byref(ch), ctypes.byref(orient), err,
                            len(err)), err)
    out = np.empty((h.value, w.value, 3) if color else (h.value, w.value), np.uint8)
    _check(lib.pv_jpeg_decode(src.ctypes.data, src.size, int(color), out.ctypes.data, err,
                              len(err)), err)
    return apply_orientation(out, orient.value)
