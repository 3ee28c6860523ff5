"""The port's LSD line detector: `lsd.cpp` through ctypes.

The library is compiled with g++ at first use into `build/native/` (see
`native/__init__.py`). There is no fallback: when the build fails, the
joint stage raises, since its image lines come from this detector alone.
The C call releases the GIL, so callers detect frames in parallel on
threads (utils/panorama_line.extract_panorama_lines_batch).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import compile_library

_SRC = Path(__file__).resolve().parent / "lsd.cpp"
_lib = None
_lock = threading.Lock()


def get():
    """The loaded library, built on first use. Raises when g++ fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_library(_SRC)))
            lib.pv_lsd.restype = ctypes.c_long
            lib.pv_lsd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
            lib.pv_lsd_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def detect(gray: np.ndarray) -> np.ndarray:
    """LSD segments of one (H, W) uint8 image: (L, 4) float32 [x1 y1 x2 y2]
    in pixels, the order and values of cv2's `createLineSegmentDetector()
    .detect`."""
    lib = get()
    g = np.ascontiguousarray(gray, np.uint8)
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.pv_lsd(g.ctypes.data, g.shape[0], g.shape[1], ctypes.byref(out))
    if n < 0:
        raise MemoryError("pv_lsd: allocation failed")
    if n == 0:
        return np.zeros((0, 4), np.float32)
    segs = np.ctypeslib.as_array(out, shape=(n, 4)).copy()
    lib.pv_lsd_free(out)
    return segs
