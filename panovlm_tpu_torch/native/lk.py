"""The port's pyramidal Lucas-Kanade flow: `lk.cpp` through ctypes.

It computes what `cv2.calcOpticalFlowPyrLK(prev, next, pts, None)` computes
with cv2's defaults (21 x 21 window, 3 pyramid levels, 30 iterations or a
0.01 px step, min eigenvalue 1e-4), which is how the JAX package calls it
(models/line_tracks.filter_matches_optical_flow). The library is compiled
with g++ at first use into `build/native/` (see `native/__init__.py`).
There is no fallback: when the build fails, the image line tracks raise.
The C call releases the GIL.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import compile_library

_SRC = Path(__file__).resolve().parent / "lk.cpp"
_lib = None
_lock = threading.Lock()


def get():
    """The loaded library, built on first use. Raises when g++ fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_library(_SRC)))
            lib.pv_lk.restype = ctypes.c_int
            lib.pv_lk.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                                  ctypes.c_void_p]
            _lib = lib
    return _lib


def track(prev: np.ndarray, nxt: np.ndarray, pts: np.ndarray):
    """Track points (N, 2) float32 [x y] of the uint8 image `prev` into
    `nxt` (same shape). Returns (points (N, 2) float32, status (N,) bool)."""
    lib = get()
    a = np.ascontiguousarray(prev, np.uint8)
    b = np.ascontiguousarray(nxt, np.uint8)
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"track: two single-channel images of one shape, got {a.shape}, "
                         f"{b.shape}")
    p = np.ascontiguousarray(np.asarray(pts, np.float32).reshape(-1, 2))
    out = np.empty_like(p)
    status = np.empty(len(p), np.uint8)
    if lib.pv_lk(a.ctypes.data, b.ctypes.data, a.shape[0], a.shape[1], p.ctypes.data, len(p),
                 out.ctypes.data, status.ctypes.data) < 0:
        raise ValueError(f"track: images of {a.shape} are too small for a 21 x 21 window")
    return out, status.astype(bool)
