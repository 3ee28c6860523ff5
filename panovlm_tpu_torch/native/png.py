"""The port's PNG decoder: `png.cpp` through ctypes, the inflate step with
zlib.

The library is compiled with g++ at first use into `build/native/` (see
`native/__init__.py`). There is no fallback: when the build fails, reading
a PNG raises. Both C calls and zlib's inflate release the GIL, so callers
decode frames in parallel on threads (io/images.load_images_u8).
"""

from __future__ import annotations

import ctypes
import threading
import zlib
from pathlib import Path

import numpy as np

from . import compile_library
from .jpeg import apply_orientation

_SRC = Path(__file__).resolve().parent / "png.cpp"
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
            plong = ctypes.POINTER(ctypes.c_long)
            lib.pv_png_info.restype = ctypes.c_int
            lib.pv_png_info.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                                        ctypes.c_void_p, pint, pint, pint, pint, plong, plong,
                                        ctypes.c_char_p, ctypes.c_int]
            lib.pv_png_decode.restype = ctypes.c_int
            lib.pv_png_decode.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                                          ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_char_p, ctypes.c_int]
            _lib = lib
    return _lib


def _check(rc: int, err) -> None:
    if rc:
        raise _ERRORS.get(rc, RuntimeError)(err.value.decode(errors="replace"))


def _inflate(idat: memoryview, need: int) -> bytes:
    """The zlib stream of the IDAT data, as libpng reads it: a bad header or
    checksum is an error, data past the image is ignored, too little is an
    error."""
    d = zlib.decompressobj()
    try:
        raw = d.decompress(idat)
    except zlib.error as e:
        raise ValueError(f"IDAT: {e}") from None
    if len(raw) < need:
        raise ValueError("not enough image data")
    return raw


def decode(data: bytes, color: bool) -> np.ndarray:
    """cv2.imread of PNG bytes: uint8 (H, W) for a gray read, (H, W, 3) RGB
    for a colour read, turned by the EXIF orientation of an eXIf chunk."""
    lib = get()
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    idat = np.empty(src.size, np.uint8)
    h, w, ch, orient = (ctypes.c_int() for _ in range(4))
    idat_len, raw_len = ctypes.c_long(), ctypes.c_long()
    _check(lib.pv_png_info(src.ctypes.data, src.size, int(color), idat.ctypes.data,
                           ctypes.byref(h), ctypes.byref(w), ctypes.byref(ch),
                           ctypes.byref(orient), ctypes.byref(idat_len), ctypes.byref(raw_len),
                           err, len(err)), err)
    raw = _inflate(memoryview(idat)[:idat_len.value], raw_len.value)
    del idat
    out = np.empty((h.value, w.value, 3) if color else (h.value, w.value), np.uint8)
    _check(lib.pv_png_decode(src.ctypes.data, src.size, raw, len(raw), int(color),
                             out.ctypes.data, err, len(err)), err)
    return apply_orientation(out, orient.value)
