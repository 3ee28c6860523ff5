"""The port's TIFF decoder: `tiff.cpp` through ctypes (`native.HostDecoder`),
built with g++ at first use into `build/native/` together with `jpeg.cpp`
(JPEG-coded strips and tiles go through the port's one JPEG decoder, as
libtiff's go through libjpeg) and linked with zlib (Deflate strips and
tiles go through zlib's inflate, as libtiff's do), no fallback."""

from __future__ import annotations

import numpy as np

from . import HostDecoder

_DECODER = HostDecoder("tiff", libs=("-lz",), sources=("jpeg.cpp",))
_SRC = _DECODER.src


def decode(data: bytes, color: bool) -> np.ndarray:
    """cv2.imread of TIFF bytes: uint8 (H, W) for a gray read, (H, W, 3) RGB
    for a colour read. Raises Cv2Refuses where cv2 gives no image,
    Cv2Raises where cv2.imread raises, and a plain NotImplementedError
    naming ROADMAP.md for the codecs cv2 reads and the port does not yet
    (ThunderScan, SGILog)."""
    return _DECODER.decode(data, color)
