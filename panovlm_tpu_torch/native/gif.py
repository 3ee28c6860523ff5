"""The port's GIF decoder: `gif.cpp` through ctypes (`native.HostDecoder`),
built with g++ at first use into `build/native/`, no fallback."""

from __future__ import annotations

import numpy as np

from . import HostDecoder

_DECODER = HostDecoder("gif")
_SRC = _DECODER.src


def decode(data: bytes, color: bool) -> np.ndarray:
    """cv2.imread of GIF bytes (its first frame on the logical screen):
    uint8 (H, W) for a gray read, (H, W, 3) RGB for a colour read. Raises
    Cv2Refuses or ValueError where cv2 gives no image, Cv2Raises where
    cv2.imread raises."""
    return _DECODER.decode(data, color)
