"""The port's PBM / PGM / PPM, PAM and PFM decoder: `pxm.cpp` through
ctypes (`native.HostDecoder`), built with g++ at first use into
`build/native/`, no fallback."""

from __future__ import annotations

import numpy as np

from . import HostDecoder

_DECODER = HostDecoder("pxm")
_SRC = _DECODER.src


def decode(data: bytes, color: bool) -> np.ndarray:
    """cv2.imread of P1-P7, Pf or PF bytes: uint8 (H, W) for a gray read,
    (H, W, 3) RGB for a colour read. Raises Cv2Refuses (a PFM read with
    another channel count than the file's, which cv2 gives no image for,
    and the PAM kinds cv2 refuses) or ValueError where cv2 gives no image,
    Cv2Raises where cv2.imread raises."""
    return _DECODER.decode(data, color)
