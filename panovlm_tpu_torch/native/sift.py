"""The port's host SIFT detector: `sift.cpp` through ctypes.

It computes what `cv2.SIFT_create(nfeatures).detectAndCompute(gray, mask)`
computes at cv2's other defaults, which is how the JAX package calls it
(panovlm_tpu/utils/sift.extract_sift), with the float arithmetic of
OpenCV 5.0's x86 AVX2 build (see the header of `sift.cpp`). The library is
compiled with g++ at first use into `build/native/` (see
`native/__init__.py`); on x86-64 machines whose CPU has AVX2 and FMA it is
built with `-mavx2 -mfma`, so that its explicit fused multiply-adds are
instructions rather than calls (the bits are the same either way). There
is no fallback: when the build fails, the host SIFT raises. The C call
releases the GIL and runs the frames on its own threads, one frame per
thread.
"""

from __future__ import annotations

import ctypes
import platform
import threading
from pathlib import Path

import numpy as np

from . import compile_library

_SRC = Path(__file__).resolve().parent / "sift.cpp"
_lib = None
_lock = threading.Lock()

#: the kernels of the base blur (sigma = sqrtf(1.6^2 - 1)) and of layers 1-5
#: of an octave, as `sift.cpp` embeds them
BLUR_SIGMAS = (1.2489997148513794, 1.2262734984654078, 1.5450077936447955,
               1.9465878414647133, 2.4525469969308156, 3.090015587289591)


def build_flags() -> tuple:
    """-mavx2 -mfma where the CPU has both (x86-64), else none."""
    if platform.machine() not in ("x86_64", "AMD64"):
        return ()
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln.split(":", 1)[1].split() for ln in f if ln.startswith("flags")), [])
    except OSError:
        return ()
    return ("-mavx2", "-mfma") if "avx2" in flags and "fma" in flags else ()


def get():
    """The loaded library, built on first use. Raises when g++ fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_library(_SRC, build_flags())))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pv_sift_batch.restype = p
            lib.pv_sift_batch.argtypes = [p, i, i, i, p, i, i]
            lib.pv_sift_count.restype = i
            lib.pv_sift_count.argtypes = [p, i]
            lib.pv_sift_fetch.argtypes = [p, i, p, p, p]
            lib.pv_sift_free.argtypes = [p]
            lib.pv_sift_blur.argtypes = [p, p, i, i, i]
            lib.pv_sift_exp.argtypes = [p, p, i]
            lib.pv_sift_atan.argtypes = [p, p, p, i]
            lib.pv_sift_magnitude.argtypes = [p, p, p, i]
            _lib = lib
    return _lib


def frame_bytes(rows: int, cols: int) -> int:
    """Host bytes one frame holds at its peak: the 2x-upscaled float
    pyramid (6 Gaussian and 5 DoG layers per octave, 4/3 for the octaves)
    and two layer-sized temporaries."""
    layer = 4 * (2 * rows) * (2 * cols)
    return int(layer * (11 * 4 / 3 + 2))


def detect_and_compute(frames: np.ndarray, mask: np.ndarray | None = None,
                       nfeatures: int = 0, threads: int = 1):
    """SIFT of each uint8 frame of `frames` ((N, H, W), or one (H, W)).

    `mask` (H, W) uint8: keypoints where it is 0 are dropped (after the cut
    to `nfeatures`, as cv2 does); `nfeatures` 0 keeps them all. Returns one
    (keypoints (K, 5) float32 [x y size angle response], octave (K,) int32
    as cv2 packs it, descriptors (K, 128) float32) per frame, in cv2's
    order. The result does not depend on `threads`."""
    lib = get()
    f = np.ascontiguousarray(frames, np.uint8)
    if f.ndim == 2:
        f = f[None]
    if f.ndim != 3:
        raise ValueError(f"detect_and_compute: (N, H, W) uint8 frames, got {frames.shape}")
    n, rows, cols = f.shape
    m = None
    if mask is not None:
        m = np.ascontiguousarray(mask, np.uint8)
        if m.shape != (rows, cols):
            raise ValueError(f"detect_and_compute: mask {m.shape} for frames of {(rows, cols)}")
    h = lib.pv_sift_batch(f.ctypes.data, n, rows, cols, None if m is None else m.ctypes.data,
                          int(nfeatures), max(1, int(threads)))
    try:
        out = []
        for i in range(n):
            k = lib.pv_sift_count(h, i)
            kp = np.empty((k, 5), np.float32)
            octave = np.empty(k, np.int32)
            desc = np.empty((k, 128), np.float32)
            lib.pv_sift_fetch(h, i, kp.ctypes.data, octave.ctypes.data, desc.ctypes.data)
            out.append((kp, octave, desc))
        return out
    finally:
        lib.pv_sift_free(h)


def gaussian_blur(img: np.ndarray, which: int) -> np.ndarray:
    """The float blur of the pyramid: which = 0 the base blur, 1-5 layer
    `which` of an octave (sigma BLUR_SIGMAS[which], reflect-101)."""
    a = np.ascontiguousarray(img, np.float32)
    out = np.empty_like(a)
    get().pv_sift_blur(a.ctypes.data, out.ctypes.data, a.shape[0], a.shape[1], int(which))
    return out


def exp32f(x: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(x, np.float32).ravel()
    out = np.empty_like(a)
    get().pv_sift_exp(a.ctypes.data, out.ctypes.data, a.size)
    return out


def fast_atan2(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Degrees in [0, 360), as cv2.phase(x, y, angleInDegrees=True)."""
    a = np.ascontiguousarray(y, np.float32).ravel()
    b = np.ascontiguousarray(x, np.float32).ravel()
    out = np.empty_like(a)
    get().pv_sift_atan(a.ctypes.data, b.ctypes.data, out.ctypes.data, a.size)
    return out


def magnitude(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(x, np.float32).ravel()
    b = np.ascontiguousarray(y, np.float32).ravel()
    out = np.empty_like(a)
    get().pv_sift_magnitude(a.ctypes.data, b.ctypes.data, out.ctypes.data, a.size)
    return out
