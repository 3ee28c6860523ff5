"""The formats cv2 reads without a codec — BMP (native/bmp.cpp), PBM / PGM /
PPM, PAM and PFM (native/pxm.cpp) and Sun raster (native/sunras.cpp) —
against cv2.imread, bit for bit, in gray and in colour (BGR -> RGB), on
files tests/image_forge.py writes (cv2 and PIL write none of RLE4 / RLE8,
bitfields, OS/2 headers, short palettes, other maxvals, PAM tuple types,
Sun raster maps and types):

  * every variant of each format at 1 x 1, 7 x 13, 37 x 53 and 129 x 257,
    and the kinds cv2 gives no image for (which the port refuses);
  * one file of each kind cut at every byte, and seeded bit flips: the port
    gives an image exactly where cv2 does, with its bits, and raises
    native.Cv2Raises exactly where cv2.imread raises (a size that
    validateInputImageSize refuses);
  * load_mask and load_images against the JAX package's (cv2-based) on
    masks and frames of these formats, tolerance 0; a PFM mask cv2 gives no
    gray image for is None with "Fail to read mask";
  * chip_smoke.py phase 16 (f)'s probes, their digests recomputed with cv2.

PAM's GRAYSCALE_ALPHA and RGB_ALPHA reads go through OpenCV's
basic_conversion, which writes only part of each row (cv2 leaves the rest
as it was in memory, so its output there differs between calls) and, for a
gray read of GRAYSCALE_ALPHA, half a row past the image: those files are
read by cv2 into buffers of their size with room after them, filled with 0
and with 255, and the port must give the 0-filled one (its bytes where cv2
writes, 0 where it writes nothing).
"""

import base64
import hashlib
import logging
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline as jpipe
from panovlm_tpu.config import Config
from panovlm_tpu_torch import native
from panovlm_tpu_torch.io import images
from panovlm_tpu_torch.native import bmp, pxm, sunras

import chip_smoke as cs
import image_forge as forge

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

SIZES = ((1, 1), (7, 13), (37, 53), (129, 257))
DECODERS = {"BMP": bmp, "PxM": pxm, "PAM": pxm, "PFM": pxm, "Sun raster": sunras}


def _cv2_read(path, color, shape=None):
    """cv2.imread's outcome: the image (RGB for a colour read), None where it
    gives none, "raises" where it raises. With shape, the read goes into
    buffers of that shape (with rows to spare after them) filled with 0 and
    with 255; the 0-filled one is the image, and neither written is none."""
    flag = cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE
    try:
        if shape is None:
            img = cv2.imread(path, flag)
        else:
            h, w = shape
            out = []
            for fill in (0, 255):
                room = np.full((h + 4, w, 3) if color else (h + 4, w), fill, np.uint8)
                out.append(cv2.imread(path, room[:h], flag))
            if out[0] is None or ((out[0] == 0).all() and (out[1] == 255).all()):
                return None
            img = out[0]
    except cv2.error:
        return "raises"
    if img is None:
        return None
    return np.ascontiguousarray(img[..., ::-1]) if color else img


def _port_read(data: bytes, color: bool):
    """The port's outcome on the same bytes, as _cv2_read gives cv2's."""
    decoder = DECODERS.get(images.image_format(data[:64]))
    if decoder is None:
        return None
    try:
        return decoder.decode(data, color)
    except native.Cv2Raises:
        return "raises"
    except (native.Cv2Refuses, ValueError):
        return None


def _outcome(x):
    return x.shape if isinstance(x, np.ndarray) else x


def _same_as_cv2(path, data: bytes, tag, shape=None):
    """Both reads of data (written to path) against cv2's."""
    with open(path, "wb") as f:
        f.write(data)
    for color in (False, True):
        ref, out = _cv2_read(str(path), color, shape), _port_read(data, color)
        assert _outcome(out) == _outcome(ref), (tag, color)
        if isinstance(ref, np.ndarray):
            assert out.dtype == np.uint8, tag
            np.testing.assert_array_equal(out, ref, err_msg=f"{tag} color={color}")


def _blocky(rng, h, w, levels):
    """Palette indices in runs of 5, some single pixels, and index-0
    stretches (left third, a middle row) that RLE codes as deltas."""
    b = np.repeat(rng.integers(0, levels, (h, (w + 4) // 5)), 5, axis=1)[:, :w]
    b[rng.random((h, w)) < 0.2] = rng.integers(0, levels)
    b[:, :w // 3] = 0
    if h > 3:
        b[h // 2] = 0
    return b


# ----------------------------------------------------------------------------
# every variant at every size
# ----------------------------------------------------------------------------

def _pal(rng, n):
    return rng.integers(0, 256, (n, 3))


BMP_KINDS = {
    "1-bit": lambda r, h, w: forge.bmp_bytes(r.integers(0, 2, (h, w)), 1, _pal(r, 2)),
    "1-bit OS/2": lambda r, h, w: forge.bmp_bytes(r.integers(0, 2, (h, w)), 1, _pal(r, 2),
                                                  header=12),
    "4-bit": lambda r, h, w: forge.bmp_bytes(r.integers(0, 16, (h, w)), 4, _pal(r, 16)),
    "4-bit, 5-entry palette": lambda r, h, w: forge.bmp_bytes(r.integers(0, 16, (h, w)), 4,
                                                              _pal(r, 5)),
    "4-bit V5": lambda r, h, w: forge.bmp_bytes(r.integers(0, 16, (h, w)), 4, _pal(r, 16),
                                                header=124),
    "8-bit": lambda r, h, w: forge.bmp_bytes(r.integers(0, 256, (h, w)), 8, _pal(r, 256)),
    "8-bit, 85-entry palette": lambda r, h, w: forge.bmp_bytes(r.integers(0, 256, (h, w)), 8,
                                                               _pal(r, 85)),
    "8-bit gray palette": lambda r, h, w: forge.bmp_bytes(
        r.integers(0, 256, (h, w)), 8, np.repeat(np.arange(256)[:, None], 3, axis=1)),
    "8-bit OS/2": lambda r, h, w: forge.bmp_bytes(r.integers(0, 256, (h, w)), 8, _pal(r, 256),
                                                  header=12),
    "8-bit top-down": lambda r, h, w: forge.bmp_bytes(r.integers(0, 256, (h, w)), 8,
                                                      _pal(r, 256), top_down=True),
    "RLE8": lambda r, h, w: forge.bmp_bytes(_blocky(r, h, w, 256), 8, _pal(r, 256), rle=True,
                                            delta=False),
    "RLE8 with deltas": lambda r, h, w: forge.bmp_bytes(_blocky(r, h, w, 256), 8,
                                                        _pal(r, 100), rle=True),
    "RLE8 top-down": lambda r, h, w: forge.bmp_bytes(_blocky(r, h, w, 256), 8, _pal(r, 256),
                                                     rle=True, top_down=True),
    "RLE4": lambda r, h, w: forge.bmp_bytes(_blocky(r, h, w, 16), 4, _pal(r, 16), rle=True,
                                            delta=False),
    "RLE4 with deltas": lambda r, h, w: forge.bmp_bytes(_blocky(r, h, w, 16), 4, _pal(r, 7),
                                                        rle=True),
    "16-bit 555": lambda r, h, w: forge.bmp_bytes(r.integers(0, 65536, (h, w)), 16),
    "16-bit 555 bitfields": lambda r, h, w: forge.bmp_bytes(r.integers(0, 65536, (h, w)), 16,
                                                            masks=forge.MASKS_555),
    "16-bit 565 bitfields": lambda r, h, w: forge.bmp_bytes(r.integers(0, 65536, (h, w)), 16,
                                                            masks=forge.MASKS_565),
    "16-bit 565 bitfields V4": lambda r, h, w: forge.bmp_bytes(
        r.integers(0, 65536, (h, w)), 16, masks=forge.MASKS_565, header=108),
    "16-bit 444 bitfields (refused)": lambda r, h, w: forge.bmp_bytes(
        r.integers(0, 65536, (h, w)), 16, masks=(0xF00, 0xF0, 0xF)),
    "24-bit": lambda r, h, w: forge.bmp_bytes(r.integers(0, 256, (h, w, 3)), 24),
    "24-bit OS/2": lambda r, h, w: forge.bmp_bytes(r.integers(0, 256, (h, w, 3)), 24,
                                                   header=12),
    "24-bit top-down V4": lambda r, h, w: forge.bmp_bytes(r.integers(0, 256, (h, w, 3)), 24,
                                                          header=108, top_down=True),
    "32-bit": lambda r, h, w: forge.bmp_bytes(r.integers(0, 256, (h, w, 4)), 32),
    "32-bit RGBA bitfields V5": lambda r, h, w: forge.bmp_bytes(
        r.integers(0, 256, (h, w, 4)), 32, masks=(0xFF, 0xFF00, 0xFF0000), header=124),
    "32-bit 10-bit bitfields V4": lambda r, h, w: forge.bmp_bytes(
        r.integers(0, 256, (h, w, 4)), 32, masks=(0x3FF00000, 0xFFC00, 0x3FF), header=108),
    "32-bit scattered bitfields V5": lambda r, h, w: forge.bmp_bytes(
        r.integers(0, 256, (h, w, 4)), 32, masks=(0xF0F000, 0xF0F, 0xF0000000), header=124),
    "32-bit bitfields V5, a zero mask": lambda r, h, w: forge.bmp_bytes(
        r.integers(0, 256, (h, w, 4)), 32, masks=(0, 0xFF00, 0xFF), header=124),
    "32-bit bitfields, masks after an INFO header": lambda r, h, w: forge.bmp_bytes(
        r.integers(0, 256, (h, w, 4)), 32, masks=(0xFF, 0xFF00, 0xFF0000)),
}


def _pnm(kind, maxval, comment=False):
    def make(r, h, w):
        s = r.integers(0, maxval + 1, (h, w, 3) if kind in (3, 6) else (h, w))
        if kind in (2, 3) and maxval > 1:
            s.reshape(-1)[0] = min(maxval + 9, 65535)   # ASCII samples above maxval
        return forge.pnm_bytes(s, kind, maxval, comment)
    return make


PXM_KINDS = {
    "P1": _pnm(1, 1), "P1 comments": _pnm(1, 1, True), "P4": _pnm(4, 1),
    "P2": _pnm(2, 255), "P2 maxval 100": _pnm(2, 100, True), "P2 maxval 1000": _pnm(2, 1000),
    "P3": _pnm(3, 255), "P3 maxval 7": _pnm(3, 7), "P3 16-bit": _pnm(3, 65535),
    "P5": _pnm(5, 255, True), "P5 maxval 100": _pnm(5, 100), "P5 maxval 1": _pnm(5, 1),
    "P5 maxval 1000": _pnm(5, 1000), "P5 16-bit": _pnm(5, 65535),
    "P6": _pnm(6, 255), "P6 maxval 200": _pnm(6, 200), "P6 16-bit": _pnm(6, 65535),
}


def _pam(tupltype, depth, maxval):
    def make(r, h, w):
        return forge.pam_bytes(r.integers(0, maxval + 1, (h, w, depth)), maxval, tupltype)
    return make


PAM_KINDS = {f"{t or 'no TUPLTYPE'} depth {d} maxval {m}": _pam(t, d, m) for t, d, ms in (
    (None, 1, (255, 1, 100, 65535)), (None, 3, (255, 1, 1000)), (None, 2, (255,)),
    ("BLACKANDWHITE", 1, (1, 255)), ("GRAYSCALE", 1, (255, 1000, 65535)),
    ("GRAYSCALE_ALPHA", 2, (255, 65535, 1)), ("RGB", 3, (255, 65535, 1)),
    ("RGB_ALPHA", 4, (255, 1000)), ("BLACKANDWHITE_ALPHA", 2, (1,)), ("RGB", 4, (255,)),
    ("GRAYSCALE", 3, (255,))) for m in ms}


def _pfm(channels, scale, special=False):
    def make(r, h, w):
        v = r.normal(128, 90, (h, w, 3) if channels == 3 else (h, w)).astype(np.float32)
        if special:   # ties, saturation, NaN and values past the int32 range
            flat = v.reshape(-1)
            sp = np.float32([0.5, 1.5, 2.5, 255.5, 254.5, -0.5, np.nan, 3e9, -np.inf, 256])
            flat[:min(len(sp), flat.size)] = sp[:flat.size]
        return forge.pfm_bytes(v, scale)
    return make


PFM_KINDS = {"PF": _pfm(3, -1.0), "PF big endian": _pfm(3, 1.0),
             "PF special values": _pfm(3, -1.0, True), "PF scale 3": _pfm(3, -3.0),
             "Pf": _pfm(1, -1.0), "Pf big endian scale 0.5": _pfm(1, 0.5),
             "Pf special values": _pfm(1, 1.0, True), "Pf scale 7": _pfm(1, -7.0)}


def _sun(depth, typ=1, cmap=None, maptype=None):
    def make(r, h, w):
        px = r.integers(0, 1 << depth, (h, w)) if depth <= 8 else \
            r.integers(0, 256, (h, w, depth // 8))
        m = cmap(r) if callable(cmap) else cmap
        return forge.sun_bytes(px, depth, typ, m, maptype)
    return make


SUN_KINDS = {
    "1-bit": _sun(1), "1-bit map": _sun(1, 1, lambda r: _pal(r, 2)),
    "8-bit": _sun(8), "8-bit RT_OLD": _sun(8, 0),
    "8-bit map": _sun(8, 1, lambda r: _pal(r, 256)),
    "8-bit 50-entry map": _sun(8, 1, lambda r: _pal(r, 50)),
    "8-bit equal map": _sun(8, 1, lambda r: np.repeat(_pal(r, 256)[:, :1], 3, axis=1)),
    "8-bit raw map (refused)": _sun(8, 1, lambda r: _pal(r, 256), maptype=2),
    "24-bit": _sun(24), "32-bit": _sun(32), "32-bit RT_OLD": _sun(32, 0),
    "8-bit RT_BYTE_ENCODED (refused)": _sun(8, 2), "24-bit RT_BYTE_ENCODED (refused)": _sun(24, 2),
    "24-bit RT_FORMAT_RGB (refused)": _sun(24, 3), "32-bit RT_FORMAT_RGB (refused)": _sun(32, 3),
}

KINDS = {**{("BMP", k): f for k, f in BMP_KINDS.items()},
         **{("PxM", k): f for k, f in PXM_KINDS.items()},
         **{("PAM", k): f for k, f in PAM_KINDS.items()},
         **{("PFM", k): f for k, f in PFM_KINDS.items()},
         **{("Sun raster", k): f for k, f in SUN_KINDS.items()}}


@pytest.mark.parametrize("fmt,kind", list(KINDS), ids=[f"{f} {k}" for f, k in KINDS])
def test_variant_reads_like_cv2(tmp_path, fmt, kind):
    """The variant at every size: cv2's bits in both reads, or no image
    where cv2 gives none."""
    rng = np.random.default_rng(zlib.crc32(f"{fmt} {kind}".encode()))
    for h, w in SIZES:
        data = KINDS[fmt, kind](rng, h, w)
        assert images.image_format(data[:64]) == fmt
        alpha = fmt == "PAM" and "_ALPHA" in kind
        _same_as_cv2(tmp_path / "x.img", data, (fmt, kind, h, w), (h, w) if alpha else None)


def test_refused_kinds_give_no_image_in_cv2(tmp_path):
    """The kinds marked refused (and a PFM read with another channel count
    than its own) give no image in cv2; the port raises Cv2Refuses."""
    rng = np.random.default_rng(3)
    refused = [(f, k) for f, k in KINDS if "refused" in k or k.startswith("BLACKANDWHITE_ALPHA")
               or k in ("RGB depth 4 maxval 255", "GRAYSCALE depth 3 maxval 255")]
    assert len(refused) == 9
    for fmt, kind in refused:
        data = KINDS[fmt, kind](rng, 7, 13)
        path = tmp_path / "x.img"
        path.write_bytes(data)
        for color in (False, True):
            assert _cv2_read(str(path), color) is None, kind
            with pytest.raises(native.Cv2Refuses):
                DECODERS[fmt].decode(data, color)
    for channels, color in ((3, False), (1, True)):
        data = _pfm(channels, -1.0)(rng, 7, 13)
        (tmp_path / "x.pfm").write_bytes(data)
        assert _cv2_read(str(tmp_path / "x.pfm"), color) is None
        with pytest.raises(native.Cv2Refuses, match="channel count"):
            pxm.decode(data, color)


def test_header_quirks_read_like_cv2(tmp_path):
    """Headers cv2 reads or refuses by its own parsing: PxM numbers, '#'
    right after a number, comments between them; PAM fields in any order,
    repeated, without a value, with trailing blanks, unknown, lower case,
    negative, too large; PFM tokens without leading whitespace, hex and
    signed scales, a scale of 0 or NaN; signatures with other separators;
    sizes that cv2.imread raises for."""
    tail = bytes(range(1, 200))
    cases = [b"P5\n#c\n2 2\n255\n", b"P5 2 2 255 ", b"P5\n2#c\n 2\n255\n", b"P5\n2 2\n255\r\n",
             b"P5\n2 2 255\n#c\n", b"P5\n+2 2\n255\n", b"P5\n2 2\n0\n", b"P5\n2 2\n65536\n",
             b"P5\n0 2\n255\n", b"P5\n2147483648 2\n255\n", b"P5\n2 2\n255#c\n",
             b"P5\t2 2 255\n", b"P2\n2 2\n255\n1 2 3 4", b"P1\n3 1\n0 1 0", b"P1\n2 1 021",
             b"P5\n1048577 1\n255\n"]
    pam = ["WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "TUPLTYPE GRAYSCALE\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "WIDTH 0\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "WIDTH 0\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 0\nMAXVAL 255\nENDHDR\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 1\nENDHDR\n", "WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 0\nENDHDR\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL -1\nENDHDR\n",
           "WIDTH 2\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "TUPLTYPE RGB\nTUPLTYPE GRAYSCALE\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "# c\nWIDTH 2\n#x\n\n\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "  WIDTH    2  \nHEIGHT\t2\rDEPTH 1\rMAXVAL 255\rENDHDR\r",
           "WIDTH 2x\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "WIDTH 2 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "WIDTH 99999999999\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nFOO 3\nENDHDR\n",
           "width 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE  \nENDHDR\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nTUPLTYPE\nENDHDR\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR x\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR \n",
           "WIDTHWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "WIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nTUPLTYPE \nENDHDR\n",
           "WIDTH 2\0x\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
           "WIDTH 2 \0\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"]
    cases += [b"P7\n" + p.encode() for p in pam]
    cases += [b"P7" + sep + pam[0].encode() for sep in (b"\r", b"\t", b" ")]
    cases += [b"Pf\n2 2\n-1.0\n", b"Pf\n2  2\n-1\n", b"Pf\n 2 2\n-1\n", b"Pf\n2 2 -1 ",
              b"Pf\n2\n2\n-1\n", b"Pf\n2 2\n-1e0\n", b"Pf\n2 2\n+1\n", b"Pf\n2 2\nabc\n",
              b"Pf\n2 2\n-0\n", b"Pf\n2 2\n0x1p1\n", b"Pf\n2 2\nnan\n", b"Pf\n2 2\n-inf\n",
              b"Pf\n2 2\n1e-50\n", b"Pf\n2 2\n-1\r", b"Pf\n2x 2\n-1\n", b"Pf\n2 2\n-1\xc3\n",
              b"Pf\r2 2\n-1\n", b"PF\n-3 1\n-1\n", b"Pf\n2 1048577\n-1\n"]
    for head in cases:
        _same_as_cv2(tmp_path / "x.img", head + tail, head)
    bmp_ok = forge.bmp_bytes(np.zeros((2, 2, 3), np.uint8), 24)
    sun_ok = forge.sun_bytes(np.zeros((2, 2, 3), np.uint8), 24)
    for data in (bmp_ok[:18] + (1 << 20 | 1).to_bytes(4, "little") + bmp_ok[22:],
                 bmp_ok[:18] + (1 << 15).to_bytes(4, "little") + (1 << 15 | 1).to_bytes(4, "little")
                 + bmp_ok[26:], bmp_ok[:14] + (20).to_bytes(4, "little") + bmp_ok[18:],
                 bmp_ok[:14] + (0).to_bytes(4, "little") + bmp_ok[18:],
                 sun_ok[:4] + (1 << 20 | 1).to_bytes(4, "big") + sun_ok[8:]):
        _same_as_cv2(tmp_path / "x.img", data + bytes(64), data[:30])


# ----------------------------------------------------------------------------
# cut and corrupted files
# ----------------------------------------------------------------------------

def _cut_files():
    r = np.random.default_rng(11)
    h, w = 5, 7
    b = _blocky(r, h, w, 8)
    return {
        "BMP 8-bit": forge.bmp_bytes(b, 8, _pal(r, 8)),
        "BMP RLE8": forge.bmp_bytes(b, 8, _pal(r, 8), rle=True),
        "BMP RLE4": forge.bmp_bytes(b, 4, _pal(r, 8), rle=True),
        "BMP 1-bit": forge.bmp_bytes(b % 2, 1, _pal(r, 2)),
        "BMP 16-bit 565": forge.bmp_bytes(r.integers(0, 65536, (h, w)), 16,
                                          masks=forge.MASKS_565),
        "BMP 24-bit OS/2": forge.bmp_bytes(r.integers(0, 256, (h, w, 3)), 24, header=12),
        "P1": forge.pnm_bytes(b % 2, 1), "P4": forge.pnm_bytes(b % 2, 4),
        "P2": forge.pnm_bytes(b * 11, 2, 100, comment=True),
        "P3": forge.pnm_bytes(r.integers(0, 256, (h, w, 3)), 3),
        "P5": forge.pnm_bytes(r.integers(0, 256, (h, w)), 5),
        "P6 16-bit": forge.pnm_bytes(r.integers(0, 65536, (h, w, 3)), 6, 65535),
        "PAM RGB": forge.pam_bytes(r.integers(0, 256, (h, w, 3)), 255, "RGB"),
        "PAM GRAYSCALE 16-bit": forge.pam_bytes(r.integers(0, 65536, (h, w)), 65535,
                                                "GRAYSCALE"),
        "PF": forge.pfm_bytes(r.normal(128, 90, (h, w, 3)), -1.0),
        "Pf": forge.pfm_bytes(r.normal(128, 90, (h, w)), 2.0),
        "Sun raster 8-bit map": forge.sun_bytes(b, 8, 1, _pal(r, 8)),
        "Sun raster 1-bit": forge.sun_bytes(b % 2, 1),
        "Sun raster 24-bit": forge.sun_bytes(r.integers(0, 256, (h, w, 3)), 24),
        "Sun raster 32-bit": forge.sun_bytes(r.integers(0, 256, (h, w, 4)), 32),
    }


CUT_FILES = _cut_files()


@pytest.mark.parametrize("name", list(CUT_FILES))
def test_cut_at_every_byte_like_cv2(tmp_path, name):
    data = CUT_FILES[name]
    for k in range(len(data)):
        _same_as_cv2(tmp_path / "x.img", data[:k], (name, k))


FUZZ_FILES = ("BMP RLE8", "BMP RLE4", "BMP 16-bit 565", "P2", "P6 16-bit", "PAM RGB", "PF",
              "Sun raster 8-bit map")


@pytest.mark.parametrize("name", FUZZ_FILES)
def test_bit_flips_like_cv2(tmp_path, name):
    """150 copies with 1-3 bits flipped anywhere (headers too): cv2's
    image, no image, or error, and the port's the same."""
    data = CUT_FILES[name]
    rng = np.random.default_rng(len(name))
    for i in range(150):
        b = bytearray(data)
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(0, len(b))] ^= 1 << int(rng.integers(0, 8))
        _same_as_cv2(tmp_path / "x.img", bytes(b), (name, i))


def test_decodes_on_threads_alike():
    """No shared state: the same files decoded on 8 threads at once give the
    bits of one thread."""
    files = [CUT_FILES[n] for n in ("BMP RLE8", "P3", "PAM RGB", "PF", "Sun raster 8-bit map")]
    jobs = [(d, c) for d in files for c in (True, False)]
    ref = [_port_read(d, c) for d, c in jobs]
    with ThreadPoolExecutor(max_workers=8) as ex:
        for _ in range(4):
            for a, b in zip(ex.map(lambda j: _port_read(*j), jobs), ref):
                np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------------
# load_mask and load_images against the JAX package
# ----------------------------------------------------------------------------

def _tripod(h, w):
    m = np.full((h, w), 200, np.uint8)
    m[h - h // 4:] = 0
    m[h // 2:, w // 2 - 2:w // 2 + 2] = 0
    m[1, 1] = 0
    return m


def _mask_files(h=30, w=61):
    m = _tripod(h, w)
    idx = (m > 0).astype(np.uint8)
    two = [[0, 0, 0], [200, 90, 30]]
    return {
        "BMP RLE8": forge.bmp_bytes(idx, 8, two, rle=True),
        "BMP 1-bit": forge.bmp_bytes(idx, 1, two),
        "PGM": forge.pnm_bytes(m, 5),
        "PBM": forge.pnm_bytes(1 - idx, 1),
        "PAM": forge.pam_bytes(m, 255, "GRAYSCALE"),
        "PFM": forge.pfm_bytes(m.astype(np.float32) / 100, -0.01),
        "Sun raster": forge.sun_bytes(idx, 8, 1, two),
    }


@pytest.mark.parametrize("name", list(_mask_files()))
def test_mask_matches_jax_package(tmp_path, name):
    """Each mask named mask.png, at its own size and nearest-resized up and
    down, as the JAX package's load_mask (cv2.imread + cv2.resize) gives
    it."""
    path = tmp_path / "mask.png"
    path.write_bytes(_mask_files()[name])
    for H, W in ((30, 61), (60, 122), (13, 29), (720, 1440)):
        ref = jpipe.load_mask(Config(mask_path=str(path)), H, W)
        out = images.load_mask(str(path), H, W)
        assert ref is not None and out is not None and out.dtype == bool
        np.testing.assert_array_equal(out, ref)
        assert not out.all()


def test_three_channel_pfm_mask_is_none_like_jax_package(tmp_path, caplog):
    """cv2 gives no gray image for a three-channel PFM: the JAX package's
    load_mask logs "Fail to read mask" and returns None, and so does the
    port's (it raised NotImplementedError before it read PFM)."""
    path = str(tmp_path / "mask.pfm")
    with open(path, "wb") as f:
        f.write(forge.pfm_bytes(np.full((6, 9, 3), 200, np.float32)))
    for load in (lambda: jpipe.load_mask(Config(mask_path=path), 12, 18),
                 lambda: images.load_mask(path, 12, 18)):
        caplog.clear()
        with caplog.at_level(logging.ERROR, logger="panovlm"):
            assert load() is None
        assert [r.getMessage() for r in caplog.records] == [f"Fail to read mask {path}"]
    assert images.read_image(path, True).shape == (6, 9, 3)


def test_size_cv2_raises_for_raises(tmp_path):
    """A BMP 2^20 + 1 pixels wide: cv2.imread raises (validateInputImageSize)
    and so does the JAX package's load_mask; the port raises Cv2Raises from
    read_image and load_mask, where a mask cv2 gives no image for is None."""
    data = forge.bmp_bytes(np.zeros((1, 2, 3), np.uint8), 24)
    data = data[:18] + (1 << 20 | 1).to_bytes(4, "little") + data[22:]
    path = str(tmp_path / "mask.png")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(cv2.error):
        jpipe.load_mask(Config(mask_path=path), 4, 8)
    for read in (lambda: images.read_image(path), lambda: images.load_mask(path, 4, 8)):
        with pytest.raises(native.Cv2Raises):
            read()


@pytest.mark.parametrize("color,scale", [(False, 0), (False, -1), (True, 0), (True, -1)])
def test_frames_of_these_formats_match_jax_package(tmp_path, color, scale):
    """A directory of .png files that hold BMP (24-bit, RLE8), PGM, PPM,
    PAM and Sun raster bytes: cv2 decodes by signature, so the JAX
    package's load_images reads them all, and the port's gives the same
    arrays."""
    rng = np.random.default_rng(7)
    h, w = 37, 75
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 128 + 90 * np.sin(yy / 4.0) * np.cos(xx / 6.0)
    rgb = np.clip(np.stack([base, 255 - base, (0.5 * base + 3 * xx) % 256], -1)
                  + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)
    g = rgb[..., 1]
    ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
    files = [forge.bmp_bytes(rgb, 24), forge.bmp_bytes(g, 8, ramp, rle=True),
             forge.pnm_bytes(g, 5), forge.pnm_bytes(rgb, 6), forge.pam_bytes(rgb, 255, "RGB"),
             forge.sun_bytes(g, 8, 1, ramp), forge.sun_bytes(rgb[..., ::-1], 24)]
    d = tmp_path / "images"
    d.mkdir()
    for i, data in enumerate(files):
        (d / f"{i:06d}.png").write_bytes(data)
    ref, names = jpipe.load_images(Config(image_path=str(d), scale=scale), color=color)
    out, names_t = images.load_images(str(d), scale, color=color)
    assert names_t == names and len(out) == len(files)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [0, -1, -2])
def test_pair_surgery_working_size_of_a_bmp_frame(tmp_path, scale):
    """pair_surgery's working size (it reads the first frame alone) of a
    frame.png that holds a BMP: the shape the JAX package's load_images
    gives."""
    from panovlm_tpu_torch import pair_surgery
    from panovlm_tpu_torch.config import Config as PortConfig
    d = tmp_path / "images"
    d.mkdir()
    (d / "000000.png").write_bytes(forge.bmp_bytes(np.zeros((37, 75), np.uint8), 8,
                                                   [[0, 0, 0]] * 2, rle=True))
    ref = jpipe.load_images(Config(image_path=str(d), scale=scale))[0][0].shape
    assert pair_surgery._working_size(PortConfig(image_path=str(d), scale=scale)) == ref


# ----------------------------------------------------------------------------
# chip_smoke.py phase 16 (f)'s probes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(cs.RASTER_PROBES))
def test_smoke_raster_probes_are_cv2s(name, tmp_path):
    """Each probe under 2 KB of base64, its digests those of cv2.imread of
    the file (colour in RGB order, gray; None where cv2 gives no image;
    PAM RGB_ALPHA read into 0-filled buffers), and the port's decoders
    give them."""
    b64, digests = cs.RASTER_PROBES[name]
    assert len(b64) < 2048, len(b64)
    data = base64.b64decode(b64)
    path = str(tmp_path / "probe")
    with open(path, "wb") as f:
        f.write(data)
    shape = (6, 11) if "ALPHA" in name else None
    for kind in ("color", "gray"):
        ref = _cv2_read(path, kind == "color", shape)
        assert not isinstance(ref, str), kind
        want = None if ref is None else hashlib.sha256(ref.tobytes()).hexdigest()
        assert want == digests[kind], kind
    cs.check_raster_probes(names=(name,))
