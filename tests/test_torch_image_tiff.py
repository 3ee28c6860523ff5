"""TIFF (native/tiff.cpp) against cv2.imread, bit for bit, in gray and in
colour (BGR -> RGB), on files tests/image_forge.py writes (tiff_bytes: any
layout, codec, predictor, byte order, tag) and on files PIL and cv2 write:

  * every variant at 1 x 1, 7 x 13, 37 x 53 and 129 x 257: strips and
    tiles, PlanarConfiguration 1 and 2, classic and BigTIFF in either byte
    order, FillOrder 2, the codecs none, PackBits, LZW (new-style and the
    old bit-reversed codes) and Deflate (8 and 32946) with and without
    horizontal differencing; MinIsWhite / MinIsBlack at 1, 8 and 16 bits,
    palettes at 1, 4 and 8 bits (8 and 16-bit colormaps), RGB at 8 and 16
    bits, CMYK, YCbCr at every subsampling libtiff converts, associated,
    unassociated and unspecified extra samples, CIE L*a*b* at 8 and 16
    bits, the eight orientations, a compression number libtiff has no
    codec for (an image of zeros);
  * the kinds cv2 gives no image for (the codecs its libtiff is built
    without, 2-bit gray, 4-bit gray, float and 32-bit samples, more than 4
    samples, orientations 5 to 8 on a non-square image, a predictor the
    codec refuses, broken directories) raise native.Cv2Refuses, and the
    codecs cv2 reads that the port does not yet (ThunderScan, SGILog) a
    plain NotImplementedError naming ROADMAP.md, and the CCITT and JPEG
    files that raised so before the port read them (tests/
    test_torch_image_tiff_codecs.py holds those codecs) cv2's bits;
  * 20 files cut at every byte and 8 with seeded bit flips: an image with
    cv2's bits exactly where cv2 gives one, no image where it gives none,
    native.Cv2Raises where cv2.imread raises (a flip that turns the codec
    into a queued one raises the queued codec's NotImplementedError);
  * decodes on 8 threads, and load_mask / load_images / pair surgery's
    working size against the JAX package's (cv2-based), tolerance 0;
  * chip_smoke.py phase 16 (h)'s probes, their digests recomputed with cv2.
"""

import base64
import hashlib
import io
import logging
import re
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline as jpipe
from panovlm_tpu.config import Config
from panovlm_tpu_torch import native
from panovlm_tpu_torch.io import images
from panovlm_tpu_torch.native import tiff

import chip_smoke as cs
import image_forge as forge

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

SIZES = ((1, 1), (7, 13), (37, 53), (129, 257))
QUEUED = re.compile(r"(ThunderScan|SGILog).*ROADMAP")


def _cv2_read(path, color):
    """cv2.imread's outcome: the image (RGB for a colour read), None where it
    gives none, "raises" where it raises."""
    try:
        img = cv2.imread(path, cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
    except cv2.error:
        return "raises"
    if img is None:
        return None
    return np.ascontiguousarray(img[..., ::-1]) if color else img


def _port_read(data: bytes, color: bool):
    """The port's outcome on the same bytes, as _cv2_read gives cv2's, or
    ("queued", message) for a codec the port does not read yet."""
    if images.image_format(data[:64]) != "TIFF":
        return None
    try:
        return tiff.decode(data, color)
    except native.Cv2Raises:
        return "raises"
    except native.Cv2Refuses:
        return None
    except NotImplementedError as e:
        return ("queued", str(e))


def _outcome(x):
    return x.shape if isinstance(x, np.ndarray) else x


def _same_as_cv2(path, data: bytes, tag) -> int:
    """Both reads of data (written to path) against cv2's; returns the
    number of reads the port left to a queued codec (each checked to name
    it and ROADMAP.md)."""
    with open(path, "wb") as f:
        f.write(data)
    queued = 0
    for color in (False, True):
        ref, out = _cv2_read(str(path), color), _port_read(data, color)
        if isinstance(out, tuple):
            assert QUEUED.search(out[1]), (tag, out[1])
            queued += 1
            continue
        assert _outcome(out) == _outcome(ref), (tag, color)
        if isinstance(ref, np.ndarray):
            assert out.dtype == np.uint8, tag
            np.testing.assert_array_equal(out, ref, err_msg=f"{tag} color={color}")
    return queued


def _pil(arr, compression, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "TIFF", compression=compression, **kw)
    return buf.getvalue()


# ----------------------------------------------------------------------------
# every variant at every size
# ----------------------------------------------------------------------------

def _u(bits):
    return lambda r, h, w, c=1: r.integers(0, 1 << bits, (h, w, c) if c > 1 else (h, w))


def _kind(photometric, bits=8, spp=1, **kw):
    def make(r, h, w):
        s = _u(bits)(r, h, w, spp)
        if photometric == 3:
            kw.setdefault("colormap", r.integers(0, 65536, (1 << bits, 3)))
        return forge.tiff_bytes(s, photometric, bits, **kw)
    return make


def _alpha(photometric, bits, spp, extra, **kw):
    def make(r, h, w):
        s = _u(bits)(r, h, w, spp)
        a = s[..., -1]
        a[r.random((h, w)) < 0.3] = 0
        a[r.random((h, w)) < 0.3] = (1 << bits) - 1
        return forge.tiff_bytes(s, photometric, bits, extra=extra, **kw)
    return make


def _palette(bits, small, **kw):
    def make(r, h, w):
        cmap = r.integers(0, 256 if small else 65536, (1 << bits, 3))
        return forge.tiff_bytes(_u(bits)(r, h, w), 3, bits, colormap=cmap, **kw)
    return make


def _pil_kind(mode, compression):
    def make(r, h, w):
        if mode == "1":
            return _pil(r.random((h, w)) < 0.5, compression)
        c = {"L": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
        arr = r.integers(0, 256, (h, w, c) if c > 1 else (h, w)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "TIFF", compression=compression)
        return buf.getvalue()
    return make


def _pil_pages(r, h, w):
    im = Image.fromarray(r.integers(0, 256, (h, w, 3)).astype(np.uint8))
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression="tiff_lzw", save_all=True,
            append_images=[im.transpose(Image.Transpose.FLIP_LEFT_RIGHT)])
    return buf.getvalue()


T16 = (16, 16)
KINDS = {
    # gray
    "1-bit MinIsBlack": _kind(1, 1),
    "1-bit MinIsWhite PackBits": _kind(0, 1, compression=32773),
    "1-bit MinIsWhite tiles FillOrder 2": _kind(0, 1, tile=T16, fill_order=2),
    "8-bit": _kind(1),
    "8-bit MinIsWhite": _kind(0),
    "8-bit strips of 3 rows": _kind(1, rows_per_strip=3),
    "8-bit PackBits": _kind(1, compression=32773),
    "8-bit LZW": _kind(1, compression=5),
    "8-bit LZW predictor": _kind(1, compression=5, predictor=2, rows_per_strip=5),
    "8-bit compat LZW": _kind(1, compression=5, lzw_compat=True),
    "8-bit compat LZW predictor": _kind(1, compression=5, lzw_compat=True, predictor=2),
    "8-bit Deflate 8": _kind(1, compression=8),
    "8-bit Deflate 32946 predictor": _kind(1, compression=32946, predictor=2),
    "8-bit tiles": _kind(1, tile=T16),
    "8-bit tiles 32x16 LZW predictor": _kind(1, tile=(32, 16), compression=5, predictor=2),
    "8-bit planar 2": _kind(1, planar=2),
    "8-bit big-endian": _kind(1, big_endian=True, compression=5),
    "8-bit BigTIFF": _kind(1, bigtiff=True, compression=8),
    "8-bit BigTIFF big-endian tiles": _kind(1, bigtiff=True, big_endian=True, tile=T16),
    "8-bit data before the IFD": _kind(1, ifd_first=False, rows_per_strip=4),
    "8-bit FillOrder 2 LZW": _kind(1, compression=5, fill_order=2),
    "8-bit signed": _kind(1, sample_format=2),
    "8-bit unknown compression 9": _kind(0, compression=9),
    "16-bit": _kind(1, 16),
    "16-bit MinIsWhite": _kind(0, 16),
    "16-bit big-endian LZW predictor": _kind(1, 16, big_endian=True, compression=5, predictor=2),
    "16-bit Deflate predictor tiles": _kind(1, 16, compression=8, predictor=2, tile=T16),
    "16-bit signed": _kind(1, 16, sample_format=2),
    # palettes
    "palette 1-bit": _palette(1, False),
    "palette 4-bit": _palette(4, False, compression=5),
    "palette 4-bit 8-bit colormap": _palette(4, True),
    "palette 8-bit": _palette(8, False, compression=32773),
    "palette 8-bit 8-bit colormap tiles": _palette(8, True, tile=T16),
    # RGB
    "RGB 8-bit": _kind(2, spp=3),
    "RGB 8-bit LZW predictor": _kind(2, spp=3, compression=5, predictor=2, rows_per_strip=4),
    "RGB 8-bit compat LZW predictor": _kind(2, spp=3, compression=5, lzw_compat=True,
                                            predictor=2),
    "RGB 8-bit Deflate tiles": _kind(2, spp=3, compression=8, tile=(16, 32)),
    "RGB 8-bit PackBits planar": _kind(2, spp=3, compression=32773, planar=2, rows_per_strip=6),
    "RGB 8-bit planar tiles LZW predictor": _kind(2, spp=3, planar=2, tile=T16, compression=5,
                                                  predictor=2),
    "RGB 8-bit BigTIFF big-endian": _kind(2, spp=3, bigtiff=True, big_endian=True,
                                          compression=32946),
    "RGB 16-bit": _kind(2, 16, 3),
    "RGB 16-bit big-endian Deflate predictor": _kind(2, 16, 3, big_endian=True, compression=8,
                                                     predictor=2),
    "RGB 16-bit planar tiles": _kind(2, 16, 3, planar=2, tile=T16),
    # extra samples
    "RGBA unassociated": _alpha(2, 8, 4, (2,)),
    "RGBA unassociated planar LZW": _alpha(2, 8, 4, (2,), planar=2, compression=5),
    "RGBA associated tiles": _alpha(2, 8, 4, (1,), tile=T16),
    "RGBA unspecified": _alpha(2, 8, 4, (0,)),
    "RGBA without ExtraSamples": _alpha(2, 8, 4, ()),
    "RGBA 16-bit unassociated": _alpha(2, 16, 4, (2,), compression=8, predictor=2),
    "RGBA 16-bit associated planar": _alpha(2, 16, 4, (1,), planar=2),
    "gray + unassociated alpha": _alpha(1, 8, 2, (2,)),
    "gray + associated alpha planar": _alpha(1, 8, 2, (1,), planar=2),
    "gray + unspecified sample tiles": _alpha(1, 8, 2, (0,), tile=T16),
    "gray 16-bit + alpha": _alpha(1, 16, 2, (2,)),
    "gray + unspecified + alpha": _alpha(1, 8, 3, (0, 2)),
    # CMYK
    "CMYK": _kind(5, spp=4),
    "CMYK LZW predictor": _kind(5, spp=4, compression=5, predictor=2),
    "CMYK planar": _kind(5, spp=4, planar=2),
    "CMYK tiles": _kind(5, spp=4, tile=T16),
    # YCbCr
    **{f"YCbCr {a}:{b}": _kind(6, spp=3, subsampling=(a, b), rows_per_strip=8)
       for a, b in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2))},
    "YCbCr 2:2 LZW ReferenceBlackWhite": _kind(6, spp=3, subsampling=(2, 2), compression=5,
                                               ref_bw=(16, 235, 128, 240, 128, 240)),
    "YCbCr 4:4 tiles": _kind(6, spp=3, subsampling=(4, 4), tile=T16),
    "YCbCr 2:2 coefficients": _kind(6, spp=3, subsampling=(2, 2), tags={
        529: (forge.RATIONAL, [2990, 10000, 5870, 10000, 1140, 10000])}),
    "YCbCr planar 1:1": _kind(6, spp=3, planar=2, tags={530: (forge.SHORT, [1, 1])}),
    # CIE L*a*b*
    "CIE L*a*b* 8-bit": _kind(8, spp=3),
    "CIE L*a*b* 16-bit LZW predictor tiles": _kind(8, 16, 3, compression=5, predictor=2,
                                                   tile=T16),
    "CIE L*a*b* D65 white point": _kind(8, spp=3, tags={
        318: (forge.RATIONAL, [3127, 10000, 3290, 10000])}),
    # orientations, on strips, tiles and planes
    **{f"orientation {o}": _kind(2, spp=3, orientation=o, rows_per_strip=3) for o in range(1, 9)},
    **{f"orientation {o} tiles": _kind(2, spp=3, orientation=o, tile=T16) for o in (2, 3, 6, 8)},
    "orientation 7 planar 1-bit": _kind(0, 1, orientation=7, tile=T16),
    # other writers
    "PIL L LZW": _pil_kind("L", "tiff_lzw"),
    "PIL RGB Deflate": _pil_kind("RGB", "tiff_adobe_deflate"),
    "PIL RGBA PackBits": _pil_kind("RGBA", "packbits"),
    "PIL CMYK raw": _pil_kind("CMYK", "raw"),
    "PIL 1-bit LZW": _pil_kind("1", "tiff_lzw"),
    "PIL two pages": _pil_pages,
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_variant_reads_like_cv2(tmp_path, kind):
    """The variant at every size: cv2's bits in both reads, or no image where
    cv2 gives none (orientations 5 to 8 on a non-square image)."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    for h, w in SIZES:
        data = KINDS[kind](rng, h, w)
        assert images.image_format(data[:64]) == "TIFF"
        assert _same_as_cv2(tmp_path / "x.tif", data, (kind, h, w)) == 0
        if re.match(r"orientation [5-8]", kind) and h != w:
            assert _cv2_read(str(tmp_path / "x.tif"), False) is None


def _refused():
    r = np.random.default_rng(5)
    h, w = 7, 13
    g = r.integers(0, 256, (h, w))
    rgb = r.integers(0, 256, (h, w, 3))
    out = {f"compression {c}": forge.tiff_bytes(g, 1, compression=c)
           for c in (6, 32909, 34661, 34887, 34925, 50000, 50001)}
    out.update({
        "2-bit gray": forge.tiff_bytes(g % 4, 1, 2),
        "4-bit gray": forge.tiff_bytes(g % 16, 1, 4),
        "12-bit gray": forge.tiff_bytes(g * 16, 1, 12),
        "2-bit palette": forge.tiff_bytes(g % 4, 3, 2, colormap=r.integers(0, 65536, (4, 3))),
        "16-bit palette": forge.tiff_bytes(g, 3, 16, colormap=r.integers(0, 65536, (65536, 3))),
        "float32": forge.tiff_bytes(g, 1, 32, sample_format=3),
        "uint32": forge.tiff_bytes(g, 1, 32),
        "void samples": forge.tiff_bytes(g, 1, sample_format=4),
        "RGB + 2 extra samples": forge.tiff_bytes(r.integers(0, 256, (h, w, 5)), 2, extra=(0, 2)),
        "RGB 1-bit": forge.tiff_bytes(rgb % 2, 2, 1),
        "CMYK 16-bit": forge.tiff_bytes(r.integers(0, 65536, (h, w, 4)), 5, 16),
        "NeXT 2-bit": forge.tiff_bytes(g % 4, 1, 2, compression=32766),
        "ThunderScan 4-bit gray": forge.tiff_bytes(g % 16, 1, 4, compression=32809),
        "CCITT 8-bit": forge.tiff_bytes(g, 1, compression=4),
        "predictor 0": forge.tiff_bytes(g, 1, compression=5, tags={317: (forge.SHORT, [0])}),
        "predictor 3 integers": forge.tiff_bytes(g, 1, compression=8, predictor=3),
        "predictor 2 on 4-bit": forge.tiff_bytes(g % 16, 3, 4, compression=5, predictor=2,
                                                 colormap=r.integers(0, 65536, (16, 3))),
        "orientation 6 not square": forge.tiff_bytes(rgb, 2, orientation=6),
        "YCbCr 2:4": forge.tiff_bytes(rgb, 6, subsampling=(2, 4), rows_per_strip=8),
        "no PhotometricInterpretation": forge.tiff_bytes(g, 1, drop=(262,)),
        "no StripOffsets": forge.tiff_bytes(g, 1, drop=(273,)),
        "no StripByteCounts, 2 strips": forge.tiff_bytes(g, 1, rows_per_strip=4, drop=(279,)),
        "RowsPerStrip 0": forge.tiff_bytes(g, 1, tags={278: (forge.LONG, [0])}),
        "RowsPerStrip 2^24 + 1": forge.tiff_bytes(g, 1, tags={278: (forge.LONG, [(1 << 24) + 1])}),
        "uncompressed tile 1 byte short": forge.tiff_bytes(
            rgb, 2, tile=T16, tags={325: (forge.LONG, [767])}),
        "CIE L*a*b* planar": forge.tiff_bytes(rgb, 8, planar=2),
        "a directory of 0 entries": b"II*\x00\x08\x00\x00\x00\x00\x00\x00\x00\x00\x00",
    })
    return out


@pytest.mark.parametrize("name", list(_refused()))
def test_refused_kinds_give_no_image_in_cv2(tmp_path, name):
    """cv2 gives no image for each: the port raises Cv2Refuses (load_mask's
    None)."""
    data = _refused()[name]
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    for color in (False, True):
        assert _cv2_read(str(path), color) is None, name
        with pytest.raises(native.Cv2Refuses):
            tiff.decode(data, color)


def _codec_files():
    r = np.random.default_rng(6)
    h, w = 13, 21
    bw = r.random((h, w)) < 0.5
    rgb = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
    s4 = r.integers(0, 16, (h, w))
    L = r.integers(0, 32768, (h, w))
    logl = b"".join(bytes([w]) + bytes(((row >> s) & 255).astype(np.uint8))
                    for row in L for s in (8, 0))   # per row two literal byte planes
    return {
        "CCITT RLE (2)": _pil(bw, "tiff_ccitt"),
        "CCITT Group 3 (3)": _pil(bw, "group3"),
        "CCITT Group 4 (4)": _pil(bw, "group4"),
        "CCITT RLE/W (32771)": forge.tiff_bytes(bw.astype(int), 0, 1, compression=32771),
        "JPEG (7)": _pil(rgb, "jpeg"),
        "ThunderScan (32809)": forge.tiff_bytes(
            s4, 3, 4, compression=32809, colormap=r.integers(0, 65536, (16, 3)),
            chunks=[bytes(0xC0 | int(v) for v in s4.reshape(-1))]),
        "SGILog (34676)": forge.tiff_bytes(L, 32844, 16, compression=34676, sample_format=2,
                                           chunks=[logl]),
    }


def _queued():
    return {k: v for k, v in _codec_files().items() if k.startswith(("ThunderScan", "SGILog"))}


def _formerly_queued():
    return {k: v for k, v in _codec_files().items() if k not in _queued()}


@pytest.mark.parametrize("name", list(_formerly_queued()))
def test_formerly_queued_kinds_read_like_cv2(tmp_path, name):
    """The CCITT and JPEG files the port raised for before it read these
    codecs: cv2's bits in both reads through read_image (the file named
    mask.png), and the JAX package's load_mask (tests/
    test_torch_image_tiff_codecs.py holds every variant)."""
    data = _formerly_queued()[name]
    path = str(tmp_path / "mask.png")
    with open(path, "wb") as f:
        f.write(data)
    for color in (False, True):
        ref = _cv2_read(path, color)
        assert isinstance(ref, np.ndarray), name
        np.testing.assert_array_equal(images.read_image(path, color), ref)
    np.testing.assert_array_equal(images.load_mask(path, 8, 16),
                                  jpipe.load_mask(Config(mask_path=path), 8, 16))


@pytest.mark.parametrize("name", list(_queued()))
def test_queued_kinds_raise_naming_roadmap(tmp_path, name):
    """cv2 reads each; the port raises a plain NotImplementedError naming the
    codec and ROADMAP.md, and a mask of it raises too (it does not become
    None)."""
    data = _queued()[name]
    path = str(tmp_path / "mask.png")
    with open(path, "wb") as f:
        f.write(data)
    for color in (False, True):
        assert isinstance(_cv2_read(path, color), np.ndarray), name
        with pytest.raises(NotImplementedError) as e:
            images.read_image(path, color)
        assert not isinstance(e.value, native.Cv2Refuses)
        assert name.split(" (")[0] in str(e.value)
        assert "ROADMAP" in str(e.value)
    with pytest.raises(NotImplementedError) as e:
        images.load_mask(path, 8, 16)
    assert not isinstance(e.value, native.Cv2Refuses)


def test_header_quirks_read_like_cv2(tmp_path):
    """Directories libtiff repairs or reads its own way: a missing or
    implausible StripByteCounts, short strip arrays, missing optional
    tags, values OpenCV or libtiff drop, duplicated tags, unsorted tags,
    RowsPerStrip past the image, the compression-ratio check on huge
    tiles, sizes cv2.imread raises for."""
    r = np.random.default_rng(9)
    g = r.integers(0, 256, (7, 13))
    rgb = r.integers(0, 256, (7, 13, 3))
    L, S, B = forge.LONG, forge.SHORT, forge.BYTE
    cases = [
        forge.tiff_bytes(g, 1, drop=(279,)),
        forge.tiff_bytes(g, 1, compression=8, drop=(279,)),
        forge.tiff_bytes(rgb, 2, planar=2, compression=5, drop=(279,)),
        forge.tiff_bytes(g, 1, tags={279: (L, [0])}),
        forge.tiff_bytes(g, 1, tags={279: (L, [50])}),
        forge.tiff_bytes(g, 1, compression=32773, tags={279: (L, [0])}),
        forge.tiff_bytes(g, 1, rows_per_strip=2, tags={279: (L, [26, 20, 26, 13])}),
        forge.tiff_bytes(g, 1, rows_per_strip=2, tags={279: (L, [26, 26])}),
        forge.tiff_bytes(g, 1, rows_per_strip=2, tags={273: (L, [400])}),
        forge.tiff_bytes(g, 1, drop=(258,)), forge.tiff_bytes(g, 1, drop=(277,)),
        forge.tiff_bytes(g, 1, drop=(259,)), forge.tiff_bytes(g, 1, drop=(284,)),
        forge.tiff_bytes(g, 1, drop=(278,)), forge.tiff_bytes(g, 1, drop=(256,)),
        forge.tiff_bytes(g, 1, drop=(257,)),
        forge.tiff_bytes(g, 1, tags={274: (S, [0])}), forge.tiff_bytes(g, 1, tags={274: (S, [9])}),
        forge.tiff_bytes(g, 1, tags={266: (S, [3])}), forge.tiff_bytes(g, 1, tags={284: (S, [3])}),
        forge.tiff_bytes(g, 1, tags={339: (S, [7])}), forge.tiff_bytes(g, 1, tags={338: (S, [4])}),
        forge.tiff_bytes(g, 1, tags={258: (S, [8, 8])}),
        forge.tiff_bytes(rgb, 2, tags={258: (S, [8, 16, 8])}),
        forge.tiff_bytes(rgb, 2, tags={258: (S, [8, 8, 8, 8, 16])}),
        forge.tiff_bytes(g, 1, tags={256: (S, [13]), 257: (B, [7])}),
        forge.tiff_bytes(g, 1, tags={256: (forge.ASCII, b"abc\0")}),
        forge.tiff_bytes(g, 1, tags={262: (forge.DOUBLE, [1.0])}),
        forge.tiff_bytes(g, 1, tags={257: (forge.LONG8, [7])}),
        forge.tiff_bytes(g, 1, tags={257: (L, [7, 7])}),
        forge.tiff_bytes(g, 3, tags={320: (S, [0] * 767)}),
        forge.tiff_bytes(g, 3, bits=8, tags={320: (S, list(range(768)))}),
        forge.tiff_bytes(g, 1, tags={278: (L, [20])}),
        forge.tiff_bytes(g, 1, tags={278: (L, [1 << 24])}),
        forge.tiff_bytes(g, 1, tags={278: (L, [0xFFFFFFFE])}),
        forge.tiff_bytes(g, 1, tags={278: (L, [0xFFFFFFFF])}),
        forge.tiff_bytes(g, 1, tags={278: (L, [(1 << 31) - 1])}),
        forge.tiff_bytes(g, 1, tile=(8, 8)), forge.tiff_bytes(g % 2, 1, 1, tile=(12, 5)),
        forge.tiff_bytes(g, 1, tile=T16, tags={322: (L, [1 << 25])}),
        forge.tiff_bytes(g, 1, tile=T16, drop=(323,)),
        forge.tiff_bytes(np.zeros((1, 1), int), 1, compression=8, tile=(8192, 16384),
                         chunks=[bytes(100)], tags={256: (L, [8192]), 257: (L, [16384])}),
        forge.tiff_bytes(g, 1, tags={256: (L, [(1 << 20) + 1])}),
        forge.tiff_bytes(g, 1, tags={256: (L, [1 << 31])}),
        forge.tiff_bytes(g, 1, tags={257: (L, [0])}),
        forge.tiff_bytes(g, 1, tags={277: (S, [0])}),
        forge.tiff_bytes(rgb, 2, extra=(999,)),
    ]
    base = forge.tiff_bytes(g, 1)
    cases += [base[:8] + bytes([base[8] + 1, 0]) + base[10:],          # one entry more
              base[:4] + (1 << 31).to_bytes(4, "little") + base[8:],    # IFD past the end
              base[:4] + b"\x00\x00\x00\x00" + base[8:],                # IFD at offset 0
              base[:10] + base[22:34] + base[10:22] + base[34:],        # unsorted entries
              base[:22] + base[10:22] + base[34:]]                      # a duplicated entry
    for k, data in enumerate(cases):
        _same_as_cv2(tmp_path / "x.tif", data, k)


# ----------------------------------------------------------------------------
# cut and corrupted files
# ----------------------------------------------------------------------------

def _cut_files():
    r = np.random.default_rng(11)
    h, w = 5, 7
    g = r.integers(0, 256, (h, w))
    rgb = r.integers(0, 256, (h, w, 3))
    return {
        "none gray": forge.tiff_bytes(g, 1),
        "none RGB strips": forge.tiff_bytes(rgb, 2, rows_per_strip=2),
        "1-bit PackBits": forge.tiff_bytes(g % 2, 0, 1, compression=32773),
        "LZW predictor RGB": forge.tiff_bytes(rgb, 2, compression=5, predictor=2,
                                              rows_per_strip=2),
        "LZW compat": forge.tiff_bytes(g, 1, compression=5, lzw_compat=True),
        "LZW planar tiles": forge.tiff_bytes(rgb, 2, compression=5, planar=2, tile=T16),
        "Deflate tiles": forge.tiff_bytes(rgb, 2, compression=8, tile=T16),
        "Deflate 32946 predictor 16-bit": forge.tiff_bytes(g * 257, 1, 16, compression=32946,
                                                           predictor=2),
        "PackBits planar": forge.tiff_bytes(rgb // 64 * 60, 2, compression=32773, planar=2),
        "16-bit big-endian Deflate predictor": forge.tiff_bytes(
            r.integers(0, 65536, (h, w, 3)), 2, 16, big_endian=True, compression=8, predictor=2),
        "palette 4-bit LZW": forge.tiff_bytes(g % 16, 3, 4, colormap=r.integers(0, 65536, (16, 3)),
                                              compression=5),
        "palette 4-bit tiles": forge.tiff_bytes(g % 16, 3, 4, colormap=r.integers(0, 256, (16, 3)),
                                                tile=T16),
        "YCbCr 2:2": forge.tiff_bytes(rgb, 6, subsampling=(2, 2), rows_per_strip=2),
        "RGBA unassociated Deflate": forge.tiff_bytes(r.integers(0, 256, (h, w, 4)), 2, extra=(2,),
                                                      compression=32946),
        "CMYK LZW": forge.tiff_bytes(r.integers(0, 256, (h, w, 4)), 5, compression=5),
        "gray + alpha planar": forge.tiff_bytes(r.integers(0, 256, (h, w, 2)), 1, extra=(2,),
                                                planar=2),
        "BigTIFF LZW": forge.tiff_bytes(g, 1, bigtiff=True, compression=5),
        "BigTIFF big-endian tiles": forge.tiff_bytes(rgb, 2, bigtiff=True, big_endian=True,
                                                     tile=T16, compression=32773),
        "data before the IFD": forge.tiff_bytes(rgb, 2, compression=32773, ifd_first=False,
                                                rows_per_strip=2),
        "orientation 3 FillOrder 2": forge.tiff_bytes(g, 1, orientation=3, fill_order=2,
                                                      compression=5),
    }


CUT_FILES = _cut_files()


@pytest.mark.parametrize("name", list(CUT_FILES))
def test_cut_at_every_byte_like_cv2(tmp_path, name):
    data = CUT_FILES[name]
    for k in range(len(data)):
        if data[:4] == data[:k][:4]:   # shorter prefixes have no TIFF signature
            _same_as_cv2(tmp_path / "x.tif", data[:k], (name, k))


FUZZ_FILES = ("none RGB strips", "LZW predictor RGB", "LZW compat", "Deflate tiles",
              "PackBits planar", "16-bit big-endian Deflate predictor", "palette 4-bit LZW",
              "YCbCr 2:2")


@pytest.mark.parametrize("name", FUZZ_FILES)
def test_bit_flips_like_cv2(tmp_path, name):
    """150 copies with 1-3 bits flipped anywhere but in the signature: cv2's
    image, no image, or error, and the port's the same."""
    data = CUT_FILES[name]
    rng = np.random.default_rng(len(name))
    queued = 0
    for i in range(150):
        b = bytearray(data)
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(4, len(b))] ^= 1 << int(rng.integers(0, 8))
        queued += _same_as_cv2(tmp_path / "x.tif", bytes(b), (name, i))
    assert queued <= 10


@pytest.mark.parametrize("compat", [False, True])
def test_forge_lzw_in_cpp_writes_the_python_codes(compat):
    """tests/tiff_forge.cpp, which codes the full-size frames of phase 16 (h),
    writes the codes of image_forge.tiff_lzw_py, clear codes of a full
    table included."""
    rng = np.random.default_rng(13)
    data = (np.repeat(rng.integers(0, 6, 40000), rng.integers(1, 9, 40000))[:200000]
            .astype(np.uint8).tobytes())
    assert len(data) > 1 << 16
    assert forge.tiff_lzw(data, compat) == forge.tiff_lzw_py(data, compat)


def test_decodes_on_threads_alike():
    """No shared state: the same files decoded on 8 threads at once give the
    bits of one thread."""
    files = [CUT_FILES[n] for n in ("LZW predictor RGB", "LZW compat", "Deflate tiles",
                                    "YCbCr 2:2", "palette 4-bit LZW", "PackBits planar")]
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
    return {
        "LZW tiles": forge.tiff_bytes(m, 1, compression=5, tile=T16),
        "Deflate predictor": forge.tiff_bytes(m, 1, compression=8, predictor=2, rows_per_strip=7),
        "PackBits 1-bit MinIsWhite": forge.tiff_bytes((m == 0).astype(int), 0, 1,
                                                      compression=32773),
        "palette": forge.tiff_bytes((m > 0).astype(int), 3, 1,
                                    colormap=[[0, 0, 0], [51400, 23130, 7710]]),
        "RGB compat LZW": forge.tiff_bytes(np.repeat(m[..., None], 3, axis=2), 2, compression=5,
                                           lzw_compat=True),
        "16-bit big-endian": forge.tiff_bytes(m.astype(int) * 257, 1, 16, big_endian=True),
        "orientation 4": forge.tiff_bytes(m[::-1], 1, orientation=4, compression=5),
        "PIL LZW": _pil(m, "tiff_lzw"),
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


def test_orientation_6_masks_like_jax_package(tmp_path, caplog):
    """Orientation 6 (turned 90 degrees): cv2.imread transposes the image in
    place, so a square mask reads transposed (and its resize follows the
    JAX package's), and a non-square one gives no image: the JAX package's
    load_mask logs "Fail to read mask" and returns None, and so does the
    port's."""
    m = _tripod(30, 30)
    m[3:9, 20:26] = 0
    path = str(tmp_path / "mask.tif")
    with open(path, "wb") as f:
        f.write(forge.tiff_bytes(m, 1, orientation=6, compression=5))
    for H, W in ((30, 30), (45, 80), (16, 9)):
        ref = jpipe.load_mask(Config(mask_path=path), H, W)
        out = images.load_mask(path, H, W)
        assert ref is not None
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(images.read_image(path), m.T[:, ::-1])
    with open(path, "wb") as f:
        f.write(forge.tiff_bytes(_tripod(30, 61), 1, orientation=6, compression=5))
    for load in (lambda: jpipe.load_mask(Config(mask_path=path), 61, 30),
                 lambda: images.load_mask(path, 61, 30)):
        caplog.clear()
        with caplog.at_level(logging.ERROR, logger="panovlm"):
            assert load() is None
        assert [r.getMessage() for r in caplog.records] == [f"Fail to read mask {path}"]


def test_size_cv2_raises_for_raises(tmp_path):
    """A TIFF 2^20 + 1 pixels wide: cv2.imread raises (validateInputImageSize)
    and so does the JAX package's load_mask; the port raises Cv2Raises from
    read_image and load_mask."""
    data = forge.tiff_bytes(np.zeros((1, 2), int), 1, tags={256: (forge.LONG, [(1 << 20) + 1])})
    path = str(tmp_path / "mask.png")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(cv2.error):
        jpipe.load_mask(Config(mask_path=path), 4, 8)
    for read in (lambda: images.read_image(path), lambda: images.load_mask(path, 4, 8)):
        with pytest.raises(native.Cv2Raises):
            read()


def _frames(h=37, w=75):
    rng = np.random.default_rng(7)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 128 + 90 * np.sin(yy / 4.0) * np.cos(xx / 6.0)
    rgb = np.clip(np.stack([base, 255 - base, (0.5 * base + 3 * xx) % 256], -1)
                  + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)
    g = rgb[..., 1]
    return [forge.tiff_bytes(rgb, 2, compression=5, predictor=2, rows_per_strip=8),
            forge.tiff_bytes(rgb, 2, compression=8, tile=T16),
            forge.tiff_bytes(g, 1, compression=32773),
            forge.tiff_bytes(g.astype(int) * 257, 1, 16, compression=8, predictor=2),
            forge.tiff_bytes(rgb.astype(int) * 257, 2, 16, planar=2),
            forge.tiff_bytes(rgb, 6, subsampling=(2, 2), rows_per_strip=8),
            _pil(rgb, "tiff_lzw")]


@pytest.mark.parametrize("color,scale", [(False, 0), (False, -1), (True, 0), (True, -1)])
def test_frames_of_tiff_bytes_match_jax_package(tmp_path, color, scale):
    """A directory of .png files that hold TIFF bytes (LZW with the
    predictor, Deflate tiles, PackBits gray, 16-bit gray and planar RGB,
    YCbCr 4:2:0, PIL's LZW): cv2 decodes by signature, so the JAX package's
    load_images reads them all, and the port's gives the same arrays."""
    files = _frames()
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
def test_pair_surgery_working_size_of_a_tiff_frame(tmp_path, scale):
    """pair_surgery's working size (it reads the first frame alone) of a
    frame.png that holds a tiled Deflate TIFF: the shape the JAX package's
    load_images gives."""
    from panovlm_tpu_torch import pair_surgery
    from panovlm_tpu_torch.config import Config as PortConfig
    d = tmp_path / "images"
    d.mkdir()
    (d / "000000.png").write_bytes(forge.tiff_bytes(np.zeros((37, 75), int), 1, compression=8,
                                                    tile=T16))
    ref = jpipe.load_images(Config(image_path=str(d), scale=scale))[0][0].shape
    assert pair_surgery._working_size(PortConfig(image_path=str(d), scale=scale)) == ref


# ----------------------------------------------------------------------------
# chip_smoke.py phase 16 (h)'s probes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(cs.TIFF_PROBES))
def test_smoke_tiff_probes_are_cv2s(name, tmp_path):
    """Each probe under 4 KB of base64, its digests those of cv2.imread of
    the file (colour in RGB order, gray; None where cv2 gives no image;
    "queued" for a codec the port does not read yet, which cv2 reads),
    and the port's decoder gives them."""
    b64, digests = cs.TIFF_PROBES[name]
    assert len(b64) < 4096, len(b64)
    data = base64.b64decode(b64)
    path = str(tmp_path / "probe")
    with open(path, "wb") as f:
        f.write(data)
    for kind in ("color", "gray"):
        ref = _cv2_read(path, kind == "color")
        assert not isinstance(ref, str), kind
        if digests[kind] == "queued":
            assert ref is not None
            continue
        want = None if ref is None else hashlib.sha256(ref.tobytes()).hexdigest()
        assert want == digests[kind], kind
    cs.check_tiff_probes(names=(name,))
