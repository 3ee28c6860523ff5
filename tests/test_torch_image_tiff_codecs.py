"""The TIFF codecs that bilevel masks and JPEG-coded frames carry
(native/tiff.cpp; JPEG strips and tiles through native/jpeg.cpp) against
cv2.imread, bit for bit, in gray and in colour (BGR -> RGB), on files PIL
writes (libtiff's own encoders: tiff_ccitt, group3 with T4Options, group4,
jpeg of L, RGB and YCbCr images) and on files tests/image_forge.py writes
(tiff_bytes through fax_code: RLE/W, Group 3 with EOLs, fill bits and 2-D
rows, Group 4 with and without EOFB, FillOrder 2, strips and tiles; through
tiff_jpeg_chunks: gray, RGB, CMYK, YCbCr at 1x1 / 2x1 / 1x2 / 2x2 / 4x1 /
4x2 sampling, strips and tiles, with, without and with partial JPEGTables,
restarts, progressive scans):

  * every variant at 1 x 1, 7 x 13, 37 x 53 and 129 x 257, and rows with
    runs past 2560 pixels;
  * what libtiff reads its own way (a Group 3 strip whose data ends within
    an EOL is read again without EOLs, and so are the later strips; the
    uncompressed-mode option is read; a JPEG strip shorter, narrower or,
    as the last one, taller than its strip; subsampling taken from the
    first strip's SOF where the tag is missing) and the kinds cv2 gives no
    image for (raising native.Cv2Refuses);
  * files cut at every byte, strips cut at every byte with their byte
    count, and seeded bit flips: cv2's image, no image, or error;
  * masks and frames against the JAX package's load_mask / load_images;
  * the JPEG decoder's repairs these files found (ROADMAP F18-F20) on plain
    JPEG and TIFF files;
  * the relations chip_smoke.py phase 16 (i) holds the full-size files to:
    a baseline JPEG moved into a single-strip JPEG-in-TIFF reads as the
    JPEG does, and each tile of a tiled one as its stream spliced with the
    tables into a standalone JPEG.
"""

import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline as jpipe
from panovlm_tpu.config import Config
from panovlm_tpu_torch import native
from panovlm_tpu_torch.io import images
from panovlm_tpu_torch.native import jpeg as native_jpeg
from panovlm_tpu_torch.native import tiff

import image_forge as forge

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

SIZES = ((1, 1), (7, 13), (37, 53), (129, 257))
L, S, U = forge.LONG, forge.SHORT, forge.UNDEFINED


def _cv2_read(path, color):
    """cv2.imread's outcome: the image (RGB for a colour read), None where it
    gives none, "raises" where it raises."""
    try:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
    except cv2.error:
        return "raises"
    if img is None:
        return None
    return np.ascontiguousarray(img[..., ::-1]) if color else img


def _port_read(data: bytes, color: bool):
    try:
        return tiff.decode(data, color)
    except native.Cv2Raises:
        return "raises"
    except native.Cv2Refuses:
        return None


def _same_as_cv2(path, data: bytes, tag):
    """Both reads of data (written to path): the port's outcome is cv2's.
    Returns cv2's gray outcome."""
    with open(path, "wb") as f:
        f.write(data)
    outcomes = []
    for color in (False, True):
        ref, out = _cv2_read(path, color), _port_read(data, color)
        shape = lambda x: x.shape if isinstance(x, np.ndarray) else x
        assert shape(out) == shape(ref), (tag, color)
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(out, ref, err_msg=f"{tag} color={color}")
        outcomes.append(ref)
    return outcomes[0]


def _bits(r, h, w):
    """Bilevel rows: bands and blobs (long runs) with 5 % noise (short ones)."""
    yy, xx = np.mgrid[:h, :w]
    smooth = np.sin(yy / 5.0 + xx / 9.0) * np.cos(xx / 7.0 - yy / 11.0) > 0.15
    return (smooth ^ (r.random((h, w)) < 0.05)).astype(int)


def _samples(r, h, w, c):
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 80 * (np.sin(yy / 4.0) * np.cos(xx / 6.0))[..., None] * np.cos(np.arange(c))
    return np.clip(base + r.integers(-40, 41, (h, w, c)), 0, 255).astype(int)


def _pil(arr, compression, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode or Image.fromarray(arr).mode).save(
        buf, "TIFF", compression=compression, **kw)
    return buf.getvalue()


def _drop_dht_from_tables(data: bytes) -> bytes:
    """A PIL JPEG-in-TIFF whose JPEGTables loses its DHT segments (zeros
    after its EOI keep the tag's size): libtiff's strips use libjpeg's
    standard tables, which libjpeg then installs itself."""
    tables = forge.tiff_fields(data)[347]
    kept = b"\xff\xd8" + b"".join(seg for m, seg in forge.jpeg_units(tables) if m != 0xC4)
    kept += b"\xff\xd9" + bytes(len(tables) - len(kept) - 2)
    assert data.count(tables) == 1
    return data.replace(tables, kept)


def _fax(photometric, compression, **kw):
    return lambda r, h, w: forge.tiff_bytes(_bits(r, h, w), photometric, 1,
                                            compression=compression, **kw)


def _jpeg(photometric, c=1, **kw):
    return lambda r, h, w: forge.tiff_bytes(_samples(r, h, w, c)[..., 0] if c == 1 else
                                            _samples(r, h, w, c), photometric,
                                            compression=7, **kw)


def _pil_kind(kind):
    def make(r, h, w):
        if kind.startswith("1-bit"):
            comp, kw = {"1-bit tiff_ccitt": ("tiff_ccitt", {}),
                        "1-bit group3": ("group3", {}),
                        "1-bit group3 2-D, fill bits": ("group3", {"tiffinfo": {292: 5}}),
                        "1-bit group4": ("group4", {})}[kind]
            return _pil(_bits(r, h, w).astype(bool), comp, **kw)
        rgb = _samples(r, h, w, 3).astype(np.uint8)
        if kind == "jpeg L":
            return _pil(rgb[..., 1], "jpeg")
        if kind == "jpeg RGB":
            return _pil(rgb, "jpeg")
        data = _pil(rgb, "jpeg", "YCbCr")
        return _drop_dht_from_tables(data) if kind == "jpeg YCbCr, standard tables" else data
    return make


T16 = (16, 16)
KINDS = {
    # CCITT: MinIsWhite (the fax convention) unless named
    "RLE": _fax(0, 2),
    "RLE MinIsBlack strips": _fax(1, 2, rows_per_strip=5),
    "RLE FillOrder 2": _fax(0, 2, fill_order=2),
    "RLE/W": _fax(0, 32771),
    "RLE/W strips FillOrder 2": _fax(0, 32771, rows_per_strip=3, fill_order=2),
    "RLE/W tiles": _fax(0, 32771, tile=(32, 16)),
    "G3 1-D": _fax(0, 3),
    "G3 1-D fill bits": _fax(0, 3, fax=(0, True, True)),
    "G3 1-D without RTC strips": _fax(0, 3, rows_per_strip=4, fax=(0, False, False)),
    "G3 2-D": _fax(0, 3, fax=(4, False, True)),
    "G3 2-D fill bits": _fax(0, 3, fax=(2, True, True)),
    "G3 2-D fill bits FillOrder 2 tiles": _fax(0, 3, fax=(3, True, False), fill_order=2,
                                              tile=T16),
    "G3 2-D MinIsBlack big-endian": _fax(1, 3, fax=(2, False, True), big_endian=True),
    "G4": _fax(0, 4),
    "G4 FillOrder 2": _fax(0, 4, fill_order=2),
    "G4 without EOFB strips": _fax(0, 4, fax=(0, False, False), rows_per_strip=6),
    "G4 tiles": _fax(0, 4, tile=(32, 16)),
    "G4 MinIsBlack BigTIFF": _fax(1, 4, bigtiff=True),
    "G4 orientation 3": _fax(0, 4, orientation=3),
    "G4 palette": lambda r, h, w: forge.tiff_bytes(_bits(r, h, w), 3, 1, compression=4,
                                                   colormap=[[0, 0, 0], [60000, 20000, 9000]]),
    # JPEG
    "JPEG gray": _jpeg(1),
    "JPEG gray MinIsWhite strips restarts": _jpeg(0, rows_per_strip=8, jpeg={"restart": 1}),
    "JPEG gray without JPEGTables": _jpeg(1, jpeg={"tables": None}),
    "JPEG gray progressive tiles": _jpeg(1, tile=T16, jpeg={"progressive": True}),
    "JPEG RGB": _jpeg(2, 3),
    "JPEG RGB strips DQT in JPEGTables": _jpeg(2, 3, rows_per_strip=5, jpeg={"tables": "dqt"}),
    "JPEG RGB planar": _jpeg(2, 3, planar=2, rows_per_strip=9),
    "JPEG CMYK": _jpeg(5, 4, rows_per_strip=16),
    "JPEG CMYK tiles without JPEGTables": _jpeg(5, 4, tile=(16, 32), jpeg={"tables": None}),
    "JPEG RGBA unassociated": _jpeg(2, 4, extra=(2,)),
    **{f"JPEG YCbCr {a}x{b}": _jpeg(6, 3, subsampling=(a, b), rows_per_strip=16)
       for a, b in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1))},
    "JPEG YCbCr 2x2 tiles restarts": _jpeg(6, 3, subsampling=(2, 2), tile=(16, 32),
                                          jpeg={"restart": 2}),
    "JPEG YCbCr 2x1 strips without JPEGTables": _jpeg(6, 3, subsampling=(2, 1),
                                                     rows_per_strip=8, jpeg={"tables": None}),
    "JPEG YCbCr 2x2 progressive": _jpeg(6, 3, subsampling=(2, 2), rows_per_strip=32,
                                       jpeg={"progressive": True}),
    "JPEG YCbCr 2x1, no YCbCrSubsampling tag": _jpeg(6, 3, subsampling=(2, 1),
                                                    rows_per_strip=16, drop=(530,)),
    "JPEG YCbCr 1x1, no YCbCrSubsampling tag": _jpeg(6, 3, drop=(530,)),
    "JPEG YCbCr 2x2 FillOrder 2 orientation 2": _jpeg(6, 3, subsampling=(2, 2), fill_order=2,
                                                     orientation=2),
    # PIL (libtiff's encoders)
    **{f"PIL {k}": _pil_kind(k) for k in (
        "1-bit tiff_ccitt", "1-bit group3", "1-bit group3 2-D, fill bits", "1-bit group4",
        "jpeg L", "jpeg RGB", "jpeg YCbCr", "jpeg YCbCr, standard tables")},
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_variant_reads_like_cv2(tmp_path, kind):
    """The variant at every size: cv2's bits in both reads (cv2 gives no
    image only for 4:1 YCbCr wider than libjpeg's 10 blocks an MCU allow:
    none here)."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    for h, w in SIZES:
        data = KINDS[kind](rng, h, w)
        assert images.image_format(data[:64]) == "TIFF"
        assert isinstance(_same_as_cv2(tmp_path / "x.tif", data, (kind, h, w)), np.ndarray)


@pytest.mark.parametrize("compression", [2, 32771, 3, 4])
def test_runs_past_2560_read_like_cv2(tmp_path, compression):
    """Rows 5000 pixels wide with runs of 1 to 4900 pixels: the make-up codes
    of 64 to 1728, the shared ones of 1792 to 2560, and 2560 repeated."""
    rng = np.random.default_rng(compression)
    rows = []
    for _ in range(6):
        edges = np.sort(rng.choice(np.arange(1, 5000), 5, replace=False))
        row = np.zeros(5000, int)
        for k, (a, b) in enumerate(zip([0, *edges], [*edges, 5000])):
            row[a:b] = k % 2
        rows.append(row)
    rows.append(np.zeros(5000, int))
    rows.append(np.ones(5000, int))
    data = forge.tiff_bytes(np.array(rows), 0, 1, compression=compression,
                            fax=(2, True, True) if compression == 3 else (0, False, True))
    assert isinstance(_same_as_cv2(tmp_path / "x.tif", data, compression), np.ndarray)


def _code_bits(*parts):
    """Coded data from (code word, count) parts, MSB first, padded to a byte."""
    bits = np.concatenate([np.tile(np.frombuffer(code.encode(), np.uint8) - 48, n)
                           for code, n in parts])
    return np.packbits(bits).tobytes()


W0, B1, EOL, MAKEUP_2560 = "00110101", "010", "000000000001", "000000011111"


@pytest.mark.parametrize("name,h,w", [("RLE", 2, 64), ("RLE", 2, 200), ("G3 1-D", 2, 64),
                                      ("RLE, a0 wrapped", 128, 8192),
                                      ("G3 2-D, a 1-D row, a0 wrapped", 128, 8192)])
def test_a_row_past_the_run_array_ends_the_strip_like_cv2(tmp_path, name, h, w):
    """A 1-D row of (white 0, black 1) pairs writes two runs per pixel, more
    than the run array of a 1-D code holds: libtiff's SETVALUE stops at its
    end ("Buffer overflow at line") and the strip ends without filling the
    row. With a0 first wrapped negative by about 839k make-up codes of 2560
    (which fit under the 10 x strip + 4 KiB clamp of an 8192 x 128 strip),
    the pairs never bring a0 to the row's end and would run on unbounded,
    past the twice as long array of a 2-D code too."""
    wrapped = "wrapped" in name
    head = [(EOL, 1)] if "G3 1-D" in name else [(EOL + "1", 1)] if "2-D" in name else []
    if wrapped:
        head += [(MAKEUP_2560, 838861), (W0, 1), (B1, 1)]
    data = forge.tiff_bytes(np.zeros((h, w), int), 0, 1, compression=2 if "RLE" in name else 3,
                            tags={292: (L, [1])} if "2-D" in name else None,
                            chunks=[_code_bits(*head, (W0 + B1, 20000 if wrapped else w),
                                               ("0" * 7, 1))])
    out = _same_as_cv2(tmp_path / "x.tif", data, name)
    assert isinstance(out, np.ndarray) and (out == 255).all()


def _edge_cases():
    r = np.random.default_rng(5)
    h, w = 7, 13
    b = _bits(r, h, w)
    rgb = _samples(r, h, w, 3)
    g = rgb[..., 0]
    chunks = lambda parts, ph=1, **kw: forge.tiff_jpeg_chunks(
        [p[..., None] if p.ndim == 2 else p for p in parts], ph, tables=None, **kw)[0]
    tables = forge.tiff_jpeg_chunks([g[..., None]], 1)[1]
    return {
        # T4Options' uncompressed-mode bit: libtiff reads the file all the same
        "G3 uncompressed-mode option": forge.tiff_bytes(b, 0, 1, compression=3,
                                                        tags={292: (L, [2])}),
        "G3 2-D and uncompressed-mode options": forge.tiff_bytes(
            b, 0, 1, compression=3, fax=(2, False, True), tags={292: (L, [3])}),
        "G4 uncompressed-mode option": forge.tiff_bytes(b, 0, 1, compression=4,
                                                        tags={293: (L, [2])}),
        "G3 T4Options as SHORT": forge.tiff_bytes(b, 0, 1, compression=3, fax=(2, False, True),
                                                  tags={292: (S, [1])}),
        "G3 T4Options of 2 values (dropped)": forge.tiff_bytes(
            b, 0, 1, compression=3, fax=(2, False, True), tags={292: (L, [1, 1])}),
        "RLE/W at an odd offset": forge.tiff_bytes(b, 0, 1, compression=32771,
                                                   tags={270: (forge.ASCII, b"ab\0")}),
        "G4 BadFaxLines, CleanFaxData": forge.tiff_bytes(
            b, 0, 1, compression=4, tags={326: (L, [2]), 327: (S, [1]), 328: (L, [1])}),
        "JPEG JPEGTables of 0 bytes": forge.tiff_bytes(g, 1, compression=7,
                                                       jpeg={"tables": None},
                                                       tags={347: (U, b"")}),
        "JPEG JPEGTables as BYTE": forge.tiff_bytes(g, 1, compression=7,
                                                    tags={347: (forge.BYTE, list(tables))}),
        "JPEG JPEGTables as SHORT": forge.tiff_bytes(g, 1, compression=7,
                                                     tags={347: (S, list(tables))}),
        "JPEG last strip taller than its rows": forge.tiff_bytes(
            g, 1, compression=7, rows_per_strip=4,
            chunks=chunks([g[:4], np.pad(g[4:], ((0, 1), (0, 0)))])),
        "JPEG strip shorter than its rows": forge.tiff_bytes(
            g, 1, compression=7, rows_per_strip=4, chunks=chunks([g[:3], g[4:]])),
        "JPEG strip narrower than the image": forge.tiff_bytes(
            g, 1, compression=7, chunks=chunks([g[:, :9]])),
        "JPEG tile smaller than the tile": forge.tiff_bytes(g, 1, compression=7, tile=T16,
                                                            chunks=chunks([g])),
        "JPEG arithmetic-coded strip": forge.tiff_bytes(g, 1, compression=7,
                                                        chunks=[_arith_gray(g)]),
        "JPEG lossless strip": forge.tiff_bytes(g, 1, compression=7, chunks=[
            forge.lossless_bytes([g.astype(np.uint8)], w, h, predictor=1)]),
        "JPEG palette": forge.tiff_bytes(g, 3, compression=7,
                                         colormap=r.integers(0, 65536, (256, 3))),
        "JPEG CIE L*a*b*": forge.tiff_bytes(rgb, 8, compression=7),
        "JPEG YCbCr planar 1x1": forge.tiff_bytes(rgb, 6, planar=2, compression=7,
                                                  tags={530: (S, [1, 1])}),
        "JPEG YCbCr 2x2 stream, tag 2x2 missing from a 1x1 file": forge.tiff_bytes(
            rgb, 6, compression=7, drop=(530,), chunks=chunks([rgb], 6, subsampling=(1, 1))),
    }


def _arith_gray(g):
    comps, q = forge.plane_components([g.astype(float)], [(1, 1)])
    return forge.jpeg_bytes(comps, g.shape[1], g.shape[0], q, [("seq", [0])],
                            arithmetic=True, jfif=False)


EDGE = _edge_cases()


@pytest.mark.parametrize("name", list(EDGE))
def test_edge_case_reads_like_cv2(tmp_path, name):
    assert isinstance(_same_as_cv2(tmp_path / "x.tif", EDGE[name], name), np.ndarray)


def _refused():
    r = np.random.default_rng(6)
    h, w = 7, 13
    b = _bits(r, h, w)
    rgb = _samples(r, h, w, 3)
    g = rgb[..., 0]
    whole = lambda parts, ph=1, **kw: forge.tiff_jpeg_chunks(
        [p[..., None] if p.ndim == 2 else p for p in parts], ph, tables=None, **kw)[0]
    comps, q = forge.plane_components([g.astype(float)], [(1, 1)])
    gray_stream = forge.jpeg_bytes(comps, w, h, q, [("seq", [0])])
    tables = forge.tiff_jpeg_chunks([g[..., None]], 1)[1]
    return {
        "G4 without PhotometricInterpretation": forge.tiff_bytes(b, 0, 1, compression=4,
                                                                 drop=(262,)),
        "G3 without PhotometricInterpretation": forge.tiff_bytes(b, 0, 1, compression=3,
                                                                 drop=(262,)),
        "G4 of 2 samples in planes": forge.tiff_bytes(np.stack([b, b], -1), 1, 1,
                                                      compression=4, planar=2, extra=(0,)),
        "RLE of 4-bit palette samples": forge.tiff_bytes(
            b * 3, 3, 4, compression=2, colormap=r.integers(0, 65536, (16, 3))),
        "JPEG JPEGTables with a frame": forge.tiff_bytes(g, 1, compression=7,
                                                         tags={347: (U, gray_stream)}),
        "JPEG JPEGTables without SOI": forge.tiff_bytes(g, 1, compression=7,
                                                        tags={347: (U, tables[2:])}),
        "JPEG 12-bit TIFF": forge.tiff_bytes(g, 1, 12, compression=7),
        "JPEG 16-bit TIFF": forge.tiff_bytes(g, 1, 16, compression=7),
        "JPEG strip taller than its rows (not the last)": forge.tiff_bytes(
            g, 1, compression=7, rows_per_strip=4, chunks=whole([g[:6], g[4:]])),
        "JPEG strip wider than the image": forge.tiff_bytes(
            g, 1, compression=7, chunks=whole([np.pad(g, ((0, 0), (0, 3)))])),
        "JPEG YCbCr stream 1x1, tag 2x2": forge.tiff_bytes(
            rgb, 6, subsampling=(2, 2), compression=7, chunks=whole([rgb], 6)),
        "JPEG gray stream in an RGB file": forge.tiff_bytes(rgb, 2, compression=7,
                                                            chunks=whole([g])),
        "JPEG 2x2 sampling in an RGB file": forge.tiff_bytes(
            rgb, 2, compression=7, chunks=whole([rgb], 6, subsampling=(2, 2))),
        "JPEG YCbCr planar 2x2": forge.tiff_bytes(rgb, 6, planar=2, compression=7,
                                                  tags={530: (S, [2, 2])}),
        "JPEG YCbCr 4x4 (too many blocks an MCU)": forge.tiff_bytes(
            rgb, 6, subsampling=(4, 4), compression=7, rows_per_strip=8),
        "JPEG stream without SOI": forge.tiff_bytes(g, 1, compression=7,
                                                    chunks=[whole([g])[0][2:]]),
    }


REFUSED = _refused()


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_kinds_give_no_image_in_cv2(tmp_path, name):
    data = REFUSED[name]
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    for color in (False, True):
        assert _cv2_read(path, color) is None, name
        with pytest.raises(native.Cv2Refuses):
            tiff.decode(data, color)


# ----------------------------------------------------------------------------
# libtiff's recovery on cut and corrupt data
# ----------------------------------------------------------------------------

def _cut_files():
    r = np.random.default_rng(11)
    h, w = 9, 21
    b = _bits(r, h, w)
    rgb = _samples(r, h, w, 3)
    return {
        "RLE": forge.tiff_bytes(b, 0, 1, compression=2),
        "RLE/W": forge.tiff_bytes(b, 0, 1, compression=32771),
        "G3 1-D": forge.tiff_bytes(b, 0, 1, compression=3),
        "G3 1-D fill bits": forge.tiff_bytes(b, 0, 1, compression=3, fax=(0, True, True)),
        "G3 2-D fill bits": forge.tiff_bytes(b, 0, 1, compression=3, fax=(3, True, True)),
        "G3 2-D": forge.tiff_bytes(b, 0, 1, compression=3, fax=(2, False, False)),
        "G4": forge.tiff_bytes(b, 0, 1, compression=4),
        "G4 FillOrder 2 tiles": forge.tiff_bytes(b, 1, 1, compression=4, fill_order=2, tile=T16),
        "JPEG gray": forge.tiff_bytes(rgb[..., 0], 1, compression=7),
        "JPEG YCbCr 2x2 restarts": forge.tiff_bytes(rgb, 6, subsampling=(2, 2), compression=7,
                                                    jpeg={"restart": 1}),
        "JPEG RGB tiles": forge.tiff_bytes(rgb, 2, compression=7, tile=T16,
                                           jpeg={"tables": "dqt"}),
        "JPEG gray progressive": forge.tiff_bytes(rgb[..., 0], 1, compression=7,
                                                  jpeg={"progressive": True, "tables": "dqt"}),
    }


CUT_FILES = _cut_files()


@pytest.mark.parametrize("name", list(CUT_FILES))
def test_cut_at_every_byte_like_cv2(tmp_path, name):
    data = CUT_FILES[name]
    for k in range(4, len(data)):
        _same_as_cv2(tmp_path / "x.tif", data[:k], (name, k))


@pytest.mark.parametrize("name", [n for n in CUT_FILES
                                  if len(forge.tiff_fields(CUT_FILES[n]).get(273, ())) == 1])
def test_strip_cut_at_every_byte_like_cv2(tmp_path, name):
    """The strip's data cut at every byte, its StripByteCounts following:
    the fax decoders' end of data (the row being decoded filled, the later
    ones left 0; Group 3 read again without EOLs where the data ends within
    an EOL), libjpeg's fake EOI."""
    data = CUT_FILES[name]
    fields = forge.tiff_fields(data)
    (off,), (count,) = fields[273], fields[279]
    entry = struct.pack("<HHII", 279, L, 1, count)   # the byte count, held in its entry
    assert data.count(entry) == 1
    for k in range(1, count):
        cut = data.replace(entry, struct.pack("<HHII", 279, L, 1, k))[:off + k]
        _same_as_cv2(tmp_path / "x.tif", cut, (name, k))


FUZZ_FILES = ("RLE", "RLE/W", "G3 1-D", "G3 2-D fill bits", "G4", "G4 FillOrder 2 tiles",
              "JPEG gray", "JPEG YCbCr 2x2 restarts", "JPEG RGB tiles", "JPEG gray progressive")


@pytest.mark.parametrize("name", FUZZ_FILES)
def test_bit_flips_like_cv2(tmp_path, name):
    """150 copies with 1-3 bits flipped anywhere but in the signature."""
    data = CUT_FILES[name]
    rng = np.random.default_rng(len(name))
    for i in range(150):
        b = bytearray(data)
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(4, len(b))] ^= 1 << int(rng.integers(0, 8))
        _same_as_cv2(tmp_path / "x.tif", bytes(b), (name, i))


def test_group3_without_eol_holds_for_the_later_strips(tmp_path):
    """libtiff 4.7 reads a Group 3 strip whose data ends within an EOL again
    from the strip's start without EOLs ("Try to decode (read) fax Group 3
    data without EOL"), and keeps that mode for the strips after it: a
    whole second strip then decodes as cv2 decodes it, not as coded."""
    b = _bits(np.random.default_rng(3), 18, 21)
    s1 = forge.fax_code(b[:9], 3, 3, True, True)
    s2 = forge.fax_code(b[9:], 3, 3, True, True)
    whole = forge.tiff_bytes(b, 0, 1, compression=3, fax=(3, True, True), rows_per_strip=9)
    gray = _same_as_cv2(tmp_path / "x.tif", whole, "whole")
    np.testing.assert_array_equal(gray == 0, b == 1)
    second_as_coded = []
    for k in range(1, len(s1)):
        cut = forge.tiff_bytes(b, 0, 1, compression=3, fax=(3, True, True), rows_per_strip=9,
                               chunks=[s1[:k], s2])
        gray = _same_as_cv2(tmp_path / "x.tif", cut, k)
        second_as_coded.append(np.array_equal(gray[9:] == 0, b[9:] == 1))
    assert any(second_as_coded) and not all(second_as_coded)


# ----------------------------------------------------------------------------
# the JPEG decoder's repairs (ROADMAP F18-F20), on plain files too
# ----------------------------------------------------------------------------

def _jpeg_same_as_cv2(path, data: bytes, tag):
    with open(path, "wb") as f:
        f.write(data)
    for color in (False, True):
        ref = _cv2_read(path, color)
        try:
            out = native_jpeg.decode(data, color)
        except (native.Cv2Refuses, ValueError):
            out = None
        assert (out is None) == (ref is None), (tag, color)
        if ref is not None:
            np.testing.assert_array_equal(out, ref, err_msg=str(tag))
    return ref


def _progressive_jpeg():
    rgb = _samples(np.random.default_rng(3), 9, 21, 3).astype(float)
    comps, q = forge.plane_components([rgb[..., k] for k in range(3)], [(1, 1)] * 3)
    return forge.jpeg_bytes(comps, 21, 9, q, forge.spectral_script(3))


def test_f18_a_segment_cut_between_scans_reads_the_fake_eoi(tmp_path):
    """F18: a progressive file cut within a table segment between scans.
    libjpeg's source supplies FF D9 past the end, which get_dht reads as
    code counts (an error: no image) and as symbols (no error); the port
    took every cut segment for an EOI. Also a JPEGTables stream cut within
    a segment."""
    data = _progressive_jpeg()
    units, pos, sos, dht = forge.jpeg_units(data), 2, False, []
    for m, seg in units:
        if m == 0xC4 and sos:
            dht.append((pos, len(seg)))
        sos = sos or m == 0xDA
        pos += len(seg)
    start, length = dht[0]
    outcomes = set()
    for k in range(start, start + length + 1):
        outcomes.add(_jpeg_same_as_cv2(tmp_path / "x.jpg", data[:k], k) is None)
    assert outcomes == {True, False}   # counts cut: no image; symbols cut: an image
    g = _samples(np.random.default_rng(4), 7, 13, 1)[..., 0]
    tiffd = forge.tiff_bytes(g, 1, compression=7)
    count = len(forge.tiff_fields(tiffd)[347])
    head = struct.pack("<HHI", 347, U, count)   # JPEGTables' entry up to its offset
    assert tiffd.count(head) == 1
    for cut in (count - 2, count - 6, count - 40):
        data = tiffd.replace(head, struct.pack("<HHI", 347, U, cut))
        _same_as_cv2(tmp_path / "x.tif", data, ("JPEGTables", cut))


def test_f19_libjpeg_checks_what_it_uses_when_it_uses_it(tmp_path):
    """F19: a DHT segment that defines a slot twice, the first time with
    counts that are no Huffman code (libjpeg checks a table when a scan
    starts with it: an image), a progressive or lossless frame whose
    tables no stream defined (libjpeg installs its standard tables for
    sequential frames only: no image), a frame header or a DRI segment of
    the wrong length (no image)."""
    rgb = _samples(np.random.default_rng(8), 9, 21, 3).astype(float)
    comps, q = forge.plane_components([rgb[..., 0]], [(1, 1)])
    seq = forge.jpeg_bytes(comps, 21, 9, q, [("seq", [0])], restart=2)
    units = forge.jpeg_units(seq)
    bad_dc = b"\xff\xc4" + struct.pack(">H", 2 + 17 + 3) + bytes([0, 0, 3] + [0] * 14) \
        + bytes([1, 2, 3])   # three 2-bit codes and nothing else: 11 is all ones
    twice = b"\xff\xd8" + b"".join(
        (bad_dc + seg) if m == 0xC4 else seg for m, seg in units) + b"\xff\xd9"
    assert isinstance(_jpeg_same_as_cv2(tmp_path / "x.jpg", twice, "twice"), np.ndarray)
    no_dht = lambda d: b"\xff\xd8" + b"".join(s for m, s in forge.jpeg_units(d)
                                              if m != 0xC4) + b"\xff\xd9"
    prog = forge.jpeg_bytes(comps, 21, 9, q, forge.SIMPLE_PROGRESSION_1)
    lossless = forge.lossless_bytes([rgb[..., 0].astype(np.uint8)], 21, 9, predictor=1)
    sof_len = seq.replace(b"\xff\xc0\x00\x0b", b"\xff\xc0\x00\x0d", 1)
    dri_len = seq.replace(b"\xff\xdd\x00\x04", b"\xff\xdd\x00\x06", 1)
    assert sof_len != seq and dri_len != seq
    for tag, data in (("progressive without DHT", no_dht(prog)),
                      ("lossless without DHT", no_dht(lossless)),
                      ("SOF length 13", sof_len), ("DRI length 6", dri_len)):
        assert _jpeg_same_as_cv2(tmp_path / "x.jpg", data, tag) is None
    assert isinstance(_jpeg_same_as_cv2(tmp_path / "x.jpg", no_dht(seq), "sequential"),
                      np.ndarray)


def test_f20_the_rgba_buffer_of_a_strip_of_a_gigabyte(tmp_path):
    """F20: OpenCV's 8-bit TIFF read allocates RGBA rows for a whole strip or
    tile and refuses 2^30 bytes or more (RowsPerStrip past the image counts),
    where the port checked the samples' own size only."""
    g = np.zeros((3, 37), int)
    for rows, ok in (((1 << 30) // (4 * 37), True), ((1 << 30) // (4 * 37) + 1, False)):
        data = forge.tiff_bytes(g, 1, tags={278: (L, [rows])})
        assert isinstance(_same_as_cv2(tmp_path / "x.tif", data, rows), np.ndarray) == ok


# ----------------------------------------------------------------------------
# masks and frames against the JAX package, and phase 16 (i)'s relations
# ----------------------------------------------------------------------------

def _tripod(h, w):
    m = np.full((h, w), 200, np.uint8)
    m[h - h // 4:] = 0
    m[h // 2:, w // 2 - 2:w // 2 + 2] = 0
    m[1, 1] = 0
    return m


def _mask_files(h=30, w=61):
    m = _tripod(h, w)
    black = (m == 0).astype(int)
    return {
        "G4 MinIsWhite": forge.tiff_bytes(black, 0, 1, compression=4),
        "G3 2-D FillOrder 2 strips": forge.tiff_bytes(black, 0, 1, compression=3,
                                                      fax=(2, True, True), fill_order=2,
                                                      rows_per_strip=8),
        "RLE/W MinIsBlack": forge.tiff_bytes(1 - black, 1, 1, compression=32771),
        "PIL group4": _pil(m > 0, "group4"),
        "JPEG gray": forge.tiff_bytes(m, 1, compression=7, jpeg={"quality": 100}),
    }


@pytest.mark.parametrize("name", list(_mask_files()))
def test_mask_matches_jax_package(tmp_path, name):
    """Each mask named mask.png, at its own size and nearest-resized up and
    down, as the JAX package's load_mask (cv2.imread + cv2.resize) gives it."""
    path = tmp_path / "mask.png"
    path.write_bytes(_mask_files()[name])
    for H, W in ((30, 61), (60, 122), (13, 29), (720, 1440)):
        ref = jpipe.load_mask(Config(mask_path=str(path)), H, W)
        out = images.load_mask(str(path), H, W)
        assert ref is not None and out is not None and out.dtype == bool
        np.testing.assert_array_equal(out, ref)
        assert not out.all()


def _frames(h=37, w=75):
    rgb = _samples(np.random.default_rng(7), h, w, 3)
    return [forge.tiff_bytes(rgb, 6, subsampling=(2, 2), compression=7, rows_per_strip=16),
            forge.tiff_bytes(rgb, 2, compression=7, tile=T16, jpeg={"tables": None}),
            forge.tiff_bytes(rgb[..., 1], 1, compression=7, jpeg={"restart": 2}),
            forge.tiff_bytes(rgb[..., 1] > 128, 0, 1, compression=4),
            _pil(rgb.astype(np.uint8), "jpeg", "YCbCr")]


@pytest.mark.parametrize("color,scale", [(False, 0), (False, -1), (True, 0), (True, -1)])
def test_frames_of_tiff_bytes_match_jax_package(tmp_path, color, scale):
    """A directory of .png files that hold JPEG-in-TIFF and Group 4 bytes:
    cv2 decodes by signature, so the JAX package's load_images reads them,
    and the port's gives the same arrays."""
    d = tmp_path / "images"
    d.mkdir()
    for i, data in enumerate(_frames()):
        (d / f"{i:06d}.png").write_bytes(data)
    ref, names = jpipe.load_images(Config(image_path=str(d), scale=scale), color=color)
    out, names_t = images.load_images(str(d), scale, color=color)
    assert names_t == names and len(out) == len(_frames())
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def _gray_of(rgb):
    """imgcodecs' gray of RGB pixels (a TIFF's gray read of its RGBA raster)."""
    c = rgb.astype(np.int32)
    return ((1868 * c[..., 2] + 9617 * c[..., 1] + 4899 * c[..., 0] + 8192) >> 14).astype(np.uint8)


def test_baseline_jpeg_as_a_single_strip_tiff_reads_as_the_jpeg(tmp_path):
    """Phase 16 (b)'s relation: a 4:2:0 baseline JPEG (the port's encoder,
    as the MVS colour frames are written) moved into a single-strip YCbCr
    JPEG-in-TIFF, its DQT and DHT in JPEGTables: cv2's colour read of the
    TIFF is its read of the JPEG (libtiff asks libjpeg for RGB, with the
    same islow IDCT and fancy upsampling as cv2's JPEG read), its gray read
    imgcodecs' gray of that (not the JPEG's Y plane); the port gives both."""
    from panovlm_tpu_torch.io import jpeg as port_jpeg
    rgb = _samples(np.random.default_rng(12), 45, 90, 3).astype(np.uint8)
    jpg = port_jpeg.encode(rgb, 95)
    data = forge.jpeg_as_tiff(jpg)
    (tmp_path / "x.jpg").write_bytes(jpg)
    color = _cv2_read(tmp_path / "x.jpg", True)
    assert _same_as_cv2(tmp_path / "x.tif", data, "single strip") is not None
    np.testing.assert_array_equal(_cv2_read(tmp_path / "x.tif", True), color)
    np.testing.assert_array_equal(_cv2_read(tmp_path / "x.tif", False), _gray_of(color))


def test_tiles_read_as_their_spliced_streams(tmp_path):
    """Phase 16 (c)'s relation: each tile of a YCbCr 2x2 JPEG-in-TIFF in
    tiles, its tables in JPEGTables, reads as cv2 reads the tile's stream
    spliced with the tables into a standalone JPEG (cropped to the image)."""
    rgb = _samples(np.random.default_rng(13), 40, 70, 3)
    data, tiles, tables = forge.jpeg_tiff_tiles(rgb, (32, 16))
    full = _cv2_read_bytes(tmp_path, data, ".tif")
    assert _same_as_cv2(tmp_path / "x.tif", data, "tiles") is not None
    for (y, x), stream in tiles.items():
        part = _cv2_read_bytes(tmp_path, forge.splice_tables(tables, stream), ".jpg")
        h, w = min(16, 40 - y), min(32, 70 - x)
        np.testing.assert_array_equal(full[y:y + h, x:x + w], part[:h, :w])


def _cv2_read_bytes(tmp_path, data, ext):
    path = tmp_path / f"r{ext}"
    path.write_bytes(data)
    return _cv2_read(path, True)


def test_forge_fax_codes_are_read_by_pil():
    """tests/tiff_forge.cpp's CCITT coding, read by PIL's libtiff (another
    build than cv2's), gives the coded rows back. (Not RLE/W: libtiff
    word-aligns its rows by the address it reads from, and after a row
    whose accumulator holds 16 bits or more not at all, so whether a file
    reads as coded depends on the reader's buffer.)"""
    b = _bits(np.random.default_rng(14), 37, 301)
    for compression, fax, order in ((2, (0, False, True), 1), (3, (0, True, True), 2),
                                    (3, (0, False, False), 1), (3, (3, False, True), 1),
                                    (4, (0, False, True), 1), (4, (0, False, False), 2)):
        data = forge.tiff_bytes(b, 0, 1, compression=compression, fax=fax, rows_per_strip=11,
                                fill_order=order)
        back = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
        np.testing.assert_array_equal(back == 0, b == 1, err_msg=str(compression))


def test_decodes_on_threads_alike():
    """No shared state: the same files decoded on 8 threads at once give the
    bits of one thread."""
    files = [CUT_FILES[n] for n in ("G3 2-D fill bits", "G4", "RLE/W", "JPEG YCbCr 2x2 restarts",
                                    "JPEG RGB tiles", "JPEG gray progressive")]
    jobs = [(d, c) for d in files for c in (True, False)]
    ref = [_port_read(d, c) for d, c in jobs]
    with ThreadPoolExecutor(max_workers=8) as ex:
        for _ in range(4):
            for a, b in zip(ex.map(lambda j: _port_read(*j), jobs), ref):
                np.testing.assert_array_equal(a, b)
