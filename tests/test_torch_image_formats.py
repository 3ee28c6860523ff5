"""The image formats the JAX package reads through cv2.imread, against the
port's decoders (native/jpeg.cpp, native/png.cpp), bit for bit, in colour
(BGR -> RGB) and gray, at 1 x 1, 7 x 13, 37 x 53 and 129 x 257:

  * JPEG: progressive files (cv2-written, every sampling of SAMPLING, with
    and without restarts; the image_forge scripts with successive
    approximation, EOB runs and coefficients never sent), the same files
    cut after each of their scans (libjpeg's block smoothing), multi-scan
    sequential files, CMYK (PIL, image_forge), YCCK (image_forge),
    RGB-coded files (PIL keep_rgb, component ids 'R','G','B', Adobe
    transform 0), the EXIF orientation of a progressive file, files cut
    anywhere in their data, files without Huffman tables. A
    progressive or multi-scan re-coding of the port encoder's coefficients
    decodes to the baseline file's bits. Hierarchical, 12-bit,
    2-component, lossless YCbCr and non-integral-sampling files, which cv2
    gives no image for, raise NotImplementedError (Cv2Refuses);
  * PNG: every colour type and bit depth, interlaced and not, with tRNS,
    with gAMA and sRGB (libpng's gamma tables in a gray read of a colour
    file), sBIT, eXIf orientation, cv2- and PIL-written files, libpng's
    chunk rules (CRCs, chunk order); 2,000 corrupted files decode or raise
    ValueError / NotImplementedError in a subprocess that must not crash;
  * the port's load_images (gray and colour, scale 0 and -1) and load_mask
    against the JAX package's on directories of progressive JPEGs, 16-bit
    and interlaced PNGs, 1-bit and 4-bit palette masks (tolerance 0);
  * 8 different files decoded on 8 threads at once give their one-thread
    bits (the C calls release the GIL);
  * chip_smoke.py's embedded format probes decode to cv2's digests.
"""

import base64
import hashlib
import io
import os
import struct
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline as jpipe
from panovlm_tpu.config import Config
from panovlm_tpu_torch.io import images, jpeg
from panovlm_tpu_torch.native import jpeg as native_jpeg
from panovlm_tpu_torch.native import png as native_png

import image_forge as forge

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = ((1, 1), (7, 13), (37, 53), (129, 257))
SIZE_IDS = [f"{h}x{w}" for h, w in SIZES]


def _image(h, w, seed):
    """Smooth colour structure plus noise (RGB uint8)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 128 + 90 * np.sin(yy / 4.0) * np.cos(xx / 6.0)
    img = np.stack([base, 255 - base, (0.5 * base + 3 * xx) % 256], axis=-1)
    return np.clip(img + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def _cv2_read(path, color):
    ref = cv2.imread(path, cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
    return None if ref is None else (ref[..., ::-1] if color else ref)


def _assert_like_cv2(tmp_path, data: bytes, ext: str, tag=""):
    """The port's decoder gives cv2.imread's bits on the file, both reads."""
    path = str(tmp_path / f"f{ext}")
    with open(path, "wb") as f:
        f.write(data)
    decode = native_png.decode if ext == ".png" else native_jpeg.decode
    for color in (True, False):
        ref = _cv2_read(path, color)
        assert ref is not None, (tag, color)
        out = decode(data, color)
        assert out.dtype == np.uint8 and out.shape == ref.shape, (tag, color, out.shape, ref.shape)
        np.testing.assert_array_equal(out, ref, err_msg=f"{tag} color={color}")


def _scan_ends(data: bytes):
    """Where the entropy-coded data of each scan ends (its next marker that
    is not a restart marker)."""
    out, i = [], 2
    while i < len(data) - 1:
        m = data[i + 1]
        if m == 0xDA:
            j = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
            while not (data[j] == 0xFF and data[j + 1] != 0 and not 0xD0 <= data[j + 1] <= 0xD7):
                j += 1
            out.append(j)
            i = j
        elif m == 0xD9:
            break
        else:
            i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return out


def _cv2_jpeg(img, *flags):
    ok, buf = cv2.imencode(".jpg", img, list(flags))
    assert ok
    return buf.tobytes()


# ----------------------------------------------------------------------------
# JPEG
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_progressive_like_cv2(sampling, hw, tmp_path):
    """cv2's progressive files (jpeg_simple_progression: successive
    approximation, EOB runs), with and without restarts, and each of them
    cut after every scan but the last, as an interrupted download leaves it
    (libjpeg's block smoothing fills in what the cut scans did not send)."""
    img = _image(*hw, 7)
    for rst in (0, 1):
        data = _cv2_jpeg(img[..., ::-1], cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                         cv2.IMWRITE_JPEG_RST_INTERVAL, rst, cv2.IMWRITE_JPEG_QUALITY, 90)
        _assert_like_cv2(tmp_path, data, ".jpg", ("progressive", rst))
        for k, end in enumerate(_scan_ends(data)[:-1]):
            _assert_like_cv2(tmp_path, data[:end], ".jpg", ("cut after scan", k, rst))


@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_progressive_gray_like_cv2(hw, tmp_path):
    data = _cv2_jpeg(_image(*hw, 8)[..., 1], cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                     cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    _assert_like_cv2(tmp_path, data, ".jpg", "gray")
    for k, end in enumerate(_scan_ends(data)[:-1]):
        _assert_like_cv2(tmp_path, data[:end], ".jpg", ("cut after scan", k))


SCRIPTS = {
    "simple": None,                                         # SIMPLE_PROGRESSION_*
    "spectral": "spectral",
    # AC refinement over three steps, DC sent at Al = 2 then refined twice
    "refine": (("dc", [0, 1, 2], 0, 2), ("ac", 0, 1, 63, 0, 3), ("ac", 1, 1, 63, 0, 1),
               ("ac", 2, 1, 63, 0, 0), ("ac", 0, 1, 63, 3, 2), ("dc", [0, 1, 2], 2, 1),
               ("ac", 0, 1, 63, 2, 1), ("ac", 1, 1, 63, 1, 0), ("dc", [0, 1, 2], 1, 0),
               ("ac", 0, 1, 63, 1, 0)),
    # coefficients never sent: smoothing applies to the whole file
    "partial": (("dc", [0], 0, 0), ("dc", [1, 2], 0, 0), ("ac", 0, 1, 9, 0, 1),
                ("ac", 1, 1, 2, 0, 0), ("ac", 0, 1, 9, 1, 0)),
    "dc-only": (("dc", [0, 1, 2], 0, 0),),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_forged_progressive_like_cv2(script, hw, tmp_path):
    """Progressive re-codings of the port encoder's coefficients (4:2:0,
    quality 90), with restart intervals of 0 and 3 MCUs and cut after each
    scan. A complete script decodes to the baseline file's bits."""
    img = _image(*hw, 9)
    comps, q, w, h = forge.port_components(img, 90)
    scans = SCRIPTS[script]
    if scans is None:
        scans = forge.SIMPLE_PROGRESSION_3
    elif scans == "spectral":
        scans = forge.spectral_script(3)
    base = native_jpeg.decode(jpeg.encode(img, 90), True)
    for rst in (0, 3):
        data = forge.jpeg_bytes(comps, w, h, q, scans, restart=rst)
        _assert_like_cv2(tmp_path, data, ".jpg", (script, rst))
        if script in ("simple", "spectral", "refine"):
            np.testing.assert_array_equal(native_jpeg.decode(data, True), base)
        for k, end in enumerate(_scan_ends(data)[:-1]):
            _assert_like_cv2(tmp_path, data[:end], ".jpg", (script, rst, "cut", k))


@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_multiscan_sequential_like_cv2(hw, tmp_path):
    """Sequential frames whose components are split over several scans
    (each non-interleaved one walks its component's own blocks), with
    restarts: cv2's bits, and the baseline file's."""
    for color in (True, False):
        img = _image(*hw, 10) if color else _image(*hw, 10)[..., 0]
        comps, q, w, h = forge.port_components(img, 95)
        base = native_jpeg.decode(jpeg.encode(img, 95), color)
        n = len(comps)
        for scans in ([("seq", [i]) for i in range(n)][::-1],
                      [("seq", [0, 1]), ("seq", [2])] if n == 3 else [("seq", [0])]):
            for rst in (0, 2):
                data = forge.jpeg_bytes(comps, w, h, q, scans, restart=rst,
                                        progressive=False)
                _assert_like_cv2(tmp_path, data, ".jpg", (color, len(scans), rst))
                np.testing.assert_array_equal(native_jpeg.decode(data, color), base)


def _pil_jpeg(arr, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


FOUR_SAMPLINGS = (((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2)),
                  ((2, 1), (1, 1), (1, 1), (1, 1)))


@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_cmyk_like_cv2(hw, tmp_path):
    """PIL's CMYK files (Adobe transform 0; baseline, progressive, 4:2:0)
    and image_forge's (no Adobe marker, transform 0; interleaved, split and
    progressive scans): cv2's CMYK -> BGR and CMYK -> gray arithmetic."""
    cmyk = np.concatenate([_image(*hw, 11), _image(*hw, 12)[..., :1]], axis=2)
    for kw in ({}, {"progressive": True}, {"subsampling": 2, "quality": 95}):
        _assert_like_cv2(tmp_path, _pil_jpeg(cmyk, "CMYK", **kw), ".jpg", ("PIL", kw))
    for sampling in FOUR_SAMPLINGS:
        comps, q = forge.plane_components([cmyk[..., i] for i in range(4)], sampling)
        for adobe in (None, 0):
            for scans in ([("seq", [0, 1, 2, 3])], [("seq", [0, 1]), ("seq", [2, 3])],
                          [("dc", [0, 1, 2, 3], 0, 0)] + [("ac", i, 1, 63, 0, 0)
                                                          for i in range(4)]):
                data = forge.jpeg_bytes(comps, hw[1], hw[0], q, scans, jfif=False, adobe=adobe)
                _assert_like_cv2(tmp_path, data, ".jpg", (sampling, adobe, len(scans)))


@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_ycck_like_cv2(hw, tmp_path):
    """YCCK (Adobe transform 2, and 1, which libjpeg takes for YCCK too):
    jdcolor.c's ycck_cmyk_convert, then cv2's CMYK arithmetic."""
    planes = [_image(*hw, 13)[..., i] for i in range(3)] + [_image(*hw, 14)[..., 0]]
    for sampling in FOUR_SAMPLINGS:
        comps, q = forge.plane_components(planes, sampling)
        for adobe in (2, 1):
            for scans in ([("seq", [0, 1, 2, 3])], [("seq", [3]), ("seq", [0, 1, 2])],
                          [("dc", [0, 1, 2, 3], 0, 1)] + [("ac", i, 1, 63, 0, 0)
                                                          for i in range(4)]
                          + [("dc", [0, 1, 2, 3], 1, 0)]):
                data = forge.jpeg_bytes(comps, hw[1], hw[0], q, scans, jfif=False, adobe=adobe)
                _assert_like_cv2(tmp_path, data, ".jpg", (sampling, adobe, len(scans)))


@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_rgb_coded_like_cv2(hw, tmp_path):
    """RGB-coded files: PIL's keep_rgb (Adobe transform 0), component ids
    'R','G','B' with no JFIF or Adobe marker; a gray read is libjpeg's
    rgb_gray_convert. The same ids under JFIF, or Adobe transform 1, are
    YCbCr."""
    img = _image(*hw, 15)
    for kw in ({}, {"progressive": True}):
        _assert_like_cv2(tmp_path, _pil_jpeg(img, "RGB", keep_rgb=True, **kw), ".jpg",
                         ("PIL", kw))
    planes = [img[..., i] for i in range(3)]
    for sampling in (((1, 1),) * 3, ((2, 2), (1, 1), (1, 1))):
        comps, q = forge.plane_components(planes, sampling, ids=[82, 71, 66])
        for jfif, adobe in ((False, None), (False, 0), (True, None), (False, 1)):
            data = forge.jpeg_bytes(comps, hw[1], hw[0], q, [("seq", [0, 1, 2])], jfif=jfif,
                                    adobe=adobe)
            _assert_like_cv2(tmp_path, data, ".jpg", (sampling, jfif, adobe))


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("hw", SIZES[2:], ids=SIZE_IDS[2:])
def test_truncated_jpeg_like_cv2(progressive, hw, tmp_path):
    """Files cut anywhere in their data, with and without restarts, where
    cv2 still gives an image: the MCU the data ran out in decodes on zero
    bits, then nothing more until the next restart marker (libjpeg's
    insufficient_data); a progressive file then smooths what it has."""
    img = _image(*hw, 21)
    for rst in (0, 2):
        data = _cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
                         cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
        start = data.index(b"\xff\xda") + 20
        path = str(tmp_path / "cut.jpg")
        rng = np.random.default_rng(hw[0] + rst)
        for cut in rng.integers(start, len(data) - 2, 6):
            with open(path, "wb") as f:
                f.write(data[:cut])
            if cv2.imread(path) is not None:
                _assert_like_cv2(tmp_path, data[:cut], ".jpg", (rst, int(cut)))


def test_jpeg_without_huffman_tables_like_cv2(tmp_path):
    """A file with no DHT segment decodes with the standard tables
    (jstdhuff.c: Motion-JPEG frames leave them out); a DNL segment between
    scans is skipped."""
    img = _image(37, 53, 22)
    data = _cv2_jpeg(img)                       # cv2's tables are the standard ones
    out, i = [data[:2]], 2
    while True:
        marker, length = struct.unpack(">HH", data[i:i + 4])
        if marker != 0xFFC4:
            out.append(data[i:i + 2 + length])
        if marker == 0xFFDA:
            break
        i += 2 + length
    _assert_like_cv2(tmp_path, b"".join(out) + data[i + 2 + length:], ".jpg", "no DHT")
    comps, q, w, h = forge.port_components(img, 95)
    split = forge.jpeg_bytes(comps, w, h, q, [("seq", [0]), ("seq", [1, 2])])
    k = split.rindex(b"\xff\xc4")
    dnl = b"\xff\xdc\x00\x04" + struct.pack(">H", h)
    _assert_like_cv2(tmp_path, split[:k] + dnl + split[k:], ".jpg", "DNL")


def _app1_orientation(value: int, little_endian: bool) -> bytes:
    e = "<" if little_endian else ">"
    return ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, value, 0)
            + struct.pack(e + "I", 0))


@pytest.mark.parametrize("orientation", range(10))
def test_progressive_exif_orientation_like_cv2(orientation, tmp_path):
    data = _cv2_jpeg(_image(37, 53, 16), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    for le in (True, False):
        payload = b"Exif\x00\x00" + _app1_orientation(orientation, le)
        app1 = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
        _assert_like_cv2(tmp_path, data[:2] + app1 + data[2:], ".jpg", le)


def test_jpeg_kinds_still_refused(tmp_path):
    """The kinds cv2 gives no image for raise NotImplementedError (the
    port's Cv2Refuses): hierarchical frames, 12-bit samples, 2 components, a
    lossless YCbCr file and, in a colour read, non-integral sampling. A
    baseline or progressive file's Huffman data under an arithmetic SOF
    marker decodes as arithmetic-coded data, as cv2 decodes it."""
    img = _image(37, 53, 17)
    base = _cv2_jpeg(img)
    prog = _cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    sof, psof = base.index(b"\xff\xc0"), prog.index(b"\xff\xc2")
    comps, q = forge.plane_components([img[..., 0], img[..., 1]], ((1, 1), (1, 1)))
    two = forge.jpeg_bytes(comps, 53, 37, q, [("seq", [0, 1])])
    comps, q = forge.plane_components([img[..., 0], img[..., 1], img[..., 2]],
                                      ((3, 1), (2, 1), (1, 1)))
    for data in (base[:sof] + b"\xff\xc9" + base[sof + 2:],
                 prog[:psof] + b"\xff\xca" + prog[psof + 2:]):
        _assert_like_cv2(tmp_path, data, ".jpg", "arithmetic")
    files = {"lossless": base[:sof] + b"\xff\xc3" + base[sof + 2:],
             "hierarchical": base[:sof] + b"\xff\xc5" + base[sof + 2:],
             "12-bit": base[:sof + 4] + b"\x0c" + base[sof + 5:],
             "12-bit progressive": prog[:psof + 4] + b"\x0c" + prog[psof + 5:],
             "2 components": two}
    for name, data in files.items():
        path = str(tmp_path / "r.jpg")
        with open(path, "wb") as f:
            f.write(data)
        for color in (True, False):
            assert _cv2_read(path, color) is None, (name, color)
            with pytest.raises(native_jpeg.Cv2Refuses, match="ROADMAP"):
                native_jpeg.decode(data, color)
    # non-integral sampling (Y 3x1, Cb 2x1, Cr 1x1): libjpeg refuses to
    # upsample Cb, so a colour read gives no image; a gray read needs Y only
    rng = np.random.default_rng(18)
    comps = []
    for i, hs in enumerate((3, 2, 1)):
        coef = rng.integers(-6, 7, (2, 2 * hs, 64))
        coef[..., 0] = rng.integers(-60, 61, (2, 2 * hs))
        comps.append({"id": i + 1, "h": hs, "v": 1, "tq": 0, "coef": coef})
    data = forge.jpeg_bytes(comps, 48, 16, {0: np.full(64, 4)}, [("seq", [0, 1, 2])])
    path = str(tmp_path / "n.jpg")
    with open(path, "wb") as f:
        f.write(data)
    assert cv2.imread(path) is None
    with pytest.raises(native_jpeg.Cv2Refuses, match="non-integral"):
        native_jpeg.decode(data, True)
    np.testing.assert_array_equal(native_jpeg.decode(data, False), _cv2_read(path, False))


# ----------------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------------

COMBOS = [(c, d) for c, ds in forge.DEPTHS.items() for d in ds]
TRNS = {0: lambda d: struct.pack(">H", (1 << d) // 3), 2: lambda d: struct.pack(">HHH", 1, 2, 3),
        3: lambda d: bytes([0, 128, 255])}


@pytest.mark.parametrize("ctype,depth", COMBOS, ids=[f"type{c}-{d}bit" for c, d in COMBOS])
@pytest.mark.parametrize("hw", SIZES, ids=SIZE_IDS)
def test_png_like_cv2(ctype, depth, hw, tmp_path):
    """Every colour type x bit depth of the specification, non-interlaced
    and Adam7 (every row filter in turn), plain, with tRNS (where the type
    has one), with gAMA 0.45455 and 2.0, with sRGB (which wins over gAMA)
    and with an sBIT before gAMA; a palette shorter than the indices."""
    npal = 1 << depth if ctype == 3 else 0
    s = forge.random_samples(*hw, ctype, depth, seed=hw[0] * 7 + depth, n_palette=npal)
    pal = (np.random.default_rng(depth).integers(0, 256, (max(1, npal - 2), 3))
           if ctype == 3 else None)
    sbit = bytes([8 if depth == 16 else max(1, min(depth, 8) - 2)]
                 * ((3 if ctype & 2 else 1) + (1 if ctype & 4 else 0)))
    variants = {"plain": {}, "gAMA": {"pre": (forge.gama(0.45455),)},
                "gAMA 2": {"pre": (forge.gama(2.0),)},
                "sRGB": {"pre": (forge.gama(1.0), (b"sRGB", b"\x00"))},
                "sBIT": {"pre": ((b"sBIT", sbit), forge.gama(0.45455))}}
    if ctype in TRNS:
        variants["tRNS"] = {"trns": TRNS[ctype](depth)}
    for interlace in (False, True):
        for name, kw in variants.items():
            data = forge.png_bytes(s, ctype, depth, interlace, palette=pal, **kw)
            _assert_like_cv2(tmp_path, data, ".png", (name, interlace))


def test_png_cv2_and_pil_files_like_cv2(tmp_path):
    rng = np.random.default_rng(19)
    img16 = rng.integers(0, 65536, (37, 53, 3)).astype(np.uint16)
    files = []
    for arr, flags in ((img16, []), (img16[..., 0], []),
                       (_image(37, 53, 20)[..., 0], [cv2.IMWRITE_PNG_BILEVEL, 1]),
                       (_image(37, 53, 21), [cv2.IMWRITE_PNG_STRATEGY,
                                             cv2.IMWRITE_PNG_STRATEGY_FILTERED])):
        ok, buf = cv2.imencode(".png", arr, flags)
        files.append(buf.tobytes())
    pal = Image.fromarray(_image(37, 53, 22)).convert("P", palette=Image.Palette.ADAPTIVE,
                                                      colors=13)
    for mode, kw in ((pal, {"transparency": 3}), (pal, {"bits": 4}),
                     (Image.fromarray(_image(37, 53, 23)).convert("LA"), {}),
                     (Image.fromarray(_image(37, 53, 24)).convert("RGBA"), {}),
                     (Image.fromarray(_image(37, 53, 25)[..., 0] > 128), {})):
        buf = io.BytesIO()
        mode.save(buf, "PNG", **kw)
        files.append(buf.getvalue())
    for i, data in enumerate(files):
        _assert_like_cv2(tmp_path, data, ".png", i)


@pytest.mark.parametrize("orientation", range(10))
def test_png_exif_orientation_like_cv2(orientation, tmp_path):
    """cv2 turns a PNG by the Orientation tag of its first eXIf chunk,
    before or after the image data (a chunk with a bad CRC is dropped)."""
    s = forge.random_samples(7, 13, 2, 8, 26)
    for le in (True, False):
        exif = (b"eXIf", _app1_orientation(orientation, le))
        other = (b"eXIf", _app1_orientation(6 if orientation != 6 else 3, le))
        for kw in ({"pre": (exif,)}, {"post": (exif,)}, {"pre": (exif,), "post": (other,)}):
            _assert_like_cv2(tmp_path, forge.png_bytes(s, 2, 8, **kw), ".png", (le, kw))
    data = forge.png_bytes(s, 2, 8, pre=((b"eXIf", _app1_orientation(orientation, True)),))
    i = data.index(b"eXIf") + 4 + len(_app1_orientation(0, True))
    _assert_like_cv2(tmp_path, data[:i] + bytes([data[i] ^ 1]) + data[i + 1:], ".png", "bad crc")


def test_png_chunk_rules_like_cv2(tmp_path):
    """libpng's rules as cv2 meets them: an ancillary chunk with a bad CRC
    and a gAMA or sRGB after PLTE or IDAT are ignored, zlib data past the
    image is ignored; a critical chunk with a bad CRC, an unknown critical
    chunk, a missing IEND, a bad zlib checksum and too little image data
    give no image (the port raises ValueError)."""
    s = forge.random_samples(37, 53, 2, 8, 27)
    ok_files = {
        "gAMA bad CRC": forge.png_bytes(s, 2, 8, pre=(forge.gama(0.45455),)),
        "gAMA after PLTE": forge.png_bytes(s, 2, 8, palette=np.zeros((4, 3), np.uint8),
                                           trns=None, post=()),
        "gAMA after IDAT": forge.png_bytes(s, 2, 8, post=(forge.gama(0.45455),)),
        "sRGB after IDAT": forge.png_bytes(s, 2, 8, post=((b"sRGB", b"\x00"),)),
        "tiny gAMA": forge.png_bytes(s, 2, 8, pre=((b"gAMA", struct.pack(">I", 10)),)),
        "unknown ancillary": forge.png_bytes(s, 2, 8, pre=((b"zzZz", b"123"),)),
        "split IDAT": forge.png_bytes(s, 2, 8, idat_chunks=7),
    }
    d = ok_files["gAMA bad CRC"]
    i = d.index(b"gAMA") + 8
    ok_files["gAMA bad CRC"] = d[:i] + bytes([d[i] ^ 1]) + d[i + 1:]
    d = ok_files["gAMA after PLTE"]
    i = d.index(b"IDAT") - 4
    ok_files["gAMA after PLTE"] = d[:i] + forge.chunk(b"gAMA", struct.pack(">I", 45455)) + d[i:]
    raw = forge.png_raw(s, 2, 8)
    ihdr = forge.chunk(b"IHDR", struct.pack(">IIBBBBB", 53, 37, 8, 2, 0, 0, 0))

    def wrap(z):
        return forge.PNG_MAGIC + ihdr + forge.chunk(b"IDAT", z) + forge.chunk(b"IEND", b"")

    import zlib
    ok_files["extra data"] = wrap(zlib.compress(raw + b"\x00" * 99))
    for name, data in ok_files.items():
        _assert_like_cv2(tmp_path, data, ".png", name)
    good = forge.png_bytes(s, 2, 8)
    i = good.index(b"IDAT") + 4 + struct.unpack(">I", good[good.index(b"IDAT") - 4:
                                                          good.index(b"IDAT")])[0]
    bad_files = {
        "IDAT bad CRC": good[:i] + bytes([good[i] ^ 1]) + good[i + 1:],
        "unknown critical": forge.png_bytes(s, 2, 8, pre=((b"ZZZZ", b"123"),)),
        "no IEND": good[:-12],
        "bad adler": wrap(zlib.compress(raw)[:-4] + b"\x00\x00\x00\x00"),
        "short": wrap(zlib.compress(raw[:-5])),
        "cut stream": wrap(zlib.compress(raw)[:-20]),
    }
    for name, data in bad_files.items():
        path = str(tmp_path / "bad.png")
        with open(path, "wb") as f:
            f.write(data)
        assert cv2.imread(path) is None, name
        with pytest.raises(ValueError):
            native_png.decode(data, True)


_FUZZ = r"""
import numpy as np, struct, sys, zlib
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
from panovlm_tpu_torch.native import png
rng = np.random.default_rng(0)
base = [open(p, "rb").read() for p in sys.argv[2:]]

def fix_crcs(b):
    i = 8
    while i + 12 <= len(b):
        n = struct.unpack(">I", b[i:i + 4])[0]
        if i + 12 + n > len(b):
            break
        b[i + 8 + n:i + 12 + n] = struct.pack(">I", zlib.crc32(bytes(b[i + 4:i + 8 + n])))
        i += 12 + n
    return b

seen = set()
for it in range(2000):
    b = bytearray(base[it % len(base)])
    for _ in range(rng.integers(1, 6)):
        b[rng.integers(8, len(b))] = rng.integers(0, 256)
    if it % 3:
        b = fix_crcs(b)
    if it % 7 == 0:
        b = b[:rng.integers(8, len(b))]
    try:
        png.decode(bytes(b), bool(it % 2))
        seen.add("decoded")
    except (ValueError, NotImplementedError) as e:
        seen.add(type(e).__name__)
print(" ".join(sorted(seen)))
"""


def test_png_corrupt_files_decode_or_raise(tmp_path):
    """2,000 corrupted PNGs (bytes overwritten, CRCs recomputed on two
    thirds of them so that the damage reaches the decoder, files cut): each
    decodes or raises ValueError / NotImplementedError, in a subprocess that
    must not crash. Stored (level 0) data keeps the mutations in the
    filtered rows."""
    paths = []
    for i, (ctype, depth, interlace) in enumerate(((2, 8, False), (3, 4, True), (0, 16, True),
                                                   (6, 8, False), (0, 1, False))):
        s = forge.random_samples(19, 23, ctype, depth, 30 + i, n_palette=16)
        pal = np.random.default_rng(i).integers(0, 256, (16, 3)) if ctype == 3 else None
        path = str(tmp_path / f"{i}.png")
        with open(path, "wb") as f:
            f.write(forge.png_bytes(s, ctype, depth, interlace, palette=pal,
                                    pre=(forge.gama(0.45455),), level=0 if i % 2 else 6))
        paths.append(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FUZZ, root, *paths], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["ValueError", "decoded"]


# ----------------------------------------------------------------------------
# the port's loaders against the JAX package's; threads; the smoke probes
# ----------------------------------------------------------------------------

def _format_dir(tmp_path, kind):
    """Three frames of 75 x 151 in one kind of file."""
    d = tmp_path / kind
    d.mkdir()
    for i in range(3):
        img = _image(75, 151, 40 + i)
        if kind == "progressive":
            data = _cv2_jpeg(img if i != 1 else img[..., 0], cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                             cv2.IMWRITE_JPEG_RST_INTERVAL, i)
            (d / f"{i:06d}.jpg").write_bytes(data)
        elif kind == "png16":
            arr = img.astype(np.uint16) * 257 + i
            cv2.imwrite(str(d / f"{i:06d}.png"), arr if i != 1 else arr[..., 0])
        else:   # Adam7, gray, RGB and palette frames
            ctype = (0, 2, 3)[i]
            s = img[..., 0] if ctype == 0 else (img if ctype == 2 else img[..., 0] // 16)
            pal = np.random.default_rng(i).integers(0, 256, (16, 3)) if ctype == 3 else None
            data = forge.png_bytes(s, ctype, 8 if ctype != 3 else 4, True, palette=pal)
            (d / f"{i:06d}.png").write_bytes(data)
    return d


@pytest.mark.parametrize("kind", ["progressive", "png16", "adam7"])
@pytest.mark.parametrize("color,scale", [(False, 0), (False, -1), (True, 0), (True, -1)])
def test_load_images_formats_match_jax_package(tmp_path, kind, color, scale):
    d = _format_dir(tmp_path, kind)
    ref, names = jpipe.load_images(Config(image_path=str(d), scale=scale), color=color)
    out, names_t = images.load_images(str(d), scale, color=color)
    assert names_t == names
    for a, b in zip(out, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("hw", [(50, 101), (150, 302), (13, 7)])
def test_load_mask_palette_png_matches_jax_package(tmp_path, depth, hw):
    """A 1-bit gray and a 4-bit palette mask (palette entry 0 black, the
    others colours, some dark enough to read as gray 0), nearest-resized as
    cv2.resize(INTER_NEAREST) does in the JAX package."""
    rng = np.random.default_rng(depth)
    m = np.kron(rng.integers(0, 1 << depth, (15, 31)), np.ones((5, 5), int))[:75, :151]
    path = str(tmp_path / "mask.png")
    if depth == 1:
        data = forge.png_bytes(m, 0, 1, interlace=True)
    else:
        pal = rng.integers(0, 256, (16, 3))
        pal[0] = 0
        pal[1] = (1, 0, 0)
        data = forge.png_bytes(m, 3, 4, palette=pal, trns=bytes([0, 255]))
    with open(path, "wb") as f:
        f.write(data)
    ref = jpipe.load_mask(Config(mask_path=path), *hw)
    out = images.load_mask(path, *hw)
    assert out.shape == hw and out.dtype == bool
    np.testing.assert_array_equal(out, ref)


def test_decoders_on_threads_give_one_thread_bits():
    """8 different files (progressive, cut progressive, CMYK, RGB-coded,
    16-bit, Adam7, palette, baseline) decoded on 8 threads at once, 4
    rounds: every result equals the file's one-thread decode."""
    img = _image(129, 257, 50)
    prog = _cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    cmyk = np.concatenate([img, img[..., :1]], axis=2)
    files = [
        (prog, native_jpeg),
        (prog[:_scan_ends(prog)[2]], native_jpeg),
        (_pil_jpeg(cmyk, "CMYK"), native_jpeg),
        (_pil_jpeg(img, "RGB", keep_rgb=True), native_jpeg),
        (forge.png_bytes(img.astype(np.uint16) * 257, 2, 16, filters=4), native_png),
        (forge.png_bytes(img, 2, 8, interlace=True, pre=(forge.gama(0.45455),)), native_png),
        (forge.png_bytes(img[..., 0] // 16, 3, 4, palette=np.arange(48).reshape(16, 3) * 5),
         native_png),
        (_cv2_jpeg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 3), native_jpeg),
    ]
    jobs = [(data, mod, color) for data, mod in files for color in (True, False)]
    ref = [mod.decode(data, color) for data, mod, color in jobs]
    with ThreadPoolExecutor(max_workers=8) as ex:
        for _ in range(4):
            out = list(ex.map(lambda j: j[1].decode(j[0], j[2]), jobs))
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(cs.FORMAT_PROBES))
def test_smoke_format_probes_are_cv2s(name, tmp_path):
    """chip_smoke.py phase 16 (a)'s embedded files: each under 4 KB of
    base64, its digests those of cv2.imread of the file (colour in RGB
    order, gray; None where cv2 gives no image), and the port's decoder
    gives them (and refuses where cv2 gives none)."""
    b64, ext, digests = cs.FORMAT_PROBES[name]
    assert len(b64) < 4096, len(b64)
    data = base64.b64decode(b64)
    path = str(tmp_path / f"probe{ext}")
    with open(path, "wb") as f:
        f.write(data)
    for kind in ("color", "gray"):
        ref = _cv2_read(path, kind == "color")
        if ref is None:
            assert digests[kind] is None, kind
            continue
        assert hashlib.sha256(np.ascontiguousarray(ref).tobytes()).hexdigest() == digests[kind], \
            kind
    cs.check_format_probes(names=(name,))
