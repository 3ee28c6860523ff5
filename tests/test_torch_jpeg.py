"""The port's JPEG (panovlm_tpu_torch/io/jpeg.py).

The encoder (ROADMAP F10) against cv2.imwrite at its defaults (quality 95,
4:2:0), both decoded by cv2.imdecode: on the SfM stage's depth
visualisation (a 128 x 256 depth colour map blended with the panorama), a
gray panorama and a colour crop of odd size (partial MCUs), the decoded
images differ by at most 0.5 in mean absolute value and 8 at any pixel.
The quantisation and Huffman tables are cv2's byte for byte.

The decoder (`read_jpeg`, native/jpeg.cpp) against cv2.imread, colour (BGR
-> RGB) and gray, bit for bit, on one parametrised set: sampling 4:4:4,
4:2:2, 4:2:0, 4:4:0 and 4:1:1 at quality 50, 95 and 100, optimised Huffman
tables, restart intervals, a one-component file, the port's own encoder's
output, tables split over several segments and fill bytes before markers,
each at 1 x 1, 7 x 13, 37 x 53 and 129 x 257; EXIF orientation 1-8 (and 0,
9) in both byte orders, in an APP1 segment spliced into a cv2-written file.
A progressive file reads as cv2 reads it (the progressive, multi-scan,
CMYK, YCCK and RGB-coded kinds in full: tests/test_torch_image_formats.py);
arithmetic-coded and 12-bit files raise NotImplementedError naming
ROADMAP; 2,000 corrupted files (bytes overwritten, files cut; baseline,
progressive and multi-scan bases) decode or raise ValueError /
NotImplementedError, in a subprocess that must not crash. chip_smoke.py's
JPEG bounds: the q95 round trip of a
phase-11 colour panorama at 360 x 720 stays within JPEG_Q95_MEAN / _MAX,
and its embedded probe decodes to cv2's bits.
"""

import base64
import hashlib
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from panovlm_tpu_torch.io import jpeg
from panovlm_tpu_torch.utils import visualization as viz

from synthetic import render_panorama

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)


def _images():
    gray, depth = render_panorama((0.3, -0.2, 0.1), 128, 256)
    color = viz.depth_to_color(depth, 10.0)                       # BGR, as the stage
    blend = (0.5 * color + 0.5 * (gray[..., None] * 255)).astype(np.uint8)
    return {"depth_blend": blend, "gray": (gray * 255).astype(np.uint8),
            "odd_crop": blend[:77, :203]}


def _segments(data: bytes):
    out, i = {}, 2
    while i < len(data):
        marker, length = struct.unpack(">HH", data[i:i + 4])
        out.setdefault(marker, []).append(data[i + 4:i + 2 + length])
        if marker == 0xFFDA:
            break
        i += 2 + length
    return out


@pytest.mark.parametrize("name", ["depth_blend", "gray", "odd_crop"])
def test_jpeg_decodes_like_cv2_encoding(name, tmp_path):
    img = _images()[name]
    path = str(tmp_path / "depth_0.jpg")
    # the stage hands the encoder RGB; cv2.imwrite takes BGR
    jpeg.write_jpeg(path, img[..., ::-1] if img.ndim == 3 else img)
    mine = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    ok, ref = cv2.imencode(".jpg", img)
    assert ok
    ref_img = cv2.imdecode(ref, cv2.IMREAD_UNCHANGED)
    assert mine.shape == img.shape
    diff = np.abs(mine.astype(np.int64) - ref_img.astype(np.int64))
    assert diff.mean() <= 0.5 and diff.max() <= 8, (diff.mean(), diff.max())
    with open(path, "rb") as f:
        seg_m = _segments(f.read())
    seg_r = _segments(ref.tobytes())
    for marker in (0xFFDB, 0xFFC4):      # quantisation and Huffman tables
        assert b"".join(seg_m[marker]) == b"".join(seg_r[marker]), hex(marker)


def test_jpeg_rejects_other_inputs():
    with pytest.raises(ValueError):
        jpeg.encode(np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError):
        jpeg.encode(np.zeros((8, 8, 4), np.uint8))


SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = ((1, 1), (7, 13), (37, 53), (129, 257))


def _test_image(h, w, seed):
    """Smooth colour structure plus noise, so that every coefficient band
    and the chroma carry signal. RGB uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 128 + 90 * np.sin(yy / 4.0) * np.cos(xx / 6.0)
    img = np.stack([base, 255 - base, (0.5 * base + 3 * xx) % 256], axis=-1)
    return np.clip(img + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def _split_tables(data: bytes) -> bytes:
    """The same file with every DQT and DHT segment that holds several
    tables rewritten as one segment per table."""
    out, i = [data[:2]], 2
    while True:
        marker, length = struct.unpack(">HH", data[i:i + 4])
        body = data[i + 4:i + 2 + length]
        if marker == 0xFFDB:
            j = 0
            while j < len(body):
                size = 1 + (128 if body[j] >> 4 else 64)
                out.append(struct.pack(">HH", marker, size + 2) + body[j:j + size])
                j += size
        elif marker == 0xFFC4:
            j = 0
            while j < len(body):
                size = 17 + sum(body[j + 1:j + 17])
                out.append(struct.pack(">HH", marker, size + 2) + body[j:j + size])
                j += size
        else:
            out.append(data[i:i + 2 + length])
        if marker == 0xFFDA:
            return b"".join(out) + data[i + 2 + length:]
        i += 2 + length


def _fill_bytes(data: bytes) -> bytes:
    """FF fill bytes before the SOS and EOI markers."""
    sos = data.index(b"\xff\xda")
    return data[:sos] + b"\xff\xff" + data[sos:-2] + b"\xff\xff\xff" + data[-2:]


def _encode(kind: str, h: int, w: int) -> bytes:
    img = _test_image(h, w, h * 1000 + w)
    bgr = img[..., ::-1]
    if kind == "gray":
        ok, buf = cv2.imencode(".jpg", img[..., 1])
    elif kind == "port":
        return jpeg.encode(img, 95)
    elif kind in ("optimize", "restart", "split", "fill"):
        flags = {"optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
                 "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]}.get(kind, [])
        ok, buf = cv2.imencode(".jpg", bgr, flags)
    else:
        sampling, quality = kind.split("-q")
        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, int(quality),
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                             SAMPLING[sampling]])
    assert ok
    data = buf.tobytes()
    return {"split": _split_tables, "fill": _fill_bytes}.get(kind, lambda d: d)(data)


def _assert_reads_like_cv2(path):
    for color in (True, False):
        ref = cv2.imread(path, cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
        ref = ref[..., ::-1] if color else ref
        out = jpeg.read_jpeg(path, color)
        assert out.dtype == np.uint8 and out.shape == ref.shape, (color, out.shape, ref.shape)
        np.testing.assert_array_equal(out, ref, err_msg=f"color={color}")


@pytest.mark.parametrize("kind", [f"{s}-q{q}" for s in SAMPLING for q in (50, 95, 100)]
                         + ["optimize", "restart", "gray", "port", "split", "fill"])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_jpeg_reads_like_cv2(kind, hw, tmp_path):
    path = str(tmp_path / "f.jpg")
    with open(path, "wb") as f:
        f.write(_encode(kind, *hw))
    _assert_reads_like_cv2(path)


def _app1_orientation(value: int, little_endian: bool) -> bytes:
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, value, 0)
            + struct.pack(e + "I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("orientation", range(10))
def test_jpeg_exif_orientation_like_cv2(orientation, tmp_path):
    """cv2.imread turns the image by the Orientation tag (1-8; other values
    leave it) unless IMREAD_IGNORE_ORIENTATION is given, and the JAX
    package does not give it."""
    ok, buf = cv2.imencode(".jpg", _test_image(37, 53, 5))
    data = buf.tobytes()
    for le in (True, False):
        path = str(tmp_path / f"o{int(le)}.jpg")
        with open(path, "wb") as f:       # after SOI and after the JFIF APP0
            f.write(data[:2] + _app1_orientation(orientation, le) + data[2:])
        _assert_reads_like_cv2(path)
        app0_end = 4 + struct.unpack(">H", data[4:6])[0]
        with open(path, "wb") as f:
            f.write(data[:app0_end] + _app1_orientation(orientation, le) + data[app0_end:])
        _assert_reads_like_cv2(path)


def test_jpeg_unsupported_kinds_raise(tmp_path):
    """12-bit files raise; a progressive file, refused before the
    progressive decoder, and an arithmetic-coded one (a baseline file's
    Huffman data read as arithmetic-coded), refused before the arithmetic
    decoder, now read as cv2 reads them."""
    img = _test_image(37, 53, 6)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    path = str(tmp_path / "progressive.jpg")
    with open(path, "wb") as f:
        f.write(prog.tobytes())
    _assert_reads_like_cv2(path)
    ok, base = cv2.imencode(".jpg", img)
    base = base.tobytes()
    sof = base.index(b"\xff\xc0")
    path = str(tmp_path / "arithmetic.jpg")
    with open(path, "wb") as f:
        f.write(base[:sof] + b"\xff\xc9" + base[sof + 2:])
    _assert_reads_like_cv2(path)
    files = {"12-bit": base[:sof + 4] + b"\x0c" + base[sof + 5:]}
    for name, data in files.items():
        path = str(tmp_path / f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            jpeg.read_jpeg(path, True)


@pytest.mark.parametrize("frame", [0, 8])
def test_q95_round_trip_bounds_of_the_smoke(frame):
    """chip_smoke.py phase 11 holds one decoded 2880 x 5760 panorama to its
    source array within JPEG_Q95_MEAN / _MAX: the round trip of the port's
    q95 encoder and decoder on the phase's frames 0 and 8 at 360 x 720
    (measured mean 2.380 and 2.381, max 56 and 62), decoded as cv2 decodes
    it, is within them."""
    scans, poses = cs.room_loop(frame + 1, sweep_alpha=0.0)
    R, t = cs._camera_convention(poses)
    rgb = cs.render_color(t[frame], 360, 720, R[frame])
    data = jpeg.encode(rgb, 95)
    from panovlm_tpu_torch.native import jpeg as native_jpeg
    out = native_jpeg.decode(data, True)
    np.testing.assert_array_equal(out, cv2.imdecode(np.frombuffer(data, np.uint8), 1)[..., ::-1])
    diff = np.abs(out.astype(np.int16) - rgb.astype(np.int16))
    assert diff.mean() <= cs.JPEG_Q95_MEAN and diff.max() <= cs.JPEG_Q95_MAX, \
        (diff.mean(), diff.max())


def test_smoke_probe_is_cv2s():
    """The JPEG that chip_smoke.py decodes on the card's machine (which has
    no cv2) to check the decoder built there: its hashes are cv2's bits."""
    from panovlm_tpu_torch.native import jpeg as native_jpeg
    data = base64.b64decode(cs.JPEG_PROBE_B64)
    buf = np.frombuffer(data, np.uint8)
    ref = {"color": np.ascontiguousarray(cv2.imdecode(buf, 1)[..., ::-1]),
           "gray": cv2.imdecode(buf, 0)}
    for kind, img in ref.items():
        assert hashlib.sha256(img.tobytes()).hexdigest() == cs.JPEG_PROBE_SHA256[kind], kind
        np.testing.assert_array_equal(native_jpeg.decode(data, kind == "color"), img)
    cs.check_jpeg_decoder()


_FUZZ = r"""
import numpy as np, sys
sys.path.insert(0, sys.argv[1])
from panovlm_tpu_torch.native import jpeg
rng = np.random.default_rng(0)
base = [open(p, "rb").read() for p in sys.argv[2:]]
seen = set()
for it in range(2000):
    b = bytearray(base[it % len(base)])
    for _ in range(rng.integers(1, 6)):
        b[rng.integers(0, len(b))] = rng.integers(0, 256)
    if it % 7 == 0:
        b = b[:rng.integers(2, len(b))]
    try:
        jpeg.decode(bytes(b), bool(it % 2))
        seen.add("decoded")
    except (ValueError, NotImplementedError) as e:
        seen.add(type(e).__name__)
print(" ".join(sorted(seen)))
"""


def test_jpeg_corrupt_files_decode_or_raise(tmp_path):
    """Baseline bases at four samplings, a progressive one (successive
    approximation, restarts) and a multi-scan sequential one. A refusal is
    native.jpeg.Cv2Refuses, the NotImplementedError of kinds cv2 gives no
    image for."""
    import image_forge
    paths = []
    for i, sampling in enumerate(("420", "444", "411", "440", "prog")):
        path = str(tmp_path / f"{i}.jpg")
        flags = ([cv2.IMWRITE_JPEG_PROGRESSIVE, 1] if sampling == "prog" else
                 [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
        ok, buf = cv2.imencode(".jpg", _test_image(37, 53, i),
                               flags + [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
        with open(path, "wb") as f:
            f.write(buf.tobytes())
        paths.append(path)
    comps, q, w, h = image_forge.port_components(_test_image(37, 53, 5), 95)
    path = str(tmp_path / "multiscan.jpg")
    with open(path, "wb") as f:
        f.write(image_forge.jpeg_bytes(comps, w, h, q, [("seq", [2]), ("seq", [0, 1])],
                                       restart=2))
    paths.append(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _FUZZ, root, *paths], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["Cv2Refuses", "ValueError", "decoded"]
