"""How the port's image reads choose and fail, against the JAX package's
cv2.imread-based `load_images` / `load_mask` (panovlm_tpu/pipeline.py):

  * the mask's resize is cv2.resize(INTER_NEAREST): source index
    min(floor(i * (1 / (N / n))), n - 1) in float64, bit-equal on the sizes
    where floor(i * n / N) rounds the other way (33 x 65 -> 300 x 900) and
    on a grid of sizes;
  * a mask cv2 gives no image for (corrupt or cut, no known signature,
    empty, a directory, a 12-bit or 2-component JPEG, a PNG with a bad
    critical CRC) is None, with the JAX package's "Fail to read mask" log
    line;
  * the decoder follows the file's first bytes, as cv2's findDecoder does:
    a PNG named .jpg and a JPEG named .png load as in the JAX package, as
    frames (gray and colour, scale 0 and -1) and as masks;
  * a BMP, PxM, PAM, PFM, Sun raster, TIFF or GIF file that cv2 writes,
    named mask.png, reads with cv2's bits as a frame and as a mask (a PFM
    mask is None: cv2 gives no gray image for a three-channel PFM);
  * GIF frames named .png (an interlaced one, one on a larger screen with a
    background colour, one with a transparent index, one cv2 writes) load
    as in the JAX package, gray and colour, scale 0 and -1;
  * a file of another format cv2 reads (HDR, WebP, AVIF, JPEG 2000)
    raises NotImplementedError naming the format and ROADMAP.md, as a mask
    too: only "cv2 gives no image" reads as no mask.
"""

import io
import logging
import struct

import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline as jpipe
from panovlm_tpu.config import Config
from panovlm_tpu_torch.io import images

import image_forge as forge

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")
torch.set_num_threads(2)


def _mask(h, w, seed):
    """A gray mask with zero and nonzero runs and single pixels."""
    rng = np.random.default_rng(seed)
    m = (rng.random((h, w)) < 0.5).astype(np.uint8) * rng.integers(1, 256, (h, w))
    return m.astype(np.uint8)


def _write(path, data: bytes):
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _png(arr) -> bytes:
    ok, buf = cv2.imencode(".png", arr)
    assert ok
    return buf.tobytes()


def _jpeg(arr, *flags) -> bytes:
    ok, buf = cv2.imencode(".jpg", arr, list(flags))
    assert ok
    return buf.tobytes()


def _same_mask(path, H, W):
    ref = jpipe.load_mask(Config(mask_path=path), H, W)
    out = images.load_mask(path, H, W)
    if ref is None:
        assert out is None
        return
    assert out is not None and out.dtype == bool and out.shape == (H, W)
    np.testing.assert_array_equal(out, ref)


# ----------------------------------------------------------------------------
# the mask's nearest resize
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((33, 65), (300, 900)), ((35, 70), (720, 1440)),
                                     ((75, 151), (150, 302)), ((7, 3), (13, 7))])
def test_mask_nearest_resize_matches_jax_package(tmp_path, src, dst):
    """The sizes where floor(i * n / N) and cv2's floor(i * (1 / (N / n)))
    part (33 x 65 -> 300 x 900: rows 100 and 200 take source rows 10 and
    21 in cv2), and a down-size."""
    path = _write(tmp_path / "mask.png", _png(_mask(*src, sum(src))))
    _same_mask(path, *dst)
    # the cases that motivated the repair differ from the naive index
    if src == (33, 65):
        naive = np.floor(np.arange(300) * (33 / 300)).astype(int)
        assert (naive != images._nearest_index(300, 33)).any()


@pytest.mark.parametrize("n", [2, 3, 7, 11, 33, 35, 99, 199])
def test_mask_nearest_resize_grid_matches_jax_package(tmp_path, n):
    """n rows and 2n + 1 columns resized to N x 2N for the panorama heights
    N of the datasets and the smoke test (300 .. 2880)."""
    path = _write(tmp_path / "mask.png", _png(_mask(n, 2 * n + 1, n)))
    for N in (300, 360, 720, 900, 1000, 1440, 2880):
        _same_mask(path, N, 2 * N)


# ----------------------------------------------------------------------------
# masks cv2 gives no image for
# ----------------------------------------------------------------------------

def _unreadable_masks(tmp_path):
    img = (np.arange(37 * 53) % 251).reshape(37, 53).astype(np.uint8)
    jpg = _jpeg(img)
    sof = jpg.index(b"\xff\xc0")
    comps, q = forge.plane_components([img, img[::-1]], ((1, 1), (1, 1)))
    png = _png(img)
    ihdr = png.index(b"IHDR") + 4
    files = {
        "cut in a segment": jpg[:sof + 6],
        "cut in the SOI": jpg[:3],
        "no signature": b"not an image at all\n" * 4,
        "empty": b"",
        "12-bit JPEG": jpg[:sof + 4] + b"\x0c" + jpg[sof + 5:],
        "2-component JPEG": forge.jpeg_bytes(comps, 53, 37, q, [("seq", [0, 1])]),
        "lossless YCbCr JPEG": forge.lossless_bytes([img] * 3, 53, 37, jfif=True),
        "PNG with a bad IHDR CRC": png[:ihdr] + bytes([png[ihdr] ^ 1]) + png[ihdr + 1:],
        "PNG cut in its data": png[:len(png) // 2],
    }
    return {name: _write(tmp_path / f"{i}.jpg", data) for i, (name, data) in enumerate(files.items())}


def test_unreadable_mask_is_none_like_jax_package(tmp_path, caplog):
    """Each file gives no image in cv2.imread; both packages return None and
    log "Fail to read mask <path>"; so does a directory named mask.png."""
    paths = _unreadable_masks(tmp_path)
    d = tmp_path / "mask.png"
    d.mkdir()
    paths["directory"] = str(d)
    for name, path in paths.items():
        if name != "directory":
            assert cv2.imread(path, cv2.IMREAD_GRAYSCALE) is None, name
        for load in (lambda p: jpipe.load_mask(Config(mask_path=p), 50, 100),
                     lambda p: images.load_mask(p, 50, 100)):
            caplog.clear()
            with caplog.at_level(logging.ERROR, logger="panovlm"):
                assert load(path) is None, name
            assert [r.getMessage() for r in caplog.records] == [f"Fail to read mask {path}"], name


def test_unset_or_missing_mask_is_none(tmp_path):
    for path in ("", str(tmp_path / "absent.png")):
        assert images.load_mask(path, 10, 20) is None
        assert jpipe.load_mask(Config(mask_path=path), 10, 20) is None


# ----------------------------------------------------------------------------
# the decoder follows the signature, not the name
# ----------------------------------------------------------------------------

def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 128 + 90 * np.sin(yy / 4.0) * np.cos(xx / 6.0)
    img = np.stack([base, 255 - base, (0.5 * base + 3 * xx) % 256], axis=-1)
    return np.clip(img + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("color,scale", [(False, 0), (False, -1), (True, 0), (True, -1)])
def test_frames_by_signature_match_jax_package(tmp_path, color, scale):
    """A PNG named .jpg, a JPEG named .png, a gray PNG named .jpeg and a
    progressive JPEG named .png in one image directory."""
    d = tmp_path / "images"
    d.mkdir()
    _write(d / "000000.jpg", _png(_frame(37, 75, 1)))
    _write(d / "000001.png", _jpeg(_frame(37, 75, 2)))
    _write(d / "000002.jpeg", _png(_frame(37, 75, 3)[..., 0]))
    _write(d / "000003.png", _jpeg(_frame(37, 75, 4), cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    ref, names = jpipe.load_images(Config(image_path=str(d), scale=scale), color=color)
    out, names_t = images.load_images(str(d), scale, color=color)
    assert names_t == names and len(out) == 4
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,encode", [("mask.jpg", _png), ("mask.png", _jpeg),
                                         ("mask.jpeg", _png), ("mask", _png)])
def test_mask_by_signature_matches_jax_package(tmp_path, name, encode):
    path = _write(tmp_path / name, encode(_mask(30, 61, 5)))
    _same_mask(path, 60, 122)
    _same_mask(path, 30, 61)


# ----------------------------------------------------------------------------
# the other formats cv2 reads raise
# ----------------------------------------------------------------------------

def _pil(fmt, **kw):
    def enc(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, fmt, **kw)
        return buf.getvalue()
    return enc


def _cv2_enc(ext):
    def enc(arr):
        a = arr.astype(np.float32) / 255 if ext in (".pfm", ".hdr") else arr
        ok, buf = cv2.imencode(ext, a)
        assert ok, ext
        return buf.tobytes()
    return enc


RASTER_FORMATS = {
    "BMP": _cv2_enc(".bmp"), "PxM": _cv2_enc(".ppm"), "PAM": _cv2_enc(".pam"),
    "PFM": _cv2_enc(".pfm"), "Sun raster": _cv2_enc(".sr"), "TIFF": _cv2_enc(".tiff"),
    "GIF": _cv2_enc(".gif"),
}
OTHER_FORMATS = {
    "HDR": _cv2_enc(".hdr"), "WebP": _cv2_enc(".webp"), "AVIF": _cv2_enc(".avif"),
    "JPEG 2000": _pil("JPEG2000"),
}


@pytest.mark.parametrize("fmt", list(RASTER_FORMATS))
def test_raster_formats_read_like_cv2(tmp_path, fmt):
    """Each file is one cv2 writes; named mask.png, the port reads it by its
    signature with cv2's bits in colour and gray, and its mask is the JAX
    package's (None for the PFM, whose gray read cv2 gives no image for)."""
    path = _write(tmp_path / "mask.png", RASTER_FORMATS[fmt](_frame(24, 32, 6)))
    with open(path, "rb") as f:
        assert images.image_format(f.read(64)) == fmt
    for color in (True, False):
        ref = cv2.imread(path, cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
        if ref is None:
            assert fmt == "PFM" and not color
            with pytest.raises(NotImplementedError):
                images.read_image(path, color)
            continue
        np.testing.assert_array_equal(images.read_image(path, color),
                                      cv2.cvtColor(ref, cv2.COLOR_BGR2RGB) if color else ref)
    _same_mask(path, 24, 32)
    _same_mask(path, 48, 64)
    assert (images.load_mask(path, 24, 32) is None) == (fmt == "PFM")


@pytest.mark.parametrize("color,scale", [(False, 0), (False, -1), (True, 0), (True, -1)])
def test_gif_frames_match_jax_package(tmp_path, color, scale):
    """GIF bytes in .png files (cv2 decodes by signature): a 256-colour
    frame, the same interlaced, a smaller frame at an offset on a screen
    with a background colour and a transparent index, and the file cv2
    writes of a frame. The JAX package's load_images reads them with cv2,
    the port's with native/gif.cpp: the same arrays."""
    rng = np.random.default_rng(21)
    h, w = 37, 75
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3))
    files = [forge.gif_bytes(idx, pal), forge.gif_bytes(idx, pal, interlace=True),
             forge.gif_bytes(idx[3:30, 5:60], pal, screen=(w, h), offset=(5, 3), bg=17,
                             transparent=int(idx[10, 10])),
             _cv2_enc(".gif")(_frame(h, w, 8))]
    d = tmp_path / "images"
    d.mkdir()
    for i, data in enumerate(files):
        _write(d / f"{i:06d}.png", data)
    ref, names = jpipe.load_images(Config(image_path=str(d), scale=scale), color=color)
    out, names_t = images.load_images(str(d), scale, color=color)
    assert names_t == names and len(out) == len(files)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", list(OTHER_FORMATS))
def test_other_formats_raise_naming_roadmap(tmp_path, fmt):
    """Each file is one cv2 reads; the port names its format and ROADMAP.md,
    as a frame and as a mask (the mask does not fall back to None),
    whatever the file is called."""
    path = _write(tmp_path / "mask.png", OTHER_FORMATS[fmt](_frame(24, 32, 6)))
    assert cv2.imread(path, cv2.IMREAD_COLOR) is not None
    with open(path, "rb") as f:
        assert images.image_format(f.read(64)) == fmt
    for read in (lambda: images.read_image(path, True), lambda: images.load_mask(path, 24, 32)):
        with pytest.raises(NotImplementedError, match=f"a {fmt} file.*ROADMAP"):
            read()


def test_signatures_as_cv2_checks_them():
    """The byte patterns of cv2's checkSignature for each decoder, and
    near misses that match none (cv2.imread gives no image for them)."""
    cases = {b"\xff\xd8\xff\xe0": "JPEG", b"\x89PNG\r\n\x1a\n": "PNG", b"BM\x00": "BMP",
             b"#?RGBE\n": "HDR", b"#?RADIANCE\n": "HDR",
             b"RIFF\x00\x00\x00\x00WEBPVP8 ": "WebP", b"\x00\x00\x00\x1cftypmif1\x00\x00\x00\x00"
             b"mif1avif": "AVIF", b"Y\xa6j\x95": "Sun raster", b"P1\n": "PxM", b"P6 ": "PxM",
             b"P7\n": "PAM", b"Pf\n": "PFM", b"PF\r": "PFM", b"II*\x00": "TIFF",
             b"MM\x00*": "TIFF", b"II+\x00": "TIFF", b"\xffO\xffQ": "JPEG 2000",
             b"\x00\x00\x00\x0cjP  \r\n\x87\n": "JPEG 2000", b"GIF87a": "GIF", b"GIF89a": "GIF",
             b"\xff\xd8\x00": None, b"P8\n": None, b"P6x": None, b"GIF90a": None,
             b"\x00\x00\x00\x1cftypheic\x00\x00\x00\x00mif1heic": None, b"": None,
             struct.pack(">I", 0x89504E47): None}
    for head, fmt in cases.items():
        assert images.image_format(head) == fmt, head
