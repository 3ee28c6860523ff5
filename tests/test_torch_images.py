"""The port's image loading (panovlm_tpu_torch/io/images.py) against cv2,
which the JAX package's load_images uses: PNG and JPEG decoding, the u8
pyramid and the gray conversion are all bit-equal (integer arithmetic on
both sides), and so are load_images and load_mask on JPEG files."""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline as jpipe
from panovlm_tpu.config import Config
from panovlm_tpu_torch.io import images

torch.set_num_threads(2)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _png_all_filters(path, img):
    """Encode an 8-bit gray or RGB image with filter type y % 5 on row y."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, -1).astype(int)
    raw = bytearray()
    prior = [0] * rows.shape[1]
    for y in range(h):
        f, line = y % 5, rows[y].tolist()
        out = []
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            out.append((x - pred) & 0xFF)
        raw += bytes([f] + out)
        prior = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(images.PNG_MAGIC)
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                            0 if bpp == 1 else 2, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(bytes(raw))))
        fh.write(chunk(b"IEND", b""))


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    smooth = 128 + 100 * np.sin(yy / 5.0) * np.cos(xx / 7.0)
    img = smooth[..., None] if len(shape) == 3 else smooth
    img = img + rng.integers(-20, 21, shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(23, 37), (20, 30, 3)])
def test_png_decode_all_filter_types(tmp_path, shape):
    img = _image(shape, 0)
    path = str(tmp_path / "f.png")
    _png_all_filters(path, img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    ref = ref if ref.ndim == 2 else ref[..., ::-1]
    np.testing.assert_array_equal(ref, img)          # the encoder is right
    np.testing.assert_array_equal(images.read_png(path), img)


@pytest.mark.parametrize("shape", [(33, 65), (40, 80, 3)])
def test_png_decode_matches_cv2(tmp_path, shape):
    img = _image(shape, 1)
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, img if img.ndim == 2 else img[..., ::-1])
    np.testing.assert_array_equal(images.read_png(path), img)


@pytest.mark.parametrize("shape", [(31, 45), (32, 64), (17, 30, 3)])
def test_pyramid_matches_cv2(shape):
    img = _image(shape, 2)
    np.testing.assert_array_equal(images.pyr_down(img), cv2.pyrDown(img))
    np.testing.assert_array_equal(images.pyr_up(img), cv2.pyrUp(img))
    np.testing.assert_array_equal(images.apply_scale(img, -2),
                                  cv2.pyrDown(cv2.pyrDown(img)))


def test_gray_conversion_matches_cv2_imread(tmp_path):
    """cv2.imread(IMREAD_GRAYSCALE) of an RGB PNG (libpng's fixed-point
    weights), which is what load_images reads, and the colour read."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (30, 50, 3)).astype(np.uint8)
    path = str(tmp_path / "rgb.png")
    cv2.imwrite(path, rgb[..., ::-1])
    np.testing.assert_array_equal(images.rgb_to_gray(rgb),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(images.read_image(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(images.read_image(path, color=True),
                                  cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))


@pytest.mark.parametrize("color,scale", [(False, -1), (True, 0), (True, -1)])
def test_load_images_matches_jax_package(tmp_path, color, scale):
    d = tmp_path / "img"
    d.mkdir()
    for i in range(2):
        img = _image((41, 82, 3), 10 + i)
        cv2.imwrite(str(d / f"{i:06d}.png"), img if i else img[..., 0])
    ref, names = jpipe.load_images(Config(image_path=str(d), scale=scale), color=color)
    out, names_t = images.load_images(str(d), scale, color=color)
    assert names_t == names
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def _jpeg_dir(tmp_path):
    """Three JPEG frames of 75 x 151 (odd: partial MCUs): 4:2:0 colour at
    quality 90, a one-component file, and 4:2:2 colour at quality 95."""
    d = tmp_path / "jpg"
    d.mkdir()
    for i, flags in enumerate(([cv2.IMWRITE_JPEG_QUALITY, 90], [],
                               [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111])):
        img = _image((75, 151, 3), 20 + i)
        cv2.imwrite(str(d / f"{i:06d}.jpg"), img[..., 0] if i == 1 else img, flags)
    return d


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("scale", [-2, 0, 1])
def test_load_images_jpeg_matches_jax_package(tmp_path, color, scale):
    """Decoded like cv2.imread (the gray read is libjpeg's Y plane) and
    pyramided like cv2.pyrDown / pyrUp: bit-equal to the JAX package."""
    d = _jpeg_dir(tmp_path)
    ref, names = jpipe.load_images(Config(image_path=str(d), scale=scale), color=color)
    out, names_t = images.load_images(str(d), scale, color=color)
    assert names_t == names
    for a, b in zip(out, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(50, 101), (33, 77), (150, 302), (13, 7)])
def test_load_mask_jpeg_matches_jax_package(tmp_path, hw):
    """A binary JPEG mask (ringing around its edges) read gray, thresholded
    at > 0 and nearest-resized at a non-integer ratio from 75 x 151, as
    cv2.resize(INTER_NEAREST) does it in the JAX package."""
    rng = np.random.default_rng(4)
    m = np.kron(rng.random((15, 31)) > 0.5, np.ones((5, 5), bool))[:75, :151]
    path = str(tmp_path / "mask.jpg")
    cv2.imwrite(path, m.astype(np.uint8) * 255)
    ref = jpipe.load_mask(Config(mask_path=path), *hw)
    out = images.load_mask(path, *hw)
    assert out.shape == hw and out.dtype == bool
    np.testing.assert_array_equal(out, ref)
