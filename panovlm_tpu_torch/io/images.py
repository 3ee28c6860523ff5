"""Panorama loading without cv2 or PIL — the counterpart of `load_images` and
`load_mask` (panovlm_tpu/pipeline.py:49-84), which read with cv2.imread.

  * `read_png`: every PNG that cv2.imread reads (each colour type and bit
    depth, Adam7 interlacing, tRNS, gAMA / sRGB, eXIf orientation), with
    cv2's bits, through the host C++ decoder native/png.cpp (zlib inflates):
    16-bit samples keep their high byte, 1/2/4-bit gray scales to 0-255,
    alpha is dropped, and a gray read of a colour or palette file is
    libpng's png_set_rgb_to_gray (see `rgb_to_gray`; through libpng's gamma
    tables when the file's gAMA or sRGB is not within 5 % of 1);
  * `rgb_to_gray`: the gray that cv2.imread(IMREAD_GRAYSCALE) gives for an
    8-bit RGB PNG without gamma. cv2 hands that conversion to libpng
    (png_set_rgb_to_gray with 0.299 / 0.587), which truncates:
    (9797 R + 19234 G + 3737 B) >> 15. cv2.cvtColor(COLOR_BGR2GRAY) rounds
    with other weights ((9798 R + 19235 G + 3735 B + 16384) >> 15) and
    differs on ~half the pixels; load_images reads with imread, so the port
    follows imread;
  * `pyr_down` / `pyr_up`: cv2.pyrDown / cv2.pyrUp on u8 images — the 5-tap
    [1 4 6 4 1] kernel in integer arithmetic (pyr_down in numpy uint16),
    rounded to u8 at each level,
    BORDER_REFLECT_101 (pyrUp repeats the last row and column, as cv2's
    does);
  * JPEG through the host C++ decoder native/jpeg.cpp, with cv2.imread's
    bits: every JPEG cv2 reads (Huffman and arithmetic coding, baseline,
    extended, progressive and lossless, one, three or four components);
    a gray read is libjpeg's Y plane, not `rgb_to_gray` of the colour
    result.

  * BMP (native/bmp.cpp), PBM / PGM / PPM, PAM and PFM (native/pxm.cpp)
    and Sun raster (native/sunras.cpp), host C++ decoders with cv2's bits
    (OpenCV's own readers replayed, its quirks too: RLE escapes, PAM's
    channel conversions, PFM's channel count; see each file's comment);
  * TIFF (native/tiff.cpp): classic and BigTIFF, strips and tiles, the
    codecs none, PackBits, LZW and Deflate with horizontal differencing,
    through libtiff's RGBA conversions as cv2 5.0 reads them (palettes,
    16-bit samples, CMYK, YCbCr, CIE L*a*b*, alpha, orientation). The TIFF
    codecs cv2 reads and the port does not yet (CCITT, JPEG, ThunderScan,
    SGILog) raise NotImplementedError naming ROADMAP.md.

The decoder is chosen by the file's first bytes, as cv2's findDecoder
chooses it, never by its name: `image_format` names the format of every
signature cv2 5.0 here has a decoder for. JPEG, PNG, BMP, PxM / PAM, PFM,
Sun raster and TIFF are read; the other formats (WebP, HDR, GIF, JPEG
2000, AVIF) raise NotImplementedError naming ROADMAP.md; bytes that are no
format's signature raise ValueError, as cv2.imread gives no image for them.
A file whose size cv2.imread raises for (a side over 2^20 pixels, ...)
raises native.Cv2Raises. The extension only decides which files
`list_images` finds: a frame.png that holds BMP bytes is a BMP frame.

`load_mask` is the JAX package's: where cv2.imread gives no image (a
corrupt or cut file, no decoder for its first bytes, a kind of file cv2
refuses, a gray read of a three-channel PFM, an unreadable path) it logs
"Fail to read mask" and returns None; where cv2.imread raises, or for a
format the port does not read yet, it raises. Its resize is
cv2.resize's INTER_NEAREST: source index min(floor(i * (1 / (N / n))),
n - 1) in float64.

`load_images` decodes and pyramids the frames on threads (the decoders' C
calls, zlib and numpy's loops release the GIL).
"""

from __future__ import annotations

import glob
import logging
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .jpeg import read_jpeg

log = logging.getLogger("panovlm")

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def read_png(path: str, color: bool | None = None) -> np.ndarray:
    """cv2.imread of a PNG file: uint8 (H, W) gray (IMREAD_GRAYSCALE) or
    (H, W, 3) RGB with color=True (IMREAD_COLOR, then BGR -> RGB), turned
    by the EXIF orientation. color=None reads a gray file (colour type 0 or
    4) as gray and any other as RGB."""
    from ..native import png
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    if color is None:
        color = len(blob) > 25 and bool(blob[25] & 2)   # IHDR colour type
    try:
        return png.decode(blob, color)
    except (NotImplementedError, ValueError) as e:
        raise type(e)(f"{path}: {e}") from None


def write_png(path: str, img: np.ndarray):
    """Encode an 8-bit gray (H,W) or RGB (H,W,3) image as PNG, filter type 0
    on every row."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_MAGIC)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """Gray of an (...,3) uint8 RGB image as cv2.imread(IMREAD_GRAYSCALE)
    decodes an RGB PNG (libpng's fixed-point weights, truncated)."""
    c = np.asarray(rgb).astype(np.int32)
    return ((c[..., 0] * 9797 + c[..., 1] * 19234 + c[..., 2] * 3737)
            >> 15).astype(np.uint8)


_SPACE = b" \t\n\v\f\r"


def image_format(head: bytes) -> str | None:
    """The format whose signature the file's first bytes carry, as cv2
    5.0's decoders check them (imgcodecs' checkSignature of each), or None
    where no decoder of cv2 matches."""
    if head[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if head[:8] == PNG_MAGIC:
        return "PNG"
    if head[:2] == b"BM":
        return "BMP"
    if head[:6] == b"#?RGBE" or head[:10] == b"#?RADIANCE":
        return "HDR"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    if head[4:8] == b"ftyp":
        size = int.from_bytes(head[:4], "big")
        brands = [head[i:i + 4] for i in range(8, min(size, len(head)) - 3, 4)]
        if b"avif" in brands or b"avis" in brands:
            return "AVIF"
    if head[:4] == b"\x59\xa6\x6a\x95":
        return "Sun raster"
    if len(head) >= 3 and head[:1] == b"P" and head[2] in _SPACE:
        kind = head[1:2]
        if b"1" <= kind <= b"6":
            return "PxM"
        if kind == b"7":
            return "PAM"
        if kind in (b"f", b"F"):
            return "PFM"
    if head[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "TIFF"
    if head[:4] == b"\xff\x4f\xff\x51" or head[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n":
        return "JPEG 2000"
    if head[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    return None


def read_image(path: str, color: bool | None = False) -> np.ndarray:
    """imread through the decoder the file's first bytes choose: uint8 gray
    (H,W), or RGB (H,W,3) with color=True (a gray file gives three equal
    channels; alpha is dropped). color=None is a colour read, except that a
    gray PNG reads as gray (load_images pyramids its one channel before it
    replicates it); a TIFF's is a colour read."""
    with open(path, "rb") as f:
        kind = image_format(f.read(64))
    if kind == "JPEG":
        return read_jpeg(path, color is not False)
    if kind == "PNG":
        return read_png(path, color)
    if kind in ("BMP", "PxM", "PAM", "PFM", "Sun raster", "TIFF"):
        from ..native import Cv2Raises, bmp, pxm, sunras, tiff
        decoder = {"BMP": bmp, "Sun raster": sunras, "TIFF": tiff}.get(kind, pxm)
        with open(path, "rb") as f:
            data = f.read()
        try:
            return decoder.decode(data, color is not False)
        except (NotImplementedError, Cv2Raises, ValueError) as e:   # Cv2Refuses too
            raise type(e)(f"{path}: {e}") from None
    if kind is None:
        raise ValueError(f"{path}: no image format's signature in its first bytes "
                         "(cv2.imread has no decoder for it)")
    raise NotImplementedError(f"{path}: a {kind} file; the port reads JPEG, PNG, BMP, "
                              "PxM / PAM, PFM, Sun raster and TIFF (none, PackBits, LZW, "
                              "Deflate); ROADMAP.md queues WebP, GIF, HDR, JPEG 2000 and "
                              "AVIF")


def _planes(img: np.ndarray) -> torch.Tensor:
    """uint8 (H,W) or (H,W,C) -> int32 (C,1,H,W)."""
    t = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    t = t[..., None] if t.dim() == 2 else t
    return t.permute(2, 0, 1)[:, None]


def _unplanes(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    out = t[:, 0].permute(1, 2, 0).to(torch.uint8).numpy()
    return out[..., 0] if like.ndim == 2 else out


def _down_axis(x: np.ndarray, axis: int) -> np.ndarray:
    """Every second output of the [1 4 6 4 1] filter along `axis` of an
    array padded by 2 on both sides of it: (n + 1) // 2 of them."""
    m = (x.shape[axis] - 3) // 2

    def tap(k):
        return x[(slice(None),) * axis + (slice(k, k + 2 * m - 1, 2),)]
    return tap(0) + 4 * tap(1) + 6 * tap(2) + 4 * tap(3) + tap(4)


def pyr_down(img: np.ndarray) -> np.ndarray:
    """cv2.pyrDown of a uint8 image: 5x5 Gaussian (outer product of
    [1 4 6 4 1]), BORDER_REFLECT_101, every second row and column of the
    result, (sum + 128) >> 8. Output ((H+1)//2, (W+1)//2). The sums fit
    uint16 (at most 255 * 256 + 128), which keeps numpy's loops narrow."""
    if min(img.shape[:2]) < 3:
        raise ValueError(f"pyr_down needs at least 3x3 pixels, got {img.shape[:2]}")
    pad = ((2, 2), (2, 2)) + ((0, 0),) * (img.ndim - 2)
    x = np.pad(img, pad, mode="reflect").astype(np.uint16)   # reflect = REFLECT_101
    return ((_down_axis(_down_axis(x, 0), 1) + 128) >> 8).astype(np.uint8)


def _up_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of cv2.pyrUp: out[2i] = s[i-1] + 6 s[i] + s[i+1],
    out[2i+1] = 4 (s[i] + s[i+1]), with s[-1] = s[1] (REFLECT_101) and
    s[n] = s[n-1] (cv2 repeats the last sample)."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 1, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = prev + 6 * x + nxt
    odd = 4 * (x + nxt)
    out = torch.stack([even, odd], dim + 1)
    shape = list(x.shape)
    shape[dim] = 2 * n
    return out.reshape(shape)


def pyr_up(img: np.ndarray) -> np.ndarray:
    """cv2.pyrUp of a uint8 image: (sum + 32) >> 6 of the separable
    upsampling filter. Output (2H, 2W)."""
    x = _planes(img).to(torch.int64)
    if min(x.shape[-2:]) < 2:
        raise ValueError("pyr_up needs at least 2x2 pixels")
    x = _up_axis(_up_axis(x, 2), 3)
    return _unplanes((x + 32) >> 6, img)


def apply_scale(img: np.ndarray, scale: int) -> np.ndarray:
    """The config `scale` pyramid (Frame.cpp:18-44): -scale pyrDowns or
    scale pyrUps, each rounded to u8."""
    for _ in range(-scale):
        img = pyr_down(img)
    for _ in range(max(scale, 0)):
        img = pyr_up(img)
    return img


def list_images(path: str):
    out = []
    for e in ("jpg", "jpeg", "png"):
        out += glob.glob(os.path.join(path, f"*.{e}"))
    return sorted(out)


def _load(path: str, scale: int, color: bool) -> np.ndarray:
    img = read_image(path, None if color else False)
    if color and img.ndim == 2:   # a gray PNG: the pyramid (per channel) once, then three channels
        return np.repeat(apply_scale(img, scale)[..., None], 3, axis=-1)
    return apply_scale(img, scale)


def load_images_u8(image_path: str, scale: int = 0, color: bool = False):
    """The panoramas of image_path as uint8: gray (H,W) by default, RGB
    (H,W,3) with color=True, each through the `scale` pyramid, decoded on
    a thread per core (at most 8). Returns (images, names)."""
    files = list_images(image_path)
    workers = min(8, os.cpu_count() or 1, len(files) or 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        imgs = list(ex.map(lambda f: _load(f, scale, color), files))
    return imgs, [os.path.basename(f) for f in files]


def load_images(image_path: str, scale: int = 0, color: bool = False):
    """load_images_u8 as float32 [0,1], as the JAX package's load_images
    returns them."""
    imgs, names = load_images_u8(image_path, scale, color)
    return [img.astype(np.float32) / 255.0 for img in imgs], names


def _nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """cv2.resize(INTER_NEAREST)'s source index of each output index:
    min(floor(i * (1 / (n_out / n_in))), n_in - 1), in float64 as resizeNN
    computes it."""
    idx = np.floor(np.arange(n_out) * (1.0 / (n_out / n_in))).astype(np.int64)
    return np.minimum(idx, n_in - 1)


def load_mask(mask_path: str, H: int, W: int):
    """Static panorama mask (main.cpp:102-104/610-612): >0 = usable pixel,
    nearest-resized to (H,W) as cv2.resize(INTER_NEAREST) resizes; None
    when unset or missing, and, with the JAX package's log line, where
    cv2.imread gives no image for the file."""
    from ..native import Cv2Refuses
    if not mask_path or not os.path.exists(mask_path):
        return None
    try:
        m = read_image(mask_path)
    except (ValueError, OSError, Cv2Refuses):
        log.error("Fail to read mask %s", mask_path)
        return None
    if m.shape != (H, W):
        m = m[_nearest_index(H, m.shape[0])][:, _nearest_index(W, m.shape[1])]
    return m > 0
