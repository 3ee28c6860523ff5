"""Panorama loading without cv2 or PIL — the counterpart of `load_images` and
`load_mask` (panovlm_tpu/pipeline.py:49-84), which read with cv2.

  * `read_png`: 8-bit, non-interlaced PNG (gray, gray+alpha, RGB, RGBA,
    palette) decoded with zlib and numpy, all five row filter types;
  * `rgb_to_gray`: the gray that cv2.imread(IMREAD_GRAYSCALE) gives for an
    RGB PNG. cv2 hands that conversion to libpng (png_set_rgb_to_gray with
    0.299 / 0.587), which truncates: (9797 R + 19234 G + 3737 B) >> 15.
    cv2.cvtColor(COLOR_BGR2GRAY) rounds with other weights
    ((9798 R + 19235 G + 3735 B + 16384) >> 15) and differs on ~half the
    pixels; load_images reads with imread, so the port follows imread;
  * `pyr_down` / `pyr_up`: cv2.pyrDown / cv2.pyrUp on u8 images — the 5-tap
    [1 4 6 4 1] kernel in integer arithmetic (pyr_down in numpy uint16),
    rounded to u8 at each level,
    BORDER_REFLECT_101 (pyrUp repeats the last row and column, as cv2's
    does);
  * JPEG through `io/jpeg.read_jpeg` (the host C++ decoder
    native/jpeg.cpp), with cv2.imread's bits: a gray read is libjpeg's Y
    plane, not `rgb_to_gray` of the colour result.

`load_images` decodes and pyramids the frames on threads (the decoder's
C call and numpy's loops release the GIL).
"""

from __future__ import annotations

import glob
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .jpeg import read_jpeg

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters. raw holds h rows of 1 filter byte +
    stride bytes. Returns (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    ftype, data = rows[:, 0], rows[:, 1:]
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = int(ftype[y]), data[y]
        if f == 0:                                   # None
            cur = line.copy()
        elif f == 1:                                 # Sub: running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:                                 # Up
            cur = line + prior
        elif f in (3, 4):                            # Average, Paeth: byte recurrences
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {f} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG -> uint8 (H,W) for gray, (H,W,2)
    gray+alpha, (H,W,3) RGB (palette expanded), (H,W,4) RGBA."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise NotImplementedError(
            f"{path}: PNG bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}; only 8-bit non-interlaced PNG is read (ROADMAP.md)")
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    img = img.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[img[..., 0]]
    return img[..., 0] if ch == 1 else img


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


def _read_png(path: str) -> np.ndarray:
    """uint8 (H,W) gray or (H,W,3) RGB (alpha dropped) of a PNG file."""
    img = read_png(path)
    if img.ndim == 3:
        img = img[..., 0] if img.shape[2] == 2 else img[..., :3]
    return img


def _is_jpeg(path: str) -> bool:
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".jpg", ".jpeg", ".png"):
        raise ValueError(f"{path}: unknown image format {ext}")
    return ext != ".png"


def _as(img: np.ndarray, color: bool) -> np.ndarray:
    if color:
        return img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=-1)
    return img if img.ndim == 2 else rgb_to_gray(img)


def read_image(path: str, color: bool = False) -> np.ndarray:
    """imread: uint8 gray (H,W), or RGB (H,W,3) with color=True (a gray
    file gives three equal channels; alpha is dropped)."""
    if _is_jpeg(path):
        return read_jpeg(path, color)
    return _as(_read_png(path), color)


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
    if _is_jpeg(path):
        return apply_scale(read_jpeg(path, color), scale)
    img = _read_png(path)
    if color and img.ndim == 2:   # the pyramid (per channel) once, then three channels
        return _as(apply_scale(img, scale), True)
    return apply_scale(_as(img, color), scale)


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


def load_mask(mask_path: str, H: int, W: int):
    """Static panorama mask (main.cpp:102-104/610-612): >0 = usable pixel,
    nearest-resized to (H,W); None when unset or missing."""
    if not mask_path or not os.path.exists(mask_path):
        return None
    m = read_image(mask_path)
    if m.shape != (H, W):
        ys = np.floor(np.arange(H) * (m.shape[0] / H)).astype(int)
        xs = np.floor(np.arange(W) * (m.shape[1] / W)).astype(int)
        m = m[ys][:, xs]
    return m > 0
