"""Equirectangular (spherical panorama) camera model — the port of
panovlm_tpu/ops/spherical.py. Conventions (X-right, Y-down, Z-front):

  cam -> sphere : lon = atan2(x, z),  lat = -atan2(y, sqrt(x^2+z^2))
  sphere -> px  : u = W*(0.5 + lon/2pi),  v = H*(0.5 - lat/pi)
  sphere -> cam : x = r cos(lat) sin(lon), y = -r sin(lat), z = r cos(lat) cos(lon)

Also the LiDAR->panorama depth splat (ProjectLidar2PanoramaDepth,
util/Visualization.h:408-441) as a scatter-min z-buffer, and the samplers.
The JAX package samples neighbour maps through u8/u16 "packed quads" (the
2x2 footprint bit-packed into int32 words: a TPU gather trick, ROADMAP F6);
the port keeps their quantisation and clamping and drops the packing:

  * gray: q = round(img / scale * 255) with the per-view scale max(img)
    (`quantize_u8`), sample q bilinearly, times scale / 255;
  * depth: round(d * 256), confidence: round((c + 1) * 16384), both
    clipped to u16 (`quantize_u16`), sampled and divided back;
  * the packed samplers clamp the row coordinate to [0, H-1] before the
    floor (pole clamp) and take the lower row of the footprint clamped,
    the column wrapped (`bilinear_sample_clamped`).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def cam_to_sphere(xyz):
    """(...,3) camera-frame points -> (...,2) (lon, lat) radians."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = torch.atan2(x, z)
    lat = -torch.atan2(y, torch.sqrt(x * x + z * z))
    return torch.stack([lon, lat], dim=-1)


def sphere_to_image(lonlat, rows, cols):
    """(...,2) (lon,lat) -> (...,2) pixel (u=x=col, v=y=row), origin top-left."""
    lon, lat = lonlat[..., 0], lonlat[..., 1]
    u = cols * (0.5 + lon / (2.0 * math.pi))
    v = rows * (0.5 - lat / math.pi)
    return torch.stack([u, v], dim=-1)


def image_to_sphere(uv, rows, cols):
    u, v = uv[..., 0], uv[..., 1]
    lon = (2.0 * u / cols - 1.0) * math.pi
    lat = (0.5 - v / rows) * math.pi
    return torch.stack([lon, lat], dim=-1)


def sphere_to_cam(lonlat, r=1.0):
    lon, lat = lonlat[..., 0], lonlat[..., 1]
    cy = torch.cos(lat)
    return torch.stack([r * cy * torch.sin(lon), -r * torch.sin(lat),
                        r * cy * torch.cos(lon)], dim=-1)


def cam_to_image(xyz, rows, cols):
    return sphere_to_image(cam_to_sphere(xyz), rows, cols)


def image_to_cam(uv, rows, cols, r=1.0):
    return sphere_to_cam(image_to_sphere(uv, rows, cols), r)


def pixel_ray_grid(rows: int, cols: int, device="cpu"):
    """Pixel -> unit ray LUT (rows, cols, 3) float32, evaluated at integer
    pixel coordinates (Equirectangular::PreComputeI2C,
    sensors/Equirectangular.cpp:12-18)."""
    v, u = torch.meshgrid(torch.arange(rows, dtype=torch.float32, device=device),
                          torch.arange(cols, dtype=torch.float32, device=device),
                          indexing="ij")
    return image_to_cam(torch.stack([u, v], dim=-1), rows, cols)


def project_points_to_depth_pano(points_cam, mask, rows: int, cols: int,
                                 size: int = 3):
    """Splat camera-frame points (P,3) into a sparse (rows, cols) depth
    panorama: each valid point writes its range into its (size+1)^2 pixel
    footprint (floor - size/2 .. ceil + size/2) by scatter-min; empty
    pixels are 0."""
    depth = torch.linalg.vector_norm(points_cam, dim=-1)
    uv = cam_to_image(points_cam, rows, cols)
    lt_x = torch.floor(uv[..., 0]) - size // 2
    lt_y = torch.floor(uv[..., 1]) - size // 2
    rb_x = torch.ceil(uv[..., 0]) + size // 2
    rb_y = torch.ceil(uv[..., 1]) + size // 2
    # reference IsInside(rb) uses x+1 <= cols (Equirectangular.h:184-187)
    inside = (lt_x >= 0) & (lt_y >= 0) & (rb_x + 1 <= cols) & (rb_y + 1 <= rows)
    valid = mask & inside & (depth > 0)
    d = torch.where(valid, depth, torch.full_like(depth, math.inf))
    x0, y0 = lt_x.to(torch.int64), lt_y.to(torch.int64)
    rbx, rby = rb_x.to(torch.int64), rb_y.to(torch.int64)
    canvas = torch.full((rows * cols,), math.inf, dtype=depth.dtype,
                        device=depth.device)
    span = size // 2 * 2 + 2      # footprint width <= size//2*2 + 2 per axis
    for dy in range(span):
        for dx in range(span):
            xx = torch.clamp(x0 + dx, 0, cols - 1)
            yy = torch.clamp(y0 + dy, 0, rows - 1)
            in_fp = (x0 + dx <= rbx) & (y0 + dy <= rby)
            dd = torch.where(in_fp, d, torch.full_like(d, math.inf))
            canvas.scatter_reduce_(0, yy * cols + xx, dd, reduce="amin")
    canvas = canvas.view(rows, cols)
    return torch.where(torch.isinf(canvas), torch.zeros_like(canvas), canvas)


def _taps(img, v0, v1, u0, u1):
    W = img.shape[1]
    flat = img.reshape(img.shape[0] * W, *img.shape[2:])
    return (flat[v0 * W + u0], flat[v0 * W + u1],
            flat[v1 * W + u0], flat[v1 * W + u1])


def _lerp(taps, fu, fv):
    p00, p01, p10, p11 = taps
    top = p00 * (1 - fu) + p01 * fu
    bot = p10 * (1 - fu) + p11 * fu
    return top * (1 - fv) + bot * fv


def _footprint(uv, H: int, W: int):
    """The 2x2 footprint of bilinear_sample: rows v0, v1 clamped to
    [0, H-1], columns u0, u1 wrapped around the seam, weights fu, fv."""
    u = uv[..., 0] - 0.5            # sample at pixel centers
    v = uv[..., 1] - 0.5
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0i, v0i = u0.to(torch.int64), v0.to(torch.int64)
    return (torch.clamp(v0i, 0, H - 1), torch.clamp(v0i + 1, 0, H - 1),
            torch.remainder(u0i, W), torch.remainder(u0i + 1, W), fu, fv)


def bilinear_sample(img, uv):
    """Bilinear sample img (H,W) or (H,W,C) at pixel coords uv (...,2):
    longitude (u) wraps around the seam, the row index clamps. Returns
    (...) or (...,C)."""
    v0, v1, u0, u1, fu, fv = _footprint(uv, img.shape[0], img.shape[1])
    if img.dim() == 3:
        fu, fv = fu[..., None], fv[..., None]
    return _lerp(_taps(img, v0, v1, u0, u1), fu, fv)


def bilinear_sample_u8(imgs, index, uv):
    """bilinear_sample of the uint8 image imgs[index[b]] (imgs (M,H,W,C),
    index (B,)) at uv (B,...,2), each tap read as the float32 u8 / 255 that
    a float image loaded from it holds. Returns (B,...,C) float32."""
    M, H, W = imgs.shape[:3]
    v0, v1, u0, u1, fu, fv = _footprint(uv, H, W)
    row0 = (index.to(torch.int64) * H).reshape(-1, *[1] * (v0.dim() - 1))
    # numpy's float32 division is correctly rounded, as the reference's
    # u8.astype(float32) / 255 is; a torch divide by a scalar on the card
    # multiplies by the reciprocal
    unit = torch.from_numpy(np.arange(256, dtype=np.float32) / np.float32(255.0)).to(imgs.device)
    taps = [unit[t.to(torch.int64)] for t in
            _taps(imgs.reshape(M * H, W, -1), row0 + v0, row0 + v1, u0, u1)]
    return _lerp(taps, fu[..., None], fv[..., None])


def bilinear_sample_clamped(img, uv):
    """The packed samplers' bilinear read of an (H,W) map
    (bilinear_sample_packed_u8/u16): the row coordinate clamps to [0, H-1]
    before the floor (pole clamp), the lower tap row clamps at H-1, the
    column wraps."""
    H, W = img.shape
    u = uv[..., 0] - 0.5
    v = torch.clamp(uv[..., 1] - 0.5, 0.0, float(H - 1))
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    u0w = torch.remainder(u0.to(torch.int64), W)
    v0i = v0.to(torch.int64)
    return _lerp(_taps(img, v0i, torch.clamp(v0i + 1, max=H - 1), u0w,
                       torch.remainder(u0w + 1, W)), fu, fv)


def quantize_u8(img, scale=None):
    """u8 quantisation of a gray panorama as pack_bilinear_u8 does it:
    (round(img / scale * 255) clipped to [0, 255] as float32, scale), with
    scale = max(max(img), 1e-6) unless given."""
    img = img.to(torch.float32)
    if scale is None:
        scale = torch.clamp_min(img.max(), 1e-6)
    return torch.clamp(torch.round(img / scale * 255.0), 0, 255), scale


def sample_u8(q, scale, uv):
    """bilinear_sample_packed_u8 on a quantize_u8 map."""
    return bilinear_sample_clamped(q, uv) * (scale / 255.0)


def quantize_u16(img, scale: float = 256.0, offset: float = 0.0):
    """round((img + offset) * scale) clipped to u16, as float32 (depth:
    scale 256, offset 0; confidence: scale 16384, offset 1)."""
    return torch.clamp(torch.round((img.to(torch.float32) + offset) * scale),
                       0, 65535)


def sample_u16(q, scale: float, uv):
    """bilinear_sample_packed_u16 on a quantize_u16 map (offset not
    removed)."""
    return bilinear_sample_clamped(q, uv) / scale
