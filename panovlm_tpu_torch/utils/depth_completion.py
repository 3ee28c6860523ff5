"""Morphological depth completion (ip_basic) — the port of
panovlm_tpu/utils/depth_completion.py.

Replaces util/DepthCompletion.{h,cpp} (reference DepthCompletion,
:154-315): invert valid depths (max_depth - d), multi-scale dilation with
cross kernels chosen by range band (near<=15 m: cross7, med<=30: cross5,
far: cross3), 5x5 closing, median blur, sky-aware hole filling (top mask
from the first valid row per column), 6 rounds of 5x5 dilation into holes,
median + bilateral smoothing, invert back. Flat structuring elements are
maxima over shifted copies; out-of-image samples read 0 (inf for erosion).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import spherical


def _kernel_offsets(mask: np.ndarray):
    ys, xs = np.nonzero(mask)
    c = mask.shape[0] // 2
    return [(int(y - c), int(x - c)) for y, x in zip(ys, xs)]


FULL_5 = _kernel_offsets(np.ones((5, 5), bool))
FULL_9 = _kernel_offsets(np.ones((9, 9), bool))
CROSS_3 = _kernel_offsets(np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool))
CROSS_5 = _kernel_offsets(np.array(
    [[0, 0, 1, 0, 0], [0, 0, 1, 0, 0], [1, 1, 1, 1, 1],
     [0, 0, 1, 0, 0], [0, 0, 1, 0, 0]], bool))
_c7 = np.zeros((7, 7), bool)
_c7[3, :] = True
_c7[:, 3] = True
CROSS_7 = _kernel_offsets(_c7)


def _shift(img, dy, dx, fill):
    """out[y, x] = img[y - dy, x - dx], out-of-bounds -> fill."""
    H, W = img.shape
    p = F.pad(img[None], (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)),
              value=fill)[0]
    return p[max(-dy, 0):H + max(-dy, 0), max(-dx, 0):W + max(-dx, 0)]


def dilate(img, offsets):
    out = img
    for dy, dx in offsets:
        if dy or dx:
            out = torch.maximum(out, _shift(img, dy, dx, 0.0))
    return out


def erode(img, offsets):
    out = img
    for dy, dx in offsets:
        if dy or dx:
            out = torch.minimum(out, _shift(img, dy, dx, math.inf))
    return out


def median5(img):
    """5x5 median (25 samples: the middle one), zero outside the image."""
    stack = torch.stack([_shift(img, dy, dx, 0.0) for dy, dx in FULL_5])
    return torch.sort(stack, dim=0).values[12]


def bilateral5(img, sigma_color: float = 0.5, sigma_space: float = 2.0):
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for dy, dx in FULL_5:
        s = _shift(img, dy, dx, 0.0)
        w_s = float(np.exp(-(dy * dy + dx * dx) / (2 * sigma_space ** 2)))
        w_c = torch.exp(-((s - img) ** 2) / (2 * sigma_color ** 2))
        w = w_s * w_c * (s > 0)
        num = num + w * s
        den = den + w
    return torch.where(den > 0, num / torch.clamp_min(den, 1e-12), img)


def _top_mask(s):
    """Rows at or below each column's first valid (> 0.1) pixel."""
    valid = s > 0.1
    first = torch.argmax(valid.to(torch.uint8), dim=0)
    rows = torch.arange(s.shape[0], device=s.device)[:, None]
    return (rows >= first[None, :]) & valid.any(dim=0)[None, :]


def depth_completion(sparse_depth, max_depth: float = 20.0):
    """Dense depth (H,W) from a sparse panorama depth (0 = empty)."""
    d0 = torch.where(sparse_depth <= max_depth, sparse_depth, torch.zeros_like(sparse_depth))
    valid = d0 > 0.1
    near = valid & (d0 <= 15.0)
    med = (d0 > 15.0) & (d0 <= 30.0)
    far = d0 > 30.0
    zero = torch.zeros_like(d0)

    s1 = torch.where(valid, max_depth - d0, d0)                   # invert
    dil_far = dilate(torch.where(far, s1, zero), CROSS_3)
    dil_med = dilate(torch.where(med, s1, zero), CROSS_5)
    dil_near = dilate(torch.where(near, s1, zero), CROSS_7)
    s2 = torch.where(dil_far > 0.1, dil_far, s1)
    s2 = torch.where(dil_med > 0.1, dil_med, s2)
    s2 = torch.where(dil_near > 0.1, dil_near, s2)

    s3 = erode(dilate(s2, FULL_5), FULL_5)                        # close 5x5
    s4 = torch.where(s3 > 0.1, median5(s3), s3)

    empty = (~(s4 > 0.1)) & _top_mask(s4)                         # sky-aware fill
    s5 = torch.where(empty, dilate(s4, FULL_9), s4)

    top2 = _top_mask(s5)
    s7 = s5
    for _ in range(6):
        s7 = torch.where((s7 < 0.1) & top2, dilate(s7, FULL_5), s7)
    vmask = (s7 > 0.1) & top2
    s7 = torch.where(vmask, median5(s7), s7)
    s7 = torch.where(vmask, bilateral5(s7), s7)
    return torch.where(s7 > 0.1, max_depth - s7, s7)


def compute_depth_image(points_lidar, mask, T_cl, rows: int, cols: int,
                        max_depth: float = 20.0, splat: int | None = None):
    """ComputeDepthImage for one scan (sfm/SfM.cpp:170-226): transform the
    (P,3) cloud by T_cl (4,4), splat it to a sparse panorama depth, complete
    it. The splat footprint scales with the width (the reference's size 3
    is tuned for 2880-wide panoramas)."""
    if splat is None:
        splat = max(1, 3 * cols // 2880)
    p_cam = points_lidar @ T_cl[:3, :3].T + T_cl[:3, 3]
    sparse = spherical.project_points_to_depth_pano(p_cam, mask, rows, cols, size=splat)
    return depth_completion(sparse, max_depth=max_depth)


def compute_depth_images(points_lidar, mask, T_cl, rows: int, cols: int,
                         max_depth: float = 20.0, splat: int | None = None):
    """All scans' completed depth panoramas: points_lidar (N,P,3), mask
    (N,P), T_cl (N,4,4) -> (N, rows, cols)."""
    return torch.stack([compute_depth_image(points_lidar[i], mask[i], T_cl[i],
                                            rows, cols, max_depth, splat)
                        for i in range(points_lidar.shape[0])])
