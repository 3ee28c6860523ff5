"""Point colorization from one panorama — the port of `colorize_points` of
panovlm_tpu/models/texture.py (mvs/Texture.{h,cpp} of the reference), which
the SfM stage uses for structure.pcd (colorize_structure)."""

from __future__ import annotations

import torch

from ..ops import se3, spherical


def colorize_points(points_w, mask, image, pose_cw, max_dist: float = 35.0):
    """Sample image color for world points seen from one camera. points_w
    (P,3); image (H,W) gray or (H,W,3) rgb; pose_cw (6,) [aa_cw, t_cw].
    Returns (colors (P,C), ok (P,))."""
    H, W = image.shape[:2]
    R = se3.exp_so3(pose_cw[:3])
    p_c = points_w @ R.T + pose_cw[3:]
    dist = torch.linalg.vector_norm(p_c, dim=-1)
    col = spherical.bilinear_sample(image, spherical.cam_to_image(p_c, H, W))
    ok = mask & (dist > 0.1) & (dist < max_dist)
    if col.dim() == 1:
        col = col[:, None]
    return torch.where(ok[:, None], col, torch.zeros_like(col)), ok
