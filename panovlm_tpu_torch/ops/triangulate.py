"""Multi-view triangulation of bearing rays — the port of
panovlm_tpu/ops/triangulate.py (sfm/Triangulate.{h,cpp} and the
TriangulateTracks helpers of sfm/Structure.cpp:8-85). Batched over leading
dimensions; poses are [aa_cw, t_cw]."""

from __future__ import annotations

import torch

from . import se3


def rays_from_poses(poses_cw, bearings):
    """Camera-frame bearings -> world rays: (origin (...,3), dir (...,3))."""
    R_wc = se3.exp_so3(poses_cw[..., :3]).transpose(-1, -2)
    origin = -torch.einsum("...ij,...j->...i", R_wc, poses_cw[..., 3:])
    return origin, torch.einsum("...ij,...j->...i", R_wc, bearings)


def triangulate_rays(origins, dirs, mask):
    """Least-squares point closest to a masked bundle of rays (..., L, 3):
    X = (sum P_i)^-1 sum P_i c_i, P_i = I - d_i d_i^T. Returns (X, ok)."""
    w = mask.to(origins.dtype)[..., None, None]
    eye = torch.eye(3, dtype=origins.dtype, device=origins.device)
    P = (eye - dirs[..., :, None] * dirs[..., None, :]) * w
    A = torch.sum(P, dim=-3)
    b = torch.sum(torch.einsum("...lij,...lj->...li", P, origins), dim=-2)
    det = torch.linalg.det(A)
    X = torch.linalg.solve(A + 1e-9 * eye, b[..., None])[..., 0]
    ok = (torch.sum(mask, dim=-1) >= 2) & (torch.abs(det) > 1e-9)
    return X, ok


def max_pairwise_ray_angle(dirs, mask):
    """Largest angle (deg) between two valid rays of (..., L, 3)."""
    cosm = torch.einsum("...li,...mi->...lm", dirs, dirs)
    valid = mask[..., :, None] & mask[..., None, :]
    cosm = torch.where(valid, torch.clamp(cosm, -1.0, 1.0), torch.ones_like(cosm))
    return torch.rad2deg(torch.arccos(torch.amin(cosm, dim=(-2, -1))))


def reprojection_angles(poses_cw, bearings, X, mask):
    """Angle (deg) between each observation ray and the point (..., L);
    0 where masked (FilterTracksAngleResidual, Structure.cpp:159-194)."""
    R_cw = se3.exp_so3(poses_cw[..., :3])
    p_c = torch.einsum("...lij,...j->...li", R_cw, X) + poses_cw[..., 3:]
    p_n = p_c / (torch.linalg.vector_norm(p_c, dim=-1, keepdim=True) + 1e-12)
    ang = torch.rad2deg(torch.arccos(torch.clamp(torch.sum(p_n * bearings, -1), -1.0, 1.0)))
    return torch.where(mask, ang, torch.zeros_like(ang))

