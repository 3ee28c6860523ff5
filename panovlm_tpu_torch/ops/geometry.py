"""Closed-form 3D geometry with validity masks — the part of
`panovlm_tpu/ops/geometry.py` that the odometry stage needs.

Fitting functions take a (..., P, 3) point block and a (..., P) bool mask, so
ragged point sets ride fixed-shape tensors. `eigh3x3` stays analytic:
`torch.linalg.eigh` orders and signs eigenvectors differently, and the line
and plane fits depend on the JAX package's conventions.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _masked_mean(pts, mask):
    w = mask.to(pts.dtype)
    n = torch.sum(w, dim=-1, keepdim=True).clamp_min(1.0)
    mean = torch.sum(pts * w[..., None], dim=-2) / n
    return mean, w, n


def _masked_cov(pts, mask):
    mean, w, n = _masked_mean(pts, mask)
    centered = (pts - mean[..., None, :]) * w[..., None]
    cov = torch.einsum("...pi,...pj->...ij", centered, centered) / n[..., None]
    return mean, cov, n[..., 0]


def eigh3x3(A):
    """Analytic eigendecomposition of symmetric 3x3 matrices (batched):
    trigonometric eigenvalues (Smith's method) and cross-product
    eigenvectors. Returns (eigvals ascending (...,3), eigvecs (...,3,3)
    as columns)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    eigvals = torch.stack([e_lo, e_mid, e_hi], dim=-1)

    def eigvec(lam):
        # v = cross of two rows of (A - lam I); keep the largest of the three
        M = A - lam[..., None, None] * eye
        c01 = torch.linalg.cross(M[..., 0, :], M[..., 1, :], dim=-1)
        c02 = torch.linalg.cross(M[..., 0, :], M[..., 2, :], dim=-1)
        c12 = torch.linalg.cross(M[..., 1, :], M[..., 2, :], dim=-1)
        norms = torch.stack([torch.sum(c * c, dim=-1) for c in (c01, c02, c12)],
                            dim=-1)
        best = torch.argmax(norms, dim=-1)
        cands = torch.stack([c01, c02, c12], dim=-2)
        v = torch.gather(cands, -2,
                         best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
        norm = torch.linalg.norm(v, dim=-1, keepdim=True)
        unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype, device=A.device)
        return torch.where(norm > 1e-20, v / torch.clamp_min(norm, 1e-20),
                           unit_x.expand(v.shape))

    v_lo = eigvec(e_lo)
    v_hi = eigvec(e_hi)
    v_mid = torch.linalg.cross(v_hi, v_lo, dim=-1)
    v_mid = v_mid / torch.clamp_min(torch.linalg.norm(v_mid, dim=-1, keepdim=True), 1e-20)
    return eigvals, torch.stack([v_lo, v_mid, v_hi], dim=-1)


def fit_line_pca(pts, mask):
    """PCA line fit (reference FormLine): point (...,3) centroid, dir
    (...,3) unit direction with its largest-|.| component positive,
    eigvals (...,3) ascending, ok (...,) (>= 2 points, non-degenerate)."""
    mean, cov, n = _masked_cov(pts, mask)
    eigvals, eigvecs = eigh3x3(cov)
    direction = eigvecs[..., :, 2]
    idx = torch.argmax(torch.abs(direction), dim=-1, keepdim=True)
    sign = torch.sign(torch.gather(direction, -1, idx))
    direction = direction * torch.where(sign == 0, torch.ones_like(sign), sign)
    ok = (n >= 2) & (eigvals[..., 2] > _EPS)
    return {"point": mean, "dir": direction, "eigvals": eigvals, "ok": ok}


def line_straightness(eigvals):
    """lambda_max / (lambda_mid + eps): large => nearly collinear set."""
    return eigvals[..., 2] / (eigvals[..., 1] + 1e-9)


def fit_plane_lsq(pts, mask, tolerance=None):
    """LSQ plane fit (reference FormPlane): n.x + d = 0 with |n| = 1. ok needs
    >= 3 points and, when given, max |point-plane distance| <= tolerance."""
    mean, cov, n = _masked_cov(pts, mask)
    eigvals, eigvecs = eigh3x3(cov)
    normal = eigvecs[..., :, 0]
    d = -torch.einsum("...i,...i->...", normal, mean)
    dist = torch.abs(torch.einsum("...pi,...i->...p", pts, normal) + d[..., None])
    dist = torch.where(mask, dist, torch.zeros_like(dist))
    max_dist = torch.amax(dist, dim=-1)
    ok = n >= 3
    if tolerance is not None:
        ok = ok & (max_dist <= tolerance)
    return {"normal": normal, "d": d, "centroid": mean, "max_dist": max_dist,
            "eigvals": eigvals, "ok": ok}


def point_to_line_distance(p, line_pt, line_dir):
    """Distance of points p (...,3) to line(point, unit dir)."""
    diff = p - line_pt
    proj = torch.einsum("...i,...i->...", diff, line_dir)
    closest = diff - proj[..., None] * line_dir
    return torch.linalg.norm(closest, dim=-1)


def angle_between(v1, v2, degrees=False):
    """Unsigned angle between vectors in [0, pi]."""
    c = torch.einsum("...i,...i->...", v1, v2) / (
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1)).clamp_min(_EPS)
    a = torch.arccos(torch.clamp(c, -1.0, 1.0))
    return torch.rad2deg(a) if degrees else a


def line_angle_between(v1, v2, degrees=False):
    """Angle between undirected lines in [0, pi/2]."""
    a = angle_between(v1, v2, degrees=False)
    a = torch.minimum(a, math.pi - a)
    return torch.rad2deg(a) if degrees else a
