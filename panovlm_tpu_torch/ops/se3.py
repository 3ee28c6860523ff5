"""Batched SO(3) operations — the slice of `panovlm_tpu/ops/se3.py` that the
odometry stage needs.

Conventions as in the JAX module: quaternions (w, x, y, z), Hamilton; rotation
matrices act on column vectors; tangent vectors use the axis-angle chart.
Every function broadcasts over leading batch dimensions and is usable under
`torch.func` transforms. Float32 products run at full precision because
`device.resolve` turns TF32 off.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def hat(w):
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def exp_so3(w):
    """Rodrigues: axis-angle (...,3) -> rotation matrix (...,3,3), with the
    Taylor branch near 0 and safe denominators in the branch not taken (so
    reverse-mode derivatives stay finite)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    use_taylor = theta2 < 1e-8
    one = torch.ones_like(theta)
    theta_s = torch.where(use_taylor, one, theta)
    theta2_s = torch.where(use_taylor, one, theta2)
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta_s) / theta_s)
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta_s)) / theta2_s)
    W = hat(w)
    wwT = w[..., :, None] * w[..., None, :]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    WW = wwT - theta2[..., None, None] * eye
    return eye + a[..., None, None] * W + b[..., None, None] * WW


def log_so3(R):
    """Rotation matrix (...,3,3) -> axis-angle (...,3). Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1) * 0.5
    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-2
    safe_sin = torch.where(torch.abs(sin_theta) < _EPS,
                           torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 1.0 + theta * theta / 6.0, theta / safe_sin)
    w_generic = v * scale[..., None]
    # near pi: the column of R + I with the largest diagonal is the axis
    A = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1)
    col_idx = torch.argmax(diag, dim=-1)
    cols = A.transpose(-1, -2)
    axis_raw = torch.gather(
        cols, -2, col_idx[..., None, None].expand(*col_idx.shape, 1, 3))[..., 0, :]
    axis = axis_raw / torch.linalg.norm(axis_raw, dim=-1, keepdim=True).clamp_min(_EPS)
    sign = torch.sign(torch.sum(axis * v, dim=-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    w_pi = theta[..., None] * axis * sign
    return torch.where(near_pi[..., None], w_pi, w_generic)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def quat_to_matrix(q):
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def matrix_to_quat(R):
    """Rotation matrix (...,3,3) -> quaternion (...,4) with w >= 0
    (Shepperd's four-branch construction, selected with where)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp_min(x, _EPS)) * 2.0

    s0 = root(1.0 + tr)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_slerp(q0, q1, t):
    """Spherical linear interpolation; t (...,1) broadcasts over the batch."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot).clamp(max=1.0)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe_sin)
    return quat_normalize(w0 * q0 + w1 * q1)


def invert_pose(R, t):
    """(R, t)^-1 = (R^T, -R^T t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)
