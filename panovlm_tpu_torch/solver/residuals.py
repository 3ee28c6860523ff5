"""Residual functions, ported from `panovlm_tpu/solver/residuals.py`: the
odometry families (point-to-plane, point-to-line and line-to-line,
base/CostFunction.h:567-1022 in the reference), the SfM families
(chordal and pixel reprojection, pairwise rotation and translation, the
LUD and chordal translation-averaging residuals, scale bounds) and the
camera-LiDAR line families of the joint stage (plane-to-plane and plane
IoU, base/CostFunction.h:350-506, and their calibration variants with the
single pose T_cl, :294-348 and :509-564).

Each function is the un-batched residual of ONE observation; the solver
maps it over the observation axis with `torch.func.vmap` and differentiates
it with `torch.func.jacrev`. Poses are [angleaxis_fw (3), t_fw (3)], the
world-to-frame transform.
"""

from __future__ import annotations

import math

import torch

from ..ops import se3


def split_pose(pose):
    return pose[..., :3], pose[..., 3:]


def transform_n_to_r(pose_r, pose_n, point_n):
    """P_r = R_rw R_wn P_n - R_rw R_wn t_nw + t_rw."""
    aa_r, t_r = split_pose(pose_r)
    aa_n, t_n = split_pose(pose_n)
    R_rn = torch.matmul(se3.exp_so3(aa_r), se3.exp_so3(-aa_n))
    return R_rn @ point_n - R_rn @ t_n + t_r


def _safe_norm(x, eps: float = 1e-6):
    """sqrt(|x|^2 + eps^2): finite derivative at x = 0."""
    return torch.sqrt(torch.sum(x * x) + eps * eps)


def vector_angle(v1, v2):
    """Unsigned angle between vectors as atan2(|cross|, dot); the 1e-12
    floor under the sqrt bounds reverse-mode partials (see the JAX module)."""
    cross = torch.linalg.cross(v1, v2, dim=-1)
    sin_n = torch.sqrt(torch.sum(cross * cross) + 1e-12)
    return torch.atan2(sin_n, torch.sum(v1 * v2))


def plane_angle(v1, v2):
    """Angle folded to [0, pi/2]."""
    a = vector_angle(v1, v2)
    return torch.minimum(a, math.pi - a)


def _normalized_center_angle(point_proj, point_ref):
    """Angle seen from a centre 1 m from the projected point along its ray
    (CostFunction.h:694-715), so the angle ~ metric distance; the norm is
    clamped to 1 cm."""
    norm = torch.clamp_min(_safe_norm(point_proj), 1e-2)
    center = (norm - 1.0) / norm * point_proj
    return vector_angle(point_proj - center, point_ref - center)


def _deadband(value, gate):
    return torch.where(gate, torch.zeros_like(value), value)[None]


def point2plane_meter(pose_r, pose_n, point_n, plane_r):
    """Point2Plane_Meter: signed point-plane distance in the reference
    frame; plane_r = (nx, ny, nz, d). (1,)."""
    p_ref = transform_n_to_r(pose_r, pose_n, point_n)
    return (torch.sum(plane_r[:3] * p_ref) + plane_r[3])[None]


def point2plane_angle(pose_r, pose_n, point_n, plane_r, normalize_distance=True):
    """Point2Plane_Angle (CostFunction.h:630-729): angle between the point
    and its in-plane projection; distance < 1e-3 -> 0. (1,)."""
    p_ref = transform_n_to_r(pose_r, pose_n, point_n)
    dis = torch.sum(plane_r[:3] * p_ref) + plane_r[3]
    p_proj = p_ref - dis * plane_r[:3]
    if normalize_distance:
        ang = _normalized_center_angle(p_proj, p_ref)
    else:
        ang = vector_angle(p_ref, p_proj)
    return _deadband(ang, torch.abs(dis) < 1e-3)


def _point_line_distance(p, line_pt, line_dir):
    diff = p - line_pt
    closest = diff - torch.sum(diff * line_dir) * line_dir
    return torch.sqrt(torch.sum(closest * closest) + 1e-12)


def point2line_meter(pose_r, pose_n, point_n, line_pt_r, line_dir_r):
    """Point2Line_Meter (CostFunction.h:769-833). (1,)."""
    p_ref = transform_n_to_r(pose_r, pose_n, point_n)
    return _point_line_distance(p_ref, line_pt_r, line_dir_r)[None]


def point2line_angle(pose_r, pose_n, point_n, line_pt_r, line_dir_r,
                     normalize_distance=True):
    """Point2Line_Angle (CostFunction.h:836-933); distance < 1e-3 -> 0. (1,)."""
    p_ref = transform_n_to_r(pose_r, pose_n, point_n)
    k = torch.sum(line_dir_r * (p_ref - line_pt_r))
    p_proj = line_pt_r + k * line_dir_r
    dis = _safe_norm(p_ref - p_proj)
    if normalize_distance:
        ang = _normalized_center_angle(p_proj, p_ref)
    else:
        ang = vector_angle(p_ref, p_proj)
    return _deadband(ang, dis < 1e-3)


def line2line_angle(pose_r, pose_n, dir_r, dir_n):
    """Line2Line_Angle: fold-to-90deg angle between the neighbour line
    direction rotated into the reference frame and the reference direction;
    rotation only; angle < 1e-3 -> 0. (1,)."""
    aa_r, _ = split_pose(pose_r)
    aa_n, _ = split_pose(pose_n)
    d_ref = se3.exp_so3(aa_r) @ (se3.exp_so3(-aa_n) @ dir_n)
    ang = plane_angle(d_ref, dir_r)
    return _deadband(ang, ang < 1e-3)


# ----------------------------------------------------------------------------
# camera reprojection (base/CostFunction.h:178-292) and the pairwise
# pose-graph residuals (base/CostFunction.h:17-147) of the SfM slice
# ----------------------------------------------------------------------------

def reproj_chordal(pose_cw, point_3d, obs_ray):
    """Chordal reprojection: normalize(R_cw X + t_cw) - obs_ray. (3,)."""
    aa, t = split_pose(pose_cw)
    p_c = se3.exp_so3(aa) @ point_3d + t
    return p_c / (torch.linalg.vector_norm(p_c) + 1e-12) - obs_ray


def reproj_pixel(pose_cw, point_3d, obs_uv, rows, cols):
    """PanoramaReprojResidual_Pixel (base/CostFunction.h:249-292), with the
    u difference wrapped across the longitude seam. (2,)."""
    aa, t = split_pose(pose_cw)
    p_c = se3.exp_so3(aa) @ point_3d + t
    norm = torch.linalg.vector_norm(p_c) + 1e-12
    lon = torch.atan2(p_c[0], p_c[2])
    lat = -torch.arcsin(torch.clamp(p_c[1] / norm, -1.0, 1.0))
    u = cols * (0.5 + lon / (2 * math.pi))
    v = rows * (0.5 - lat / math.pi)
    du = torch.remainder(u - obs_uv[0] + cols / 2, cols) - cols / 2
    return torch.stack([du, v - obs_uv[1]])


def pairwise_rotation(aa_1w, aa_2w, aa_21_obs):
    """PairWiseRotationResidual (base/CostFunction.h:17-47): log of
    (R_2w R_1w^T) R_21_obs^T. (3,)."""
    cycle = (se3.exp_so3(aa_2w) @ se3.exp_so3(aa_1w).transpose(-1, -2)
             @ se3.exp_so3(aa_21_obs).transpose(-1, -2))
    return se3.log_so3(cycle)


def pairwise_translation(t_1w, t_2w, scale, aa_21_obs, t_21_obs_unit):
    """PairWiseTranslationResidual (base/CostFunction.h:51-84):
    t_2w - R_21 t_1w - scale t_21. (3,)."""
    return t_2w - se3.exp_so3(aa_21_obs) @ t_1w - scale[0] * t_21_obs_unit


def lud(t_w1, t_w2, scale, direction_w):
    """LUD centre residual (base/CostFunction.h:89-117 objective):
    C_1 - C_2 - scale * dir, dir = normalize(R_w2 t_21). (3,). The raw
    3-vector, as the JAX function returns it: the solver's robust loss
    stands in for the reference's sqrt(sqrt(|e|))."""
    return t_w1 - t_w2 - scale[0] * direction_w


def chordal(t_w1, t_w2, direction_w):
    """ChrodalResidual (base/CostFunction.h:149-176): the normalised
    baseline C_1 - C_2 minus the measured world-frame direction (1DSfM,
    ECCV'14). (3,). Not differentiable where C_1 = C_2."""
    base = t_w1 - t_w2
    return base / (torch.sqrt(torch.sum(base * base)) + 1e-12) - direction_w


def scale_factor(scale, lower, upper):
    """ScaleFactor (base/CostFunction.h:119-147): hinge keeping a scale in
    [lower, upper]. (1,)."""
    below = torch.clamp_min(lower - scale[0], 0.0)
    above = torch.clamp_min(scale[0] - upper, 0.0)
    return (below + above).reshape(1)


# ----------------------------------------------------------------------------
# camera-LiDAR line residuals (base/CostFunction.h:350-506)
# ----------------------------------------------------------------------------

def _transform_pair(pose_r, pose_n, p):
    """Neighbour local -> world -> reference local (the functors' transform)."""
    aa_n, t_n = split_pose(pose_n)
    aa_r, t_r = split_pose(pose_r)
    R_wn = se3.exp_so3(-aa_n)
    p_w = R_wn @ p - R_wn @ t_n
    return se3.exp_so3(aa_r) @ p_w + t_r


def plane2plane_global(pose_r, pose_n, plane_ref_n3, point_a_n, point_b_n):
    """Plane2Plane_Global (base/CostFunction.h:350-426): the angle, folded
    to [0, pi/2], between the image line's plane (unit normal in the camera
    frame) and the plane through the camera centre and the LiDAR line's
    endpoints (LiDAR frame, mapped into the camera frame). (1,)."""
    a_ref = _transform_pair(pose_r, pose_n, point_a_n)
    b_ref = _transform_pair(pose_r, pose_n, point_b_n)
    n1 = torch.linalg.cross(a_ref, b_ref, dim=-1)
    return plane_angle(plane_ref_n3, n1)[None]


def plane_iou(pose_r, pose_n, ref_plane4, middle_n, middle_ref, half_angle):
    """PlaneIOUResidual (base/CostFunction.h:433-506): hinge on the angle
    between the LiDAR line's midpoint, projected into the image line's
    plane, and the image line's midpoint ray, beyond the image line's half
    arc. (1,)."""
    m_ref = _transform_pair(pose_r, pose_n, middle_n)
    n = ref_plane4[:3]
    dis = torch.sum(n * m_ref) + ref_plane4[3]
    m_proj = m_ref - dis * n
    ang = vector_angle(m_proj, middle_ref)
    return torch.clamp_min(ang - half_angle, 0.0)[None]


def plane2plane_relative(pose_cl, plane_ref_n3, point_a_l, point_b_l):
    """Plane2Plane_Relative (base/CostFunction.h:294-348): the calibration
    variant of plane2plane_global, with the single pose T_cl mapping the
    LiDAR line's endpoints into the camera frame. (1,)."""
    aa, t = split_pose(pose_cl)
    R = se3.exp_so3(aa)
    n1 = torch.linalg.cross(R @ point_a_l + t, R @ point_b_l + t, dim=-1)
    return plane_angle(plane_ref_n3, n1)[None]


def plane_relative_iou(pose_cl, ref_plane4, middle_l, middle_ref, half_angle):
    """PlaneRelativeIOUResidual (base/CostFunction.h:509-564): plane_iou
    with the LiDAR midpoint mapped by the single pose T_cl. (1,)."""
    aa, t = split_pose(pose_cl)
    m_c = se3.exp_so3(aa) @ middle_l + t
    n = ref_plane4[:3]
    dis = torch.sum(n * m_c) + ref_plane4[3]
    ang = vector_angle(m_c - dis * n, middle_ref)
    return torch.clamp_min(ang - half_angle, 0.0)[None]
