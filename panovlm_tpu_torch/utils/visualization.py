"""Pose artifact writers (util/Visualization.{h,cpp} of the reference): the
port's copy of the numpy parts of panovlm_tpu/utils/visualization.py that
the port calls."""

from __future__ import annotations

import numpy as np

from ..io.pointcloud import write_pcd
from .poses import params_to_world


def camera_centers_pcd(path, poses_params, frame_valid=None):
    """CameraCenterPCD (util/Visualization.h): one point per camera center,
    intensity = time index."""
    _, C = params_to_world(poses_params)
    n = len(C)
    valid = np.ones(n, bool) if frame_valid is None else np.asarray(frame_valid)
    inten = (np.arange(n) / max(n - 1, 1)).astype(np.float32)
    write_pcd(path, C[valid].astype(np.float32), intensity=inten[valid])


def camera_pose_ply(path, poses_params, frame_valid=None, scale: float = 0.2):
    """CameraPoseVisualize: small 5-point frustum per camera as PLY points
    with per-axis colored edges collapsed to points (x=red axis tip etc.)."""
    R_w, t_w = params_to_world(poses_params)
    n = len(t_w)
    valid = np.ones(n, bool) if frame_valid is None else np.asarray(frame_valid)
    pts, cols = [], []
    axes = np.eye(3) * scale
    axis_colors = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    for i in range(n):
        if not valid[i]:
            continue
        pts.append(t_w[i])
        cols.append(np.array([255, 255, 255], np.uint8))
        for a in range(3):
            for s in np.linspace(0.25, 1.0, 4):
                pts.append(t_w[i] + R_w[i] @ axes[a] * s)
                cols.append(axis_colors[a])
    pts = np.asarray(pts, np.float32)
    cols = np.asarray(cols, np.uint8)
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(pts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                 "end_header\n").encode())
        rec = np.zeros(len(pts), dtype=[("xyz", np.float32, 3),
                                        ("rgb", np.uint8, 3)])
        rec["xyz"] = pts
        rec["rgb"] = cols
        f.write(rec.tobytes())
